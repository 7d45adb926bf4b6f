"""Port parity of the gather-path solver (`ibx_torch.solve.euler`) against
`ibx.solve.euler` on RAE2822 at wall_h=8e-2 (16,768 cells, the fixture of
tests/test_block_ops.py): `euler_rhs` (plain, low order, ``fix``,
``viscous`` with a scalar and a field ``mu_t``) 2e-4 per channel scaled by
the channel's max + 1e-3, `local_timestep` rtol 1e-4, one `rk2_step` 1e-5
and five 1e-3 per channel. Both packages get the JAX package's partition
tables (through `ibx_torch.convert`) and the same numpy state; the JAX
functions run un-jitted, op by op.

Inside the port: the gather path against the block path (`euler_rhs` vs
`euler_rhs_block`, the viscous pair with an ``mu_t`` field, dt, five steps:
the limits of tests/test_block_ops.py and tests/test_viscous.py), the
viscous channel of tests/test_viscous.py, and the advection and dissipation
marches of tests/test_advection.py on the port's operator API."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ibx.cases import build_rae2822 as jx_build_rae2822
from ibx.ops import block_ops as jbo
from ibx.solve import euler as je

from ibx_torch import geometry as tg
from ibx_torch.cases import build_rae2822
from ibx_torch.convert import cut3_from_numpy
from ibx_torch.ops import block_ops as bo
from ibx_torch.ops import kernels as K
from ibx_torch.ops import operators as ops
from ibx_torch.physics.fluid import make_fluid
from ibx_torch.solve import euler as te
from ibx_torch.topology.domain import Domain

from test_torch_block_ops_2d import perturbed, te_fix
from test_torch_kernels import chan_err, t
from test_torch_stencil import port_partition

torch.set_num_threads(2)
SMALL = dict(wall_h=8e-2, feature_h=4e-2, cfl=0.7)


@pytest.fixture(scope="module")
def setup():
    """(JAX gather case, port gather case, port block case, the JAX
    partition's tables as a port `Partition`)."""
    jx = jx_build_rae2822(use_blocks=False, **SMALL)
    pt = build_rae2822(use_blocks=False, device="cpu", **SMALL)
    blk = build_rae2822(device="cpu", **SMALL)
    assert pt.bt is None and pt.dom.ncells == jx.dom.ncells == 16768
    return jx, pt, blk, port_partition(jx.dom.partitions[0])


def _mu_t(dom):
    x = dom.centers[:, 0]
    return (1e-4 * (1.0 + np.abs(np.sin(5 * x)))).astype(np.float32)


def _scaled_err(ref, out):
    return chan_err(ref, out, floor=1e-3)


VARIANTS = ["plain", "low_order", "fix", "viscous", "viscous_mu_scalar",
            "viscous_mu_field"]


def _rhs_kwargs(jx, variant):
    kj, kt = {}, {}
    if variant == "low_order":
        kj = kt = dict(high_order=False)
    elif variant == "fix":
        fix, _ = te_fix(jx)
        kj, kt = dict(fix=jnp.asarray(fix)), dict(fix=t(fix))
    elif variant == "viscous":
        kj = kt = dict(viscous=True)
    elif variant == "viscous_mu_scalar":
        kj = kt = dict(viscous=True, mu_t=3e-4)
    elif variant == "viscous_mu_field":
        mu = _mu_t(jx.dom)
        kj = dict(viscous=True, mu_t=jnp.asarray(mu))
        kt = dict(viscous=True, mu_t=t(mu))
    return kj, kt


@pytest.mark.parametrize("variant", VARIANTS)
def test_euler_rhs_matches_ibx(setup, variant):
    jx, pt, _, part = setup
    P = perturbed(jx)
    kj, kt = _rhs_kwargs(jx, variant)
    ref = np.asarray(je.euler_rhs(jx.dom.partitions[0], jx.fluid,
                                  jnp.asarray(P), **kj))
    K.reset_launches()
    out = te.euler_rhs(part, make_fluid(), t(P), **kt).numpy()
    assert not any(K.launches.values())
    assert np.isfinite(out).all()
    assert _scaled_err(ref, out) < 2e-4, _scaled_err(ref, out)
    # the port's own tables give the same numbers
    own = te.euler_rhs(pt.dom.partitions[0], pt.fluid, t(P), **kt).numpy()
    assert np.array_equal(own, out)


def test_mu_t_zero_dim_tensor_takes_the_scalar_branch(setup):
    jx, _, _, part = setup
    P = t(perturbed(jx))
    fl = make_fluid()
    a = te.euler_rhs(part, fl, P, viscous=True, mu_t=3e-4)
    b = te.euler_rhs(part, fl, P, viscous=True, mu_t=torch.tensor(3e-4))
    assert torch.equal(a, b)
    plain = te.euler_rhs(part, fl, P, viscous=True)
    assert float((a - plain).abs().max()) > 0


def test_local_timestep_matches_ibx(setup):
    jx, _, _, part = setup
    P = perturbed(jx, seed=1)
    ref = np.asarray(je.local_timestep(jx.dom.partitions[0], jx.fluid,
                                       jnp.asarray(P), 0.7))
    out = te.local_timestep(part, make_fluid(), t(P), 0.7).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4)


def test_rk2_step_matches_ibx(setup):
    """One step from a perturbed state (each package's own fused BC, the
    same freeze mask): 1e-5 per channel, resnorm rtol 1e-5."""
    jx, pt, _, part = setup
    P = perturbed(jx, seed=2)
    active = pt.active.numpy()
    ref, res_ref = je.rk2_step(jx.dom.partitions[0], jx.fluid, jnp.asarray(P),
                               jx.apply_bcs, cfl=0.7,
                               active=jnp.asarray(active))
    out, res = te.rk2_step(part, make_fluid(), t(P), pt.apply_bcs, cfl=0.7,
                           active=pt.active)
    assert chan_err(ref, out.numpy()) < 1e-5, chan_err(ref, out.numpy())
    assert abs(float(res) - float(res_ref)) <= 1e-5 * abs(float(res_ref))
    # resnorm weighs rows by own_mask[:N]
    R0 = te.euler_rhs(part, make_fluid(), t(P))
    assert float(res) == float(R0[:, 0].abs().max())


def test_five_steps_match_ibx(setup):
    """Five steps of `case.march` from the initial state against the JAX
    case's (jitted) march: 1e-3 per channel, no kernel launch counted."""
    jx, pt, _, _ = setup
    ref = np.asarray(jx.march(jx.P0, 5))
    K.reset_launches()
    out = pt.march(t(np.asarray(jx.P0)), 5).numpy()
    assert np.isfinite(out).all()
    assert chan_err(ref, out) < 1e-3, chan_err(ref, out)
    assert not any(K.launches.values())


# -- inside the port: gather against block ------------------------------------

@pytest.mark.parametrize("variant", ["plain", "low_order", "fix"])
def test_gather_matches_block_rhs(setup, variant):
    """tests/test_block_ops.py::test_rhs_parity (and `_te_fix`) on the
    port: 2e-4."""
    jx, pt, blk, _ = setup
    P = t(perturbed(jx))
    _, kt = _rhs_kwargs(jx, variant)
    ref = te.euler_rhs(pt.dom.partitions[0], pt.fluid, P, **kt).numpy()
    out = bo.euler_rhs_block(blk.bt, blk.fluid, P, **kt).numpy()
    assert _scaled_err(ref, out) < 2e-4, _scaled_err(ref, out)


def test_gather_matches_block_dt_and_steps(setup):
    """dt rtol 1e-4; five `case.step`s of the two marches from the same
    state under 1e-3 (tests/test_block_ops.py:121, 146-147)."""
    jx, pt, blk, _ = setup
    dt_ref = te.local_timestep(pt.dom.partitions[0], pt.fluid, pt.P0, 0.7)
    _, dt_blk, _ = bo.euler_rhs_block(blk.bt, blk.fluid, pt.P0, with_dt=True,
                                      cfl=0.7)
    np.testing.assert_allclose(dt_blk.numpy(), dt_ref.numpy(), rtol=1e-4)
    Pg = Pb = pt.P0
    for _ in range(5):
        Pg, _ = pt.step(Pg)
        Pb, _ = blk.step(Pb)
    assert chan_err(Pg.numpy(), Pb.numpy()) < 1e-3


@pytest.mark.parametrize("mu", ["none", "field"])
def test_viscous_block_parity(setup, mu):
    """tests/test_viscous.py::test_viscous_block_parity on the port
    (`euler_rhs_grid(viscous=True, mu_t3=)` against the gather path, 2e-4),
    and the block result against the JAX package's."""
    jx, pt, blk, _ = setup
    rng = np.random.default_rng(3)
    P = np.array(jx.P0, np.float32)
    x, y = jx.dom.centers[:, 0], jx.dom.centers[:, 1]
    P[:, 0] *= (1.0 + 0.05 * np.sin(x) * np.cos(y)).astype(np.float32)
    P[:, 2] += (25.0 * np.sin(y) + rng.standard_normal(x.size)).astype(
        np.float32)
    P[:, 3] += 12.0 * np.cos(x).astype(np.float32)
    mu_t = _mu_t(jx.dom)
    bt = blk.bt
    kg = dict(mu_t=t(mu_t)) if mu == "field" else {}
    kb = dict(mu_t3=bo.to_blocks(bt, t(mu_t)[:, None])) if mu == "field" \
        else {}
    ref = te.euler_rhs(pt.dom.partitions[0], pt.fluid, t(P), viscous=True,
                       **kg).numpy()
    out = bo.to_flat(bt, bo.euler_rhs_grid(
        bt, blk.fluid, bo.to_blocks(bt, t(P)), viscous=True, **kb)).numpy()
    assert _scaled_err(ref, out) < 2e-4, _scaled_err(ref, out)
    inviscid = bo.euler_rhs_block(bt, blk.fluid, t(P)).numpy()
    assert np.abs(out - inviscid)[:, 2:].max() > 0

    from ibx.topology.blocks import build_block_tables as jx_block_tables
    jbt = jx_block_tables(jx.dom)
    kj = dict(mu_t3=jbo.to_blocks(jbt, jnp.asarray(mu_t)[:, None])) \
        if mu == "field" else {}
    jref = np.asarray(jbo.euler_rhs_grid(
        jbt, jx.fluid, jbo.to_blocks(jbt, jnp.asarray(P)), viscous=True,
        **kj)).reshape(-1, 4)
    assert _scaled_err(jref, out) < 2e-4, _scaled_err(jref, out)


def test_block_cut3_all_open_is_plain_rhs(setup):
    """The block RHS's ``cut3`` (the cut-cell wall) with an all-open
    geometry (no cut face, no wall cell, alpha = 1) leaves R and dt
    bit-equal to the plain block RHS; an incomplete table raises."""
    _, _, blk, _ = setup
    P3 = bo.to_blocks(blk.bt, torch.as_tensor(perturbed(blk, seed=4)))
    empty = np.zeros(0, np.int32)
    cm = dict(owner=[empty] * 2, neighbor=[empty] * 2,
              wr=[np.zeros(0, np.float32)] * 2,
              wl=[np.zeros(0, np.float32)] * 2, wall_cells=empty,
              wall_coef=np.zeros((0, 2), np.float32),
              xw_rel=np.zeros((0, 2), np.float32),
              alpha=np.ones(blk.dom.ncells, np.float32),
              inv_alpha=np.ones(blk.dom.ncells, np.float32))
    R, dt, _ = bo.euler_rhs_grid(blk.bt, blk.fluid, P3, with_dt=True,
                                 cfl=0.7)
    Rc, dtc, _ = bo.euler_rhs_grid(blk.bt, blk.fluid, P3, with_dt=True,
                                   cfl=0.7,
                                   cut3=cut3_from_numpy(cm, blk.bt, "cpu"))
    assert torch.equal(R, Rc) and torch.equal(dt, dtc)
    with pytest.raises(KeyError):
        bo.euler_rhs_grid(blk.bt, blk.fluid, P3, cut3={})


# -- the reference's README recipes on the port's operator API ---------------

@pytest.fixture(scope="module")
def channel():
    """tests/test_viscous.py:16-27."""
    lower = tg.polyline(np.array([[0.0, 0.0], [1.0, 0.0]]), closed=False)
    msh = tg.build_mesh([0.0, 0.0], [1.0, 1.0], ("wall", lower, 5e-2),
                        block_size=4)
    return Domain(msh, hypercube_families=[
        ("io", [(0, False), (0, True), (1, True)])], device="cpu")


def test_viscous_rhs_finite_and_dissipative(channel):
    dom = channel
    part = dom.partitions[0]
    fluid = make_fluid()
    N = dom.ncells
    P = np.tile(np.array([1.0e5, 288.15, 0.0, 0.0], np.float32), (N, 1))
    P[:, 2] = 50.0 * dom.centers[:, 1]
    P = t(P)
    R_inv = te.euler_rhs(part, fluid, P, viscous=False).numpy()
    R_vis = te.euler_rhs(part, fluid, P, viscous=True).numpy()
    assert np.isfinite(R_vis).all()
    assert np.abs((R_vis - R_inv)[:, 2]).max() > 0
    R_t = te.euler_rhs(part, fluid, P, viscous=True,
                       mu_t=torch.full((N,), 1e-4)).numpy()
    assert np.isfinite(R_t).all()
    assert np.abs(R_t - R_vis).max() > 0


@pytest.fixture(scope="module")
def adv():
    """tests/test_advection.py:19-36."""
    lower = tg.polyline(np.array([[0.0, 0.0], [1.0, 0.0]]), closed=False)
    upper = tg.polyline(np.array([[0.0, 0.0], [0.0, 1.0]]), closed=False)
    msh = tg.build_mesh(
        [0.0, 0.0], [1.0, 1.0],
        ("lower", lower, 2e-2),
        ("upper", upper, 2e-2),
        refinement_regions=[
            (tg.Line([0.0, 0.0], [1.0, 1.0]), 4e-2),
            (tg.Line([0.0, 0.0], [0.5, 0.5]), 2e-2),
        ],
    )
    return Domain(msh, hypercube_families=[
        ("outlet", [(0, True), (1, True)])], device="cpu")


def test_advection_end_to_end(adv):
    """tests/test_advection.py::test_advection_end_to_end with the same
    800 steps and assertions, on `ibx_torch.ops.operators` and
    `Domain.impose_bc`."""
    dom = adv
    part = dom.partitions[0]
    N = dom.ncells
    C = (torch.ones(N), torch.ones(N))

    def apply_bcs(u):
        u = dom.impose_bc("upper", lambda b, ui: torch.ones_like(ui), u)
        u = dom.impose_bc("lower", lambda b, ui: torch.zeros_like(ui), u)
        return dom.impose_bc("outlet", lambda b, ui: ui, u)

    bound = torch.maximum(
        ops.unsigned_green_gauss(part, ops.at_faces(part, C[0], 0), 0),
        ops.unsigned_green_gauss(part, ops.at_faces(part, C[1], 1), 1))
    dt = 0.75 * 0.5 / bound.max()

    def residual(u):
        D = ops.jst_sensor(part, u)
        ud = torch.zeros_like(u)
        for dim in range(2):
            Cf = ops.at_faces(part, C[dim], dim)
            du = ops.cell_gradient(part, u, dim)
            uL, uR = ops.muscl(part, u, du, dim, D=D, high_order=True)
            flux = (uL + uR) * Cf / 2 + Cf.abs() * (uL - uR) / 2
            ud = ud - ops.green_gauss(part, flux, dim)
        return ud

    u = apply_bcs(torch.zeros(N))
    for _ in range(800):
        u = apply_bcs(u + residual(u) * dt)
    un = u.numpy()
    assert np.isfinite(un).all()
    x, y = dom.centers[:, 0], dom.centers[:, 1]
    assert un[(y - x) > 0.15].min() > 0.85
    assert np.abs(un[(x - y) > 0.15]).max() < 0.15
    assert un.min() > -0.05 and un.max() < 1.05


def test_dissipation_end_to_end(adv):
    """tests/test_advection.py::test_dissipation_end_to_end, 400 steps."""
    dom = adv
    part = dom.partitions[0]
    N = dom.ncells

    def apply_bcs(uv):
        uv = dom.impose_bc(
            "upper", lambda b, i: torch.tensor([1.0, 0.0]).expand(i.shape),
            uv)
        uv = dom.impose_bc(
            "lower", lambda b, i: torch.tensor([0.0, 1.0]).expand(i.shape),
            uv)
        return dom.impose_bc("outlet", lambda b, i: i, uv)

    bound = (
        ops.unsigned_green_gauss(part, 1.0 / ops.face_distance(part, 0), 0)
        + ops.unsigned_green_gauss(part, 1.0 / ops.face_distance(part, 1), 1)
    )
    dt = 0.5 / bound.max()
    uv = apply_bcs(torch.zeros((N, 2)))
    for _ in range(400):
        d = torch.zeros_like(uv)
        for dim in range(2):
            d = d + ops.green_gauss(
                part, ops.face_gradient(part, uv, dim), dim)
        uv = apply_bcs(uv + d * dt)
    uvn = uv.numpy()
    assert np.isfinite(uvn).all()
    assert uvn.min() > -0.01 and uvn.max() < 1.01
    interior = (dom.centers.min(axis=1) > 0.2) & (dom.centers.max(axis=1) < 0.8)
    assert uvn[interior].sum() > 0.1
