"""Port parity for the cell-major grid march (`ibx_torch.ops.block_ops`:
`euler_rhs_grid` on its kernel route and its torch-op body,
`rk2_step_grid`; `GhostBC.apply_grid`; the sphere case's grid branch)
against the JAX package on the bs=4 sphere octree (2:1 interfaces in every
dim, one-sided boundary sides). Kernels run their plain versions.

On the CPU the JAX package's `euler_rhs_grid` takes its XLA body, and its
sphere case marches through `rk2_step_grid`; its kernel route is reached
by calling `euler_rhs_grid_pallas` directly (Pallas in interpret mode)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ibx.cases import build_sphere3d as jx_build_sphere3d
from ibx.ops import block_ops as jbo
from ibx.ops.pallas_rhs import euler_rhs_grid_pallas
from ibx.physics import make_fluid as jx_make_fluid
from ibx.physics.fluid import physicality_guard as jx_guard

from ibx_torch.cases import build_sphere3d
from ibx_torch.convert import cut3_from_numpy
from ibx_torch.ops import block_ops as bo
from ibx_torch.ops import kernels as K
from ibx_torch.physics.fluid import make_fluid

from test_pallas_rhs import _perturbed, sphere  # noqa: F401
from test_torch_kernels import chan_err, port_tables, t
from test_torch_sphere3d import _perturbed_flat

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def setup(sphere):  # noqa: F811
    dom, bt = sphere
    tb, _ = port_tables(dom, bt)
    return bt, tb, np.asarray(_perturbed(dom, bt))


@pytest.fixture(scope="module")
def cases():
    jx = jx_build_sphere3d(wall_h=0.25, block_size=4)
    pt = build_sphere3d(wall_h=0.25, block_size=4, device="cpu")
    assert "apply_bcs_cs" not in jx.grid      # the XLA grid branch
    return jx, pt


def _frozen_t(frozen):
    du, nu = frozen
    return [t(x) for x in du], t(nu)


@pytest.mark.parametrize("with_dt,fold", [(True, False), (False, True)])
def test_euler_rhs_grid_kernel_route_matches_ibx(setup, with_dt, fold,
                                                 monkeypatch):
    """Kernel route against `euler_rhs_grid_pallas` (IBX_CS_FOLD=1 for the
    folded plain-RHS call): R 2e-4 per channel, dt rtol 1e-5, du and nu
    1e-4 per channel."""
    bt, tb, P3 = setup
    if fold:
        monkeypatch.setenv("IBX_CS_FOLD", "1")
    ref = euler_rhs_grid_pallas(bt, jx_make_fluid(), jnp.asarray(P3),
                                with_dt=with_dt, cfl=0.5)
    out = bo.euler_rhs_grid(tb, make_fluid(), t(P3), with_dt=with_dt,
                            cfl=0.5, fold=fold)
    if with_dt:
        (ref, dt_ref, (du_ref, nu_ref)), (out, dt, (du, nu)) = ref, out
        np.testing.assert_allclose(dt.numpy(), np.asarray(dt_ref), rtol=1e-5)
        for d in range(3):
            assert chan_err(du_ref[d], du[d], axis=-1) < 1e-4, d
        assert chan_err(nu_ref, nu, axis=-1) < 1e-4
    assert chan_err(ref, out, axis=-1, floor=1e-3) < 2e-4, \
        chan_err(ref, out, -1, 1e-3)


@pytest.mark.parametrize("frozen", [False, True])
def test_euler_rhs_grid_body_matches_ibx(setup, frozen):
    """Torch-op body (kernels=False) against the XLA body, with and
    without frozen gradients: R 2e-4 per channel, dt rtol 1e-4."""
    bt, tb, P3 = setup
    fl, jfl = make_fluid(), jx_make_fluid()
    R_ref, dt_ref, fr_ref = jbo.euler_rhs_grid(bt, jfl, jnp.asarray(P3),
                                               with_dt=True, cfl=0.5)
    if frozen:
        R_ref = jbo.euler_rhs_grid(bt, jfl, jnp.asarray(P3) * 1.001,
                                   frozen=fr_ref)
        R = bo.euler_rhs_grid(tb, fl, t(P3) * 1.001, frozen=_frozen_t(fr_ref))
    else:
        R, dt, _ = bo.euler_rhs_grid(tb, fl, t(P3), with_dt=True, cfl=0.5,
                                     kernels=False)
        np.testing.assert_allclose(dt.numpy(), np.asarray(dt_ref), rtol=1e-4)
    assert chan_err(R_ref, R, axis=-1, floor=1e-3) < 2e-4, \
        chan_err(R_ref, R, -1, 1e-3)


def test_grid_bc_matches_blocked_bc(cases):
    """GhostBC.apply_grid vs BlockedBC.__call__: 2e-5 per channel, other
    cells untouched."""
    jx, pt = cases
    bt = jx.grid["bt"]
    P3 = np.asarray(jbo.to_blocks(bt, jnp.asarray(_perturbed_flat(jx))))
    ref = np.asarray(jx.grid["bbc"](jnp.asarray(P3), jx.grid["bc_fns"],
                                    guard=jx_guard))
    out = pt.apply_bcs3(t(P3)).numpy()
    assert chan_err(ref, out, axis=-1) < 2e-5, chan_err(ref, out, -1)
    keep = np.ones(P3.shape[:-1], bool).reshape(-1)
    keep[pt.bc.ghost_b.numpy() * 64 + pt.bc.ghost_w.numpy()] = False
    keep = keep.reshape(P3.shape[:-1])
    assert np.array_equal(out[keep], P3[keep])


@pytest.mark.parametrize("freeze_gradients", [False, True])
def test_rk2_step_grid_matches_ibx(cases, freeze_gradients):
    """One grid step (kernel route with the fold; stage 2 on the torch-op
    body when frozen) against `rk2_step_grid` + `BlockedBC`: < 1e-4 per
    channel, resnorm 1e-4 relative."""
    jx, pt = cases
    bt = jx.grid["bt"]
    P = _perturbed_flat(jx)
    ref, res_ref = jbo.rk2_step_grid(
        bt, jx.fluid, jbo.to_blocks(bt, jnp.asarray(P)),
        jx.grid["apply_bcs3"], cfl=0.7, active3=jx.grid["active3"],
        freeze_gradients=freeze_gradients)
    out, res = pt.step(t(P), grid=True, fold=True,
                       freeze_gradients=freeze_gradients)
    ref = np.asarray(ref).reshape(-1, 5)
    assert chan_err(ref, out.numpy()) < 1e-4, chan_err(ref, out.numpy())
    assert abs(float(res) - float(res_ref)) <= 1e-4 * abs(float(res_ref))


def test_march5_grid_matches_case_march(cases):
    """5 grid steps of the port's case (fold on) from the JAX case's
    initial state vs its `march` (the XLA grid branch on the CPU): < 1e-3
    per channel."""
    jx, pt = cases
    ref = np.asarray(jx.march(jx.P0, 5))
    out = pt.march(t(np.asarray(jx.P0)), 5, grid=True, fold=True).numpy()
    assert np.isfinite(out).all()
    assert chan_err(ref, out) < 1e-3, chan_err(ref, out)


def _cut_metrics(dom, seed=0, n_faces=40, n_wall=30):
    """A synthetic `cut_metrics_2d`-shaped table on ``dom``'s cells (nd
    dims): real interior faces of each dim with random closed fractions,
    random wall cells with wall vectors and offsets, fluid fractions in
    [0.3, 1]."""
    rng = np.random.default_rng(seed)
    nd, n = dom.centers.shape[1], dom.ncells
    cm = dict(owner=[], neighbor=[], wr=[], wl=[])
    for d in range(nd):
        faces = np.nonzero((dom.face_dim == d) & (dom.face_owner >= 0)
                           & (dom.face_neighbor >= 0))[0]
        pick = np.sort(rng.choice(faces, n_faces, replace=False))
        w = rng.uniform(0.0, 1.0, n_faces).astype(np.float32)
        cm["owner"].append(dom.face_owner[pick].astype(np.int32))
        cm["neighbor"].append(dom.face_neighbor[pick].astype(np.int32))
        cm["wr"].append(w)
        cm["wl"].append(w)
    cm["wall_cells"] = np.sort(rng.choice(n, n_wall, replace=False))
    cm["wall_coef"] = (rng.normal(size=(n_wall, nd)) * 1e-2).astype(
        np.float32)
    cm["xw_rel"] = (rng.normal(size=(n_wall, nd)) * 5e-2).astype(np.float32)
    cm["alpha"] = rng.uniform(0.3, 1.0, n).astype(np.float32)
    cm["inv_alpha"] = (1.0 / cm["alpha"]).astype(np.float32)
    return cm


def test_cs_march_refuses_freeze_gradients(cases):
    """``freeze_gradients`` on the channel-split march raises instead of
    being ignored: it needs the grid march."""
    pt = cases[1]
    with pytest.raises(ValueError, match="grid"):
        pt.step(pt.P0, freeze_gradients=True)


@pytest.mark.parametrize("option", ["viscous", "mu_t3", "cut3"])
def test_grid_options_match_ibx(setup, sphere, option):  # noqa: F811
    """``viscous``, ``mu_t3`` and ``cut3`` (the cut-cell wall's tables,
    here a synthetic set at nd = 3) on the grid path take the torch-op
    body (no kernel launch), change R and match the JAX grid path at 2e-4
    per channel (dt under ``cut3`` at rtol 1e-5)."""
    bt, tb, P3n = setup
    fl, P3 = make_fluid(), t(P3n)
    one = torch.ones(P3.shape[:-1] + (1,))
    if option == "cut3":
        cm = _cut_metrics(sphere[0])
        jcut = dict(
            owner=tuple(jnp.asarray(o) for o in cm["owner"]),
            neighbor=tuple(jnp.asarray(o) for o in cm["neighbor"]),
            wr=tuple(jnp.asarray(w) for w in cm["wr"]),
            wl=tuple(jnp.asarray(w) for w in cm["wl"]),
            wall_cells=jnp.asarray(cm["wall_cells"]),
            wall_coef=jnp.asarray(cm["wall_coef"]),
            xw_rel=jnp.asarray(cm["xw_rel"]),
            inv_alpha3=jbo.to_blocks(bt, jnp.asarray(cm["inv_alpha"])[:, None]),
            alpha3=jbo.to_blocks(bt, jnp.asarray(cm["alpha"])[:, None])[..., 0])
        R, dt, _ = jbo.euler_rhs_grid(bt, jx_make_fluid(), jnp.asarray(P3n),
                                      with_dt=True, cfl=0.7, cut3=jcut)
        K.reset_launches()
        out, dto, _ = bo.euler_rhs_grid(tb, fl, P3, with_dt=True, cfl=0.7,
                                        cut3=cut3_from_numpy(cm, tb, "cpu"))
        assert not any(K.launches.values())
        assert chan_err(np.asarray(R), out.numpy(), axis=-1,
                        floor=1e-3) < 2e-4
        dt = np.asarray(dt)
        assert np.abs(dto.numpy() - dt).max() <= 1e-5 * np.abs(dt).max()
        plain = bo.euler_rhs_grid(tb, fl, P3, kernels=False).numpy()
        assert np.abs(out.numpy() - plain).max() > 0
    else:
        kj = dict(viscous=True)
        kt = dict(viscous=True)
        if option == "mu_t3":
            kj["mu_t3"] = jnp.asarray(one.numpy() * 1e-4)
            kt["mu_t3"] = one * 1e-4
        ref = np.asarray(jbo.euler_rhs_grid(bt, jx_make_fluid(),
                                            jnp.asarray(P3n), **kj))
        K.reset_launches()
        out = bo.euler_rhs_grid(tb, fl, P3, **kt).numpy()
        assert not any(K.launches.values())
        assert chan_err(ref, out, axis=-1, floor=1e-3) < 2e-4
        plain = bo.euler_rhs_grid(tb, fl, P3, kernels=False).numpy()
        assert np.abs(out - plain).max() > 0


@pytest.mark.parametrize("option", ["fix3", "irs_eps"])
def test_3d_options_match_ibx(setup, cases, option):
    """The ``fix3`` blend and implicit residual smoothing at nd = 3 (both
    leave the kernel route for the torch-op body) against the JAX package:
    R 2e-4 per channel; one smoothed step < 1e-4 per channel."""
    bt, tb, P3 = setup
    fl, jfl = make_fluid(), jx_make_fluid()
    if option == "fix3":
        rng = np.random.default_rng(8)
        fix = (rng.uniform(size=P3.shape[:-1] + (1,)) ** 4).astype(
            np.float32)
        ref = jbo.euler_rhs_grid(bt, jfl, jnp.asarray(P3),
                                 fix3=jnp.asarray(fix))
        K.reset_launches()
        out = bo.euler_rhs_grid(tb, fl, t(P3), fix3=t(fix))
        assert not any(K.launches.values())
        assert chan_err(ref, out, axis=-1, floor=1e-3) < 2e-4, \
            chan_err(ref, out, -1, 1e-3)
        plain = bo.euler_rhs_grid(tb, fl, t(P3))
        assert chan_err(plain, out, axis=-1) > 1e-4
        return
    jx, pt = cases
    P = _perturbed_flat(jx)
    ref, res_ref = jbo.rk2_step_grid(
        jx.grid["bt"], jx.fluid, jbo.to_blocks(jx.grid["bt"], jnp.asarray(P)),
        jx.grid["apply_bcs3"], cfl=1.0, active3=jx.grid["active3"],
        irs_eps=0.5)
    out, res = bo.rk2_step_grid(pt.bt, pt.fluid, bo.to_blocks(pt.bt, t(P)),
                                pt.apply_bcs3, cfl=1.0, active3=pt.active3,
                                irs_eps=0.5)
    ref = np.asarray(ref).reshape(-1, 5)
    assert chan_err(ref, out.reshape(-1, 5).numpy()) < 1e-4
    assert abs(float(res) - float(res_ref)) <= 1e-4 * abs(float(res_ref))


@pytest.mark.parametrize("entry", ["euler_rhs_block", "euler_step_grid",
                                   "rk2_step_block"])
def test_grid_entry_points_match_ibx(cases, entry):
    """The single-stage step and the flat step against the JAX package's
    (kernel route against its XLA body): state < 1e-4 per channel, resnorm
    1e-4 relative. The flat RHS wrapper is `euler_rhs_grid` (held to the
    JAX package above) behind reshapes, so it must agree bitwise."""
    jx, pt = cases
    bt, tb = jx.grid["bt"], pt.bt
    P = _perturbed_flat(jx)
    if entry == "euler_rhs_block":
        R, dt, (du, nu) = bo.euler_rhs_block(tb, pt.fluid, t(P),
                                             with_dt=True, cfl=0.7)
        R3, dt3, (du3, nu3) = bo.euler_rhs_grid(
            tb, pt.fluid, bo.to_blocks(tb, t(P)), with_dt=True, cfl=0.7)
        for a, b in [(R, R3), (dt, dt3), (nu, nu3)] + list(zip(du, du3)):
            assert torch.equal(a, b.reshape(a.shape))
        R_f = bo.euler_rhs_block(tb, pt.fluid, t(P), frozen=(du, nu))
        assert torch.equal(R_f, bo.to_flat(tb, bo.euler_rhs_grid(
            tb, pt.fluid, bo.to_blocks(tb, t(P)), frozen=(du3, nu3))))
        return
    if entry == "euler_step_grid":
        ref, res_ref = jbo.euler_step_grid(
            bt, jx.fluid, jbo.to_blocks(bt, jnp.asarray(P)),
            jx.grid["apply_bcs3"], active3=jx.grid["active3"])
        out, res = bo.euler_step_grid(tb, pt.fluid, bo.to_blocks(tb, t(P)),
                                      pt.apply_bcs3, active3=pt.active3)
    else:
        ref, res_ref = jbo.rk2_step_block(
            bt, jx.fluid, jnp.asarray(P), jx.apply_bcs, cfl=0.7,
            active=jx.grid["active3"].reshape(-1))
        out, res = bo.rk2_step_block(
            tb, pt.fluid, t(P),
            lambda Pf: bo.to_flat(tb, pt.apply_bcs3(bo.to_blocks(tb, Pf))),
            cfl=0.7, active=pt.active3.reshape(-1), fold=True)
    ref, out = np.asarray(ref).reshape(-1, 5), out.reshape(-1, 5).numpy()
    assert chan_err(ref, out) < 1e-4, chan_err(ref, out)
    assert abs(float(res) - float(res_ref)) <= 1e-4 * abs(float(res_ref))
