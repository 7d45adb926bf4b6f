"""Port parity for the 2D block operators (`ibx_torch.ops.block_ops` at
nd = 2: `interface_corrections`, `face_accumulate`, the generic sparse
leftover, `euler_rhs_grid` / `euler_rhs_block` with ``frozen`` and ``fix``,
`smooth_residual_grid`, `rk2_step_grid` with IRS, `euler_step_grid` and
`euler_step_block`) against the JAX package on the RAE2822 quadtree at
wall_h=8e-2 (2:1 interfaces on both sides of both dims, one-sided boundary
sides), and on the converged transonic state of
tests/data/rae2822_cp_medium.npz (37,120 cells, a shock on the mesh).

Both packages get the same numpy inputs: the JAX package's block tables
and ghost families go through `ibx_torch.convert.tables_from_numpy`, and
states are made from a seed with numpy. No kernel launches: the JAX
package's nd = 2 takes its XLA body, and the port's 2D kernel route
(`rhs_cs.euler_rhs_grid_2d`) runs the kernels' plain versions on CPU
tensors, which give the torch-op body's values bit for bit."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ibx.cases import build_rae2822 as jx_build_rae2822
from ibx.ops import block_ops as jbo
from ibx.topology.blocked_bc import _collect_families as jx_families
from ibx.topology.blocks import _colid

from ibx_torch.convert import tables_from_numpy
from ibx_torch.ops import block_ops as bo
from ibx_torch.ops import kernels as K
from ibx_torch.ops import rhs_cs, scheme
from ibx_torch.ops.rhs_cs import pallas_eligible
from ibx_torch.physics.bc import apply_flow_bc, flow_bc
from ibx_torch.physics.fluid import make_fluid, physicality_guard

from test_torch_kernels import FAMILIES, chan_err, ibx_fields, t

torch.set_num_threads(2)
DATA = os.path.join(os.path.dirname(__file__), "data")


def port_case(jx):
    """(tb, apply_bcs3, active3) of the port from the JAX case's tables."""
    tb, bc = tables_from_numpy(ibx_fields(jx.grid["bt"]),
                               jx_families(jx.dom, FAMILIES), FAMILIES,
                               "cpu")
    fl = make_fluid()
    far = flow_bc(fl, jx.P_inf, device="cpu")
    wall = flow_bc(fl, [float(jx.P_inf[0]), 288.15, 0.0], normal_flow=True,
                   device="cpu")
    fns = {"farfield": lambda Pi, n: apply_flow_bc(far, Pi, n),
           "wall": lambda Pi, n: apply_flow_bc(wall, Pi, n)}

    def apply_bcs3(P3):
        return bc.apply_grid(P3, fns, guard=physicality_guard)

    return tb, apply_bcs3, t(jx.grid["active3"])


@pytest.fixture(scope="module")
def setup():
    jx = jx_build_rae2822(wall_h=8e-2, feature_h=4e-2, cfl=0.7)
    tb, apply_bcs3, active3 = port_case(jx)
    assert tb.nd == 2 and tb.n_sparse == 0
    return jx, tb, apply_bcs3, active3


def perturbed(jx, seed=0):
    """The state of tests/test_block_ops.py::test_rhs_parity plus
    independent noise in u and v (a transposed edge line would pass a
    smooth field)."""
    rng = np.random.default_rng(seed)
    P = np.array(jx.P0, np.float32)
    x, y = jx.dom.centers[:, 0], jx.dom.centers[:, 1]
    P[:, 0] *= 1.0 + 0.05 * np.sin(x) * np.cos(y)
    P[:, 1] *= 1.0 + 0.02 * np.cos(x)
    P[:, 2] += 20.0 * np.sin(y) + 5.0 * rng.standard_normal(P.shape[0])
    P[:, 3] += 10.0 * np.cos(x) + 5.0 * rng.standard_normal(P.shape[0])
    return P.astype(np.float32)


def te_fix(jx, r=0.3):
    x, y = jx.dom.centers[:, 0], jx.dom.centers[:, 1]
    d_te = np.sqrt((x - 1.0) ** 2 + y ** 2)
    return np.clip((2 * r - d_te) / r, 0.0, 1.0).astype(np.float32), d_te


def test_2d_takes_no_kernel_route(setup, monkeypatch):
    """The gate at nd = 2: the plain Euler configuration takes the kernel
    route (`rhs_cs.euler_rhs_grid_2d`); frozen gradients, ``fix3``,
    ``cut3``, viscous fluxes, an ``mu_t3`` field and a sparse leftover
    keep the torch-op body. On CPU tensors the route launches no kernel:
    no launch is counted."""
    jx, tb, _, _ = setup
    assert pallas_eligible(tb)
    one = torch.ones(1)
    for kw in (dict(frozen=([one], one)), dict(fix3=one), dict(cut3={}),
               dict(viscous=True), dict(mu_t3=one)):
        assert not pallas_eligible(tb, **kw), kw
    assert not pallas_eligible(dataclasses.replace(tb, n_sparse=1))
    routed = []
    route = rhs_cs.euler_rhs_grid_2d
    monkeypatch.setattr(rhs_cs, "euler_rhs_grid_2d",
                        lambda *a, **k: routed.append(1) or route(*a, **k))
    K.reset_launches()
    fl, P = make_fluid(), t(perturbed(jx))
    bo.euler_rhs_block(tb, fl, P)
    assert routed == [1]
    bo.euler_rhs_block(tb, fl, P, fix=torch.zeros(tb.n_cells))
    bo.euler_rhs_block(tb, fl, P, kernels=False)
    assert routed == [1]
    assert not any(K.launches.values())


def _nested_equal(a, b):
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_nested_equal(x, y)
                                        for x, y in zip(a, b))
    return a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("high_order", [True, False])
@pytest.mark.parametrize("with_dt", [True, False])
def test_plain_2d_passes_match_op_body(setup, with_dt, high_order):
    """The 2D kernel route on CPU tensors (the plain versions of
    `kernels.euler_pass_a_2d` / `euler_pass_b_2d` with the route's 2:1
    glue) against the torch-op body (`_euler_rhs_ops`): R, and with dt
    the dt bound, du and nu, equal bit for bit. Tolerance 0: the plain
    versions repeat the body's operations in its order, 2:1 corrections
    included (pass B adds each dim's before it sums the dims, as the body
    does); the CUDA kernels are held to the plain versions on the card
    (chip_smoke.py). The fixture has 2:1 rows on both sides of both
    dims; the state is column-major, as a restart file loads, which the
    route must take."""
    jx, tb, _, _ = setup
    assert all(int((tb.fold_rows[:, q] >= 0).sum()) > 0 for q in range(4))
    P = t(perturbed(jx, seed=3)).t().contiguous().t()
    fl, P3 = make_fluid(), bo.to_blocks(tb, P)
    assert not P3.is_contiguous()
    K.reset_launches()
    out = rhs_cs.euler_rhs_grid_2d(tb, fl, P3, high_order=high_order,
                                   with_dt=with_dt, cfl=0.7)
    ref = bo._euler_rhs_ops(tb, fl, P3, high_order, with_dt, 0.7, None,
                            None, False, None, None)
    assert _nested_equal(out, ref)
    assert not any(K.launches.values())


def _edge_line(tb, d, s):
    """[B, bs, bs] bool: the cells of each block's side-s edge along d."""
    bs = tb.block_size
    m = torch.zeros((tb.n_blocks, bs, bs), dtype=torch.bool)
    m.select(2 - d, bs - 1 if s else 0).fill_(True)
    return m


@pytest.mark.parametrize("side", [(0, 0), (0, 1), (1, 0), (1, 1)])
def test_plain_2d_corrections_reach_their_side(setup, side):
    """Each 2:1 side's compact rows land on that side's edge line and
    nowhere else: with side (d, s)'s rows dropped (-1), pass A's du_d and
    pass B's R change on the edge line of every block with a row there,
    and nowhere else; the other dim's du does not change."""
    jx, tb, _, _ = setup
    d, s = side
    fl, bs = make_fluid(), tb.block_size
    P3 = bo.to_blocks(tb, t(perturbed(jx, seed=4)))
    rng = np.random.default_rng(30 + 2 * d + s)
    V = int((tb.fold_rows >= 0).sum())
    valsA = t(rng.uniform(1.0, 2.0, (V, bs, 7)))
    valsB = t(rng.uniform(1.0, 2.0, (V, bs, 4)))
    dropped = tb.fold_rows.clone()
    dropped[:, 2 * d + s] = -1
    want = _edge_line(tb, d, s) & (tb.fold_rows[:, 2 * d + s] >= 0)[
        :, None, None]
    assert want.any()
    a = [K.euler_pass_a_2d(fl, P3, tb.meta, tb.nbr_table, rows, valsA,
                           with_dt=True, cfl=0.7)
         for rows in (tb.fold_rows, dropped)]
    assert torch.equal((a[0][d] != a[1][d]).any(dim=-1), want)
    assert torch.equal(a[0][1 - d], a[1][1 - d])
    du_x, du_y, nu, _ = a[0]
    R = [K.euler_pass_b_2d(fl, P3, du_x, du_y, nu, tb.meta, tb.nbr_table,
                           rows, valsB, high_order=True)
         for rows in (tb.fold_rows, dropped)]
    assert torch.equal((R[0] != R[1]).any(dim=-1), want)


@pytest.mark.parametrize("variant", ["plain", "low_order", "frozen", "fix"])
def test_euler_rhs_block_matches_ibx(setup, variant):
    """`euler_rhs_block` against the JAX package's: R < 2e-4 per channel
    (scaled by the channel's max + 1e-3, as tests/test_block_ops.py), dt
    rtol 1e-4, du and nu 1e-4 per channel. ``frozen`` feeds both the JAX
    gradients; ``fix`` must change R where the blend is on and nowhere
    beyond its reach."""
    jx, tb, _, _ = setup
    bt, jfl, fl = jx.grid["bt"], jx.fluid, make_fluid()
    P = perturbed(jx)
    kw, jkw = {}, {}
    if variant == "low_order":
        kw = jkw = dict(high_order=False)
    if variant == "fix":
        fix, d_te = te_fix(jx)
        kw, jkw = dict(fix=t(fix)), dict(fix=jnp.asarray(fix))
    if variant == "frozen":
        _, _, fr = jbo.euler_rhs_block(bt, jfl, jnp.asarray(P), with_dt=True,
                                       cfl=0.7)
        R_ref = jbo.euler_rhs_block(bt, jfl, jnp.asarray(P) * 1.001,
                                    frozen=fr)
        R = bo.euler_rhs_block(tb, fl, t(P) * 1.001,
                               frozen=([t(x) for x in fr[0]], t(fr[1])))
    else:
        # op by op, not jitted: XLA's fusion moves du by a few 1e-4
        R_ref, dt_ref, (du_ref, nu_ref) = jbo.euler_rhs_block(
            bt, jfl, jnp.asarray(P), with_dt=True, cfl=0.7, **jkw)
        R, dt, (du, nu) = bo.euler_rhs_block(tb, fl, t(P), with_dt=True,
                                             cfl=0.7, **kw)
        np.testing.assert_allclose(dt.numpy(), np.asarray(dt_ref), rtol=1e-4)
        for d in range(2):
            assert chan_err(du_ref[d], du[d]) < 1e-4, d
        assert chan_err(np.asarray(nu_ref)[:, None], nu[:, None]) < 1e-4
        # without dt the same R comes back
        assert torch.equal(R, bo.euler_rhs_block(tb, fl, t(P), **kw))
    assert chan_err(R_ref, R, floor=1e-3) < 2e-4, \
        chan_err(R_ref, R, floor=1e-3)
    if variant == "fix":
        changed = (R - bo.euler_rhs_block(tb, fl, t(P))).abs().amax(dim=1)
        assert changed[t(fix) > 0.5].max() > 0
        assert changed[t(d_te) > 2 * 0.3 + 0.5].max() == 0.0


def _face_fns(xp_cat, xp_abs):
    def fn(Wo, Wn, ho, hn):
        f = (Wo * hn + Wn * ho) / (ho + hn)
        dlt = Wn[..., 0:1] - Wo[..., 0:1]
        return xp_cat([f, dlt * ho, xp_abs(dlt)])

    return fn


@pytest.mark.parametrize("d", [0, 1])
@pytest.mark.parametrize("op", ["interface_corrections", "face_accumulate"])
def test_face_ops_match_ibx(setup, op, d):
    """`interface_corrections` (its compact rows placed into the JAX
    package's grids) and `face_accumulate` alone, per dim, on random
    3-channel cells with a signed/unsigned channel mix: 1e-5 per channel."""
    jx, tb, _, _ = setup
    bt = jx.grid["bt"]
    rng = np.random.default_rng(20 + d)
    W = rng.standard_normal((bt.n_cells, 3)).astype(np.float32)
    signed = [1.0, 1.0, 1.0, 0.0, 0.0]
    jfn = _face_fns(lambda xs: jnp.concatenate(xs, axis=-1), jnp.abs)
    pfn = _face_fns(lambda xs: torch.cat(xs, dim=-1), torch.abs)
    W3j = jbo.to_blocks(bt, jnp.asarray(W))
    W3 = bo.to_blocks(tb, t(W))
    if op == "face_accumulate":
        ref = jbo.face_accumulate(bt, d, W3j, jfn, 5, signed)
        out = bo.face_accumulate(tb, d, W3, pfn, 5, signed)
        assert chan_err(ref, out, axis=-1) < 1e-5, chan_err(ref, out, -1)
        return
    ref = jbo.interface_corrections(bt, d, W3j, jfn, 5, signed)
    out = scheme.interface_corrections(tb, d, pfn, signed,
                                       bo._grid_edge_fetch(tb, (W3,), d))
    for s in (0, 1):
        assert (ref[s] is None) == (out[s] is None)
        blocks, vals = out[s]
        assert blocks.shape[0] > 0 and vals.shape[1:] == (tb.block_size, 5)
        placed = torch.zeros((tb.n_blocks,) + tuple(vals.shape[1:]))
        placed[blocks] = vals
        assert chan_err(ref[s], placed, axis=-1) < 1e-5, (s, chan_err(
            ref[s], placed, -1))


@pytest.mark.parametrize("with_active", [False, True])
def test_smooth_residual_grid_matches_ibx(setup, with_active):
    """IRS sweeps on a random residual: 1e-5 per channel; a zero residual
    stays zero; frozen cells keep their input."""
    jx, tb, _, active3 = setup
    bt = jx.grid["bt"]
    rng = np.random.default_rng(4)
    R = rng.standard_normal((bt.n_cells, 4)).astype(np.float32)
    ja = jx.grid["active3"] if with_active else None
    pa = active3 if with_active else None
    ref = jbo.smooth_residual_grid(bt, jbo.to_blocks(bt, jnp.asarray(R)),
                                   eps=0.6, active3=ja)
    R3 = bo.to_blocks(tb, t(R))
    out = bo.smooth_residual_grid(tb, R3, eps=0.6, active3=pa)
    assert chan_err(ref, out, axis=-1) < 1e-5, chan_err(ref, out, -1)
    assert out.abs().max() <= R3.abs().max() * 1.001
    zero = bo.smooth_residual_grid(tb, torch.zeros_like(R3), eps=0.6,
                                   active3=pa)
    assert zero.abs().max() == 0.0
    if with_active:
        assert torch.equal(out[active3 == 0], R3[active3 == 0])


@pytest.mark.parametrize("entry", ["rk2_step_grid_irs", "rk2_step_grid_fix",
                                   "euler_step_grid", "euler_step_block",
                                   "rk2_step_block"])
def test_step_entry_points_match_ibx(setup, entry):
    """One step of each march entry against the JAX package's, same BCs and
    freeze mask: state < 1e-4 per channel, resnorm 1e-4 relative."""
    jx, tb, apply_bcs3, active3 = setup
    bt, jfl, fl = jx.grid["bt"], jx.fluid, make_fluid()
    P = perturbed(jx, seed=1)
    jP3, P3 = jbo.to_blocks(bt, jnp.asarray(P)), bo.to_blocks(tb, t(P))
    ja3, jbcs3 = jx.grid["active3"], jx.grid["apply_bcs3"]

    def flat_bcs(Pf):
        return bo.to_flat(tb, apply_bcs3(bo.to_blocks(tb, Pf)))

    if entry.startswith("rk2_step_grid"):
        kw = dict(cfl=1.2, irs_eps=0.5) if entry.endswith("irs") \
            else dict(cfl=0.7)
        jkw = dict(kw)
        if entry.endswith("fix"):
            fix = te_fix(jx)[0]
            jkw["fix3"] = jbo.to_blocks(bt, jnp.asarray(fix)[:, None])
            kw["fix3"] = bo.to_blocks(tb, t(fix)[:, None])
        ref, res_ref = jbo.rk2_step_grid(bt, jfl, jP3, jbcs3, active3=ja3,
                                         **jkw)
        out, res = bo.rk2_step_grid(tb, fl, P3, apply_bcs3, active3=active3,
                                    **kw)
    elif entry == "euler_step_grid":
        ref, res_ref = jbo.euler_step_grid(bt, jfl, jP3, jbcs3, active3=ja3)
        out, res = bo.euler_step_grid(tb, fl, P3, apply_bcs3,
                                      active3=active3)
    else:
        jstep, pstep = getattr(jbo, entry), getattr(bo, entry)
        ref, res_ref = jstep(bt, jfl, jnp.asarray(P), jx.apply_bcs,
                             active=ja3.reshape(-1))
        out, res = pstep(tb, fl, t(P), flat_bcs, active=active3.reshape(-1))
    ref, out = np.asarray(ref).reshape(-1, 4), out.reshape(-1, 4).numpy()
    assert np.isfinite(out).all()
    assert chan_err(ref, out) < 1e-4, chan_err(ref, out)
    assert abs(float(res) - float(res_ref)) <= 1e-4 * abs(float(res_ref))


def test_sparse_leftover_matches_dense(setup):
    """The generic sparse leftover: the faces of one dense block side per
    dim are switched off (``edge_valid = 0`` on both blocks) and listed in
    ``sp_owner`` / ``sp_neighbor`` with weights 1. Each package must give
    its own undoctored R within 1e-5 per channel (the same face values,
    accumulated by scatter-add instead of the dense shift), and the two
    packages agree within 2e-4."""
    jx, tb, _, _ = setup
    bt = jx.grid["bt"]
    f = ibx_fields(bt)
    bs, B = bt.block_size, bt.n_blocks
    ev = [[np.array(f["edge_valid"][d][s]) for s in range(2)]
          for d in range(2)]
    sp = {k: [] for k in ("sp_owner", "sp_neighbor", "sp_wr", "sp_wl")}
    j = np.arange(bs)
    for d in range(2):
        dense = (f["edge_valid"][d][1] > 0) & (f["bnd"][d][1] == 0)
        b = int(np.nonzero(dense)[0][B // 7])
        nb = int(f["nbr"][d][1][b])
        assert f["edge_valid"][d][0][nb] > 0 and f["nbr"][d][0][nb] == b
        ev[d][1][b] = 0.0
        ev[d][0][nb] = 0.0
        sp["sp_owner"].append(_colid(bs, 2, d, 1, b, j).astype(np.int32))
        sp["sp_neighbor"].append(_colid(bs, 2, d, 0, nb, j).astype(np.int32))
        sp["sp_wr"].append(np.ones(bs, np.float32))
        sp["sp_wl"].append(np.ones(bs, np.float32))
    doctored = dict(f, edge_valid=tuple(tuple(e) for e in ev),
                    **{k: tuple(v) for k, v in sp.items()})
    tb_d, _ = tables_from_numpy(doctored, jx_families(jx.dom, FAMILIES),
                                FAMILIES, "cpu")
    assert tb_d.n_sparse == 2 * bs and tb_d.spacing_flat is not None
    bt_d = dataclasses.replace(
        bt,
        edge_valid=tuple(tuple(jnp.asarray(e) for e in ed) for ed in ev),
        **{k: tuple(jnp.asarray(a) for a in v) for k, v in sp.items()})

    P = perturbed(jx, seed=2)
    fl, jfl = make_fluid(), jx.fluid
    R = bo.euler_rhs_block(tb, fl, t(P))
    R_d, dt_d, _ = bo.euler_rhs_block(tb_d, fl, t(P), with_dt=True, cfl=0.7)
    Rj = jbo.euler_rhs_block(bt, jfl, jnp.asarray(P))
    Rj_d = jbo.euler_rhs_block(bt_d, jfl, jnp.asarray(P))
    assert chan_err(R, R_d, floor=1e-3) < 1e-5, chan_err(R, R_d, floor=1e-3)
    assert chan_err(Rj, Rj_d, floor=1e-3) < 1e-5, \
        chan_err(Rj, Rj_d, floor=1e-3)
    assert chan_err(Rj_d, R_d, floor=1e-3) < 2e-4
    # the leftover's wave-speed sums reach the dt bound too
    _, dt, _ = bo.euler_rhs_block(tb, fl, t(P), with_dt=True, cfl=0.7)
    np.testing.assert_allclose(dt_d.numpy(), dt.numpy(), rtol=1e-5)
    # and they were needed: without them the doctored tables lose the faces
    empty = {k: tuple(np.zeros(0, a.dtype) for a in v)
             for k, v in sp.items()}
    tb_e, _ = tables_from_numpy(dict(doctored, **empty),
                                jx_families(jx.dom, FAMILIES), FAMILIES,
                                "cpu")
    R_e = bo.euler_rhs_block(tb_e, fl, t(P))
    assert chan_err(R, R_e, floor=1e-3) > 1e-3


@pytest.fixture(scope="module")
def medium():
    ref = np.load(os.path.join(DATA, "rae2822_cp_medium.npz"))
    meta = json.loads(str(ref["meta"]))
    jx = jx_build_rae2822(wall_h=meta["wall_h"], feature_h=meta["feature_h"],
                          cfl=meta["cfl"])
    assert jx.dom.ncells == ref["P"].shape[0] == 37120
    return jx, port_case(jx), np.asarray(ref["P"], np.float32)


@pytest.mark.parametrize("what", ["rhs", "step"])
def test_converged_transonic_state_matches_ibx(medium, what):
    """From the converged medium state (a shock on the mesh): one RHS (R
    < 2e-4 per channel, dt rtol 1e-4) and one RK2 step (state < 1e-4 per
    channel, resnorm 1e-4 relative) against the JAX package."""
    jx, (tb, apply_bcs3, active3), P = medium
    bt, jfl, fl = jx.grid["bt"], jx.fluid, make_fluid()
    P = np.asarray(jx.apply_bcs(jnp.asarray(P)))
    mach = np.hypot(P[:, 2], P[:, 3]) / np.sqrt(1.4 * 283.0 * P[:, 1])
    assert mach.max() > 1.1           # the supersonic pocket is there
    if what == "rhs":
        R_ref, dt_ref, _ = jax.jit(
            lambda Pj: jbo.euler_rhs_block(bt, jfl, Pj, with_dt=True,
                                           cfl=0.7))(jnp.asarray(P))
        R, dt, _ = bo.euler_rhs_block(tb, fl, t(P), with_dt=True, cfl=0.7)
        np.testing.assert_allclose(dt.numpy(), np.asarray(dt_ref), rtol=1e-4)
        assert chan_err(R_ref, R, floor=1e-3) < 2e-4, \
            chan_err(R_ref, R, floor=1e-3)
        return
    ref, res_ref = jax.jit(lambda P3: jbo.rk2_step_grid(
        bt, jfl, P3, jx.grid["apply_bcs3"], cfl=0.7,
        active3=jx.grid["active3"]))(jbo.to_blocks(bt, jnp.asarray(P)))
    out, res = bo.rk2_step_grid(tb, fl, bo.to_blocks(tb, t(P)), apply_bcs3,
                                cfl=0.7, active3=active3)
    ref, out = np.asarray(ref).reshape(-1, 4), out.reshape(-1, 4).numpy()
    assert chan_err(ref, out) < 1e-4, chan_err(ref, out)
    assert abs(float(res) - float(res_ref)) <= 1e-4 * abs(float(res_ref))
