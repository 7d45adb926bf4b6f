"""The 2D 2:1 interface rows (`kernels.interface_a_2d` / `interface_b_2d`
and their row table `BlockTables.ifc_rows`) on CPU tensors, where the
plain versions run: bit for bit the rows of the torch-op glue they
replace (`scheme.interface_corrections` over `block_ops
._grid_edge_fetch`, concatenated in the order `BlockTables.fold_rows`
numbers them), on the port's RAE2822 at wall_h=8e-2 (2:1 rows on both
sides of both dims) and on a synthetic bs=4 mesh that holds both fine-side
quadrant offsets and a coarse side on each side of each dim. Torch only;
the CUDA kernels are held to these plain versions on the card
(chip_smoke.py phase 10)."""

import numpy as np
import pytest
import torch

from ibx_torch.cases import build_rae2822
from ibx_torch.ops import block_ops as bo
from ibx_torch.ops import kernels as K
from ibx_torch.ops import rhs_cs, scheme
from ibx_torch.physics.fluid import make_fluid, speed_of_sound
from ibx_torch.topology.blocks import BlockTables

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def rae():
    case = build_rae2822(wall_h=8e-2, feature_h=4e-2, cfl=0.7, device="cpu")
    assert case.bt.nd == 2 and case.bt.n_sparse == 0
    return case


def flow_state(case, seed=3):
    """The case's freestream with the perturbation of
    tests/test_torch_block_ops_2d.py and independent noise in u and v (a
    transposed edge line would pass a smooth field), as blocks."""
    rng = np.random.default_rng(seed)
    P = case.P0.numpy().copy()
    x, y = case.dom.centers[:, 0], case.dom.centers[:, 1]
    P[:, 0] *= 1.0 + 0.05 * np.sin(x) * np.cos(y)
    P[:, 1] *= 1.0 + 0.02 * np.cos(x)
    P[:, 2] += 20.0 * np.sin(y) + 5.0 * rng.standard_normal(P.shape[0])
    P[:, 3] += 10.0 * np.cos(x) + 5.0 * rng.standard_normal(P.shape[0])
    return bo.to_blocks(case.bt, torch.as_tensor(P.astype(np.float32)))


def random_state(bt, seed):
    """A seeded state of independent cells over wide ranges: p, T in
    [0.5, 2] of the freestream's, u, v in [-300, 300]."""
    rng = np.random.default_rng(seed)
    shape = (bt.n_blocks, bt.block_size, bt.block_size)
    P = np.stack([101325.0 * rng.uniform(0.5, 2.0, shape),
                  288.15 * rng.uniform(0.5, 2.0, shape),
                  rng.uniform(-300.0, 300.0, shape),
                  rng.uniform(-300.0, 300.0, shape)], axis=-1)
    return torch.as_tensor(P.astype(np.float32))


def pass_b_operands(bt, fl, P3, seed):
    """du_x, du_y and nu: pass A's on the state (seed None), or seeded
    random fields (nu as 10^U(-7, 0), so that the JST blend does not hide
    the high-order face value)."""
    if seed is None:
        vals = K.interface_a_2d(fl, P3, bt.h, bt.ifc_rows, with_dt=False)
        du_x, du_y, nu, _ = K.euler_pass_a_2d(
            fl, P3, bt.meta, bt.nbr_table, bt.fold_rows, vals,
            with_dt=False, cfl=0.7)
        return du_x, du_y, nu
    rng = np.random.default_rng(seed)
    g = [torch.as_tensor(rng.normal(0.0, s, P3.shape).astype(np.float32))
         for s in (1e4, 1e4)]
    nu = 10.0 ** rng.uniform(-7, 0, P3.shape[:-1])
    return g[0], g[1], torch.as_tensor(nu.astype(np.float32))


def glue_rows(bt, fl, P3, pass_, flag, du=None):
    """The rows the torch-op glue gave: `interface_corrections` a dim over
    the edge planes of the grids (with the wave speed S_d appended for
    pass A with dt), the (d, s) sides' rows concatenated in order."""
    rows = []
    for d in range(2):
        if pass_ == "a":
            parts = (P3,)
            if flag:
                parts += (P3[..., 2 + d:3 + d].abs()
                          + speed_of_sound(fl, P3[..., 1])[..., None],)
            face = scheme.cat_fn(scheme.face_a(flag),
                                 [4, 1] if flag else [4])
            signed = [1.0] * 5 + [0.0] * (2 if flag else 1)
        else:
            du_x, du_y, nu = du
            parts = (P3, (du_x, du_y)[d], nu[..., None])
            face = scheme.cat_fn(scheme.face_b(fl, flag, d), [4, 4, 1])
            signed = [1.0] * 4
        cols = scheme.interface_corrections(
            bt, d, face, signed, bo._grid_edge_fetch(bt, parts, d))
        rows += [c[1] for c in cols if c is not None]
    return torch.cat(rows)


def plain_rows(bt, fl, P3, pass_, flag, du=None):
    if pass_ == "a":
        return K.interface_a_2d(fl, P3, bt.h, bt.ifc_rows, with_dt=flag)
    du_x, du_y, nu = du
    return K.interface_b_2d(fl, P3, du_x, du_y, nu, bt.h, bt.ifc_rows,
                            high_order=flag)


@pytest.mark.parametrize("pass_, flag, state", [
    ("a", True, "flow"), ("a", False, "flow"), ("b", True, "flow"),
    ("b", False, "flow"), ("a", True, "random"), ("b", True, "random")])
def test_plain_rows_match_glue(rae, pass_, flag, state):
    """The plain per-row rows against the glue's, tolerance 0: pass A with
    and without dt (``flag``), pass B in both ``high_order`` (``flag``), on
    the flow state and on a seeded random one (for pass B also random
    gradients and sensor). No launch is counted on CPU tensors."""
    bt, fl = rae.bt, make_fluid()
    if state == "flow":
        P3, seed = flow_state(rae), None
    else:
        P3, seed = random_state(bt, 11), 12
    du = pass_b_operands(bt, fl, P3, seed) if pass_ == "b" else None
    K.reset_launches()
    out = plain_rows(bt, fl, P3, pass_, flag, du)
    ref = glue_rows(bt, fl, P3, pass_, flag, du)
    V = int((bt.fold_rows >= 0).sum())
    width = (7 if flag else 6) if pass_ == "a" else 4
    assert out.shape == ref.shape == (V, bt.block_size, width)
    assert torch.equal(out, ref)
    assert bool(out.abs().amax() > 0)
    assert not any(K.launches.values())


def check_table(bt):
    """`ifc_rows` against `fold_rows` and the per-side tables: each row
    >= 0 of `fold_rows` names exactly one table row, which holds its
    block, d, s, kind and neighbors (and fs_off on the fine side)."""
    tab, fold = bt.ifc_rows.numpy(), bt.fold_rows.numpy()
    V = int((fold >= 0).sum())
    assert tab.shape == (V, 6) and tab.dtype == np.int32
    assert sorted(fold[fold >= 0].tolist()) == list(range(V))
    for d in range(2):
        for s in range(2):
            fsb = bt.fs_block[d][s].numpy()
            csb = bt.cs_block[d][s].numpy()
            for k, b in enumerate(fsb):
                want = [b, d, s, 0, int(bt.fs_coarse[d][s][k]),
                        int(bt.fs_off[d][s][k])]
                assert tab[fold[b, 2 * d + s]].tolist() == want
            for k, b in enumerate(csb):
                want = [b, d, s, 1] + bt.cs_fine[d][s][k].tolist()
                assert tab[fold[b, 2 * d + s]].tolist() == want
            assert (fold[:, 2 * d + s] >= 0).sum() == fsb.size + csb.size


def test_ifc_rows_match_fold_rows(rae):
    """The RAE2822 fixture's row table: every (d, s) side has fine- and
    coarse-side rows, each numbered as `fold_rows` numbers it."""
    bt = rae.bt
    for d in range(2):
        for s in range(2):
            assert bt.fs_block[d][s].shape[0] and bt.cs_block[d][s].shape[0]
    check_table(bt)


def synthetic_tables(bs=4):
    """Block tables of a coarse block (0, spacing 2/bs) with two fine
    blocks on each of its four sides (spacing 1/bs): block 1 + 2k + q on
    side k = 2d + s of the coarse block, at quadrant offset q. Each fine
    block faces the coarse one on its opposite side (d, 1 - s); its other
    sides, and the coarse block's, are one-sided boundary sides (the 2:1
    tables are all the rows read)."""
    B, nd = 9, 2
    h = np.full((B, nd), 1.0 / bs, np.float32)
    h[0] = 2.0 / bs
    e = [[np.zeros(0, np.int32) for _ in range(2)] for _ in range(nd)]
    fs_block, fs_coarse, fs_off = (
        [[np.zeros(0, np.int32) for _ in range(2)] for _ in range(nd)]
        for _ in range(3))
    cs_block = [[np.zeros(0, np.int32) for _ in range(2)] for _ in range(nd)]
    cs_fine = [[np.zeros((0, 2), np.int32) for _ in range(2)]
               for _ in range(nd)]
    for d in range(nd):
        for s in range(2):
            fine = np.array([1 + 2 * (2 * d + s), 2 + 2 * (2 * d + s)],
                            np.int32)
            cs_block[d][s] = np.array([0], np.int32)
            cs_fine[d][s] = fine[None]
            fs_block[d][1 - s] = fine
            fs_coarse[d][1 - s] = np.zeros(2, np.int32)
            fs_off[d][1 - s] = np.arange(2, dtype=np.int32)
    ones = [[np.ones(B, np.float32) for _ in range(2)] for _ in range(nd)]
    f = dict(
        nbr=[[np.arange(B, dtype=np.int32) for _ in range(2)]
             for _ in range(nd)],
        bnd=ones, edge_valid=ones, h=h, fs_block=fs_block,
        fs_coarse=fs_coarse, fs_off=fs_off, cs_block=cs_block,
        cs_fine=cs_fine, sp_owner=e[0], sp_neighbor=e[0], sp_wr=e[1],
        sp_wl=e[1],
        spacing_flat=np.repeat(h, bs ** nd, axis=0),
        n_blocks=B, block_size=bs, nd=nd, n_cells=B * bs ** nd)
    return BlockTables.from_numpy(f, "cpu")


@pytest.mark.parametrize("pass_, flag", [("a", True), ("a", False),
                                         ("b", True), ("b", False)])
def test_synthetic_mesh_rows(pass_, flag):
    """bs = 4: fine-side rows at both quadrant offsets and a coarse-side row
    on each side of each dim, in the table and in the rows, bit for bit
    against the glue on a seeded random state."""
    bt, fl = synthetic_tables(), make_fluid()
    check_table(bt)
    tab = bt.ifc_rows.numpy()
    for d in range(2):
        for s in range(2):
            side = tab[(tab[:, 1] == d) & (tab[:, 2] == s)]
            assert sorted(side[side[:, 3] == 0, 5].tolist()) == [0, 1]
            assert (side[:, 3] == 1).sum() == 1
    P3 = random_state(bt, 21)
    du = pass_b_operands(bt, fl, P3, 22) if pass_ == "b" else None
    out = plain_rows(bt, fl, P3, pass_, flag, du)
    assert torch.equal(out, glue_rows(bt, fl, P3, pass_, flag, du))


def test_route_takes_no_glue(rae, monkeypatch):
    """The 2D kernel route evaluates no `scheme.interface_corrections`:
    its 2:1 rows come from the interface wrappers, once a pass."""
    bt, fl = rae.bt, make_fluid()
    P3 = flow_state(rae)
    called = []
    for name in ("interface_a_2d", "interface_b_2d"):
        fn = getattr(rhs_cs, name)
        monkeypatch.setattr(rhs_cs, name, lambda *a, _n=name, _f=fn, **k:
                            called.append(_n) or _f(*a, **k))

    def glue(*a, **k):
        raise AssertionError("the 2D route ran the torch-op glue")

    monkeypatch.setattr(scheme, "interface_corrections", glue)
    R3, dt3, _ = rhs_cs.euler_rhs_grid_2d(bt, fl, P3, with_dt=True, cfl=0.7)
    assert called == ["interface_a_2d", "interface_b_2d"]
    assert bool(torch.isfinite(R3).all()) and bool((dt3 > 0).all())
