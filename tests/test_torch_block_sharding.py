"""Port parity of the sharded block march
(`ibx_torch.parallel.block_sharding`, `build_rae2822_block_sharded`)
against `ibx.parallel.block_sharding` and
`ibx.cases.rae2822_block_sharded` on RAE2822.

The host tables of every rank (block maps, offsets, send tables, the
`build_block_tables_raw` output of each rank's local grid, the ``ctx.bc``
tables, the overlap subsets and their block tables) are compared bit for
bit with the JAX package's stacked tables at P = 4, in this process with
no process group: JAX pads each rank's rows to a common length (2:1 rows
with the dump block, leftover rows with zeros), so a rank's rows are the
leading part of its JAX row. The marches run on 4 gloo ranks on the CPU
(`spawn`, once for the module) against the JAX package's sharded march on
its 4-device mesh."""

import numpy as np
import pytest
import torch

from ibx.cases.rae2822_block_sharded import (
    build_rae2822_block_sharded as jx_build)

from ibx_torch.cases import build_rae2822
from ibx_torch.parallel import DeviceMesh, ShardedBlockDomain, spawn
from ibx_torch.parallel.block_sharding import _subset_inputs
from ibx_torch.topology.blocks import build_block_tables_raw

from test_torch_sharded_ranks import (P_RANKS, RAE_SHOCKED, RAE_SMALL,
                                      RAE_VARIANTS, block_sharding_rank)

torch.set_num_threads(2)
ORACLE = "tests/data/rae2822_cp_coarse.npz"


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("block_sharding")
    spawn(block_sharding_rank, P_RANKS, backend="gloo", device="cpu",
          args=(str(d), ORACLE), threads=1)
    return dict(np.load(d / "out.npz"))


@pytest.fixture(scope="module")
def jx_runs():
    """label -> (JAX sharded block domain, 5-step state, resnorms); the
    overlap run's domain carries every table the port is held to."""
    out, case = {}, None
    for label, kw in RAE_VARIANTS.items():
        sbd, step, P, case = jx_build(P_RANKS, case=case, **RAE_SMALL, **kw)
        res = []
        for _ in range(5):
            P, r = step(P)
            res.append(float(r))
        out[label] = (sbd, sbd.collect(P), np.asarray(res))
    return out, case


def _err(ref, out):
    return float((np.abs(out - ref) / np.abs(ref).max(axis=0)).max())


def _rows(a, p):
    return np.asarray(a)[p]


def _check_raw(jt, raw, p, nd, dump):
    """Rank p's `build_block_tables_raw` output against row p of the JAX
    package's stacked tables ``jt`` (dense and per-block tables equal;
    2:1 and leftover tables equal on the port's length, JAX's padding
    after it inert)."""
    for key in ("nbr", "bnd", "edge_valid"):
        for d in range(nd):
            for s in range(2):
                a = _rows(jt[key][d][s], p)
                assert np.array_equal(a, raw[key][d][s]), (key, d, s)
    assert np.array_equal(_rows(jt["h"], p), raw["h"])
    assert np.array_equal(_rows(jt["spacing_flat"], p), raw["spacing_flat"])
    for key, fill in (("fs_block", dump), ("fs_coarse", dump),
                      ("fs_off", 0), ("cs_block", dump), ("cs_fine", dump)):
        for d in range(nd):
            for s in range(2):
                a, b = _rows(jt[key][d][s], p), raw[key][d][s]
                n = b.shape[0]
                assert np.array_equal(a[:n], b), (key, d, s)
                assert (a[n:] == fill).all(), (key, d, s)
    for key in ("sp_owner", "sp_neighbor", "sp_wr", "sp_wl"):
        for d in range(nd):
            a, b = _rows(jt[key][d][0], p), raw[key][d]
            assert a.dtype == b.dtype and np.array_equal(a[:b.size], b)
            assert not a[b.size:].any(), (key, d)


def test_tables_bit_equal(jx_runs):
    """Block maps, offsets, slots, send tables, every rank's raw local
    block tables and ``ctx.bc`` tables, and the overlap split (subgrid
    sources, frontier index and mask, the interior and frontier raw
    tables) equal the JAX package's at P = 4 with ``overlap=True``."""
    runs, jcase = jx_runs
    jsbd = runs["overlap"][0]
    case = build_rae2822(device="cpu", **RAE_SMALL)
    cpu = torch.device("cpu")
    sbd = ShardedBlockDomain(case.dom, DeviceMesh(0, P_RANKS, cpu),
                             overlap=True, bc_names=["farfield", "wall"])
    assert sbd.offs == jsbd.offs and sbd.S == jsbd.S
    assert sbd.B_loc == jsbd.B_loc and sbd.chunk == jsbd.chunk
    assert np.array_equal(sbd.l2g, jsbd._l2g)
    t = jsbd.tables
    for o in sbd.offs:
        assert np.array_equal(np.asarray(t["send_idx"][o]), sbd.send_idx[o])
    nd, dump = sbd.nd, sbd.B_loc - 1
    for p in range(P_RANKS):
        raw = build_block_tables_raw(**sbd.local_inputs(p))
        _check_raw(t["bt"], raw, p, nd, dump)
        bc = sbd.local_bc_tables(p)
        G, K = bc["idx"].shape
        for key in ("ghost", "eta", "normals", "family", "imd"):
            # the JAX package's device tables hold the int64 ghosts as int32
            ref = _rows(t["bc"][key], p)
            assert np.array_equal(ref[:G], bc[key]), key
        for key in ("idx", "w"):
            assert np.array_equal(_rows(t["bc"][key], p)[:G, :K], bc[key])
    assert sbd.overlap and jsbd.overlap
    for key in ("sub_src", "fr_idx", "fr_mask"):
        ref = np.asarray(t[key])
        assert ref.dtype == getattr(sbd, key).dtype
        assert np.array_equal(ref, getattr(sbd, key)), key
    for p in range(P_RANKS):
        _check_raw(t["bt_own"], build_block_tables_raw(**_subset_inputs(
            case.dom, sbd.own_blocks(p), sbd.B_own_loc)), p, nd,
            sbd.B_own_loc - 1)
        _check_raw(t["bt_sub"], build_block_tables_raw(**_subset_inputs(
            case.dom, sbd.sub_blocks[p], sbd.B_sub_loc)), p, nd,
            sbd.B_sub_loc - 1)


@pytest.mark.parametrize("label", list(RAE_VARIANTS))
def test_march_matches(ranks, jx_runs, label):
    """5 steps on 4 ranks against the JAX package's sharded march (plain,
    ``overlap=True``, ``te_fix_radius=0.3``): the state's per-channel
    scaled error under 2e-5 and the resnorm of each step within rtol 1e-3
    (as tests/test_block_sharding.py; measured 1.05e-5 in each variant,
    the resnorms 4.2e-7 and 7.6e-7 apart);
    the initial distribution round-trips exactly."""
    runs, jcase = jx_runs
    _, ref, res_ref = runs[label]
    assert np.array_equal(ranks[f"{label}_P0"], np.asarray(jcase.P0))
    assert bool(ranks[f"{label}_overlap"]) == (label == "overlap")
    out = ranks[label]
    assert np.isfinite(out).all()
    err = _err(ref, out)
    assert err < 2e-5, err
    np.testing.assert_allclose(ranks[f"{label}_res"], res_ref, rtol=1e-3)


def test_all_gather_flat_and_own_flat(ranks, jx_runs):
    """``ctx.all_gather_flat`` gives every rank the global flat state
    (equal to the case's ``P0``), and ``ctx.own_flat`` takes each rank's
    own grids back out of it (asserted on every rank)."""
    _, jcase = jx_runs
    assert np.array_equal(ranks["all_gather_flat"], np.asarray(jcase.P0))


def test_gather_bc_matches_ghost_bc():
    """``ctx.bc`` (per-ghost gathers over the ``ctx.bc`` tables, for
    callbacks that take the image distances) and ``ctx.bbc`` (the rank's
    `GhostBC`) give the same local grid on every rank, from a perturbed
    state: within 1e-6 of each channel's scale (measured 0)."""
    from ibx_torch.physics.fluid import physicality_guard

    case = build_rae2822(device="cpu", **RAE_SMALL)
    rng = np.random.default_rng(4)
    P = case.P0.numpy() * (1 + 0.05 * rng.standard_normal((1, 4)))
    P[:, 2:] += 10 * rng.standard_normal((P.shape[0], 2))
    P = torch.as_tensor(P.astype(np.float32))
    for p in range(P_RANKS):
        sbd = ShardedBlockDomain(case.dom, DeviceMesh(p, P_RANKS,
                                                      torch.device("cpu")),
                                 bc_names=["farfield", "wall"])
        shard = sbd.shard_fn(lambda ctx, loc: (
            ctx.bc(loc, case.bc_fns, guard=physicality_guard),
            ctx.bbc(loc.clone(), case.bc_fns, guard=physicality_guard)))
        loc = sbd.distribute_local(P)
        a, b = shard(loc)
        scale = b.abs().amax(dim=(0, 1, 2))
        assert float(((a - b).abs().amax(dim=(0, 1, 2)) / scale).max()) < 1e-6
        n_ghost = sbd.local_bc_tables(p)["ghost"].size
        assert torch.equal(a, loc) == (n_ghost == 0), (p, n_ghost)


def test_shocked_state_matches(ranks):
    """From the converged shocked state of tests/data/rae2822_cp_coarse.npz
    (27,520 cells, M 0.73), 3 steps on 4 ranks against the JAX package's
    sharded march: under 1e-4 (the band of tests/test_block_sharding.py,
    which a one-ring halo misses at 7.5e-4; measured 1.7e-6, and the
    port's one-device march is the same to the bit)."""
    sbd, step, _, _ = jx_build(P_RANKS, **RAE_SHOCKED)
    P = sbd.distribute(np.load(ORACLE)["P"])
    for _ in range(3):
        P, _ = step(P)
    ref = sbd.collect(P)
    out = ranks["shocked"]
    assert np.isfinite(out).all()
    err = _err(ref, out)
    assert err < 1e-4, err
