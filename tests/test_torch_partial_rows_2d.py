"""Partial coarse-side 2:1 rows (`topology.blocks._partial_rows`) on the
local tables of the sharded block march's four ranks, on the CPU, where
the 2D kernels' plain versions run.

A rank's local grid has generic leftover faces at its halo blocks: the
coarse side of a 2:1 interface whose other fine neighbor lies beyond the
halo. `BlockTables.from_numpy` carries them as coarse rows of the 2D
interface kernels with that neighbor -1, so the gate (`rhs_cs
.pallas_eligible`) admits the table and the rank takes the 2D kernel
route, which must give the torch-op body's values (with its `sp_*`
leftover accumulation) bit for bit. A leftover face of any other shape
keeps the whole table on the torch-op body. Torch only; the CUDA kernels
are held to these plain versions on the card (chip_smoke.py phase 36)."""

import dataclasses

import numpy as np
import pytest
import torch

from ibx_torch.cases import build_rae2822
from ibx_torch.ops import kernels as K
from ibx_torch.ops.block_ops import euler_rhs_grid
from ibx_torch.ops.rhs_cs import pallas_eligible
from ibx_torch.parallel import DeviceMesh, ShardedBlockDomain
from ibx_torch.topology.blocks import (BlockTables, build_block_tables,
                                      build_block_tables_raw)
from ibx_torch.utils import monitor

from test_torch_interface_2d import check_table
from test_torch_sharded_ranks import P_RANKS, RAE_SMALL

torch.set_num_threads(2)
CPU = torch.device("cpu")
# partial rows a rank's local table takes at RAE_SMALL (one a halo block
# side; its leftover faces are 8 a row, 2 for each of its bs/2 lanes)
PARTIAL = [2, 6, 3, 4]


@pytest.fixture(scope="module")
def ranks():
    """The case, a perturbed state (`test_gather_bc_matches_ghost_bc`'s)
    and, per rank, its `ShardedBlockDomain` built while recording, with
    the counters of that build."""
    case = build_rae2822(device="cpu", **RAE_SMALL)
    rng = np.random.default_rng(4)
    P = case.P0.numpy() * (1 + 0.05 * rng.standard_normal((1, 4)))
    P[:, 2:] += 10 * rng.standard_normal((P.shape[0], 2))
    P = torch.as_tensor(P.astype(np.float32))
    out = []
    for p in range(P_RANKS):
        with monitor.tracing():
            sbd = ShardedBlockDomain(case.dom, DeviceMesh(p, P_RANKS, CPU))
        out.append((sbd, monitor.records()["counters"]))
    return case, P, out


def _flat(x):
    if isinstance(x, (tuple, list)):
        return [z for y in x for z in _flat(y)]
    return [x]


def _rhs(bt, case, loc, with_dt, kernels):
    """`euler_rhs_grid` while recording: its outputs flattened (R, and
    with dt the dt bound, du_x, du_y and nu) and its route counters."""
    with monitor.tracing():
        out = euler_rhs_grid(bt, case.fluid, loc, with_dt=with_dt,
                             cfl=case.cfl, kernels=kernels)
    return _flat(out), monitor.records()["counters"]


@pytest.mark.parametrize("p", range(P_RANKS))
def test_ranks_absorb_their_leftovers(ranks, p):
    """Every leftover face of each rank's table is carried: 2, 6, 3 and 4
    partial coarse rows, one fine neighbor each and the other -1, each
    numbered by `fold_rows` on its side, after the structured rows, which
    stay as they were; the build counts them, and the gate admits the
    table."""
    _, _, out = ranks
    sbd, counters = out[p]
    bt = sbd.bt
    assert bt.n_sparse > 0 and bt.n_partial_rows == PARTIAL[p]
    assert counters == {"blocks.partial_rows": PARTIAL[p]}
    assert pallas_eligible(bt)
    tab, fold = bt.ifc_rows.numpy(), bt.fold_rows.numpy()
    V = tab.shape[0] - PARTIAL[p]
    part = tab[V:]
    assert (part[:, 3] == 1).all()
    assert ((part[:, 4] < 0) != (part[:, 5] < 0)).all()
    assert (fold[part[:, 0], 2 * part[:, 1] + part[:, 2]]
            == np.arange(V, tab.shape[0])).all()
    assert sorted(fold[fold >= 0].tolist()) == list(range(tab.shape[0]))
    # the leftover faces: two a lane of each row's present half
    assert bt.n_sparse == PARTIAL[p] * bt.block_size
    rest = dataclasses.replace(bt, ifc_rows=bt.ifc_rows[:V],
                               fold_rows=torch.where(bt.fold_rows >= V, -1,
                                                     bt.fold_rows))
    check_table(rest)


@pytest.mark.parametrize("with_dt", [True, False])
@pytest.mark.parametrize("p", range(P_RANKS))
def test_kernel_route_matches_op_body(ranks, p, with_dt):
    """On the whole local grid, from the perturbed state: the 2D kernel
    route (the plain versions of the passes and interface kernels, with
    the partial rows) against the torch-op body (`kernels=False`, the
    leftovers by `sp_*` scatter-add): R, and with dt the dt bound, du_x,
    du_y and nu, bit for bit (measured 0 in both passes, at every rank),
    each call counted on its route, no launch counted. Without the
    partial rows the route's R differs: the rows carry the faces."""
    case, P, out = ranks
    bt = out[p][0].bt
    loc = out[p][0].distribute_local(P)
    K.reset_launches()
    got, c_k = _rhs(bt, case, loc, with_dt, True)
    ref, c_o = _rhs(bt, case, loc, with_dt, False)
    assert c_k == {"rhs.route.kernels_2d": 1}
    assert c_o == {"rhs.route.ops": 1}
    assert len(got) == len(ref) == (5 if with_dt else 1)
    for a, b in zip(got, ref):
        assert a.shape == b.shape and torch.equal(a, b)
    assert bool(torch.isfinite(got[0]).all())
    assert not any(K.launches.values())
    V = bt.ifc_rows.shape[0] - bt.n_partial_rows
    dropped = dataclasses.replace(
        bt, fold_rows=torch.where(bt.fold_rows >= V, -1, bt.fold_rows))
    R = _flat(euler_rhs_grid(dropped, case.fluid, loc, with_dt=with_dt,
                             cfl=case.cfl))[0]
    assert not torch.equal(R, ref[0])


def _misfit(raw, how):
    """Rank 0's raw tables with one leftover face changed so that it no
    longer fits a partial row: its weight (1/2 -> 1), its neighbor cell
    (one lane on along the fine edge line), or the face taken out (a half
    row with one face missing)."""
    f = dict(raw)
    d = 0 if raw["sp_owner"][0].size else 1
    k = int(np.nonzero((raw["sp_wr"][d] != 0) | (raw["sp_wl"][d] != 0))[0][0])
    sp = {key: list(raw[key]) for key in ("sp_owner", "sp_neighbor",
                                          "sp_wr", "sp_wl")}
    if how == "weight":
        for key in ("sp_wr", "sp_wl"):
            a = sp[key][d].copy()
            a[k] = 2 * a[k]
            sp[key][d] = a
    elif how == "lane":
        bs = raw["block_size"]
        step = bs if d == 0 else 1        # the next lane along the edge
        for key, w in (("sp_neighbor", "sp_wr"), ("sp_owner", "sp_wl")):
            if sp[w][d][k] != 0:
                a = sp[key][d].copy()
                a[k] = a[k] + step if (a[k] // step) % bs < bs - 1 \
                    else a[k] - step
                sp[key][d] = a
    else:
        for key in sp:
            sp[key][d] = np.delete(sp[key][d], k)
    f.update({key: tuple(v) for key, v in sp.items()})
    return f


@pytest.mark.parametrize("how", ["weight", "lane", "missing"])
def test_a_misfit_face_keeps_the_op_body(ranks, how):
    """A table with one leftover face that does not fit absorbs nothing:
    no partial row and no counter, the structured rows alone, and the
    gate sends its RHS to the torch-op body."""
    case, P, out = ranks
    sbd = out[0][0]
    raw = build_block_tables_raw(**sbd.local_inputs(0))
    with monitor.tracing():
        bt = BlockTables.from_numpy(_misfit(raw, how), CPU)
    assert monitor.records()["counters"] == {}
    assert bt.n_sparse > 0 and bt.n_partial_rows == 0
    assert not pallas_eligible(bt)
    check_table(bt)
    assert torch.equal(bt.ifc_rows,
                       sbd.bt.ifc_rows[:bt.ifc_rows.shape[0]])
    _, counters = _rhs(bt, case, sbd.distribute_local(P), False, True)
    assert counters == {"rhs.route.ops": 1}


def test_one_card_table_is_unchanged(ranks):
    """The one-card table (no leftover face, as the flagship's) takes no
    partial row: its row table holds the structured rows alone, each
    numbered by `fold_rows`, and nothing is counted."""
    case = ranks[0]
    with monitor.tracing():
        bt = BlockTables.from_numpy(build_block_tables(case.dom), CPU)
    assert monitor.records()["counters"] == {}
    assert bt.n_sparse == 0 and bt.n_partial_rows == 0
    check_table(bt)
    assert torch.equal(bt.ifc_rows, case.bt.ifc_rows)
    assert torch.equal(bt.fold_rows, case.bt.fold_rows)

