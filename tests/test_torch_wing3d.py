"""Port parity of the 3D RANS wing (`ibx_torch.cases.build_wing3d_rans_fas`,
workload 5) at the JAX package's test size (`tests/test_wing3d_fas.py:15`,
4096 cells): the host build (mesh, faces, block tables, ghost families,
the coarse level and its transfers, every rank's sharded tables at P = 4)
bit-equal to the JAX package's, the initial state, and one rank's 2-step
march against the JAX package's jitted march. The FAS cycle and the four-
rank march are in `test_torch_wing3d_fas.py`."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ibx.cases.wing3d_rans_fas import (
    build_wing3d_rans_fas as jx_build_wing)
from ibx.solve.multigrid_domain import multigrid as jx_multigrid
from ibx.topology.blocked_bc import _collect_families as jx_families
from ibx.topology.blocks import build_block_tables as jx_block_tables

from ibx_torch.cases import build_wing3d_rans_fas
from ibx_torch.parallel import DeviceMesh, ShardedBlockDomain, one_rank_group
from ibx_torch.solve.multigrid_domain import multigrid
from ibx_torch.topology.blocked_bc import _collect_families
from ibx_torch.topology.blocks import (build_block_tables,
                                       build_block_tables_raw)

from test_torch_block_sharding import _check_raw
from test_torch_kernels import ibx_fields
from test_torch_stencil import assert_stencil_equal
from test_torch_wing3d_ranks import WING

torch.set_num_threads(2)
N_STEPS = 2


@pytest.fixture(scope="module")
def jx():
    """The JAX wing on one device: its initial state, ``dt*R`` there on
    the solved cells, and 2 steps."""
    case = jx_build_wing(1, **WING)
    S0 = case.collect(case.S0_sh)
    # one device: its own grids are the flat order (a leading shard axis)
    rf = np.asarray(case.res_field(case.S0_sh)).reshape(S0.shape)
    S2 = case.collect(case.march(case.S0_sh, N_STEPS))
    return case, S0, S2, rf


@pytest.fixture(scope="module")
def pt():
    """The port's wing on one gloo rank of this process, on the CPU: its
    domain and freestream (the case itself, which holds the process
    group, is freed with the group), its initial state, ``dt*R`` there
    and 2 steps."""
    with one_rank_group("gloo"):
        case = build_wing3d_rans_fas(1, device="cpu", **WING)
        S0 = case.collect(case.S0_sh)
        rf = case.collect(case.res_field(case.S0_sh))
        S2 = case.collect(case.march(case.S0_sh, N_STEPS))
        host = SimpleNamespace(dom=case.dom, P_inf=case.P_inf,
                               Rt_inf=case.Rt_inf)
        del case
    return host, S0, S2, rf


def _err(ref, out):
    """Max abs error per channel over that channel's max |ref|."""
    return (np.abs(out - ref) / (np.abs(ref).max(axis=0) + 1e-12)).max(0)


def test_host_build_bit_equal(jx, pt):
    """Cells, faces, the fine block tables and the ghost families in
    ``_host_boundaries`` order (the order the sharded BC resolves
    families by) equal the JAX package's."""
    jd, d = jx[0].dom, pt[0].dom
    for name in ("centers", "widths", "face_dim", "face_owner",
                 "face_neighbor"):
        assert np.array_equal(getattr(jd, name), getattr(d, name)), name
    assert list(jd._host_boundaries) == list(d._host_boundaries)
    ref = ibx_fields(jx_block_tables(jd))
    out = build_block_tables(d)
    assert set(ref) == set(out)
    for k in ref:
        _equal(ref[k], out[k], k)
    names = list(d._host_boundaries)
    ref = jx_families(jd, names)
    out = _collect_families(d, names)
    assert set(ref) == set(out)
    for k in ref:
        assert np.array_equal(np.asarray(ref[k]), out[k]), k


def _equal(a, b, path):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{path}[{i}]")
        return
    assert np.array_equal(np.asarray(a), np.asarray(b)), path


def test_coarse_level_bit_equal(jx, pt):
    """The replicated coarse level: the bs/2 domain's cells, block tables
    and ghost families, and the IDW coarsener and prolongator."""
    jh, h = jx_multigrid(jx[0].dom, 1), multigrid(pt[0].dom, 1)
    jcd, cd = jh.coarse_domains[0], h.coarse_domains[0]
    assert np.array_equal(jcd.centers, cd.centers)
    ref, out = ibx_fields(jx_block_tables(jcd)), build_block_tables(cd)
    for k in ref:
        _equal(ref[k], out[k], k)
    names = list(cd._host_boundaries)
    ref, out = jx_families(jcd, names), _collect_families(cd, names)
    for k in ref:
        assert np.array_equal(np.asarray(ref[k]), out[k]), k
    assert_stencil_equal(jh.coarseners[0], h.coarseners[0], "coarsen")
    assert_stencil_equal(jh.prolongators[0], h.prolongators[0], "prolong")


def test_sharded_tables_bit_equal(pt):
    """Every rank's block map, send tables, raw local block tables and
    ``ctx.bc`` tables at P = 4 equal the JAX package's 4-device wing."""
    jsbd = jx_build_wing(4, **WING).sbd
    cpu = torch.device("cpu")
    sbd = ShardedBlockDomain(pt[0].dom, DeviceMesh(0, 4, cpu))
    assert sbd.offs == jsbd.offs and sbd.S == jsbd.S
    assert sbd.B_loc == jsbd.B_loc and sbd.chunk == jsbd.chunk
    assert np.array_equal(sbd.l2g, jsbd._l2g)
    t = jsbd.tables
    for o in sbd.offs:
        assert np.array_equal(np.asarray(t["send_idx"][o]), sbd.send_idx[o])
    for p in range(4):
        _check_raw(t["bt"], build_block_tables_raw(**sbd.local_inputs(p)),
                   p, sbd.nd, sbd.B_loc - 1)
        bc = sbd.local_bc_tables(p)
        G, K = bc["idx"].shape
        for key in ("ghost", "eta", "normals", "family", "imd"):
            assert np.array_equal(np.asarray(t["bc"][key])[p][:G], bc[key])
        for key in ("idx", "w"):
            assert np.array_equal(np.asarray(t["bc"][key])[p][:G, :K],
                                  bc[key])


def test_initial_state_matches(jx, pt):
    """``S0`` after its BC-only pass within 2e-5 per channel (measured
    2.7e-7) and the freestream constants equal; ``res_field`` (dt*R on
    the solved cells: outside the solid and off the ghost rows) is zero
    on the same cells in both packages and agrees within 1e-4 per
    channel elsewhere (measured 1.1e-5)."""
    (jc, jS0, _, jrf), (c, S0, _, rf) = jx, pt
    assert S0.shape == jS0.shape == (c.dom.ncells, 6)
    assert np.array_equal(c.P_inf, jc.P_inf) and c.Rt_inf == jc.Rt_inf
    assert _err(jS0, S0).max() < 2e-5, _err(jS0, S0)
    frozen = (jrf == 0).all(axis=1)
    assert 0 < frozen.sum() < frozen.size
    assert np.array_equal(frozen, (rf == 0).all(axis=1))
    assert _err(jrf, rf).max() < 1e-4, _err(jrf, rf)


def test_march_matches(jx, pt):
    """2 sharded RANS steps on one rank against the JAX package's jitted
    march: flow channels within 1e-4 per channel scaled and Rt within
    1e-3 of max |Rt| (the RANS tolerances of test_torch_rans.py; measured
    3.3e-6 and 5.9e-7)."""
    (_, _, jS2, _), (_, _, S2, _) = jx, pt
    assert np.isfinite(S2).all()
    err = _err(jS2, S2)
    assert err[:5].max() < 1e-4, err
    assert err[5] < 1e-3, err
