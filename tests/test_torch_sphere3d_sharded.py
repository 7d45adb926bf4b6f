"""Port parity of the sharded 3D sphere march
(`ibx_torch.cases.build_sphere3d_block_sharded`) on the bs=4 sphere
(wall_h=0.25, 18,432 cells) over 4 gloo ranks on the CPU, on the
channel-split march (the kernels' plain versions) and on the grid march,
against the JAX package's single-device step and its sharded march (bs=4
is below the JAX package's cs gate, so its sharded run takes its grid
path); the leftover-face glue of `rhs_cs.euler_rhs_cs` on each rank's
local grid; and `dryrun_multichip(4)` (legs 1-4)."""

import numpy as np
import pytest
import torch

from ibx.cases import build_sphere3d as jx_build_sphere3d
from ibx.cases.sphere3d_block_sharded import (
    build_sphere3d_block_sharded as jx_build_sharded)

from ibx_torch.cases import build_sphere3d
from ibx_torch.ops.block_ops import euler_rhs_grid
from ibx_torch.ops.rhs_cs import cs_merge, cs_split, euler_rhs_cs
from ibx_torch.parallel import DeviceMesh, ShardedBlockDomain, spawn
from ibx_torch.parallel.dryrun import dryrun_multichip

from test_torch_sharded_ranks import P_RANKS, SPHERE, perturbed, sphere_rank

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("sphere_sharded")
    spawn(sphere_rank, P_RANKS, backend="gloo", device="cpu",
          args=(str(d),), threads=1)
    return dict(np.load(d / "out.npz"))


@pytest.fixture(scope="module")
def jx():
    """The JAX case and its single-device states after 1 and 5 steps
    from ``P0`` and after 1 step from the developed state."""
    case = jx_build_sphere3d(**SPHERE)
    P, ref = case.P0, {}
    for i in range(5):
        P, _ = case.step(P)
        if i == 0:
            ref[1] = np.asarray(P)
    ref[5] = np.asarray(P)
    Pd = perturbed(np.asarray(case.P0), case.dom.centers)
    ref["dev"] = np.asarray(case.step(Pd)[0])
    return case, ref


def _err(ref, out):
    return float((np.abs(out - ref) / np.abs(ref).max(axis=0)).max())


@pytest.mark.parametrize("march", ["cs", "grid"])
def test_matches_single_device(ranks, jx, march):
    """4 ranks against the JAX package's single-device step: 1 step under
    1e-4 and 5 steps under 1e-3 from the initial state (the port's
    single-device tolerances), 1 step from a developed state under 1e-4
    (measured 1.5e-6, 2.0e-6 and 1.8e-6 on both marches). `use_cs=None`
    takes the channel-split march here, where the JAX gate (bs 8 or 16)
    would not; no kernel is launched on the CPU."""
    case, ref = jx
    assert bool(ranks[f"{march}_use_cs"]) == (march == "cs")
    assert np.array_equal(ranks[f"{march}_P0"], np.asarray(case.P0))
    for key, tol in ((1, 1e-4), (5, 1e-3), ("dev", 1e-4)):
        out = ranks[f"{march}_{key}"]
        assert np.isfinite(out).all()
        assert _err(ref[key], out) < tol, (key, _err(ref[key], out))
    assert np.isfinite(ranks[f"{march}_res"])
    assert int(ranks["launches"]) == 0


def test_matches_jax_sharded(ranks, jx):
    """The JAX package's sharded march on its 4-device mesh (its grid
    path at bs=4), 5 steps: both port marches under 1e-3 (measured
    2.6e-6)."""
    case, _ = jx
    sbd, step, P, _ = jx_build_sharded(P_RANKS, case=case)
    for _ in range(5):
        P, _ = step(P)
    ref = sbd.collect(P)
    for march in ("cs", "grid"):
        assert _err(ref, ranks[f"{march}_5"]) < 1e-3


def test_leftover_glue_matches_torch_op_body():
    """Each rank's local grid has generic sparse leftover faces at halo
    blocks (coarse blocks beside partly present fine blocks) on 3 of the 4
    ranks; `euler_rhs_cs` (plain kernels + the 2:1 and leftover glue)
    equals the torch-op body of `euler_rhs_grid`, which accumulates them
    too, on every local cell: R per channel and dt within 1e-5 of scale
    (measured 2.0e-7 and 2.4e-7)."""
    case = build_sphere3d(device="cpu", **SPHERE)
    P = perturbed(case.P0.numpy(), case.dom.centers)
    n_sparse = []
    for p in range(P_RANKS):
        sbd = ShardedBlockDomain(case.dom,
                                 DeviceMesh(p, P_RANKS, torch.device("cpu")))
        bt = sbd.bt
        n_sparse.append(bt.n_sparse)
        loc = sbd.distribute_local(torch.as_tensor(P))
        pad = torch.as_tensor(np.nonzero(sbd.l2g[p] < 0)[0])
        loc[pad] = loc[0].clone()          # finite state in pad and dump
        R3, dt3, _ = euler_rhs_grid(bt, case.fluid, loc, with_dt=True,
                                    cfl=0.7, kernels=False)
        Rc, dtb = euler_rhs_cs(bt, case.fluid, cs_split(bt, loc),
                               with_dt=True)
        Rg = cs_merge(bt, Rc)
        scale = R3.abs().amax(dim=(0, 1, 2, 3))
        err = ((Rg - R3).abs().amax(dim=(0, 1, 2, 3)) / scale).max()
        assert float(err) < 1e-5, (p, float(err))
        dt = 0.7 / dtb[:, 0].reshape(dt3.shape)
        assert float(((dt - dt3).abs() / dt3.abs()).max()) < 1e-5
    assert sum(n > 0 for n in n_sparse) >= 3, n_sparse
    assert sbd.cs_eligible()


def test_dryrun_multichip():
    """Legs 1, 2, 3, 3b and 4 (the RANS+FAS wing: 2 steps and a V-cycle)
    of the JAX package's dry run on 4 gloo ranks, finite on every rank."""
    dryrun_multichip(P_RANKS)
