"""The rank functions of the sharded parity tests, and the tests of the
launcher (`ibx_torch.parallel.spawn`) itself.

Every spawned rank imports the module its function lives in. This one
imports torch and `ibx_torch` only: a rank that imported the JAX package
would start XLA's thread pools, which may still be running when the rank
exits. The JAX side of each comparison stays in the test files
(`test_torch_sharding.py`, `test_torch_block_sharding.py`,
`test_torch_sphere3d_sharded.py`); each rank writes what it collected to
``out_dir`` (rank 0 the ``.npz``, every rank its own checks)."""

import glob
import json

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ibx_torch import geometry as tg
from ibx_torch.cases import (build_rae2822, build_rae2822_block_sharded,
                             build_rae2822_sharded, build_sphere3d,
                             build_sphere3d_block_sharded)
from ibx_torch.ops import kernels as K
from ibx_torch.ops import operators as to
from ibx_torch.parallel import (ShardedDomain, make_device_mesh,
                                sharded_impose_bc, spawn)
from ibx_torch.parallel.launch import _rank_main
from ibx_torch.topology.domain import Domain

P_RANKS = 4
HF = [("outlet", [(0, True), (1, True)])]
RAE_SMALL = dict(wall_h=4e-2, feature_h=2e-2, cfl=0.7)     # 21,760 cells
RAE_SHOCKED = dict(wall_h=2e-2, feature_h=1e-2, cfl=0.7)   # 27,520 cells
RAE_VARIANTS = {"plain": {}, "overlap": dict(overlap=True),
                "te_fix": dict(te_fix_radius=0.3)}
SPHERE = dict(wall_h=0.25, block_size=4)                   # 18,432 cells


def adv_mesh(build=tg.build_mesh, polyline=tg.polyline, Line=tg.Line,
             h=4e-2):
    """The advection geometry of tests/test_sharding.py:18-31."""
    lower = polyline(np.array([[0.0, 0.0], [1.0, 0.0]]), closed=False)
    upper = polyline(np.array([[0.0, 0.0], [0.0, 1.0]]), closed=False)
    return build(
        [0.0, 0.0], [1.0, 1.0],
        ("lower", lower, h),
        ("upper", upper, h),
        refinement_regions=[(Line([0.0, 0.0], [1.0, 1.0]), 2 * h)],
        block_size=4,
    )


def residual_fn(ops, zeros_like):
    """The residual of tests/test_sharding.py on either package."""
    def residual(part, u):
        D = ops.jst_sensor(part, u)
        r = zeros_like(u)
        for dim in range(part.nd):
            du = ops.cell_gradient(part, u, dim)
            uL, uR = ops.muscl(part, u, du, dim, D=D, high_order=True)
            flux = (uL + uR) / 2 + (uL - uR) / 2
            r = r - ops.green_gauss(part, flux, dim)
        return r
    return residual


def bc_step_fn(ops, impose, ones_like, zeros_like):
    """tests/test_sharding.py's sharded step: three families, each with a
    refresh after it, then u + 0.01 R."""
    res = residual_fn(ops, zeros_like)

    def step(ctx, u):
        u = impose(ctx, ctx.boundary("upper"), lambda b, i: ones_like(i), u)
        u = ctx.refresh(u)
        u = impose(ctx, ctx.boundary("lower"), lambda b, i: zeros_like(i), u)
        u = ctx.refresh(u)
        u = impose(ctx, ctx.boundary("outlet"), lambda b, i: i, u)
        u = ctx.refresh(u)
        return u + 0.01 * res(ctx.part, u)
    return step


def adv_fields(dom):
    """The fields of tests/test_sharding.py: u0, u1 and the cell volumes."""
    u0 = (np.sin(3 * dom.centers[:, 0])
          * np.cos(2 * dom.centers[:, 1])).astype(np.float32)
    u1 = (dom.centers[:, 0] * dom.centers[:, 1]).astype(np.float32)
    vol = np.prod(dom.widths, axis=1).astype(np.float32)
    return u0, u1, vol


def perturbed(P0, centers, seed=11):
    """A developed 3D state: smooth and random perturbations of ``P0``, so
    that gradients and the JST sensor are on at every chunk edge."""
    rng = np.random.default_rng(seed)
    P = np.array(P0, np.float32)
    x = centers
    P[:, 0] *= 1 + 0.05 * np.sin(2 * x[:, 0]) * np.cos(x[:, 1])
    P[:, 1] *= 1 + 0.03 * np.cos(1.5 * x[:, 2])
    P[:, 2] += 30 * np.sin(x[:, 1] + x[:, 2])
    P[:, 3] += 25 * np.cos(x[:, 0]) * np.sin(x[:, 2])
    P[:, 4] += 20 * rng.standard_normal(P.shape[0])
    return P.astype(np.float32)


def sharding_rank(out_dir):
    """One rank of test_torch_sharding.py: the residual, 3 BC+residual
    steps and the volume psum on the advection mesh; the sharded RAE2822
    gather march (3 steps); the calls of one halo exchange."""
    rank = dist.get_rank()
    dom = Domain(adv_mesh(), n_partitions=P_RANKS, hypercube_families=HF,
                 device="cpu")
    sdom = ShardedDomain(dom, make_device_mesh(P_RANKS, device="cpu"))
    u0, u1, vol = adv_fields(dom)
    out = {}
    res = residual_fn(to, torch.zeros_like)
    (r,) = sdom.shard_fn(lambda ctx, u: res(ctx.part, u))(
        sdom.distribute(u0))
    out["residual"] = sdom.collect(r)
    run = sdom.shard_fn(bc_step_fn(to, sharded_impose_bc, torch.ones_like,
                                   torch.zeros_like))
    u = sdom.distribute(u1)
    for _ in range(3):
        (u,) = run(u)
    out["bc3"] = sdom.collect(u)

    def total_volume(ctx, v):
        n = ctx.part.n_own
        s = ctx.psum((v[:n] * ctx.own_mask[:n]).sum())
        return s.expand(ctx.part.n_dom)

    (v,) = sdom.shard_fn(total_volume)(sdom.distribute(vol))
    out["volume"] = sdom.collect(v)

    # one halo exchange, counted: one batched call of 2 ops an offset
    calls = {"batch_isend_irecv": [], "all_gather": 0}
    batch, gather = dist.batch_isend_irecv, dist.all_gather

    def count_batch(ops):
        calls["batch_isend_irecv"].append(len(ops))
        return batch(ops)

    def count_gather(*a, **k):
        calls["all_gather"] += 1
        return gather(*a, **k)

    dist.batch_isend_irecv, dist.all_gather = count_batch, count_gather
    try:
        sdom.shard_fn(lambda ctx, u: u)(sdom.distribute(u0))
    finally:
        dist.batch_isend_irecv, dist.all_gather = batch, gather
    calls["offsets"] = list(sdom.offsets)
    with open(f"{out_dir}/calls{rank}.json", "w") as f:
        json.dump(calls, f)

    gsd, gstep, P, _ = build_rae2822_sharded(P_RANKS, device="cpu",
                                             **RAE_SMALL)
    for _ in range(3):
        (P,) = gstep(P)
    out["rae2822_sharded"] = gsd.collect(P)
    if rank == 0:
        np.savez(f"{out_dir}/out.npz", **out)


def block_sharding_rank(out_dir, oracle):
    """One rank of test_torch_block_sharding.py: 5 steps of each variant
    from the case's initial state, the replicated-flat helpers, and 3
    steps of the shocked case from the converged coarse state."""
    rank = dist.get_rank()
    case = build_rae2822(device="cpu", **RAE_SMALL)
    out = {}
    for label, kw in RAE_VARIANTS.items():
        sbd, step, P, _ = build_rae2822_block_sharded(
            P_RANKS, case=case, cfl=0.7, **kw)
        out[f"{label}_P0"] = sbd.collect(P)
        res = []
        for _ in range(5):
            P, r = step(P)
            res.append(float(r))
        out[label] = sbd.collect(P)
        out[f"{label}_res"] = np.asarray(res)
        out[f"{label}_overlap"] = np.asarray(bool(sbd.overlap))
    # the replicated-flat helpers of the sharded FAS composition
    sbd, _, P, _ = build_rae2822_block_sharded(P_RANKS, case=case)

    def roundtrip(ctx, own):
        flat = ctx.all_gather_flat(own)
        return ctx.own_flat(flat), flat

    back, flat = sbd.shard_fn(roundtrip)(P)
    n_real = min(sbd.chunk, sbd.B - rank * sbd.chunk)
    assert torch.equal(back[:n_real], P[:n_real])
    out["all_gather_flat"] = flat.numpy()
    shocked = build_rae2822(device="cpu", **RAE_SHOCKED)
    sbd, step, _, _ = build_rae2822_block_sharded(P_RANKS, case=shocked,
                                                  cfl=0.7)
    P = sbd.distribute(np.load(oracle)["P"])
    for _ in range(3):
        P, _ = step(P)
    out["shocked"] = sbd.collect(P)
    if rank == 0:
        np.savez(f"{out_dir}/out.npz", **out)


def sphere_rank(out_dir):
    """One rank of test_torch_sphere3d_sharded.py: 1 and 5 steps from the
    initial state and 1 step from a developed state, on each march; which
    march `use_cs=None` took; the launches counted on the CPU."""
    rank = dist.get_rank()
    case = build_sphere3d(device="cpu", **SPHERE)
    Pd = perturbed(case.P0.numpy(), case.dom.centers)
    out = {}
    K.reset_launches()
    for label, use_cs in (("cs", None), ("grid", False)):
        sbd, step, P, _ = build_sphere3d_block_sharded(P_RANKS, case=case,
                                                       use_cs=use_cs)
        out[f"{label}_use_cs"] = np.asarray(sbd.use_cs)
        out[f"{label}_P0"] = sbd.collect(P)
        for i in range(5):
            P, res = step(P)
            if i == 0:
                out[f"{label}_1"] = sbd.collect(P)
        out[f"{label}_5"] = sbd.collect(P)
        out[f"{label}_res"] = np.asarray(float(res))
        P, _ = step(sbd.distribute(Pd))
        out[f"{label}_dev"] = sbd.collect(P)
    out["launches"] = np.asarray(sum(K.launches.values()))
    if rank == 0:
        np.savez(f"{out_dir}/out.npz", **out)


def _sum_ranks(out_dir):
    """Every rank adds its rank + 1 over the group; rank 0 writes it."""
    t = torch.tensor([float(dist.get_rank() + 1)])
    dist.all_reduce(t)
    if dist.get_rank() == 0:
        np.save(f"{out_dir}/sum.npy", t.numpy())


def _raise_on_rank_1():
    if dist.get_rank() == 1:
        raise ValueError("rank 1 fails")


def test_spawn_runs_every_rank(tmp_path):
    """`spawn` joins ``world_size`` ranks into one gloo group (an
    all-reduce over 3 ranks sums 1 + 2 + 3)."""
    spawn(_sum_ranks, 3, backend="gloo", device="cpu",
          args=(str(tmp_path),), threads=1)
    assert float(np.load(tmp_path / "sum.npy")[0]) == 6.0


def test_spawn_raises_when_a_rank_raises():
    """A rank that raises makes `spawn` raise, and nothing hangs: the
    error is the failing rank's, or its peer's lost connection in the
    closing barrier, whichever process ends first."""
    with pytest.raises(mp.ProcessRaisedException,
                       match="rank 1 fails|Connection reset|Connection closed"):
        spawn(_raise_on_rank_1, 2, backend="gloo", device="cpu", threads=1)


def _hold_mesh_in_cycle():
    """A rank function whose mesh (and with it the process group) stays
    referenced from a reference cycle when it returns, as a case's
    closures over its `ShardedBlockDomain` do."""
    class Holder:
        pass

    h = Holder()
    h.mesh = make_device_mesh(1, device="cpu")
    h.self = h


def _gloo_threads():
    names = []
    for task in glob.glob("/proc/self/task/*/comm"):
        try:
            with open(task) as f:
                names.append(f.read().strip())
        except OSError:
            pass
    return [n for n in names if "gloo" in n]


def test_rank_teardown_frees_group_held_by_cycle(tmp_path):
    """A rank's process group is torn down inside the rank's own code,
    not at interpreter shutdown: after `_rank_main` returns, no gloo
    thread is left, even when the rank function left its mesh in a
    reference cycle. (A group left to the shutdown aborted 6 of 30 four-
    rank runs with "terminate called without an active exception".)"""
    assert not dist.is_initialized()
    _rank_main(0, _hold_mesh_in_cycle, 1, "gloo",
               "file://" + str(tmp_path / "store"), 1, ())
    assert not dist.is_initialized()
    assert _gloo_threads() == []
