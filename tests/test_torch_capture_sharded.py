"""The compiled sharded marches and the wing (`ibx_torch.utils.graphs`
with a `DeviceMesh`) on the CPU, where no CUDA graph exists: one step of
every sharded march that a CUDA state over an ``nccl`` mesh captures
passes the capture guard of `test_torch_capture.py` after one eager step
(the warm-up `GraphedStep` runs before it captures), runs the eager step
by default on the CPU, bit-equal to ``graph=False``, and refuses
``graph=True`` on a CPU state; `use_graph` runs a staged mesh (gloo with
CUDA tensors) eagerly and refuses ``graph=True`` there.

The marches run on a one-rank gloo group of this process, at the port
tests' sizes: RAE2822 at wall_h=8e-2 (16,768 cells) on the sharded block
march with and without the overlap split and on the sharded gather step,
the bs=4 sphere at wall_h=0.25 (18,432 cells) on the channel-split and
the grid march, the 4096-cell wing's step and FAS cycle (its march shares
the step's graph). The overlap split and the halo exchange exist only
with several ranks: two spawned gloo ranks run one step of the
overlapped block march under the guard. A fresh process runs one guarded
sharded step on a one-rank gloo group and checks that no gloo thread
outlives the group."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from ibx_torch.cases import (build_rae2822, build_rae2822_block_sharded,
                             build_rae2822_sharded, build_sphere3d,
                             build_sphere3d_block_sharded,
                             build_wing3d_rans_fas)
from ibx_torch.parallel import DeviceMesh, one_rank_group, spawn
from ibx_torch.utils.graphs import use_graph

from test_torch_capture import CaptureGuard
from test_torch_wing3d_ranks import WING

torch.set_num_threads(2)

RAE = dict(wall_h=8e-2, feature_h=4e-2, cfl=0.7)
SPHERE = dict(wall_h=0.25, block_size=4)


def _rae_block(overlap):
    def build(cases):
        sbd, step, P0, _ = build_rae2822_block_sharded(
            1, case=cases["rae"], cfl=0.7, overlap=overlap)
        return P0, step
    return build


def _sphere(use_cs):
    def build(cases):
        sbd, step, P0, _ = build_sphere3d_block_sharded(
            1, case=cases["sphere"], cfl=0.7, use_cs=use_cs)
        assert sbd.use_cs is use_cs
        return P0, step
    return build


def _gather(cases):
    _, step, P0, _ = build_rae2822_sharded(1, device="cpu", **RAE)
    return P0, step


def _wing(method):
    def build(cases):
        wc = cases["wing"]
        return wc.S0_sh, getattr(wc, method)
    return build


STEPS = {
    "rae_block": _rae_block(False),
    "rae_block_overlap": _rae_block(True),
    "sphere_cs": _sphere(True),
    "sphere_grid": _sphere(False),
    "rae_gather_step": _gather,
    "wing_step": _wing("step"),
    "wing_fas_cycle": _wing("fas_cycle"),
}


@pytest.fixture(scope="module")
def cases():
    """The one-rank gloo group of this process and the prebuilt cases the
    sharded builders take (built inside the group: the wing builds its
    mesh from it)."""
    with one_rank_group("gloo"):
        yield dict(
            rae=build_rae2822(device="cpu", **RAE),
            sphere=build_sphere3d(device="cpu", **SPHERE),
            wing=build_wing3d_rans_fas(1, device="cpu", **WING))


def _flat(out):
    return out[0] if isinstance(out, (tuple, list)) else out


@pytest.mark.parametrize("name", list(STEPS))
def test_sharded_step_passes_capture_guard(cases, name):
    """One eager step (the warm-up), then one step of the default call
    under the guard: nothing the card could not capture, and on the CPU
    the default is the eager step, bit-equal."""
    X, step = STEPS[name](cases)
    ref = step(X, graph=False)
    with CaptureGuard():
        out = step(X)
    assert len(out) == len(ref)
    for a, b in zip(ref, out):
        assert (a is None and b is None) or torch.equal(a, b)
    assert torch.isfinite(_flat(out)).all()


@pytest.mark.parametrize("name", list(STEPS))
def test_graph_true_on_cpu_raises(cases, name):
    """``graph=True`` on a CPU state raises: it never runs eager
    quietly."""
    X, step = STEPS[name](cases)
    with pytest.raises(ValueError, match="CUDA state"):
        step(X, graph=True)


def test_sharded_marches_default_to_the_eager_loop(cases):
    """``march(X, n)`` on the CPU is the eager loop of ``step``, for the
    block marches and the wing (which shares its step's graph)."""
    sbd, step, P0, _ = build_rae2822_block_sharded(1, case=cases["rae"],
                                                   cfl=0.7)
    X = P0
    for _ in range(2):
        X = step(X, graph=False)[0]
    assert torch.equal(sbd.march(P0, 2), X)
    wc = cases["wing"]
    S = wc.step(wc.S0_sh, graph=False)[0]
    assert torch.equal(wc.march(wc.S0_sh, 1), S)
    assert not sbd._graphs.steps and not wc.sbd._graphs.steps


def test_sharded_gather_reuses_a_gather_case(cases):
    """``build_rae2822_sharded(case=...)`` takes a prebuilt gather case of
    as many partitions as ranks: the same state and step as its own
    build; a case of another partition count is refused."""
    gcase = build_rae2822(device="cpu", use_blocks=False, **RAE)
    _, own, P_own, _ = build_rae2822_sharded(1, device="cpu", **RAE)
    _, reuse, P_re, case = build_rae2822_sharded(1, case=gcase, cfl=0.7)
    assert case is gcase and torch.equal(P_own, P_re)
    assert torch.equal(own(P_own)[0], reuse(P_re)[0])
    with pytest.raises(ValueError, match="partitions"):
        build_rae2822_sharded(2, case=gcase)


def test_use_graph_on_a_staged_mesh():
    """A staged mesh (gloo with CUDA tensors) moves its exchanges through
    host tensors: the default runs eager there and ``graph=True`` raises,
    whatever the state; an nccl mesh leaves the choice to the state's
    device (the CPU: eager)."""
    X = torch.zeros(3)
    staged = DeviceMesh(0, 1, torch.device("cuda"), backend="gloo")
    assert staged.staged
    assert use_graph(None, X, staged) is False
    assert use_graph(False, X, staged) is False
    with pytest.raises(ValueError, match="staged mesh"):
        use_graph(True, X, staged)
    nccl = DeviceMesh(0, 1, torch.device("cuda"), backend="nccl")
    assert not nccl.staged and use_graph(None, X, nccl) is False
    with pytest.raises(ValueError, match="CUDA state"):
        use_graph(True, X, nccl)


def overlap_rank(out_dir):
    """One of two gloo ranks: the overlapped sharded block march at
    wall_h=8e-2, one eager step, then one step under the capture guard
    (the exchange in flight while the interior pass runs), bit-equal;
    each rank writes whether it held."""
    torch.set_num_threads(1)
    sbd, step, P0, _ = build_rae2822_block_sharded(
        dist.get_world_size(), device="cpu", overlap=True, **RAE)
    assert sbd.overlap and sbd.offs
    ref = step(P0, graph=False)
    with CaptureGuard():
        out = step(P0)
    ok = all(torch.equal(a, b) for a, b in zip(ref, out))
    np.save(f"{out_dir}/rank{dist.get_rank()}.npy", np.asarray(ok))


def test_overlap_exchange_passes_capture_guard(tmp_path):
    """The halo exchange and the overlap split on two spawned ranks pass
    the guard: no host upload or read sits in the sharded step."""
    spawn(overlap_rank, 2, backend="gloo", device="cpu",
          args=(str(tmp_path),), threads=1)
    assert all(bool(np.load(tmp_path / f"rank{p}.npy")) for p in range(2))


# one guarded sharded gather step on a one-rank gloo group, in a process
# of its own; prints the gloo threads left after the group
_GUARDED_GROUP = """
import glob, sys
import torch
sys.path.insert(0, "tests")
from test_torch_capture import CaptureGuard
from ibx_torch.cases import build_rae2822_sharded
from ibx_torch.parallel import one_rank_group
torch.set_num_threads(1)
with one_rank_group("gloo"):
    sdom, step, P0, case = build_rae2822_sharded(
        1, device="cpu", wall_h=8e-2, feature_h=4e-2, cfl=0.7)
    step(P0, graph=False)
    with CaptureGuard():
        step(P0)
    del sdom, step, P0, case
names = [open(t).read().strip() for t in glob.glob("/proc/self/task/*/comm")]
print([n for n in names if "gloo" in n])
"""


def test_guarded_sharded_step_frees_its_group():
    """A sharded step under the capture guard leaves no gloo thread once
    its group is destroyed. The guard is a `TorchDispatchMode`, whose
    first entry imports `torch._dynamo` and with it
    `torch.distributed.nn.functional`, whose functions bind the live
    group as a default argument: `ibx_torch.parallel` imports that module
    before any group exists. A fresh process, since this one imported
    `torch._dynamo` long ago."""
    r = subprocess.run([sys.executable, "-c", _GUARDED_GROUP],
                       cwd=Path(__file__).resolve().parent.parent,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "[]", r.stdout
