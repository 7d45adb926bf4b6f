"""Launch an SPMD function on ``world_size`` local ranks, or make this
process a group of one rank.

`spawn` starts one process a rank with `torch.multiprocessing.spawn`,
joins them into one process group over a ``file://`` store in a
temporary directory (no port is opened), runs ``fn(*args)`` on every rank
and destroys the group. Inside ``fn``, `make_device_mesh` reads the mesh
from the group. The same code runs under ``torchrun`` with its own
``init_process_group`` call. `one_rank_group` is the group of one rank in
this process (a sharded case on one card, a test's rank):

    from ibx_torch.parallel import one_rank_group, spawn
    spawn(run, 4, backend="gloo", device="cpu", args=(n_steps,))
    with one_rank_group("nccl"):
        sbd, step, P, case = build_rae2822_block_sharded(1)
"""

from __future__ import annotations

import contextlib
import gc
import os
import tempfile
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
# Imported before any group exists, on purpose: its functions take
# ``group=group.WORLD`` as a default, bound when the module is first
# imported. torch imports it lazily with `torch._dynamo`, which entering
# any `TorchDispatchMode` (or `torch.compile`) loads; loaded while a group
# lives, it would hold that group, and its gloo threads, until exit.
import torch.distributed.nn.functional  # noqa: F401
import torch.multiprocessing as mp

from ..topology.domain import require_device


def _free_group() -> None:
    # A CUDA graph that captured NCCL kernels holds a reference on their
    # communicator, and destroying the communicator waits for every such
    # reference: free the graphs that only reference cycles still hold (a
    # sharded case's captured steps) before the group.
    gc.collect()
    dist.destroy_process_group()
    # The group's C++ object (its gloo connections and threads) lives
    # while any Python object holds it, and a mesh held in a reference
    # cycle (a case's closures over its `ShardedBlockDomain`) keeps it
    # until the cyclic collector runs, at the latest during interpreter
    # shutdown, where tearing it down aborts the process ("terminate
    # called without an active exception"). Free it here.
    gc.collect()


@contextlib.contextmanager
def one_rank_group(backend: str = "gloo"):
    """A process group of one rank, this process, over a ``file://``
    store in a temporary directory; destroyed (and its threads freed) on
    exit. ``nccl`` for a mesh on the card, ``gloo`` for the CPU (or a
    staged mesh on the card)."""
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            backend, init_method="file://" + os.path.join(tmp, "store"),
            world_size=1, rank=0)
        try:
            yield
        finally:
            _free_group()


def _rank_main(rank: int, fn: Callable, world_size: int, backend: str,
               init_method: str, threads: int, args: Sequence) -> None:
    torch.set_num_threads(threads)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    try:
        fn(*args)
        # no rank tears its connections down while a peer still sends
        dist.barrier()
    finally:
        _free_group()


def spawn(fn: Callable, world_size: int, *, backend: Optional[str] = None,
          device="cuda", args: Sequence = (),
          threads: Optional[int] = None) -> None:
    """Run ``fn(*args)`` on ``world_size`` ranks, each in its own process.

    ``backend`` defaults to ``nccl`` when ``device`` is CUDA and to
    ``gloo`` on the CPU; ``gloo`` with a CUDA device puts every rank on
    the card with host-staged collectives (NCCL refuses two ranks on one
    device). ``device`` picks only the default backend: ``fn`` passes its
    device to the builders itself. ``threads`` (default: the CPU count
    over ``world_size``, at least 1) is each rank's
    `torch.set_num_threads`. ``fn`` must be importable (a module-level
    function). A rank that raises makes `spawn` raise."""
    device = require_device("spawn", device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if threads is None:
        threads = max(1, (os.cpu_count() or 1) // world_size)
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "store")
        mp.spawn(_rank_main, nprocs=world_size, join=True,
                 args=(fn, world_size, backend, init, threads, tuple(args)))
