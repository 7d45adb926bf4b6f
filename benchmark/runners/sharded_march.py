"""The sharded march runner: a case's block march sharded over ``ranks``
ranks, one card each, captured and replayed in chunks of ``chunk_steps``
steps for the whole window.

Entry: ``ibx_torch.cases.build_<case>_block_sharded(ranks, **build)``
and its ``sbd.march(P_own, n)``, which on the card replays a step
captured with its halo exchange and residual reduction over NCCL. Rank 0
is this process, on the device the harness gives; ranks 1.. are child
processes running this file on the next cards (``gloo`` ranks on the
CPU). All join one process group over a ``file://`` store, and a ``gloo``
group beside it carries rank 0's command before each chunk: every rank
then marches the same chunks from the same seeded start. Every wait on a
child has a time limit, a child that dies ends the run with a message,
and the children end with rank 0's process (`Run.release`). The window
is rank 0's clock over the whole mesh's cells x steps; at most four
chunks are in flight. The kept chunks (the first, one drawn from the
seed, the last) are collected from every rank and compared with the
float64 reference on rank 0's device.
"""

from __future__ import annotations

import atexit
import collections
import datetime
import importlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import torch

if __name__ == "__main__":
    # a child rank: the benchmark's modules and the program as rank 0 saw
    # them (its sys.path, handed down in the environment)
    sys.path[:0] = [p for p in os.environ.get("BENCH_RANK_PATH", "").split(
        os.pathsep) if p]

import harness  # noqa: E402
import spans  # noqa: E402
from reference.euler import Euler  # noqa: E402
from reference.tables import domains  # noqa: E402

# the commands, each a chunk's or a phase's: (op, argument)
MARCH, RESEED, TRACE_ON, TRACE_OFF, COLLECT, STOP = range(6)
# MARCH's argument: flags
FIRST, KEEP_START, KEEP_SAMPLE = 1, 2, 4
KEPT = ("start", "sample", "end")
# seconds a rank waits for the others: to join, for a command, to end
JOIN_S, COMMAND_S, END_S = 180, 600, 120


def _groups(backend: str, store: str, world: int, rank: int):
    """Join the process group, and the ``gloo`` group of the commands."""
    import torch.distributed as dist
    dist.init_process_group(backend, init_method="file://" + store,
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=JOIN_S))
    return dist.new_group(backend="gloo",
                          timeout=datetime.timedelta(seconds=COMMAND_S))


def _close(group) -> None:
    """Every rank at once: meet on the command group, then destroy the
    groups (gloo ranks; see `Run.release` for NCCL's)."""
    import gc

    import torch.distributed as dist
    dist.barrier(group=group)
    gc.collect()
    dist.destroy_process_group()
    gc.collect()


class _Rank:
    """One rank's share: its sharded march and kept chunks."""

    def __init__(self, cfg: dict, traffic: dict, world: int, device):
        import ibx_torch.cases as cases
        self.cfg, self.tr, self.device = cfg, traffic, device
        self.params = dict(cfg["build"], **traffic.get("build", {}))
        self.refcase = importlib.import_module("reference.cases." + cfg["case"])
        self.chunk = int(traffic["chunk_steps"])
        build = getattr(cases, f"build_{cfg['case']}_block_sharded")
        t0 = time.perf_counter()
        self.sbd, _, _, case = build(
            world, overlap=bool(traffic["overlap"]), device=device,
            **self.params)
        self.host_build_s = time.perf_counter() - t0
        self.ncells = case.dom.ncells
        del case
        self.keep, self.X = {}, None

    def reseed(self, seed: int) -> None:
        P0 = harness.start_state(
            self.refcase.freestream(dict(self.cfg, **self.params)),
            self.ncells, seed, float(self.tr["amplitude"]), self.device)
        self.X0, self.keep = self.sbd.distribute(P0), {}

    def march(self, flags: int) -> None:
        Xin = self.X0 if flags & FIRST else self.X
        self.X = self.sbd.march(Xin, self.chunk)
        if flags & KEEP_START:
            self.keep["start"] = (Xin, self.X)
        if flags & KEEP_SAMPLE:
            self.keep["sample"] = (Xin, self.X)
        self.keep["end"] = (Xin, self.X)

    def collect(self) -> dict:
        """Every rank's kept chunks, whole (a collective: every rank calls
        it), as numpy on each rank."""
        return {k: tuple(self.sbd.collect(x) for x in self.keep[k])
                for k in KEPT if k in self.keep}

    def free(self) -> None:
        self.keep, self.X, self.X0, self.sbd = {}, None, None, None


def _command(group, op: int = 0, arg: int = 0):
    """Rank 0's command, broadcast to every rank: (op, argument)."""
    import torch.distributed as dist
    t = torch.tensor([op, arg], dtype=torch.int64)
    dist.broadcast(t, 0, group=group)
    return int(t[0]), int(t[1])


class Run:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.tr, self.seed, self.device = cfg, traffic, seed, device
        self.params = dict(cfg["build"], **traffic.get("build", {}))
        self.flow = dict(cfg, **self.params)
        self.refcase = importlib.import_module("reference.cases." + cfg["case"])
        self.chunk = int(traffic["chunk_steps"])
        self.world = int(traffic["ranks"])
        self.kids, self.group, self.rank = [], None, None
        # past STOP (a child's exit is expected), the march stopped on
        # every rank, and the groups closed
        self.ended = self.released = self.closed = False

    # -- the ranks -------------------------------------------------------

    def _start_ranks(self) -> None:
        on_card = self.device.type == "cuda"
        backend = "nccl" if on_card else "gloo"
        if on_card:
            # the kernel library (the spans' stamp kernel), built once
            # here rather than by every rank at once into one folder
            from ibx_torch.ops import kernels
            kernels.build()
        self.tmp = tempfile.TemporaryDirectory()
        store = os.path.join(self.tmp.name, "store")
        spec = os.path.join(self.tmp.name, "spec.json")
        with open(spec, "w") as f:
            json.dump({"cfg": self.cfg, "traffic": self.tr,
                       "world": self.world, "backend": backend,
                       "device": self.device.type,
                       "first_card": self.device.index or 0}, f)
        env = dict(os.environ, BENCH_RANK_PATH=os.pathsep.join(sys.path))
        threads = str(max(1, (os.cpu_count() or 1) // self.world))
        for r in range(1, self.world):
            self.kids.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), spec, store,
                 str(r), threads], env=env, stdin=subprocess.DEVNULL,
                stdout=sys.__stderr__, stderr=sys.__stderr__))
        atexit.register(self._end_ranks_at_exit)
        threading.Thread(target=self._watch, daemon=True).start()
        self.group = _groups(backend, store, self.world, 0)

    def _watch(self) -> None:
        """End this process, with a message, if a child rank dies before
        the run has ended: its peers' collectives would wait for it."""
        while not self.ended:
            for r, p in enumerate(self.kids, 1):
                code = p.poll()
                if code is not None and not self.ended:
                    print(f"benchmark: rank {r} ended with exit code {code} "
                          f"before the run did", file=sys.__stderr__,
                          flush=True)
                    self._kill()
                    os._exit(5)
            time.sleep(0.5)

    def _kill(self) -> None:
        for p in self.kids:
            if p.poll() is None:
                p.kill()

    def _end_ranks_at_exit(self) -> None:
        """At exit with the groups open (NCCL ranks, a run that was not
        released, or one that failed): the children are killed, and the
        process ends at once, with 0 after a `release` and no uncaught
        exception, else 1, rather than tear down a group whose peers are
        gone."""
        if not self.closed:
            self.ended = True
            self._kill()
            shutil.rmtree(self.tmp.name, ignore_errors=True)
            failed = getattr(sys, "last_value", None) is not None
            sys.stdout.flush()
            sys.stderr.flush()
            os._exit(0 if self.released and not failed else 1)

    def _cmd(self, op: int, arg: int = 0) -> None:
        _command(self.group, op, arg)

    # -- the run ---------------------------------------------------------

    def setup(self) -> None:
        self._start_ranks()
        self.rank = _Rank(self.cfg, self.tr, self.world, self.device)
        if self.rank.ncells != self.cfg["cells"]:
            raise RuntimeError(f"{self.rank.ncells} cells, the configuration "
                               f"states {self.cfg['cells']}")
        self.host_build_s = self.rank.host_build_s
        self.reseed(self.seed)
        # the first chunk captures the step on every rank
        self._march(FIRST)
        harness.sync(self.device)

    def _march(self, flags: int) -> None:
        self._cmd(MARCH, flags)
        self.rank.march(flags)

    def settle(self) -> dict:
        """The same chunk from the seeded start until the card has left
        its slow first phase (`harness.settle`)."""
        return harness.settle(lambda: self._march(FIRST), self.device,
                              **self.tr["settle"])

    def reseed(self, seed: int) -> None:
        """The seeded start of ``seed`` on every rank; nothing kept."""
        self.seed = seed
        self._cmd(RESEED, int(seed))
        self.rank.reseed(seed)

    def _chunks(self, seconds: float, n_max: int, sample: int) -> int:
        n, evs = 0, collections.deque()
        t0 = time.perf_counter()
        while True:
            self._march((FIRST | KEEP_START if n == 0 else 0)
                        | (KEEP_SAMPLE if n == sample else 0))
            n += 1
            if self.device.type == "cuda":
                # at most four chunks in flight
                evs.append(torch.cuda.Event())
                evs[-1].record()
                if len(evs) > 4:
                    evs.popleft().synchronize()
            if n >= n_max or time.perf_counter() - t0 >= seconds:
                break
        harness.sync(self.device)
        return n

    def window(self, seconds: float) -> dict:
        sample = harness.seeded_index(self.seed, 1, int(self.tr["sample_span"]))
        harness.sync(self.device)
        t0 = time.perf_counter()
        n = self._chunks(seconds, 1 << 62, sample)
        el = time.perf_counter() - t0
        self.attempted = n
        steps = n * self.chunk
        return {"cell_updates_per_s": self.cfg["cells"] * steps / el}

    def _tracing(self, fn):
        """``fn()`` with every rank recording (`monitor.tracing`)."""
        from ibx_torch.utils import monitor
        self._cmd(TRACE_ON)
        try:
            with monitor.tracing():
                return fn()
        finally:
            self._cmd(TRACE_OFF)

    def traced(self, path: str) -> dict:
        """Rank 0's spans over ``trace_chunks`` chunks (the traced step
        captured on every rank and the card settled first, the profiler
        off), then the profiler's stretch of as many on rank 0."""
        n = int(self.tr["trace_chunks"])

        def unit(k):
            return self._chunks(1e9, k, -1)
        self._tracing(lambda: unit(1))
        self.settle()
        rec = self._tracing(lambda: spans.stretch(unit, n, self.device))
        tr = harness.trace_stretch(lambda: unit(n), path, self.device)
        self.attempted = n
        return {"spans": rec, "trace": tr, "steps": n * self.chunk}

    def _collect(self) -> None:
        """The kept chunks of every rank, whole, on rank 0's device."""
        self._cmd(COLLECT)
        self.keep = {k: tuple(torch.as_tensor(x, device=self.device)
                              for x in v)
                     for k, v in self.rank.collect().items()}

    def release(self) -> None:
        """Collect the kept chunks and stop every rank's march. gloo ranks
        close their groups and end here. NCCL's teardown waits for every
        peer and every graph that captured its kernels, and on the cards it
        did not end within minutes: there the children wait, their groups
        open, until this process ends, and `_end_ranks_at_exit` kills them
        and ends it without a teardown."""
        self._collect()
        self.ended = True
        self._cmd(STOP)
        self.rank.free()
        self.rank = None
        self.released = True
        if self.device.type == "cuda":
            return
        _close(self.group)
        self.group = None
        for r, p in enumerate(self.kids, 1):
            try:
                p.wait(timeout=END_S)
            except subprocess.TimeoutExpired:
                p.kill()
                raise RuntimeError(f"rank {r} did not end within {END_S} s")
            if p.returncode != 0:
                raise RuntimeError(f"rank {r} ended with exit code "
                                   f"{p.returncode}")
        self.closed = True
        self.tmp.cleanup()

    def _reference(self, dtype):
        dom = domains(self.flow, self.refcase, 1, harness.CACHE + "/reference")
        return Euler(dom[0], self.refcase.freestream(self.flow), dtype=dtype,
                     device=self.device, cfl=float(self.params["cfl"]),
                     guarded=True)

    def readings(self, control: bool = False) -> dict:
        """Each kept chunk's gap to the float64 reference, the whole mesh
        collected from every rank; with ``control`` also the bfloat16
        reference's in the program's place (``control.<name>``). Before
        `release` (as `calibrate.py` reads them) the chunks are collected
        first."""
        if self.rank is not None:
            self._collect()
        ref = self._reference(torch.float64)
        ctl = self._reference(torch.bfloat16) if control else None
        out = {}
        for name, (Pin, Pout) in self.keep.items():
            R = ref.march(Pin, self.chunk)
            out[name + "_gap"] = harness.change_gap(Pin, Pout, R)
            if ctl is not None:
                out["control." + name + "_gap"] = harness.change_gap(
                    Pin, ctl.march(Pin, self.chunk), R)
        return out


# -- a child rank ------------------------------------------------------------

def _watch_parent(pid: int) -> None:
    """End this child if rank 0's process is gone."""
    while True:
        if os.getppid() != pid:
            os._exit(6)
        time.sleep(0.5)


def child(spec_path: str, store: str, rank: int, threads: int) -> int:
    """Rank ``rank``: build, then carry out rank 0's commands until STOP."""
    from ibx_torch.utils import monitor
    threading.Thread(target=_watch_parent, args=(os.getppid(),),
                     daemon=True).start()
    torch.set_num_threads(threads)
    with open(spec_path) as f:
        sp = json.load(f)
    if sp["device"] == "cuda":
        device = torch.device("cuda", sp["first_card"] + rank)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    group = _groups(sp["backend"], store, sp["world"], rank)
    me = _Rank(sp["cfg"], sp["traffic"], sp["world"], device)
    tracing = None
    while True:
        op, arg = _command(group)
        if op == MARCH:
            me.march(arg)
        elif op == RESEED:
            me.reseed(arg)
        elif op == TRACE_ON:
            tracing = monitor.tracing()
            tracing.__enter__()
        elif op == TRACE_OFF:
            tracing.__exit__(None, None, None)
            tracing = None
        elif op == COLLECT:
            me.collect()
        elif op == STOP:
            break
    harness.sync(device)
    me.free()
    if sp["backend"] == "nccl":
        # rank 0 ends this process when it ends (`Run.release`)
        while True:
            time.sleep(60)
    _close(group)
    return 0


if __name__ == "__main__":
    sys.exit(child(sys.argv[1], sys.argv[2], int(sys.argv[3]),
                   int(sys.argv[4])))
