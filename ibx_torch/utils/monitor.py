"""March observability: residual history, convergence detection, the
program's own spans and counters, profiling (counterpart of
`ibx/utils/monitor.py`).

The reference's only run-time observability is verbose stage banners and the
``TimeAverage`` EMA tracker (``src/cfd.jl:747-802``); solvers return residual
ratios (``src/solver.jl:90``). This gives march loops a proper monitor:
history recording, relative-drop convergence tests, rate estimates, a
recorder of spans and counters inside the program, and an optional
`torch.profiler` trace context.

The recorder is off by default and `tracing()` is its only switch. While
it is off, `span` and `device_span` return one shared null context and
`count` returns at once: nothing is kept and no graph node is captured.
While it is on:

* `span(name)` records a host span: its name, its start and end in Unix-time
  nanoseconds (the clock a `torch.profiler` Chrome trace counts its ``ts``
  on, in microseconds after its ``baseTimeNanoseconds``) and the id of the
  span it opened inside. Under a recording `torch.profiler` it also enters
  `torch.profiler.record_function(name)`.
* `device_span(name, device)` records the same on the device's timeline:
  its begin and end are written by a one-thread stamp kernel
  (`ops.kernels.stamp`, ``csrc/stamp.cu``) as ``(tag, %globaltimer)`` into
  a ring on the card, so it works eagerly and inside a CUDA-graph capture,
  where each replay writes fresh slots. On the CPU it takes host stamps.
  The ring is read and put on the host clock only by `records()`; a full
  ring counts ``trace.dropped`` and keeps its first slots.
* `count(name, n)` adds to a counter.

`tracing()` calibrates each card's globaltimer against the host clock at
entry (host time around a synchronised stamp, the best of five) and keeps
the uncertainty with the records. `records()` returns plain data, `write`
writes it as Chrome-trace events, and `profile_trace`, entered inside
`tracing()`, merges it into the `torch.profiler` trace it exports.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import time
from typing import Dict, List, Optional

import torch

from ..ops import kernels

# ring slots a device keeps per recording (16 bytes a slot)
RING_SLOTS = 1 << 18
# tries of the globaltimer calibration, the best kept
CALIBRATION_TRIES = 5
# Chrome-trace process ids of the spans, beside the profiler's own
_HOST_PID = 1 << 30


class ResidualMonitor:
    """Records (iteration, wall_clock, residual [, extras]) samples.

    >>> mon = ResidualMonitor(print_every=100)
    >>> for i in range(n):
    ...     P, res = step(P)
    ...     mon.push(float(res), cl=cl)
    ...     if mon.converged(rtol=1e-4): break
    """

    def __init__(self, *, print_every: int = 0, label: str = "march"):
        self.label = label
        self.print_every = print_every
        self.iters: List[int] = []
        self.times: List[float] = []
        self.residuals: List[float] = []
        self.extras: List[dict] = []
        self._t0 = time.time()
        self._n = 0

    def push(self, residual: float, **extras) -> None:
        self._n += 1
        self.iters.append(self._n)
        self.times.append(time.time() - self._t0)
        self.residuals.append(float(residual))
        self.extras.append(extras)
        if self.print_every and self._n % self.print_every == 0:
            xs = " ".join(f"{k}={v:.5g}" for k, v in extras.items())
            print(f"[{self.label}] it={self._n} t={self.times[-1]:.1f}s "
                  f"res={residual:.4e} {xs}", flush=True)

    @property
    def r0(self) -> Optional[float]:
        return self.residuals[0] if self.residuals else None

    def drop(self) -> float:
        """Residual reduction ratio vs the first sample."""
        if not self.residuals:
            return 1.0
        return self.residuals[-1] / (self.r0 + 1e-300)

    def converged(self, *, rtol: float = 1e-4, atol: float = 0.0) -> bool:
        if not self.residuals:
            return False
        return self.residuals[-1] <= rtol * self.r0 + atol

    def rate(self, window: int = 20) -> float:
        """Geometric per-iteration residual reduction over the last window."""
        if len(self.residuals) < 2:
            return 1.0
        w = min(window, len(self.residuals) - 1)
        a, b = self.residuals[-1 - w], self.residuals[-1]
        if a <= 0:
            return 1.0
        return (b / a) ** (1.0 / w)

    def summary(self) -> dict:
        return dict(
            label=self.label,
            iterations=self._n,
            wall_clock=self.times[-1] if self.times else 0.0,
            residual_first=self.r0,
            residual_last=self.residuals[-1] if self.residuals else None,
            drop=self.drop(),
            rate=self.rate(),
        )


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------

class _Ring:
    """A device's stamps: ``(tag, time ns)`` rows in slot order. On a card
    the rows and the head live on it, written by the stamp kernel; a
    captured graph holds their addresses, so a card's ring is made once
    and kept for the process. On the CPU they are host stamps."""

    def __init__(self, device: torch.device, slots: int):
        self.device, self.capacity = device, slots
        self.on_card = device.type == "cuda"
        if self.on_card:
            self.slots = torch.zeros((slots, 2), dtype=torch.int64,
                                     device=device)
            self.head = torch.zeros(1, dtype=torch.int64, device=device)
            self.cal = torch.zeros((1, 2), dtype=torch.int64, device=device)
            self.cal_head = torch.zeros(1, dtype=torch.int64, device=device)
        else:
            self.rows: List[tuple] = []
            self.n = 0
        self.offset_ns, self.uncertainty_ns = 0, 0

    def stamp(self, tag: int) -> None:
        if self.on_card:
            kernels.stamp(self.slots, self.head, tag)
            return
        if self.n < self.capacity:
            self.rows.append((tag, time.time_ns()))
        self.n += 1

    def clear(self) -> None:
        if self.on_card:
            self.head.zero_()
        else:
            self.rows, self.n = [], 0

    def calibrate(self) -> None:
        """The globaltimer-to-Unix offset: host time around a synchronised
        stamp, the try with the narrowest window kept; its half width is
        the uncertainty."""
        if not self.on_card:
            return
        kernels.stamp(self.cal, self.cal_head, 0)   # checks and loads
        # the launch alone between the two host times: the library call
        # with its arguments made beforehand
        stamp = kernels.build().ibx_stamp
        args = (self.cal.data_ptr(), self.cal_head.data_ptr(), 1, 0,
                torch.cuda.current_stream(self.device).cuda_stream)
        best = None
        for _ in range(CALIBRATION_TRIES):
            self.cal_head.zero_()
            torch.cuda.synchronize(self.device)
            t0 = time.time_ns()
            stamp(*args)
            torch.cuda.synchronize(self.device)
            t1 = time.time_ns()
            gt = int(self.cal[0, 1])
            if best is None or t1 - t0 < best[1] - best[0]:
                best = (t0, t1, gt)
        t0, t1, gt = best
        self.offset_ns = (t0 + t1) // 2 - gt
        self.uncertainty_ns = (t1 - t0 + 1) // 2

    def read(self):
        """(the rows on the host clock, the stamps dropped)."""
        if self.on_card:
            n = int(self.head)
            rows = self.slots[:min(n, self.capacity)].cpu().tolist()
            rows = [(tag, t + self.offset_ns) for tag, t in rows]
        else:
            n, rows = self.n, list(self.rows)
        return rows, max(0, n - self.capacity)


# the cards' rings, kept for the process (captured graphs hold them)
_card_rings: Dict[torch.device, _Ring] = {}
# device-span names by tag (2 tags a name: begin, end), kept for the
# process: a captured graph holds its tags
_names: List[str] = []
_tags: Dict[str, int] = {}


def _tag(name: str) -> int:
    t = _tags.get(name)
    if t is None:
        t = _tags[name] = 2 * len(_names)
        _names.append(name)
    return t


class _Recorder:
    def __init__(self):
        self.ids = itertools.count(1)
        self.stack: List[int] = []
        self.host: List[dict] = []
        self.counters: Dict[str, int] = {}
        self.rings: Dict[torch.device, _Ring] = {}

    def ring(self, device: torch.device) -> _Ring:
        r = self.rings.get(device)
        if r is None:
            if device.type == "cuda":
                if torch.cuda.is_current_stream_capturing():
                    raise RuntimeError(
                        f"the first device_span on {device} of this "
                        "recording is inside a CUDA-graph capture, where "
                        "its clock cannot be calibrated: enter tracing() "
                        "with that device current")
                r = _card_rings.get(device)
                if r is None:
                    r = _card_rings[device] = _Ring(device, RING_SLOTS)
                r.clear()
                r.calibrate()
            else:
                r = _Ring(device, RING_SLOTS)
            self.rings[device] = r
        return r

    def clear(self) -> None:
        self.host, self.counters = [], {}
        for r in self.rings.values():
            r.clear()


_rec: Optional[_Recorder] = None     # the recorder while recording is on
_last: Optional[_Recorder] = None    # the last one, which `records` reads
_NULL = contextlib.nullcontext()


def recording() -> bool:
    """Whether `tracing()` is on."""
    return _rec is not None


@contextlib.contextmanager
def tracing():
    """Turn recording on for the block (see the module docstring); a
    nested call leaves the outer one's records as they are. Entry drops
    the last records and calibrates the current card's clock."""
    global _rec, _last
    if _rec is not None:
        yield
        return
    rec = _Recorder()
    if torch.cuda.is_available():
        rec.ring(torch.device("cuda", torch.cuda.current_device()))
    _rec = _last = rec
    try:
        yield
    finally:
        _rec = None


def clear() -> None:
    """Drop the records made so far (recording stays as it is)."""
    if _last is not None:
        _last.clear()


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    if _rec is None:
        return
    c = _rec.counters
    c[name] = c.get(name, 0) + n


class _HostSpan:
    __slots__ = ("rec", "name", "id", "parent", "t0", "rf")

    def __init__(self, rec: _Recorder, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        rec = self.rec
        self.id = next(rec.ids)
        self.parent = rec.stack[-1] if rec.stack else None
        rec.stack.append(self.id)
        self.rf = None
        if torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        rec = self.rec
        rec.stack.remove(self.id)
        rec.host.append({"id": self.id, "parent": self.parent,
                         "name": self.name, "t0_ns": self.t0,
                         "t1_ns": t1})
        return False


def span(name: str):
    """A host span ``name`` around the block."""
    if _rec is None:
        return _NULL
    return _HostSpan(_rec, name)


def add_span(name: str, t0_ns: int, t1_ns: int) -> None:
    """Record a host span that has already ended (from ``t0_ns`` to
    ``t1_ns``, Unix-time nanoseconds), a child of the span open now."""
    rec = _rec
    if rec is None:
        return
    rec.host.append({"id": next(rec.ids),
                     "parent": rec.stack[-1] if rec.stack else None,
                     "name": name, "t0_ns": int(t0_ns), "t1_ns": int(t1_ns)})


class _DeviceSpan:
    __slots__ = ("ring", "tag")

    def __init__(self, ring: _Ring, tag: int):
        self.ring, self.tag = ring, tag

    def __enter__(self):
        self.ring.stamp(self.tag)
        return self

    def __exit__(self, *exc):
        self.ring.stamp(self.tag + 1)
        return False


def device_span(name: str, device=None):
    """A span ``name`` on the timeline of ``device`` (a `torch.device`, a
    tensor's, or None for the current card, the CPU without one) around
    the work the block enqueues there."""
    rec = _rec
    if rec is None:
        return _NULL
    if isinstance(device, torch.Tensor):
        device = device.device
    elif device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if torch.cuda.is_available() else torch.device("cpu"))
    else:
        device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return _DeviceSpan(rec.ring(device), _tag(name))


def _device_spans(device: torch.device, rows, ids) -> List[dict]:
    """Pair a ring's begin and end stamps (slot order is stream order) into
    spans; an end pairs with the latest open begin of its name, and the
    span open around a begin is its parent."""
    out, stack = [], []
    for tag, t in rows:
        name = _names[tag // 2]
        if tag % 2 == 0:
            stack.append((name, t, next(ids)))
            continue
        for k in range(len(stack) - 1, -1, -1):
            if stack[k][0] == name:
                _, t0, sid = stack.pop(k)
                parent = stack[k - 1][2] if k > 0 else None
                out.append({"id": sid, "parent": parent, "name": name,
                            "t0_ns": t0, "t1_ns": t, "device": str(device)})
                break
    return out


def records() -> dict:
    """The last recording's records as plain data: ``host`` and ``device``
    spans (``id``, ``parent``, ``name``, ``t0_ns``, ``t1_ns`` on the host's
    Unix clock; device spans add ``device``), ``counters`` and each card's
    ``calibration`` (``offset_ns``: globaltimer to Unix time,
    ``uncertainty_ns``). Reading a card's ring synchronises it."""
    rec = _last
    if rec is None:
        return {"host": [], "device": [], "counters": {}, "calibration": {}}
    ids = itertools.count(1 << 40)
    device, counters, cal = [], dict(rec.counters), {}
    for dev, ring in rec.rings.items():
        rows, dropped = ring.read()
        device += _device_spans(dev, rows, ids)
        if dropped:
            counters["trace.dropped"] = counters.get("trace.dropped",
                                                     0) + dropped
        if ring.on_card:
            cal[str(dev)] = {"offset_ns": ring.offset_ns,
                             "uncertainty_ns": ring.uncertainty_ns}
    device.sort(key=lambda s: s["t0_ns"])
    return {"host": sorted(rec.host, key=lambda s: s["t0_ns"]),
            "device": device, "counters": counters, "calibration": cal}


def _chrome_events(rec: dict, base_ns: int) -> List[dict]:
    """``rec`` (`records()`) as Chrome-trace events, ``ts`` in microseconds
    after ``base_ns``: host spans in one process, each device's in one of
    its own, the counters at the last span's end."""
    pids = {"host": _HOST_PID}
    for s in rec["device"]:
        pids.setdefault(s["device"], _HOST_PID + len(pids))
    ev = [{"ph": "M", "name": "process_name", "pid": pid,
           "args": {"name": f"ibx_torch spans ({what})"}}
          for what, pid in pids.items()]
    ends = []
    for s in rec["host"] + rec["device"]:
        ends.append(s["t1_ns"])
        ev.append({"ph": "X", "cat": "ibx_span", "name": s["name"],
                   "pid": pids[s.get("device", "host")], "tid": 0,
                   "ts": (s["t0_ns"] - base_ns) / 1e3,
                   "dur": (s["t1_ns"] - s["t0_ns"]) / 1e3,
                   "args": {"id": s["id"], "parent": s["parent"]}})
    if rec["counters"]:
        ev.append({"ph": "C", "name": "ibx_counters", "pid": _HOST_PID,
                   "tid": 0, "ts": (max(ends, default=base_ns) - base_ns)
                   / 1e3, "args": dict(rec["counters"])})
    return ev


def write(path: str, rec: Optional[dict] = None) -> None:
    """Write ``rec`` (default: `records()`) to ``path`` as a Chrome trace
    whose ``ts`` count microseconds after its ``baseTimeNanoseconds``."""
    rec = records() if rec is None else rec
    starts = [s["t0_ns"] for s in rec["host"] + rec["device"]]
    base = min(starts, default=time.time_ns())
    with open(path, "w") as f:
        json.dump({"traceEvents": _chrome_events(rec, base),
                   "baseTimeNanoseconds": base,
                   "ibx_calibration": rec["calibration"]}, f)


@contextlib.contextmanager
def profile_trace(logdir: Optional[str]):
    """`torch.profiler` trace of the block, written as a Chrome trace
    (``trace.json``) into ``logdir`` when a logdir is given; a no-op
    otherwise. The CPU is traced always, the CUDA device where one is
    available. Entered inside `tracing()`, it merges the program's spans
    and counters (`records()`) into the trace; outside, it records none,
    and the block runs the graphs it runs unprofiled."""
    if not logdir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "trace.json")
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(path)
    if not recording():
        return
    with open(path) as f:
        trace = json.load(f)
    trace["traceEvents"] += _chrome_events(
        records(), int(trace.get("baseTimeNanoseconds", 0)))
    with open(path, "w") as f:
        json.dump(trace, f)
