"""The benchmark's general parts: the spec and its files found by name,
the seeded start state, the comparison arithmetic, the reading of a
profiler trace, and the result line.

Everything a cell is made of lives in a file of its own, found by the
name that ``BENCHMARK.json`` gives: ``configs/<config>.json``,
``traffic/<traffic>.json`` (whose ``runner`` names
``runners/<runner>.py``), ``metrics/<metric>.py`` and
``roofline/<kernel>.py``. Adding a cell, a configuration or a metric adds
files and entries and edits none.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
from types import ModuleType
from typing import Dict, List, Optional, Sequence, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# the reference's cache of its mesh tables: a fixed path inside the
# checkout, so that only a checkout's first run builds them (the program
# builds its kernel library into its own folder, also in the checkout)
CACHE = os.path.join(ROOT, ".bench_cache")
JAX_NAMES = ("jax", "jaxlib", "flax", "ibx")


class SpecError(RuntimeError):
    """The spec names a cell, file or metric that is not there."""


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def spec(root: str = ROOT) -> dict:
    path = os.path.join(root, "BENCHMARK.json")
    if not os.path.exists(path):
        raise SpecError(f"no BENCHMARK.json in {root}")
    return load_json(path)


def by_name(entries: Sequence[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise SpecError(f"no {what} named {name!r}")


def bench_dir(sp: dict, root: str = ROOT) -> str:
    """The benchmark's folder in the checkout ``root``: the first of the
    spec's ``paths``."""
    return os.path.join(root, sp["paths"][0])


def data(bdir: str, kind: str, name: str, ext: str = ".json"):
    """``<kind>/<name><ext>`` of the benchmark folder ``bdir``, read."""
    path = os.path.join(bdir, kind, name + ext)
    if not os.path.exists(path):
        raise SpecError(f"no {kind} file {path}")
    return load_json(path)


def cell(sp: dict, name: str, root: str = ROOT) -> Tuple[dict, dict, dict]:
    """(workload entry, configuration, traffic mix) of the cell ``name``."""
    wl = by_name(sp["workloads"], name, "workload")
    cf = by_name(sp["configs"], wl["config"], "configuration")
    cfg = load_json(os.path.join(root, cf["file"]))
    return wl, cfg, data(bench_dir(sp, root), "traffic", wl["traffic"])


def module(kind: str, name: str, bdir: str = HERE) -> ModuleType:
    """``<kind>/<name>.py`` of the benchmark folder ``bdir``, loaded by
    its path (a name may hold dots)."""
    path = os.path.abspath(os.path.join(bdir, kind, name + ".py"))
    if not os.path.exists(path):
        raise SpecError(f"no {kind} file {path}")
    key = "_bench_" + "".join(c if c.isalnum() else "_" for c in path)
    if key in sys.modules:
        return sys.modules[key]
    sp = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(sp)
    sys.modules[key] = mod
    sp.loader.exec_module(mod)
    return mod


def metrics_of(sp: dict, section: str, workload: str) -> List[dict]:
    """The entries of ``section`` that the cell ``workload`` reports: those
    whose ``workloads`` list it, and those without the key."""
    return [m for m in sp[section]
            if "workloads" not in m or workload in m["workloads"]]


def jax_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: ``ibx_torch`` is not ``ibx``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in JAX_NAMES})


# -- the seeded start state ------------------------------------------------

def start_state(P_inf, n_cells: int, seed: int, amplitude: float, device):
    """The freestream ``P_inf`` [p, T, u...] on ``n_cells`` cells with
    seeded noise: p and T times (1 + a n), each velocity component plus
    a |V| n, n standard normal from a generator on ``device`` seeded with
    ``seed``, in float32. The same seed gives the same state."""
    import torch
    P_inf = [float(x) for x in P_inf]
    C = len(P_inf)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63))
    n = torch.randn((n_cells, C), generator=g, device=device,
                    dtype=torch.float32)
    base = torch.tensor(P_inf, dtype=torch.float32, device=device)
    V = math.sqrt(sum(x * x for x in P_inf[2:]))
    scale = torch.tensor([amplitude * P_inf[0], amplitude * P_inf[1]]
                         + [amplitude * V] * (C - 2), dtype=torch.float32,
                         device=device)
    return base[None, :] + scale[None, :] * n


def seeded_index(seed: int, lo: int, hi: int) -> int:
    """An index in [lo, hi) drawn from the seed."""
    import random
    return random.Random(int(seed)).randrange(lo, hi)


# -- the comparison ----------------------------------------------------------

def change_gap(x0, out, ref) -> float:
    """How far the program's change ``out - x0`` lies from the
    reference's ``ref - x0``: the largest gap of a cell, a channel at a
    time over the largest reference change of that channel, in float64.
    A state that did not move reads 1; a non-finite one reads inf."""
    import torch
    x0 = x0.double()
    d_out = out.double() - x0
    d_ref = ref.double().to(x0.device) - x0
    if not bool(torch.isfinite(d_out).all()):
        return math.inf
    scale = d_ref.abs().amax(0)
    gap = (d_out - d_ref).abs().amax(0) / torch.where(
        scale > 0, scale, torch.ones_like(scale))
    return float(gap.max())


def rel_gap(a: float, b: float) -> float:
    if not math.isfinite(a):
        return math.inf
    return abs(a - b) / max(abs(b), 1e-30)


# -- the device trace --------------------------------------------------------

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the span around the traced stretch where host ops are traced (the CPU)
WINDOW_SPAN = "bench.window"
# on the card the stretch lies between two device synchronisations
SYNC = "cudaDeviceSynchronize"


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _end(e: dict) -> float:
    return float(e["ts"]) + float(e["dur"])


class Trace:
    """A `torch.profiler` chrome trace, read within the traced stretch:
    from the end of the first ``cudaDeviceSynchronize`` to the end of the
    last (on the card, where only device activity and the CUDA runtime
    calls are traced), or within the span ``bench.window`` (host ops, on
    the CPU). Times are in microseconds as the trace gives them."""

    def __init__(self, events: List[dict]):
        ev = [e for e in events if e.get("ph") == "X"]
        win = [e for e in ev if e.get("name") == WINDOW_SPAN
               and e.get("cat") == "user_annotation"]
        syncs = sorted((e for e in ev if e.get("cat") == "cuda_runtime"
                        and e.get("name") == SYNC),
                       key=lambda e: float(e["ts"]))
        if win:
            w = max(win, key=lambda e: e["dur"])
            self.t0, self.t1 = float(w["ts"]), _end(w)
        elif len(syncs) >= 2:
            self.t0, self.t1 = _end(syncs[0]), _end(syncs[-1])
        else:
            raise RuntimeError("the trace holds neither a bench.window "
                               "span nor two device synchronisations")

        def inside(e):
            return self.t0 <= float(e["ts"]) <= self.t1

        self.device = [e for e in ev if e.get("cat") in DEVICE_CATS
                       and inside(e)]
        self.kernels = [e for e in self.device if e.get("cat") == "kernel"]
        self.runtime = [e for e in ev if e.get("cat") == "cuda_runtime"
                        and inside(e)]

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as f:
            data = json.load(f)
        return cls(data["traceEvents"] if isinstance(data, dict) else data)

    @property
    def window_us(self) -> float:
        return self.t1 - self.t0

    def busy_intervals(self) -> List[Tuple[float, float]]:
        return _union([(max(float(e["ts"]), self.t0), min(_end(e), self.t1))
                       for e in self.device])

    def busy_us(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def idle_gaps(self) -> List[Tuple[float, float]]:
        """The device's idle intervals inside the window."""
        gaps, t = [], self.t0
        for a, b in self.busy_intervals():
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if self.t1 > t:
            gaps.append((t, self.t1))
        return gaps

    def reads(self) -> List[dict]:
        """The device-to-host copies: each a host read of device data."""
        return [e for e in self.device if e.get("cat") == "gpu_memcpy"
                and "DtoH" in e.get("name", "")]

    def graph_launches(self) -> List[dict]:
        return [e for e in self.runtime
                if e.get("name", "").startswith("cudaGraphLaunch")]

    def in_graphs(self) -> List[dict]:
        """The device activities of graph replays: those whose
        correlation id is a ``cudaGraphLaunch``'s."""
        ids = {(e.get("args") or {}).get("correlation")
               for e in self.graph_launches()}
        ids.discard(None)
        return [e for e in self.device
                if (e.get("args") or {}).get("correlation") in ids]

    def kernel_time(self, match) -> List[Tuple[str, float, float]]:
        """(name, start, duration) of every kernel whose name ``match``
        accepts, in time order."""
        return sorted(((e["name"], float(e["ts"]), float(e["dur"]))
                       for e in self.kernels if match(e["name"])),
                      key=lambda x: x[1])

    def host_at(self, t: float) -> str:
        """What the host was doing at time ``t``: the CUDA runtime call
        it was in, or the last one it had left."""
        last = None
        for e in self.runtime:
            if float(e["ts"]) <= t <= _end(e):
                return e["name"]
            if _end(e) < t and (last is None or _end(e) > _end(last)):
                last = e
        return "after " + last["name"] if last is not None else \
            "no CUDA call"

    def top_ops(self, n: int = 10) -> List[List]:
        tot: Dict[str, float] = {}
        for e in self.device:
            tot[e["name"]] = tot.get(e["name"], 0.0) + float(e["dur"])
        return [[k, v / 1e6] for k, v in
                sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    def top_gaps(self, n: int = 10, longest: int = 200) -> List[List]:
        """Idle time by what the host was doing as it began, over the
        ``longest`` idle gaps."""
        gaps = sorted(self.idle_gaps(), key=lambda g: g[0] - g[1])[:longest]
        tot: Dict[str, float] = {}
        for a, b in gaps:
            k = self.host_at(a)
            tot[k] = tot.get(k, 0.0) + (b - a)
        return [[k, v / 1e6] for k, v in
                sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def settle(unit, device, *, least_s: float, most_s: float, drop: float,
           after_s: float) -> dict:
    """Run ``unit`` (one chunk or call, the same work each time) before
    the window until the card has left its slow first phase of load: for
    its first 3 to 31 s a card runs the same work about a tenth slower
    at an unchanged SM clock, then steps up once. Runs for at least
    ``least_s`` seconds, and ends ``after_s`` after the step (the median
    time of the last five units below ``1 - drop`` times that of units 3
    to 7), or at ``most_s``. Returns the seconds taken and when the step
    was seen (None where it was not)."""
    import statistics
    import time
    times: List[float] = []
    step = None
    t0 = time.perf_counter()
    while True:
        a = time.perf_counter()
        unit()
        sync(device)
        times.append(time.perf_counter() - a)
        now = time.perf_counter() - t0
        if step is None and len(times) >= 12 and statistics.median(
                times[-5:]) < (1.0 - drop) * statistics.median(times[2:7]):
            step = now
        if now >= most_s or (step is not None
                             and now >= max(least_s, step + after_s)):
            return {"seconds": now, "step_at": step, "units": len(times)}


def trace_stretch(fn, path: str, device) -> Trace:
    """Run ``fn`` under `torch.profiler`, write the chrome trace to
    ``path`` and read it back. On the card only device activity and the
    CUDA runtime calls are traced, between two synchronisations: tracing
    host ops would lengthen the host's turns and read as idle card. On
    the CPU, host ops inside the span ``bench.window``."""
    from torch.profiler import ProfilerActivity, profile, record_function
    if device.type == "cuda":
        sync(device)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            sync(device)
            fn()
            sync(device)
    else:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with record_function(WINDOW_SPAN):
                fn()
    prof.export_chrome_trace(path)
    try:
        return Trace.load(path)
    finally:
        os.remove(path)


# -- the result --------------------------------------------------------------

class Check:
    """One number compared with the reference, beside its limit."""

    def __init__(self, name: str, value: float, limit: float):
        self.name, self.value, self.limit = name, float(value), float(limit)

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def device_info(device, count: int, peak: int,
                trace: Optional[Trace]) -> dict:
    import torch
    on_card = device.type == "cuda"
    d = {"platform": "gpu" if on_card else "cpu",
         "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
         "count": count, "memory_peak_bytes": int(peak)}
    if trace is not None:
        d["busy_s"] = trace.busy_us() / 1e6
        d["window_s"] = trace.window_us / 1e6
    return d


def result_line(*, checks: Sequence[Check], attempted: int, metrics: dict,
                device: dict, breakdown: Optional[dict] = None) -> dict:
    failed = sum(not c.ok for c in checks)
    line = {"correct": failed == 0 and bool(checks), "attempted": attempted,
            "failed": failed, "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    # the numbers compared, each beside its limit: the last key
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                      for c in checks}
    return line


def check_lines(checks: Sequence[Check]) -> List[str]:
    return [f"check {c.name}: {c.value!r} (limit {c.limit!r}) "
            f"{'ok' if c.ok else 'FAIL'}" for c in checks]


# -- rooflines ---------------------------------------------------------------

def peaks() -> dict:
    return load_json(os.path.join(HERE, "roofline", "peaks.json"))


def least_seconds(ops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations
    at the float32 peak and the bytes at the HBM rate."""
    pk = peaks()
    return max(ops / pk["float32_flop_per_s"],
               nbytes / pk["hbm_bytes_per_s"])


def roofline_pct(trace: "Trace", pattern: str, bound_of) -> Optional[float]:
    """100 x (the least time of every launch of the kernels whose name
    holds ``pattern``, ``bound_of(name, i)`` seconds for the i-th in time
    order) / (their device time), or None where none ran."""
    ks = trace.kernel_time(lambda n: pattern in n)
    if not ks:
        return None
    least = sum(bound_of(name, i) for i, (name, _, _) in enumerate(ks))
    return 100.0 * least / (sum(d for _, _, d in ks) / 1e6)
