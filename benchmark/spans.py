"""The program's own records, read: the spans and counters that
`ibx_torch.utils.monitor` keeps while `tracing()` is on, handed to the
per-layer readers as ``ctx["spans"]`` (what ``records()`` returns: host
and device spans with ``id``, ``parent``, ``name``, ``t0_ns``, ``t1_ns`` on
the host's Unix clock, the counters, each card's calibration).

`stretch` is the traced stretch that gives them, with the profiler off:
one untimed unit, which captures the traced variant of the step or loop,
then the records cleared and ``n`` units recorded. A reader finds nothing
(None) where ``ctx`` has no records, as in a program without spans.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

# the spans of a step and of a call: their count is the steps and calls
STEP = "march.step"
CALL = "fas.L0.head"


def stretch(unit, n: int, device) -> Optional[dict]:
    """``unit(1)`` untimed, then ``unit(n)`` recorded: the program's
    records (None where the program keeps none). ``unit(k)`` runs ``k``
    chunks or calls and returns once they are enqueued."""
    import harness
    try:
        from ibx_torch.utils import monitor
    except ImportError:
        return None
    if not hasattr(monitor, "tracing"):
        return None
    with monitor.tracing():
        unit(1)
        harness.sync(device)
        monitor.clear()
        unit(n)
        harness.sync(device)
    return monitor.records()


def of(ctx: dict) -> Optional[dict]:
    rec = ctx.get("spans")
    return rec if rec and (rec.get("host") or rec.get("device")) else None


def named(spans: Iterable[dict], *names: str,
          prefix: Optional[str] = None) -> List[dict]:
    """The spans of any of ``names``, or whose name starts with
    ``prefix`` (and ends with one of ``names`` where both are given)."""
    if prefix is None:
        return [s for s in spans if s["name"] in names]
    return [s for s in spans if s["name"].startswith(prefix)
            and (not names or s["name"].endswith(names))]


def dur_ns(s: dict) -> int:
    return s["t1_ns"] - s["t0_ns"]


def union(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def self_ns(span: dict, spans: Iterable[dict]) -> int:
    """``span``'s duration less the part its children cover."""
    kids = union((max(s["t0_ns"], span["t0_ns"]),
                  min(s["t1_ns"], span["t1_ns"]))
                 for s in spans if s["parent"] == span["id"])
    return dur_ns(span) - sum(max(0, b - a) for a, b in kids)


def units(rec: dict, name: str) -> int:
    return len(named(rec["device"], name))


def per_unit_ms(rec: dict, spans: List[dict], unit: str) -> Optional[float]:
    n = units(rec, unit)
    if not n or not spans:
        return None
    return sum(dur_ns(s) for s in spans) / 1e6 / n


def busy(rec: dict) -> List[Tuple[int, int]]:
    """The union of the device spans: the card at work on spanned code."""
    return union((s["t0_ns"], s["t1_ns"]) for s in rec["device"])


def idle_gaps(rec: dict) -> List[Tuple[int, int]]:
    """The card's idle intervals between its first span's start and its
    last span's end."""
    b = busy(rec)
    return [(b[i][1], b[i + 1][0]) for i in range(len(b) - 1)]


def idle_pct(rec: dict) -> Optional[float]:
    """100 x (stretch - union of device spans) / stretch, the stretch from
    the first device span's start to the last one's end."""
    b = busy(rec)
    if not b:
        return None
    whole = b[-1][1] - b[0][0]
    if whole <= 0:
        return None
    return 100.0 * sum(g1 - g0 for g0, g1 in idle_gaps(rec)) / whole


def overlapping(gaps: List[Tuple[int, int]],
                spans: List[dict]) -> List[Tuple[int, int]]:
    """The gaps that share time with any of ``spans``."""
    return [(a, b) for a, b in gaps
            if any(s["t0_ns"] < b and a < s["t1_ns"] for s in spans)]


def build_s(rec: dict, *names: str) -> Optional[float]:
    """Seconds of the host spans ``names`` (the build's stages)."""
    sp = named(rec["host"], *names)
    if not sp:
        return None
    return sum(dur_ns(s) for s in sp) / 1e9


def by_name_ms(spans: Iterable[dict]) -> Dict[str, float]:
    tot: Dict[str, float] = {}
    for s in spans:
        tot[s["name"]] = tot.get(s["name"], 0.0) + dur_ns(s) / 1e6
    return tot
