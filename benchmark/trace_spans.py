"""One cell's per-layer readings from the program's own records
(`spans.py`, the span readers of `metrics/`), beside the profiler's, and
what recording costs.

    python3 benchmark/trace_spans.py --workload <cell> --seed <n> \
        [--seconds 10] [--cost-units 12]

From the root of a checkout, on the card. The cell's runner sets up as a
run of `run.py` does, with the build (and a solver cell's `FasEuler`)
recorded by `monitor.tracing()` and the first unit, which captures the
untraced graph, outside it. Then: the settle; the window with recording
off (the end-to-end metric); one unit recording, which captures the
traced graph; the settle again (the card starts each load slow after a
pause, `harness.settle`); the program's traced stretch (`spans.stretch`,
the profiler off: one untimed unit, then ``trace_chunks`` or
``trace_calls`` units) and the span readers; the settle again and the
unit's time with recording off and on in turns (off, on, on, off,
``--cost-units`` units each, ending at a synchronize); last the
profiler's traced stretch and its readers, after which the host's turns
at a FAS call's reads stay slower (section 5 of PERF.md). Prints one JSON
line. No reference runs: `run.py` decides ``correct``.

It stands in for the runners until they record the build and hand the
records to the span readers as ``ctx["spans"]`` themselves; it then goes.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
for _p in (os.path.dirname(HERE), HERE):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import harness  # noqa: E402
import spans  # noqa: E402
from run import card_line  # noqa: E402

SPAN_METRICS = {
    "march": ("rhs_ms_per_step", "two_to_one_ms_per_step",
              "ghost_bc_ms_per_step", "update_ms_per_step", "card_idle_pct"),
    "fas_cycle": ("smooth_ms_per_call", "transfer_ms_per_call",
                  "stop_read_idle_ms_per_call", "call_idle_pct"),
}
BUILD_METRICS = ("build_mesh_s", "build_domain_s", "build_blocks_s")
PROFILER_METRICS = {
    "march": ("busy_ms_per_step", "launches_per_step"),
    "fas_cycle": ("busy_ms_per_call", "reads_per_call"),
}


def _recorded(fn, kept):
    """``fn`` run under `monitor.tracing()`, its host spans kept."""
    from ibx_torch.utils import monitor

    def wrapped(*a, **k):
        with monitor.tracing():
            out = fn(*a, **k)
        kept.extend(monitor.records()["host"])
        return out
    return wrapped


def _units(run, runner: str):
    """``k`` chunks or calls of the runner's timed loop, returning once
    they are enqueued: no time limit, no sample kept (the loop's
    arguments: seconds, most units, the unit to keep)."""
    loop = run._chunks if runner == "march" else run._calls
    return lambda k: loop(float("inf"), k, -1)


def main(argv=None, *, root: str = harness.ROOT, device=None) -> int:
    """One cell; ``device`` other than the card is for a rehearsal."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--cost-units", type=int, default=12)
    a = ap.parse_args(argv)

    import torch
    import ibx_torch.cases as cases
    import ibx_torch.solve as solve
    from ibx_torch.utils import monitor

    if device is None:
        if not torch.cuda.is_available():
            print("trace_spans: no CUDA device", file=sys.stderr)
            return 3
        device = torch.device("cuda", 0)
    device = torch.device(device)
    sp = harness.spec(root)
    _, cfg, traffic = harness.cell(sp, a.workload, root)
    bdir = harness.bench_dir(sp, root)
    runner = traffic["runner"]
    drv = harness.module("runners", runner, bdir)
    kept = []
    build = "build_" + cfg["case"]
    plain = getattr(cases, build), solve.FasEuler
    setattr(cases, build, _recorded(plain[0], kept))
    solve.FasEuler = _recorded(plain[1], kept)
    run = drv.Run(cfg, traffic, a.seed, device)
    try:
        run.setup()
    finally:
        setattr(cases, build, plain[0])
        solve.FasEuler = plain[1]
    harness.sync(device)
    settled = run.settle()
    unit = _units(run, runner)
    steps = int(traffic.get("chunk_steps", 1))
    n = int(traffic["trace_chunks" if runner == "march" else "trace_calls"])
    out = {"workload": a.workload, "seed": a.seed,
           "card": card_line() if device.type == "cuda" else "cpu",
           "host_build_s": run.host_build_s,
           "settle_s": settled["seconds"]}
    out.update(run.window(a.seconds))

    with monitor.tracing():
        unit(1)
    run.settle()
    rec = spans.stretch(unit, n, device)
    rec["host"] = kept + rec["host"]
    sctx = {"spans": rec}
    out["spans"] = {m: harness.module("metrics", m, bdir).read(sctx)
                    for m in SPAN_METRICS[runner] + BUILD_METRICS}
    unit_span = spans.STEP if runner == "march" else spans.CALL
    out["ms_by_span"] = {k: v / spans.units(rec, unit_span) for k, v in
                         spans.by_name_ms(rec["device"]).items()}
    out["units_traced"] = spans.units(rec, unit_span)
    out["counters"] = rec["counters"]
    out["calibration"] = rec["calibration"]
    reads = spans.named(rec["host"], "fas.stop_read")
    if reads:
        out["stop_read_host_ms"] = sum(map(spans.dur_ns, reads)) / 1e6 / len(
            reads)

    # the unit's ms off and on, in turns
    run.settle()
    k = a.cost_units
    per = steps if runner == "march" else 1
    cost = {"off": [], "on": []}
    for side in ("off", "on", "on", "off"):
        harness.sync(device)
        t0 = time.perf_counter()
        if side == "on":
            with monitor.tracing():
                unit(k)
                harness.sync(device)
        else:
            unit(k)
            harness.sync(device)
        cost[side].append((time.perf_counter() - t0) * 1e3 / (k * per))
    out["ms_per_" + ("step" if runner == "march" else "call")] = cost

    run.settle()
    with tempfile.TemporaryDirectory() as d:
        ctx = {"cfg": cfg, "params": run.params, "bdir": bdir}
        ctx.update(run.traced(os.path.join(d, "trace.json")))
    out["profiler"] = {m: harness.module("metrics", m, bdir).read(ctx)
                       for m in PROFILER_METRICS[runner]}
    out["profiler"]["idle_pct"] = 100.0 * (
        1.0 - ctx["trace"].busy_us() / ctx["trace"].window_us)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
