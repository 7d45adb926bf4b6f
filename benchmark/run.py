"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. The cell, its configuration, its traffic
mix (and through it the runner), its limits and its metrics are found by
name from ``BENCHMARK.json``. ``--trace 0`` measures the window and
prints the cell's end-to-end metrics; ``--trace 1`` traces a short
stretch of the same path under `torch.profiler` and prints its per-layer
metrics. Either way the compared answers are checked against the plain
reference once the window has closed and the program's state is freed,
each number beside its limit on the last lines of standard error and
under ``checks``, the last key of the line.

Exit codes: 0 with a result line (``correct`` may be false); 2 for a
spec that names what is not there; 3 without enough cards; 4 when a
module of JAX or of the JAX package is loaded. It never runs on the CPU.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
for _p in (os.path.dirname(HERE), HERE):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import harness  # noqa: E402

GIB = 2 ** 30


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unreadable"


def fail(code: int, msg: str) -> int:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    return code


def main(argv=None, *, root: str = harness.ROOT, device=None) -> int:
    """One run; ``device`` other than the card is for the harness's own
    tests, which drive everything but the look for a card."""
    a = parse(argv)
    try:
        sp = harness.spec(root)
        wl, cfg, traffic = harness.cell(sp, a.workload, root)
        bdir = harness.bench_dir(sp, root)
        limits = harness.data(bdir, "limits", a.workload)
        drv = harness.module("runners", traffic["runner"], bdir)
    except (harness.SpecError, OSError, KeyError) as e:
        return fail(2, f"{type(e).__name__}: {e}")

    import torch
    if device is None:
        if not torch.cuda.is_available():
            return fail(3, "no CUDA device: the benchmark runs on the card "
                           "only")
        if torch.cuda.device_count() < wl["chips"]:
            return fail(3, f"{torch.cuda.device_count()} CUDA devices, the "
                           f"cell asks for {wl['chips']}")
        device = torch.device("cuda", 0)
    device = torch.device(device)

    run = drv.Run(cfg, traffic, a.seed, device)
    # set-up: the build and the first chunk or call, which captures
    run.setup()
    # the host build's garbage is collected now, not in the window
    gc.collect()
    gc.freeze()
    harness.sync(device)
    setup_s = time.perf_counter() - T_START
    # the card's slow first phase of load, outside set-up and window
    settled = run.settle()
    ctx = {"cfg": cfg, "params": run.params, "bdir": bdir,
           "host_build_s": run.host_build_s}
    if a.trace:
        path = os.path.join(tempfile.gettempdir(),
                            f"bench_trace_{os.getpid()}.json")
        ctx.update(run.traced(path))
        e2e = {}
    else:
        e2e = run.window(a.seconds)
    on_card = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    found = harness.jax_modules()
    if found:
        return fail(4, f"modules of JAX or the JAX package loaded: {found}")

    # the reference runs once the program's state is freed and the peak
    # read: only the compared inputs and outputs stay
    run.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    readings = run.readings()
    checks = [harness.Check(k, v, limits[k]) for k, v in readings.items()]

    trace = ctx.get("trace")
    metrics, breakdown = {}, None
    if a.trace:
        for m in harness.metrics_of(sp, "per_layer", a.workload):
            v = harness.module("metrics", m["name"], bdir).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
            else:
                print(f"benchmark: per-layer metric {m['name']} found "
                      f"nothing to read", file=sys.stderr)
        if trace is not None:
            breakdown = {"device_ops": trace.top_ops(),
                         "idle_gaps": trace.top_gaps()}
    else:
        e2e.update(setup_s=setup_s, peak_mem_gib=peak / GIB)
        for m in harness.metrics_of(sp, "end_to_end", a.workload):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    found = harness.jax_modules()
    if found:
        return fail(4, f"modules of JAX or the JAX package loaded: {found}")

    line = harness.result_line(
        checks=checks, attempted=run.attempted, metrics=metrics,
        device=harness.device_info(device, wl["chips"], peak, trace),
        breakdown=breakdown)
    print(f"card: {card_line() if on_card else 'cpu'}; setup "
          f"{setup_s!r} s, host build {run.host_build_s!r} s; settle "
          f"{settled['seconds']!r} s, {settled['units']} units, step seen "
          f"at {settled['step_at']!r} s", file=sys.stderr)
    for s in harness.check_lines(checks):
        print(s, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
