"""Readings that the limits of a cell are set from, on the card.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \
        --seconds 10 [--control 3] [--out file.jsonl]

Builds the cell once, then for each seed: the seeded start, a window of
``--seconds`` (several lengths, comma-separated, are taken in turn), and
the compared numbers against the float64 reference; for the first
``--control`` seeds also the numbers of the control, the bfloat16
reference put in the program's place. One JSON line a seed, on standard
output and appended to ``--out``. The benchmark's own runs never run the
control.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
for _p in (os.path.dirname(HERE), HERE):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", default="10")
    ap.add_argument("--control", type=int, default=0)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    sp = harness.spec()
    wl, cfg, traffic = harness.cell(sp, a.workload)
    run = harness.module("runners", traffic["runner"]).Run(cfg, traffic, 0,
                                                           dev)
    t0 = time.perf_counter()
    run.setup()
    print(f"setup {time.perf_counter() - t0:.1f} s", file=sys.stderr,
          flush=True)
    lengths = [float(s) for s in a.seconds.split(",")]
    for i, seed in enumerate(int(s) for s in a.seeds.split(",")):
        run.reseed(seed)
        seconds = lengths[i % len(lengths)]
        e2e = run.window(seconds)
        t1 = time.perf_counter()
        rd = run.readings(control=i < a.control)
        line = {"workload": a.workload, "seed": seed, "seconds": seconds,
                "attempted": run.attempted, "e2e": e2e, "readings": rd,
                "reference_s": time.perf_counter() - t1}
        print(json.dumps(line), flush=True)
        if a.out:
            with open(a.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
