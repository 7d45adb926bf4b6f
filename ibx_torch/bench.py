"""Benchmark of the port: the Euler pseudo-time march's throughput on one
card (the counterpart of the repo's ``bench.py``).

    python -m ibx_torch.bench

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}, with
``bench.py``'s keys, metric name and unit fields. ``vs_baseline`` keeps
``bench.py``'s definition: the value over 125e6 cell-updates/s/chip (the
north-star pod target of BASELINE.json over its 8 chips).

It reads ``bench.py``'s environment and no other:
  IBX_BENCH_CASE=rae2822 (default) or sphere3d;
  IBX_BENCH_STEPS (300), IBX_BENCH_WALL_H (5e-4 for the airfoil, 0.03 for
  the sphere; the airfoil's feature_h is wall_h / 2), IBX_BENCH_BLOCK_SIZE
  (16), all at cfl 0.5;
  IBX_BENCH_SHARDED=1 marches the case through the sharded block runtime
  on one rank (an ``nccl`` group of this process) instead;
  IBX_BENCH_3D=0 skips the 3D leg of the default run.
The default run (the airfoil, not sharded) also marches the same case
through the one-rank sharded runtime with ``overlap=True`` (the unit's
``sharded_1dev``) and the 5,308,416-cell sphere (``sphere3d``).

Each leg runs a warm-up of ``march(P, 2)``, which captures the step in a
CUDA graph (`utils.graphs`), then ``steps`` steps timed with CUDA events
after a synchronize; the unit adds the card's busy ms a step, from
`torch.profiler` over 5 steps after the timed window, and the card's name
and power limit as nvidia-smi gives them. A non-finite state prints
``bench.py``'s error line and exits 1. Without a card it prints an error
line and exits 2: it never runs on the CPU by itself (``main(device=
"cpu")`` does, for the tests).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback
from typing import Callable, Optional, Tuple

import torch

BASELINE_CUPS = 125e6
WARMUP_STEPS = 2
BUSY_STEPS = 5
SPHERE3D = dict(wall_h=0.03, cfl=0.5, block_size=16)


def card_line(device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` prints them (its first line);
    ``cpu`` on the CPU."""
    if torch.device(device).type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def busy_ms(fn: Callable[[], object], n_steps: int, device) -> Optional[float]:
    """The card's busy ms a step: the device time of every kernel and copy
    that ``fn`` (``n_steps`` steps) launches under `torch.profiler`; None
    on the CPU."""
    if torch.device(device).type != "cuda":
        return None
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    if not ev:
        raise RuntimeError("torch.profiler recorded no device time")
    return sum(e.time_range.elapsed_us() for e in ev) / 1e3 / n_steps


def timed_march(march: Callable, P, steps: int, device
                ) -> Tuple[float, object, Optional[float]]:
    """``march(P, 2)`` (the warm-up, which captures the step), then
    ``steps`` steps timed (CUDA events on the card, the host clock on the
    CPU), then the busy ms a step over `BUSY_STEPS` more: (seconds of the
    timed steps, the state after them, busy ms a step or None)."""
    P = march(P, WARMUP_STEPS)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        P = march(P, steps)
        e1.record()
        e1.synchronize()
        elapsed = e0.elapsed_time(e1) / 1e3
    else:
        t0 = time.perf_counter()
        P = march(P, steps)
        elapsed = time.perf_counter() - t0
    busy = busy_ms(lambda: march(P, BUSY_STEPS), BUSY_STEPS, device)
    return elapsed, P, busy


def _finite(P) -> bool:
    if isinstance(P, (tuple, list)):
        return all(_finite(p) for p in P)
    return bool(torch.isfinite(torch.as_tensor(P)).all())


def _busy(b: Optional[float]) -> str:
    return "not measured" if b is None else f"{b:.3f}ms/step"


def build_case(which: str, wall_h: float, block_size: int, device):
    """The bench's case: the airfoil at ``wall_h`` (feature_h = wall_h / 2)
    or the sphere, at cfl 0.5."""
    if which == "sphere3d":
        from .cases import build_sphere3d
        return build_sphere3d(wall_h=wall_h, cfl=0.5, block_size=block_size,
                              device=device)
    from .cases import build_rae2822
    return build_rae2822(wall_h=wall_h, feature_h=wall_h / 2, cfl=0.5,
                         block_size=block_size, device=device)


def sharded_march(which: str, case, overlap: bool = False):
    """``(sbd, P0_sh)`` of ``case`` on the sharded block runtime of one
    rank; inside a process group of one rank (`parallel.one_rank_group`)."""
    if which == "sphere3d":
        from .cases import build_sphere3d_block_sharded
        sbd, _, P0_sh, _ = build_sphere3d_block_sharded(1, cfl=0.5,
                                                        case=case)
    else:
        from .cases import build_rae2822_block_sharded
        sbd, _, P0_sh, _ = build_rae2822_block_sharded(
            1, cfl=0.5, case=case, overlap=overlap)
    return sbd, P0_sh


def sharded_leg(case, steps: int, elapsed: float, device) -> str:
    """The unit's ``sharded_1dev`` field: the airfoil ``case`` through the
    one-rank sharded runtime with ``overlap=True`` (inside a one-rank
    group), against the single-device march's ``elapsed`` seconds."""
    n = case.dom.ncells
    sbd, P0_sh = sharded_march("rae2822", case, overlap=True)
    sh_el, Ps, busy = timed_march(sbd.march, P0_sh, steps, device)
    if not _finite(Ps):
        raise FloatingPointError("non-finite sharded state")
    return (f", sharded_1dev={n * steps / sh_el / 1e6:.1f}M"
            f" ({(sh_el / elapsed - 1) * 100:+.1f}%, busy={_busy(busy)})")


def sphere_leg(steps: int, device, case=None) -> str:
    """The unit's ``sphere3d`` field: the 5,308,416-cell sphere (``case``
    if given: a prebuilt `build_sphere3d(**SPHERE3D)`), its default
    (channel-split) march."""
    if case is None:
        from .cases import build_sphere3d
        t0 = time.time()
        case = build_sphere3d(device=device, **SPHERE3D)
        b3 = time.time() - t0
    else:
        b3 = case.build_seconds
    el3, P3, busy = timed_march(case.march, case.P0, steps, device)
    if not _finite(P3):
        raise FloatingPointError("non-finite 3D state")
    return (f", sphere3d={case.dom.ncells * steps / el3 / 1e6:.1f}M"
            f" (cells={case.dom.ncells}, bs={SPHERE3D['block_size']}, "
            f"build={b3:.0f}s, busy={_busy(busy)})")


def _leg(fn: Callable[[], str], name: str) -> str:
    """A leg of the default run; its failure is reported in its field as
    ``bench.py`` reports it (``name=err:<type>``), with the traceback on
    standard error."""
    try:
        return fn()
    except Exception as e:
        traceback.print_exc()
        return f", {name}=err:{type(e).__name__}"


def run(device="cuda", sphere=None, env=None) -> dict:
    """Every leg that ``bench.py``'s environment (``env``, by default this
    process's) asks for, on ``device``; the JSON line as a dict
    (``bench.py``'s error line on a non-finite state). ``sphere``: a
    prebuilt `build_sphere3d(**SPHERE3D)` for the 3D leg."""
    from .parallel import one_rank_group

    env = os.environ if env is None else env
    which = env.get("IBX_BENCH_CASE", "rae2822")
    steps = int(env.get("IBX_BENCH_STEPS", "300"))
    default_h = "0.03" if which == "sphere3d" else "5e-4"
    wall_h = float(env.get("IBX_BENCH_WALL_H", default_h))
    block_size = int(env.get("IBX_BENCH_BLOCK_SIZE", "16"))
    sharded = env.get("IBX_BENCH_SHARDED", "0") != "0"
    with_3d = env.get("IBX_BENCH_3D", "1") != "0"
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"

    with one_rank_group(backend):
        t0 = time.time()
        case = build_case(which, wall_h, block_size, device)
        tag = ""
        if sharded:
            sbd, P = sharded_march(which, case)
            march = sbd.march
            tag = ", sharded=1-device-mesh"
        else:
            march, P = case.march, case.P0
        build_s = time.time() - t0
        n = case.dom.ncells

        elapsed, P, busy = timed_march(march, P, steps, device)
        if not _finite(P):
            return {"metric": "error", "value": 0,
                    "unit": "non-finite state", "vs_baseline": 0}
        cups = n * steps / elapsed

        if which == "rae2822" and not sharded:
            tag += _leg(lambda: sharded_leg(case, steps, elapsed, device),
                        "sharded_1dev")
            if with_3d:
                tag += _leg(lambda: sphere_leg(steps, device, sphere),
                            "sphere3d")
    return {
        "metric": f"{which}_euler_cell_updates_per_sec_per_chip",
        "value": cups,
        "unit": (f"cell-updates/s/chip (cells={n}, steps={steps}, "
                 f"march={elapsed:.3f}s, build={build_s:.1f}s{tag}, "
                 f"busy={_busy(busy)}, card={card_line(device)})"),
        "vs_baseline": cups / BASELINE_CUPS,
    }


def main(device="cuda") -> int:
    """Run the bench on ``device`` and print its JSON line; the exit
    code: 0, 1 on a non-finite state, 2 without a card."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        print(json.dumps({"metric": "error", "value": 0,
                          "unit": "no CUDA device", "vs_baseline": 0}))
        return 2
    line = run(device)
    print(json.dumps(line), flush=True)
    return 1 if line["metric"] == "error" else 0


if __name__ == "__main__":
    sys.exit(main())
