#!/usr/bin/env python3
"""The captured sharded marches over NCCL between cards: one rank a card.

    python3 scripts/torch_nccl_capture.py            # 4 ranks, nccl, 4 cards
    python3 scripts/torch_nccl_capture.py --cpu      # 4 gloo ranks, CPU

Every rank builds the sharded marches at the sizes of `chip_smoke.py`
phase 24 and the flagship: the RAE2822 block march at wall_h=5e-4 (881,152
cells) without and with the overlap split, the sharded gather step at
wall_h=4e-2 (21,760 cells), the sphere at wall_h=0.1, bs=8 (348,160
cells) on the channel-split and the grid march, and the wing at 4096
cells (its march and its FAS cycle). For each it runs ``STEPS`` steps of
the eager loop (``graph=False``) and as many of the default march, which
on a CUDA state over an nccl mesh captures one step (halo exchange,
``all_reduce`` and ``all_gather`` included) in a CUDA graph and replays
it: the two must be bit-equal on every rank, with the same kernel
launches a step. On the card it also times both (CUDA events over
``TIMED`` steps), traces one replay with `torch.profiler` (the card's busy
ms a step, and the NCCL kernels in the replay: the exchange is in the
graph) and prints the card's name and power limit. Rank 0 prints one JSON
row a march; the script exits non-zero if any rank's march differs.

``--cpu`` rehearses the same code on four gloo ranks on the CPU, where
the default march is the eager loop (no graph exists there), with the
block march at wall_h=4e-2 in the flagship's place.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

STEPS = 5
TIMED = 20
FLAGSHIP = dict(wall_h=5e-4, feature_h=2.5e-4, cfl=0.7, block_size=16)
SMALL = dict(wall_h=4e-2, feature_h=2e-2, cfl=0.7)
SPHERE = dict(wall_h=0.1, block_size=8)
WING = dict(wall_h=0.25, span=0.5, farfield=2.0, block_size=8,
            n_coarse_iter=4)


def _trace(fn):
    """(busy ms, NCCL kernels) of one call of ``fn`` under the profiler."""
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in ev) / 1e3
    return busy, sum("nccl" in e.name.lower() for e in ev)


def _ms(march, X, n, graph):
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    march(X, n, graph=graph)
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / n


def _row(tag, march, X, steps=STEPS, timed=TIMED):
    """Eager against default (captured on the card) over ``steps``."""
    from ibx_torch.ops import kernels as K

    print(f"{time.strftime('%H:%M:%S')} {tag}", file=sys.stderr, flush=True)

    on_card = X.device.type == "cuda"
    K.reset_launches()
    eager = march(X, steps, graph=False)
    n_eager = {k: v / steps for k, v in K.launches.items()}
    K.reset_launches()
    t0 = time.perf_counter()
    march(X, 1, graph=None)               # captures on the card
    capture_s = time.perf_counter() - t0
    K.reset_launches()
    out = march(X, steps, graph=None)
    n_graph = {k: v / steps for k, v in K.launches.items()}
    row = dict(march=tag, steps=steps, bit_equal=bool(torch.equal(eager,
                                                                  out)),
               launches_eager=n_eager, launches_graph=n_graph,
               capture_s=capture_s)
    if on_card:
        row.update(
            ms_eager=_ms(march, X, timed, False),
            ms_graph=_ms(march, X, timed, None))
        row["busy_ms_eager"], row["nccl_kernels_eager"] = _trace(
            lambda: march(X, 1, graph=False))
        row["busy_ms_graph"], row["nccl_kernels_graph"] = _trace(
            lambda: march(X, 1, graph=None))
    return row


def _calls(call):
    def march(X, n, graph):
        for _ in range(n):
            X = call(X, graph=graph)[0]
        return X
    return march


def rank_main(device, out_dir, flagship):
    import torch.distributed as dist

    from ibx_torch.cases import (build_rae2822, build_rae2822_block_sharded,
                                 build_rae2822_sharded, build_sphere3d,
                                 build_sphere3d_block_sharded,
                                 build_wing3d_rans_fas)

    warnings.filterwarnings("ignore", category=UserWarning)
    P, rank = dist.get_world_size(), dist.get_rank()
    if device == "cuda":                   # one card a rank
        torch.cuda.set_device(rank)
        device = torch.device("cuda", rank)
    rows = []
    flag = build_rae2822(device=device, **flagship)
    cells = f"{flag.dom.ncells:,} cells"
    for overlap in (False, True):
        sbd, _, X, _ = build_rae2822_block_sharded(
            P, case=flag, cfl=flag.cfl, overlap=overlap)
        assert sbd.overlap == overlap and sbd.offs
        X = sbd.march(X, 2, graph=False)
        rows.append(_row(f"RAE2822 block{', overlap' if overlap else ''}"
                         f" ({cells}, offsets {sbd.offs})", sbd.march, X))
    del flag, sbd
    _, step, X, _ = build_rae2822_sharded(P, device=device, **SMALL)
    rows.append(_row("gather step (21,760 cells)", _calls(step), X))
    sph = build_sphere3d(device=device, **SPHERE)
    for use_cs in (True, False):
        sbd, _, X, _ = build_sphere3d_block_sharded(P, case=sph, cfl=0.7,
                                                    use_cs=use_cs)
        rows.append(_row(f"sphere {'channel-split' if use_cs else 'grid'}"
                         f" (348,160 cells)", sbd.march, X))
    del sph, sbd
    wc = build_wing3d_rans_fas(P, device=device, **WING)
    rows.append(_row("wing march (4096 cells)", wc.march, wc.S0_sh))
    rows.append(_row("wing FAS cycle (4096 cells)", _calls(wc.fas_cycle),
                     wc.S0_sh, steps=2, timed=2))
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(rows))
    # each rank's rows also on the output: they survive a hang at teardown
    print(f"rank {rank}: " + json.dumps(rows), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    from ibx_torch.ops import kernels as K
    from ibx_torch.parallel import spawn

    if args.cpu:
        device, backend, card, flagship = "cpu", "gloo", "cpu", SMALL
    else:
        if torch.cuda.device_count() < args.ranks:
            print(f"needs {args.ranks} cards, has "
                  f"{torch.cuda.device_count()}", file=sys.stderr)
            return 2
        device, backend, flagship = "cuda", "nccl", FLAGSHIP
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()
        K.build()                          # once, before the ranks load it
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out:
        spawn(rank_main, args.ranks, backend=backend, device=device,
              args=(device, out, flagship))
        ranks = [json.loads(Path(out, f"rank{p}.json").read_text())
                 for p in range(args.ranks)]
    ok = True
    for i, row in enumerate(ranks[0]):
        per_rank = [r[i] for r in ranks]
        row["bit_equal_all_ranks"] = all(r["bit_equal"] for r in per_rank)
        row["launches_equal_all_ranks"] = all(
            r["launches_eager"] == r["launches_graph"] for r in per_rank)
        if "ms_graph" in row:
            row["ms_graph_ranks"] = [r["ms_graph"] for r in per_rank]
            row["busy_ms_graph_ranks"] = [r["busy_ms_graph"]
                                          for r in per_rank]
        ok &= row["bit_equal_all_ranks"] and row["launches_equal_all_ranks"]
        print(json.dumps(row), flush=True)
    print(f"{args.ranks} {backend} ranks, {time.perf_counter() - t0:.1f} s; "
          f"card: {card}; all bit-equal and launches equal: {ok}",
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
