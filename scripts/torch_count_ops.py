#!/usr/bin/env python3
"""Count the torch ops one RK2 step of the port dispatches, on the CPU.

    python3 scripts/torch_count_ops.py

Builds RAE2822 at wall_h=8e-2 (16,768 cells), the bs=4 sphere (18,432
cells), the RANS airfoil at wall_h=8e-2, block_size=8 (16,768 cells) and
the flat plate at wall_h=2e-2 (9,216 cells) with ``device="cpu"`` and runs
one `case.step` of the generic gather march (``use_blocks=False``) and of
the block march under a `TorchDispatchMode`: every dispatched op, those that are views (no device
launch), and the rest. The op count does not depend on the mesh size, so it
is the host's work a step at any size. It also counts the row gathers
(`ibx_torch.ops.stencil.take_rows`) whose rows are a multiple of 16 bytes
wide: on a CUDA tensor each of those dispatches 7 more ops (the flat index
arithmetic: 3 launches and 4 views) than the `index_select` counted here.

It then counts one step of the sharded marches on a one-rank gloo group
in this process (`build_rae2822_block_sharded(1)` at wall_h=8e-2, and
`build_sphere3d_block_sharded(1)` on the bs=4 sphere), beside the
single-device step of the same case: the one-rank runtime's ops over the
single-device march.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

VIEWS = ("view", "reshape", "select.int", "slice", "unsqueeze", "expand",
         "alias", "squeeze", "t.default", "permute", "detach")


class Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = self.views = self.wide_gathers = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        name = str(func)
        if any(v in name for v in VIEWS):
            self.views += 1
        if "index_select" in name and args[0].dim() > 1 and \
                (args[0][0].numel() * args[0].element_size()) % 16 == 0:
            self.wide_gathers += 1
        return func(*args, **(kwargs or {}))


def main() -> int:
    from ibx_torch.cases import (build_flat_plate, build_rae2822,
                                 build_rae2822_rans, build_sphere3d)

    torch.set_num_threads(2)
    small = dict(wall_h=8e-2, feature_h=4e-2, cfl=0.7, device="cpu")
    sphere = dict(wall_h=0.25, block_size=4, device="cpu")
    cases = {
        "RAE2822 gather march (use_blocks=False)":
            (build_rae2822(use_blocks=False, **small), {}),
        "RAE2822 block march": (build_rae2822(**small), {}),
        "sphere gather march (use_blocks=False)":
            (build_sphere3d(use_blocks=False, **sphere), {}),
        "sphere channel-split march": (build_sphere3d(**sphere), {}),
        "sphere grid march": (build_sphere3d(**sphere), dict(grid=True)),
    }
    rans = dict(wall_h=8e-2, feature_h=4e-2, block_size=8, device="cpu")
    plate = dict(wall_h=2e-2, reynolds=6e5, device="cpu")
    for ub in (False, True):
        march = "gather march (use_blocks=False)" if not ub else "block march"
        cases[f"RANS RAE2822 {march}"] = (
            build_rae2822_rans(use_blocks=ub, **rans), None)
        cases[f"RANS flat plate {march}"] = (
            build_flat_plate(use_blocks=ub, **plate), None)
    for label, (case, kw) in cases.items():
        with Count() as c:
            if kw is None:
                case.step(case.P0, case.Rt0)
            else:
                case.step(case.P0, **kw)
        print(f"{label}: {c.n} dispatched ops a step, {c.views} views, "
              f"{c.n - c.views} launches; {c.wide_gathers} row gathers of "
              f"rows a multiple of 16 bytes wide")
    sharded_counts(cases["RAE2822 block march"][0],
                   cases["sphere channel-split march"][0])
    return 0


def sharded_counts(rae, sphere) -> None:
    """One step of each sharded block march on a one-rank gloo group."""
    from ibx_torch.cases import (build_rae2822_block_sharded,
                                 build_sphere3d_block_sharded)
    from ibx_torch.parallel import one_rank_group

    with one_rank_group("gloo"):
        for label, build, case in (
                ("RAE2822 block march", build_rae2822_block_sharded, rae),
                ("sphere channel-split march",
                 build_sphere3d_block_sharded, sphere)):
            _, step, P, _ = build(1, case=case)
            with Count() as c:
                step(P)
            print(f"{label}, sharded on one rank: {c.n} dispatched ops "
                  f"a step, {c.views} views, {c.n - c.views} launches")

if __name__ == "__main__":
    sys.exit(main())
