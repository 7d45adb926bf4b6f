"""Pass A's share of its roofline: the least time of its launches (each
by its dt-bound template argument, at the configuration's blocks and
block size, `roofline/euler_pass_a.py`) over their device time by name.
Stated against the data sheet's peaks (`roofline/peaks.json`); the
card's power limit is in the run's log."""

import re

import harness


def read(ctx):
    tr = ctx.get("trace")
    if tr is None:
        return None
    rl = harness.module("roofline", "euler_pass_a", ctx["bdir"])
    B, bs = ctx["cfg"]["blocks"], ctx["params"]["block_size"]

    def bound(name, i):
        dt = re.search(r"euler_pass_a_kernel<\d+, *(true|false)>", name)
        return harness.least_seconds(*rl.work(
            B, bs, with_dt=dt is None or dt.group(1) == "true"))

    return harness.roofline_pct(tr, "euler_pass_a_kernel", bound)
