"""Pass B's share of its roofline: the least time of its launches (at
the configuration's blocks and block size, `roofline/euler_pass_b.py`)
over their device time by name. Stated against the data sheet's peaks
(`roofline/peaks.json`); the card's power limit is in the run's log."""

import harness


def read(ctx):
    tr = ctx.get("trace")
    if tr is None:
        return None
    rl = harness.module("roofline", "euler_pass_b", ctx["bdir"])
    B, bs = ctx["cfg"]["blocks"], ctx["params"]["block_size"]
    least = harness.least_seconds(*rl.work(B, bs))
    return harness.roofline_pct(tr, "euler_pass_b_kernel",
                                lambda name, i: least)
