"""The fused RK2 stage's share of its roofline: the least time of its
launches (stage 1 and stage 2 in turn, a pair a step,
`roofline/rk2_update.py`) over their device time by name. Stated
against the data sheet's peaks (`roofline/peaks.json`); the card's power
limit is in the run's log."""

import harness


def read(ctx):
    tr = ctx.get("trace")
    if tr is None:
        return None
    rl = harness.module("roofline", "rk2_update", ctx["bdir"])
    n = ctx["cfg"]["cells"]
    least = [harness.least_seconds(*rl.work(n, s)) for s in (1, 2)]
    return harness.roofline_pct(tr, "rk2_update_kernel",
                                lambda name, i: least[i % 2])
