"""The card's idle ms a FAS call at the stop rule's host reads: the idle
gaps between the program's device spans that share time with a
``fas.stop_read`` host span (the host reading the predicate before a
smoothing iteration), over the calls, the profiler off."""

import spans


def read(ctx):
    rec = spans.of(ctx)
    if rec is None:
        return None
    n = spans.units(rec, spans.CALL)
    reads = spans.named(rec["host"], "fas.stop_read")
    if not n or not reads:
        return None
    gaps = spans.overlapping(spans.idle_gaps(rec), reads)
    return sum(b - a for a, b in gaps) / 1e6 / n
