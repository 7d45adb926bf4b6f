"""The card's idle share of the FAS calls, the profiler off: 100 x
(stretch - the union of the program's device spans, each level's pieces)
/ stretch, the stretch from the first device span's start to the last
one's end."""

import spans


def read(ctx):
    rec = spans.of(ctx)
    if rec is None or not spans.units(rec, spans.CALL):
        return None
    return spans.idle_pct(rec)
