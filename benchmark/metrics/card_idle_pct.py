"""The card's idle share of a march, the profiler off: 100 x (stretch -
the union of the program's device spans) / stretch, the stretch from the
first device span's start to the last one's end (the steps and the
state's copies at the chunks' ends are all spanned)."""

import spans


def read(ctx):
    rec = spans.of(ctx)
    if rec is None or not spans.units(rec, spans.STEP):
        return None
    return spans.idle_pct(rec)
