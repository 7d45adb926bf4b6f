"""The levels' smoothing ms a FAS call: every ``fas.L<k>.body`` device
span (one smoothing iteration of level k) over the calls (the
``fas.L0.head`` spans) of the program's traced stretch, the profiler
off."""

import spans


def read(ctx):
    rec = spans.of(ctx)
    if rec is None:
        return None
    return spans.per_unit_ms(rec, spans.named(rec["device"], ".body",
                                              prefix="fas.L"), spans.CALL)
