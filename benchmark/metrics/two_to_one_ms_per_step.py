"""The 2:1 interface corrections' ms a replayed step: every
``march.two_to_one`` device span (the corrections of both passes, inside
the RHS) over the ``march.step`` spans of the program's traced stretch,
the profiler off."""

import spans


def read(ctx):
    rec = spans.of(ctx)
    if rec is None:
        return None
    return spans.per_unit_ms(rec, spans.named(rec["device"],
                                              "march.two_to_one"),
                             spans.STEP)
