"""The stage assembly's ms a replayed step: every ``march.update`` device
span (the state update of each RK stage: to conservative, the add, back
to guarded primitives, or `rk2_update`) over the ``march.step`` spans of
the program's traced stretch, the profiler off."""

import spans


def read(ctx):
    rec = spans.of(ctx)
    if rec is None:
        return None
    return spans.per_unit_ms(rec, spans.named(rec["device"],
                                              "march.update"),
                             spans.STEP)
