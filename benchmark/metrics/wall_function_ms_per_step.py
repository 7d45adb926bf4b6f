"""The wall function's ms a replayed step: every
``march.wall_function`` device span (the fixed point of the wall
function on the ghost rows, inside the ghost BC, one a stage) over the
``march.step`` spans of the program's traced stretch, the profiler
off."""

import spans


def read(ctx):
    rec = spans.of(ctx)
    if rec is None:
        return None
    return spans.per_unit_ms(rec, spans.named(rec["device"],
                                              "march.wall_function"),
                             spans.STEP)
