"""The levels' transfers ms a FAS call: every ``fas.L<k>.head`` (the
level's residual, the source, the restriction to the coarser level) and
``fas.L<k>.tail`` (the prolonged correction) device span over the calls
of the program's traced stretch, the profiler off."""

import spans


def read(ctx):
    rec = spans.of(ctx)
    if rec is None:
        return None
    return spans.per_unit_ms(rec, spans.named(rec["device"], ".head",
                                              ".tail", prefix="fas.L"),
                             spans.CALL)
