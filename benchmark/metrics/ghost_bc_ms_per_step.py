"""The ghost BC's ms a replayed step: every ``march.ghost_bc`` device
span (`GhostBC.apply_grid` / `apply_cs`, one a stage) over the
``march.step`` spans of the program's traced stretch, the profiler
off."""

import spans


def read(ctx):
    rec = spans.of(ctx)
    if rec is None:
        return None
    return spans.per_unit_ms(rec, spans.named(rec["device"],
                                              "march.ghost_bc"),
                             spans.STEP)
