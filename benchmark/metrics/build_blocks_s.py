"""Seconds of the host build's march tables: the ``build.blocks`` span of
set-up (the block tables and `GhostBC`, or the gather march's partition
tables, the BCs and the initial state), and in a solver cell the
``build.levels`` span (the coarse levels of `FasEuler`)."""

import spans


def read(ctx):
    rec = spans.of(ctx)
    return None if rec is None else spans.build_s(rec, "build.blocks",
                                                  "build.levels")
