"""Seconds of the host build's mesh: the ``build.mesh`` spans of set-up
(the octree, its distance fields and the inside test)."""

import spans


def read(ctx):
    rec = spans.of(ctx)
    return None if rec is None else spans.build_s(rec, "build.mesh")
