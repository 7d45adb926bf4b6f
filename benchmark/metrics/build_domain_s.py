"""Seconds of the host build's `Domain`: the ``build.domain`` span of
set-up (its stages, cells to device_put, are its children)."""

import spans


def read(ctx):
    rec = spans.of(ctx)
    return None if rec is None else spans.build_s(rec, "build.domain")
