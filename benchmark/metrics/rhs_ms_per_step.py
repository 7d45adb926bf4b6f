"""The RHS's own ms a replayed step: the self time of every
``march.rhs`` device span (less its ``march.two_to_one`` children) over
the ``march.step`` spans of the program's traced stretch, the profiler
off (`spans.stretch`)."""

import spans


def read(ctx):
    rec = spans.of(ctx)
    if rec is None:
        return None
    dev = rec["device"]
    rhs = spans.named(dev, "march.rhs")
    n = spans.units(rec, spans.STEP)
    if not rhs or not n:
        return None
    return sum(spans.self_ns(s, dev) for s in rhs) / 1e6 / n
