"""The RANS closure's own ms a replayed step: the self time of every
``march.turbulence`` device span (the part of `rans_rhs_grid` after its
flow RHS: the cell gradients of Rt and of the shear rate, the Rt
transport faces, the Wray-Agarwal source and the viscous dt bound; less
its ``march.two_to_one`` children) over the ``march.step`` spans of the
program's traced stretch, the profiler off."""

import spans


def read(ctx):
    rec = spans.of(ctx)
    if rec is None:
        return None
    dev = rec["device"]
    closure = spans.named(dev, "march.turbulence")
    n = spans.units(rec, spans.STEP)
    if not closure or not n:
        return None
    return sum(spans.self_ns(s, dev) for s in closure) / 1e6 / n
