"""The card's busy ms a solver call: the union of device activity over
the traced calls, whole, divided by the calls."""


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or not ctx.get("calls") or not tr.device:
        return None
    return tr.busy_us() / 1e3 / ctx["calls"]
