"""Host reads of device data a solver call: the device-to-host copies of
the traced calls (the stop rule's predicate, read before each smoothing
iteration, where the card waits for the host's turn), over the calls."""


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or not ctx.get("calls") or not tr.device:
        return None
    return len(tr.reads()) / ctx["calls"]
