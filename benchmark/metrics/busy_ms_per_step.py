"""The card's busy ms a replayed step: the device time of every kernel
and copy of the captured step's replays (matched to their
``cudaGraphLaunch`` by correlation id) over the replays traced."""


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or not ctx.get("steps"):
        return None
    n = len(tr.graph_launches())
    ev = tr.in_graphs()
    if not n or not ev:
        return None
    return sum(float(e["dur"]) for e in ev) / 1e3 / n
