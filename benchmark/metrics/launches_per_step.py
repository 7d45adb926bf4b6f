"""Device kernels a replayed step: the kernels of the captured step's
replays (matched to their ``cudaGraphLaunch`` by correlation id) over
the replays traced."""


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or not ctx.get("steps"):
        return None
    n = len(tr.graph_launches())
    k = [e for e in tr.in_graphs() if e.get("cat") == "kernel"]
    if not n or not k:
        return None
    return len(k) / n
