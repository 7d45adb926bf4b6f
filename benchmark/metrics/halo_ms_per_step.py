"""The halo exchange's ms a replayed step on rank 0: every
``march.halo`` device span (`ShardedBlockDomain.exchange`, from the
start of the exchange to its local grid, before each RHS and each ghost
BC) over the ``march.step`` spans of rank 0's traced stretch, the
profiler off."""

import spans


def read(ctx):
    rec = spans.of(ctx)
    if rec is None:
        return None
    return spans.per_unit_ms(rec, spans.named(rec["device"], "march.halo"),
                             spans.STEP)
