"""Search layer, single-query calls: distance computations per query (the
engine's counters at full and quantized precision) over the traced calls."""


def read(ctx):
    total = sum(ctx.counters.values())
    return total / ctx.traced_queries if ctx.counters and total > 0 else None
