"""Search layer, single-query calls: µs the host spends issuing work, the
union of the program's ``expann.engine.query`` spans less the time inside
its ``expann.sync`` spans (the host blocked on the device), per traced
query.  With ``sync_wait_us_per_query.single`` it accounts for the calls."""

from annbench.devtrace import union_us


def read(ctx):
    query = [iv for iv in ctx.trace.host if iv[0] == "expann.engine.query"]
    if not query or not ctx.traced_queries:
        return None
    sync = [iv for iv in ctx.trace.host if iv[0] == "expann.sync"]
    return (union_us(query + sync) - union_us(sync)) / ctx.traced_queries
