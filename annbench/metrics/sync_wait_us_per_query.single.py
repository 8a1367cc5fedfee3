"""Search layer, single-query calls: µs the host blocks on the device, the
union of the program's ``expann.sync`` spans in the traced calls, per
traced query.  Nothing where the calls hold no ``expann.engine.query``
span (a program without spans)."""

from annbench.devtrace import union_us


def read(ctx):
    host = ctx.trace.host
    if not ctx.traced_queries or not any(iv[0] == "expann.engine.query" for iv in host):
        return None
    return union_us([iv for iv in host if iv[0] == "expann.sync"]) / ctx.traced_queries
