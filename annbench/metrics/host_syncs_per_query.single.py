"""Search layer, single-query calls: host syncs per query, the count of the
program's ``expann.sync`` spans (one a blocking device read: a descent step
or a beam iteration) in the traced calls, per traced query.  Nothing where
the calls hold no ``expann.engine.query`` span (a program without spans)."""


def read(ctx):
    host = ctx.trace.host
    if not ctx.traced_queries or not any(iv[0] == "expann.engine.query" for iv in host):
        return None
    return sum(iv[0] == "expann.sync" for iv in host) / ctx.traced_queries
