"""Search layer, single-query calls: replays of the captured beam per
query, the count of the program's ``expann.search.replay`` spans (one a
replay of a block of beam iterations) in the traced calls, per traced
query.  Nothing where the calls hold no ``expann.engine.query`` span (a
program without spans)."""


def read(ctx):
    host = ctx.trace.host
    if not ctx.traced_queries or not any(iv[0] == "expann.engine.query" for iv in host):
        return None
    return sum(iv[0] == "expann.search.replay" for iv in host) / ctx.traced_queries
