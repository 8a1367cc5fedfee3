"""Device layer, single-query calls: the share of the traced calls' span (first
call's start to last call's end) in which no kernel or copy ran on the
device."""


def read(ctx):
    span = ctx.trace.span_us
    if span <= 0 or not ctx.trace.device:
        return None
    return 1.0 - ctx.trace.busy_us() / span
