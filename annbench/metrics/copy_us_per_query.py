"""Engine layer: device µs of the host-to-device and device-to-host copies
in the traced calls (union of their records), per traced query."""

from annbench.devtrace import union_us


def read(ctx):
    copies = [iv for iv in ctx.trace.copies if "HtoD" in iv[0] or "DtoH" in iv[0]]
    if not copies or not ctx.traced_queries:
        return None
    return union_us(copies) / ctx.traced_queries
