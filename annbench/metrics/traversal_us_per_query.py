"""Kernel layer: device µs of the fused traversal (K1 and K1-s8, the
kernels whose function name starts with ``fused_search``, in whatever
namespace), the union of their records in the traced calls, per traced
query."""

import re

from annbench.devtrace import union_us

PATTERN = re.compile(r"(^|::)fused_search\w*\(")


def read(ctx):
    hits = [iv for iv in ctx.trace.kernels if PATTERN.search(iv[0])]
    if not hits or not ctx.traced_queries:
        return None
    return union_us(hits) / ctx.traced_queries
