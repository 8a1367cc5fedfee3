"""Kernel layer: the rows traversal's (K1-rows') share of its roofline, in
percent.  Its least time is the bytes of the rows it gathered at HBM's
rate: each row once, its ``d`` elements in bf16 with its 4-byte id and
4-byte norm (``row_bytes``), ``rows_gathered / queries`` rows a query from
the engine's counters (both counted over the same calls, so a call counted
and not traced cancels), against the device µs a query of the union of the
``fused_search_rows*`` kernel records.  ``d`` is the configuration's width,
not the padded one.  Nothing where the engine counts no queries or the
trace holds no such kernel."""

import re

from annbench.devtrace import union_us
from annbench.peaks import HBM_BYTES_S

PATTERN = re.compile(r"(^|::)fused_search_rows\w*\(")


def row_bytes(d: int) -> int:
    """Bytes of one gathered row: d bf16 elements, its int32 id, its f32 norm."""
    return 2 * d + 8


def read(ctx):
    queries = ctx.counters.get("queries", 0)
    hits = [iv for iv in ctx.trace.kernels if PATTERN.search(iv[0])]
    if not queries or not hits or not ctx.traced_queries or not ctx.on_card:
        return None
    us_per_query = union_us(hits) / ctx.traced_queries
    bound_us = ctx.counters.get("rows_gathered", 0) / queries * row_bytes(ctx.d) / HBM_BYTES_S * 1e6
    return 100.0 * bound_us / us_per_query if us_per_query > 0 else None
