"""Kernel layer: the flat scan's share of its roofline, in percent.  The
least time of the traced calls (``peaks.flat_bound_s`` a call, from the
shapes alone) over the union of the device records of every kernel the
calls launched, whatever kernels implement the scan."""

from annbench.devtrace import union_us
from annbench.peaks import flat_bound_s


def read(ctx):
    busy_s = union_us(ctx.trace.kernels) * 1e-6
    if busy_s <= 0 or not ctx.on_card:
        return None
    return 100.0 * ctx.traced_calls * flat_bound_s(ctx.batch, ctx.n, ctx.d, ctx.k) / busy_s
