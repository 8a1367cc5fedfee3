"""Engine layer: µs the host spends on each call's queries before the
upload (``np.asarray``, ``pad_dim``, the bf16 / i8 wire cast): the union of
the program's ``expann.engine.cast`` spans in the traced calls, per traced
query."""

from annbench.devtrace import union_us


def read(ctx):
    spans = [iv for iv in ctx.trace.host if iv[0] == "expann.engine.cast"]
    if not spans or not ctx.traced_queries:
        return None
    return union_us(spans) / ctx.traced_queries
