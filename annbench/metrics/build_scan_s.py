"""Build layer: seconds of the candidate scan of the base layer (the
one-shot builder's exact k-NN; the distributed builder's K2 or dense scans,
summed over its waves), as the builder records them."""


def read(ctx):
    return ctx.stages.get("scan")
