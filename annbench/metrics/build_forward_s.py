"""Build layer: seconds of the distributed builder's forward stage (K2
candidate scans, prune, forward rows), as the builder records them."""


def read(ctx):
    return ctx.stages.get("forward")
