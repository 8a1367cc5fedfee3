"""Build layer: seconds of the anti-topo prune of the base layer's
candidates (the one-shot builder's batched prune; the distributed builder's
per-wave prune, summed), as the builder records them."""


def read(ctx):
    return ctx.stages.get("prune")
