"""Build layer: seconds of the distributed builder's reverse stage, as the
builder records them."""


def read(ctx):
    return ctx.stages.get("reverse")
