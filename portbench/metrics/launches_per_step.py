"""``launches_per_step``: kernels the device ran in the traced window, per
batched leapfrog (one log density and gradient over every chain)."""


def read(ctx):
    if not ctx.calls or not ctx.trace.kernels:
        return None
    return ctx.trace.kernels / ctx.calls
