"""``pullback_trsm_ms_per_step``: device time of cuBLAS's triangular-solve
kernels with a matrix right-hand side (``trsm``) per batched leapfrog.  On
the whitened latent cell these are all Murray's pullback
(``ops/cholesky.py::cholesky_pullback``): its two full-width solves,
L^{-T} S and then (.) L^{-1}."""

PATTERN = r"(?i)trsm"


def read(ctx):
    seconds, count = ctx.trace.kernel_seconds(PATTERN)
    if not count or not ctx.calls:
        return None
    return 1e3 * seconds / ctx.calls
