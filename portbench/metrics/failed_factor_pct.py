"""``failed_factor_pct``: share of the window's chain-leapfrogs whose log
density came back non-finite (a failed factorization, or a position that
left the support), counted from the values the sampler was handed."""


def read(ctx):
    if not ctx.attempted:
        return None
    return 100.0 * ctx.failed / ctx.attempted
