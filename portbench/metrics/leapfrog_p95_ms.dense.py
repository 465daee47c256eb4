"""``leapfrog_p95_ms.dense``: the 95th percentile of the traced window's
batched leapfrogs (CUDA events at each call into the log density, to the
window's end) on the dense cell.  Not an end-to-end metric there: a
leapfrog in which a chain's factor came back NaN runs about 1.4 % longer
(cuBLAS's triangular solves of the pullback), and such leapfrogs come in
some seeds' windows and not in others, so the percentile parts by the seed
(``PERF.md``, noise study)."""

from portbench import cell as cells


def read(ctx):
    iv = ctx.window.intervals_ms
    if len(iv) < 2:
        return None
    return cells.p95(iv)
