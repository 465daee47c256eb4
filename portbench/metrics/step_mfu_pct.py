"""``step_mfu_pct``: the whole batched leapfrog's share of the card's float32
peak: the operations that a log density and its gradient need over every
chain, counted from the configuration's shapes by the standard algorithms
below (whatever the program launches), over the leapfrog's mean device time
in the traced window (CUDA events at each call, to the window's end), at
67 TFLOP/s (``peaks.py``).  The card's power limit is on the run's "gpu:"
line."""

from portbench import peaks


def dense_flops(cfg: dict) -> float:
    """One chain on the dense marginal, n x n: the Cholesky factor (n^3/3),
    the inverse from it for the gradient's trace term (2 n^3 / 3), the
    solve for alpha (n^2), and the gram with its derivative, the trace
    products and the quadratic form (about 11 n^2)."""
    n = cfg["n"]
    return n**3 + 12.0 * n * n


def rff_flops(cfg: dict) -> float:
    """One chain on the feature-space marginal, Phi (n, m): the capacitance
    Phi^T Phi (a symmetric rank-n update, n m^2) and, for the gradient, the
    product of Phi with its cotangent (2 n m^2); the m x m factor and the
    inverse (m^3); the features and their derivatives, Phi^T y and its
    derivative (about 12 n m)."""
    n, m = cfg["n"], cfg["m_total"]
    return 3.0 * n * m * m + m**3 + 12.0 * n * m


FLOPS = {"none": dense_flops, "rff": rff_flops}


def read(ctx):
    flops = FLOPS.get(ctx.cell.cfg["approx"])
    iv = ctx.window.intervals_ms
    if flops is None or not iv:
        return None
    step_s = 1e-3 * sum(iv) / len(iv)
    return 100.0 * ctx.cell.traffic["chains"] * flops(ctx.cell.cfg) / (step_s * peaks.PEAK_F32_FLOPS)
