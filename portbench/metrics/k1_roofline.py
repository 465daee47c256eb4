"""``k1_roofline``: kernel K1's (``csrc/chol_batched.cu``) share of its
roofline: the least time the card could take for the factorizations the
model needs, over K1's device time in the traced window.

Each batched leapfrog factors one (C, N, N) batch: the gram on the dense
path (N = n), the capacitance matrices on the rff path (N = m_total).  One
factorization needs N^3 / 3 operations, and reads its input once and writes
its factor once: 2 N^2 words.  Bound: the larger of the operations over the
float32 peak and the bytes over the memory rate (``peaks.py``)."""

from portbench import peaks

#: K1's kernel, as the device names it
PATTERN = r"chol_batched"

#: bytes a word, by the configuration's precision
WORD = {"float32": 4, "float64": 8}


def factored_n(cfg: dict) -> int:
    return cfg["m_total"] if cfg["approx"] == "rff" else cfg["n"]


def bound_s(cfg: dict, chains: int) -> float:
    """Least seconds for one leapfrog's factorizations."""
    N = factored_n(cfg)
    return peaks.bound_s(chains * N**3 / 3.0, chains * 2.0 * N * N * WORD[cfg["precision"]])


def read(ctx):
    seconds, count = ctx.trace.kernel_seconds(PATTERN)
    if not count or not ctx.calls:
        return None
    return 100.0 * ctx.calls * bound_s(ctx.cell.cfg, ctx.cell.traffic["chains"]) / seconds
