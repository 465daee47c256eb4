"""Chain diagnostics: split-R̂ and bulk ESS (port of
``gaplac_tpu/inference/diagnostics.py``).  They run on the host, over
(chains, draws) arrays (numpy, or tensors that numpy can read)."""

from __future__ import annotations

import numpy as np


def split_chains(x) -> np.ndarray:
    """(chains, draws) -> (2*chains, draws//2)."""
    x = np.asarray(x)
    n = x.shape[1] // 2
    return np.concatenate([x[:, :n], x[:, n:2 * n]], axis=0)


def rhat(x) -> float:
    """Split-R̂ (Gelman-Rubin) for (chains, draws) scalar chains."""
    x = split_chains(x)
    m, n = x.shape
    w = np.mean(np.var(x, axis=1, ddof=1))
    b = n * np.var(np.mean(x, axis=1), ddof=1)
    var_plus = (n - 1) / n * w + b / n
    return float(np.sqrt(var_plus / w))


def ess(x) -> float:
    """Bulk ESS via Geyer's initial monotone sequence over the pooled
    autocorrelation (Stan's formulation)."""
    x = split_chains(x)
    m, n = x.shape
    xc = x - x.mean(axis=1, keepdims=True)
    fsize = int(2 ** np.ceil(np.log2(2 * n)))
    f = np.fft.rfft(xc, fsize, axis=1)
    acov = np.fft.irfft(f * np.conj(f), fsize, axis=1)[:, :n].real / n
    chain_var = acov[:, 0] * n / (n - 1)
    w = chain_var.mean()
    var_plus = acov[:, 0].mean()
    if m > 1:
        var_plus += x.mean(axis=1).var(ddof=1)
    rho = 1.0 - (w - acov.mean(axis=0)) / var_plus
    even, odd = rho[0::2], rho[1::2]
    k = min(len(even), len(odd))
    pair = even[:k] + odd[:k]
    pos = pair > 0
    first_neg = np.argmax(~pos) if (~pos).any() else k
    pair = pair[:first_neg]
    pair = np.minimum.accumulate(pair) if len(pair) else pair
    tau = -1.0 + 2.0 * pair.sum()
    tau = max(tau, 1.0 / np.log10(n * m + 10.0))
    return float(m * n / tau)


def summarize(name: str, x) -> dict:
    """Per-parameter summary over (chains, draws)."""
    arr = np.asarray(x)
    return {
        "param": name,
        "mean": float(arr.mean()),
        "std": float(arr.std()),
        "q5": float(np.quantile(arr, 0.05)),
        "q95": float(np.quantile(arr, 0.95)),
        "rhat": rhat(arr) if arr.shape[0] > 1 and arr.shape[1] > 3 else float("nan"),
        "ess": ess(arr) if arr.shape[1] > 3 else float("nan"),
    }
