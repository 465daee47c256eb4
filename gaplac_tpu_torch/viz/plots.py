"""Plots (port of ``gaplac_tpu/viz/plots.py``): the sample plot with its
posterior refit, the grouped sample plot, trace plots and the predict
ribbon.

matplotlib (Agg backend) is imported inside each function, never when the
module is imported: the port runs without it except for ``--plot`` and
``fitplot``.  The refit of ``sample_plot`` runs through ``ops/mvn.py`` on
the device of the caller's ``Runtime``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from gaplac_tpu_torch.kernels.covariance import CompiledKernel
from gaplac_tpu_torch.ops import mvn


def pyplot():
    """matplotlib's pyplot on the Agg backend."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def sample_plot(ck: CompiledKernel, x: np.ndarray, y: np.ndarray, xlabel: str, ylabel: str,
                noise: float = mvn.DEFAULT_JITTER, device=None, dtype=torch.float64):
    """1-D sample plot: the samples, and over a 100-point grid spanning them
    +-1 the posterior mean with a mean +- variance band of a GP refit on
    them (observation variance ``noise``)."""
    plt = pyplot()
    X = torch.tensor(np.asarray(x, float)[:, None], dtype=dtype, device=device)
    yt = torch.tensor(np.asarray(y, float), dtype=dtype, device=device)
    params = ck.default_params(dtype, device)
    xmin, xmax = float(np.min(x)) - 1.0, float(np.max(x)) + 1.0
    xtest = np.linspace(xmin, xmax, 100)
    Xt = torch.as_tensor(xtest[:, None], dtype=dtype, device=device)
    K_tx = ck.gram(params, Xt, X)
    post = mvn.gp_posterior_cache(ck.gram(params, X), yt, noise)
    ym = mvn.gp_predict_mean(post, K_tx).cpu().numpy()
    yvar = mvn.gp_predict_var(post, K_tx, ck.gram_diag(params, Xt)).cpu().numpy()

    fig, ax = plt.subplots(figsize=(8, 5))
    ax.scatter(x, y, color="purple", label="samples", zorder=3, s=18)
    ax.plot(xtest, ym, color="dodgerblue", label="mean posterior")
    # the reference's band is mean +- variance, not +- sd
    ax.fill_between(xtest, ym - yvar, ym + yvar, color="dodgerblue", alpha=0.3,
                    label="var posterior")
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.set_title(f"Sample from posterior, x from {xmin:.2f} to {xmax:.2f}")
    ax.legend()
    fig.tight_layout()
    return fig


def grouped_sample_plot(x: np.ndarray, y: np.ndarray, groups: Optional[np.ndarray],
                        xlabel: str, ylabel: str, grouplabel: Optional[str] = None):
    """Scatter and per-group connecting lines (``--plotx "x:group"``)."""
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(8, 5))
    x, y = np.asarray(x, float), np.asarray(y, float)
    if groups is None:
        order = np.argsort(x)
        ax.scatter(x, y, color="purple", s=18, zorder=3)
        ax.plot(x[order], y[order], color="purple", lw=0.8, alpha=0.5)
    else:
        groups = np.asarray(groups)
        levels = list(dict.fromkeys(groups.tolist()))
        cmap = plt.get_cmap("tab10")
        for i, g in enumerate(levels):
            m = groups == g
            order = np.argsort(x[m])
            color = cmap(i % 10)
            ax.scatter(x[m], y[m], color=color, s=18, zorder=3, label=f"{grouplabel}={g}")
            ax.plot(x[m][order], y[m][order], color=color, lw=0.8, alpha=0.6)
        if len(levels) <= 12:
            ax.legend()
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    fig.tight_layout()
    return fig


def trace_plot(draws: np.ndarray, names: Sequence[str]):
    """Trace and histogram per hyperparameter of a (chains, draws, k) array."""
    plt = pyplot()
    draws = np.asarray(draws)
    if draws.ndim == 2:
        draws = draws[None]
    c, _, k = draws.shape
    fig, axes = plt.subplots(k, 2, figsize=(10, 2.6 * k), squeeze=False)
    for j in range(k):
        for ci in range(c):
            axes[j][0].plot(draws[ci, :, j], lw=0.7, alpha=0.8)
        axes[j][0].set_ylabel(names[j])
        axes[j][1].hist(draws[:, :, j].ravel(), bins=40, color="dodgerblue", alpha=0.8)
    axes[-1][0].set_xlabel("iteration")
    fig.tight_layout()
    return fig


def predict_plot(x, ymu, y05, y95, data_x=None, data_y=None, xlabel="x", ylabel="y"):
    """Posterior predictive ribbon."""
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(8, 5))
    order = np.argsort(np.asarray(x))
    x, ymu, y05, y95 = (np.asarray(a)[order] for a in (x, ymu, y05, y95))
    if data_x is not None:
        ax.scatter(data_x, data_y, color="purple", s=14, alpha=0.6, label="data")
    ax.plot(x, ymu, color="dodgerblue", label="posterior mean")
    ax.fill_between(x, y05, y95, color="dodgerblue", alpha=0.3, label="5-95% band")
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.legend()
    fig.tight_layout()
    return fig
