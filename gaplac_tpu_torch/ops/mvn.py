"""MVN core: Cholesky-backed logpdf, sampling and the GP posterior (port of
``gaplac_tpu/ops/mvn.py``; logpdf and sampling are batched over leading
axes, the posterior helpers take one (n, n) system as there).

The observation variance ("jitter") 0.1 is the reference's default.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from gaplac_tpu_torch.ops import linalg

DEFAULT_JITTER = 0.1


def add_jitter(K: torch.Tensor, jitter) -> torch.Tensor:
    n = K.shape[-1]
    return K + jitter * torch.eye(n, dtype=K.dtype, device=K.device)


def chol(K: torch.Tensor, jitter=0.0) -> torch.Tensor:
    """Lower Cholesky factor of K (+ jitter I)."""
    if not (isinstance(jitter, (int, float)) and jitter == 0.0):
        K = add_jitter(K, jitter)
    return linalg.cholesky(K)


def mvn_logpdf_chol(L: torch.Tensor, y: torch.Tensor, mean=0.0) -> torch.Tensor:
    """log N(y; mean, L L^T) for L (..., n, n) and y (..., n); natural log."""
    n = y.shape[-1]
    alpha = linalg.solve_triangular(L, y - mean, lower=True)
    quad = torch.sum(alpha * alpha, dim=-1)
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)
    return -0.5 * (quad + logdet + n * math.log(2.0 * math.pi))


def mvn_logpdf(K: torch.Tensor, y: torch.Tensor, mean=0.0, jitter: float = 0.0) -> torch.Tensor:
    return mvn_logpdf_chol(chol(K, jitter), y, mean)


def sample_mvn_chol(gen: torch.Generator, L: torch.Tensor, mean=0.0) -> torch.Tensor:
    """One draw per matrix from N(mean, L L^T): f = mean + L z."""
    z = torch.randn(L.shape[:-1], generator=gen, dtype=L.dtype, device=L.device)
    return mean + (L @ z.unsqueeze(-1)).squeeze(-1)


def sample_mvn(gen: torch.Generator, K: torch.Tensor, mean=0.0, jitter: float = 0.0) -> torch.Tensor:
    return sample_mvn_chol(gen, chol(K, jitter), mean)


class GPPosterior(NamedTuple):
    """Cached solves for GP regression on train (X, y) with observation
    variance ``noise``: predicts the mean and covariance at test points."""

    L: torch.Tensor      # chol(K_xx + noise I)
    alpha: torch.Tensor  # (K_xx + noise I)^{-1} (y - mean)


def gp_posterior_cache(K_xx: torch.Tensor, y: torch.Tensor, noise, mean=0.0) -> GPPosterior:
    L = chol(K_xx) if noise is None else chol(add_jitter(K_xx, noise))
    a = linalg.solve_triangular(L, y - mean, lower=True)
    alpha = linalg.solve_triangular(L.mT, a, lower=False)
    return GPPosterior(L, alpha)


def gp_predict_mean(post: GPPosterior, K_tx: torch.Tensor, prior_mean=0.0) -> torch.Tensor:
    """Posterior mean at the test points: m_t + K_tx alpha."""
    return prior_mean + K_tx @ post.alpha


def gp_predict_var(post: GPPosterior, K_tx: torch.Tensor, K_tt_diag: torch.Tensor) -> torch.Tensor:
    """Posterior marginal variance (diagonal only): k_tt - ||L^{-1} K_xt||^2."""
    V = linalg.solve_triangular(post.L, K_tx.mT, lower=True)
    return K_tt_diag - torch.sum(V * V, dim=-2)


def gp_predict_cov(post: GPPosterior, K_tx: torch.Tensor, K_tt: torch.Tensor) -> torch.Tensor:
    V = linalg.solve_triangular(post.L, K_tx.mT, lower=True)
    return K_tt - V.mT @ V
