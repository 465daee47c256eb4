"""MVN core: Cholesky-backed logpdf and sampling (port of
``gaplac_tpu/ops/mvn.py``, batched over leading axes).

The observation variance ("jitter") 0.1 is the reference's default.
"""

from __future__ import annotations

import math

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
