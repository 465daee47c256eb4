"""MVN core: Cholesky-backed logpdf, sampling and the GP posterior (port of
``gaplac_tpu/ops/mvn.py``; logpdf and sampling are batched over leading
axes, the posterior helpers take one (n, n) system as there).

The observation variance ("jitter") 0.1 is the reference's default.

``mvn_logpdf`` brings its own adjoint (``_GaussianLogpdf``): with
alpha = K^{-1} (y - mean), the gradient in K is (alpha alpha^T - K^{-1}) / 2,
K^{-1} from the factor by halves (``ops/cholesky.py::cholesky_inverse``,
about 4 n^3 / 3 flops a matrix), and in y it is -alpha.  The dense marginal
(``inference/model.py::build_gaussian_marginal``) takes it under every
sampler, and no longer Murray's pullback of the factor, which does 4 n^3;
its reports take the same forward.  What uses the factor itself still goes
through ``linalg.cholesky`` and that pullback: ``mvn_logpdf_chol``, the
whitened model (f = L z), Laplace's B, the low-rank capacitance
(``ops/lowrank.py``) and ``parallel/distributed.py``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from gaplac_tpu_torch.ops import _build, linalg
from gaplac_tpu_torch.ops.cholesky import cholesky_inverse

DEFAULT_JITTER = 0.1


def add_jitter(K: torch.Tensor, jitter) -> torch.Tensor:
    n = K.shape[-1]
    return K + jitter * torch.eye(n, dtype=K.dtype, device=K.device)


def _jittered(K: torch.Tensor, jitter) -> torch.Tensor:
    if isinstance(jitter, (int, float)) and jitter == 0.0:
        return K
    return add_jitter(K, jitter)


def chol(K: torch.Tensor, jitter=0.0) -> torch.Tensor:
    """Lower Cholesky factor of K (+ jitter I)."""
    return linalg.cholesky(_jittered(K, jitter))


def mvn_logpdf_chol(L: torch.Tensor, y: torch.Tensor, mean=0.0) -> torch.Tensor:
    """log N(y; mean, L L^T) for L (..., n, n) and y (..., n); natural log."""
    n = y.shape[-1]
    alpha = linalg.solve_triangular(L, y - mean, lower=True)
    quad = torch.sum(alpha * alpha, dim=-1)
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)
    return -0.5 * (quad + logdet + n * math.log(2.0 * math.pi))


class _GaussianLogpdf(torch.autograd.Function):
    """log N(r; 0, K) for K (..., n, n) and r (..., n) of the same batch.
    Forward: L by ``linalg.factor``'s route, a = L^{-1} r.  Backward(g):
    K^{-1} from L, alpha = K^{-1} r (one product where a triangular solve
    L^{-T} a is a sequential pass), Kbar = g (alpha alpha^T - K^{-1}) / 2,
    full and symmetric, written over K^{-1}'s buffer; rbar = -g alpha.  A
    member whose factor failed gives NaN in its own value and gradient only."""

    @staticmethod
    def forward(ctx, K, r):
        L = linalg.factor(K)
        a = linalg.solve_triangular(L, r, lower=True)
        ctx.save_for_backward(L, r)
        logdet = 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)
        return -0.5 * (torch.sum(a * a, dim=-1) + logdet + r.shape[-1] * math.log(2.0 * math.pi))

    @staticmethod
    def backward(ctx, g):
        L, r = ctx.saved_tensors
        _build.adjoints["gaussian"] += 1
        n = L.shape[-1]
        Kbar = cholesky_inverse(L)
        Kb = Kbar.view(-1, n, n)
        alpha = torch.bmm(Kb, r.reshape(-1, n, 1))
        Kb.baddbmm_(alpha, alpha.mT, beta=-1).mul_(0.5 * g.reshape(-1, 1, 1))
        return Kbar, -g[..., None] * alpha.view(r.shape)


def mvn_logpdf(K: torch.Tensor, y: torch.Tensor, mean=0.0, jitter: float = 0.0) -> torch.Tensor:
    """log N(y; mean, K + jitter I) for K (..., n, n) and y (..., n), or y (n,)
    broadcast over K's batch; natural log.  Differentiable in K, y and mean
    through its own adjoint (module docstring)."""
    K = _jittered(K, jitter)
    r = y - mean
    if r.dim() < K.dim():
        r = r.expand(*K.shape[:-2], r.shape[-1])
    return _GaussianLogpdf.apply(K, r)


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
