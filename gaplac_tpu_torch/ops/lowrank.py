"""Low-rank (feature-space) MVN ops: N(0, Phi Phi^T + D) without n x n math
(port of ``gaplac_tpu/ops/lowrank.py``).

With Phi an (n, m) feature matrix (``kernels/features.py``) and D = diag(d),
every operation reduces by the Woodbury identity to (n, m) matmuls and one
m x m Cholesky factor of the capacitance matrix A = I_m + Phi^T D^-1 Phi:

  (Phi Phi^T + D)^-1 = D^-1 - D^-1 Phi A^-1 Phi^T D^-1
  logdet(Phi Phi^T + D) = logdet(A) + sum(log d)

Weight-space view (posterior, predict, sample): y = Phi w + e with
w ~ N(0, I_m), e ~ N(0, D), so w | y ~ N(A^-1 Phi^T D^-1 y, A^-1).

Every function takes Phi (n, m) or a batch (C, n, m), d of shape (), (n,) or
(C, n), and vectors (n,) or (C, n); ``lowrank_solve`` also takes a matrix
right-hand side (..., n, k).  A (C, m, m) capacitance batch, and a 2-D one
below ``linalg.BLOCKED_MIN_N``, is factored by kernel K1; a 2-D one from
there on by the blocked route through kernel K3 (``ops/linalg.py``).  The
samplers take an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Union

import torch

from gaplac_tpu_torch.ops import linalg

_LOG_2PI = math.log(2.0 * math.pi)

Diag = Union[float, torch.Tensor]


def _as_diag(d: Diag, like: torch.Tensor) -> torch.Tensor:
    """d as a tensor of ``like``'s dtype and device, (n,) or (..., n)."""
    d = torch.as_tensor(d, dtype=like.dtype, device=like.device)
    return d.expand(like.shape[-2]) if d.dim() == 0 else d


class LowRankChol(NamedTuple):
    """Cached factorization of Phi Phi^T + diag(d): ``R`` is the lower
    Cholesky factor of A = I_m + Phi^T D^-1 Phi; ``phi_over_d`` caches
    D^-1 Phi for the solves."""

    phi: torch.Tensor         # (..., n, m)
    d: torch.Tensor           # (n,) or (..., n)
    phi_over_d: torch.Tensor  # (..., n, m)
    R: torch.Tensor           # (..., m, m) lower


#: rows of each partial product of a product over the n rows (Phi^T D^-1
#: Phi, Phi^T D^-1 y).  cuBLAS sums such an entry along all n rows in the
#: working precision: in float32 at n = 65536 on an H100 one product put the
#: capacitance matrix's least eigenvalue at -0.22 where it is at least 1 (d =
#: 0.1), so K1 found it indefinite, and the log density off by 0.44 nats;
#: partial products of 1024 rows, summed, left 0.996 and 0.012 nats
#: (chip_smoke.py, row_block_errors).
ROW_BLOCK = 1024


def rows_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a^T b for a (..., n, m) and b (..., n, k): one batched product of the
    whole blocks of ROW_BLOCK rows, summed, plus the rest."""
    n = a.shape[-2]
    c, rest = divmod(n, ROW_BLOCK)
    if rest:  # (a slice's backward writes a full-size copy: slice only when needed)
        return rows_matmul(a[..., :n - rest, :], b[..., :n - rest, :]) + (
            a[..., n - rest:, :].mT @ b[..., n - rest:, :])
    return (a.unflatten(-2, (c, ROW_BLOCK)).mT @ b.unflatten(-2, (c, ROW_BLOCK))).sum(-3)


def lowrank_chol(phi: torch.Tensor, d: Diag) -> LowRankChol:
    m = phi.shape[-1]
    d = _as_diag(d, phi)
    phi_over_d = phi / d[..., None]
    A = torch.eye(m, dtype=phi.dtype, device=phi.device) + rows_matmul(phi, phi_over_d)
    # Phi^T D^-1 Phi is symmetric up to the matmul's rounding only
    A = 0.5 * (A + A.mT)
    return LowRankChol(phi, d, phi_over_d, linalg.cholesky(A))


def lowrank_solve(lr: LowRankChol, y: torch.Tensor) -> torch.Tensor:
    """(Phi Phi^T + D)^-1 y by Woodbury; y a vector (..., n) or a matrix
    (..., n, k) (as many dims as Phi)."""
    vec = y.dim() < lr.phi.dim()
    Y = y[..., None] if vec else y
    b = rows_matmul(lr.phi_over_d, Y)
    u = linalg.solve_triangular(lr.R, b, lower=True)
    v = linalg.solve_triangular(lr.R.mT, u, lower=False)
    out = Y / lr.d[..., None] - lr.phi_over_d @ v
    return out[..., 0] if vec else out


def lowrank_logdet(lr: LowRankChol) -> torch.Tensor:
    return (2.0 * torch.sum(torch.log(torch.diagonal(lr.R, dim1=-2, dim2=-1)), dim=-1)
            + torch.sum(torch.log(lr.d), dim=-1))


def lowrank_logpdf_chol(lr: LowRankChol, y: torch.Tensor, mean=0.0) -> torch.Tensor:
    """log N(y; mean, Phi Phi^T + D), natural log (as ``ops/mvn.py::
    mvn_logpdf`` on the dense equivalent)."""
    r = y - mean
    n = r.shape[-1]
    b = rows_matmul(lr.phi_over_d, r[..., None])[..., 0]               # (..., m)
    u = linalg.solve_triangular(lr.R, b, lower=True)
    quad = torch.sum(r * r / lr.d, dim=-1) - torch.sum(u * u, dim=-1)
    return -0.5 * (quad + lowrank_logdet(lr) + n * _LOG_2PI)


def lowrank_logpdf(phi: torch.Tensor, d: Diag, y: torch.Tensor, mean=0.0) -> torch.Tensor:
    return lowrank_logpdf_chol(lowrank_chol(phi, d), y, mean)


def _randn(gen: torch.Generator, shape, like: torch.Tensor) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=like.dtype, device=like.device)


def sample_lowrank(gen: torch.Generator, phi: torch.Tensor, d: Diag, mean=0.0) -> torch.Tensor:
    """One draw a batch member from N(mean, Phi Phi^T + D): f = mean + Phi w
    + sqrt(d) eta, O(n m)."""
    *batch, n, m = phi.shape
    d = _as_diag(d, phi)
    w = _randn(gen, (*batch, m), phi)
    eta = _randn(gen, (*batch, n), phi)
    return mean + (phi @ w[..., None])[..., 0] + torch.sqrt(d) * eta


class LowRankPosterior(NamedTuple):
    """Weight-space GP regression posterior: w | y ~ N(w_mean, (R R^T)^-1)."""

    w_mean: torch.Tensor  # (m,)
    R: torch.Tensor       # (m, m) lower factor of A = I + Phi^T D^-1 Phi


def lowrank_posterior(phi: torch.Tensor, d: Diag, y: torch.Tensor, mean=0.0) -> LowRankPosterior:
    lr = lowrank_chol(phi, d)
    b = rows_matmul(lr.phi_over_d, (y - mean)[..., None])[..., 0]
    u = linalg.solve_triangular(lr.R, b, lower=True)
    w_mean = linalg.solve_triangular(lr.R.mT, u, lower=False)
    return LowRankPosterior(w_mean, lr.R)


def lowrank_predict_mean(post: LowRankPosterior, phi_t: torch.Tensor,
                         prior_mean=0.0) -> torch.Tensor:
    """Posterior mean at the test features phi_t (n_t, m)."""
    return prior_mean + phi_t @ post.w_mean


def lowrank_predict_var(post: LowRankPosterior, phi_t: torch.Tensor,
                        extra_diag: Diag = 0.0) -> torch.Tensor:
    """Posterior marginal variance of f* = Phi* w, plus an independent
    diagonal prior variance (the latent's jitter, bare Noise)."""
    V = linalg.solve_triangular(post.R, phi_t.mT, lower=True)  # (m, n_t)
    return torch.sum(V * V, dim=-2) + extra_diag


def lowrank_conditional_sample_at(
    gen: torch.Generator,
    phi: torch.Tensor,
    d0: Diag,
    obs_sigma2: float,
    y: torch.Tensor,
    phi_t: torch.Tensor,
    d0_t: Diag,
) -> torch.Tensor:
    """A draw of f* at TEST features from p(f* | y), by Matheron's rule: train
    f = Phi w + sqrt(d0) eta, y = f + N(0, s2 I), and f* = Phi* w + sqrt(d0_t)
    eta* shares only the weights w with f (the diagonal parts are
    row-independent, as the dense path's Noise and jitter).  O((n + n_t) m)."""
    n, m = phi.shape[-2:]
    d0 = _as_diag(d0, phi)
    d0_t = _as_diag(d0_t, phi_t)
    w0 = _randn(gen, (m,), phi)
    f0 = phi @ w0 + torch.sqrt(d0) * _randn(gen, (n,), phi)
    e0 = math.sqrt(obs_sigma2) * _randn(gen, (n,), phi)
    lr = lowrank_chol(phi, d0 + obs_sigma2)
    v = lowrank_solve(lr, y - f0 - e0)  # (K_xx + d0 + s2 I)^-1 residual
    return (phi_t @ (w0 + rows_matmul(phi, v[:, None])[:, 0])
            + torch.sqrt(d0_t) * _randn(gen, (phi_t.shape[0],), phi))


def lowrank_conditional_sample(
    gen: torch.Generator,
    phi: torch.Tensor,
    d0: Diag,
    obs_sigma2: float,
    y: torch.Tensor,
) -> torch.Tensor:
    """A draw a batch member from p(f | y), f ~ N(0, C), C = Phi Phi^T +
    diag(d0), y = f + N(0, s2 I), by Matheron's rule: f0 + C (C + s2 I)^-1
    (y - f0 - e0) with f0 ~ N(0, C), e0 ~ N(0, s2 I).  O(n m^2)."""
    *batch, n, _ = phi.shape
    d0 = _as_diag(d0, phi)
    f0 = sample_lowrank(gen, phi, d0)
    e0 = math.sqrt(obs_sigma2) * _randn(gen, (*batch, n), phi)
    lr = lowrank_chol(phi, d0 + obs_sigma2)
    v = lowrank_solve(lr, y - f0 - e0)                                # (C + s2 I)^-1 residual
    return f0 + (phi @ rows_matmul(phi, v[..., None]))[..., 0] + d0 * v   # C v
