"""Laplace approximation for latent-GP posteriors, dense path (port of
``gaplac_tpu/inference/laplace.py``: ``laplace_approx``, ``_diag_hess``,
``build_laplace_marginal``).

GPML Algorithm 3.1 (Rasmussen & Williams): a fixed number of Newton steps
for the mode of p(f | y, theta) with the stabilized B = I + sqrt(W) K
sqrt(W), then

    log q(y | theta) = -1/2 a^T f_hat + loglik(f_hat) - 1/2 log|B|,

an approximate marginal likelihood for non-Gaussian likelihoods.  Batched
over a leading chain axis like ``inference/model.py``: one evaluation
factors 16 (C, n, n) matrices (15 Newton steps and the mode) through kernel
K1, and its gradient runs through all of them.  The likelihood's first and
second derivatives are closed forms (``likelihoods.make_loglik_derivs``),
so autograd reaches the third derivative the gradient needs without
nesting ``autograd.grad`` inside the factorizations' graph.
``build_laplace_marginal_markov`` is the state-space form (``--approx
sde``): every dense solve becomes a parallel Kalman smoothing.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from gaplac_tpu_torch.inference.likelihoods import make_loglik, make_loglik_derivs
from gaplac_tpu_torch.inference.model import (
    DEFAULT_PRIOR_BOUNDS,
    GPModel,
    _params_from,
    _uniform_init,
    markov_data,
)
from gaplac_tpu_torch.inference.priors import as_prior
from gaplac_tpu_torch.inference.smc import particle_chunk
from gaplac_tpu_torch.kernels.covariance import CompiledKernel
from gaplac_tpu_torch.ops import linalg, mvn
from gaplac_tpu_torch.ops import markov_ss as mss


class LaplaceFit(NamedTuple):
    f_mode: torch.Tensor        # (..., n)
    log_marginal: torch.Tensor  # (...)
    W: torch.Tensor             # (..., n) negative loglik curvature at the mode


def _diag_hess(derivs: Callable, y, f, aux) -> torch.Tensor:
    """Diagonal Hessian of the per-point loglik in f (exact: the likelihood
    factorizes over points)."""
    return derivs(y, f, aux)[1]


def _b_factor(K: torch.Tensor, W: torch.Tensor):
    """sqrt(W) and the Cholesky factor of B = I + sqrt(W) K sqrt(W)."""
    sw = torch.sqrt(W)
    eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
    return sw, linalg.cholesky(eye + sw[..., :, None] * K * sw[..., None, :])


def laplace_approx(
    K: torch.Tensor,
    y: torch.Tensor,
    loglik_fn: Callable,
    derivs: Callable,
    aux: Optional[torch.Tensor] = None,
    num_iters: int = 15,
) -> LaplaceFit:
    """Newton mode-finding and the Laplace marginal for latent f ~ N(0, K),
    K (..., n, n); ``derivs`` gives the loglik's first and second
    derivatives per point."""
    f = a = K.new_zeros(K.shape[:-1])
    for _ in range(num_iters):
        g, h = derivs(y, f, aux)
        W = torch.clamp(-h, min=1e-9)
        sw, L = _b_factor(K, W)
        b = W * f + g
        Kb = (K @ b.unsqueeze(-1)).squeeze(-1)
        v = linalg.solve_triangular(L, sw * Kb, lower=True)
        a = b - sw * linalg.solve_triangular(L.mT, v, lower=False)
        f = (K @ a.unsqueeze(-1)).squeeze(-1)

    # at the mode f = K a, so GPML's -1/2 f^T K^-1 f is -1/2 a^T f
    W = torch.clamp(-_diag_hess(derivs, y, f, aux), min=1e-9)
    _, L = _b_factor(K, W)
    log_marginal = (-0.5 * torch.sum(a * f, dim=-1) + loglik_fn(y, f, aux).sum(-1)
                    - torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1))
    return LaplaceFit(f, log_marginal, W)


def build_laplace_marginal(
    ck: CompiledKernel,
    slot_groups: Tuple[Tuple[int, ...], ...],
    X: torch.Tensor,
    y: torch.Tensor,
    likelihood,
    aux: Optional[torch.Tensor] = None,
    jitter: float = mvn.DEFAULT_JITTER,
    prior_bounds=DEFAULT_PRIOR_BOUNDS,
    num_iters: int = 15,
) -> GPModel:
    """Approximate-marginal model for non-Gaussian likelihoods: the samplers
    run over theta only, with the latents integrated out by Laplace (the
    analogue of ``build_gaussian_marginal``).  Batched over a leading axis."""
    tr = as_prior(prior_bounds)
    nh = len(slot_groups)
    n = y.shape[0]
    dtype, device = X.dtype, X.device
    params_from = _params_from(ck, slot_groups, dtype, device)
    loglik_fn, derivs = make_loglik(likelihood), make_loglik_derivs(likelihood)
    dynamic = tuple(sorted({s for g in slot_groups for s in g}))
    gram_bound = ck.bind(X, dynamic, diag=jitter)

    def _fit(u):
        theta = tr.forward(u)
        K = gram_bound(params_from(theta))
        return theta, K, laplace_approx(K, y, loglik_fn, derivs, aux, num_iters)

    def logdensity(u: torch.Tensor) -> torch.Tensor:
        _, _, fit = _fit(u)
        return fit.log_marginal + tr.logprior_u(u).sum(-1)

    @torch.no_grad()
    def report(gen: torch.Generator, u: torch.Tensor):
        """f from the Gaussian around the mode, cov = (K^-1 + W)^-1, and the
        joint lp as the latent models record it."""
        theta, K, fit = _fit(u)
        sw, L = _b_factor(K, fit.W)
        V = linalg.solve_triangular(L, sw[..., :, None] * K, lower=True)
        cov = K - V.mT @ V
        tr_c = torch.diagonal(cov, dim1=-2, dim2=-1).sum(-1)
        Lc = linalg.cholesky(mvn.add_jitter(cov, (1e-8 * tr_c / n)[..., None, None]))
        f = mvn.sample_mvn_chol(gen, Lc, fit.f_mode)
        lp = (tr.logprior_x(theta).sum(-1) + mvn.mvn_logpdf(K, f)
              + loglik_fn(y, f, aux).sum(-1))
        return theta, f, lp

    def initial_position(gen: torch.Generator, C: int) -> torch.Tensor:
        return _uniform_init(gen, C, nh, dtype, device)

    def position_from(theta, f) -> torch.Tensor:
        return tr.inverse(torch.as_tensor(theta, dtype=dtype, device=device))

    return GPModel(nh, nh, logdensity, report, tr.forward, initial_position, True,
                   position_from, particle_chunk(n, n, y.element_size()))


def build_laplace_marginal_markov(
    ck: CompiledKernel,
    slot_groups: Tuple[Tuple[int, ...], ...],
    X: torch.Tensor,
    y: torch.Tensor,
    likelihood,
    aux: Optional[torch.Tensor] = None,
    jitter: float = mvn.DEFAULT_JITTER,
    prior_bounds=DEFAULT_PRIOR_BOUNDS,
    num_iters: int = 15,
) -> GPModel:
    """State-space Laplace marginal (``--approx sde``, non-Gaussian
    likelihoods): GPML Algorithm 3.1's objective with every dense solve an
    O(n log n) parallel Kalman pass,

      Newton step  f <- K (K + diag(1/W))^-1 z, z = f + grad/W: smoothing of
                   the working response at per-row noise 1/W,
      -1/2 f^T K^-1 f = the filter's quadratic form at R = j_eff,
      -1/2 log|B|  = -1/2 (sum log S_i at R = j_eff + 1/W, plus sum log W_i),

    with K = K_ss + j_eff I.  Batched over a leading axis; the gradient runs
    through the 15 smoothings."""
    tr = as_prior(prior_bounds)
    nh = len(slot_groups)
    n = y.shape[0]
    dtype, device = X.dtype, X.device
    params_from = _params_from(ck, slot_groups, dtype, device)
    loglik_fn, derivs = make_loglik(likelihood), make_loglik_derivs(likelihood)
    md = markov_data(ck, X, dynamic_slots={s for g in slot_groups for s in g})
    ys = y[md.idx]
    aux_s = None if aux is None else aux[md.idx]

    def _smooth_correct(A, Q, H, j_eff, z, Rw):
        """S T^-1 z for S = K_ss + j_eff I, T = S + diag(Rw): smoothing at
        total noise j_eff + Rw, plus the per-row jitter correction."""
        m_x = mss.measure_row(H, mss.ss_smooth(A, Q, H, z, j_eff + Rw)[0])
        return m_x + j_eff * (z - m_x) / (j_eff + Rw)

    def _fit(u):
        theta = tr.forward(u)
        p = params_from(theta)
        A, Q, H = md.steps(ck, p)
        j_eff = md.j_eff(p, jitter)
        f = ys.new_zeros(u.shape[:-1] + (n,))
        for _ in range(num_iters):
            g, h = derivs(ys, f, aux_s)
            Rw = 1.0 / torch.clamp(-h, min=1e-9)
            f = _smooth_correct(A, Q, H, j_eff, f + g * Rw, Rw)
        W = torch.clamp(-_diag_hess(derivs, ys, f, aux_s), min=1e-9)
        quad, _ = mss.ss_loglik_parts(A, Q, H, f, j_eff)
        _, logdet_T = mss.ss_loglik_parts(A, Q, H, f, j_eff + 1.0 / W)
        log_B = logdet_T + torch.sum(torch.log(W), dim=-1)
        log_marginal = -0.5 * quad + loglik_fn(ys, f, aux_s).sum(-1) - 0.5 * log_B
        return theta, (A, Q, H), j_eff, f, W, log_marginal

    def logdensity(u: torch.Tensor) -> torch.Tensor:
        # SqExp/RQ steps run in float64 (markov_ss.steps_dtype)
        return (_fit(u)[-1] + tr.logprior_u(u).sum(-1)).to(dtype)

    @torch.no_grad()
    def report(gen: torch.Generator, u: torch.Tensor):
        """f from N(f_hat, (K^-1 + W)^-1) by Matheron's rule,
        f_hat + f* - S T^-1 (f* + eps*), and the joint lp."""
        theta, (A, Q, H), j_eff, f_hat, W, _ = _fit(u)
        Rw = 1.0 / W
        f_star = (mss.measure_row(H, mss.ss_prior_sample(gen, A, Q))
                  + torch.sqrt(j_eff) * torch.randn(f_hat.shape, generator=gen, dtype=dtype,
                                                    device=device))
        eps = torch.sqrt(Rw) * torch.randn(f_hat.shape, generator=gen, dtype=dtype, device=device)
        f = f_hat + f_star - _smooth_correct(A, Q, H, j_eff, f_star + eps, Rw)
        lp = (tr.logprior_x(theta).sum(-1) + mss.ss_loglik(A, Q, H, f, j_eff)
              + loglik_fn(ys, f, aux_s).sum(-1))
        return theta, f[..., md.inv_idx].to(dtype), lp.to(dtype)

    def initial_position(gen: torch.Generator, C: int) -> torch.Tensor:
        return _uniform_init(gen, C, nh, dtype, device)

    def position_from(theta, f) -> torch.Tensor:
        return tr.inverse(torch.as_tensor(theta, dtype=dtype, device=device))

    return GPModel(nh, nh, logdensity, report, tr.forward, initial_position, True,
                   position_from, md.report_batch())
