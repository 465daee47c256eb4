"""Log-density models for GP hyperparameter inference, dense paths (port of
``gaplac_tpu/inference/model.py``).

Reference model: ℓ ~ Uniform(0, 20); fx ~ GP(kern(ℓ)) at X with jitter 0.1;
y ~ Normal(fx, 1).  The formulations, as in ``gaplac_tpu``:

1. ``build_gaussian_marginal``: Gaussian likelihoods integrate the latents
   out, y ~ N(0, K(θ) + (jitter + σ²) I); the sampler runs over θ only.
2. ``build_latent_whitened``: f = L(θ) z with z ~ N(0, I), sampled over
   v = [u, z]; any likelihood.
3. ``build_gaussian_marginal_lowrank`` (``approx="rff"``): the marginal of 1
   with K(θ) replaced by Φ(θ)Φ(θ)ᵀ, Φ the (n, m) feature matrix of
   ``kernels/features.py``, in O(n m²) (``ops/lowrank.py``).

Every function here is batched over a leading chain axis: ``logdensity``
maps v (C, dim) to (C,), so one call factors a (C, n, n) batch through
kernels K1 and K2, or for 3 a (C, m, m) capacitance batch through K1.
``approx="sde"`` is not ported.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Tuple

import torch

from gaplac_tpu_torch.dsl.parser import LikelihoodSpec
from gaplac_tpu_torch.inference.likelihoods import gaussian_obs_sigma2, make_loglik
from gaplac_tpu_torch.inference.priors import as_prior
from gaplac_tpu_torch.kernels.covariance import CompiledKernel
from gaplac_tpu_torch.ops import linalg, lowrank, mvn

_LOG_2PI = math.log(2.0 * math.pi)

DEFAULT_PRIOR_BOUNDS = (0.0, 20.0)


def slot_groups_for(
    ck: CompiledKernel,
    inferable: Sequence[str],
    shared: bool = True,
    infer_extras: Sequence[str] = (),
) -> Tuple[Tuple[int, ...], ...]:
    """Map --infer variables to hyperparameter slot groups: one shared
    scalar for all (``shared``) or one per variable, then one entry per
    shape parameter of the --infer-extra variables."""
    groups: list = []
    if inferable:
        if shared:
            groups.append(ck.param_slots_for_vars(inferable))
        else:
            seen = set()
            for v in inferable:
                if v in seen:
                    continue
                seen.add(v)
                groups.append(ck.param_slots_for_vars([v]))
    seen_e = set()
    for v in infer_extras:
        if v in seen_e:
            continue
        seen_e.add(v)
        groups.extend((s,) for s in ck.extra_slots_for_vars([v]))
    if not groups:
        raise ValueError("nothing to infer: give --infer and/or --infer-extra")
    return tuple(groups)


@dataclass(frozen=True)
class GPModel:
    """A compiled inference problem, batched over a leading axis.

    ``logdensity(v)``: (C, dim) -> (C,), the unconstrained-space target.
    ``report(gen, v)``: (B, dim) -> theta (B, n_hyper), f (B, n), lp (B,),
    the chain-row pieces.  ``initial_position(gen, C)`` -> (C, dim).
    ``position_from(theta, f)``: one chain row back to a position (dim,).
    """

    dim: int
    n_hyper: int
    logdensity: Callable[[torch.Tensor], torch.Tensor]
    report: Callable
    constrain: Callable[[torch.Tensor], torch.Tensor]
    initial_position: Callable
    marginalized: bool
    position_from: Callable = None


def _params_from(ck: CompiledKernel, slot_groups, dtype, device):
    """theta (C, n_groups) -> params (C, n_params): the defaults with each
    group's slots set to its theta, as an out-of-place scatter so autograd
    flows to theta."""
    defaults = ck.default_params(dtype, device)
    idx_groups = [torch.as_tensor(g, dtype=torch.long, device=device) for g in slot_groups]

    def params(theta: torch.Tensor) -> torch.Tensor:
        C = theta.shape[0]
        p = defaults.expand(C, -1)
        for g, idx in enumerate(idx_groups):
            p = p.index_copy(1, idx, theta[:, g:g + 1].expand(C, idx.numel()))
        return p

    return params


def _uniform_init(gen, C, nh, dtype, device):
    """u0 ~ U(-2, 2), as Turing initializes."""
    return torch.rand((C, nh), generator=gen, dtype=dtype, device=device) * 4.0 - 2.0


def build_gaussian_marginal(
    ck: CompiledKernel,
    slot_groups: Tuple[Tuple[int, ...], ...],
    X: torch.Tensor,
    y: torch.Tensor,
    jitter: float = mvn.DEFAULT_JITTER,
    obs_sigma2: float = 1.0,
    prior_bounds=DEFAULT_PRIOR_BOUNDS,
) -> GPModel:
    """Collapsed model: θ -> log N(y; 0, K(θ) + (jitter + σ²) I) + prior."""
    tr = as_prior(prior_bounds)
    nh = len(slot_groups)
    n = y.shape[0]
    dtype, device = X.dtype, X.device
    params_from = _params_from(ck, slot_groups, dtype, device)
    dynamic = tuple(sorted({s for g in slot_groups for s in g}))
    gram_bound = ck.bind(X, dynamic, diag=jitter + obs_sigma2)

    def logdensity(u: torch.Tensor) -> torch.Tensor:
        theta = tr.forward(u)
        S = gram_bound(params_from(theta))
        return mvn.mvn_logpdf(S, y) + tr.logprior_u(u).sum(-1)

    @torch.no_grad()
    def report(gen: torch.Generator, u: torch.Tensor):
        """f ~ p(f | θ, y) exactly, and the joint lp = log p(θ) +
        log N(f; 0, K + jitter I) + Σ log N(y; f, σ²)."""
        theta = tr.forward(u)
        Kf = ck.gram(params_from(theta), X, diag=jitter)
        Ls = linalg.cholesky(mvn.add_jitter(Kf, obs_sigma2))
        A = linalg.solve_triangular(Ls, Kf, lower=True)               # L^-1 Kf
        mean_f = (A.mT @ linalg.solve_triangular(Ls, y, lower=True).unsqueeze(-1)).squeeze(-1)
        cond_cov = Kf - A.mT @ A
        tr_c = torch.diagonal(cond_cov, dim1=-2, dim2=-1).sum(-1)
        Lc = linalg.cholesky(mvn.add_jitter(cond_cov, (1e-8 * tr_c / n)[:, None, None]))
        f = mvn.sample_mvn_chol(gen, Lc, mean_f)
        lp = (tr.logprior_x(theta).sum(-1) + mvn.mvn_logpdf(Kf, f)
              + torch.sum(-0.5 * ((y - f) ** 2 / obs_sigma2 + math.log(obs_sigma2) + _LOG_2PI),
                          dim=-1))
        return theta, f, lp

    def initial_position(gen: torch.Generator, C: int) -> torch.Tensor:
        return _uniform_init(gen, C, nh, dtype, device)

    def position_from(theta: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
        return tr.inverse(torch.as_tensor(theta, dtype=dtype, device=device))

    return GPModel(nh, nh, logdensity, report, tr.forward, initial_position, True,
                   position_from)


def build_gaussian_marginal_lowrank(
    ck: CompiledKernel,
    slot_groups: Tuple[Tuple[int, ...], ...],
    X: torch.Tensor,
    y: torch.Tensor,
    num_features: int = 256,
    feature_seed: int = 0,
    jitter: float = mvn.DEFAULT_JITTER,
    obs_sigma2: float = 1.0,
    prior_bounds=DEFAULT_PRIOR_BOUNDS,
) -> GPModel:
    """Low-rank collapsed model: θ -> log N(y; 0, Φ(θ)Φ(θ)ᵀ + D(θ)) + prior,
    D = jitter + bare Noise + σ²; the prior, jitter and σ² of
    ``build_gaussian_marginal``."""
    from gaplac_tpu_torch.kernels.features import build_feature_map

    tr = as_prior(prior_bounds)
    nh = len(slot_groups)
    dtype, device = X.dtype, X.device
    params_from = _params_from(ck, slot_groups, dtype, device)
    fm = build_feature_map(ck, [X], num_features=num_features, seed=feature_seed)

    def _phi_d0(theta):
        """The features and the latent's prior diagonal d0 = jitter + bare Noise."""
        p = params_from(theta)
        return fm.phi(p, X), jitter + fm.noise_diag(p, X)

    def logdensity(u: torch.Tensor) -> torch.Tensor:
        phi, d0 = _phi_d0(tr.forward(u))
        return lowrank.lowrank_logpdf(phi, d0 + obs_sigma2, y) + tr.logprior_u(u).sum(-1)

    @torch.no_grad()
    def report(gen: torch.Generator, u: torch.Tensor):
        """f ~ p(f | θ, y) exactly by Matheron's rule, and the joint lp of
        ``build_gaussian_marginal``'s report, all in O(n m²)."""
        theta = tr.forward(u)
        phi, d0 = _phi_d0(theta)
        f = lowrank.lowrank_conditional_sample(gen, phi, d0, obs_sigma2, y)
        lp = (tr.logprior_x(theta).sum(-1) + lowrank.lowrank_logpdf(phi, d0, f)
              + torch.sum(-0.5 * ((y - f) ** 2 / obs_sigma2 + math.log(obs_sigma2) + _LOG_2PI),
                          dim=-1))
        return theta, f, lp

    def initial_position(gen: torch.Generator, C: int) -> torch.Tensor:
        return _uniform_init(gen, C, nh, dtype, device)

    def position_from(theta: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
        return tr.inverse(torch.as_tensor(theta, dtype=dtype, device=device))

    return GPModel(nh, nh, logdensity, report, tr.forward, initial_position, True,
                   position_from)


def build_latent_whitened(
    ck: CompiledKernel,
    slot_groups: Tuple[Tuple[int, ...], ...],
    X: torch.Tensor,
    y: torch.Tensor,
    likelihood: LikelihoodSpec,
    aux: Optional[torch.Tensor] = None,
    jitter: float = mvn.DEFAULT_JITTER,
    prior_bounds=DEFAULT_PRIOR_BOUNDS,
) -> GPModel:
    """Whitened latent model over v = [u (nh,), z (n,)]: f = L(θ) z."""
    tr = as_prior(prior_bounds)
    nh = len(slot_groups)
    n = y.shape[0]
    dtype, device = X.dtype, X.device
    params_from = _params_from(ck, slot_groups, dtype, device)
    loglik = make_loglik(likelihood)
    dynamic = tuple(sorted({s for g in slot_groups for s in g}))
    gram_bound = ck.bind(X, dynamic, diag=jitter)

    def _latent_chol(u):
        theta = tr.forward(u)
        return theta, linalg.cholesky(gram_bound(params_from(theta)))

    def logdensity(v: torch.Tensor) -> torch.Tensor:
        u, z = v[:, :nh], v[:, nh:]
        _, L = _latent_chol(u)
        f = (L @ z.unsqueeze(-1)).squeeze(-1)
        return (tr.logprior_u(u).sum(-1) - 0.5 * torch.sum(z * z, dim=-1)
                - 0.5 * n * _LOG_2PI + loglik(y, f, aux).sum(-1))

    @torch.no_grad()
    def report(gen: torch.Generator, v: torch.Tensor):
        u, z = v[:, :nh], v[:, nh:]
        theta, L = _latent_chol(u)
        f = (L @ z.unsqueeze(-1)).squeeze(-1)
        lp = (tr.logprior_x(theta).sum(-1) + mvn.mvn_logpdf_chol(L, f)
              + loglik(y, f, aux).sum(-1))
        return theta, f, lp

    def initial_position(gen: torch.Generator, C: int) -> torch.Tensor:
        u0 = _uniform_init(gen, C, nh, dtype, device)
        z0 = 0.1 * torch.randn((C, n), generator=gen, dtype=dtype, device=device)
        return torch.cat([u0, z0], dim=1)

    @torch.no_grad()
    def position_from(theta: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
        u = tr.inverse(torch.as_tensor(theta, dtype=dtype, device=device))
        _, L = _latent_chol(u[None])
        z = linalg.solve_triangular(L[0], torch.as_tensor(f, dtype=dtype, device=device))
        return torch.cat([u, z])

    return GPModel(nh + n, nh, logdensity, report, tr.forward, initial_position, False,
                   position_from)


def build_model(
    ck: CompiledKernel,
    inferable: Sequence[str],
    X: torch.Tensor,
    y: torch.Tensor,
    likelihood: LikelihoodSpec,
    aux: Optional[torch.Tensor] = None,
    jitter: float = mvn.DEFAULT_JITTER,
    prior_bounds=DEFAULT_PRIOR_BOUNDS,
    shared_hyper: bool = True,
    marginalize: bool = True,
    approx: str = "exact",
    rff_features: int = 256,
    rff_seed: int = 0,
    infer_extras: Sequence[str] = (),
) -> GPModel:
    """The marginal model for Gaussian likelihoods (default), the whitened
    latent model otherwise; ``approx="rff"`` takes the low-rank feature-space
    marginal (Gaussian likelihoods only)."""
    if approx not in ("exact", "rff"):
        raise NotImplementedError(f"approx={approx!r} is not yet ported to gaplac_tpu_torch "
                                  "(the dense exact and rff paths are)")
    groups = slot_groups_for(ck, inferable, shared=shared_hyper, infer_extras=infer_extras)
    sigma2 = gaussian_obs_sigma2(likelihood)
    if approx == "rff":
        if sigma2 is None:
            raise ValueError(
                "--approx rff requires a Gaussian likelihood (the low-rank "
                "path marginalizes the latents analytically)"
            )
        if infer_extras:
            raise ValueError(
                "--infer-extra is not supported with --approx rff: the "
                "feature expansion is drawn from the spectral density at the "
                "STATIC shape parameters (period/alpha), so they cannot vary "
                "per density evaluation"
            )
        return build_gaussian_marginal_lowrank(
            ck, groups, X, y, num_features=rff_features, feature_seed=rff_seed,
            jitter=jitter, obs_sigma2=sigma2, prior_bounds=prior_bounds,
        )
    if marginalize and sigma2 is not None:
        return build_gaussian_marginal(ck, groups, X, y, jitter=jitter, obs_sigma2=sigma2,
                                       prior_bounds=prior_bounds)
    return build_latent_whitened(ck, groups, X, y, likelihood, aux=aux, jitter=jitter,
                                 prior_bounds=prior_bounds)
