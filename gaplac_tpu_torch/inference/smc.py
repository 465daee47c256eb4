"""Tempered sequential Monte Carlo for marginal likelihoods (port of
``gaplac_tpu/inference/smc.py``).

Particles start from the prior; the inverse temperature beta climbs from 0
to 1 by bisection on a target relative ESS; each stage adds
logmeanexp((beta' - beta) * loglik) to log Z, resamples systematically and
rejuvenates with random-walk Metropolis steps whose scale follows the
particles' spread.  The stage loop and the bisection run on the host; the
particles stay on the device, and each evaluation of the particles' log
likelihoods is one batched call over the particle axis (through K2 and K1
for a dense GP, K1 for the rff one), in chunks when its buffers would pass
``SMC_BATCH_BYTES``.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch
from scipy.special import logsumexp

#: the buffers one batched call over particles (or a report's draws) may
#: hold; more than that are evaluated in chunks
SMC_BATCH_BYTES = 4 << 30
#: (B, n, width) buffers a GP log likelihood holds at once: the dense gram,
#: its factor and the factorization's working copy (width n), or the rff
#: model's features, their scaled copy and the feature map's temporary
#: (width m_total)
_GP_BUFFERS = 3


class SMCResult(NamedTuple):
    log_evidence: float           # log Z (natural log)
    particles: torch.Tensor       # (n_particles, dim) final posterior particles
    n_stages: int
    final_beta: float


def _systematic_resample(u: float, log_w: np.ndarray, n: int) -> np.ndarray:
    """Systematic resampling indices for the weights exp(log_w), with ``u``
    the one U(0, 1) draw that offsets the n evenly spaced points."""
    w = np.exp(log_w - logsumexp(log_w))
    cum = np.cumsum(w)
    points = (u + np.arange(n)) / n
    return np.clip(np.searchsorted(cum, points, side="right"), 0, n - 1)


def next_beta(beta: float, lls: np.ndarray, target_rel_ess: float = 0.5) -> float:
    """The largest beta' in (beta, 1] whose incremental weights keep the
    relative ESS at or above ``target_rel_ess`` (bisection, at most 30
    halvings, to a width of 1e-6)."""
    n = lls.shape[0]

    def ess_at(b):
        lw = (b - beta) * lls
        lw = lw - logsumexp(lw)
        return math.exp(-logsumexp(2.0 * lw)) / n

    if ess_at(1.0) >= target_rel_ess:
        return 1.0
    lo, hi, it = beta, 1.0, 0
    while it < 30 and hi - lo > 1e-6:
        mid = 0.5 * (lo + hi)
        if ess_at(mid) >= target_rel_ess:
            lo = mid
        else:
            hi = mid
        it += 1
    return lo


def run_smc(
    gen: torch.Generator,
    sample_prior: Callable[[torch.Generator, int], torch.Tensor],
    logprior: Callable[[torch.Tensor], torch.Tensor],
    loglik: Callable[[torch.Tensor], torch.Tensor],
    n_particles: int = 512,
    target_rel_ess: float = 0.5,
    rejuvenation_steps: int = 5,
    rw_scale: float = 1.0,  # multiplier on the adaptive 2.38/sqrt(d) * sd scale
    max_stages: int = 50,
) -> SMCResult:
    """``sample_prior(gen, n) -> (n, dim)``; ``logprior`` and ``loglik`` map
    the particles (B, dim) to (B,)."""
    parts = sample_prior(gen, n_particles)
    dtype, device = parts.dtype, parts.device
    lls = loglik(parts)
    beta, log_z, stage = 0.0, 0.0, 0
    while beta < 1.0 and stage < max_stages:
        lls_host = lls.double().cpu().numpy()
        beta_new = next_beta(beta, lls_host, target_rel_ess)
        inc = (beta_new - beta) * lls_host
        log_z += float(logsumexp(inc)) - math.log(n_particles)

        u = float(torch.rand((), generator=gen, dtype=torch.float64, device=device))
        idx = torch.as_tensor(_systematic_resample(u, inc, n_particles), device=device)
        parts, lls = parts[idx], lls[idx]

        # random-walk Metropolis at beta_new; the proposal scale follows the
        # particles' per-dimension spread (2.38 / sqrt(d) of their sd)
        prop_sd = rw_scale * (2.38 / math.sqrt(parts.shape[1])) * (
            parts.std(dim=0, unbiased=False) + 1e-3)
        lps = logprior(parts)
        for _ in range(rejuvenation_steps):
            prop = parts + prop_sd * torch.randn(parts.shape, generator=gen, dtype=dtype,
                                                 device=device)
            lls_p, lps_p = loglik(prop), logprior(prop)
            log_acc = (lps_p + beta_new * lls_p) - (lps + beta_new * lls)
            accept = torch.log(torch.rand((n_particles,), generator=gen, dtype=dtype,
                                          device=device)) < log_acc
            parts = torch.where(accept[:, None], prop, parts)
            lls = torch.where(accept, lls_p, lls)
            lps = torch.where(accept, lps_p, lps)
        beta = beta_new
        stage += 1
    return SMCResult(log_z, parts, stage, beta)


def particle_chunk(n: int, width: int, itemsize: int, buffers: int = _GP_BUFFERS) -> int:
    """Particles (or draws) one batched GP call takes at n observations: as
    many as keep its ``buffers`` (B, n, width) buffers within
    SMC_BATCH_BYTES.  Every model builder sizes its ``report_batch`` so."""
    return max(1, SMC_BATCH_BYTES // (buffers * n * width * itemsize))


def smc_log_evidence_gp(gen: torch.Generator, model, y: torch.Tensor, chunk: int,
                        n_particles: int = 512, **kwargs) -> SMCResult:
    """Marginal likelihood of a marginalized GPModel over its unconstrained
    hyperparameters: the prior is the Uniform prior's logit image (logistic
    draws), the log likelihood the model's log density less that prior.
    Only the marginalized (Gaussian) models decompose so.  ``y``, the
    observations the model conditions on, gives the draws their dtype and
    device; ``chunk`` particles at most go through the model in one call
    (the model's ``report_batch``)."""
    if not model.marginalized:
        raise ValueError("SMC evidence requires the marginalized (Gaussian) model")

    def logprior(u):
        # the uniform prior through the logit transform: -softplus(u) - softplus(-u)
        return torch.sum(-torch.nn.functional.softplus(u)
                         - torch.nn.functional.softplus(-u), dim=-1)

    @torch.no_grad()
    def loglik(u):
        return torch.cat([model.logdensity(c) - logprior(c) for c in u.split(chunk)])

    def sample_prior(g, n):
        # u = logit of Uniform(1e-6, 1 - 1e-6): logistic draws
        p = 1e-6 + (1 - 2e-6) * torch.rand((n, model.dim), generator=g,
                                           dtype=y.dtype, device=y.device)
        return torch.log(p) - torch.log1p(-p)

    return run_smc(gen, sample_prior, logprior, loglik, n_particles=n_particles, **kwargs)
