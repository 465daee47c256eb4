"""Per-point data log-likelihoods for the latent-GP path (port of
``gaplac_tpu/inference/likelihoods.py``)."""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch

from gaplac_tpu_torch.dsl.parser import LikelihoodSpec

_LOG_2PI = math.log(2.0 * math.pi)


def _logaddexp0(f):
    return torch.logaddexp(f, torch.zeros_like(f))


def gaussian_loglik(y, f, sigma2):
    return -0.5 * ((y - f) ** 2 / sigma2 + math.log(sigma2) + _LOG_2PI)


def bernoulli_logit_loglik(y, f, _=None):
    """y in {0,1}; f the logit."""
    return y * f - _logaddexp0(f)


def poisson_log_loglik(y, f, _=None):
    """y a count; f the log-rate."""
    return y * f - torch.exp(f) - torch.lgamma(y + 1.0)


def studentt_loglik(y, f, nu, sigma=1.0):
    z = (y - f) / sigma
    return (math.lgamma((nu + 1.0) / 2.0) - math.lgamma(nu / 2.0)
            - 0.5 * math.log(nu * math.pi) - math.log(sigma)
            - (nu + 1.0) / 2.0 * torch.log1p(z * z / nu))


def binomial_logit_loglik(y, f, n):
    """y successes of n trials; f the logit."""
    return (torch.lgamma(n + 1.0) - torch.lgamma(y + 1.0) - torch.lgamma(n - y + 1.0)
            + y * f - n * _logaddexp0(f))


def make_loglik(spec: LikelihoodSpec) -> Callable[..., torch.Tensor]:
    """``(y, f, aux) -> per-point loglik`` for a parsed likelihood; ``aux``
    carries a column-valued parameter (Binomial trials)."""
    name = spec.name
    if name == "gaussian":
        sigma2 = float(spec.args[0]) if spec.args else 1.0
        return lambda y, f, aux=None: gaussian_loglik(y, f, sigma2)
    if name == "bernoulli":
        return lambda y, f, aux=None: bernoulli_logit_loglik(y, f)
    if name == "poisson":
        return lambda y, f, aux=None: poisson_log_loglik(y, f)
    if name == "studentt":
        nu = float(spec.args[0]) if spec.args else 4.0
        sigma = float(spec.args[1]) if len(spec.args) > 1 else 1.0
        return lambda y, f, aux=None: studentt_loglik(y, f, nu, sigma)
    if name == "binomial":
        return lambda y, f, aux=None: binomial_logit_loglik(y, f, aux)
    raise ValueError(f"Unknown likelihood {name!r}")


def make_loglik_derivs(spec: LikelihoodSpec) -> Callable[..., Tuple[torch.Tensor, torch.Tensor]]:
    """``(y, f, aux) -> (d/df, d^2/df^2)`` of the per-point loglik, in closed
    form: what ``gaplac_tpu`` takes with ``jax.grad`` and
    ``jax.grad(jax.grad(.))`` per point.  They are plain tensor expressions,
    so autograd differentiates them once more where the Laplace marginal's
    gradient needs the third derivative."""
    name = spec.name
    if name == "gaussian":
        sigma2 = float(spec.args[0]) if spec.args else 1.0
        return lambda y, f, aux=None: ((y - f) / sigma2, torch.full_like(f, -1.0 / sigma2))
    if name in ("bernoulli", "binomial"):
        def logit(y, f, aux=None):
            s = torch.sigmoid(f)
            trials = 1.0 if name == "bernoulli" else aux
            return y - trials * s, -trials * s * (1.0 - s)
        return logit
    if name == "poisson":
        def log_rate(y, f, aux=None):
            rate = torch.exp(f)
            return y - rate, -rate
        return log_rate
    if name == "studentt":
        nu = float(spec.args[0]) if spec.args else 4.0
        sigma = float(spec.args[1]) if len(spec.args) > 1 else 1.0
        s2nu = nu * sigma * sigma

        def studentt(y, f, aux=None):
            r = y - f
            d = s2nu + r * r
            return (nu + 1.0) * r / d, -(nu + 1.0) * (s2nu - r * r) / (d * d)
        return studentt
    raise ValueError(f"Unknown likelihood {name!r}")


def gaussian_obs_sigma2(spec: LikelihoodSpec) -> Optional[float]:
    """Observation variance of a Gaussian likelihood, else None."""
    if spec.name != "gaussian":
        return None
    return float(spec.args[0]) if spec.args else 1.0
