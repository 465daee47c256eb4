"""Per-point data log-likelihoods for the latent-GP path (port of
``gaplac_tpu/inference/likelihoods.py``)."""

from __future__ import annotations

import math
from typing import Callable, Optional

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


def gaussian_obs_sigma2(spec: LikelihoodSpec) -> Optional[float]:
    """Observation variance of a Gaussian likelihood, else None."""
    if spec.name != "gaussian":
        return None
    return float(spec.args[0]) if spec.args else 1.0
