"""Hyperparameter priors with their unconstraining bijectors (port of
``gaplac_tpu/inference/priors.py``).

    Uniform(lo, hi)                    logit transform on (lo, hi)  [reference]
    LogNormal(mu, sigma)               x = exp(u)
    Gamma(alpha, beta)                 shape/RATE, x = exp(u)
    TruncatedNormal(mu, sigma, lo, hi) logit transform on (lo, hi)

Each prior has forward(u), inverse(x), logprior_u(u) (log p(x(u)) +
log|dx/du|, what the samplers add) and logprior_x(x) (the constrained
log-density the chain table's ``lp`` records).
"""

from __future__ import annotations

import math
import re
from typing import NamedTuple, Sequence, Union

import torch

from gaplac_tpu_torch.inference.transforms import Interval

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


def _where_or_neginf(cond, x):
    return torch.where(cond, x, torch.full_like(x, -math.inf))


class UniformPrior(NamedTuple):
    lo: float
    hi: float

    @property
    def _tr(self) -> Interval:
        return Interval(self.lo, self.hi)

    def forward(self, u):
        return self._tr.forward(u)

    def inverse(self, x):
        return self._tr.inverse(x)

    def logprior_u(self, u):
        return -math.log(self.hi - self.lo) + self._tr.log_jac(u)

    def logprior_x(self, x):
        return self._tr.constrained_logprior(x)


class LogNormalPrior(NamedTuple):
    mu: float
    sigma: float

    def forward(self, u):
        return torch.exp(u)

    def inverse(self, x):
        return torch.log(x)

    def logprior_u(self, u):
        z = (u - self.mu) / self.sigma
        return -0.5 * z * z - math.log(self.sigma) - _LOG_SQRT_2PI

    def logprior_x(self, x):
        lx = torch.log(x)
        z = (lx - self.mu) / self.sigma
        return _where_or_neginf(x > 0, -0.5 * z * z - lx - math.log(self.sigma) - _LOG_SQRT_2PI)


class GammaPrior(NamedTuple):
    alpha: float
    beta: float

    def forward(self, u):
        return torch.exp(u)

    def inverse(self, x):
        return torch.log(x)

    def logprior_u(self, u):
        const = self.alpha * math.log(self.beta) - math.lgamma(self.alpha)
        return const + self.alpha * u - self.beta * torch.exp(u)

    def logprior_x(self, x):
        const = self.alpha * math.log(self.beta) - math.lgamma(self.alpha)
        return _where_or_neginf(x > 0, const + (self.alpha - 1.0) * torch.log(x) - self.beta * x)


class TruncatedNormalPrior(NamedTuple):
    mu: float
    sigma: float
    lo: float
    hi: float

    @property
    def _tr(self) -> Interval:
        return Interval(self.lo, self.hi)

    @property
    def _log_z(self) -> float:
        a = (self.lo - self.mu) / self.sigma
        b = (self.hi - self.mu) / self.sigma
        phi = lambda z: 0.5 * (1.0 + math.erf(z / math.sqrt(2.0)))
        return math.log(phi(b) - phi(a))

    def forward(self, u):
        return self._tr.forward(u)

    def inverse(self, x):
        return self._tr.inverse(x)

    def logprior_u(self, u):
        x = self._tr.forward(u)
        z = (x - self.mu) / self.sigma
        return (-0.5 * z * z - math.log(self.sigma) - _LOG_SQRT_2PI - self._log_z
                + self._tr.log_jac(u))

    def logprior_x(self, x):
        z = (x - self.mu) / self.sigma
        dens = -0.5 * z * z - math.log(self.sigma) - _LOG_SQRT_2PI - self._log_z
        return _where_or_neginf((x >= self.lo) & (x <= self.hi), dens)


Prior = Union[UniformPrior, LogNormalPrior, GammaPrior, TruncatedNormalPrior]

_REGISTRY = {
    "uniform": (UniformPrior, 2),
    "lognormal": (LogNormalPrior, 2),
    "gamma": (GammaPrior, 2),
    "truncatednormal": (TruncatedNormalPrior, 4),
    "truncnormal": (TruncatedNormalPrior, 4),
}

_CALL_RE = re.compile(r"\s*([A-Za-z]+)\s*\(([^)]*)\)\s*$")


def parse_prior(s: str) -> Prior:
    """Parse a ``--prior`` string like ``Uniform(0,20)``."""
    m = _CALL_RE.match(s)
    if not m:
        raise ValueError(
            f"Unsupported prior {s!r} (expected Name(args...); supported: "
            "Uniform(lo,hi), LogNormal(mu,sigma), Gamma(alpha,rate), "
            "TruncatedNormal(mu,sigma,lo,hi))"
        )
    name = m.group(1).lower()
    if name not in _REGISTRY:
        raise ValueError(
            f"Unknown prior {m.group(1)!r} (supported: Uniform, LogNormal, "
            "Gamma, TruncatedNormal)"
        )
    cls, nargs = _REGISTRY[name]
    try:
        args = [float(a) for a in m.group(2).split(",")]
    except ValueError:
        raise ValueError(f"Prior arguments must be numeric in {s!r}")
    if len(args) != nargs:
        raise ValueError(f"{m.group(1)} takes {nargs} arguments, got {len(args)}")
    prior = cls(*args)
    if isinstance(prior, (UniformPrior, TruncatedNormalPrior)) and not prior.lo < prior.hi:
        raise ValueError(f"Prior bounds must satisfy lo < hi in {s!r}")
    if isinstance(prior, (LogNormalPrior, TruncatedNormalPrior)) and prior.sigma <= 0:
        raise ValueError(f"sigma must be positive in {s!r}")
    if isinstance(prior, GammaPrior) and (prior.alpha <= 0 or prior.beta <= 0):
        raise ValueError(f"Gamma parameters must be positive in {s!r}")
    return prior


def as_prior(p: Union[Prior, Sequence[float]]) -> Prior:
    """A Prior, or the legacy (lo, hi) Uniform tuple."""
    if isinstance(p, (UniformPrior, LogNormalPrior, GammaPrior, TruncatedNormalPrior)):
        return p
    lo, hi = p
    return UniformPrior(float(lo), float(hi))
