"""Unconstraining bijectors (port of ``gaplac_tpu/inference/transforms.py``).

The samplers run in unconstrained space u; the model maps u to the
constrained value and adds the prior log-density plus the log-Jacobian.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


def softplus(u: torch.Tensor) -> torch.Tensor:
    """log(1 + e^u), exact at every u (``jax.nn.softplus``)."""
    return torch.logaddexp(u, torch.zeros_like(u))


class Interval(NamedTuple):
    """x in (lo, hi) <-> u in R via x = lo + (hi-lo) sigmoid(u)."""

    lo: float
    hi: float

    def forward(self, u):
        return self.lo + (self.hi - self.lo) * torch.sigmoid(u)

    def inverse(self, x):
        # clamp away from the bounds: float32 chains can record draws exactly
        # at lo/hi (sigmoid saturation), which would invert to +-inf
        p = (x - self.lo) / (self.hi - self.lo)
        p = torch.clamp(p, 1e-7, 1.0 - 1e-7)
        return torch.log(p) - torch.log1p(-p)

    def log_jac(self, u):
        return math.log(self.hi - self.lo) - softplus(u) - softplus(-u)

    def constrained_logprior(self, x):
        """log Uniform(lo, hi) at the constrained value, closed interval."""
        inside = (x >= self.lo) & (x <= self.hi)
        return torch.where(inside, torch.full_like(x, -math.log(self.hi - self.lo)),
                           torch.full_like(x, -math.inf))
