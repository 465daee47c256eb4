"""ADVI, mean-field Gaussian variational inference (port of
``gaplac_tpu/inference/vi.py``).

The reparameterized ELBO over the model's unconstrained space, with
``num_mc`` draws a step as one batched density call (a (num_mc, n, n) gram
and factorization), maximized by Adam with optax's defaults.  The fitted
q(v) = N(mu, diag(exp(2 log_sigma))) gives pseudodraws in the same chain
schema as the samplers.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from gaplac_tpu_torch.inference.model import GPModel


class ADVIResult(NamedTuple):
    mu: torch.Tensor
    log_sigma: torch.Tensor
    elbo_trace: torch.Tensor   # (num_steps,)


class AdamState(NamedTuple):
    count: int
    mu: Tuple[torch.Tensor, ...]   # first moments, one per parameter
    nu: Tuple[torch.Tensor, ...]   # second moments


def adam_init(params) -> AdamState:
    return AdamState(0, tuple(torch.zeros_like(p) for p in params),
                     tuple(torch.zeros_like(p) for p in params))


def adam_step(params, grads, state: AdamState, learning_rate: float, b1: float = 0.9,
              b2: float = 0.999, eps: float = 1e-8, eps_root: float = 0.0):
    """One descent step of ``optax.adam`` (bias-corrected moments), in its
    order of operations: (new params, new state)."""
    count = state.count + 1
    mu = tuple((1 - b1) * g + b1 * m for g, m in zip(grads, state.mu))
    nu = tuple((1 - b2) * g * g + b2 * v for g, v in zip(grads, state.nu))
    c1, c2 = 1 - b1 ** count, 1 - b2 ** count
    new = tuple(p + -learning_rate * ((m / c1) / (torch.sqrt(v / c2 + eps_root) + eps))
                for p, m, v in zip(params, mu, nu))
    return new, AdamState(count, mu, nu)


def elbo(logdensity, mu: torch.Tensor, log_sigma: torch.Tensor,
         eps: torch.Tensor) -> torch.Tensor:
    """E_q[log p(v)] over the draws mu + exp(log_sigma) * eps (num_mc, dim),
    plus the entropy of q."""
    dim = mu.shape[0]
    logps = logdensity(mu + torch.exp(log_sigma) * eps)
    entropy = torch.sum(log_sigma) + 0.5 * dim * (1.0 + math.log(2 * math.pi))
    return torch.mean(logps) + entropy


def run_advi(
    gen: torch.Generator,
    model: GPModel,
    num_steps: int = 1000,
    num_mc: int = 8,
    learning_rate: float = 0.05,
) -> ADVIResult:
    """Maximize ELBO(mu, log_sigma) = E_q[log p(v)] + H[q] from mu at the
    model's initial position and log_sigma = -1."""
    mu = model.initial_position(gen, 1)[0]
    ls = torch.full_like(mu, -1.0)
    state = adam_init((mu, ls))
    trace = []
    for _ in range(num_steps):
        eps = torch.randn((num_mc, mu.shape[0]), generator=gen, dtype=mu.dtype,
                          device=mu.device)
        with torch.enable_grad():
            params = (mu.requires_grad_(True), ls.requires_grad_(True))
            val = -elbo(model.logdensity, *params, eps)
            grads = torch.autograd.grad(val, params)
        (mu, ls), state = adam_step((mu.detach(), ls.detach()), grads, state, learning_rate)
        trace.append(-val.detach())
    empty = mu.new_zeros((0,))
    return ADVIResult(mu, ls, torch.stack(trace) if trace else empty)


def sample_posterior(gen: torch.Generator, result: ADVIResult, num_samples: int) -> torch.Tensor:
    """(num_samples, dim) pseudodraws from the fitted q."""
    mu = result.mu
    eps = torch.randn((num_samples, mu.shape[0]), generator=gen, dtype=mu.dtype,
                      device=mu.device)
    return mu + torch.exp(result.log_sigma) * eps
