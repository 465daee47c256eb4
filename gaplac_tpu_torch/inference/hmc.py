"""HMC machinery: leapfrog, dual-averaging step size, Welford mass
adaptation, Stan's warmup schedule (port of ``gaplac_tpu/inference/hmc.py``).

Tensors carry the positions (any leading batch shape over a trailing
``dim``); the scalar adaptation state (dual averaging, counts) lives on the
host as Python floats, since the samplers decide on it in Python loops.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch


class LeapfrogState(NamedTuple):
    q: torch.Tensor       # position
    p: torch.Tensor       # momentum
    logp: torch.Tensor    # logdensity(q)
    grad: torch.Tensor    # d logdensity / d q


def value_and_grad(logdensity: Callable[[torch.Tensor], torch.Tensor]):
    """q (..., dim) -> (logdensity(q), its gradient in q); batch members
    must not interact, so the gradient of the sum is each one's own."""

    def vag(q: torch.Tensor):
        with torch.enable_grad():
            qr = q.detach().requires_grad_(True)
            lp = logdensity(qr)
            (g,) = torch.autograd.grad(lp.sum(), qr)
        return lp.detach(), g

    return vag


def leapfrog_step(value_and_grad: Callable, state: LeapfrogState, eps,
                  inv_mass: torch.Tensor) -> LeapfrogState:
    """One leapfrog step with a diagonal mass matrix."""
    p_half = state.p + 0.5 * eps * state.grad
    q_new = state.q + eps * inv_mass * p_half
    logp_new, grad_new = value_and_grad(q_new)
    p_new = p_half + 0.5 * eps * grad_new
    return LeapfrogState(q_new, p_new, logp_new, grad_new)


def kinetic_energy(p: torch.Tensor, inv_mass: torch.Tensor) -> torch.Tensor:
    return 0.5 * torch.sum(p * p * inv_mass, dim=-1)


def sample_momentum(gen: torch.Generator, inv_mass: torch.Tensor, shape=None) -> torch.Tensor:
    """p ~ N(0, M) with M = diag(1/inv_mass)."""
    shape = inv_mass.shape if shape is None else shape
    z = torch.randn(shape, generator=gen, dtype=inv_mass.dtype, device=inv_mass.device)
    return z * torch.rsqrt(inv_mass)


# ---------------------------------------------------------------------------
# Dual averaging (Hoffman & Gelman 2014, Algorithm 5; Stan defaults)
# ---------------------------------------------------------------------------


class DualAveragingState(NamedTuple):
    log_eps: float
    log_eps_avg: float
    h_avg: float
    mu: float
    count: float


def da_init(eps0: float) -> DualAveragingState:
    log_eps = math.log(eps0)
    return DualAveragingState(log_eps, 0.0, 0.0, math.log(10.0) + log_eps, 0.0)


def da_update(state: DualAveragingState, accept_prob: float, target: float = 0.65,
              gamma: float = 0.05, t0: float = 10.0, kappa: float = 0.75) -> DualAveragingState:
    count = state.count + 1.0
    eta_h = 1.0 / (count + t0)
    h_avg = (1.0 - eta_h) * state.h_avg + eta_h * (target - accept_prob)
    log_eps = state.mu - math.sqrt(count) / gamma * h_avg
    eta_x = count ** (-kappa)
    log_eps_avg = eta_x * log_eps + (1.0 - eta_x) * state.log_eps_avg
    return DualAveragingState(log_eps, log_eps_avg, h_avg, state.mu, count)


# ---------------------------------------------------------------------------
# Welford running variance (diagonal mass estimation)
# ---------------------------------------------------------------------------


class WelfordState(NamedTuple):
    mean: torch.Tensor
    m2: torch.Tensor
    count: float


def welford_init(dim: int, dtype=torch.float64, device=None) -> WelfordState:
    z = torch.zeros((dim,), dtype=dtype, device=device)
    return WelfordState(z, z, 0.0)


def welford_update(state: WelfordState, x: torch.Tensor) -> WelfordState:
    count = state.count + 1.0
    delta = x - state.mean
    mean = state.mean + delta / count
    m2 = state.m2 + delta * (x - mean)
    return WelfordState(mean, m2, count)


def welford_update_batch(state: WelfordState, X: torch.Tensor) -> WelfordState:
    """Fold a (chains, dim) batch into the accumulator (Chan's parallel
    combination of the batch's own mean/M2 with the running state)."""
    c = X.shape[0]
    bmean = X.mean(dim=0)
    bm2 = ((X - bmean) ** 2).sum(dim=0)
    n0 = state.count
    n = n0 + c
    delta = bmean - state.mean
    mean = state.mean + delta * (c / n)
    m2 = state.m2 + bm2 + delta * delta * (n0 * c / n)
    return WelfordState(mean, m2, n)


def welford_variance(state: WelfordState) -> torch.Tensor:
    """Regularized sample variance (Stan's shrinkage toward unit)."""
    if state.count <= 1.0:
        return torch.ones_like(state.m2)
    n = state.count
    var = state.m2 / max(n - 1.0, 1.0)
    return (n / (n + 5.0)) * var + 1e-3 * (5.0 / (n + 5.0))


# ---------------------------------------------------------------------------
# Reasonable initial step size (Hoffman & Gelman 2014, Algorithm 4)
# ---------------------------------------------------------------------------


def find_reasonable_step_size(value_and_grad: Callable, gen: torch.Generator, q: torch.Tensor,
                              inv_mass: torch.Tensor, init_eps: float = 1.0,
                              max_iters: int = 60) -> float:
    """Double or halve eps until one leapfrog's acceptance crosses 1/2; q is
    one chain's position (dim,)."""
    logp0, grad0 = value_and_grad(q)
    p0 = sample_momentum(gen, inv_mass)
    h0 = float(-logp0 + kinetic_energy(p0, inv_mass))
    start = LeapfrogState(q, p0, logp0, grad0)

    def joint_delta(eps):
        st = leapfrog_step(value_and_grad, start, eps, inv_mass)
        d = h0 - float(-st.logp + kinetic_energy(st.p, inv_mass))
        return -math.inf if math.isnan(d) else d

    eps = float(init_eps)
    direction = 1.0 if joint_delta(eps) > math.log(0.5) else -1.0
    it = 0
    while it < max_iters:
        d = joint_delta(eps)
        keep = d > math.log(0.5) if direction > 0 else d < math.log(0.5)
        if not keep:
            break
        eps *= 2.0 if direction > 0 else 0.5
        it += 1
    return eps


# ---------------------------------------------------------------------------
# Stan-style warmup schedule
# ---------------------------------------------------------------------------


class WarmupSchedule(NamedTuple):
    """Per-warmup-step flags: update the mass accumulator; end of a window
    (swap in the new mass, restart the step-size adaptation)."""

    in_slow_window: np.ndarray   # bool (num_warmup,)
    window_end: np.ndarray       # bool (num_warmup,)


def stan_warmup_schedule(num_warmup: int, init_buffer: int = 75, term_buffer: int = 50,
                         base_window: int = 25) -> WarmupSchedule:
    in_slow = np.zeros(num_warmup, bool)
    w_end = np.zeros(num_warmup, bool)
    if num_warmup < 20:
        return WarmupSchedule(in_slow, w_end)
    if num_warmup < init_buffer + term_buffer + base_window:
        scale = num_warmup / (init_buffer + term_buffer + base_window)
        init_buffer = int(init_buffer * scale)
        term_buffer = int(term_buffer * scale)
        base_window = num_warmup - init_buffer - term_buffer
    pos = init_buffer
    window = base_window
    last_slow = num_warmup - term_buffer
    while pos < last_slow:
        end = pos + window
        if end + 2 * window > last_slow:  # absorb the remainder into this window
            end = last_slow
        in_slow[pos:end] = True
        w_end[end - 1] = True
        pos = end
        window *= 2
    return WarmupSchedule(in_slow, w_end)
