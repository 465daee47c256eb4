"""ChEES-HMC, cross-chain adaptive HMC (port of ``run_chees`` in
``gaplac_tpu/inference/chees.py``; Hoffman, Radul & Sountsov, AISTATS 2021).

All chains move in lockstep over (C, dim) for the same Halton-jittered
trajectory length, so each leapfrog is one batched density call: one
(C, n, n) gram through K2 and one batched Cholesky through K1.  The step
size follows dual averaging on the cross-chain mean acceptance; the
trajectory length follows Adam ascent on the ChEES criterion.  The scalar
adaptation state lives on the host (one device-to-host transfer per
transition); positions, momenta and the Welford mass accumulator stay on
the device.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from gaplac_tpu_torch.inference.hmc import (
    LeapfrogState,
    da_init,
    da_update,
    leapfrog_step,
    sample_momentum,
    value_and_grad,
    welford_init,
    welford_update_batch,
    welford_variance,
)


class CheesResult(NamedTuple):
    positions: torch.Tensor     # (chains, num_samples, dim)
    logps: torch.Tensor         # (chains, num_samples)
    accept_prob: torch.Tensor   # (chains, num_samples)
    step_size: float
    traj_length: float
    inv_mass: torch.Tensor


def halton(i: int, base: int = 2) -> float:
    """Element i of the Halton sequence, in float32 arithmetic as
    ``gaplac_tpu``'s ``_halton`` computes it (16 digits)."""
    r = np.float32(0.0)
    x = i + 1
    denom = np.float32(base)
    for _ in range(16):
        r = np.float32(r + np.float32(x % base) / denom)
        x //= base
        denom = np.float32(denom * base)
    return float(r)


def run_chees(
    gen: torch.Generator,
    logdensity: Callable[[torch.Tensor], torch.Tensor],
    initial_positions: torch.Tensor,   # (chains, dim)
    num_samples: int,
    num_warmup: int = 500,
    max_leapfrogs: int = 1000,
    target_accept: float = 0.651,
    init_step_size: float = 0.1,
    init_traj_length: float = 1.0,
    adam_lr: float = 0.025,
    init_inv_mass=None,
    progress: Optional[Callable[[str, int, int], None]] = None,
) -> CheesResult:
    """Batched-chain ChEES-HMC; ``logdensity`` maps (C, dim) to (C,)."""
    n_chains, dim = initial_positions.shape
    dtype, device = initial_positions.dtype, initial_positions.device
    vag = value_and_grad(logdensity)

    q = initial_positions
    logp, grad = vag(q)
    da = da_init(init_step_size)
    log_t = math.log(init_traj_length)
    adam_m = adam_v = adam_i = 0.0
    wf = welford_init(dim, dtype, device)
    inv_mass = (torch.ones((dim,), dtype=dtype, device=device) if init_inv_mass is None
                else torch.as_tensor(init_inv_mass, dtype=dtype, device=device))
    it = 0

    def transition(adapt: bool):
        nonlocal q, logp, grad, da, log_t, adam_m, adam_v, adam_i, wf, it
        eps = math.exp(da.log_eps)
        traj_j = math.exp(log_t) * halton(it) * 2.0
        n_steps = int(min(max(math.ceil(traj_j / eps), 1), max_leapfrogs))

        p0 = sample_momentum(gen, inv_mass, (n_chains, dim))
        ke0 = 0.5 * torch.sum(p0 * p0 * inv_mass, dim=1)
        st = LeapfrogState(q, p0, logp, grad)
        for _ in range(n_steps):
            st = leapfrog_step(vag, st, eps, inv_mass)
        ke1 = 0.5 * torch.sum(st.p * st.p * inv_mass, dim=1)
        log_acc = (st.logp - ke1) - (logp - ke0)
        log_acc = torch.where(torch.isnan(log_acc), torch.full_like(log_acc, -math.inf), log_acc)
        alpha = torch.clamp(torch.exp(log_acc), max=1.0)
        u = torch.rand((n_chains,), generator=gen, dtype=dtype, device=device)
        accept = torch.log(u) < log_acc
        q_prev = q
        q = torch.where(accept[:, None], st.q, q)
        logp = torch.where(accept, st.logp, logp)
        grad = torch.where(accept[:, None], st.grad, grad)

        # ChEES gradient for log T, from cross-chain means
        m1, m0 = st.q.mean(dim=0), q_prev.mean(dim=0)
        d1 = ((st.q - m1) ** 2).sum(dim=1)
        d0 = ((q_prev - m0) ** 2).sum(dim=1)
        proj = ((st.q - m1) * (st.p * inv_mass)).sum(dim=1)
        per_chain = (d1 - d0) * proj * alpha
        mean_alpha, pc_mean, pc_sq = torch.stack(
            [alpha.mean(), per_chain.mean(), (per_chain ** 2).mean()]).tolist()

        it += 1
        if adapt:
            da = da_update(da, mean_alpha, target=target_accept)
            g = pc_mean * traj_j / (math.sqrt(pc_sq + 1e-12) * traj_j + 1e-12)
            g = g if math.isfinite(g) else 0.0
            adam_i += 1.0
            adam_m = 0.9 * adam_m + 0.1 * g
            adam_v = 0.999 * adam_v + 0.001 * g * g
            mhat = adam_m / (1 - 0.9 ** adam_i)
            vhat = adam_v / (1 - 0.999 ** adam_i)
            log_t = log_t + adam_lr * mhat / (math.sqrt(vhat) + 1e-8)
            # keep T within sane bounds relative to eps
            log_t = min(max(log_t, math.log(eps)), math.log(eps * max_leapfrogs))
            # every chain's position feeds the mass estimate
            wf = welford_update_batch(wf, q)
        return q, logp, alpha

    if num_warmup > 0:
        # first half: eps/T under unit mass; midpoint: the cross-chain
        # variance becomes the mass; second half: re-adapt under it while a
        # batched Welford gathers the final mass
        h1 = num_warmup // 2
        for i in range(num_warmup):
            if i == h1:
                inv_mass = q.var(dim=0, unbiased=False) + 1e-3
                wf = welford_init(dim, dtype, device)
            transition(adapt=True)
            if progress:
                progress("warmup", i, num_warmup)
        inv_mass_final = welford_variance(wf)
        # keep the whitened step eps*sqrt(inv_mass) invariant across the swap
        ratio = math.exp(0.5 * float(torch.log(inv_mass / inv_mass_final).mean()))
        eps_final = math.exp(da.log_eps_avg) * ratio
        da = da_init(eps_final)
        inv_mass = inv_mass_final
    else:
        # checkpoint resume: the caller's step size and mass
        eps_final = float(init_step_size)

    qs, lps, alphas = [], [], []
    for i in range(num_samples):
        qi, lpi, ai = transition(adapt=False)
        qs.append(qi)
        lps.append(lpi)
        alphas.append(ai)
        if progress:
            progress("sampling", i, num_samples)
    empty = initial_positions.new_zeros
    return CheesResult(
        torch.stack(qs, dim=1) if qs else empty((n_chains, 0, dim)),
        torch.stack(lps, dim=1) if lps else empty((n_chains, 0)),
        torch.stack(alphas, dim=1) if alphas else empty((n_chains, 0)),
        eps_final,
        math.exp(log_t),
        inv_mass,
    )
