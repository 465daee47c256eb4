"""ChEES-HMC, cross-chain adaptive HMC, and fixed-trajectory HMC (port of
``gaplac_tpu/inference/chees.py``; Hoffman, Radul & Sountsov, AISTATS 2021).

All chains move in lockstep over (C, dim) for the same Halton-jittered
trajectory length, so each leapfrog is one batched density call: one
(C, n, n) gram through K2 and one batched Cholesky through K1.  The step
size follows dual averaging on the cross-chain mean acceptance; the
trajectory length follows Adam ascent on the ChEES criterion.  The scalar
adaptation state lives on the host (one device-to-host transfer per
transition); positions, momenta and the Welford mass accumulator stay on
the device.

``run_hmc`` runs the same lockstep chains for a fixed number of leapfrogs
a transition, with the step size jittered by a Halton draw in [0.8, 1.2);
its transition is a function of ``HmcCarry``, the whole chain state (the
generator included), which ``run_hmc`` threads through segments of any size
(``--segments``) and draws the same numbers.

With a "chains" ``mesh`` (``parallel/mesh.py``), ``run_chees`` and
``run_hmc`` take this rank's slice of the chains and return this rank's
draws, with the adaptation of all of them, as if computed on the whole
batch: every rank holds the same generator, draws the whole batch's momenta
and uniforms and keeps its own rows, and the per-chain vectors the
cross-chain statistics read (positions, proposals, p M^-1, acceptance) are
all-gathered once a warmup transition, so every mean, variance and Welford
fold runs on the whole (C, dim) batch in the unsharded order.  The log
density, the expensive part, stays on the rank's own chains.  Without a
mesh nothing is gathered.
"""

from __future__ import annotations

import logging
import math
import time
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from gaplac_tpu_torch.inference.hmc import (
    DualAveragingState,
    LeapfrogState,
    WelfordState,
    da_init,
    da_update,
    leapfrog_step,
    sample_momentum,
    value_and_grad,
    welford_init,
    welford_update_batch,
    welford_variance,
)
from gaplac_tpu_torch.inference.progress import progress_emitter
from gaplac_tpu_torch.parallel.mesh import Mesh, gather_chain_axis

log = logging.getLogger("gaplac")


def _rows(mesh: Optional[Mesh], n_local: int) -> slice:
    """This rank's rows of a draw over the whole batch: all of them without
    a mesh."""
    return slice(None) if mesh is None else slice(mesh.rank * n_local, (mesh.rank + 1) * n_local)


def _gathered(mesh: Optional[Mesh], *xs: torch.Tensor) -> tuple:
    """Each (C_local, ...) chain tensor over the whole batch: ``xs``
    themselves without a mesh; with one, all of them in one all-gather,
    returned contiguous."""
    if mesh is None:
        return xs
    cols = [x.reshape(x.shape[0], -1) for x in xs]
    whole = gather_chain_axis(torch.cat(cols, dim=1), mesh)
    parts = whole.split([c.shape[1] for c in cols], dim=1)
    return tuple(w.reshape(-1, *x.shape[1:]).contiguous() for w, x in zip(parts, xs))


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


def accept_uniform(gen: torch.Generator, n_chains: int, like: torch.Tensor) -> torch.Tensor:
    """One U(0, 1) a chain for the Metropolis test, in ``like``'s dtype and
    on its device."""
    return torch.rand((n_chains,), generator=gen, dtype=like.dtype, device=like.device)


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
    progress: bool = False,
    mesh: Optional[Mesh] = None,
) -> CheesResult:
    """Batched-chain ChEES-HMC; ``logdensity`` maps (C, dim) to (C,).  With
    a ``mesh``, ``initial_positions`` and the result's arrays are this
    rank's chains."""
    n_local, dim = initial_positions.shape
    n_chains = n_local if mesh is None else n_local * mesh.size
    rows = _rows(mesh, n_local)
    dtype, device = initial_positions.dtype, initial_positions.device
    vag = value_and_grad(logdensity)

    q = initial_positions
    (q_all,) = _gathered(mesh, q)  # every chain's position, for the statistics
    logp, grad = vag(q)
    da = da_init(init_step_size)
    log_t = math.log(init_traj_length)
    adam_m = adam_v = adam_i = 0.0
    wf = welford_init(dim, dtype, device)
    inv_mass = (torch.ones((dim,), dtype=dtype, device=device) if init_inv_mass is None
                else torch.as_tensor(init_inv_mass, dtype=dtype, device=device))
    it = 0
    warm_progress = progress_emitter("warmup", num_warmup, progress)
    samp_progress = progress_emitter("sampling", num_samples, progress)

    def transition(adapt: bool):
        nonlocal q, q_all, logp, grad, da, log_t, adam_m, adam_v, adam_i, wf, it
        eps = math.exp(da.log_eps)
        traj_j = math.exp(log_t) * halton(it) * 2.0
        n_steps = int(min(max(math.ceil(traj_j / eps), 1), max_leapfrogs))

        p0 = sample_momentum(gen, inv_mass, (n_chains, dim))[rows]
        ke0 = 0.5 * torch.sum(p0 * p0 * inv_mass, dim=1)
        st = LeapfrogState(q, p0, logp, grad)
        for _ in range(n_steps):
            st = leapfrog_step(vag, st, eps, inv_mass)
        ke1 = 0.5 * torch.sum(st.p * st.p * inv_mass, dim=1)
        log_acc = (st.logp - ke1) - (logp - ke0)
        log_acc = torch.where(torch.isnan(log_acc), torch.full_like(log_acc, -math.inf), log_acc)
        alpha = torch.clamp(torch.exp(log_acc), max=1.0)
        u = accept_uniform(gen, n_chains, q)[rows]
        accept = torch.log(u) < log_acc
        q = torch.where(accept[:, None], st.q, q)
        logp = torch.where(accept, st.logp, logp)
        grad = torch.where(accept[:, None], st.grad, grad)

        it += 1
        if adapt:
            # ChEES gradient for log T, from cross-chain means over every chain
            q_prev = q_all
            q1, v1, alpha_all, q_all = _gathered(mesh, st.q, st.p * inv_mass, alpha, q)
            m1, m0 = q1.mean(dim=0), q_prev.mean(dim=0)
            d1 = ((q1 - m1) ** 2).sum(dim=1)
            d0 = ((q_prev - m0) ** 2).sum(dim=1)
            proj = ((q1 - m1) * v1).sum(dim=1)
            per_chain = (d1 - d0) * proj * alpha_all
            mean_alpha, pc_mean, pc_sq = torch.stack(
                [alpha_all.mean(), per_chain.mean(), (per_chain ** 2).mean()]).tolist()
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
            wf = welford_update_batch(wf, q_all)
        return q, logp, alpha

    if num_warmup > 0:
        # first half: eps/T under unit mass; midpoint: the cross-chain
        # variance becomes the mass; second half: re-adapt under it while a
        # batched Welford gathers the final mass
        h1 = num_warmup // 2
        for i in range(num_warmup):
            if i == h1:
                inv_mass = q_all.var(dim=0, unbiased=False) + 1e-3
                wf = welford_init(dim, dtype, device)
            transition(adapt=True)
            warm_progress(i)
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
        samp_progress(i)
    empty = initial_positions.new_zeros
    return CheesResult(
        torch.stack(qs, dim=1) if qs else empty((n_local, 0, dim)),
        torch.stack(lps, dim=1) if lps else empty((n_local, 0)),
        torch.stack(alphas, dim=1) if alphas else empty((n_local, 0)),
        eps_final,
        math.exp(log_t),
        inv_mass,
    )


# ---------------------------------------------------------------------------
# fixed-trajectory HMC (gaplac_tpu/inference/chees.py:288-480)
# ---------------------------------------------------------------------------


class HmcResult(NamedTuple):
    positions: torch.Tensor     # (chains, num_samples, dim)
    logps: torch.Tensor         # (chains, num_samples)
    accept_prob: torch.Tensor   # (chains, num_samples)
    step_size: float
    inv_mass: torch.Tensor


class HmcCarry(NamedTuple):
    """The whole between-transition state of the lockstep chains: the
    generator the transitions draw from (its state is the chain's random
    stream; ``gen.get_state()`` snapshots it), positions with their log
    density and gradient, the dual-averaging and Welford accumulators, the
    mass and the transition count.  Any loop that threads it through
    ``hmc_transition_factory``'s transition draws the same numbers."""

    gen: torch.Generator
    q: torch.Tensor
    logp: torch.Tensor
    grad: torch.Tensor
    da: DualAveragingState
    wf: WelfordState
    inv_mass: torch.Tensor
    iter: int


def step_jitter(i: int) -> float:
    """0.8 + 0.4 * halton(i) in float32, as ``gaplac_tpu``'s compiled
    transition computes it on the CPU: its Halton draw is float32, and XLA
    contracts the product and the sum into one fused multiply-add, so the
    result is rounded to float32 once."""
    fused = float(np.float32(0.4)) * float(np.float32(halton(i))) + float(np.float32(0.8))
    return float(np.float32(fused))


def hmc_transition_factory(
    logdensity: Callable[[torch.Tensor], torch.Tensor],
    n_chains: int,
    dim: int,
    num_leapfrogs: int,
    target_accept: float = 0.651,
    mesh: Optional[Mesh] = None,
):
    """One fixed-trajectory lockstep HMC transition (``num_leapfrogs``
    batched leapfrogs at a Halton-jittered step, pooled dual averaging and
    a batched Welford fold while adapting) as a function of ``HmcCarry``.
    ``n_chains`` counts every chain; with a ``mesh`` the carry holds this
    rank's.  Returns (transition, batched value_and_grad)."""
    vag = value_and_grad(logdensity)
    rows = _rows(mesh, n_chains if mesh is None else n_chains // mesh.size)

    def transition(c: HmcCarry, adapt: bool):
        # mild multiplicative jitter decorrelates the fixed trajectory
        # length from the target's periods (Neal 2011, section 3.2)
        eps = math.exp(c.da.log_eps) * step_jitter(c.iter)
        p0 = sample_momentum(c.gen, c.inv_mass, (n_chains, dim))[rows]
        ke0 = 0.5 * torch.sum(p0 * p0 * c.inv_mass, dim=1)
        st = LeapfrogState(c.q, p0, c.logp, c.grad)
        for _ in range(num_leapfrogs):
            st = leapfrog_step(vag, st, eps, c.inv_mass)
        ke1 = 0.5 * torch.sum(st.p * st.p * c.inv_mass, dim=1)
        log_acc = (st.logp - ke1) - (c.logp - ke0)
        log_acc = torch.where(torch.isnan(log_acc), torch.full_like(log_acc, -math.inf), log_acc)
        alpha = torch.clamp(torch.exp(log_acc), max=1.0)
        accept = torch.log(accept_uniform(c.gen, n_chains, c.q)[rows]) < log_acc
        q = torch.where(accept[:, None], st.q, c.q)
        logp = torch.where(accept, st.logp, c.logp)
        grad = torch.where(accept[:, None], st.grad, c.grad)
        new = c._replace(q=q, logp=logp, grad=grad, iter=c.iter + 1)
        if adapt:
            alpha_all, q_all = _gathered(mesh, alpha, q)
            new = new._replace(da=da_update(c.da, float(alpha_all.mean()), target=target_accept),
                               wf=welford_update_batch(c.wf, q_all))
        return new, (q, logp, alpha)

    return transition, vag


def hmc_init_carry(vag, gen: torch.Generator, initial_positions: torch.Tensor,
                   init_step_size: float, init_inv_mass=None) -> HmcCarry:
    """The sampler's first ``HmcCarry``."""
    q = initial_positions
    dim, dtype, device = q.shape[1], q.dtype, q.device
    logp0, grad0 = vag(q)
    inv_mass = (torch.ones((dim,), dtype=dtype, device=device) if init_inv_mass is None
                else torch.as_tensor(init_inv_mass, dtype=dtype, device=device))
    return HmcCarry(gen, q, logp0, grad0, da_init(float(init_step_size)),
                    welford_init(dim, dtype, device), inv_mass, 0)


def hmc_midpoint_update(carry: HmcCarry, h1: int, mesh: Optional[Mesh] = None) -> HmcCarry:
    """The warmup midpoint: the cross-chain variance (over every chain of the
    mesh) becomes the mass, the Welford accumulator restarts, and dual
    averaging restarts at its averaged step (unless the first half was
    empty)."""
    (q_all,) = _gathered(mesh, carry.q)
    var = q_all.var(dim=0, unbiased=False) + 1e-3
    da = da_init(math.exp(carry.da.log_eps_avg)) if h1 >= 1 else carry.da
    wf = welford_init(carry.q.shape[1], carry.q.dtype, carry.q.device)
    return carry._replace(inv_mass=var, wf=wf, da=da)


def hmc_finalize_adaptation(carry: HmcCarry) -> Tuple[HmcCarry, float]:
    """After warmup: the Welford mass, and the averaged step rescaled for
    the mass change (eps * sqrt(old / new), geometric mean over dims).  It
    reads only the adaptation state, which is the same on every rank of a
    mesh."""
    inv_mass_final = welford_variance(carry.wf)
    ratio = math.exp(0.5 * float(torch.log(carry.inv_mass / inv_mass_final).mean()))
    eps_final = math.exp(carry.da.log_eps_avg) * ratio
    return carry._replace(da=da_init(eps_final), inv_mass=inv_mass_final), eps_final


def run_hmc(
    gen: torch.Generator,
    logdensity: Callable[[torch.Tensor], torch.Tensor],
    initial_positions: torch.Tensor,   # (chains, dim)
    num_samples: int,
    num_warmup: int = 500,
    num_leapfrogs: int = 32,
    target_accept: float = 0.651,
    init_step_size: float = 0.1,
    init_inv_mass=None,
    progress: bool = False,
    segment_size: Optional[int] = None,
    checkpoint_cb: Optional[Callable[[dict], None]] = None,
    mesh: Optional[Mesh] = None,
) -> HmcResult:
    """Batched-chain fixed-trajectory HMC: ``num_leapfrogs`` leapfrogs a
    transition, each one batched density call over the chains.  Warmup as
    ``run_chees``: unit mass while the step finds its scale, the cross-chain
    variance as the mass at the midpoint, then re-adaptation under it while
    a batched Welford gathers the final mass.

    Each phase (warmup, sampling) is driven in segments of ``segment_size``
    transitions, one segment when it is None; the segments thread the same
    ``HmcCarry`` through the same transition, so the draws do not depend on
    the segment size.  ``checkpoint_cb(state)`` is called after each
    sampling segment with the latest ``positions`` (chains, dim),
    ``step_size`` and ``inv_mass`` (numpy and float); with a ``mesh``,
    ``initial_positions`` and the result's arrays are this rank's chains and
    the checkpoint's positions every chain's."""
    if segment_size is not None and segment_size < 1:
        raise ValueError(f"segment_size must be >= 1, got {segment_size}")
    n_local, dim = initial_positions.shape
    n_chains = n_local if mesh is None else n_local * mesh.size
    transition, vag = hmc_transition_factory(logdensity, n_chains, dim, num_leapfrogs,
                                             target_accept, mesh)
    carry = hmc_init_carry(vag, gen, initial_positions, init_step_size, init_inv_mass)

    def drive(carry: HmcCarry, phase: str, n_steps: int, adapt: bool, outs=None):
        emit = progress_emitter(phase, n_steps, progress)
        size, t0 = segment_size or n_steps, time.time()
        for i in range(n_steps):
            if adapt and i == n_steps // 2:
                carry = hmc_midpoint_update(carry, i, mesh)
            carry, out = transition(carry, adapt)
            emit(i)
            if outs is not None:
                outs.append(out)
            done = i + 1
            if done % size and done < n_steps:
                continue
            # the end of a segment
            if outs is not None and checkpoint_cb is not None:
                checkpoint_cb({"positions": _gathered(mesh, carry.q)[0].cpu().numpy(),
                               "step_size": math.exp(carry.da.log_eps),
                               "inv_mass": carry.inv_mass.cpu().numpy()})
            if segment_size and progress:
                log.info("segmented hmc %s: %d/%d transitions (%.1f tr/s)", phase, done,
                         n_steps, done * n_chains / max(time.time() - t0, 1e-9))
        return carry

    eps_final = float(init_step_size)
    if num_warmup > 0:
        carry = drive(carry, "warmup", num_warmup, True)
        carry, eps_final = hmc_finalize_adaptation(carry)
    outs = []
    carry = drive(carry, "sampling", num_samples, False, outs)
    if not outs:
        empty = initial_positions.new_zeros
        return HmcResult(empty((n_local, 0, dim)), empty((n_local, 0)), empty((n_local, 0)),
                         eps_final, carry.inv_mass)
    qs, logps, alphas = (torch.stack(t, dim=1) for t in zip(*outs))
    return HmcResult(qs, logps, alphas, eps_final, carry.inv_mass)
