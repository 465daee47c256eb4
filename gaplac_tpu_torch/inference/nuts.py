"""Iterative NUTS with multinomial sampling, dual-averaging step size and
diagonal mass adaptation (port of ``gaplac_tpu/inference/nuts.py``).

Same algorithm as ``gaplac_tpu``: each transition doubles a trajectory until
a U-turn, a divergence or ``max_depth``; each doubling integrates its 2^depth
leaves in a loop; sub-U-turns use the O(max_depth) checkpoint scheme (even
leaf i stores at slot popcount(i); odd leaf i with t trailing ones checks
slots [popcount(i) - t, popcount(i) - 1]).  The loops are Python loops
where JAX used ``while_loop``: positions, momenta and gradients stay on the
device, while each leaf's energy and U-turn dot products come to the host
in one transfer for the branch.  Host decisions (direction, multinomial
picks) draw from a CPU ``torch.Generator`` seeded from the caller's.
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
    find_reasonable_step_size,
    kinetic_energy,
    leapfrog_step,
    sample_momentum,
    stan_warmup_schedule,
    value_and_grad,
    welford_init,
    welford_update,
    welford_variance,
)
from gaplac_tpu_torch.inference.progress import progress_emitter

DIVERGENCE_THRESHOLD = 1000.0  # Stan's default energy-error cutoff


class NUTSInfo(NamedTuple):
    accept_prob: float   # mean leaf acceptance statistic
    depth: int           # completed doublings
    diverging: bool
    energy: float        # H at transition start
    num_steps: int       # leapfrog steps taken


def _popcount(i: int) -> int:
    return bin(i).count("1")


def host_generator(gen: torch.Generator) -> torch.Generator:
    """A CPU generator for host-side decisions, seeded from ``gen``."""
    seed = int(torch.randint(0, 2**62, (1,), generator=gen, device=gen.device).item())
    return torch.Generator().manual_seed(seed)


def make_nuts_kernel(logdensity: Callable[[torch.Tensor], torch.Tensor], max_depth: int = 10,
                     divergence_threshold: float = DIVERGENCE_THRESHOLD):
    """``step(gen, host, lf, step_size, inv_mass) -> (lf', NUTSInfo)`` for one
    chain; ``logdensity`` maps q (dim,) to a scalar.  ``lf``'s momentum is
    ignored (fresh momentum each transition); logp/grad are carried."""
    vag = value_and_grad(logdensity)

    def uniform(host):
        return float(torch.rand((), generator=host, dtype=torch.float64))

    def build_subtree(host, start, depth, d, eps, inv_mass, h0):
        """Integrate 2^depth leaves from ``start`` in direction d (+-1)."""
        dim = start.q.shape[0]
        ckpt_q = start.q.new_zeros((max_depth, dim))
        ckpt_v = start.q.new_zeros((max_depth, dim))
        prop = start
        logw, turning, diverging = -math.inf, False, False
        sum_acc, num_acc = 0.0, 0
        cur = start
        i = 0
        while i < (1 << depth) and not turning and not diverging:
            new = leapfrog_step(vag, cur, eps * d, inv_mass)
            v = inv_mass * new.p
            pc = _popcount(i)
            scalars = [-new.logp + kinetic_energy(new.p, inv_mass)]
            if i % 2 == 0:
                slot = min(pc, max_depth - 1)
                ckpt_q[slot] = new.q
                ckpt_v[slot] = v
            else:
                t_ones = _popcount(i ^ (i + 1)) - 1
                lo, hi = max(pc - t_ones, 0), min(pc - 1, max_depth - 1)
                dqs = (new.q[None, :] - ckpt_q[lo:hi + 1]) * d
                scalars += [(ckpt_v[lo:hi + 1] * dqs).sum(-1), dqs @ v]
            host_vals = torch.cat([s.reshape(-1) for s in scalars]).tolist()
            h = host_vals[0]
            if math.isnan(h):
                h = math.inf
            turning = any(x < 0 for x in host_vals[1:])
            diverging = (h - h0) > divergence_threshold
            logw_leaf = -h
            logw_new = float(np.logaddexp(logw, logw_leaf))
            if math.log(uniform(host)) < logw_leaf - logw_new:
                prop = new
            sum_acc += min(1.0, math.exp(min(0.0, h0 - h)))
            num_acc += 1
            logw = logw_new
            cur = new
            i += 1
        return cur, prop, logw, turning, diverging, sum_acc, num_acc

    def step(gen, host, lf: LeapfrogState, step_size: float, inv_mass: torch.Tensor):
        p0 = sample_momentum(gen, inv_mass)
        h0 = float(-lf.logp + kinetic_energy(p0, inv_mass))
        start = LeapfrogState(lf.q, p0, lf.logp, lf.grad)
        left = right = prop = start
        logw = -h0
        depth, turning, diverging = 0, False, False
        sum_acc, num_acc = 0.0, 0
        while depth < max_depth and not turning and not diverging:
            d = 1.0 if uniform(host) < 0.5 else -1.0
            fwd = d > 0
            end, sprop, slogw, sturn, sdiv, sacc, snum = build_subtree(
                host, right if fwd else left, depth, d, step_size, inv_mass, h0)
            invalid = sturn or sdiv
            # biased progressive sampling at the doubling level
            take = math.log(uniform(host)) < slogw - logw
            if take and not invalid:
                prop = sprop
            if not invalid:
                logw = float(np.logaddexp(logw, slogw))
                if fwd:
                    right = end
                else:
                    left = end
            # whole-trajectory U-turn check
            dq = right.q - left.q
            dots = torch.stack([(inv_mass * left.p) @ dq, (inv_mass * right.p) @ dq]).tolist()
            traj_turn = dots[0] < 0 or dots[1] < 0
            depth += 1
            turning = sturn or (not invalid and traj_turn)
            diverging = sdiv
            sum_acc += sacc
            num_acc += snum
        accept = sum_acc / max(num_acc, 1)
        new_lf = LeapfrogState(prop.q, p0, prop.logp, prop.grad)
        return new_lf, NUTSInfo(accept, depth, diverging, h0, num_acc)

    return step


class NUTSResult(NamedTuple):
    positions: torch.Tensor     # (num_samples, dim)
    logps: torch.Tensor         # (num_samples,)
    accept_prob: np.ndarray     # (num_samples,)
    depths: np.ndarray          # (num_samples,)
    diverging: np.ndarray       # (num_samples,)
    step_size: float            # adapted
    inv_mass: torch.Tensor      # adapted diagonal


def run_nuts(
    gen: torch.Generator,
    logdensity: Callable[[torch.Tensor], torch.Tensor],
    initial_position: torch.Tensor,
    num_samples: int,
    num_warmup: int = 500,
    max_depth: int = 10,
    target_accept: float = 0.65,
    initial_step_size: Optional[float] = None,
    initial_inv_mass: Optional[torch.Tensor] = None,
    progress: bool = False,
) -> NUTSResult:
    """Single-chain adaptive NUTS: Stan-style warmup, then sampling.
    ``logdensity`` maps q (dim,) to a scalar; ``gen`` lives on q's device.
    ``progress`` prints progress lines to stderr (``inference/progress.py``)."""
    vag = value_and_grad(logdensity)
    kernel = make_nuts_kernel(logdensity, max_depth=max_depth)
    q0 = initial_position
    dim, dtype, device = q0.shape[0], q0.dtype, q0.device
    host = host_generator(gen)

    logp0, grad0 = vag(q0)
    lf = LeapfrogState(q0, torch.zeros_like(q0), logp0, grad0)
    inv_mass = (torch.ones((dim,), dtype=dtype, device=device) if initial_inv_mass is None
                else torch.as_tensor(initial_inv_mass, dtype=dtype, device=device))
    eps0 = (find_reasonable_step_size(vag, gen, q0, inv_mass) if initial_step_size is None
            else float(initial_step_size))

    warm_progress = progress_emitter("warmup", num_warmup, progress)
    samp_progress = progress_emitter("sampling", num_samples, progress)
    sched = stan_warmup_schedule(num_warmup)
    da = da_init(eps0)
    wf = welford_init(dim, dtype, device)
    for i in range(num_warmup):
        lf, info = kernel(gen, host, lf, math.exp(da.log_eps), inv_mass)
        da = da_update(da, info.accept_prob, target=target_accept)
        if sched.in_slow_window[i]:
            wf = welford_update(wf, lf.q)
        if sched.window_end[i]:
            # end of a slow window: swap in the new mass, restart the accumulators
            inv_mass = welford_variance(wf)
            da = da_init(math.exp(da.log_eps))
            wf = welford_init(dim, dtype, device)
        warm_progress(i)
    eps_final = math.exp(da.log_eps_avg) if num_warmup > 0 else eps0

    qs, logps, accs, depths, divs = [], [], [], [], []
    for i in range(num_samples):
        lf, info = kernel(gen, host, lf, eps_final, inv_mass)
        qs.append(lf.q)
        logps.append(lf.logp)
        accs.append(info.accept_prob)
        depths.append(info.depth)
        divs.append(info.diverging)
        samp_progress(i)
    positions = torch.stack(qs) if qs else q0.new_zeros((0, dim))
    logps_t = torch.stack(logps) if logps else q0.new_zeros((0,))
    return NUTSResult(positions, logps_t, np.asarray(accs, float), np.asarray(depths, np.int32),
                      np.asarray(divs, bool), eps_final, inv_mass)
