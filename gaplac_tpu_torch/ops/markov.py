"""Exact state-space GP marginal for one OU kernel, by a parallel Kalman
filter (port of ``gaplac_tpu/ops/markov.py``).

The OU kernel k(t, t') = exp(-|t - t'| / l) is a stationary scalar
Gauss-Markov process:

    x_k = a_k x_{k-1} + q_k,   a_k = exp(-dt_k / l),  q_k ~ N(0, 1 - a_k^2)
    y_k = x_k + r_k,           r_k ~ N(0, R_k)

so log N(y; 0, K + diag(R)) is a Kalman filter's prediction-error
decomposition, O(n) work.  The filter is an associative operation on
conditional-Gaussian elements e_k = (A, b, C, eta, J), meaning
p(x_k | x_{k-1}, y_k) = N(A x_{k-1} + b, C) with the information (eta, J)
the observation gives about x_{k-1}; two elements compose as

    d = 1 + C1 J2
    A = A2 A1 / d                 eta = A1 (eta2 - J2 b1) / d + eta1
    b = A2 (b1 + C1 eta2)/d + b2  J   = A1^2 J2 / d + J1
    C = A2^2 C1 / d + C2

and ``ops/scan.py`` evaluates the prefixes in O(log n) depth: at k, b and C
are the filtered mean and variance.

Batched: the times ``t`` are one sorted (n,) axis; ``ell`` may carry leading
batch dimensions B (one lengthscale per chain), and y and R broadcast to
(*B, n), so one scan serves every chain.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from gaplac_tpu_torch.ops.scan import associative_scan

_LOG_2PI = math.log(2.0 * math.pi)


class _Elems(NamedTuple):
    A: torch.Tensor
    b: torch.Tensor
    C: torch.Tensor
    eta: torch.Tensor
    J: torch.Tensor


def _combine(e1: _Elems, e2: _Elems) -> _Elems:
    d = 1.0 + e1.C * e2.J
    A = e2.A * e1.A / d
    b = e2.A * (e1.b + e1.C * e2.eta) / d + e2.b
    C = e2.A * e2.A * e1.C / d + e2.C
    eta = e1.A * (e2.eta - e2.J * e1.b) / d + e1.eta
    J = e1.A * e1.A * e2.J / d + e1.J
    return _Elems(A, b, C, eta, J)


def _scan(elems: _Elems) -> _Elems:
    return associative_scan(_combine, elems, axis=elems.A.dim() - 1)


def _ou_steps(t: torch.Tensor, ell, R):
    """Transition a_k, process noise Q_k and observation variance R_k, each
    (*B, n), of a unit-variance OU process on SORTED t; the first slots hold
    the prior (a = 0, Q = 1)."""
    ell = torch.as_tensor(ell, dtype=t.dtype, device=t.device)
    r = -torch.diff(t) / ell[..., None]
    a = torch.cat([torch.zeros_like(r[..., :1]), torch.exp(r)], dim=-1)
    # 1 - a^2 as -expm1(2r): no cancellation at steps much shorter than ell
    Q = torch.cat([torch.ones_like(r[..., :1]), -torch.expm1(2.0 * r)], dim=-1)
    R = torch.as_tensor(R, dtype=t.dtype, device=t.device)
    return a, Q, R.expand(torch.broadcast_shapes(a.shape, R.shape))


def ou_filter(t, y, ell, R) -> Tuple[torch.Tensor, torch.Tensor]:
    """Filtered means and variances E[x_k | y_1:k], Var[x_k | y_1:k] on sorted t."""
    a, Q, Rv = _ou_steps(t, ell, R)
    S = Q + Rv
    K = Q / S
    pre = _scan(_Elems(A=(1.0 - K) * a, b=K * y, C=(1.0 - K) * Q, eta=a * y / S,
                       J=a * a / S))
    return pre.b, pre.C


def ou_loglik(t, y, ell, R) -> torch.Tensor:
    """log N(y; 0, K_OU(ell) + diag(R)) on SORTED t, (*B,)."""
    a, Q, Rv = _ou_steps(t, ell, R)
    m_f, P_f = ou_filter(t, y, ell, R)
    # innovations: y_k | y_1:k-1 ~ N(a_k m_{k-1}, a_k^2 P_{k-1} + Q_k + R_k)
    m_prev = torch.cat([torch.zeros_like(m_f[..., :1]), m_f[..., :-1]], dim=-1)
    P_prev = torch.cat([torch.zeros_like(P_f[..., :1]), P_f[..., :-1]], dim=-1)
    S_pred = a * a * P_prev + Q + Rv
    resid = y - a * m_prev
    return torch.sum(-0.5 * (resid * resid / S_pred + torch.log(S_pred) + _LOG_2PI), dim=-1)


def ou_posterior_predict(t, y, ell, R, t_new) -> Tuple[torch.Tensor, torch.Tensor]:
    """Posterior latent mean and variance at t_new given (t, y): the new
    points join the sequence unobserved, and a two-filter smoother combines
    a forward and a time-reversed filter (see ``_smooth``).  Unbatched."""
    n = t.shape[0]
    tj = torch.cat([t, t_new])
    yj = torch.cat([y, y.new_zeros(t_new.shape)])
    obs = torch.cat([torch.ones(t.shape, dtype=torch.bool, device=t.device),
                     torch.zeros(t_new.shape, dtype=torch.bool, device=t.device)])
    Rv = torch.cat([torch.as_tensor(R, dtype=y.dtype, device=y.device).expand(t.shape),
                    y.new_ones(t_new.shape)])  # placeholder at the new points, masked
    order = torch.argsort(tj, stable=True)
    m_s, P_s = _smooth(tj[order], yj[order], Rv[order], obs[order], ell)
    inv = torch.argsort(order)
    return m_s[inv][n:], P_s[inv][n:]


def _masked_filter(ts, ys, Rs, obs, ell):
    """The filter with the unobserved points (obs False) skipped: K = 0 and
    no information."""
    a, Q, _ = _ou_steps(ts, ell, 0.0)
    S = Q + Rs
    K = torch.where(obs, Q / S, 0.0)
    pre = _scan(_Elems(A=(1.0 - K) * a, b=K * ys, C=(1.0 - K) * Q,
                       eta=torch.where(obs, a * ys / S, 0.0),
                       J=torch.where(obs, a * a / S, 0.0)))
    return pre.b, pre.C


def _smooth(ts, ys, Rs, obs, ell):
    """Two-filter smoothed posterior N(m_s, P_s) of the OU latent at every
    point of the sorted sequence.  The stationary unit-variance OU process is
    reversible, so the reversed sequence follows the same model: the reversed
    filter at k+1 gives p(x_{k+1} | y_{k+1:}) = N(m_r, P_r), whose likelihood
    (J_L = 1/P_r - 1, eta_L = m_r/P_r) propagates back through the
    transition and combines with the forward filter by precisions."""
    m_f, P_f = _masked_filter(ts, ys, Rs, obs, ell)
    flip = lambda v: torch.flip(v, (-1,))
    m_bf, P_bf = _masked_filter(-flip(ts), flip(ys), flip(Rs), flip(obs), ell)
    # reversed index j holds p(x_{n-1-j} | y_{n-1-j:}); original k+1 is j = n-2-k
    m_r, P_r = flip(m_bf)[..., 1:], flip(P_bf)[..., 1:]
    a, Q, _ = _ou_steps(ts, ell, 0.0)
    a_next, Q_next = a[..., 1:], Q[..., 1:]
    J_L = 1.0 / P_r - 1.0
    eta_L = m_r / P_r
    denom = 1.0 + Q_next * J_L
    zero = torch.zeros_like(m_f[..., :1])
    J_b = torch.cat([a_next * a_next * J_L / denom, zero], dim=-1)  # last: no future
    eta_b = torch.cat([a_next * eta_L / denom, zero], dim=-1)
    P_s = 1.0 / (1.0 / P_f + J_b)
    return P_s * (m_f / P_f + eta_b), P_s


def ou_smooth(t, y, ell, R) -> Tuple[torch.Tensor, torch.Tensor]:
    """Smoothed posterior mean and variance of the OU latent at the observed
    sorted points, y = x + N(0, R); m_s = K (K + R I)^-1 y."""
    ell = torch.as_tensor(ell, dtype=t.dtype, device=t.device)
    shape = torch.broadcast_shapes(ell.shape + t.shape, torch.as_tensor(y).shape)
    Rv = torch.as_tensor(R, dtype=t.dtype, device=t.device).expand(shape)
    obs = torch.ones(t.shape, dtype=torch.bool, device=t.device)
    return _smooth(t, y, Rv, obs, ell)


def ou_prior_sample(gen: torch.Generator, t, ell) -> torch.Tensor:
    """Exact prior paths x ~ N(0, K_OU(ell)) at sorted t, (*B, n): the
    recurrence x_k = a_k x_{k-1} + sqrt(Q_k) z_k as a scan of (a, b) pairs,
    (a2, b2) o (a1, b1) = (a2 a1, a2 b1 + b2)."""
    a, Q, _ = _ou_steps(t, ell, 0.0)
    z = torch.randn(a.shape, generator=gen, dtype=a.dtype, device=a.device)

    def comb(e1, e2):
        return e2[0] * e1[0], e2[0] * e1[1] + e2[1]

    return associative_scan(comb, (a, torch.sqrt(Q) * z), axis=a.dim() - 1)[1]
