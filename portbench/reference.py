"""Plain PyTorch pieces of the reference that decides ``correct``.

Nothing here imports the program under test: the reference works out again
every quantity the program derives from the inputs (constrained
hyperparameters, priors, grams, features, factors) and follows the sampler's
definition (momentum draws, jittered step, leapfrog, Metropolis test) from
its own code.  Each configuration's module (``configs/<name>.py``) supplies
the model's log density on top of these pieces.

Precision.  ``Arith`` carries the dtype and the product used for every
matrix product: float64 for the reference; float32 with TF32 products for
the control, the nearest precision below the configurations' float32 with
TF32 off.  TF32 is emulated by rounding both operands of each product (and of
each product in its backward) to TF32's 10-bit mantissa, round half away from
zero as ``cvt.rna.tf32.f32``; a product of two such operands is exact in
float32, so the emulation is the tensor cores' arithmetic on any device.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

LOG_2PI = math.log(2.0 * math.pi)

#: the blocked factorization's panel width: its trailing updates are the
#: products that a lower precision would round
CHOL_BLOCK = 256


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (10 explicit mantissa bits)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _Tf32Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return tf32_round(a) @ tf32_round(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = tf32_round(g)
        return g @ tf32_round(b).mT, tf32_round(a).mT @ g


class Arith(NamedTuple):
    dtype: torch.dtype
    tf32: bool

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return _Tf32Matmul.apply(a, b) if self.tf32 else a @ b


FLOAT64 = Arith(torch.float64, False)
TF32 = Arith(torch.float32, True)


def cholesky(A: torch.Tensor, ar: Arith, block: int = CHOL_BLOCK) -> torch.Tensor:
    """Lower factor of (..., n, n) by right-looking panels of ``block``
    columns: each diagonal block by ``cholesky_ex``, its panel below by a
    triangular solve, the trailing matrix by ``ar.mm``.  A member whose
    factorization fails is NaN."""
    n = A.shape[-1]
    cols, S, k = [], A, 0
    while k < n:
        b = min(block, n - k)
        L11, info = torch.linalg.cholesky_ex(S[..., :b, :b])
        L11 = torch.where((info != 0)[..., None, None], torch.full_like(L11, math.nan), L11)
        if b < S.shape[-1]:
            L21 = torch.linalg.solve_triangular(L11, S[..., b:, :b].mT, upper=False).mT
            S = S[..., b:, b:] - ar.mm(L21, L21.mT)
            col = torch.cat([L11, L21], dim=-2)
        else:
            col = L11
        cols.append(torch.nn.functional.pad(col, (0, 0, k, 0)))
        k += b
    return torch.cat(cols, dim=-1)


class _DenseGaussianLp(torch.autograd.Function):
    """log N(y; 0, K) for K (C, n, n) and y (n,), with the textbook gradient
    in K: 0.5 (alpha alpha^T - K^-1), alpha = K^-1 y (Rasmussen & Williams,
    Gaussian Processes for Machine Learning, 2006, eq. 5.9); K^-1 from the
    inverse of the factor, both products by ``ar.mm``."""

    @staticmethod
    def forward(ctx, K, y, ar):
        C, n, _ = K.shape
        L = cholesky(K, ar)
        a = torch.linalg.solve_triangular(L, y.expand(C, n)[..., None], upper=False)
        logdet = 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
        ctx.save_for_backward(L, a)
        ctx.ar = ar
        return -0.5 * ((a * a).sum((-2, -1)) + logdet + n * LOG_2PI)

    @staticmethod
    def backward(ctx, g):
        L, a = ctx.saved_tensors
        ar = ctx.ar
        eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device).expand_as(L)
        L_inv = torch.linalg.solve_triangular(L, eye, upper=False)
        alpha = torch.linalg.solve_triangular(L.mT, a, upper=True)
        K_bar = 0.5 * (ar.mm(alpha, alpha.mT) - ar.mm(L_inv.mT, L_inv))
        return K_bar * g[:, None, None], None, None


def dense_gaussian_lp(K: torch.Tensor, y: torch.Tensor, ar: Arith) -> torch.Tensor:
    """log N(y; 0, K) for K (C, n, n), y (n,); differentiable in K."""
    return _DenseGaussianLp.apply(K, y, ar)


def lowrank_gaussian_lp(phi: torch.Tensor, d: float, y: torch.Tensor, ar: Arith) -> torch.Tensor:
    """log N(y; 0, Phi Phi^T + d I) for Phi (C, n, m) by the Woodbury identity:
    A = I + Phi^T Phi / d, logdet = logdet A + n log d, quad = y.y/d -
    |R^-1 Phi^T y / d|^2 with R R^T = A."""
    C, n, m = phi.shape
    A = torch.eye(m, dtype=phi.dtype, device=phi.device) + ar.mm(phi.mT, phi) / d
    R = cholesky(A, ar)
    b = ar.mm(phi.mT, y.expand(C, n)[..., None]) / d
    u = torch.linalg.solve_triangular(R, b, upper=False)[..., 0]
    quad = (y * y).sum() / d - (u * u).sum(-1)
    logdet = 2.0 * torch.log(torch.diagonal(R, dim1=-2, dim2=-1)).sum(-1) + n * math.log(d)
    return -0.5 * (quad + logdet + n * LOG_2PI)


class UniformPrior(NamedTuple):
    """Uniform(lo, hi) on each hyperparameter, sampled as u with
    x = lo + (hi - lo) sigmoid(u); ``log_density_u`` is the prior of x plus
    log |dx/du|."""

    lo: float
    hi: float

    def x(self, u: torch.Tensor) -> torch.Tensor:
        return self.lo + (self.hi - self.lo) * torch.sigmoid(u)

    def log_density_u(self, u: torch.Tensor) -> torch.Tensor:
        sp = torch.nn.functional.softplus
        return (-sp(u) - sp(-u)).sum(-1)


def parse_uniform(text: str) -> UniformPrior:
    """``Uniform(lo,hi)`` -> UniformPrior; the configurations state it so."""
    name, _, rest = text.partition("(")
    if name.strip().lower() != "uniform" or not rest.endswith(")"):
        raise ValueError(f"the reference knows Uniform(lo,hi) priors only, not {text!r}")
    lo, hi = (float(v) for v in rest[:-1].split(","))
    return UniformPrior(lo, hi)


def value_and_grad(logdensity: Callable[[torch.Tensor], torch.Tensor], u: torch.Tensor):
    """(logdensity(u), d/du) for a batch u (C, dim); chains do not interact."""
    with torch.enable_grad():
        ur = u.detach().requires_grad_(True)
        lp = logdensity(ur)
        (g,) = torch.autograd.grad(lp.sum(), ur)
    return lp.detach(), g


# ---------------------------------------------------------------------------
# the sampler's definition: lockstep fixed-trajectory HMC, sampling phase
# ---------------------------------------------------------------------------


def radical_inverse2(i: int) -> float:
    """Element i of the base-2 Halton sequence (the radical inverse of i + 1)."""
    r, f, x = 0.0, 0.5, i + 1
    while x:
        r += f * (x & 1)
        x >>= 1
        f *= 0.5
    return r


def step_size(eps0: float, i: int) -> float:
    """The i-th transition's step: eps0 jittered by 0.8 + 0.4 halton(i)."""
    return eps0 * (0.8 + 0.4 * radical_inverse2(i))


def replay_draws(seed: int, n_transitions: int, chains: int, dim: int, dtype, device):
    """Each transition's (z, u): a (C, dim) standard normal for the momenta,
    then a (C,) uniform for the Metropolis test, drawn in that order from one
    generator seeded with ``seed`` in the sampler's working dtype."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = []
    for _ in range(n_transitions):
        z = torch.randn((chains, dim), generator=gen, dtype=dtype, device=device)
        u = torch.rand((chains,), generator=gen, dtype=dtype, device=device)
        out.append((z, u))
    return out


#: a position whose energy lies more than this many nats above its
#: trajectory's start is not compared: a trajectory that stays there is
#: rejected (acceptance below 2e-9), and float32 may fail there where float64
#: does not (a lengthscale that underflows to 0)
ENERGY_LIMIT = 20.0


class Audit(NamedTuple):
    """One transition of the program audited by the reference, per chain,
    over the compared positions: ``nonfinite``, how many of them have a
    non-finite log density or gradient in the program (the reference's are
    finite there); ``lp_gap``, ``grad_gap`` (the gradient's gap over
    ``grad_scale``) and ``step_gap`` (how far the leapfrog from each put the
    next position from where the reference's gradient puts it, in posterior
    standard deviations sqrt(inv_mass)), each over the compared positions
    where the program's values are finite; and the reference's log
    acceptance ratio of the program's trajectory."""

    nonfinite: torch.Tensor    # (C,)
    lp_gap: torch.Tensor       # (C,)
    grad_gap: torch.Tensor     # (C,)
    step_gap: torch.Tensor     # (C,)
    log_accept: torch.Tensor   # (C,)


def audit_transition(vag, qs: torch.Tensor, lps: torch.Tensor, grads: torch.Tensor,
                     z: torch.Tensor, inv_mass: torch.Tensor, eps: float,
                     grad_scale) -> Audit:
    """Audit a fixed-trajectory HMC transition from the program's own
    positions ``qs`` (L + 1, C, dim): the start and the position each of its
    L leapfrogs evaluated, with the program's log densities ``lps`` (L + 1, C)
    and gradients ``grads`` (L + 1, C, dim) there.  The leapfrog from (q_j,
    p_(j-1/2)) gives p_(j+1/2) = p_(j-1/2) + eps g(q_j) and q_(j+1) = q_j +
    eps inv_mass p_(j+1/2), with p_(-1/2) = z / sqrt(inv_mass) - eps g(q_0) / 2;
    the half-step momenta are read back from the program's positions, and
    each next position is held against where the reference's gradient at
    q_j puts it.  The energy H = -log p(q) + p.p inv_mass / 2 (full-step
    momenta) picks the compared positions, those at most ``ENERGY_LIMIT``
    above the start's, and gives the log acceptance ratio H_0 - H_L (-inf
    where non-finite).  ``grad_scale``: the norm a gradient's gap is measured
    against at least (the reference's norm is the other)."""
    ref = [vag(q) for q in qs]
    lp_r = torch.stack([r[0] for r in ref])
    g_r = torch.stack([r[1] for r in ref])
    sd = torch.sqrt(inv_mass)
    p0 = z / sd
    half = (qs[1:] - qs[:-1]) / (eps * inv_mass)                        # p_(j+1/2), (L, C, dim)
    before = torch.cat([(p0 - 0.5 * eps * g_r[0])[None], half[:-1]])     # p_(j-1/2)
    full = torch.cat([p0[None], half + 0.5 * eps * g_r[1:]])             # p_j, (L + 1, C, dim)
    energy = -lp_r + 0.5 * (full * full * inv_mass).sum(-1)
    keep = (energy - energy[0]).nan_to_num(math.inf) <= ENERGY_LIMIT     # (L + 1, C)
    lps, grads = lps.to(lp_r.dtype), grads.to(g_r.dtype)
    ok = torch.isfinite(lps) & torch.isfinite(grads).all(-1)
    nonfinite = (keep & ~ok).sum(0)
    both = keep & ok
    lp_gap = torch.where(both, (lps - lp_r).abs(), 0.0).amax(0)
    scale = torch.maximum(g_r.norm(dim=-1), torch.as_tensor(grad_scale, dtype=g_r.dtype))
    g_gap = (grads.nan_to_num(0.0) - g_r).norm(dim=-1) / scale
    grad_gap = torch.where(both, g_gap, 0.0).amax(0)
    step = ((half - before - eps * g_r[:-1]).abs() * eps * sd).amax(-1)  # (L, C)
    step_gap = torch.where(both[:-1], step.nan_to_num(math.inf), 0.0).amax(0)
    rise = energy[-1] - energy[0]
    log_acc = torch.where(torch.isfinite(rise), -rise, -math.inf)
    return Audit(nonfinite, lp_gap, grad_gap, step_gap, log_acc)
