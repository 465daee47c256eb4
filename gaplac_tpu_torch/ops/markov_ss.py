"""Matrix-state parallel Kalman filtering and smoothing: state-space
marginals of additive formulas (port of ``gaplac_tpu/ops/markov_ss.py``,
its dense ``(..., n, d, d)`` layout).

Each kernel leaf is a block of a Gauss-Markov state:

  OU(l)        d=1  A = e^{-dt/l},                      P∞ = 1,        H = [1]
  Matern32(l)  d=2  A = e^{-λdt}(I + N dt), λ = √3/l,   P∞ = diag(1, λ²), H = [1, 0]
  Matern52(l)  d=3  A = e^{-λdt}(I + N dt + N²dt²/2), λ = √5/l,           H = [1, 0, 0]
  Constant(c)  d=1  A = 1, Q = 0,                       P∞ = c,        H = [1]
  Linear(:x,c) d=2  A = I, Q = 0,                       P∞ = diag(1, c), H_k = [x_k, 1]
  SqExp(l)     d=6  the order-6 spectral-Taylor SSM in real modal form
                    (approximate; max kernel error 4.3e-3)
  Periodic(l,p) d=2J+1  the J-harmonic Fourier series (approximate)
  RQ(l, α)     d=6K  a K-node Gamma mixture of SqExp blocks (approximate)
  Noise        —    adds to the observation variance R

with N = F + λI nilpotent, so A is a short polynomial; Q_k = P∞ − A_k P∞ A_kᵀ
for every block; a product of leaves is the Kronecker product of their
blocks.  The filter composes elements (A, b, C, η, J) with

    D = I + C1 J2
    A = A2 D⁻¹ A1               η = A1ᵀ Dᵀ⁻¹ (η2 − J2 b1) + η1
    b = A2 D⁻¹ (b1 + C1 η2) + b2    (Dᵀ = I + J2 C1)
    C = A2 D⁻¹ C1 A2ᵀ + C2      J = A1ᵀ Dᵀ⁻¹ J2 A1 + J1

by ``ops/scan.py``: O(n log n · d³) work, O(log n) depth.  The systems are
solved by ``torch.linalg.solve_ex`` (LU with pivoting).

Batched: the sorted time axis ``t`` (n,) is shared; a leaf's parameter may
carry leading batch dimensions B (one value per chain), and the steps then
are (*B, n, d, d), so one scan serves every chain.  ``H`` depends on no
parameter and stays (n, d).  An observation variance ``R`` broadcasts to
(*B, n): a per-chain scalar is passed as (*B, 1).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import numpy as np
import torch

from gaplac_tpu_torch.ops.scan import associative_scan

_LOG_2PI = math.log(2.0 * math.pi)

#: leaf block kinds
(BLOCK_OU, BLOCK_M32, BLOCK_M52, BLOCK_CONST, BLOCK_LINEAR, BLOCK_SQEXP,
 BLOCK_PERIODIC, BLOCK_RQ) = range(8)

#: Periodic harmonic count J (state dim 2J+1; ``--sde-harmonics``), the
#: static structure of subsequently built models
DEFAULT_PERIODIC_J = 10
PERIODIC_J = DEFAULT_PERIODIC_J
#: RQ Gamma-mixture node count K (state dim 6K; ``--sde-rq-nodes``)
DEFAULT_RQ_MIX_K = 8
RQ_MIX_K = DEFAULT_RQ_MIX_K

#: midpoint-rule nodes of the Periodic block's Bessel coefficients
#: q_j² = (2 − δ_j0) e^{−x} I_j(x) = (1/π)∫₀^π e^{x(cosθ−1)} cos(jθ) dθ, x = 1/l²
_PERIODIC_QUAD_M = 256

#: SqExp spectral-Taylor order
SQEXP_ORDER = 6

_BLOCK_DIM = {BLOCK_OU: 1, BLOCK_M32: 2, BLOCK_M52: 3, BLOCK_CONST: 1,
              BLOCK_LINEAR: 2, BLOCK_SQEXP: SQEXP_ORDER}

#: (n, d, d) arrays a batch member's scans and their autograd tape hold at
#: once, about: the elements, each level's halves and the combines' systems
#: (``inference/smc.py::particle_chunk`` sizes batches by it)
SCAN_BUFFERS = 24
#: matrices one eigh call takes in psd_sqrt
EIGH_BATCH = 1 << 14


def set_periodic_harmonics(J: int) -> None:
    """Set the Periodic block's harmonic count for subsequently built
    models: static structure, fixed before a formula's structure is
    extracted."""
    global PERIODIC_J
    if not (1 <= int(J) <= 64):
        raise ValueError(f"--sde-harmonics must be in [1, 64], got {J}")
    PERIODIC_J = int(J)


def set_rq_nodes(K: int) -> None:
    """Set the RQ block's Gamma-mixture node count (as set_periodic_harmonics)."""
    global RQ_MIX_K
    if not (1 <= int(K) <= 32):
        raise ValueError(f"--sde-rq-nodes must be in [1, 32], got {K}")
    RQ_MIX_K = int(K)


def block_dim(kind) -> int:
    """State dimension of a block kind; a tuple of kinds is a product kernel
    whose dimension multiplies.  Periodic and RQ follow the current knobs."""
    if isinstance(kind, tuple):
        d = 1
        for k in kind:
            d *= block_dim(k)
        return d
    if kind == BLOCK_PERIODIC:
        return 2 * PERIODIC_J + 1
    if kind == BLOCK_RQ:
        return SQEXP_ORDER * RQ_MIX_K
    return _BLOCK_DIM[kind]


def _kron_mat(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Kronecker product of (..., a, a) and (..., b, b) -> (..., ab, ab),
    the leading dimensions broadcast."""
    a, b = A.shape[-1], B.shape[-1]
    K = A[..., :, None, :, None] * B[..., None, :, None, :]
    return K.reshape(K.shape[:-4] + (a * b, a * b))


def _kron_vec(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Kronecker product of (..., a) and (..., b) rows -> (..., ab)."""
    K = u[..., :, None] * v[..., None, :]
    return K.reshape(K.shape[:-2] + (-1,))


def _sqexp_modal_constants(order: int = SQEXP_ORDER):
    """Static real modal realization of the order-N spectral-Taylor SqExp
    SSM, in float64 numpy: the l = 1 spectrum q / P(ω²), P the Taylor
    truncation of 1/S ∝ exp(ω²/2), its stable spectral factor's companion
    matrix diagonalized into 2×2 rotation-scale blocks, so that

      A(Δt, l) = blockdiag( e^{α_p τ} R(β_p τ) ),  τ = Δt/l;  P∞, H constant.

    The ill-conditioned eigenbasis stays in this precomputation.  Returns
    (modes [(α, β)...], P∞ (N, N), h (N,)), P∞ of unit marginal variance."""
    from scipy.linalg import solve_continuous_lyapunov

    coefs = np.zeros(2 * order + 1)
    for k in range(order + 1):
        coefs[2 * k] = (-0.5) ** k / math.factorial(k)
    roots = np.roots(coefs[::-1])
    stable = roots[roots.real < 0]
    if len(stable) != order:
        raise ValueError("spectral factorization lost a root")
    a = np.real(np.poly(stable))
    F = np.zeros((order, order))
    F[:-1, 1:] = np.eye(order - 1)
    F[-1, :] = -a[1:][::-1]
    q = math.sqrt(2.0 * math.pi) * math.factorial(order) * 2.0 ** order
    L = np.zeros((order, 1))
    L[-1, 0] = 1.0
    P1 = solve_continuous_lyapunov(F, -q * (L @ L.T))
    d, V = np.linalg.eig(F)
    cols, modes = [], []
    for k in range(order):
        if d[k].imag > 1e-12:
            cols += [np.real(V[:, k]), np.imag(V[:, k])]
            modes.append((float(d[k].real), float(d[k].imag)))
        elif abs(d[k].imag) <= 1e-12:
            cols.append(np.real(V[:, k]))
            modes.append((float(d[k].real), None))
    T = np.stack(cols, axis=1)
    Ti = np.linalg.inv(T)
    Pz = Ti @ P1 @ Ti.T
    Pz = 0.5 * (Pz + Pz.T)
    h = T[0, :]
    Pz = Pz / float(h @ Pz @ h)
    return tuple(modes), Pz, h


_SQEXP_CONST_CACHE: dict = {}


def _sqexp_constants_cached(order: int = SQEXP_ORDER):
    if order not in _SQEXP_CONST_CACHE:
        _SQEXP_CONST_CACHE[order] = _sqexp_modal_constants(order)
    return _SQEXP_CONST_CACHE[order]


_RQ_CONST_CACHE: dict = {}


def rq_mixture_constants(alpha: float, K: int = None):
    """Static Gamma-mixture quadrature of the RQ block, float64 numpy: per
    component lengthscale multipliers c_k = √(α/v_k) and weights w_k
    (Σw = 1).  Of two rules, the one with the smaller max kernel error on
    τ ∈ [0, 30] is kept: (a) the K-node generalized Gauss–Laguerre rule for
    v^{α−1}e^{−v}; (b) Gamma-quantile nodes with NNLS-fitted nonnegative
    weights, better for heavy-tailed α ≲ 1.  Cached per (α, K)."""
    if K is None:
        K = RQ_MIX_K
    key = (float(alpha), K)
    if key not in _RQ_CONST_CACHE:
        from scipy.optimize import nnls
        from scipy.special import gammaln, roots_genlaguerre
        from scipy.stats import gamma as _gamma

        tau = np.concatenate([np.linspace(0.0, 30.0, 400), np.geomspace(0.01, 30.0, 200)])
        krq = (1.0 + tau ** 2 / (2.0 * alpha)) ** (-alpha)

        def max_err(v, w):
            kmix = np.exp(-v[None, :] * tau[:, None] ** 2 / (2 * alpha)) @ w
            return np.abs(kmix - krq).max()

        v1, w1 = roots_genlaguerre(K, alpha - 1.0)
        w1 = w1 / np.exp(gammaln(alpha))
        w1 = w1 / w1.sum()
        v2 = _gamma.ppf((np.arange(K) + 0.5) / K, alpha)
        Phi = np.exp(-v2[None, :] * tau[:, None] ** 2 / (2 * alpha))
        w2, _ = nnls(np.vstack([Phi, 10.0 * np.ones((1, K))]), np.concatenate([krq, [10.0]]))
        w2 = w2 / w2.sum()
        v, w = min(((v1, w1), (v2, w2)), key=lambda vw: max_err(*vw))
        _RQ_CONST_CACHE[key] = (np.sqrt(alpha / v), w)
    return _RQ_CONST_CACHE[key]


def _stack2(rows) -> torch.Tensor:
    """A (..., r, c) matrix from a list of rows of same-shaped tensors."""
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def _param(v, dt: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=dt.dtype, device=dt.device)


def _block_APH(kind, dt: torch.Tensor, param, x):
    """Transition A (*B, n, d, d), stationary P∞ (*B, n, d, d) and
    measurement row H (n, d) of one leaf block; ``dt`` is (n,), ``x`` the
    leaf's data column (Linear), B the parameter's batch shape."""
    n = dt.shape[0]
    f = dict(dtype=dt.dtype, device=dt.device)
    if isinstance(kind, tuple):
        # product kernel: the Kronecker-composed SSM, A = ⊗A_i, P∞ = ⊗P_i,
        # H = ⊗H_i, whose covariance is Π k_i
        A = P = H = None
        for k, pr, xk in zip(kind, param, x):
            Ak, Pk, Hk = _block_APH(k, dt, pr, xk)
            if A is None:
                A, P, H = Ak, Pk, Hk
            else:
                A, P, H = _kron_mat(A, Ak), _kron_mat(P, Pk), _kron_vec(H, Hk)
        return A, P, H
    if kind == BLOCK_OU:
        lam = 1.0 / _param(param, dt)
        A = torch.exp(-lam[..., None] * dt)[..., None, None]
        return A, torch.ones_like(A), torch.ones((n, 1), **f)
    if kind == BLOCK_M32:
        lam = 3.0 ** 0.5 / _param(param, dt)
        ld = lam[..., None] * dt
        e = torch.exp(-ld)
        dtb = dt.expand_as(ld)
        # N = F + λI = [[λ, 1], [-λ², -λ]], N² = 0: A = e^{-λΔ}(I + NΔ)
        A = e[..., None, None] * _stack2([[1.0 + ld, dtb], [-lam[..., None] * ld, 1.0 - ld]])
        one, zero = torch.ones_like(lam), torch.zeros_like(lam)
        P = _stack2([[one, zero], [zero, lam * lam]])[..., None, :, :].expand(A.shape)
        return A, P, torch.tensor([1.0, 0.0], **f).expand(n, 2)
    if kind == BLOCK_M52:
        lam = 5.0 ** 0.5 / _param(param, dt)
        l2 = lam * lam
        e = torch.exp(-lam[..., None] * dt)
        one, zero = torch.ones_like(lam), torch.zeros_like(lam)
        # F companion of (s+λ)³, N = F + λI, N³ = 0: A = e^{-λΔ}(I + NΔ + N²Δ²/2)
        N = _stack2([[lam, one, zero], [zero, lam, one], [-lam * l2, -3.0 * l2, -2.0 * lam]])
        N2 = N @ N
        dtm = dt[:, None, None]
        A = e[..., None, None] * (torch.eye(3, **f) + N[..., None, :, :] * dtm
                                  + 0.5 * N2[..., None, :, :] * dtm ** 2)
        P = _stack2([[one, zero, -l2 / 3.0], [zero, l2 / 3.0, zero],
                     [-l2 / 3.0, zero, l2 * l2]])[..., None, :, :].expand(A.shape)
        return A, P, torch.tensor([1.0, 0.0, 0.0], **f).expand(n, 3)
    if kind == BLOCK_CONST:
        # clamp: a zero-variance static state makes the smoother's predicted
        # covariance singular (Constant(0)); 1e-12 is exact to float64
        c = torch.clamp(_param(param, dt), min=1e-12)
        P = c[..., None, None, None].expand(c.shape + (n, 1, 1))
        return torch.ones((n, 1, 1), **f), P, torch.ones((n, 1), **f)
    if kind == BLOCK_SQEXP:
        modes, Pz, h = _sqexp_constants_cached()
        N = h.shape[0]
        tau = dt / _param(param, dt)[..., None]
        A = torch.zeros(tau.shape + (N, N), **f)
        off = 0
        for al, be in modes:
            e = torch.exp(al * tau)
            if be is None:
                A[..., off, off] = e
                off += 1
            else:
                c, s = torch.cos(be * tau), torch.sin(be * tau)
                A[..., off, off] = e * c
                A[..., off, off + 1] = e * s
                A[..., off + 1, off] = -e * s
                A[..., off + 1, off + 1] = e * c
                off += 2
        P = torch.as_tensor(Pz, **f).expand(A.shape)
        return A, P, torch.as_tensor(h, **f).expand(n, N)
    if kind == BLOCK_PERIODIC:
        # k(τ) = Σ_j q_j²(l) cos(j·2π/p·τ) truncated at J harmonics; each
        # harmonic a deterministic rotation (Q = 0), the j = 0 term a constant
        l, period = _param(param[0], dt), _param(param[1], dt)
        J, M = PERIODIC_J, _PERIODIC_QUAD_M
        theta = (torch.arange(M, **f) + 0.5) * (math.pi / M)
        wgt = torch.exp((1.0 / (l * l))[..., None] * (torch.cos(theta) - 1.0))   # (*B, M)
        js = torch.arange(J + 1, **f)
        cos_tab = torch.cos(js[:, None] * theta[None, :])                        # (J+1, M)
        q2 = (wgt @ cos_tab.mT) * (1.0 / M) * torch.where(js == 0, 1.0, 2.0)      # (*B, J+1)
        dtot = 2 * J + 1
        ang = (2.0 * math.pi / period)[..., None] * dt                           # (*Bp, n)
        A = torch.zeros(ang.shape + (dtot, dtot), **f)
        A[..., 0, 0] = 1.0
        Pd = torch.zeros(q2.shape[:-1] + (dtot,), **f)
        Pd[..., 0] = q2[..., 0]
        Hrow = torch.zeros((dtot,), **f)
        Hrow[0] = 1.0
        for j in range(1, J + 1):
            c, s = torch.cos(j * ang), torch.sin(j * ang)
            o = 2 * j - 1
            A[..., o, o], A[..., o, o + 1] = c, s
            A[..., o + 1, o], A[..., o + 1, o + 1] = -s, c
            Pd[..., o], Pd[..., o + 1] = q2[..., j], q2[..., j]
            Hrow[o] = 1.0
        P = torch.diag_embed(Pd)[..., None, :, :].expand(Pd.shape[:-1] + (n, dtot, dtot))
        return A, P, Hrow.expand(n, dtot)
    if kind == BLOCK_RQ:
        # K independent SqExp sub-blocks at lengthscales l·c_k, measurement
        # scaled by √w_k: Σ w_k k_se(τ/(l c_k)) ≈ RQ(τ; l, α)
        l, c, w = param
        l = _param(l, dt)
        dse = SQEXP_ORDER
        subs = [_block_APH(BLOCK_SQEXP, dt, l * float(ck), None) for ck in c]
        d = len(subs) * dse
        A = torch.zeros(subs[0][0].shape[:-2] + (d, d), **f)
        P = torch.zeros_like(A)
        for k, (Ak, Pk, _) in enumerate(subs):
            o = k * dse
            A[..., o:o + dse, o:o + dse] = Ak
            P[..., o:o + dse, o:o + dse] = Pk
        H = torch.cat([math.sqrt(float(wk)) * Hk for wk, (_, _, Hk) in zip(w, subs)], -1)
        return A, P, H
    if kind == BLOCK_LINEAR:
        c = torch.clamp(_param(param, dt), min=1e-12)
        one, zero = torch.ones_like(c), torch.zeros_like(c)
        P = _stack2([[one, zero], [zero, c]])[..., None, :, :].expand(c.shape + (n, 2, 2))
        H = torch.stack([x.to(dt.dtype), torch.ones_like(dt)], -1)
        return torch.eye(2, **f).expand(n, 2, 2), P, H
    raise ValueError(f"unknown block kind {kind}")


#: blocks whose steps are too ill-conditioned for float32: the SqExp
#: realization's P∞ has eigenvalues from 20 to 2.8e7, and a float32 filter's
#: covariances turn indefinite at Δt/l ~ 0.01, in the modal basis and in one
#: scaled to unit variance per mode alike
#: (``tests/test_torch_markov_ss.py::test_sqexp_float32_data_keeps_the_filter_definite``)
_FLOAT64_BLOCKS = frozenset({BLOCK_SQEXP, BLOCK_RQ})


def steps_dtype(kinds: Sequence, dtype: torch.dtype) -> torch.dtype:
    """The dtype the steps of ``kinds`` are built in from ``dtype`` data:
    float64 when a block (or a product's factor) is SqExp or RQ, else
    ``dtype``.  The filters and smoothers follow the steps' dtype."""
    flat = [k for kind in kinds for k in (kind if isinstance(kind, tuple) else (kind,))]
    return torch.float64 if _FLOAT64_BLOCKS.intersection(flat) else dtype


def build_steps(kinds: Sequence, params: Sequence, t: torch.Tensor, xs: Sequence,
                resets: Sequence = None):
    """Block-diagonal per-step (A, Q, H) of the additive model on SORTED t:
    A and Q (*B, n, d, d), H (n, d), in ``steps_dtype``.  ``params`` per
    block (a tuple per factor for products; Periodic (l, period), RQ (l, c,
    w)), ``xs`` per block data column (Linear only, else None).  Step 0's A
    is zero and its Q is P∞ (the stationary prior).

    ``resets`` (per block: None or bool (n,)) implement kernel × Cat: at a
    True row the block's transition is zeroed, so Q = P∞ − A P∞ Aᵀ restarts
    it from its stationary prior, and consecutive groups are independent."""
    n = t.shape[0]
    t = t.to(steps_dtype(kinds, t.dtype))
    # dt is negative at group boundaries (t restarts per group); every Markov
    # block resets there, and the clamp keeps exp() finite
    dt = torch.clamp(torch.cat([t.new_zeros(1), torch.diff(t)]), min=0.0)
    if resets is None:
        resets = (None,) * len(kinds)
    As, Ps, Hs = [], [], []
    for kind, p, x, rs in zip(kinds, params, xs, resets):
        if rs is None:
            A, P, H = _block_APH(kind, dt, p, x)
        else:
            rs = torch.as_tensor(rs, device=t.device)
            A, P, H = _block_APH(kind, torch.where(rs, 0.0, dt), p, x)
            A = A * (~rs).to(dt.dtype)[:, None, None]
        As.append(A)
        Ps.append(P)
        Hs.append(H)
    batch = torch.broadcast_shapes(*(M.shape[:-3] for M in As + Ps))
    if len(kinds) == 1:
        A, P = As[0], Ps[0]
    else:
        d = sum(block_dim(k) for k in kinds)
        A = t.new_zeros(batch + (n, d, d))
        P = t.new_zeros(batch + (n, d, d))
        off = 0
        for kind, Ab, Pb in zip(kinds, As, Ps):
            db = block_dim(kind)
            A[..., off:off + db, off:off + db] = Ab
            P[..., off:off + db, off:off + db] = Pb
            off += db
    Q = P - A @ P @ A.mT
    shape = batch + Q.shape[-3:]
    A = torch.cat([torch.zeros_like(A[..., :1, :, :]), A[..., 1:, :, :]], dim=-3)
    Q = torch.cat([P[..., :1, :, :].expand(batch + (1,) + Q.shape[-2:]), Q[..., 1:, :, :]],
                  dim=-3)
    return A.expand(shape), Q.expand(shape), torch.cat(Hs, -1)


def measure_row(H: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """H_k · m_k at every step."""
    return torch.sum(H * m, dim=-1)


def measure_var(H: torch.Tensor, P: torch.Tensor) -> torch.Tensor:
    """H_k P_k H_kᵀ at every step."""
    return torch.sum((P @ H[..., None])[..., 0] * H, dim=-1)


class _MElems(NamedTuple):
    A: torch.Tensor    # (*B, n, d, d)
    b: torch.Tensor    # (*B, n, d)
    C: torch.Tensor    # (*B, n, d, d)
    eta: torch.Tensor  # (*B, n, d)
    J: torch.Tensor    # (*B, n, d, d)


def _solve(D: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """D⁻¹ B for batches of D, each I + (PSD)(PSD) or a predicted covariance.
    A sampler's extreme proposal can make a member singular: ``solve_ex``
    then gives that member non-finite values, as ``gaplac_tpu``'s
    ``solve_small`` does, and the sampler rejects the proposal, where
    ``torch.linalg.solve`` raises and ends the run."""
    return torch.linalg.solve_ex(D, B)[0]


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (M @ v[..., None])[..., 0]


def _mcombine(e1: _MElems, e2: _MElems) -> _MElems:
    d = e1.A.shape[-1]
    I = torch.eye(d, dtype=e1.A.dtype, device=e1.A.device)
    # I + C J with C, J PSD is nonsingular; one solve per system, with the
    # right-hand sides [A1 | b1 + C1 η2 | C1] and [η2 − J2 b1 | J2]
    D = I + e1.C @ e2.J
    Dt = I + e2.J @ e1.C
    bC = (e1.b + _mv(e1.C, e2.eta))[..., None]
    X = _solve(D, torch.cat([e1.A, bC, e1.C], dim=-1))
    XA, Xb, XC = X[..., :d], X[..., d], X[..., d + 1:]
    A = e2.A @ XA
    b = _mv(e2.A, Xb) + e2.b
    C = e2.A @ XC @ e2.A.mT + e2.C
    rhs = (e2.eta - _mv(e2.J, e1.b))[..., None]
    Y = _solve(Dt, torch.cat([rhs, e2.J], dim=-1))
    A1t = e1.A.mT
    eta = (A1t @ Y[..., :1])[..., 0] + e1.eta
    J = A1t @ Y[..., 1:] @ e1.A + e1.J
    return _MElems(A, b, C, eta, J)


class _CElems(NamedTuple):
    """Covariance-only filter element (the _MElems mean parts dropped)."""

    A: torch.Tensor
    C: torch.Tensor
    J: torch.Tensor


def _ccombine(e1: _CElems, e2: _CElems) -> _CElems:
    # _mcombine with y ≡ 0: b and η stay zero through every combine
    d = e1.A.shape[-1]
    I = torch.eye(d, dtype=e1.A.dtype, device=e1.A.device)
    D = I + e1.C @ e2.J
    Dt = I + e2.J @ e1.C
    X = _solve(D, torch.cat([e1.A, e1.C], dim=-1))
    XA, XC = X[..., :d], X[..., d:]
    A = e2.A @ XA
    C = e2.A @ XC @ e2.A.mT + e2.C
    Y = _solve(Dt, e2.J)
    J = e1.A.mT @ Y @ e1.A + e1.J
    return _CElems(A, C, J)


def _time_axis(A: torch.Tensor) -> int:
    return A.dim() - 3


#: the element fields that are matrices (the others are vectors)
_MATRIX_FIELDS = frozenset({"A", "C", "J", "E", "L", "M"})


def _broadcast(elems):
    """The elements with their leading (batch and step) dimensions broadcast
    to one shape, as the scan slices them all along one axis."""
    mat = [f in _MATRIX_FIELDS for f in elems._fields]
    lead = torch.broadcast_shapes(*(e.shape[:-2] if m else e.shape[:-1]
                                    for e, m in zip(elems, mat)))
    return type(elems)(*(e.expand(lead + e.shape[-2 if m else -1:])
                         for e, m in zip(elems, mat)))


def _filter_parts(A, Q, H, R, obs):
    """The filter's per-step pieces: I − K Hᵀ, Hᵀ A, w / S and the gain K,
    w the observed mask."""
    n, d = A.shape[-3], A.shape[-1]
    QH = _mv(Q, H)
    R = torch.as_tensor(R, dtype=A.dtype, device=A.device)
    S = torch.sum(H * QH, dim=-1) + R
    w = (torch.ones((n,), dtype=A.dtype, device=A.device) if obs is None
         else torch.as_tensor(obs, device=A.device).to(A.dtype))
    K = QH / S[..., None] * w[..., None]
    ImKH = torch.eye(d, dtype=A.dtype, device=A.device) - K[..., :, None] * H[..., None, :]
    HA = (H[..., None, :] @ A)[..., 0, :]
    return ImKH, HA, w / S, K


def ss_filter(A, Q, H, y, R, obs=None):
    """Parallel Kalman filter: filtered means (*B, n, d) and covariances
    (*B, n, d, d) of x_k = A_k x_{k-1} + N(0, Q_k), y_k = H_k·x_k + N(0, R_k);
    ``obs`` (bool (n,)) masks out unobserved points."""
    ImKH, HA, wS, K = _filter_parts(A, Q, H, R, obs)
    elems = _broadcast(_MElems(A=ImKH @ A, b=K * y[..., None], C=ImKH @ Q,
                               eta=HA * (y * wS)[..., None],
                               J=HA[..., :, None] * HA[..., None, :] * wS[..., None, None]))
    pre = associative_scan(_mcombine, elems, axis=_time_axis(elems.A))
    return pre.b, pre.C


def ss_filter_cov(A, Q, H, R, obs=None):
    """Filtered covariances only: ``ss_filter`` for y ≡ 0 with the mean
    recursion left out (they never depend on the observations)."""
    ImKH, HA, wS, _ = _filter_parts(A, Q, H, R, obs)
    elems = _broadcast(_CElems(A=ImKH @ A, C=ImKH @ Q,
                               J=HA[..., :, None] * HA[..., None, :] * wS[..., None, None]))
    return associative_scan(_ccombine, elems, axis=_time_axis(elems.A)).C


def _shift(x: torch.Tensor, axis: int) -> torch.Tensor:
    """x one step later along ``axis``, zero first."""
    first = torch.zeros_like(x.narrow(axis, 0, 1))
    return torch.cat([first, x.narrow(axis, 0, x.shape[axis] - 1)], dim=axis)


def ss_loglik_parts(A, Q, H, y, R):
    """(quad, logdet) of N(y; 0, K + diag(R)) by the prediction-error
    decomposition: quad = Σ r²/S, logdet = Σ log S, each (*B,)."""
    m_f, P_f = ss_filter(A, Q, H, y, R)
    m_pred = _mv(A, _shift(m_f, -2))
    P_pred = A @ _shift(P_f, -3) @ A.mT + Q
    S = measure_var(H, P_pred) + torch.as_tensor(R, dtype=A.dtype, device=A.device)
    r = y - measure_row(H, m_pred)
    return torch.sum(r * r / S, dim=-1), torch.sum(torch.log(S), dim=-1)


def ss_loglik(A, Q, H, y, R):
    """log N(y; 0, K + diag(R)), (*B,)."""
    quad, logdet = ss_loglik_parts(A, Q, H, y, R)
    return -0.5 * (quad + logdet + A.shape[-3] * _LOG_2PI)


class _SElems(NamedTuple):
    E: torch.Tensor    # (*B, n, d, d)
    g: torch.Tensor    # (*B, n, d)
    L: torch.Tensor    # (*B, n, d, d)


def _scombine(a: _SElems, b: _SElems) -> _SElems:
    # composes m_k = E_k m_{k+1} + g_k backward: under the reverse scan
    # (flip, scan, flip) the FIRST argument is the element nearer the END
    # of the original sequence: a = the suffix from k+1, b = the element at k
    E = b.E @ a.E
    g = _mv(b.E, a.g) + b.g
    L = b.E @ a.L @ b.E.mT + b.L
    return _SElems(E, g, L)


def ss_smooth(A, Q, H, y, R, obs=None):
    """Smoothed posterior N(m_s, P_s) of the state at every step, the
    parallel RTS pass: elements
        E_k = P_f_k A_{k+1}ᵀ (A_{k+1} P_f_k A_{k+1}ᵀ + Q_{k+1})⁻¹
        g_k = m_f_k − E_k A_{k+1} m_f_k
        L_k = P_f_k − E_k (A_{k+1} P_f_k A_{k+1}ᵀ + Q_{k+1}) E_kᵀ
    composed by a reverse scan (m_s_k = E_k m_s_{k+1} + g_k)."""
    m_f, P_f = ss_filter(A, Q, H, y, R, obs=obs)
    A1, Pf0, mf0 = A[..., 1:, :, :], P_f[..., :-1, :, :], m_f[..., :-1, :]
    Pp = A1 @ Pf0 @ A1.mT + Q[..., 1:, :, :]   # predicted covariance at k+1
    E = _solve(Pp, A1 @ Pf0).mT
    g = mf0 - _mv(E, _mv(A1, mf0))
    L = Pf0 - E @ Pp @ E.mT
    elems = _broadcast(_SElems(E=torch.cat([E, torch.zeros_like(E[..., :1, :, :])], dim=-3),
                               g=torch.cat([g, m_f[..., -1:, :]], dim=-2),
                               L=torch.cat([L, P_f[..., -1:, :, :]], dim=-3)))
    suf = associative_scan(_scombine, elems, reverse=True, axis=_time_axis(elems.E))
    return suf.g, suf.L


def ss_innovation_coeffs(A, Q, H, jitter):
    """Data-independent innovation decomposition of K + jitter·I: one
    covariance filter gives the predicted covariance, the innovation
    variance S_k = H P_pred Hᵀ + jitter and the gain K_k = P_pred H / S_k.
    The recurrence x̂_k = A_k x̂_{k-1} + K_k √S_k z_k,
    f_k = H_k A_k x̂_{k-1} + √S_k z_k realizes f = L z with L the Cholesky
    factor of K + jitter·I in step order.  Returns (K (*B, n, d), S (*B, n))."""
    P_f = ss_filter_cov(A, Q, H, jitter)
    P_pred = A @ _shift(P_f, -3) @ A.mT + Q
    PH = _mv(P_pred, H)
    S = torch.sum(H * PH, dim=-1) + torch.as_tensor(jitter, dtype=A.dtype, device=A.device)
    return PH / S[..., None], S


class _AElems(NamedTuple):
    M: torch.Tensor    # (*B, n, d, d)
    b: torch.Tensor    # (*B, n, d)


def _affine_scan(M, b):
    """x_k = M_k x_{k-1} + b_k as an associative scan; all x_k."""

    def comb(e1, e2):
        return _AElems(e2.M @ e1.M, _mv(e2.M, e1.b) + e2.b)

    elems = _broadcast(_AElems(M, b))
    return associative_scan(comb, elems, axis=_time_axis(elems.M)).b


def ss_whiten_apply(A, H, Kg, S, z):
    """f = L z through the innovation recurrence (ss_innovation_coeffs)."""
    sqrtS = torch.sqrt(S)
    xhat = _affine_scan(A, Kg * (sqrtS * z)[..., None])
    HA = (H[..., None, :] @ A)[..., 0, :]
    return torch.sum(HA * _shift(xhat, -2), dim=-1) + sqrtS * z


def ss_unwhiten(A, H, Kg, S, f):
    """z = L⁻¹ f, the inverse recurrence:
    x̂_k = (A_k − K_k Hᵀ A_k) x̂_{k-1} + K_k f_k, z_k = (f_k − HᵀA x̂_{k-1}) / √S_k."""
    HA = (H[..., None, :] @ A)[..., 0, :]
    M = A - Kg[..., :, None] * HA[..., None, :]
    xhat = _affine_scan(M, Kg * f[..., None])
    return (f - torch.sum(HA * _shift(xhat, -2), dim=-1)) / torch.sqrt(S)


def psd_sqrt(Q: torch.Tensor) -> torch.Tensor:
    """Symmetric PSD square root of (..., d, d) matrices by eigh with the
    eigenvalues clamped at 0: L Lᵀ = Q₊.  Q = P∞ − A P∞ Aᵀ is exactly
    singular for static blocks and slightly indefinite by roundoff for
    SqExp blocks at small steps, where a Cholesky factor blows up."""
    if Q.shape[-1] == 1:  # its own eigenvalue
        return torch.sqrt(torch.clamp(Q, min=0.0))
    flat = Q.reshape((-1,) + Q.shape[-2:])
    # cuSOLVER's batched eigensolver refuses batches of 2^16 and more
    parts = [torch.linalg.eigh(c) for c in flat.split(EIGH_BATCH)]
    s, U = torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])
    return (U * torch.sqrt(torch.clamp(s, min=0.0))[..., None, :]).reshape(Q.shape)


def ss_prior_sample(gen: torch.Generator, A, Q):
    """Exact prior state paths (*B, n, d): x_k = A_k x_{k-1} + L_k z_k with
    L_k L_kᵀ = Q_k (``psd_sqrt``), as an associative scan."""
    z = torch.randn(Q.shape[:-1], generator=gen, dtype=Q.dtype, device=Q.device)
    return _affine_scan(A, _mv(psd_sqrt(Q), z))


def ss_smooth_windowed(kinds, params, ts, xs, ys, Rv, obs, resets, window: int, overlap: int):
    """Windowed smoothing: H·m_s and H P_s Hᵀ at every sorted row, in
    overlapping windows of ``window`` rows with ``overlap`` context rows on
    each side, of which only the interior is kept.  Each window restarts
    from the stationary prior (build_steps zeroes its first transition), the
    right state beyond the overlap horizon: interior rows match the
    monolithic smoother once the overlap spans a few lengthscales, and a
    window's buffers bound the memory.  ``ts``/``ys``/``Rv``/``obs`` are the
    sorted length-N rows; ``xs``/``resets`` per block in that order."""
    N = ts.shape[0]
    W, V = int(window), int(overlap)
    nwin = -(-N // W)
    back = nwin * W - N + V

    def pad(v, front_val, back_val):
        return torch.cat([v.new_full((V,), front_val), v, v.new_full((back,), back_val)])

    ts_p = pad(ts, float(ts[0]), float(ts[-1]))
    ys_p = pad(ys, 0.0, 0.0)
    Rv_p = pad(torch.as_tensor(Rv, dtype=ts.dtype, device=ts.device).expand(N), 1.0, 1.0)
    obs_p = pad(torch.ones(N, dtype=torch.bool, device=ts.device) if obs is None
                else torch.as_tensor(obs, device=ts.device), False, False)

    def pad_x(x):
        if x is None:
            return None
        if isinstance(x, tuple):
            return tuple(pad_x(a) for a in x)
        return pad(x, float(x[0]), float(x[-1]))

    xs_p = [pad_x(x) for x in xs]
    resets_p = tuple(None if r is None else pad(torch.as_tensor(r, device=ts.device), False, False)
                     for r in (resets if resets is not None else (None,) * len(kinds)))
    L = W + 2 * V

    def sl(v, lo):
        if v is None:
            return None
        if isinstance(v, tuple):
            return tuple(sl(a, lo) for a in v)
        return v[lo:lo + L]

    mus, variances = [], []
    for w in range(nwin):
        lo = w * W
        A, Q, H = build_steps(kinds, params, sl(ts_p, lo), [sl(x, lo) for x in xs_p],
                              resets=tuple(sl(r, lo) for r in resets_p))
        m_s, P_s = ss_smooth(A, Q, H, sl(ys_p, lo), sl(Rv_p, lo), obs=sl(obs_p, lo))
        mus.append(measure_row(H, m_s)[V:V + W])
        variances.append(measure_var(H, P_s)[V:V + W])
    return torch.cat(mus)[:N], torch.cat(variances)[:N]


def ss_predict(kinds, params, t, xs, y, R, t_new, xs_new, order=None, resets=None,
               window=None, overlap=None):
    """Posterior latent mean and variance (of H·x) at t_new given (t, y)
    with observation variance R: the new points join the sequence
    unobserved, one smoothing pass.  ``order`` is the sort permutation of
    the joined (n + m) rows and ``resets`` the per-block group-boundary
    masks in that order (default: by joined time, no groups).  ``window``
    smooths in windows (``ss_smooth_windowed``; overlap default window // 8)."""
    n, m = t.shape[0], t_new.shape[0]
    dev = t.device
    tj = torch.cat([t, t_new])
    yj = torch.cat([y, y.new_zeros(m)])
    obs = torch.cat([torch.ones(n, dtype=torch.bool, device=dev),
                     torch.zeros(m, dtype=torch.bool, device=dev)])
    Rv = torch.cat([torch.as_tensor(R, dtype=y.dtype, device=dev).expand(n), y.new_ones(m)])

    def join(xo, xn):
        if xo is None:
            return None
        if isinstance(xo, tuple):
            return tuple(join(a, b) for a, b in zip(xo, xn))
        return torch.cat([xo, xn])

    xs_j = [join(xo, xn) for xo, xn in zip(xs, xs_new)]
    order = (torch.argsort(tj, stable=True) if order is None
             else torch.as_tensor(order, device=dev))

    def perm(x):
        if x is None:
            return None
        if isinstance(x, tuple):
            return tuple(perm(a) for a in x)
        return x[order]

    xs_s = [perm(x) for x in xs_j]
    if window is not None and int(window) > 0 and n + m > int(window):
        mu, var = ss_smooth_windowed(kinds, params, tj[order], xs_s, yj[order], Rv[order],
                                     obs[order], resets, int(window),
                                     int(overlap) if overlap else max(1, int(window) // 8))
    else:
        A, Q, H = build_steps(kinds, params, tj[order], xs_s, resets=resets)
        m_s, P_s = ss_smooth(A, Q, H, yj[order], Rv[order], obs=obs[order])
        mu, var = measure_row(H, m_s), measure_var(H, P_s)
    inv = torch.argsort(order)
    return mu[inv][n:], var[inv][n:]
