"""Cholesky factorizations: kernel K1 (``csrc/chol_batched.cu``), the
recursive blocked factorization, and its base case, kernel K3
(``csrc/chol_tile.cu``).

K1 replaces the Pallas kernel ``gaplac_tpu/ops/cholesky.py::
_chol_batched_kernel`` (wrapped there by ``cholesky_small_batched``).  Its
plain version is ``torch.linalg.cholesky_ex`` with the members that failed
filled with NaN: ``torch.linalg.cholesky`` raises on a matrix that is not
positive definite, where ``jnp.linalg.cholesky`` (and K1) return NaN.
``CholeskyBatched`` is the differentiable op: its backward is Murray's
pullback as in ``_chol_small_bwd``, with two batched triangular solves
outside any kernel, as in ``gaplac_tpu``.

``blocked_cholesky`` is ``gaplac_tpu``'s recursive 2x2 blocked algorithm
(``_rchol``, ``_rtrsm_right_lt``, a SYRK): the products go to
``torch.matmul`` and the triangular-solve leaves to
``torch.linalg.solve_triangular``, as ``gaplac_tpu`` left them to XLA.  Its
base case is K3, which replaces the Pallas kernel ``_chol_tile_kernel``
(``_chol_base_pallas``).  In ``gaplac_tpu`` that kernel is an opt-in
(``use_pallas``); here, as every kernel of the port, it is the route on the
card, and ``chol_tile_plain`` the CPU path.  K3 holds a tile of at most
``CHOL_TILE`` = 128 in registers (the TPU kernel's 256-tile does not fit),
so the recursion bottoms out at 128.  ``CholeskyBlocked`` makes the blocked
route differentiable with the same pullback as ``CholeskyBatched``.

``cholesky_nocc`` (a TPU workaround) is not ported.
"""

from __future__ import annotations

import torch

from gaplac_tpu_torch.ops import _build


def chol_batched_plain(A: torch.Tensor) -> torch.Tensor:
    """(B, n, n) -> lower factors; a failed member is all NaN."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info != 0)[:, None, None], torch.full_like(L, float("nan")), L)


def chol_batched_cuda(A: torch.Tensor) -> torch.Tensor:
    """K1 on the card: (B, n, n) float32/float64 -> lower factors."""
    lib = _build.library()
    dtype = _build.require_cuda("cholesky (K1)", A)
    if A.dim() != 3 or A.shape[1] != A.shape[2]:
        raise ValueError(f"cholesky (K1): (B, n, n) expected, got {tuple(A.shape)}")
    B, n, _ = A.shape
    if n * n >= 2**31:
        raise ValueError(f"cholesky (K1): n = {n} is beyond the kernel's int indexing")
    L = A.clone()  # the kernel factors in place
    fn = lib.gaplac_chol_batched_f32 if dtype == torch.float32 else lib.gaplac_chol_batched_f64
    err = fn(L.data_ptr(), B, n, A.device.index or 0, _build.stream_of(A))
    _build.check(err, "cholesky (K1)")
    _build.counts["K1"] += 1
    return L


def chol_batched(A: torch.Tensor) -> torch.Tensor:
    """Lower factors of (..., n, n): K1 on CUDA, the plain version on the CPU."""
    n = A.shape[-1]
    Ab = A.reshape(-1, n, n).contiguous()
    L = chol_batched_cuda(Ab) if A.is_cuda else chol_batched_plain(Ab)
    return L.reshape(A.shape)


class CholeskyBatched(torch.autograd.Function):
    """Differentiable batched lower Cholesky of (..., n, n) SPD matrices."""

    @staticmethod
    def forward(ctx, A):
        L = chol_batched(A)
        ctx.save_for_backward(L)
        return L

    @staticmethod
    def backward(ctx, Lbar):
        (L,) = ctx.saved_tensors
        return cholesky_pullback(L, Lbar)


def cholesky_pullback(L: torch.Tensor, Lbar: torch.Tensor) -> torch.Tensor:
    """Murray (2016): P = Phi(L^T Lbar), Phi = tril with halved diagonal;
    Abar = L^{-T} (P + P^T) L^{-1} / 2 (the symmetric convention)."""
    P = L.mT @ Lbar
    P = P.tril() - 0.5 * torch.diag_embed(P.diagonal(dim1=-2, dim2=-1))
    S = P + P.mT
    tmp = torch.linalg.solve_triangular(L.mT, S, upper=True)             # L^{-T} S
    Z = torch.linalg.solve_triangular(L, tmp, upper=False, left=False)   # ... L^{-1}
    return 0.5 * Z


# ---------------------------------------------------------------------------
# K3: the Cholesky factor of one tile, the blocked factorization's base case
# ---------------------------------------------------------------------------

#: the largest tile K3 factors (the tile it holds in registers), and the blocked
#: factorization's base on every device
CHOL_TILE = 128


def chol_tile_plain(A: torch.Tensor) -> torch.Tensor:
    """(n, n) -> lower factor; all NaN if A is not positive definite."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where(info != 0, torch.full_like(L, float("nan")), L)


def chol_tile_cuda(A: torch.Tensor) -> torch.Tensor:
    """K3 on the card: (n, n) float32/float64, n <= CHOL_TILE -> lower factor."""
    lib = _build.library()
    dtype = _build.require_cuda("cholesky tile (K3)", A)
    if A.dim() != 2 or A.shape[0] != A.shape[1] or A.shape[0] > CHOL_TILE:
        raise ValueError(f"cholesky tile (K3): (n, n) with n <= {CHOL_TILE} expected, got "
                         f"{tuple(A.shape)}")
    L = torch.empty_like(A)
    fn = lib.gaplac_chol_tile_f32 if dtype == torch.float32 else lib.gaplac_chol_tile_f64
    err = fn(A.data_ptr(), L.data_ptr(), A.shape[0], A.device.index or 0, _build.stream_of(A))
    _build.check(err, "cholesky tile (K3)")
    _build.counts["K3"] += 1
    return L


def chol_tile(A: torch.Tensor) -> torch.Tensor:
    """K3 on CUDA, the plain version on the CPU; A may be a view."""
    return chol_tile_cuda(A.contiguous()) if A.is_cuda else chol_tile_plain(A)


# ---------------------------------------------------------------------------
# the recursive blocked factorization (gaplac_tpu/ops/cholesky.py:132-221)
# ---------------------------------------------------------------------------


def _split_point(n: int, base: int) -> int:
    """Largest multiple of ``base`` that is >= n/2 (keeps all blocks
    base-aligned when n is a multiple of base)."""
    h = ((n + 1) // 2 + base - 1) // base * base
    return min(h, n - base) if n > base else n


def _rtrsm_right_lt(B: torch.Tensor, L: torch.Tensor, base: int) -> torch.Tensor:
    """X = B L^{-T} (L lower), by halves:
    X1 = B1 L11^{-T};  X2 = (B2 - X1 L21^T) L22^{-T}."""
    n = L.shape[0]
    if n <= base:
        return torch.linalg.solve_triangular(L.mT, B, upper=True, left=False)
    h = _split_point(n, base)
    X1 = _rtrsm_right_lt(B[:, :h], L[:h, :h], base)
    X2 = _rtrsm_right_lt(B[:, h:] - X1 @ L[h:, :h].mT, L[h:, h:], base)
    return torch.cat([X1, X2], dim=1)


def _rchol(A: torch.Tensor, base: int) -> torch.Tensor:
    """L11 = chol(A11); L21 = A21 L11^{-T}; L22 = chol(A22 - L21 L21^T)."""
    n = A.shape[0]
    if n <= base:
        return chol_tile(A)
    h = _split_point(n, base)
    L = torch.zeros_like(A)
    L[:h, :h] = L11 = _rchol(A[:h, :h], base)
    L[h:, :h] = L21 = _rtrsm_right_lt(A[h:, :h], L11, base)
    L[h:, h:] = _rchol(A[h:, h:] - L21 @ L21.mT, base)
    return L


def blocked_cholesky(A: torch.Tensor, base: int = CHOL_TILE) -> torch.Tensor:
    """Lower factor of SPD A (n, n); pads to a multiple of ``base`` with an
    identity tail (the factor of the padded matrix is the padded factor).
    ``base`` must be at most CHOL_TILE for a CUDA tensor."""
    n = A.shape[0]
    pn = max(base, -(-n // base) * base)
    if pn != n:
        P = torch.eye(pn, dtype=A.dtype, device=A.device)
        P[:n, :n] = A
        return _rchol(P, base)[:n, :n]
    return _rchol(A, base)


class CholeskyBlocked(torch.autograd.Function):
    """Differentiable blocked lower Cholesky of one (n, n) SPD matrix."""

    @staticmethod
    def forward(ctx, A):
        L = blocked_cholesky(A)
        ctx.save_for_backward(L)
        return L

    @staticmethod
    def backward(ctx, Lbar):
        (L,) = ctx.saved_tensors
        return cholesky_pullback(L, Lbar)
