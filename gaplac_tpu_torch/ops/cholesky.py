"""Cholesky factorizations: kernel K1 (``csrc/chol_batched.cu``), the
recursive blocked factorization, and its base case, kernel K3
(``csrc/chol_tile.cu``).

K1 replaces the Pallas kernel ``gaplac_tpu/ops/cholesky.py::
_chol_batched_kernel`` (wrapped there by ``cholesky_small_batched``).  Its
plain version is ``torch.linalg.cholesky_ex`` with the members that failed
filled with NaN: ``torch.linalg.cholesky`` raises on a matrix that is not
positive definite, where ``jnp.linalg.cholesky`` (and K1) return NaN.  K1
runs one thread-block cluster of 8 or 16 blocks per matrix (``K1_CLUSTER``).
``CholeskyBatched`` is the differentiable op: its backward is Murray's
pullback as in ``_chol_small_bwd``, with two batched triangular solves
outside any kernel, as in ``gaplac_tpu``.  The dense marginal no longer
takes it: ``ops/mvn.py::mvn_logpdf`` factors through ``linalg.factor`` and
brings its own adjoint, built on ``cholesky_inverse`` below.  What uses the
factor itself still does: ``mvn_logpdf_chol`` under autograd, the whitened
model (f = L z), Laplace's B, the low-rank capacitance and
``parallel/distributed.py``.

``blocked_cholesky`` is ``gaplac_tpu``'s recursive 2x2 blocked algorithm
(``_rchol``, ``_rtrsm_right_lt``, a SYRK): the products go to
``torch.matmul`` and the triangular-solve leaves to
``torch.linalg.solve_triangular``, as ``gaplac_tpu`` left them to XLA.  Its
base case is K3, which replaces the Pallas kernel ``_chol_tile_kernel``
(``_chol_base_pallas``).  In ``gaplac_tpu`` that kernel is an opt-in
(``use_pallas``); here, as every kernel of the port, it is the route on the
card, and ``chol_tile_plain`` the CPU path.  K3 holds a tile of at most
``CHOL_TILE`` = 128 in shared memory (the TPU kernel's 256-tile does not
fit), so the recursion bottoms out at 128.  The factor is allocated once;
the recursion passes views of the input's and the factor's blocks down, and
K3 reads and writes those views in place (on the CPU, ``chol_tile`` copies
the plain factor into the view), so the two devices run one algorithm.
``CholeskyBlocked`` makes the blocked route differentiable with the same
pullback as ``CholeskyBatched``.

``blocked_solve_lower``/``blocked_solve_upper`` are ``gaplac_tpu``'s
recursive triangular solves (``_rtrsm_left_lower``/``_rtrsm_left_upper``)
for a matrix right-hand side: the leaves go to
``torch.linalg.solve_triangular``, the off-diagonal updates to
``torch.matmul``, and the solution is allocated once and written in place
by halves, as ``blocked_cholesky`` writes its factor.  ``ops/linalg.py``
does not route ``solve_triangular`` through them (``gaplac_tpu`` does so
only on the TPU).

``cholesky_inverse`` is (L L^T)^{-1} from the factor by halves, in the
same style (views, one buffer written in place, batched over leading
dimensions, one algorithm on CPU and card): L^{-1} by halves, then
L^{-T} L^{-1} by halves, the products on ``torch.matmul`` and the diagonal
blocks of ``INV_LEAF`` inverted in one ``torch.linalg.solve_triangular``
call over all of them.  ``gaplac_tpu`` has no such function: its dense
marginal differentiates through the factor.

``cholesky_nocc`` (a TPU workaround) is not ported.
"""

from __future__ import annotations

import torch

from gaplac_tpu_torch.ops import _build


def chol_batched_plain(A: torch.Tensor) -> torch.Tensor:
    """(B, n, n) -> lower factors; a failed member is all NaN."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info != 0)[:, None, None], torch.full_like(L, float("nan")), L)


#: blocks in K1's cluster, one cluster per matrix: 8 (the portable size) or
#: 16; 0 lets the launcher take 16 where the batch's clusters of 16 fit on the
#: card at once, else 8
K1_CLUSTER = 0


def chol_batched_cuda(A: torch.Tensor, cluster: int = K1_CLUSTER) -> torch.Tensor:
    """K1 on the card: (B, n, n) float32/float64 -> lower factors, one
    cluster of ``cluster`` blocks per matrix."""
    lib = _build.library()
    dtype = _build.require_cuda("cholesky (K1)", A)
    if A.dim() != 3 or A.shape[1] != A.shape[2]:
        raise ValueError(f"cholesky (K1): (B, n, n) expected, got {tuple(A.shape)}")
    B, n, _ = A.shape
    if n * n >= 2**31:
        raise ValueError(f"cholesky (K1): n = {n} is beyond the kernel's int indexing")
    L = A.clone()  # the kernel factors in place
    fn = lib.gaplac_chol_batched_f32 if dtype == torch.float32 else lib.gaplac_chol_batched_f64
    err = fn(L.data_ptr(), B, n, cluster, A.device.index or 0, _build.stream_of(A))
    _build.check(err, "cholesky (K1)")
    _build.counts["K1"] += 1
    return L


def k1_clusters_that_fit(cluster: int, dtype: torch.dtype, device) -> int:
    """How many of K1's clusters of ``cluster`` blocks the card ``device`` (an
    index, or the device of the tensor K1 launches on) holds at once."""
    got = _build.library().gaplac_chol_batched_clusters(cluster, dtype == torch.float64,
                                                        _build.device_index(device))
    _build.check(max(0, -got), "cholesky (K1) cluster occupancy")
    return got


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
    _build.adjoints["murray"] += 1
    P = L.mT @ Lbar
    P = P.tril() - 0.5 * torch.diag_embed(P.diagonal(dim1=-2, dim2=-1))
    S = P + P.mT
    tmp = torch.linalg.solve_triangular(L.mT, S, upper=True)             # L^{-T} S
    Z = torch.linalg.solve_triangular(L, tmp, upper=False, left=False)   # ... L^{-1}
    return 0.5 * Z


# ---------------------------------------------------------------------------
# K3: the Cholesky factor of one tile, the blocked factorization's base case
# ---------------------------------------------------------------------------

#: the largest tile K3 factors (the tile it holds in shared memory), and the blocked
#: factorization's base on every device
CHOL_TILE = 128


def chol_tile_plain(A: torch.Tensor) -> torch.Tensor:
    """(n, n) -> lower factor; all NaN if A is not positive definite."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where(info != 0, torch.full_like(L, float("nan")), L)


def _row_major(t: torch.Tensor) -> bool:
    """A 2-D view whose rows are contiguous: stride (ld, 1) with ld >= n."""
    return t.dim() == 2 and (t.shape[1] <= 1 or t.stride(1) == 1) and (
        t.shape[0] <= 1 or t.stride(0) >= t.shape[1])


def chol_tile_cuda(A: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """K3 on the card: (n, n) float32/float64, n <= CHOL_TILE -> lower factor,
    written into ``out`` (allocated if None).  ``A`` and ``out`` may be views
    into larger matrices, as long as their rows are contiguous."""
    lib = _build.library()
    if out is None:
        out = torch.empty_like(A, memory_format=torch.contiguous_format)
    dtype = _build.require_cuda("cholesky tile (K3)", A, out, contiguous=False)
    if A.dim() != 2 or A.shape[0] != A.shape[1] or A.shape[0] > CHOL_TILE:
        raise ValueError(f"cholesky tile (K3): (n, n) with n <= {CHOL_TILE} expected, got "
                         f"{tuple(A.shape)}")
    if out.shape != A.shape:
        raise ValueError(f"cholesky tile (K3): output {tuple(out.shape)} for input "
                         f"{tuple(A.shape)}")
    if not (_row_major(A) and _row_major(out)):
        raise ValueError("cholesky tile (K3): input and output rows must be contiguous "
                         f"(strides {A.stride()}, {out.stride()})")
    n = A.shape[0]
    fn = lib.gaplac_chol_tile_f32 if dtype == torch.float32 else lib.gaplac_chol_tile_f64
    err = fn(A.data_ptr(), max(A.stride(0), n), out.data_ptr(), max(out.stride(0), n), n,
             A.device.index or 0, _build.stream_of(A))
    _build.check(err, "cholesky tile (K3)")
    _build.counts["K3"] += 1
    return out


def chol_tile(A: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """The factor of the tile ``A`` into ``out``, both views: K3 on CUDA, the
    plain version on the CPU."""
    if A.is_cuda:
        return chol_tile_cuda(A, out)
    return out.copy_(chol_tile_plain(A))


# ---------------------------------------------------------------------------
# the recursive blocked factorization (gaplac_tpu/ops/cholesky.py:132-221)
# ---------------------------------------------------------------------------


def _split_point(n: int, base: int) -> int:
    """Largest multiple of ``base`` that is >= n/2 (keeps all blocks
    base-aligned when n is a multiple of base)."""
    h = ((n + 1) // 2 + base - 1) // base * base
    return min(h, n - base) if n > base else n


def _rtrsm_right_lt(B: torch.Tensor, L: torch.Tensor, base: int, out: torch.Tensor) -> None:
    """out = B L^{-T} (L lower), by halves:
    X1 = B1 L11^{-T};  X2 = (B2 - X1 L21^T) L22^{-T}; ``out`` is a view."""
    n = L.shape[0]
    if n <= base:
        torch.linalg.solve_triangular(L.mT, B, upper=True, left=False, out=out)
        return
    h = _split_point(n, base)
    _rtrsm_right_lt(B[:, :h], L[:h, :h], base, out[:, :h])
    _rtrsm_right_lt(B[:, h:] - out[:, :h] @ L[h:, :h].mT, L[h:, h:], base, out[:, h:])


def _rchol(A: torch.Tensor, L: torch.Tensor, base: int) -> None:
    """L11 = chol(A11); L21 = A21 L11^{-T}; L22 = chol(A22 - L21 L21^T), into
    the view ``L`` of a factor whose upper triangle is already zero; ``A`` is
    only read."""
    n = A.shape[0]
    if n <= base:
        chol_tile(A, L)
        return
    h = _split_point(n, base)
    _rchol(A[:h, :h], L[:h, :h], base)
    _rtrsm_right_lt(A[h:, :h], L[:h, :h], base, L[h:, :h])
    _rchol(A[h:, h:] - L[h:, :h] @ L[h:, :h].mT, L[h:, h:], base)


def blocked_cholesky(A: torch.Tensor, base: int = CHOL_TILE) -> torch.Tensor:
    """Lower factor of SPD A (n, n), a new tensor; pads to a multiple of
    ``base`` with an identity tail (the factor of the padded matrix is the
    padded factor).  The factor is allocated once and every level of the
    recursion writes its blocks in place.  ``base`` must be at most
    CHOL_TILE for a CUDA tensor."""
    n = A.shape[0]
    pn = max(base, -(-n // base) * base)
    if pn != n:
        P = torch.eye(pn, dtype=A.dtype, device=A.device)
        P[:n, :n] = A
        A = P
    L = torch.zeros_like(A, memory_format=torch.contiguous_format)
    _rchol(A, L, base)
    return L[:n, :n]


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


# ---------------------------------------------------------------------------
# the recursive blocked triangular solves (gaplac_tpu/ops/cholesky.py:169-244)
# ---------------------------------------------------------------------------


def _rtrsm_left_lower(L: torch.Tensor, B: torch.Tensor, base: int, out: torch.Tensor) -> None:
    """out = L^{-1} B (L lower), by halves:
    X1 = L11^{-1} B1;  X2 = L22^{-1} (B2 - L21 X1); ``out`` is a view."""
    n = L.shape[0]
    if n <= base:
        torch.linalg.solve_triangular(L, B, upper=False, out=out)
        return
    h = _split_point(n, base)
    _rtrsm_left_lower(L[:h, :h], B[:h], base, out[:h])
    _rtrsm_left_lower(L[h:, h:], B[h:] - L[h:, :h] @ out[:h], base, out[h:])


def _rtrsm_left_upper(U: torch.Tensor, B: torch.Tensor, base: int, out: torch.Tensor) -> None:
    """out = U^{-1} B (U upper), by halves, the lower half first:
    X2 = U22^{-1} B2;  X1 = U11^{-1} (B1 - U12 X2); ``out`` is a view."""
    n = U.shape[0]
    if n <= base:
        torch.linalg.solve_triangular(U, B, upper=True, out=out)
        return
    h = _split_point(n, base)
    _rtrsm_left_upper(U[h:, h:], B[h:], base, out[h:])
    _rtrsm_left_upper(U[:h, :h], B[:h] - U[:h, h:] @ out[h:], base, out[:h])


def _blocked_solve(solve, T: torch.Tensor, B: torch.Tensor, base: int) -> torch.Tensor:
    vec = B.dim() == 1
    B2 = B[:, None] if vec else B
    X = torch.empty(B2.shape, dtype=B2.dtype, device=B2.device)
    solve(T, B2, base, X)
    return X[:, 0] if vec else X


def blocked_solve_lower(L: torch.Tensor, B: torch.Tensor, base: int = CHOL_TILE) -> torch.Tensor:
    """X with L X = B for lower-triangular L (n, n); B (n,) or (n, k)."""
    return _blocked_solve(_rtrsm_left_lower, L, B, base)


def blocked_solve_upper(U: torch.Tensor, B: torch.Tensor, base: int = CHOL_TILE) -> torch.Tensor:
    """X with U X = B for upper-triangular U (n, n); B (n,) or (n, k)."""
    return _blocked_solve(_rtrsm_left_upper, U, B, base)


# ---------------------------------------------------------------------------
# the inverse from the factor, by halves
# ---------------------------------------------------------------------------

#: the leaves of ``cholesky_inverse``: the largest diagonal block whose inverse
#: goes to ``torch.linalg.solve_triangular`` (from a sweep on the card of 128,
#: 256 and 512 at (8, 4096, 4096); PERF.md)
INV_LEAF = 256


def _diagonal_blocks(A: torch.Tensor, b: int) -> torch.Tensor:
    """The (B, n / b, b, b) view of the diagonal blocks of b of a contiguous
    (B, n, n), n a multiple of b."""
    B, n, _ = A.shape
    return A.as_strided((B, n // b, b, b), (n * n, b * (n + 1), n, 1), A.storage_offset())


def _rtri_inv(L: torch.Tensor, base: int, W: torch.Tensor) -> None:
    """W = L^{-1} for lower L, (B, n, n) views, by halves:
    W11 = L11^{-1};  W22 = L22^{-1};  W21 = -W22 (L21 W11).  The leaves, W's
    diagonal blocks of ``base``, hold their inverses on entry; W's upper
    triangle is zero and stays so."""
    n = L.shape[-1]
    if n <= base:
        return
    h = _split_point(n, base)
    _rtri_inv(L[:, :h, :h], base, W[:, :h, :h])
    _rtri_inv(L[:, h:, h:], base, W[:, h:, h:])
    W[:, h:, :h].baddbmm_(W[:, h:, h:], L[:, h:, :h] @ W[:, :h, :h], beta=0, alpha=-1)


def _rlauum(W: torch.Tensor, base: int) -> None:
    """W <- W^T W in place, for lower W, a (B, n, n) view with a zero upper
    triangle, by halves: C11 = W11^T W11 + W21^T W21;  C12 = W21^T W22
    (into the free upper block);  C22 = W22^T W22;  C21 = C12^T."""
    n = W.shape[-1]
    if n <= base:
        W.copy_(W.mT @ W)
        return
    h = _split_point(n, base)
    W11, W12, W21, W22 = W[:, :h, :h], W[:, :h, h:], W[:, h:, :h], W[:, h:, h:]
    _rlauum(W11, base)
    W11.baddbmm_(W21.mT, W21)
    W12.baddbmm_(W21.mT, W22, beta=0)
    _rlauum(W22, base)
    W21.copy_(W12.mT)


def cholesky_inverse(L: torch.Tensor, base: int = INV_LEAF) -> torch.Tensor:
    """(L L^T)^{-1} from lower factors L (..., n, n), a new full symmetric
    tensor: W = L^{-1} by halves (``_rtri_inv``), then W^T W by halves
    (``_rlauum``), both in one buffer.  About 4 n^3 / 3 flops a matrix on
    ``torch.matmul``.  The leaves are the diagonal blocks of ``base``,
    inverted in one call to ``torch.linalg.solve_triangular`` over all of
    them (n is padded to a multiple of ``base`` with an identity tail).  A
    member whose factor holds NaN gives NaN in its own inverse only."""
    n = L.shape[-1]
    pn = -(-n // base) * base
    Lb = L.reshape(-1, n, n)
    if pn != n:
        P = torch.eye(pn, dtype=L.dtype, device=L.device).repeat(Lb.shape[0], 1, 1)
        P[:, :n, :n] = Lb
        Lb = P
    Lb = Lb.contiguous()
    W = torch.zeros_like(Lb)
    Ld = _diagonal_blocks(Lb, base)
    eye = torch.eye(base, dtype=L.dtype, device=L.device).expand(Ld.shape)
    _diagonal_blocks(W, base).copy_(torch.linalg.solve_triangular(Ld, eye, upper=False))
    _rtri_inv(Lb, base, W)
    _rlauum(W, base)
    if pn != n:
        W = W[:, :n, :n].contiguous()
    return W.reshape(L.shape)
