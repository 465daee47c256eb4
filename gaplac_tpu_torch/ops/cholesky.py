"""Batched lower Cholesky: kernel K1 (``csrc/chol_batched.cu``).

K1 replaces the Pallas kernel ``gaplac_tpu/ops/cholesky.py::
_chol_batched_kernel`` (wrapped there by ``cholesky_small_batched``).  Its
plain version is ``torch.linalg.cholesky_ex`` with the members that failed
filled with NaN: ``torch.linalg.cholesky`` raises on a matrix that is not
positive definite, where ``jnp.linalg.cholesky`` (and K1) return NaN.
``CholeskyBatched`` is the differentiable op: its backward is Murray's
pullback as in ``_chol_small_bwd``, with two batched triangular solves
outside any kernel, as in ``gaplac_tpu``.

The TPU-only pieces of ``gaplac_tpu/ops/cholesky.py`` (the recursive
blocked factorization around kernel K3, ``cholesky_nocc``) are not ported
yet; see ROADMAP.md.
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
        # Murray (2016): P = Phi(L^T Lbar), Phi = tril with halved diagonal;
        # Abar = L^{-T} (P + P^T) L^{-1} / 2 (the symmetric convention)
        (L,) = ctx.saved_tensors
        P = L.mT @ Lbar
        P = P.tril() - 0.5 * torch.diag_embed(P.diagonal(dim1=-2, dim2=-1))
        S = P + P.mT
        tmp = torch.linalg.solve_triangular(L.mT, S, upper=True)             # L^{-T} S
        Z = torch.linalg.solve_triangular(L, tmp, upper=False, left=False)   # ... L^{-1}
        return 0.5 * Z
