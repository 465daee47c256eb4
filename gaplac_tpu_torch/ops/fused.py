"""Fused gram -> Cholesky: factor K(theta) + diag I without materializing K
(port of ``gaplac_tpu/ops/fused.py``).

A left-looking panel factorization whose entries of K are made panel by
panel from X:

    for each panel (columns j0:j1, width B):
        P  = K[j0:, j0:j1] + diag on its diagonal   # K2 at row offsets (j0, j0)
        P -= L[j0:, :j0] @ L[j0:j1, :j0]^T          # one product on views of L
        L[j0:j1, j0:j1] = chol(P[:B])               # blocked_cholesky, K3 tiles
        L[j1:,  j0:j1]  = P[B:] L11^{-T}            # the blocked right solve

Its point is memory: the factor is the only n x n buffer, where the
two-step ``blocked_cholesky(gram(X))`` holds K beside L, so the largest
dense n grows about sqrt(2) times.  ``gaplac_tpu`` measured no speed gain
on the TPU and routes no command through it (``fused.py:29-37``); neither
does the port: it is a library entry point.

Differences from ``gaplac_tpu``, none in what is computed: no ``precision``
argument (the port runs float32 without TF32, ``runtime.py``); a panel is a
cross gram of K2 with global row offsets, so bare Noise and ``diag`` land
on the panel's own diagonal; the factor is allocated once and each panel
writes its block column into it in place, and the update is one
``addmm_`` on views of it, where ``gaplac_tpu`` concatenates the left block
columns anew for every panel.

The backward (``_FusedGramCholesky``) is ``gaplac_tpu``'s ``_fused_bwd``:
Murray's pullback through ``blocked_solve_upper``, then dtheta from the
symmetric gram's backward, K2b on the card.  It holds a few n x n buffers,
as ``gaplac_tpu``'s does.  dX, which no kernel computes, goes through the
plain gram's autograd, only when X requires a gradient.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from gaplac_tpu_torch.kernels.covariance import CompiledKernel
from gaplac_tpu_torch.ops.cholesky import (
    CHOL_TILE,
    _rtrsm_right_lt,
    blocked_cholesky,
    blocked_solve_lower,
    blocked_solve_upper,
)
from gaplac_tpu_torch.ops.gram import gram, gram_bwd, gram_plain

#: default panel width, as in gaplac_tpu
PANEL = 2048

_LOG_2PI = math.log(2.0 * math.pi)


def _panel_ranges(n: int, panel: int) -> Tuple[Tuple[int, int], ...]:
    return tuple((j0, min(j0 + panel, n)) for j0 in range(0, n, panel))


def _fused_factor(ck: CompiledKernel, diag: float, panel: int, params: torch.Tensor,
                  X: torch.Tensor) -> torch.Tensor:
    """The lower factor of gram(params, X) + diag I; params (1, n_params)."""
    n = X.shape[0]
    L = torch.zeros((n, n), dtype=X.dtype, device=X.device)
    for j0, j1 in _panel_ranges(n, panel):
        b = j1 - j0
        P = gram(ck, params, X[j0:], X[j0:j1], diag, offsets=(j0, j0))[0]
        if j0:  # the left-looking update: P -= L[j0:, :j0] L[j0:j1, :j0]^T
            left = L[j0:, :j0]
            P.addmm_(left, left[:b].mT, alpha=-1.0)
        L11 = L[j0:j1, j0:j1]
        L11.copy_(blocked_cholesky(P[:b]))
        if j1 < n:
            _rtrsm_right_lt(P[b:], L11, CHOL_TILE, L[j1:, j0:j1])
    return L


class _FusedGramCholesky(torch.autograd.Function):
    """params (n_params,), X (n, d) -> L (n, n); differentiable in both."""

    @staticmethod
    def forward(ctx, params, X, ck, diag, panel):
        ctx.ck, ctx.diag = ck, diag
        L = _fused_factor(ck, diag, panel, params[None].contiguous(), X)
        ctx.save_for_backward(L, params, X)
        return L

    @staticmethod
    def backward(ctx, Lbar):
        L, params, X = ctx.saved_tensors
        # Murray (2016): dK = L^{-T} (P + P^T) L^{-1} / 2, P = Phi(L^T Lbar)
        P = L.mT @ Lbar
        P = P.tril() - 0.5 * torch.diag_embed(P.diagonal())
        S = P + P.mT
        tmp = blocked_solve_upper(L.mT, S)                 # L^{-T} S
        dK = 0.5 * blocked_solve_upper(L.mT, tmp.mT).mT    # ... L^{-1}
        p1 = params[None].contiguous()
        dparams = gram_bwd(ctx.ck, p1, X, None, dK[None].contiguous())[0]
        dX = None
        if ctx.needs_input_grad[1]:
            with torch.enable_grad():
                Xg = X.detach().requires_grad_()
                K = gram_plain(ctx.ck, p1, Xg, None, ctx.diag)[0]
                (dX,) = torch.autograd.grad(K, Xg, dK)
        return dparams, dX, None, None, None


def fused_gram_cholesky(ck: CompiledKernel, diag: float, panel: int, params: torch.Tensor,
                        X: torch.Tensor) -> torch.Tensor:
    """L = chol(gram(params, X) + diag I) with K made panel by panel and never
    materialized; params (n_leaves,) or (n_params,), X (n, d).
    Differentiable in ``params`` and ``X``."""
    return _FusedGramCholesky.apply(ck.full_params(params), X.contiguous(), ck, float(diag),
                                    int(panel))


class _LowerSolve(torch.autograd.Function):
    """alpha = L^{-1} y through ``blocked_solve_lower``, differentiable in L
    and y (the blocked solves write into views, which autograd cannot
    follow)."""

    @staticmethod
    def forward(ctx, L, y):
        alpha = blocked_solve_lower(L, y)
        ctx.save_for_backward(L, alpha)
        return alpha

    @staticmethod
    def backward(ctx, g):
        L, alpha = ctx.saved_tensors
        ybar = blocked_solve_upper(L.mT, g)  # L^{-T} g
        return -torch.outer(ybar, alpha).tril(), ybar


def mvn_logpdf_fused(ck: CompiledKernel, params: torch.Tensor, X: torch.Tensor,
                     y: torch.Tensor, diag: float, panel: int = PANEL) -> torch.Tensor:
    """log N(y; 0, gram(params, X) + diag I) through the fused factorization:
    the large-n dense marginal without materializing K."""
    L = fused_gram_cholesky(ck, diag, panel, params, X)
    alpha = _LowerSolve.apply(L, y)
    return (-0.5 * torch.sum(alpha * alpha) - torch.sum(torch.log(L.diagonal()))
            - 0.5 * y.shape[0] * _LOG_2PI)
