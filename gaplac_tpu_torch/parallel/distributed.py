"""The large-n dense and low-rank paths row-sharded over ranks (port of
``gaplac_tpu/parallel/distributed.py``).

A 1-D "data" mesh of ranks (``data_mesh``) shards K by block rows: rank d
holds rows [d nb, (d + 1) nb) of the n x n matrix, nb = n / P.  Where
``gaplac_tpu`` returns a row-sharded global array, a function here returns
this rank's (nb, n) block; where its ``out_specs`` is replicated, every rank
gets the same tensor.

``sharded_gram`` builds a rank's block with kernel K2 at global row offsets
(d nb, 0), so bare Noise and the jitter land on the global diagonal.
``distributed_cholesky`` is ``gaplac_tpu``'s right-looking panel
factorization, panel k being rank k's block column:

  1. the owner broadcasts its diagonal block, which every rank factors
     (``ops.linalg.cholesky``: K1 below n = 2048, the blocked route through
     K3 from there on);
  2. each rank below the panel solves its own panel rows;
  3. the panel column is all-gathered and every rank below it updates its
     trailing block row (up to its own diagonal block: the strict upper
     triangle is zeroed at the end).

One broadcast and one all-gather a panel (the last panel updates nothing
and gathers nothing).  ``distributed_solve_lower`` is P rounds of block
forward substitution, one broadcast each.  ``sharded_lowrank_logpdf``
builds each rank's (nb, m) feature rows and sums the m x m capacitance, the
(m,) projection and the scalar terms over ranks; it is differentiable in
``params``: the sums' backward is the identity (the cotangent reaching a sum
is already the same on every rank) and the copy of the replicated
``params`` into the rank's rows sums the rows' gradients over ranks.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

from gaplac_tpu_torch.kernels.covariance import CompiledKernel
from gaplac_tpu_torch.ops import linalg
from gaplac_tpu_torch.ops.gram import gram
from gaplac_tpu_torch.ops.lowrank import rows_matmul
from gaplac_tpu_torch.parallel.mesh import Mesh, rank_mesh

_LOG_2PI = math.log(2.0 * math.pi)


def data_mesh(n_devices: Optional[int] = None) -> Optional[Mesh]:
    """The 1-D "data" mesh over (up to) all ranks."""
    return rank_mesh(n_devices)


def _block_rows(n: int, mesh: Mesh) -> int:
    if n % mesh.size != 0:
        raise ValueError(f"n={n} must be divisible by mesh size {mesh.size}")
    return n // mesh.size


def _local_block(K_local: torch.Tensor, mesh: Mesh) -> int:
    """nb of a rank's (nb, n) block row."""
    nb, n = K_local.shape
    if n % mesh.size != 0:
        raise ValueError(f"n={n} must be divisible by mesh size {mesh.size}")
    if nb * mesh.size != n:
        raise ValueError(f"a block row of {nb} rows of an n = {n} matrix over "
                         f"{mesh.size} ranks")
    return nb


def sharded_gram(
    ck: CompiledKernel,
    params: torch.Tensor,
    X: torch.Tensor,
    mesh: Mesh,
    jitter: float = 0.0,
) -> torch.Tensor:
    """This rank's (n/P, n) block row of K (+ jitter I); params (n_params,),
    X (n, d) replicated.  No rank forms the whole gram."""
    n = X.shape[0]
    if n % mesh.size != 0:
        raise ValueError(f"n={n} must be divisible by the mesh size {mesh.size}")
    nb = n // mesh.size
    row0 = mesh.rank * nb
    return gram(ck, params[None], X[row0:row0 + nb], X, diag=jitter, offsets=(row0, 0))[0]


def distributed_cholesky(K_local: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's (n/P, n) block row of the lower Cholesky factor of the
    SPD matrix whose block row is ``K_local``."""
    nb = _local_block(K_local, mesh)
    d = mesh.rank
    A = K_local.clone()
    for k in range(mesh.size):
        cols = slice(k * nb, (k + 1) * nb)
        diag = A[:, cols].contiguous() if d == k else A.new_empty((nb, nb))
        dist.broadcast(diag, src=k, group=mesh.group)
        L_kk = linalg.cholesky(diag)
        if d == k:
            A[:, cols] = L_kk
        elif d > k:  # rows below the panel: A[:, cols] L_kk^-T
            A[:, cols] = torch.linalg.solve_triangular(L_kk.mT, A[:, cols], upper=True,
                                                       left=False)
        if k == mesh.size - 1:
            break
        panel = A[:, cols].contiguous() if d >= k else A.new_zeros((nb, nb))
        parts = [torch.empty_like(panel) for _ in range(mesh.size)]
        dist.all_gather(parts, panel, group=mesh.group)
        if d > k:  # the trailing columns up to this rank's diagonal block
            trail = slice((k + 1) * nb, (d + 1) * nb)
            F = torch.cat(parts[k + 1:d + 1])
            A[:, trail].addmm_(panel, F.mT, alpha=-1.0)
    # the strict upper triangle of the global matrix: column j > global row d nb + i
    return A.tril(d * nb)


def distributed_solve_lower(L_local: torch.Tensor, b: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """x with L x = b, L row-sharded (this rank's (n/P, n) block row), b and
    x (n,) on every rank."""
    nb = _local_block(L_local, mesh)
    d = mesh.rank
    x = b.new_zeros(b.shape)
    resid = b[d * nb:(d + 1) * nb].clone()
    for k in range(mesh.size):
        cols = slice(k * nb, (k + 1) * nb)
        xk = (linalg.solve_triangular(L_local[:, cols], resid, lower=True) if d == k
              else b.new_empty((nb,)))
        dist.broadcast(xk, src=k, group=mesh.group)
        x[cols] = xk
        if d > k:
            resid -= L_local[:, cols] @ xk
    return x


class _SumOverRanks(torch.autograd.Function):
    """The sum of a tensor over the mesh's ranks.  Its backward is the
    identity: what follows the sum is the same on every rank, so the
    cotangent that reaches it already is."""

    @staticmethod
    def forward(ctx, x, mesh):
        out = x.clone()
        dist.all_reduce(out, group=mesh.group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Replicated(torch.autograd.Function):
    """A tensor that is the same on every rank, entering a rank's own part of
    a sum over ranks; its backward sums the parts' gradients over ranks."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.mesh.group)
        return g, None


def sharded_lowrank_logpdf(fm, params: torch.Tensor, X: torch.Tensor, extra_diag,
                           y: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """log N(y; 0, Phi Phi^T + D) with the observation rows sharded over the
    mesh; X (n, d) and y (n,) the same on every rank, params (n_params,).

    ``fm`` is a ``kernels/features.py`` FeatureMap; each rank builds only its
    (n/P, m) feature rows, and its partial Phi^T D^-1 Phi and D^-1 Phi^T y
    (summed in blocks of rows, ``rows_matmul``) are summed over ranks.
    D = extra_diag + the bare-Noise diagonal.  The m x m capacitance's
    factor is ``ops.linalg.cholesky``'s (K1 on the card below m = 2048).
    Returns the same scalar on every rank, differentiable in ``params``."""
    n = X.shape[0]
    nb = _block_rows(n, mesh)
    extra_diag = torch.as_tensor(extra_diag, dtype=X.dtype, device=X.device)
    if extra_diag.ndim != 0:
        # a per-observation (n,) array would broadcast against the (n/P,)
        # local noise diag; fold per-row terms into fm.noise_diag instead
        raise ValueError(
            "extra_diag must be a scalar (jitter + obs variance); "
            "per-observation diagonals belong in the FeatureMap's noise_diag"
        )
    rows = slice(mesh.rank * nb, (mesh.rank + 1) * nb)
    X_l, y_l = X[rows], y[rows]
    params_r = _Replicated.apply(params, mesh)
    phi_l = fm.phi(params_r, X_l)                           # (n/P, m)
    d_l = extra_diag + fm.noise_diag(params_r, X_l)
    pod = phi_l / d_l[:, None]
    m = fm.m_total
    A = torch.eye(m, dtype=phi_l.dtype, device=phi_l.device) + _SumOverRanks.apply(
        rows_matmul(phi_l, pod), mesh)
    A = 0.5 * (A + A.mT)
    R = linalg.cholesky(A)
    b = _SumOverRanks.apply(rows_matmul(pod, y_l[:, None])[:, 0], mesh)   # (m,)
    u = linalg.solve_triangular(R, b, lower=True)
    local = torch.stack([torch.sum(y_l * y_l / d_l), torch.sum(torch.log(d_l))])
    yy, logd = _SumOverRanks.apply(local, mesh)
    quad = yy - torch.sum(u * u)
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(R))) + logd
    return -0.5 * (quad + logdet + n * _LOG_2PI)
