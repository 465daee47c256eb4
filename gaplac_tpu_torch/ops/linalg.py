"""Linear-algebra seam (port of ``gaplac_tpu/ops/linalg.py``).

``cholesky`` sends one 2-D matrix with n >= ``BLOCKED_MIN_N`` to the
recursive blocked factorization (``CholeskyBlocked``, base case kernel K3),
as ``gaplac_tpu/ops/__init__.py`` registers it (``register(min_n=2048)``);
every other factorization, batched or small, goes through
``CholeskyBatched`` (kernel K1).  The route depends only on the shape, so
the CPU runs the same algorithm with the kernels' plain versions.
``solve_triangular`` stays on ``torch.linalg.solve_triangular``: the blocked
solves (``ops/cholesky.py::blocked_solve_lower``/``_upper``) are not on a
route, since ``gaplac_tpu`` takes them only on the TPU.
"""

from __future__ import annotations

import torch

from gaplac_tpu_torch.ops.cholesky import CholeskyBatched, CholeskyBlocked

#: smallest n of a 2-D matrix that takes the blocked factorization
BLOCKED_MIN_N = 2048


def cholesky(K: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of (..., n, n); NaN for a failed member (for a
    failed tile of the blocked route, NaN from that tile on)."""
    if K.dim() == 2 and K.shape[-1] >= BLOCKED_MIN_N:
        return CholeskyBlocked.apply(K)
    return CholeskyBatched.apply(K)


def solve_triangular(L: torch.Tensor, b: torch.Tensor, lower: bool = True) -> torch.Tensor:
    """Solve L x = b for L (..., n, n).  A b with fewer dims than L is a
    vector (..., n), broadcast over L's batch; else b is (..., n, k)."""
    if b.dim() < L.dim():
        b = b.expand(*L.shape[:-2], b.shape[-1])
        return torch.linalg.solve_triangular(L, b.unsqueeze(-1), upper=not lower).squeeze(-1)
    return torch.linalg.solve_triangular(L, b, upper=not lower)
