"""Linear-algebra seam (port of ``gaplac_tpu/ops/linalg.py``).

``cholesky`` sends every factorization, 2-D or batched, through
``CholeskyBatched``: kernel K1 for a CUDA tensor, its plain version for a CPU
tensor.  ``solve_triangular`` stays on ``torch.linalg.solve_triangular``, as
``gaplac_tpu`` left it to XLA.  The TPU registry of blocked overrides and
min-n thresholds has no counterpart here.
"""

from __future__ import annotations

import torch

from gaplac_tpu_torch.ops.cholesky import CholeskyBatched


def cholesky(K: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of (..., n, n); NaN for a failed member."""
    return CholeskyBatched.apply(K)


def solve_triangular(L: torch.Tensor, b: torch.Tensor, lower: bool = True) -> torch.Tensor:
    """Solve L x = b for L (..., n, n).  A b with fewer dims than L is a
    vector (..., n), broadcast over L's batch; else b is (..., n, k)."""
    if b.dim() < L.dim():
        b = b.expand(*L.shape[:-2], b.shape[-1])
        return torch.linalg.solve_triangular(L, b.unsqueeze(-1), upper=not lower).squeeze(-1)
    return torch.linalg.solve_triangular(L, b, upper=not lower)
