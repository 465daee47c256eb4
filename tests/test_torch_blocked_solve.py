"""The port's recursive blocked triangular solves against gaplac_tpu's
(``blocked_solve_lower``/``_upper``), float64 on the CPU, on the same numpy
inputs, with a small base so the recursion runs several levels."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaplac_tpu.ops import cholesky as JC
from gaplac_tpu_torch.ops import cholesky as TC

BASE = 16


def _factor(n, seed):
    A = np.random.default_rng(seed).normal(size=(n, n))
    return np.linalg.cholesky(A @ A.T + n * np.eye(n))


@pytest.mark.parametrize("upper", [False, True])
@pytest.mark.parametrize("n, k", [(64, None), (61, None), (64, 64), (50, 7), (16, 3), (9, 1)])
def test_blocked_solve_matches_jax(n, k, upper):
    """Vector (k None) and matrix right-hand sides; n a multiple of the base,
    not one, and at or below it (a single leaf)."""
    rng = np.random.default_rng(n + (k or 0))
    L = _factor(n, n)
    T = L.T if upper else L
    B = rng.normal(size=(n,) if k is None else (n, k))
    jfn, tfn = ((JC.blocked_solve_upper, TC.blocked_solve_upper) if upper
                else (JC.blocked_solve_lower, TC.blocked_solve_lower))
    ref = np.asarray(jfn(jnp.asarray(T), jnp.asarray(B), base=BASE))
    got = tfn(torch.as_tensor(T), torch.as_tensor(B), base=BASE)
    assert got.shape == B.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12, atol=1e-12 * np.abs(ref).max())
    np.testing.assert_allclose(T @ got.numpy(), B, rtol=1e-10, atol=1e-10)


def test_blocked_solve_leaves_its_inputs_alone():
    L = torch.as_tensor(_factor(48, 1))
    B = torch.randn(48, 5, dtype=torch.float64, generator=torch.Generator().manual_seed(2))
    L0, B0 = L.clone(), B.clone()
    TC.blocked_solve_lower(L, B, base=BASE)
    TC.blocked_solve_upper(L.mT, B, base=BASE)
    assert torch.equal(L, L0) and torch.equal(B, B0)
