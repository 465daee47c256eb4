"""Parity of kernel K3's plain version and of the port's recursive blocked
factorization with gaplac_tpu's, on the CPU: the tile sweep
(``_chol_sweep_lax``), the Pallas tile kernel in interpret mode, and
``blocked_cholesky`` with a small base so the recursion has several levels
and a ragged tail; then the routing of ``linalg.cholesky`` and the blocked
route's gradient."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from gaplac_tpu.ops import cholesky as C
from gaplac_tpu_torch.ops import cholesky as TC
from gaplac_tpu_torch.ops import linalg

F64_TOL = 1e-12        # float64 factors of well-conditioned matrices
PALLAS_F32_TOL = 1e-4  # against the float32 Pallas kernel in interpret mode
GRAD_TOL = 1e-9        # float64 pullbacks: two triangular solves each


def _spd(n, seed):
    X = np.random.default_rng(seed).normal(size=(n, n))
    return X @ X.T + n * np.eye(n)


@pytest.mark.parametrize("n", [37, 127, 128])
def test_chol_tile_plain_matches_lax_sweep(n):
    A = _spd(n, n)
    ref = np.asarray(C._chol_sweep_lax(jnp.asarray(A)))
    np.testing.assert_allclose(TC.chol_tile_plain(torch.as_tensor(A)).numpy(), ref,
                               rtol=F64_TOL, atol=F64_TOL)


def test_chol_tile_plain_matches_pallas_tile_kernel_interpret():
    A = _spd(128, 1).astype(np.float32)
    Lk = pl.pallas_call(C._chol_tile_kernel, out_shape=jax.ShapeDtypeStruct(A.shape, A.dtype),
                        interpret=True)(jnp.asarray(A))
    np.testing.assert_allclose(TC.chol_tile_plain(torch.as_tensor(A)).numpy(), np.asarray(Lk),
                               rtol=PALLAS_F32_TOL, atol=PALLAS_F32_TOL)


def test_chol_tile_plain_fails_with_nan():
    L = TC.chol_tile_plain(-torch.eye(5, dtype=torch.float64))
    assert torch.isnan(L).all()


@pytest.mark.parametrize("n", [300, 512, 2100])
def test_blocked_cholesky_matches_jax(n):
    A = _spd(n, n)
    ref = np.asarray(C.blocked_cholesky(jnp.asarray(A), base=64))
    got = TC.blocked_cholesky(torch.as_tensor(A), base=64).numpy()
    np.testing.assert_allclose(got, ref, rtol=F64_TOL, atol=F64_TOL)


@pytest.mark.parametrize("n", [100, 2048, 5000, 9000])
def test_split_point_matches_jax(n):
    for base in (64, 128, 256):
        assert TC._split_point(n, base) == C._split_point(n, base)


def _counting(monkeypatch, name):
    calls = []
    fn = getattr(TC, name)
    monkeypatch.setattr(TC, name, lambda A, *out: calls.append(tuple(A.shape)) or fn(A, *out))
    return calls


def test_linalg_cholesky_routes_2d_large_to_blocked(monkeypatch):
    tiles = _counting(monkeypatch, "chol_tile")
    batched = _counting(monkeypatch, "chol_batched")
    n = linalg.BLOCKED_MIN_N
    A = torch.as_tensor(_spd(n, 3))
    L = linalg.cholesky(A)
    assert tiles == [(TC.CHOL_TILE, TC.CHOL_TILE)] * (n // TC.CHOL_TILE) and not batched
    np.testing.assert_allclose(L.numpy(), np.linalg.cholesky(A.numpy()), rtol=F64_TOL,
                               atol=F64_TOL * n)
    tiles.clear()
    linalg.cholesky(A[None, :300, :300].expand(2, -1, -1))  # batched: K1's route
    linalg.cholesky(A[:n - 1, :n - 1][:300, :300])          # 2-D below the threshold
    assert not tiles and batched == [(2, 300, 300), (300, 300)]


def test_blocked_route_gradient_matches_batched():
    A = _spd(300, 4)
    W = torch.as_tensor(np.random.default_rng(5).normal(size=A.shape))
    grads = []
    for fn in (TC.CholeskyBlocked.apply, TC.CholeskyBatched.apply):
        At = torch.as_tensor(A).requires_grad_(True)
        (g,) = torch.autograd.grad((torch.sin(fn(At)) * W).sum(), At)
        grads.append(g.numpy())
    np.testing.assert_allclose(grads[0], grads[1], rtol=GRAD_TOL, atol=1e-12)


def test_blocked_cholesky_leaves_its_input_unmodified():
    """The recursion reads views of A and writes views of its own factor."""
    A = torch.as_tensor(_spd(300, 6))
    before = A.clone()
    L = TC.blocked_cholesky(A, base=64)
    assert torch.equal(A, before)
    assert L.data_ptr() != A.data_ptr()
    np.testing.assert_allclose(L.numpy(), np.linalg.cholesky(before.numpy()), rtol=F64_TOL,
                               atol=F64_TOL * 300)


def test_chol_tile_writes_into_its_view_and_nowhere_else():
    """chol_tile reads a block of a larger matrix and writes the factor into a
    block of another; every entry outside the output block keeps its value."""
    n = 37
    big = torch.as_tensor(np.random.default_rng(8).normal(size=(60, 70)))
    big[5:5 + n, 9:9 + n] = torch.as_tensor(_spd(n, 9))
    out = torch.full((50, 80), 7.0, dtype=torch.float64)
    view = out[3:3 + n, 11:11 + n]
    assert TC.chol_tile(big[5:5 + n, 9:9 + n], view) is view
    np.testing.assert_allclose(view.numpy(), np.linalg.cholesky(_spd(n, 9)), rtol=F64_TOL,
                               atol=F64_TOL)
    outside = torch.ones_like(out, dtype=torch.bool)
    outside[3:3 + n, 11:11 + n] = False
    assert (out[outside] == 7.0).all()
