"""Parity of the port's batched Cholesky (kernel K1's plain version) and of
``CholeskyBatched``'s pullback with gaplac_tpu's ``cholesky_small_batched``
and its Pallas kernel, on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gaplac_tpu.ops import cholesky as C
from gaplac_tpu_torch.ops.cholesky import CholeskyBatched, chol_batched, chol_batched_plain
from gaplac_tpu_torch.ops import linalg, mvn

FWD_TOL = 1e-12        # float64 factors of well-conditioned matrices
GRAD_TOL = 1e-9        # float64 pullbacks: two triangular solves each
PALLAS_F32_TOL = 1e-4  # against the float32 Pallas kernel in interpret mode


def _spd(B, n, seed):
    X = np.random.default_rng(seed).normal(size=(B, n, n))
    return X @ np.swapaxes(X, -1, -2) + n * np.eye(n)


def test_forward_matches_cholesky_small_batched():
    A = _spd(3, 37, 0)
    ref = np.asarray(C.cholesky_small_batched(jnp.asarray(A)))
    np.testing.assert_allclose(chol_batched(torch.as_tensor(A)).numpy(), ref,
                               rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(linalg.cholesky(torch.as_tensor(A[0])).numpy(), ref[0],
                               rtol=FWD_TOL, atol=FWD_TOL)


def test_forward_matches_pallas_kernel_interpret():
    """The Pallas kernel factors the identity-padded float32 slab; its
    leading block is the factor."""
    B, n, pn = 2, 37, 128
    A = _spd(B, n, 1).astype(np.float32)
    P = np.zeros((B, pn, pn), np.float32)
    P[:, :n, :n] = A
    P[:, np.arange(n, pn), np.arange(n, pn)] = 1.0
    Lk = np.asarray(C._chol_batched_pallas(jnp.asarray(P), interpret=True))[:, :n, :n]
    got = chol_batched(torch.as_tensor(A)).numpy()
    np.testing.assert_allclose(got, Lk, rtol=PALLAS_F32_TOL, atol=PALLAS_F32_TOL)


def test_pullback_matches_cholesky_small_batched():
    A = _spd(3, 37, 2)
    W = np.random.default_rng(3).normal(size=A.shape)
    ref = np.asarray(jax.jit(jax.grad(
        lambda a: jnp.sum(jnp.sin(C.cholesky_small_batched(a)) * W)))(jnp.asarray(A)))
    At = torch.as_tensor(A).requires_grad_(True)
    (g,) = torch.autograd.grad((torch.sin(CholeskyBatched.apply(At)) * torch.as_tensor(W)).sum(),
                               At)
    np.testing.assert_allclose(g.numpy(), ref, rtol=GRAD_TOL, atol=1e-12)


def test_lengthscale_gradient_through_factor_matches_jax():
    """θ-gradient through a symmetric gram and the factor (the sampler path)."""
    rng = np.random.default_rng(4)
    B, n = 3, 50
    x = rng.uniform(-5, 5, n)
    D2 = (x[:, None] - x[None, :]) ** 2
    z = rng.normal(size=(B, n))
    ls = rng.uniform(1, 2, B)

    def jf(l):
        K = jnp.exp(jnp.asarray(D2) * (-0.5 / (l[:, None, None] ** 2))) + 1.1 * jnp.eye(n)
        return jnp.sum(jnp.einsum("bij,bj->bi", C.cholesky_small_batched(K), z) ** 2)

    lt = torch.as_tensor(ls).requires_grad_(True)
    K = torch.exp(torch.as_tensor(D2) * (-0.5 / lt[:, None, None] ** 2)) + 1.1 * torch.eye(
        n, dtype=torch.float64)
    out = ((linalg.cholesky(K) @ torch.as_tensor(z)[..., None])[..., 0] ** 2).sum()
    (g,) = torch.autograd.grad(out, lt)
    np.testing.assert_allclose(g.numpy(), np.asarray(jax.jit(jax.grad(jf))(jnp.asarray(ls))),
                               rtol=1e-10)


def test_non_pd_member_is_nan():
    A = _spd(3, 12, 5)
    A[1] = -np.eye(12)
    L = chol_batched_plain(torch.as_tensor(A))
    assert torch.isnan(L[1]).all()
    assert torch.isfinite(L[[0, 2]]).all()
    # jnp.linalg.cholesky, the XLA route gaplac_tpu's main path takes, also
    # gives NaN over that member's factor (its lower triangle)
    Lj = np.asarray(jnp.linalg.cholesky(jnp.asarray(A)))
    assert np.isnan(Lj[1][np.tril_indices(12)]).all()


def test_mvn_logpdf_matches_jax():
    from gaplac_tpu.ops import mvn as jmvn

    A = _spd(4, 20, 6)
    y = np.random.default_rng(7).normal(size=(4, 20))
    ref = np.stack([np.asarray(jmvn.mvn_logpdf(jnp.asarray(A[b]), jnp.asarray(y[b]),
                                               jitter=0.1)) for b in range(4)])
    got = mvn.mvn_logpdf(torch.as_tensor(A), torch.as_tensor(y), jitter=0.1).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12)
