"""The port's GP posterior helpers (``gp_posterior_cache``,
``gp_predict_mean``/``_var``/``_cov``) against gaplac_tpu.ops.mvn on the
CPU, float64, at n = 64; ``mvn_logpdf``'s own adjoint against Murray's
pullback and gaplac_tpu under jax.grad, and the inverse by halves."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaplac_tpu.ops import mvn as jmvn
from gaplac_tpu_torch.ops import _build, cholesky, linalg, mvn

TOL = 1e-9


def _case(seed, n=64, nt=23):
    rng = np.random.default_rng(seed)
    x, xt = rng.uniform(-5, 5, n), rng.uniform(-6, 6, nt)
    k = lambda a, b: np.exp(-(a[:, None] - b[None, :]) ** 2 / (2 * 1.3 ** 2))
    return k(x, x) + 0.1 * np.eye(n), k(xt, x), k(xt, xt), rng.normal(size=n)


def _close(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL * np.abs(ref).max())


@pytest.mark.parametrize("noise", [1.0, 0.3, None])
def test_gp_posterior_matches_jax(noise):
    K_xx, K_tx, K_tt, y = _case(0)
    mean = 0.25
    jpost = jmvn.gp_posterior_cache(jnp.asarray(K_xx), jnp.asarray(y), noise, mean=mean)
    post = mvn.gp_posterior_cache(torch.as_tensor(K_xx), torch.as_tensor(y), noise, mean=mean)
    _close(post.L, jpost.L)
    _close(post.alpha, jpost.alpha)
    t_tx, t_tt = torch.as_tensor(K_tx), torch.as_tensor(K_tt)
    _close(mvn.gp_predict_mean(post, t_tx, prior_mean=mean),
           jmvn.gp_predict_mean(jpost, jnp.asarray(K_tx), prior_mean=mean))
    _close(mvn.gp_predict_var(post, t_tx, torch.diagonal(t_tt)),
           jmvn.gp_predict_var(jpost, jnp.asarray(K_tx), jnp.diagonal(jnp.asarray(K_tt))))
    _close(mvn.gp_predict_cov(post, t_tx, t_tt),
           jmvn.gp_predict_cov(jpost, jnp.asarray(K_tx), jnp.asarray(K_tt)))


# ---------------------------------------------------------------------------
# mvn_logpdf's own adjoint and the inverse by halves
# ---------------------------------------------------------------------------

ADJ_TOL = 1e-9  # float64 gradients of well-conditioned K, relative to their largest entry


def _spd(shape, seed):
    """X X^T / n + I, float64: eigenvalues in [1, about 5]."""
    n = shape[-1]
    X = np.random.default_rng(seed).normal(size=shape)
    return X @ np.swapaxes(X, -1, -2) / n + np.eye(n)


def _murray(K, y, jitter):
    """The route the dense marginal took before: the factor under autograd
    (Murray's pullback), then mvn_logpdf_chol."""
    Kt = torch.as_tensor(K).requires_grad_(True)
    yt = torch.as_tensor(y).requires_grad_(True)
    lp = mvn.mvn_logpdf_chol(mvn.chol(Kt, jitter), yt)
    return (lp.detach(),) + torch.autograd.grad(lp.sum(), (Kt, yt))


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("route", ["batched", "2-D", "2-D blocked"])
@pytest.mark.parametrize("n", [5, cholesky.INV_LEAF, cholesky.INV_LEAF + 1, 300, 1000])
def test_adjoint_matches_murray_and_jax(monkeypatch, route, n):
    """Value and gradients in K and y of the new mvn_logpdf against the
    Murray route and gaplac_tpu's mvn_logpdf under jax.grad, float64; the
    blocked route by lowering BLOCKED_MIN_N below n."""
    if route == "2-D blocked":
        monkeypatch.setattr(linalg, "BLOCKED_MIN_N", 2)
    shape = (3, n, n) if route == "batched" else (n, n)
    K = _spd(shape, n)
    y = np.random.default_rng(n + 1).normal(size=shape[:-1])
    Kt = torch.as_tensor(K).requires_grad_(True)
    yt = torch.as_tensor(y).requires_grad_(True)
    lp = mvn.mvn_logpdf(Kt, yt, jitter=0.1)
    gK, gy = torch.autograd.grad(lp.sum(), (Kt, yt))

    lp_m, gK_m, gy_m = _murray(K, y, 0.1)
    np.testing.assert_allclose(lp.detach().numpy(), lp_m.numpy(), rtol=1e-12)
    assert _rel(gK, gK_m) < ADJ_TOL and _rel(gy, gy_m) < ADJ_TOL

    def jlp(k, v):
        return jmvn.mvn_logpdf(k, v, jitter=0.1)

    f = jax.vmap(jlp) if route == "batched" else jlp
    lp_j = f(jnp.asarray(K), jnp.asarray(y))
    gK_j, gy_j = jax.grad(lambda k, v: f(k, v).sum(), argnums=(0, 1))(jnp.asarray(K),
                                                                       jnp.asarray(y))
    np.testing.assert_allclose(lp.detach().numpy(), np.asarray(lp_j), rtol=1e-12)
    assert _rel(gK, gK_j) < ADJ_TOL and _rel(gy, gy_j) < ADJ_TOL


@pytest.mark.parametrize("base", [16, cholesky.INV_LEAF])
@pytest.mark.parametrize("shape", [(1, 1), (37, 37), (3, 255, 255), (300, 300), (2, 777, 777)])
def test_inverse_by_halves_matches_inv(shape, base):
    """cholesky_inverse at sizes that are not powers of two, leaves of 16
    (a deep recursion) and of the module's size."""
    K = torch.as_tensor(_spd(shape, sum(shape)))
    got = cholesky.cholesky_inverse(torch.linalg.cholesky(K), base)
    assert got.shape == K.shape
    assert _rel(got, torch.linalg.inv(K)) < 1e-12


def test_adjoint_non_pd_member_is_nan_in_its_own_chain_only():
    K = _spd((3, 40, 40), 8)
    K[1] = -np.eye(40)
    y = np.random.default_rng(9).normal(size=(3, 40))
    Kt = torch.as_tensor(K).requires_grad_(True)
    yt = torch.as_tensor(y).requires_grad_(True)
    lp = mvn.mvn_logpdf(Kt, yt)
    gK, gy = torch.autograd.grad(lp.sum(), (Kt, yt))
    for t in (lp.detach(), gK, gy):
        assert torch.isnan(t[1]).all()
        assert torch.isfinite(t[[0, 2]]).all()


def test_adjoint_counters():
    """One backward of mvn_logpdf raises the Gaussian adjoint's counter by
    one and leaves Murray's; a backward through the factor does the
    opposite; a forward alone raises neither."""
    K = torch.as_tensor(_spd((3, 20, 20), 10)).requires_grad_(True)
    y = torch.as_tensor(np.random.default_rng(11).normal(size=20))
    _build.reset_counts()
    with torch.no_grad():
        mvn.mvn_logpdf(K, y)
    assert _build.adjoints == {"gaussian": 0, "murray": 0}
    torch.autograd.grad(mvn.mvn_logpdf(K, y).sum(), K)
    assert _build.adjoints == {"gaussian": 1, "murray": 0}
    torch.autograd.grad(mvn.mvn_logpdf_chol(mvn.chol(K), y).sum(), K)
    assert _build.adjoints == {"gaussian": 1, "murray": 1}


def test_adjoint_in_y_alone():
    """y (n,) broadcast over K's batch, with a mean and K constant: y's
    gradient is the batch's sum of -K^{-1} (y - mean)."""
    K = torch.as_tensor(_spd((3, 30, 30), 12))
    y = torch.as_tensor(np.random.default_rng(13).normal(size=30)).requires_grad_(True)
    (gy,) = torch.autograd.grad(mvn.mvn_logpdf(K, y, mean=0.5).sum(), y)
    ref = -torch.linalg.solve(K, (y.detach() - 0.5).expand(3, 30)[..., None])[..., 0].sum(0)
    assert _rel(gy, ref) < ADJ_TOL
