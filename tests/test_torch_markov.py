"""The port's associative scan and scalar OU state-space path against
gaplac_tpu's, float64 on the CPU: the scan against lax.associative_scan on
random affine elements (n in 1, 2, 3, 17, 64, forward and reverse) to
1e-12; ou_loglik, ou_smooth and ou_posterior_predict (with duplicate
times) to 1e-9, unbatched and over a batch of lengthscales; the prior
sampler by its moments, since the two RNGs differ."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from gaplac_tpu.ops import markov as jm
from gaplac_tpu_torch.ops import markov
from gaplac_tpu_torch.ops.scan import associative_scan

RTOL = 1e-9


def _close(got, ref, rtol=RTOL):
    got, ref = np.asarray(got, float), np.asarray(ref, float)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * np.abs(ref).max())


def _affine(e1, e2):
    """(M2, b2) o (M1, b1) = (M2 M1, M2 b1 + b2): not commutative, so an
    operand order mixed up shows."""
    return e2[0] @ e1[0], (e2[0] @ e1[1][..., None])[..., 0] + e2[1]


@pytest.mark.parametrize("n", [1, 2, 3, 17, 64])
@pytest.mark.parametrize("reverse", [False, True])
def test_scan_matches_lax(n, reverse):
    rng = np.random.default_rng(n)
    M = rng.normal(size=(3, n, 2, 2)) * 0.7
    b = rng.normal(size=(3, n, 2))
    ref = jax.jit(lambda M, b: lax.associative_scan(_affine, (M, b), reverse=reverse, axis=1))(
        jnp.asarray(M), jnp.asarray(b))
    got = associative_scan(_affine, (torch.tensor(M), torch.tensor(b)), reverse=reverse, axis=1)
    for g, r in zip(got, ref):
        _close(g, r, 1e-12)


def _series(n=40, seed=0, dup=True):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 10, n))
    if dup:
        t[5] = t[4]
        t[20] = t[19]
    y = np.sin(t) + 0.3 * rng.normal(size=n)
    return t, y


@pytest.mark.parametrize("R", [0.3, "rows"])
def test_ou_loglik_and_smooth_match_jax(R):
    t, y = _series()
    Rv = np.asarray(np.random.default_rng(1).uniform(0.1, 0.5, t.shape) if R == "rows" else R)
    for ell in (0.7, 2.5):
        ref = jax.jit(jm.ou_loglik)(jnp.asarray(t), jnp.asarray(y), ell, jnp.asarray(Rv))
        got = markov.ou_loglik(torch.tensor(t), torch.tensor(y), ell, torch.tensor(Rv))
        _close(got, ref)
        for g, r in zip(markov.ou_smooth(torch.tensor(t), torch.tensor(y), ell, torch.tensor(Rv)),
                        jax.jit(jm.ou_smooth)(jnp.asarray(t), jnp.asarray(y), ell,
                                              jnp.asarray(Rv))):
            _close(g, r)
    # a batch of three lengthscales at once, R per chain as (C, 1)
    ells = np.array([0.5, 1.3, 4.0])
    got = markov.ou_loglik(torch.tensor(t), torch.tensor(y), torch.tensor(ells),
                           torch.full((3, 1), 0.3, dtype=torch.float64))
    _close(got, jax.vmap(lambda e: jm.ou_loglik(jnp.asarray(t), jnp.asarray(y), e, 0.3))(
        jnp.asarray(ells)))


def test_ou_posterior_predict_matches_jax():
    t, y = _series(dup=True)
    t_new = np.concatenate([np.linspace(-1, 11, 9), t[3:5]])  # new points on data times too
    ref = jax.jit(jm.ou_posterior_predict)(jnp.asarray(t), jnp.asarray(y), 1.4, 0.2,
                                           jnp.asarray(t_new))
    got = markov.ou_posterior_predict(torch.tensor(t), torch.tensor(y), 1.4, 0.2,
                                      torch.tensor(t_new))
    for g, r in zip(got, ref):
        _close(g, r)


def test_ou_loglik_gradient_matches_jax():
    t, y = _series(n=32, dup=False)
    g_ref = jax.jit(jax.grad(lambda e: jm.ou_loglik(jnp.asarray(t), jnp.asarray(y), e, 0.4)))(1.7)
    ell = torch.tensor(1.7, dtype=torch.float64, requires_grad=True)
    markov.ou_loglik(torch.tensor(t), torch.tensor(y), ell, 0.4).backward()
    _close(ell.grad, g_ref)


def test_ou_prior_sample_moments():
    t = np.linspace(0, 5, 6)
    gen = torch.Generator().manual_seed(0)
    x = markov.ou_prior_sample(gen, torch.tensor(t), torch.full((20000,), 1.5, dtype=torch.float64))
    K = np.exp(-np.abs(t[:, None] - t[None, :]) / 1.5)
    emp = np.cov(x.numpy().T)
    assert np.abs(emp - K).max() < 0.05
    assert np.abs(x.numpy().mean(0)).max() < 0.05
