"""The port's GP posterior helpers (``gp_posterior_cache``,
``gp_predict_mean``/``_var``/``_cov``) against gaplac_tpu.ops.mvn on the
CPU, float64, at n = 64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaplac_tpu.ops import mvn as jmvn
from gaplac_tpu_torch.ops import mvn

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
