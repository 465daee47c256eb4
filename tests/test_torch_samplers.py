"""The port's HMC building blocks against gaplac_tpu's, fed the same numbers,
and its NUTS and ChEES samplers against a quadrature posterior (the oracle
of tests/test_posterior_exact.py), float64 on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import logsumexp

from gaplac_tpu.inference import chees as jchees
from gaplac_tpu.inference import hmc as jhmc
from gaplac_tpu_torch.dsl import parse_formula
from gaplac_tpu_torch.inference import hmc
from gaplac_tpu_torch.inference.chees import halton, run_chees
from gaplac_tpu_torch.inference.model import build_model
from gaplac_tpu_torch.inference.nuts import run_nuts
from gaplac_tpu_torch.kernels.covariance import compile_formula

KS_TOL = 0.12   # as tests/test_posterior_exact.py


def test_leapfrog_step_matches_jax_exactly():
    rng = np.random.default_rng(0)
    a, q, p, im = (rng.uniform(0.5, 2, 6), rng.normal(size=6), rng.normal(size=6),
                   rng.uniform(0.5, 2, 6))

    def jvag(x):
        return -0.5 * jnp.sum(a * x * x), -a * x

    def tvag(x):
        at = torch.as_tensor(a)
        return -0.5 * torch.sum(at * x * x), -at * x

    js = jhmc.LeapfrogState(jnp.asarray(q), jnp.asarray(p), *jvag(jnp.asarray(q)))
    ts = hmc.LeapfrogState(torch.as_tensor(q), torch.as_tensor(p), *tvag(torch.as_tensor(q)))
    for _ in range(5):
        js = jhmc.leapfrog_step(jvag, js, 0.17, jnp.asarray(im))
        ts = hmc.leapfrog_step(tvag, ts, 0.17, torch.as_tensor(im))
    for jx, tx in zip(js, ts):
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))


def test_dual_averaging_matches_jax_exactly():
    accs = np.random.default_rng(1).uniform(size=40)
    js, ts = jhmc.da_init(jnp.asarray(0.3)), hmc.da_init(0.3)
    for acc in accs:
        js = jhmc.da_update(js, jnp.asarray(acc))
        ts = hmc.da_update(ts, float(acc))
        np.testing.assert_array_equal(np.asarray(ts, float), np.asarray([float(v) for v in js]))


def test_welford_matches_jax_exactly():
    X = np.random.default_rng(2).normal(size=(30, 5))
    js, ts = jhmc.welford_init(5, jnp.float64), hmc.welford_init(5)
    for x in X:
        js = jhmc.welford_update(js, jnp.asarray(x))
        ts = hmc.welford_update(ts, torch.as_tensor(x))
    np.testing.assert_array_equal(ts.mean.numpy(), np.asarray(js.mean))
    np.testing.assert_array_equal(ts.m2.numpy(), np.asarray(js.m2))
    np.testing.assert_array_equal(hmc.welford_variance(ts).numpy(),
                                  np.asarray(jhmc.welford_variance(js)))
    # the batched (cross-chain) fold of ChEES: its batch means are reductions,
    # which torch and XLA sum in different orders (last-bit differences)
    jb, tb = jhmc.welford_init(5, jnp.float64), hmc.welford_init(5)
    for k in range(3):
        jb = jchees._welford_update_batch(jb, jnp.asarray(X[10 * k:10 * k + 10]))
        tb = hmc.welford_update_batch(tb, torch.as_tensor(X[10 * k:10 * k + 10]))
    np.testing.assert_allclose(tb.mean.numpy(), np.asarray(jb.mean), rtol=1e-14, atol=1e-16)
    np.testing.assert_allclose(tb.m2.numpy(), np.asarray(jb.m2), rtol=1e-14)
    np.testing.assert_array_equal(hmc.welford_variance(hmc.welford_init(5)).numpy(),
                                  np.asarray(jhmc.welford_variance(jhmc.welford_init(5))))


@pytest.mark.parametrize("num_warmup", [0, 19, 20, 100, 149, 150, 500, 1000])
def test_stan_warmup_schedule_matches_jax_exactly(num_warmup):
    js, ts = jhmc.stan_warmup_schedule(num_warmup), hmc.stan_warmup_schedule(num_warmup)
    np.testing.assert_array_equal(ts.in_slow_window, js.in_slow_window)
    np.testing.assert_array_equal(ts.window_end, js.window_end)


def test_halton_matches_jax_exactly():
    for i in (0, 1, 2, 7, 100, 4095, 70000):
        assert halton(i) == float(jchees._halton(jnp.asarray(i)))


# ---------------------------------------------------------------------------
# samplers against a quadrature posterior
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def quadrature():
    """n = 30 points from SqExp(l=1.5) + 0.1 jitter, and the quadrature CDF of
    p(l | y) under Uniform(0, 20) for the marginal model K + 1.1 I."""
    rng = np.random.default_rng(42)
    n = 30
    x = rng.uniform(-5, 5, n)
    d2 = (x[:, None] - x[None, :]) ** 2
    y = np.linalg.cholesky(np.exp(-d2 / (2 * 1.5 ** 2)) + 0.1 * np.eye(n)) @ rng.normal(size=n)
    ls = np.linspace(0.01, 19.99, 600)
    lps = []
    for l in ls:
        L = np.linalg.cholesky(np.exp(-d2 / (2 * l * l)) + 1.1 * np.eye(n))
        a = np.linalg.solve(L, y)
        lps.append(-0.5 * a @ a - np.log(np.diag(L)).sum())
    post = np.exp(np.asarray(lps) - logsumexp(lps))
    cdf = np.cumsum(post / post.sum())
    spec = parse_formula("y ~| SqExp(:x)")
    model = build_model(compile_formula(spec.formula), ["x"], torch.as_tensor(x[:, None]),
                        torch.as_tensor(y), spec.likelihood)
    return model, ls, cdf


def _ks(samples, ls, cdf):
    samples = np.sort(samples)
    emp = np.arange(1, len(samples) + 1) / len(samples)
    return np.max(np.abs(emp - np.interp(samples, ls, cdf)))


def test_nuts_matches_quadrature(quadrature):
    model, ls, cdf = quadrature
    gen = torch.Generator().manual_seed(14)
    q0 = model.initial_position(gen, 1)[0]
    res = run_nuts(gen, lambda q: model.logdensity(q[None])[0], q0, 600, num_warmup=200)
    ells = model.constrain(res.positions).numpy().ravel()
    assert _ks(ells, ls, cdf) < KS_TOL
    assert res.accept_prob.mean() > 0.5 and not res.diverging.any()


def test_chees_matches_quadrature(quadrature):
    model, ls, cdf = quadrature
    gen = torch.Generator().manual_seed(6)
    res = run_chees(gen, model.logdensity, model.initial_position(gen, 16), 60, num_warmup=150)
    ells = model.constrain(res.positions).numpy().ravel()
    assert res.positions.shape == (16, 60, 1)
    assert _ks(ells, ls, cdf) < KS_TOL
