"""Parity of the port's dense models with gaplac_tpu's: log density and its
gradient at several points, marginal and whitened, float64 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaplac_tpu.dsl import parse_formula
from gaplac_tpu.inference.likelihoods import make_loglik as jax_make_loglik
from gaplac_tpu.inference.model import build_model as jax_build_model
from gaplac_tpu.inference.priors import parse_prior as jax_parse_prior
from gaplac_tpu.kernels.covariance import compile_formula as jax_compile
from gaplac_tpu_torch.dsl import parse_formula as torch_parse
from gaplac_tpu_torch.inference.hmc import value_and_grad
from gaplac_tpu_torch.inference.likelihoods import make_loglik
from gaplac_tpu_torch.inference.model import build_model
from gaplac_tpu_torch.inference.priors import parse_prior as torch_parse_prior
from gaplac_tpu_torch.kernels.covariance import compile_formula

RTOL = 1e-9   # float64 densities and gradients through a Cholesky at n <= 30

CASES = [
    # (formula, inferable, extras, shared, n, prior)
    ("y ~| SqExp(:x)", ["x"], [], True, 30, "Uniform(0,20)"),
    ("y ~| SqExp(:t) * Cat(:g) + Linear(:x) + OU(:t2) + Noise", ["t", "t2"], [], True, 24,
     "LogNormal(0.3,1.0)"),
    ("y ~| SqExp(:t) * Cat(:g) + Linear(:x) + OU(:t2) + Noise", ["t", "x"], [], False, 24,
     "Gamma(2.0,1.5)"),
    ("y ~| Matern32(:t) + Matern52(:t2) * Periodic(:s; l=1.2, p=2.5) + RQ(:x; l=0.8, alpha=1.5)",
     ["t"], ["s", "x"], False, 20, "TruncatedNormal(1.0,2.0,0.1,8.0)"),
]


def _data(formula, n, seed, counts=False):
    ck = jax_compile(parse_formula(formula).formula)
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, len(ck.varnames)))
    if "g" in ck.varnames:
        X[:, ck.varnames.index("g")] = np.floor(np.abs(X[:, 1]) * 2)
    if "x" in ck.varnames and formula.startswith("y ~| SqExp(:x)"):
        X[:, 0] = rng.uniform(-5, 5, n)
    y = rng.poisson(3.0, n).astype(float) if counts else rng.normal(size=n)
    return X, y


def _models(formula, inferable, extras, shared, X, y, prior, marginalize):
    spec = parse_formula(formula)
    jm = jax_build_model(jax_compile(spec.formula), inferable, jnp.asarray(X), jnp.asarray(y),
                         spec.likelihood, prior_bounds=jax_parse_prior(prior),
                         shared_hyper=shared, marginalize=marginalize, infer_extras=extras)
    tspec = torch_parse(formula)
    tm = build_model(compile_formula(tspec.formula), inferable, torch.as_tensor(X),
                     torch.as_tensor(y), tspec.likelihood, prior_bounds=torch_parse_prior(prior),
                     shared_hyper=shared, marginalize=marginalize, infer_extras=extras)
    return jm, tm


def _points(dim, nh, seed, k=4):
    rng = np.random.default_rng(seed)
    V = 0.3 * rng.normal(size=(k, dim))
    V[:, :nh] = rng.uniform(-1.5, 1.5, size=(k, nh))
    return V


def _check(jm, tm, V):
    ref_lp, ref_g = map(np.asarray, jax.jit(jax.vmap(jax.value_and_grad(jm.logdensity)))(
        jnp.asarray(V)))
    lp, g = value_and_grad(tm.logdensity)(torch.as_tensor(V))
    np.testing.assert_allclose(lp.numpy(), ref_lp, rtol=RTOL)
    np.testing.assert_allclose(g.numpy(), ref_g, rtol=RTOL, atol=RTOL * np.abs(ref_g).max())


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0][:28])
@pytest.mark.parametrize("marginalize", [True, False])
def test_logdensity_and_gradient_match_jax(case, marginalize):
    formula, inferable, extras, shared, n, prior = case
    X, y = _data(formula, n, 1)
    jm, tm = _models(formula, inferable, extras, shared, X, y, prior, marginalize)
    assert (tm.dim, tm.n_hyper, tm.marginalized) == (jm.dim, jm.n_hyper, jm.marginalized)
    _check(jm, tm, _points(tm.dim, tm.n_hyper, 2))


def test_poisson_whitened_logdensity_and_report_match_jax():
    formula = "y : Poisson ~| SqExp(:x)"
    X, y = _data("y ~| SqExp(:x)", 25, 3, counts=True)
    jm, tm = _models(formula, ["x"], [], True, X, y, "Uniform(0,20)", True)
    assert not tm.marginalized
    V = _points(tm.dim, 1, 4)
    _check(jm, tm, V)
    # the whitened report is deterministic given v: theta, f and lp agree
    theta, f, lp = tm.report(torch.Generator(), torch.as_tensor(V))
    report = jax.jit(jm.report)
    for b, v in enumerate(V):
        jt, jf, jlp = report(jax.random.key(0), jnp.asarray(v))
        np.testing.assert_allclose(theta[b].numpy(), np.asarray(jt), rtol=1e-12)
        np.testing.assert_allclose(f[b].numpy(), np.asarray(jf), rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(float(lp[b]), float(jlp), rtol=RTOL)


def test_position_from_inverts_report():
    X, y = _data("y ~| SqExp(:x)", 20, 5)
    _, tm = _models("y ~| SqExp(:x)", ["x"], [], True, X, y, "Uniform(0,20)", False)
    V = torch.as_tensor(_points(tm.dim, 1, 6, k=2))
    theta, f, _ = tm.report(torch.Generator(), V)
    for b in range(2):
        np.testing.assert_allclose(tm.position_from(theta[b], f[b]).numpy(), V[b].numpy(),
                                   rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("prior", ["Uniform(0,20)", "LogNormal(0.3,1.0)", "Gamma(2.0,1.5)",
                                   "TruncatedNormal(1.0,2.0,0.1,8.0)"])
def test_priors_match_jax(prior):
    jp, tp = jax_parse_prior(prior), torch_parse_prior(prior)
    u = np.linspace(-6, 6, 13)
    x = np.array([-1.0, 0.0, 0.05, 0.5, 3.0, 7.9, 19.0, 25.0])
    for name, arg in (("forward", u), ("logprior_u", u), ("logprior_x", x)):
        np.testing.assert_allclose(getattr(tp, name)(torch.as_tensor(arg)).numpy(),
                                   np.asarray(getattr(jp, name)(jnp.asarray(arg))), rtol=1e-13)
    inside = x[(x > max(getattr(tp, "lo", 0.0), 0.0)) & (x < getattr(tp, "hi", np.inf))]
    np.testing.assert_allclose(tp.inverse(torch.as_tensor(inside)).numpy(),
                               np.asarray(jp.inverse(jnp.asarray(inside))), rtol=1e-12)


@pytest.mark.parametrize("lik", ["y ~| SqExp(:x)", "y : Gaussian(0.3) ~| SqExp(:x)",
                                 "y : Bernoulli ~| SqExp(:x)", "y : Poisson ~| SqExp(:x)",
                                 "y : StudentT(3, 0.7) ~| SqExp(:x)",
                                 "y : Binomial(Reads) ~| SqExp(:x)"])
def test_likelihoods_match_jax(lik):
    rng = np.random.default_rng(8)
    y, f, aux = rng.integers(0, 6, 9).astype(float), rng.normal(size=9), np.full(9, 7.0)
    ref = jax_make_loglik(parse_formula(lik).likelihood)(jnp.asarray(y), jnp.asarray(f),
                                                         jnp.asarray(aux))
    got = make_loglik(torch_parse(lik).likelihood)(torch.as_tensor(y), torch.as_tensor(f),
                                                   torch.as_tensor(aux))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12)
