"""The port's dense Laplace approximation against gaplac_tpu's, float64 on
the CPU, on the same numpy inputs: the mode, the marginal and W for each
non-Gaussian likelihood, the closed-form diagonal Hessians against
``jax.grad(jax.grad(.))``, the Laplace marginal model's log density and
gradient against ``jax.grad``, the exact-for-Gaussian oracle, and the CLI
refusing a Gaussian likelihood."""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from gaplac_tpu.dsl import parse_formula as jax_parse
from gaplac_tpu.dsl import parse_likelihood as jax_parse_likelihood
from gaplac_tpu.inference import laplace as jlaplace
from gaplac_tpu.inference.likelihoods import make_loglik as jax_make_loglik
from gaplac_tpu.inference.model import slot_groups_for as jax_slot_groups
from gaplac_tpu.kernels.covariance import compile_formula as jax_compile
from gaplac_tpu_torch.cli.main import main
from gaplac_tpu_torch.dsl import parse_formula
from gaplac_tpu_torch.dsl.parser import parse_likelihood
from gaplac_tpu_torch.inference import laplace
from gaplac_tpu_torch.inference.hmc import value_and_grad
from gaplac_tpu_torch.inference.likelihoods import make_loglik, make_loglik_derivs
from gaplac_tpu_torch.inference.model import slot_groups_for
from gaplac_tpu_torch.kernels.covariance import compile_formula

N = 24
#: (likelihood, a response drawn for latent f, the trials column or None)
LIKELIHOODS = {
    "Bernoulli": lambda rng, f: ((rng.uniform(size=f.shape) < 1 / (1 + np.exp(-f))) * 1.0,
                                 None),
    "Poisson": lambda rng, f: (rng.poisson(np.exp(0.5 * f)) * 1.0, None),
    "StudentT(3.0, 0.7)": lambda rng, f: (f + 0.7 * rng.standard_t(3.0, f.shape), None),
    "Binomial(Reads)": lambda rng, f: _binomial(rng, f),
}


def _binomial(rng, f):
    trials = rng.integers(1, 12, f.shape) * 1.0
    return rng.binomial(trials.astype(int), 1 / (1 + np.exp(-f))) * 1.0, trials


def _close(got, ref, rtol):
    got, ref = np.asarray(got, float), np.asarray(ref, float)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * max(np.abs(ref).max(), 1.0))


def _problem(lik, seed=0, n=N):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(-4, 4, n))
    y, aux = LIKELIHOODS[lik](rng, 2 * np.sin(1.3 * x))
    return x, y, aux


def _K(x, ell=1.5):
    return np.exp(-(x[:, None] - x[None, :]) ** 2 / (2 * ell * ell)) + 0.1 * np.eye(len(x))


def _t(a):
    return None if a is None else torch.as_tensor(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("lik", list(LIKELIHOODS))
def test_diag_hess_matches_jax(lik):
    """Closed-form second derivatives (and first) against jax.grad(jax.grad)."""
    rng = np.random.default_rng(1)
    _, y, aux = _problem(lik, 1)
    f = rng.normal(size=N) * 2
    jll = jax_make_loglik(jax_parse_likelihood(lik))
    derivs = make_loglik_derivs(parse_likelihood(lik))
    ref_h = jlaplace._diag_hess(jll, _j(y), _j(f), _j(aux))
    _close(laplace._diag_hess(derivs, _t(y), _t(f), _t(aux)), ref_h, 1e-12)
    ref_g = jax.grad(lambda v: jnp.sum(jll(_j(y), v, _j(aux))))(_j(f))
    _close(derivs(_t(y), _t(f), _t(aux))[0], ref_g, 1e-12)


@pytest.mark.parametrize("lik", list(LIKELIHOODS))
def test_laplace_approx_matches_jax(lik):
    """f_mode, log_marginal and W on the same K and y, one K and a batch."""
    x, y, aux = _problem(lik, 2)
    K = _K(x)
    ref = jlaplace.laplace_approx(jnp.asarray(K), _j(y), jax_make_loglik(jax_parse_likelihood(lik)),
                                  _j(aux))
    spec = parse_likelihood(lik)
    got = laplace.laplace_approx(torch.as_tensor(K), _t(y), make_loglik(spec),
                                 make_loglik_derivs(spec), _t(aux))
    for g, r in zip(got, ref):
        _close(g, r, 1e-9)
    Kb = torch.as_tensor(np.stack([_K(x, 0.8), K]))
    batched = laplace.laplace_approx(Kb, _t(y), make_loglik(spec), make_loglik_derivs(spec),
                                     _t(aux))
    for g, r in zip(batched, got):
        _close(g[1], r, 1e-12)


@pytest.mark.parametrize("lik", ["Bernoulli", "Binomial(Reads)"])
def test_laplace_marginal_model_matches_jax_grad(lik):
    """build_laplace_marginal's log density and gradient at three theta,
    batched over them, against gaplac_tpu's with jax.grad."""
    x, y, aux = _problem(lik, 3)
    formula = f"y : {lik} ~| SqExp(:x)"
    jck = jax_compile(jax_parse(formula).formula)
    ck = compile_formula(parse_formula(formula).formula)
    jm = jlaplace.build_laplace_marginal(jck, jax_slot_groups(jck, ["x"]), jnp.asarray(x[:, None]),
                                         _j(y), jax_parse(formula).likelihood, aux=_j(aux))
    m = laplace.build_laplace_marginal(ck, slot_groups_for(ck, ["x"]), torch.as_tensor(x[:, None]),
                                       _t(y), parse_formula(formula).likelihood, aux=_t(aux))
    us = np.array([[-1.0], [0.2], [1.1]])
    lp, g = value_and_grad(m.logdensity)(torch.as_tensor(us))
    jvag = jax.jit(jax.value_and_grad(jm.logdensity))
    for i, u in enumerate(us):
        ref_lp, ref_g = jvag(jnp.asarray(u))
        _close(lp[i], ref_lp, 1e-9)
        _close(g[i], ref_g, 1e-9)
    theta, f, lp_r = m.report(torch.Generator().manual_seed(0), torch.as_tensor(us))
    assert theta.shape == (3, 1) and f.shape == (3, N) and torch.isfinite(lp_r).all()


def test_laplace_exact_for_gaussian():
    """tests/test_laplace.py's oracle: for a Gaussian likelihood the Laplace
    marginal is the exact log N(y; 0, K + s2 I)."""
    rng = np.random.default_rng(1)
    x = rng.uniform(-5, 5, 30)
    K = _K(x)
    y = np.linalg.cholesky(K) @ rng.normal(size=30)
    spec = parse_likelihood("Gaussian(0.5)")
    fit = laplace.laplace_approx(torch.as_tensor(K), torch.as_tensor(y), make_loglik(spec),
                                 make_loglik_derivs(spec))
    S = K + 0.5 * np.eye(30)
    exact = -0.5 * (y @ np.linalg.solve(S, y) + np.linalg.slogdet(S)[1] + 30 * np.log(2 * np.pi))
    np.testing.assert_allclose(float(fit.log_marginal), exact, rtol=1e-6)


def test_cli_laplace_rejects_gaussian(tmp_path, capsys):
    data = tmp_path / "d.tsv"
    pd.DataFrame({"x": [0.0, 1.0], "y": [0.0, 1.0]}).to_csv(data, sep="\t", index=False)
    rc = main(["--platform", "cpu", "mcmc", "y ~| SqExp(:x)", "--data", str(data), "--infer",
               "x", "--approx", "laplace", "--samples", "5"])
    assert rc == 2
    assert "non-Gaussian" in capsys.readouterr().err
