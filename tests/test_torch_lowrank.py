"""The port's low-rank (Woodbury) ops and rff model against gaplac_tpu's,
float64 on the CPU: lowrank_chol, _solve, _logdet, _logpdf, the weight-space
posterior and its predictions to 1e-10, unbatched and as a batch of two;
the rff model's log density and gradient at C = 2 against jax.grad to 1e-9;
the samplers by their moments (tests/test_lowrank.py's oracles), since the
two RNGs differ."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaplac_tpu.dsl import parse_formula as jax_parse
from gaplac_tpu.inference.model import build_model as jax_build_model
from gaplac_tpu.kernels.covariance import compile_formula as jax_compile
from gaplac_tpu.ops import lowrank as jlr
from gaplac_tpu_torch.dsl import parse_formula
from gaplac_tpu_torch.inference.hmc import value_and_grad
from gaplac_tpu_torch.inference.model import build_model
from gaplac_tpu_torch.kernels.covariance import compile_formula
from gaplac_tpu_torch.ops import lowrank

RTOL = 1e-10


def _close(got, ref, rtol=RTOL):
    got, ref = np.asarray(got, float), np.asarray(ref, float)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * np.abs(ref).max())


def _rand(n=48, m=20, seed=7, C=None):
    rng = np.random.default_rng(seed)
    lead = () if C is None else (C,)
    return (rng.standard_normal(lead + (n, m)) / np.sqrt(m), rng.uniform(0.5, 2.0, lead + (n,)),
            rng.standard_normal(lead + (n,)))


def _t(*a):
    return [torch.as_tensor(x) for x in a]


@pytest.mark.parametrize("C", [None, 2])
def test_chol_solve_logdet_logpdf_match_jax(C):
    phi, d, y = _rand(C=C)
    Y = np.random.default_rng(8).standard_normal(phi.shape[:-1] + (3,))
    tphi, td, ty, tY = _t(phi, d, y, Y)
    lr = lowrank.lowrank_chol(tphi, td)
    for c in range(1 if C is None else C):
        sel = (lambda a: a) if C is None else (lambda a, c=c: a[c])
        jl = jlr.lowrank_chol(jnp.asarray(sel(phi)), jnp.asarray(sel(d)))
        _close(sel(lr.R), jl.R)
        _close(sel(lowrank.lowrank_solve(lr, ty)), jlr.lowrank_solve(jl, jnp.asarray(sel(y))))
        _close(sel(lowrank.lowrank_solve(lr, tY)), jlr.lowrank_solve(jl, jnp.asarray(sel(Y))))
        _close(sel(lowrank.lowrank_logdet(lr)), jlr.lowrank_logdet(jl))
        _close(sel(lowrank.lowrank_logpdf(tphi, td, ty, mean=0.3)),
               jlr.lowrank_logpdf(jnp.asarray(sel(phi)), jnp.asarray(sel(d)),
                                  jnp.asarray(sel(y)), mean=0.3))
    # a scalar diagonal and one vector shared by the batch broadcast
    _close(lowrank.lowrank_logpdf(tphi, 1.3, ty[..., 0, :] if C else ty),
           np.asarray([jlr.lowrank_logpdf(jnp.asarray(p), 1.3, jnp.asarray(y[0] if C else y))
                       for p in (phi if C else [phi])]).reshape(() if C is None else (C,)))


@pytest.mark.parametrize("n", [5, 2048, 2500])
def test_row_blocked_products_match_jax(n):
    """Products over the rows go in blocks of ROW_BLOCK rows (whole blocks
    and the rest): the same numbers as one product, and gaplac_tpu's log
    density past one block."""
    phi, d, y = _rand(n=n, m=6, seed=n)
    a, b = torch.as_tensor(phi), torch.as_tensor(np.stack([y, d], axis=1))
    _close(lowrank.rows_matmul(a, b), phi.T @ np.stack([y, d], axis=1))
    _close(lowrank.rows_matmul(a.expand(3, -1, -1), b)[2], phi.T @ np.stack([y, d], axis=1))
    _close(lowrank.lowrank_logpdf(*_t(phi, d, y)),
           jlr.lowrank_logpdf(jnp.asarray(phi), jnp.asarray(d), jnp.asarray(y)))


def test_posterior_and_predictions_match_jax():
    phi, d, y = _rand(n=40, m=12, seed=3)
    rng = np.random.default_rng(4)
    phi_t, d_t = rng.standard_normal((9, 12)) / np.sqrt(12), rng.uniform(0.1, 0.5, 9)
    post = lowrank.lowrank_posterior(*_t(phi, d, y), mean=0.2)
    jpost = jlr.lowrank_posterior(jnp.asarray(phi), jnp.asarray(d), jnp.asarray(y), mean=0.2)
    _close(post.w_mean, jpost.w_mean)
    _close(post.R, jpost.R)
    _close(lowrank.lowrank_predict_mean(post, torch.as_tensor(phi_t), prior_mean=0.2),
           jlr.lowrank_predict_mean(jpost, jnp.asarray(phi_t), prior_mean=0.2))
    _close(lowrank.lowrank_predict_var(post, *_t(phi_t, d_t)),
           jlr.lowrank_predict_var(jpost, jnp.asarray(phi_t), jnp.asarray(d_t)))


MODELS = [  # (formula, inferable, shared)
    ("y ~| SqExp(:x)", ["x"], True),
    ("y ~| SqExp(:t) * Cat(:g) + Linear(:x) + Periodic(:s; l=1.2, p=2.5) + Noise", ["t", "x"],
     False),
]


def _model_data(formula, n, seed):
    ck = compile_formula(parse_formula(formula).formula)
    rng = np.random.default_rng(seed)
    X = rng.uniform(-3, 3, (n, len(ck.varnames)))
    if "g" in ck.varnames:
        X[:, ck.varnames.index("g")] = rng.integers(0, 3, n)
    return X, rng.normal(size=n)


def _models(formula, inferable, shared, X, y, m=24):
    spec, jspec = parse_formula(formula), jax_parse(formula)
    kw = dict(shared_hyper=shared, approx="rff", rff_features=m, rff_seed=3)
    jm = jax_build_model(jax_compile(jspec.formula), inferable, jnp.asarray(X), jnp.asarray(y),
                         jspec.likelihood, **kw)
    tm = build_model(compile_formula(spec.formula), inferable, torch.as_tensor(X),
                     torch.as_tensor(y), spec.likelihood, **kw)
    return jm, tm


@pytest.mark.parametrize("case", MODELS, ids=lambda c: c[0][5:25])
def test_rff_model_logdensity_and_gradient_match_jax(case):
    formula, inferable, shared = case
    X, y = _model_data(formula, 40, 1)
    jm, tm = _models(formula, inferable, shared, X, y)
    assert tm.dim == jm.dim and tm.marginalized
    U = np.random.default_rng(2).uniform(-1.5, 1.5, (2, tm.dim))
    ref_lp, ref_g = map(np.asarray, jax.jit(jax.vmap(jax.value_and_grad(jm.logdensity)))(
        jnp.asarray(U)))
    lp, g = value_and_grad(tm.logdensity)(torch.as_tensor(U))
    _close(lp, ref_lp, 1e-9)
    _close(g, ref_g, 1e-9)
    # the report: theta as gaplac_tpu's, a finite latent draw and joint lp
    theta, f, lps = tm.report(torch.Generator().manual_seed(0), torch.as_tensor(U))
    _close(theta, jax.vmap(jm.constrain)(jnp.asarray(U)))
    assert f.shape == (2, 40) and torch.isfinite(f).all() and torch.isfinite(lps).all()


def test_rff_refusals_match_jax():
    """gaplac_tpu's two ValueErrors: a non-Gaussian likelihood, --infer-extra."""
    X, y = _model_data("y ~| SqExp(:x)", 10, 0)
    for formula, extras in (("y : Bernoulli ~| SqExp(:x)", []),
                            ("y ~| Periodic(:x; l=1.0, p=2.0)", ["x"])):
        msgs = []
        for parse, compile_, build, arr in ((jax_parse, jax_compile, jax_build_model, jnp.asarray),
                                            (parse_formula, compile_formula, build_model,
                                             torch.as_tensor)):
            spec = parse(formula)
            with pytest.raises(ValueError) as e:
                build(compile_(spec.formula), ["x"], arr(X), arr((y > 0).astype(float)),
                      spec.likelihood, approx="rff", infer_extras=extras)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


def test_sample_lowrank_moments():
    phi, d, _ = _rand(n=30, m=6, seed=7)
    K = phi @ phi.T + np.diag(d)
    draws = lowrank.sample_lowrank(torch.Generator().manual_seed(0),
                                   torch.as_tensor(phi).expand(4000, -1, -1), torch.as_tensor(d))
    cov = np.cov(draws.numpy().T)
    assert np.abs(cov - K).max() < 0.35 * np.abs(np.diag(K)).max()


def test_conditional_sample_moments():
    """The batched Matheron draw has the exact conditional mean and cov."""
    phi, d0, y = _rand(n=25, m=5, seed=13)
    phi = phi * np.sqrt(5)  # unit-variance features, as tests/test_lowrank.py
    s2 = 0.4
    C = phi @ phi.T + np.diag(d0)
    S = C + s2 * np.eye(25)
    mean_true = C @ np.linalg.solve(S, y)
    cov_true = C - C @ np.linalg.solve(S, C)
    draws = lowrank.lowrank_conditional_sample(
        torch.Generator().manual_seed(1), torch.as_tensor(phi).expand(6000, -1, -1),
        torch.as_tensor(d0), s2, torch.as_tensor(y)).numpy()
    assert np.abs(draws.mean(0) - mean_true).max() < 0.12
    assert np.abs(np.cov(draws.T) - cov_true).max() < 0.2


def test_conditional_sample_at_moments():
    """The Matheron draw at test features has the exact predictive moments."""
    phi, d0, y = _rand(n=25, m=5, seed=17)
    phi = phi * np.sqrt(5)
    rng = np.random.default_rng(18)
    phi_t, d0_t = rng.standard_normal((12, 5)), rng.uniform(0.2, 0.8, 12)
    s2 = 0.5
    K_tx = phi_t @ phi.T
    S = phi @ phi.T + np.diag(d0) + s2 * np.eye(25)
    mean_true = K_tx @ np.linalg.solve(S, y)
    cov_true = phi_t @ phi_t.T + np.diag(d0_t) - K_tx @ np.linalg.solve(S, K_tx.T)
    gen = torch.Generator().manual_seed(2)
    tphi, td0, ty, tphi_t, td0_t = _t(phi, d0, y, phi_t, d0_t)
    draws = np.stack([lowrank.lowrank_conditional_sample_at(gen, tphi, td0, s2, ty, tphi_t,
                                                            td0_t).numpy()
                      for _ in range(8000)])
    assert np.abs(draws.mean(0) - mean_true).max() < 0.1
    assert np.abs(np.cov(draws.T) - cov_true).max() < 0.25
