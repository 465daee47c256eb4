"""The port's ADVI and tempered SMC against gaplac_tpu's, float64 on the
CPU: the ELBO and its gradient on the same draws, one Adam step against
optax's, systematic resampling and the bisection for the next temperature
on the same inputs, and the analytic oracles of tests/test_vi_smc.py."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from scipy import stats
from scipy.special import logsumexp

from gaplac_tpu.dsl import parse_formula as jax_parse
from gaplac_tpu.inference import smc as jsmc
from gaplac_tpu.inference.model import build_model as jax_build_model
from gaplac_tpu.kernels.covariance import compile_formula as jax_compile
from gaplac_tpu.ops import mvn as jmvn
from gaplac_tpu_torch.dsl import parse_formula
from gaplac_tpu_torch.inference import smc, vi
from gaplac_tpu_torch.inference.model import GPModel, build_model
from gaplac_tpu_torch.kernels.covariance import compile_formula


def _close(got, ref, rtol):
    got, ref = np.asarray(got, float), np.asarray(ref, float)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * max(np.abs(ref).max(), 1.0))


def _gp_data(n, seed):
    """n points of SqExp(l = 1.5) with jitter 0.1, drawn as
    tests/test_vi_smc.py draws them (the same x and y)."""
    x = np.random.default_rng(seed).uniform(-5, 5, n)
    gen = jax_compile(jax_parse("y ~| SqExp(:x; l=1.5)").formula)
    K = gen.gram(gen.default_params(), jnp.asarray(x[:, None]))
    return x, np.asarray(jmvn.sample_mvn(jax.random.key(4), K, jitter=0.1))


@pytest.mark.parametrize("marginalize", [True, False])
def test_elbo_and_gradient_match_jax(marginalize):
    """The ELBO of run_advi for fixed (mu, log sigma, eps), and its gradient
    in (mu, log sigma), against the same formula on gaplac_tpu's
    model.logdensity under jax.vmap."""
    x, y = _gp_data(10, 1)
    formula = "y ~| SqExp(:x)"
    jm = jax_build_model(jax_compile(jax_parse(formula).formula), ["x"], jnp.asarray(x[:, None]),
                         jnp.asarray(y), jax_parse(formula).likelihood, marginalize=marginalize)
    m = build_model(compile_formula(parse_formula(formula).formula), ["x"],
                    torch.as_tensor(x[:, None]), torch.as_tensor(y),
                    parse_formula(formula).likelihood, marginalize=marginalize)
    rng = np.random.default_rng(2)
    mu, ls = rng.normal(size=m.dim) * 0.3, rng.uniform(-2, -0.5, m.dim)
    eps = rng.normal(size=(8, m.dim))

    def jelbo(params):
        jmu, jls = params
        logps = jax.vmap(jm.logdensity)(jmu + jnp.exp(jls) * eps)
        return jnp.mean(logps) + jnp.sum(jls) + 0.5 * m.dim * (1.0 + jnp.log(2 * jnp.pi))

    ref, (gmu, gls) = jax.value_and_grad(jelbo)((jnp.asarray(mu), jnp.asarray(ls)))
    tmu, tls = (torch.tensor(a, requires_grad=True) for a in (mu, ls))
    got = vi.elbo(m.logdensity, tmu, tls, torch.as_tensor(eps))
    got.backward()
    _close(got.detach(), ref, 1e-9)
    _close(tmu.grad, gmu, 1e-9)
    _close(tls.grad, gls, 1e-9)


def test_adam_steps_match_optax():
    rng = np.random.default_rng(3)
    params = (rng.normal(size=5), rng.normal(size=3))
    opt = optax.adam(0.05)
    jp = tuple(jnp.asarray(p) for p in params)
    js = opt.init(jp)
    tp = tuple(torch.as_tensor(p) for p in params)
    ts = vi.adam_init(tp)
    for _ in range(4):
        grads = tuple(rng.normal(size=p.shape) for p in params)
        upd, js = opt.update(tuple(jnp.asarray(g) for g in grads), js)
        jp = optax.apply_updates(jp, upd)
        tp, ts = vi.adam_step(tp, tuple(torch.as_tensor(g) for g in grads), ts, 0.05)
        for a, b in zip(tp, jp):
            _close(a, b, 1e-12)


def test_advi_gaussian_target():
    """tests/test_vi_smc.py::test_advi_gaussian_target (torch's generator
    draws other numbers than jax.random for a seed)."""
    cov = np.array([[2.0, 0.0], [0.0, 0.5]])
    prec = torch.as_tensor(np.linalg.inv(cov))
    mdl = GPModel(2, 2, lambda q: -0.5 * torch.sum((q @ prec) * q, dim=-1), None, None,
                  lambda g, C: torch.randn((C, 2), generator=g, dtype=torch.float64), True)
    r = vi.run_advi(torch.Generator().manual_seed(1), mdl, num_steps=2500, learning_rate=0.03)
    assert r.elbo_trace.shape == (2500,) and torch.isfinite(r.elbo_trace).all()
    np.testing.assert_allclose(r.mu.numpy(), [0, 0], atol=0.2)
    np.testing.assert_allclose(np.exp(r.log_sigma.numpy()), [np.sqrt(2), np.sqrt(0.5)],
                               rtol=0.15)
    draws = vi.sample_posterior(torch.Generator().manual_seed(3), r, 4000)
    np.testing.assert_allclose(draws.numpy().std(0), [1.414, 0.707], rtol=0.2)


def test_advi_gp_agrees_with_posterior_shape():
    """tests/test_vi_smc.py::test_advi_gp_agrees_with_posterior_shape."""
    x, y = _gp_data(40, 42)
    spec = parse_formula("y ~| SqExp(:x)")
    model = build_model(compile_formula(spec.formula), ["x"], torch.as_tensor(x[:, None]),
                        torch.as_tensor(y), spec.likelihood)
    r = vi.run_advi(torch.Generator().manual_seed(1), model, num_steps=1500)
    ells = model.constrain(vi.sample_posterior(torch.Generator().manual_seed(2), r, 500))
    assert 0.8 < float(ells.median()) < 6.0


def test_systematic_resample_matches_jax():
    rng = np.random.default_rng(4)
    for n in (7, 64, 512):
        log_w = rng.normal(size=n) * 3
        key = jax.random.key(n)
        ref = np.asarray(jsmc._systematic_resample(key, jnp.asarray(log_w), n))
        u = float(jax.random.uniform(key))
        np.testing.assert_array_equal(smc._systematic_resample(u, log_w, n), ref)


@pytest.mark.parametrize("scale", [0.05, 3.0, 40.0])
def test_next_beta_matches_jax(scale):
    """gaplac_tpu's bisection is a closure of run_smc: one stage without
    rejuvenation from fixed particles ends at next_beta(0, lls)."""
    n = 256
    lls = np.random.default_rng(5).normal(size=n) * scale
    parts = jnp.asarray(lls[:, None])
    res = jsmc.run_smc(jax.random.key(0), lambda k, m: parts, lambda u: 0.0 * u[0],
                       lambda u: u[0], n_particles=n, rejuvenation_steps=0, max_stages=1)
    assert smc.next_beta(0.0, lls) == float(res.final_beta)
    beta = smc.next_beta(0.0, lls)
    if beta < 1.0:
        lw = beta * lls
        lw = lw - logsumexp(lw)
        assert math.exp(-logsumexp(2 * lw)) / n >= 0.5


def test_smc_conjugate_evidence():
    """tests/test_vi_smc.py::test_smc_conjugate_evidence at 512 particles."""
    rng = np.random.default_rng(0)
    y = torch.as_tensor(rng.normal(0.5, 1.0, size=20))
    logprior = lambda u: -0.5 * torch.sum(u ** 2, dim=-1) - 0.5 * math.log(2 * math.pi)
    loglik = lambda u: torch.sum(-0.5 * (y - u[:, :1]) ** 2 - 0.5 * math.log(2 * math.pi),
                                 dim=-1)
    sample_prior = lambda g, n: torch.randn((n, 1), generator=g, dtype=torch.float64)
    res = smc.run_smc(torch.Generator().manual_seed(1), sample_prior, logprior, loglik,
                      n_particles=512)
    n = len(y)
    exact = stats.multivariate_normal(np.zeros(n), np.eye(n) + np.ones((n, n))).logpdf(y.numpy())
    assert abs(res.log_evidence - exact) < 0.3
    assert res.final_beta == 1.0
    assert abs(float(res.particles.mean()) - float(y.sum()) / (n + 1)) < 0.1


def test_smc_gp_evidence_vs_quadrature():
    """tests/test_vi_smc.py::test_smc_gp_evidence_vs_quadrature: the SMC
    evidence of the marginal model against quadrature over Uniform(0, 20)."""
    x, y = _gp_data(30, 5)
    spec = parse_formula("y ~| SqExp(:x)")
    model = build_model(compile_formula(spec.formula), ["x"], torch.as_tensor(x[:, None]),
                        torch.as_tensor(y), spec.likelihood)
    res = smc.smc_log_evidence_gp(torch.Generator().manual_seed(0), model, torch.as_tensor(y),
                                 smc.particle_chunk(30, 30, 8), n_particles=512)
    ls = np.linspace(1e-3, 20 - 1e-3, 400)
    d2 = (x[:, None] - x[None, :]) ** 2
    S = np.exp(-d2[None] / (2 * ls[:, None, None] ** 2)) + 1.1 * np.eye(30)
    L = np.linalg.cholesky(S)
    a = np.linalg.solve(L, np.broadcast_to(y, (400, 30))[..., None])[..., 0]
    lps = (-0.5 * (a * a).sum(-1) - np.log(np.diagonal(L, axis1=1, axis2=2)).sum(-1)
           - 15 * np.log(2 * np.pi))
    quad = logsumexp(lps) + np.log(ls[1] - ls[0]) - np.log(20.0)
    assert abs(res.log_evidence - quad) < 0.3
    assert res.final_beta == 1.0


def test_smc_evaluates_particles_in_chunks(monkeypatch):
    """Past SMC_BATCH_BYTES the particles go through the model in chunks,
    with the same log likelihoods."""
    x, y = _gp_data(12, 6)
    spec = parse_formula("y ~| SqExp(:x)")
    model = build_model(compile_formula(spec.formula), ["x"], torch.as_tensor(x[:, None]),
                        torch.as_tensor(y), spec.likelihood)
    sizes = []
    ld = model.logdensity
    chunked = model.__class__(**{**model.__dict__,
                                 "logdensity": lambda u: sizes.append(len(u)) or ld(u)})
    kwargs = dict(n_particles=40, max_stages=2, rejuvenation_steps=1)
    whole = smc.smc_log_evidence_gp(torch.Generator().manual_seed(3), chunked,
                                   torch.as_tensor(y), smc.particle_chunk(12, 12, 8), **kwargs)
    assert set(sizes) == {40}
    monkeypatch.setattr(smc, "SMC_BATCH_BYTES", 3 * 12 * 12 * 8 * 16)
    sizes.clear()
    parts = smc.smc_log_evidence_gp(torch.Generator().manual_seed(3), chunked,
                                   torch.as_tensor(y), smc.particle_chunk(12, 12, 8), **kwargs)
    assert set(sizes) == {16, 8}
    assert parts.log_evidence == pytest.approx(whole.log_evidence, rel=1e-12)
    assert torch.allclose(parts.particles, whole.particles, rtol=1e-12, atol=0)
