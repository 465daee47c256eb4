"""The port's matrix-state path against gaplac_tpu's, float64 on the CPU:
build_steps for every block kind, a Kronecker product and group resets to
1e-10; ss_loglik_parts, ss_filter_cov, ss_smooth, ss_predict,
ss_smooth_windowed, ss_innovation_coeffs and ss_whiten_apply/ss_unwhiten
to 1e-9; the three state-space models' log density and gradient at C = 3
(the JAX model vmapped) to 1e-9 for scalar OU, SqExp, the quasi-periodic
product, a grouped Cat formula, the whitened model and the Bernoulli
Laplace marginal; the structure's rejections with the reference's
messages; the prior sampler by its moments, since the two RNGs differ."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaplac_tpu.dsl import parse_formula as jax_parse
from gaplac_tpu.inference.model import _markov_structure as jax_structure
from gaplac_tpu.inference.model import build_model as jax_build_model
from gaplac_tpu.kernels.covariance import compile_formula as jax_compile
from gaplac_tpu.ops import markov_ss as jss
from gaplac_tpu_torch.dsl import parse_formula
from gaplac_tpu_torch.inference.hmc import value_and_grad
from gaplac_tpu_torch.inference.model import _markov_structure, build_model
from gaplac_tpu_torch.kernels.covariance import compile_formula
from gaplac_tpu_torch.ops import markov_ss as mss

RTOL = 1e-9


def _close(got, ref, rtol=RTOL):
    got, ref = np.asarray(got, float), np.asarray(ref, float)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * max(np.abs(ref).max(), 1e-300))


def _t(v):
    """A numpy payload (nested tuples kept) as float64 tensors."""
    if v is None:
        return None
    if isinstance(v, tuple):
        return tuple(_t(a) for a in v)
    return torch.as_tensor(np.asarray(v, dtype=float))


def _j(v):
    if v is None:
        return None
    if isinstance(v, tuple):
        return tuple(_j(a) for a in v)
    return jnp.asarray(np.asarray(v, dtype=float))


RQ_C, RQ_W = jss.rq_mixture_constants(1.5)
#: (kind, param, needs an x column) for every block kind and a product
BLOCKS = {
    "ou": (jss.BLOCK_OU, 1.3, False),
    "m32": (jss.BLOCK_M32, 0.8, False),
    "m52": (jss.BLOCK_M52, 1.1, False),
    "const": (jss.BLOCK_CONST, 0.7, False),
    "linear": (jss.BLOCK_LINEAR, 0.4, True),
    "sqexp": (jss.BLOCK_SQEXP, 1.2, False),
    "periodic": (jss.BLOCK_PERIODIC, (0.9, 3.0), False),
    "rq": (jss.BLOCK_RQ, (1.4, RQ_C, RQ_W), False),
    "periodic*m32": ((jss.BLOCK_PERIODIC, jss.BLOCK_M32), ((0.9, 3.0), 1.5), False),
}


def _payload(name, x):
    kind, p, needs_x = BLOCKS[name]
    if isinstance(kind, tuple):
        return kind, p, (None, None)
    return kind, p, (x if needs_x else None)


def _steps_both(names, t, x, resets=None):
    kinds, params, xs = zip(*(_payload(nm, x) for nm in names))
    jparams = [((_j(p[0]), p[1], p[2]) if k == jss.BLOCK_RQ else _j(p)) for k, p in
               zip(kinds, params)]
    tparams = [((_t(p[0]), p[1], p[2]) if k == jss.BLOCK_RQ else _t(p)) for k, p in
               zip(kinds, params)]
    jr = None if resets is None else tuple(None if r is None else jnp.asarray(r) for r in resets)
    tr = None if resets is None else tuple(None if r is None else torch.as_tensor(r)
                                           for r in resets)
    ref = jss.build_steps(kinds, jparams, jnp.asarray(t), [_j(v) for v in xs], resets=jr)
    got = mss.build_steps(kinds, tparams, torch.as_tensor(t), [_t(v) for v in xs], resets=tr)
    return got, ref


def _times(n=24, seed=0):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 6, n))
    t[7] = t[6]  # a duplicate time
    return t, rng.uniform(-1, 1, n)


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_build_steps_every_block_matches_jax(name):
    t, x = _times()
    got, ref = _steps_both([name], t, x)
    for g, r in zip(got, ref):
        assert tuple(g.shape) == tuple(r.shape)
        _close(g, r, 1e-10)


def test_build_steps_additive_with_resets_matches_jax():
    t, x = _times()
    resets = (np.arange(24) % 8 == 0, None, np.arange(24) % 12 == 0)
    got, ref = _steps_both(["m32", "linear", "ou"], t, x, resets)
    for g, r in zip(got, ref):
        _close(g, r, 1e-10)


def test_build_steps_batched_params():
    """A batch of parameter values gives the unbatched steps, stacked."""
    t, x = _times()
    ls = torch.tensor([0.6, 1.0, 2.2], dtype=torch.float64)
    kinds = (jss.BLOCK_M32, (jss.BLOCK_PERIODIC, jss.BLOCK_OU))
    T = torch.as_tensor(t)
    A, Q, H = mss.build_steps(kinds, [ls, ((ls, torch.tensor(3.0, dtype=torch.float64)), ls)], T,
                              [None, (None, None)])
    for c in range(3):
        A1, Q1, H1 = mss.build_steps(kinds, [ls[c], ((ls[c], 3.0), ls[c])], T,
                                     [None, (None, None)])
        _close(A[c], A1, 1e-14)
        _close(Q[c], Q1, 1e-14)
        _close(H, H1, 1e-14)


def _system(n=40, seed=3):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 8, n))
    y = np.sin(t) + 0.3 * rng.normal(size=n)
    obs = rng.uniform(size=n) > 0.25
    R = rng.uniform(0.1, 0.4, n)
    return t, y, obs, R


def test_filters_and_smoother_match_jax():
    t, y, obs, R = _system()
    (A, Q, H), (jA, jQ, jH) = _steps_both(["m32", "m52"], t, None)
    z = np.random.default_rng(4).normal(size=len(t))

    @jax.jit
    def reference(A, Q, H, y, R, obs, z):
        K, S = jss.ss_innovation_coeffs(A, Q, H, 0.1)
        f = jss.ss_whiten_apply(A, H, K, S, z)
        return (*jss.ss_loglik_parts(A, Q, H, y, R), jss.ss_filter_cov(A, Q, H, R, obs=obs),
                *jss.ss_smooth(A, Q, H, y, R, obs=obs), K, S, f, jss.ss_unwhiten(A, H, K, S, f))

    Y, Rt, O = torch.as_tensor(y), torch.as_tensor(R), torch.as_tensor(obs)
    Kg, S = mss.ss_innovation_coeffs(A, Q, H, 0.1)
    f = mss.ss_whiten_apply(A, H, Kg, S, torch.as_tensor(z))
    got = (*mss.ss_loglik_parts(A, Q, H, Y, Rt), mss.ss_filter_cov(A, Q, H, Rt, obs=O),
           *mss.ss_smooth(A, Q, H, Y, Rt, obs=O), Kg, S, f, mss.ss_unwhiten(A, H, Kg, S, f))
    ref = reference(jA, jQ, jH, jnp.asarray(y), jnp.asarray(R), jnp.asarray(obs), jnp.asarray(z))
    for g, r in zip(got, ref):
        _close(g, r)
    _close(got[-1], z)


@pytest.mark.parametrize("window", [None, 16])
def test_predict_and_windowed_smoothing_match_jax(window):
    t, y, _, _ = _system(n=48)
    tn = np.sort(np.random.default_rng(5).uniform(0.5, 7.5, 10))
    kinds = [jss.BLOCK_M32, (jss.BLOCK_M52, jss.BLOCK_OU)]
    tparams = [_t(0.4), (_t(0.8), _t(0.6))]
    jparams = [0.4, (0.8, 0.6)]
    xs = [None, (None, None)]
    got = mss.ss_predict(kinds, tparams, torch.as_tensor(t), xs, torch.as_tensor(y),
                         torch.tensor(0.3, dtype=torch.float64), torch.as_tensor(tn), xs,
                         window=window, overlap=6)
    ref = jax.jit(lambda t, y, tn: jss.ss_predict(kinds, jparams, t, xs, y, 0.3, tn, xs,
                                                  window=window, overlap=6))(
        jnp.asarray(t), jnp.asarray(y), jnp.asarray(tn))
    for g, r in zip(got, ref):
        _close(g, r)


def test_windowed_smoothing_matches_monolithic():
    """tests/test_markov.py::test_windowed_smoothing_matches_monolithic on the
    port, with its tolerances."""
    rng = np.random.default_rng(77)
    n, m = 512, 64
    t = torch.as_tensor(np.sort(rng.uniform(0, 10, n)))
    y = torch.sin(2 * np.pi * t / 3.0) + 0.3 * torch.as_tensor(rng.standard_normal(n))
    tn = torch.as_tensor(np.sort(rng.uniform(0.5, 9.5, m)))
    kinds = [mss.BLOCK_M32, (mss.BLOCK_PERIODIC, mss.BLOCK_OU)]
    params = [_t(0.25), ((_t(0.8), _t(3.0)), _t(0.4))]
    xs = [None, (None, None)]
    R = torch.tensor(0.3, dtype=torch.float64)
    mu_m, var_m = mss.ss_predict(kinds, params, t, xs, y, R, tn, xs)
    mu_w, var_w = mss.ss_predict(kinds, params, t, xs, y, R, tn, xs, window=128, overlap=96)
    np.testing.assert_allclose(mu_w.numpy(), mu_m.numpy(), rtol=1e-4, atol=3e-5)
    np.testing.assert_allclose(var_w.numpy(), var_m.numpy(), rtol=1e-4, atol=3e-5)
    mu_t, _ = mss.ss_predict(kinds, params, t, xs, y, R, tn, xs, window=128, overlap=1)
    assert (mu_t - mu_m).abs().max() > 1e-3


def test_prior_sample_moments():
    t = torch.linspace(0, 4, 5, dtype=torch.float64)
    A, Q, H = mss.build_steps([mss.BLOCK_M32], [torch.full((4000,), 1.2, dtype=torch.float64)], t,
                              [None])
    f = mss.measure_row(H, mss.ss_prior_sample(torch.Generator().manual_seed(0), A, Q))
    r = np.sqrt(3) * np.abs(t.numpy()[:, None] - t.numpy()[None, :]) / 1.2
    K = (1 + r) * np.exp(-r)
    assert np.abs(np.cov(f.numpy().T) - K).max() < 0.08


def test_sqexp_float32_data_keeps_the_filter_definite():
    """SqExp at steps of about l/100 from float32 data: its steps and
    filter run in float64 (``markov_ss.steps_dtype``; in float32 the
    filter's covariances turn indefinite), so the filtered covariances stay
    positive definite, the model's log density and gradient keep float64's
    to 1e-5, and the report's Matheron draws are finite."""
    n = 512
    rng = np.random.default_rng(3)
    x = np.sort(rng.uniform(0, 2000 * n / 131072, n))
    A, Q, H = mss.build_steps([mss.BLOCK_SQEXP], [torch.tensor(1.5, dtype=torch.float64)],
                              torch.as_tensor(x), [None])
    gen = torch.Generator().manual_seed(0)
    f = mss.measure_row(H, mss.ss_prior_sample(gen, A, Q))
    y = (f + torch.randn(n, generator=gen, dtype=torch.float64)).numpy()
    t32 = torch.as_tensor(x, dtype=torch.float32)
    A, Q, H = mss.build_steps([mss.BLOCK_SQEXP], [torch.tensor(1.5, dtype=torch.float32)], t32,
                              [None])
    assert A.dtype == torch.float64
    P = mss.ss_filter_cov(A, Q, H, torch.tensor([1.0], dtype=A.dtype))
    assert torch.linalg.eigvalsh(P)[..., 0].min() > 0
    spec = parse_formula("y ~| SqExp(:x)")
    ck = compile_formula(spec.formula)
    u = torch.tensor([[np.log(1.5 / 20) - np.log1p(-1.5 / 20)]])
    out = {}
    for dt in (torch.float64, torch.float32):
        m = build_model(ck, ["x"], torch.tensor(x[:, None], dtype=dt), torch.tensor(y, dtype=dt),
                        spec.likelihood, approx="sde")
        lp, g = value_and_grad(m.logdensity)(u.to(dt))
        assert lp.dtype == dt
        out[dt] = (lp.double(), g.double())
        _, fr, lpr = m.report(torch.Generator().manual_seed(1), u.to(dt))
        assert torch.isfinite(fr).all() and torch.isfinite(lpr).all()
    for got, ref in zip(out[torch.float32], out[torch.float64]):
        _close(got, ref, 1e-5)


def test_singular_combine_gives_nonfinite_values_not_an_error():
    """A combine whose system I + C1 J2 is singular (an extreme proposal's
    steps) gives that member non-finite elements, for the sampler to
    reject, and leaves the other members as they are."""
    d = 2
    eye = torch.eye(d, dtype=torch.float64)
    one = torch.ones((2, 1, d), dtype=torch.float64)

    def elems(C, J):
        return mss._MElems(A=eye.expand(2, 1, d, d), b=one, C=C, eta=one, J=J)

    C1 = torch.stack([-eye, torch.zeros_like(eye)])[:, None]
    e = mss._mcombine(elems(C1, torch.zeros_like(C1)), elems(torch.zeros_like(C1),
                                                             eye.expand(2, 1, d, d)))
    assert not torch.isfinite(e.A[0]).all() and torch.isfinite(e.A[1]).all()
    _close(e.A[1], eye[None])
    _close(e.b[1], 2 * one[1])


FORMULAS = {
    "ou": ("y ~| OU(:x)", ["x"], True),
    "sqexp": ("y ~| SqExp(:x)", ["x"], True),
    "quasi-periodic": ("y ~| Periodic(:x; p=3.0) * Matern32(:x)", ["x"], True),
    "grouped": ("y ~| OU(:x)*Cat(:g) + Cat(:g) + Noise", ["x"], True),
    "whitened": ("y ~| Matern32(:x) + Linear(:x)", ["x"], False),
    "bernoulli laplace": ("y : Bernoulli ~| OU(:x)", ["x"], True),
}


def _frame(n=12, seed=11, bernoulli=False):
    rng = np.random.default_rng(seed)
    g = np.repeat([0.0, 1.0, 2.0], n // 3)
    x = np.concatenate([np.sort(rng.uniform(0, 6, n // 3)) for _ in range(3)])
    y = np.sin(x) + 0.4 * rng.normal(size=n)
    if bernoulli:
        y = (y > 0).astype(float)
    return {"x": x, "g": g}, y


@pytest.mark.parametrize("name", sorted(FORMULAS))
def test_models_match_jax_at_C3(name):
    formula, infer, marginalize = FORMULAS[name]
    cols, y = _frame(bernoulli="bernoulli" in name)
    jspec, spec = jax_parse(formula), parse_formula(formula)
    jck, ck = jax_compile(jspec.formula), compile_formula(spec.formula)
    X = np.stack([cols[v] for v in ck.varnames], axis=1)
    jm = jax_build_model(jck, infer, jnp.asarray(X), jnp.asarray(y), jspec.likelihood,
                         marginalize=marginalize, approx="sde")
    m = build_model(ck, infer, torch.as_tensor(X), torch.as_tensor(y), spec.likelihood,
                    marginalize=marginalize, approx="sde")
    assert (m.dim, m.n_hyper, m.marginalized) == (jm.dim, jm.n_hyper, jm.marginalized)
    rng = np.random.default_rng(2)
    v = rng.normal(size=(3, m.dim)) * 0.3
    # l = 0.8, 1.5 and 2.5: inside a third of the input span, the SqExp
    # block's accurate band (inference/routing.py's guard)
    v[:, 0] = np.log(np.array([0.8, 1.5, 2.5]) / 20) - np.log1p(-np.array([0.8, 1.5, 2.5]) / 20)
    lp_ref, g_ref = jax.jit(jax.vmap(jax.value_and_grad(jm.logdensity)))(jnp.asarray(v))
    lp, g = value_and_grad(m.logdensity)(torch.as_tensor(v))
    _close(lp, lp_ref)
    _close(g, g_ref)
    if not marginalize:  # the whitening map round-trips through position_from
        theta, f, _ = m.report(torch.Generator().manual_seed(0), torch.as_tensor(v[:1]))
        _close(m.position_from(theta[0], f[0]), v[0])


def test_rejections_match_jax():
    rng = np.random.default_rng(0)
    X3 = np.stack([rng.uniform(0, 5, 12), np.repeat([0.0, 1.0], 6), np.tile([0.0, 1.0], 6)], 1)
    cases = [
        ("y ~| SqExp(:x) * SqExp(:z)", rng.uniform(0, 5, (12, 2)), ()),   # two time axes
        ("y ~| OU(:x) * Cat(:g) + OU(:x) * Cat(:h)", X3, ()),             # two groupings
        ("y ~| OU(:t) + Noise * Cat(:g)", X3[:, :2], ()),                 # Noise * Cat
        ("y ~| RQ(:x; alpha=2)", X3[:, :1], ("x",)),                      # dynamic alpha
    ]
    for formula, X, extras in cases:
        jck, ck = jax_compile(jax_parse(formula).formula), compile_formula(parse_formula(formula).formula)
        dyn = tuple(s for v in extras for s in ck.extra_slots_for_vars([v]))
        with pytest.raises(ValueError) as je:
            jax_structure(jck, X, dynamic_slots=dyn)
        with pytest.raises(ValueError) as te:
            _markov_structure(ck, X, dynamic_slots=dyn)
        assert str(te.value) == str(je.value), formula
    # crossed groupings: groups not contiguous in the sort order
    X = np.stack([np.arange(8.0), np.array([0, 0, 1, 1, 0, 0, 1, 1.0]),
                  np.array([0, 1, 0, 1, 0, 1, 0, 1.0])], 1)
    formula = "y ~| OU(:t) * Cat(:g) + Cat(:h)"
    for compile_, parse, structure in ((jax_compile, jax_parse, jax_structure),
                                       (compile_formula, parse_formula, _markov_structure)):
        with pytest.raises(ValueError, match="not contiguous"):
            structure(compile_(parse(formula).formula), X)
