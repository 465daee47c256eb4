"""The port's feature maps against gaplac_tpu's, float64 on the CPU: phi,
noise_diag, term_diag, term_slices and m_total to 1e-12 for every leaf
kind, a product term, a sum (which pins the order of the numpy draws
across leaves) and bare-Noise terms; unbatched params and a batch of two,
on the training inputs and on a second table that shares the Cat
vocabulary."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaplac_tpu.dsl import parse_formula as jax_parse
from gaplac_tpu.kernels.covariance import compile_formula as jax_compile
from gaplac_tpu.kernels.features import build_feature_map as jax_build
from gaplac_tpu_torch.dsl import parse_formula
from gaplac_tpu_torch.kernels.covariance import compile_formula
from gaplac_tpu_torch.kernels.features import build_feature_map

RTOL = 1e-12
M = 16   # random features a stationary leaf

FORMULAS = [
    "SqExp(:x; l=1.3)",
    "OU(:x; l=0.8)",
    "Matern32(:x; l=1.1)",
    "Matern52(:x; l=0.9)",
    "RQ(:x; l=1.0, alpha=1.5)",
    "Periodic(:x; l=1.2, p=2.0)",
    "Linear(:x; c=2.5)",
    "Constant(:x; c=1.3)",
    "Cat(:g)",
    "Noise(:g; s2=0.7)",
    "SqExp(:t) * Cat(:g) * Linear(:x; c=0.5)",
    "SqExp(:x) + OU(:t) + Periodic(:s; l=1.2, p=2.5) + RQ(:x; l=0.8, alpha=1.5) + Matern32(:t)",
    "SqExp(:x) * Noise + Linear(:x) + Noise(s2=0.9) + Constant(c=2.0)",
]


def _close(got, ref):
    got, ref = np.asarray(got, float), np.asarray(ref, float)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=RTOL * max(np.abs(ref).max(), 1.0))


def _tables(varnames, seed):
    """Two input tables; columns named g* are categorical, and the second
    table has a level the first lacks."""
    rng = np.random.default_rng(seed)
    out = []
    for n, levels in ((40, 3), (12, 4)):
        cols = [rng.integers(0, levels, n).astype(float) if v.startswith("g")
                else rng.uniform(-3, 3, n) for v in varnames]
        out.append(np.stack(cols, axis=1) if cols else np.zeros((n, 0)))
    return out


@pytest.mark.parametrize("formula", FORMULAS)
def test_feature_map_matches_jax(formula):
    jck = jax_compile(jax_parse(f"y ~| {formula}").formula)
    ck = compile_formula(parse_formula(f"y ~| {formula}").formula)
    X, Xt = _tables(ck.varnames, 1)
    jfm = jax_build(jck, [X, Xt], num_features=M, seed=7)
    fm = build_feature_map(ck, [torch.as_tensor(X), torch.as_tensor(Xt)], num_features=M, seed=7)
    assert fm.m_total == jfm.m_total
    assert fm.term_slices == jfm.term_slices

    # the default parameters and two perturbed ones (leaf slots only: the
    # shape parameters are static in a feature map)
    rng = np.random.default_rng(2)
    p0 = np.asarray(jck.default_params(jnp.float64))
    P = np.stack([p0, p0.copy(), p0.copy()])
    P[1:, :ck.n_leaves] *= rng.uniform(0.7, 1.4, (2, ck.n_leaves))
    for A in (X, Xt):
        jA, tA = jnp.asarray(A), torch.as_tensor(A)
        ref_phi = np.stack([np.asarray(jfm.phi(jnp.asarray(p), jA)) for p in P])
        ref_nd = np.stack([np.asarray(jfm.noise_diag(jnp.asarray(p), jA)) for p in P])
        _close(fm.phi(torch.as_tensor(P[0]), tA), ref_phi[0])                 # (P,)
        _close(fm.phi(torch.as_tensor(P[1:]), tA), ref_phi[1:])               # (C, P)
        _close(np.broadcast_to(fm.noise_diag(torch.as_tensor(P[1:]), tA).numpy(),
                               ref_nd[1:].shape), ref_nd[1:])
        _close(fm.noise_diag(torch.as_tensor(P[0]), tA), ref_nd[0])
        for t, term in enumerate(ck.terms):
            if fm.term_slices[t] is None:
                _close(np.broadcast_to(fm.term_diag(torch.as_tensor(P[1:]), tA, term).numpy(),
                                       (2, A.shape[0])),
                       [np.broadcast_to(jfm.term_diag(jnp.asarray(p), jA, term), (A.shape[0],))
                        for p in P[1:]])


def test_phi_gradient_matches_jax():
    """The 1/l scaling and the Khatri-Rao product are differentiable in the
    parameters as in gaplac_tpu."""
    formula = "SqExp(:t) * Cat(:g) + Periodic(:s; l=1.2, p=2.5) + Linear(:x; c=0.5)"
    jck = jax_compile(jax_parse(f"y ~| {formula}").formula)
    ck = compile_formula(parse_formula(f"y ~| {formula}").formula)
    X, _ = _tables(ck.varnames, 3)
    jfm = jax_build(jck, [X], num_features=M, seed=4)
    fm = build_feature_map(ck, [torch.as_tensor(X)], num_features=M, seed=4)
    W = np.random.default_rng(5).normal(size=(X.shape[0], fm.m_total))
    p = np.asarray(jck.default_params(jnp.float64)) * 1.1
    ref = jax.grad(lambda q: jnp.sum(jnp.sin(jfm.phi(q, jnp.asarray(X))) * W))(jnp.asarray(p))
    tp = torch.tensor(p[None], requires_grad=True)
    (g,) = torch.autograd.grad((torch.sin(fm.phi(tp, torch.as_tensor(X))) * torch.as_tensor(W))
                               .sum(), tp)
    _close(g[0, :ck.n_leaves], np.asarray(ref)[:ck.n_leaves])


def test_only_bare_noise_is_refused():
    ck = compile_formula(parse_formula("y ~| Noise(s2=0.5)").formula)
    with pytest.raises(ValueError, match="no feature-representable term"):
        build_feature_map(ck, [torch.zeros((5, 0), dtype=torch.float64)])
