"""Parity of the port's gram (kernel K2's plain version) and of its
closed-form backward (kernel K2b's plain version) with gaplac_tpu, on the
CPU in float64.  The same numpy inputs go to both packages."""

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaplac_tpu.dsl import parse_formula
from gaplac_tpu.kernels.covariance import compile_formula as jax_compile
from gaplac_tpu.ops.gram import pallas_gram
from gaplac_tpu_torch.dsl import parse_formula as torch_parse
from gaplac_tpu_torch.kernels.covariance import CompiledKernel, compile_formula
from gaplac_tpu_torch.ops.gram import GramBound, descriptor, gram_bwd_plain

COMPOSITE = "y ~| SqExp(:t) * Cat(:g) + Linear(:x) + OU(:t2) + Noise"
EXTENDED = ("y ~| Matern32(:t) + Matern52(:t2) * Periodic(:s; l=1.2, p=2.5)"
            " + RQ(:x; l=0.8, alpha=1.5)")
MIXED = "y ~| Constant + 1(2.0) * SqExp(:x) + Noise(:g) + Cat(:g) * Linear(:t)"
FORMULAS = [COMPOSITE, EXTENDED, MIXED]
GRAM_ATOL = 1e-12        # float64 elementwise; both sides evaluate the same formulas
GRAD_RTOL = 1e-10        # float64 sums of n^2 terms in a different order


def _data(n, seed=0, d=4):
    X = np.random.default_rng(seed).normal(size=(n, d))
    X[:, 1] = np.floor(np.abs(X[:, 1]) * 2)   # a categorical column
    return X


def _params(ck, seed, C=3):
    rng = np.random.default_rng(seed)
    base = np.asarray(ck.default_params(torch.float64))
    return base[None] * rng.uniform(0.6, 1.5, size=(C, base.size))


@lru_cache(maxsize=None)
def _jitted_param_grad(formula):
    jck = jax_compile(parse_formula(formula).formula)
    inner = lambda p, g, X1, X2: jnp.sum(g * jck.gram(p, X1, X2))
    return jax.jit(jax.vmap(jax.grad(inner), in_axes=(0, 0, None, None)))


def _jax_param_grad(formula, P, gK, X1, X2=None):
    """jax.grad of <gK[c], K(P[c])> through gaplac_tpu's gram, for each c (one
    compile a formula and shape)."""
    return np.asarray(_jitted_param_grad(formula)(
        jnp.asarray(P), jnp.asarray(gK), jnp.asarray(X1), None if X2 is None else jnp.asarray(X2)))


def _cks(formula):
    jck = jax_compile(parse_formula(formula).formula)
    return jck, compile_formula(torch_parse(formula).formula)


@pytest.mark.parametrize("formula", FORMULAS)
def test_compile_and_from_fields_match_jax(formula):
    jck, tck = _cks(formula)
    rebuilt = CompiledKernel.from_fields(jck.varnames, jck.kinds, jck.cols, jck.terms,
                                         jck.defaults, jck.leaf_vars, jck.extras)
    assert rebuilt == tck
    assert tck.n_params == jck.n_params and tck.extra_slots == jck.extra_slots
    np.testing.assert_array_equal(np.asarray(tck.default_params()),
                                  np.asarray(jck.default_params()))
    # a JAX parameter vector, in either length, carries over
    p = np.asarray(jck.default_params()) * 1.3
    np.testing.assert_array_equal(rebuilt.params_from_numpy(p).numpy(), p)
    np.testing.assert_array_equal(
        rebuilt.set_params(rebuilt.params_from_numpy(p), (0, 2), 0.7).numpy(),
        np.asarray(jck.set_params(jnp.asarray(p), (0, 2), 0.7)))
    expected = np.array(jck.default_params())    # leaf params only: static extras appended
    expected[:jck.n_leaves] *= 1.3
    np.testing.assert_array_equal(rebuilt.params_from_numpy(p[:jck.n_leaves]).numpy(), expected)


@pytest.mark.parametrize("formula", FORMULAS)
def test_gram_matches_jax_gram_and_pallas(formula):
    jck, tck = _cks(formula)
    d = len(jck.varnames)
    X1, X2 = _data(61, 0, d), _data(23, 1, d)
    P = _params(tck, 2, C=2)
    jgram = jax.jit(jax.vmap(jck.gram, in_axes=(0, None, None)))
    ref_sym = np.asarray(jax.vmap(lambda p: jck.gram(p, jnp.asarray(X1)))(jnp.asarray(P)))
    ref_cross = np.asarray(jgram(jnp.asarray(P), jnp.asarray(X1), jnp.asarray(X2)))
    for c in range(P.shape[0]):
        got_sym = tck.gram(torch.as_tensor(P[c]), torch.as_tensor(X1)).numpy()
        got_cross = tck.gram(torch.as_tensor(P[c]), torch.as_tensor(X1),
                             torch.as_tensor(X2)).numpy()
        np.testing.assert_allclose(got_sym, ref_sym[c], rtol=0, atol=GRAM_ATOL)
        np.testing.assert_allclose(got_cross, ref_cross[c], rtol=0, atol=GRAM_ATOL)
    # batched over C, and against the Pallas tile kernel in interpret mode
    # (which reads the shape parameters statically: default extras only)
    Pl = P.copy()
    Pl[:, tck.n_leaves:] = np.asarray(tck.default_params())[tck.n_leaves:]
    Kb = tck.gram(torch.as_tensor(Pl), torch.as_tensor(X1), diag=0.25).numpy()
    for c in range(P.shape[0]):
        pk = pallas_gram(jck, jnp.asarray(Pl[c, :tck.n_leaves]), jnp.asarray(X1),
                         interpret=True, tile=128)
        np.testing.assert_allclose(Kb[c], np.asarray(pk) + 0.25 * np.eye(61), rtol=0,
                                   atol=GRAM_ATOL)
        pc = pallas_gram(jck, jnp.asarray(Pl[c, :tck.n_leaves]), jnp.asarray(X1),
                         jnp.asarray(X2), interpret=True, tile=128)
        got = tck.gram(torch.as_tensor(Pl[c]), torch.as_tensor(X1), torch.as_tensor(X2))
        np.testing.assert_allclose(got.numpy(), np.asarray(pc), rtol=0, atol=GRAM_ATOL)


@pytest.mark.parametrize("formula", FORMULAS)
def test_bind_matches_jax_bind(formula):
    """bind holds every non-dynamic slot at its default, as in gaplac_tpu."""
    jck, tck = _cks(formula)
    X = _data(47, 3, len(jck.varnames))
    dynamic = tuple(range(0, jck.n_params, 2))
    P = _params(tck, 4)
    ref = jax.vmap(jck.bind(jnp.asarray(X), dynamic, diag=0.1))(jnp.asarray(P))
    got = tck.bind(torch.as_tensor(X), dynamic, diag=0.1)(torch.as_tensor(P)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=GRAM_ATOL)


@pytest.mark.parametrize("formula", FORMULAS)
def test_gram_diag_matches_jax(formula):
    jck, tck = _cks(formula)
    X = _data(19, 5, len(jck.varnames))
    p = _params(tck, 6, C=1)[0]
    np.testing.assert_allclose(
        tck.gram_diag(torch.as_tensor(p), torch.as_tensor(X)).numpy(),
        np.asarray(jck.gram_diag(jnp.asarray(p), jnp.asarray(X))), rtol=0, atol=GRAM_ATOL)


@pytest.mark.parametrize("formula", FORMULAS)
@pytest.mark.parametrize("symmetric", [True, False])
def test_closed_form_backward_matches_jax_grad(formula, symmetric):
    """K2b's plain version (closed-form leaf derivatives, no autograd) equals
    jax.grad of <gK, K(params)>, shape parameters (period, alpha) included."""
    jck, tck = _cks(formula)
    d = len(jck.varnames)
    X1 = _data(37, 7, d)
    X2 = None if symmetric else _data(29, 8, d)
    P = _params(tck, 9)
    rng = np.random.default_rng(10)
    gK = rng.normal(size=(P.shape[0], 37, 37 if symmetric else 29))
    ref = _jax_param_grad(formula, P, gK, X1, X2)
    got = gram_bwd_plain(tck, torch.as_tensor(P), torch.as_tensor(X1),
                         None if X2 is None else torch.as_tensor(X2),
                         torch.as_tensor(gK)).numpy()
    np.testing.assert_allclose(got, ref, rtol=GRAD_RTOL, atol=GRAD_RTOL * np.abs(ref).max())
    # and the autograd Function routes its backward through it
    Pt = torch.as_tensor(P).requires_grad_(True)
    K = GramBound.apply(Pt, tck, torch.as_tensor(X1),
                        None if X2 is None else torch.as_tensor(X2), 0.3)
    (g,) = torch.autograd.grad((K * torch.as_tensor(gK)).sum(), Pt)
    np.testing.assert_allclose(g.numpy(), ref, rtol=GRAD_RTOL,
                               atol=GRAD_RTOL * np.abs(ref).max())


@pytest.mark.parametrize("formula", FORMULAS)
def test_symmetric_backward_sees_only_the_symmetric_part_of_the_cotangent(formula):
    """For a symmetric gram, <G, dK> equals <(G + G^T)/2, dK> for any G, since
    every leaf's dK/dtheta is symmetric: the identity by which K2b sums over
    the lower triangle with the weight G_ij + G_ji.  Both equal jax.grad of
    <G, K(params)> through gaplac_tpu's gram."""
    jck, tck = _cks(formula)
    X = _data(37, 11, len(jck.varnames))  # the shapes of the test above: no new compile
    P = _params(tck, 12)
    P[1] = P[0]
    G = np.random.default_rng(13).normal(size=(37, 37))  # not symmetric
    Gs = np.stack([G, 0.5 * (G + G.T), G])
    got = gram_bwd_plain(tck, torch.as_tensor(P), torch.as_tensor(X), None,
                         torch.as_tensor(Gs)).numpy()
    np.testing.assert_allclose(got[1], got[0], rtol=1e-12, atol=1e-12 * np.abs(got[0]).max())
    ref = _jax_param_grad(formula, P, Gs, X)
    np.testing.assert_allclose(got, ref, rtol=GRAD_RTOL, atol=GRAD_RTOL * np.abs(ref).max())


def test_descriptor_layout():
    _, tck = _cks(EXTENDED)
    desc = descriptor(tck)
    L, NT = tck.n_leaves, len(tck.terms)
    assert desc.dtype == np.int32
    np.testing.assert_array_equal(desc[:L], tck.kinds)
    np.testing.assert_array_equal(desc[L:2 * L], tck.cols)
    np.testing.assert_array_equal(desc[2 * L:3 * L], [-1, -1, 4, 5])
    np.testing.assert_array_equal(desc[3 * L:3 * L + NT + 1], [0, 1, 3, 4])
    np.testing.assert_array_equal(desc[3 * L + NT + 1:], [0, 1, 2, 3])
