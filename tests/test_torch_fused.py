"""The port's cross gram on global row ids and its fused gram -> Cholesky
(gaplac_tpu_torch/ops/fused.py) against gaplac_tpu's, on the CPU in
float64.  The same numpy inputs go to both packages; on the CPU the panels
come from K2's plain version with row offsets, the tiles from K3's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from gaplac_tpu.dsl import parse_formula
from gaplac_tpu.kernels.covariance import compile_formula as jax_compile
from gaplac_tpu.ops import fused as jax_fused
from gaplac_tpu_torch.dsl import parse_formula as torch_parse
from gaplac_tpu_torch.kernels.covariance import compile_formula
from gaplac_tpu_torch.ops import fused
from gaplac_tpu_torch.ops.gram import gram_bwd_plain, gram_plain

FIXTURE = "y ~| SqExp(:t) * Cat(:g) + Linear(:x) + Noise"  # tests/test_ops.py's fused_setup
MIXED = "y ~| Constant + 1(2.0) * SqExp(:x) + Noise(:g) + Cat(:g) * Linear(:t) + Noise"
GRAM_ATOL = 1e-12     # float64 elementwise: both sides evaluate the same leaf formulas
FACTOR_ATOL = 1e-10   # float64 factor of n = 300: sums in another order than XLA's
VALUE_RTOL = 1e-12    # the log density, a sum of n terms
GRAD_RTOL = 1e-8      # sums over n^2 terms of the pullback


def _cks(formula):
    return jax_compile(parse_formula(formula).formula), compile_formula(torch_parse(formula).formula)


def _data(n, seed=3, d=3):
    X = np.random.default_rng(seed).normal(size=(n, d))
    X[:, 1] = np.floor(np.abs(X[:, 1]) * 2)   # the categorical column g
    return X


@pytest.mark.parametrize("formula", [FIXTURE, MIXED])
def test_gram_cross_with_rowids_matches_jax(formula):
    """Arbitrary ids (some shared, some not) and offset ranges."""
    jck, ck = _cks(formula)
    rng = np.random.default_rng(1)
    d = len(ck.varnames)
    X1, X2 = _data(23, seed=1, d=d), _data(17, seed=2, d=d)
    p = np.asarray(ck.default_params()) * rng.uniform(0.6, 1.5, ck.n_params)
    for ids1, ids2 in ((rng.integers(0, 12, 23), rng.integers(0, 12, 17)),
                       (np.arange(40, 63), np.arange(50, 67))):
        ref = np.asarray(jck.gram_cross_with_rowids(
            jnp.asarray(p), jnp.asarray(X1), jnp.asarray(X2), jnp.asarray(ids1),
            jnp.asarray(ids2)))
        got = ck.gram_cross_with_rowids(torch.tensor(p), torch.tensor(X1), torch.tensor(X2),
                                        torch.tensor(ids1), torch.tensor(ids2))
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=GRAM_ATOL)


@pytest.mark.parametrize("offsets", [(0, 0), (5, 9), (30, 12), (100, 0)])
def test_plain_gram_with_offsets_is_the_rowid_gram(offsets):
    """K2's plain version at row offsets (r1, r2) equals the cross gram on
    the ranges r1 + i and r2 + j, batched; so does its backward, against
    autograd of that gram; without offsets bare Noise never matches."""
    _, ck = _cks(MIXED)
    rng = np.random.default_rng(4)
    X1, X2 = torch.tensor(_data(40, seed=5, d=4)), torch.tensor(_data(24, seed=6, d=4))
    P = torch.tensor(np.asarray(ck.default_params()) * rng.uniform(0.6, 1.5, (3, ck.n_params)),
                     requires_grad=True)
    r1, r2 = offsets
    ref = ck.gram_cross_with_rowids(P, X1, X2, torch.arange(r1, r1 + 40),
                                    torch.arange(r2, r2 + 24))
    got = gram_plain(ck, P.detach(), X1, X2, 0.0, offsets)
    np.testing.assert_allclose(got.numpy(), ref.detach().numpy(), rtol=0, atol=GRAM_ATOL)
    gK = torch.tensor(rng.normal(size=(3, 40, 24)))
    (dref,) = torch.autograd.grad((ref * gK).sum(), P)
    dgot = gram_bwd_plain(ck, P.detach(), X1, X2, gK, offsets)
    np.testing.assert_allclose(dgot.numpy(), dref.numpy(), rtol=1e-10, atol=1e-12)
    # diag lands where the global ids match, as bare Noise does
    with_diag = gram_plain(ck, P.detach(), X1, X2, 0.7, offsets)
    match = (torch.arange(r1, r1 + 40)[:, None] == torch.arange(r2, r2 + 24)[None]).double()
    np.testing.assert_allclose((with_diag - got).numpy(), 0.7 * match.expand(3, -1, -1).numpy(),
                               rtol=0, atol=GRAM_ATOL)
    no_offsets = gram_plain(ck, P.detach(), X1, X2, 0.7)
    far = ck.gram_cross_with_rowids(P, X1, X2, torch.arange(40), torch.arange(40, 64))
    np.testing.assert_allclose(no_offsets.numpy(), far.detach().numpy(), rtol=0, atol=GRAM_ATOL)


@pytest.fixture(scope="module")
def setup():
    jck, ck = _cks(FIXTURE)
    n = 300  # panel 128: two whole panels and a ragged last one of 44
    rng = np.random.default_rng(3)
    X = _data(n)
    y = rng.normal(size=n)
    p = np.asarray(jck.default_params())
    return jck, ck, p, X, y


def test_fused_factor_matches_jax(setup):
    jck, ck, p, X, y = setup
    ref = np.asarray(jax_fused.fused_gram_cholesky(jck, 1.1, 128, lax.Precision.HIGHEST,
                                                   jnp.asarray(p), jnp.asarray(X)))
    L = fused.fused_gram_cholesky(ck, 1.1, 128, torch.tensor(p), torch.tensor(X))
    np.testing.assert_allclose(L.numpy(), ref, rtol=0, atol=FACTOR_ATOL)
    assert float(L.triu(1).abs().max()) == 0.0


def test_fused_logpdf_value_and_grads_match_jax(setup):
    jck, ck, p, X, y = setup

    def lp(pp, xx):
        return jax_fused.mvn_logpdf_fused(jck, pp, xx, jnp.asarray(y), 1.1, panel=128,
                                          precision=lax.Precision.HIGHEST)

    v_ref, (dp_ref, dX_ref) = jax.value_and_grad(lp, argnums=(0, 1))(jnp.asarray(p),
                                                                     jnp.asarray(X))
    pt = torch.tensor(p, requires_grad=True)
    Xt = torch.tensor(X, requires_grad=True)
    v = fused.mvn_logpdf_fused(ck, pt, Xt, torch.tensor(y), 1.1, panel=128)
    v.backward()
    np.testing.assert_allclose(float(v.detach()), float(v_ref), rtol=VALUE_RTOL)
    np.testing.assert_allclose(pt.grad.numpy(), np.asarray(dp_ref), rtol=GRAD_RTOL,
                               atol=GRAD_RTOL)
    np.testing.assert_allclose(Xt.grad.numpy(), np.asarray(dX_ref), rtol=GRAD_RTOL,
                               atol=GRAD_RTOL)
