"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU with nvcc (they build the kernels); without
one they skip.  Run them on the card with

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

(``--noconftest``: tests/conftest.py configures JAX, which a GPU machine
without JAX lacks.)
"""

import numpy as np
import pytest
import torch

from gaplac_tpu_torch.dsl import parse_formula
from gaplac_tpu_torch.kernels.covariance import compile_formula
from gaplac_tpu_torch.ops import _build
from gaplac_tpu_torch.ops.cholesky import (blocked_cholesky, chol_batched_cuda,
                                           chol_batched_plain, chol_tile_cuda, chol_tile_plain,
                                           k1_clusters_that_fit)
from gaplac_tpu_torch.ops.gram import (gram_bwd_cluster, gram_bwd_cuda, gram_bwd_plain, gram_cuda,
                                       gram_plain)

pytestmark = pytest.mark.cuda

F64_RTOL = 1e-10  # float64 kernels against float64 plain versions
#: a float32 kernel against the float64 plain version: at most this multiple
#: of the float32 plain version's own error, or F32_FLOOR (relative), since
#: the kernel sums in another order than cuSOLVER but in the same precision
F32_FACTOR, F32_FLOOR = 4.0, 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    _build.library()
    return torch.device("cuda", 0)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def _spd(shape, seed, dev):
    """X X^T + n I, float64: SPD with eigenvalues at least n."""
    n = shape[-1]
    X = torch.randn(shape, dtype=torch.float64, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(seed))
    return X @ X.mT + n * torch.eye(n, dtype=torch.float64, device=dev)


def _check_factor(L, A64, plain):
    """L (the kernel's factor of A64 in L's dtype) against ``plain`` applied
    in float64, with the float32 rule or F64_RTOL."""
    ref = plain(A64)
    if L.dtype == torch.float64:
        assert _rel(L, ref) < F64_RTOL
    else:
        tol = max(F32_FACTOR * _rel(plain(A64.float()).double(), ref), F32_FLOOR)
        assert _rel(L.double(), ref) <= tol
    assert float(L.triu(1).abs().max()) == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 31, 32, 33, 100, 129, 500, 2047])
@pytest.mark.parametrize("batch", [1, 3, 8])
def test_k1_matches_plain(dev, batch, n, dtype):
    """One cluster per matrix; ragged panels (31, 33, 129, 2047) and n below,
    at and past the panel and the trailing tile; one launch a call."""
    A = _spd((batch, n, n), 10 * batch + n, dev)
    before = _build.counts["K1"]
    L = chol_batched_cuda(A.to(dtype))
    assert _build.counts["K1"] == before + 1
    _check_factor(L, A, chol_batched_plain)


def test_k1_three_dimensional_batch_past_the_blocked_threshold(dev):
    """A 3-D batch with n >= 2048 still goes to K1 (ops/linalg.py)."""
    A = _spd((2, 2100, 2100), 2, dev)
    _check_factor(chol_batched_cuda(A), A, chol_batched_plain)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("batch", [512, 37])
def test_k1_large_batches(dev, batch, dtype):
    """SMC's particle batch: 512 matrices are many waves of the clusters the
    card holds at once, and 37 leaves a ragged last wave."""
    A = _spd((batch, 128, 128), batch, dev)
    before = _build.counts["K1"]
    L = chol_batched_cuda(A.to(dtype))
    assert _build.counts["K1"] == before + 1
    _check_factor(L, A, chol_batched_plain)


@pytest.mark.parametrize("cluster", [8, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k1_cluster_sizes(dev, cluster, dtype):
    """The portable cluster of 8 and the non-portable 16 give the same factor."""
    A = _spd((8, 500, 500), 3, dev)
    _check_factor(chol_batched_cuda(A.to(dtype), cluster=cluster), A, chol_batched_plain)


def test_k1_cluster_occupancy(dev):
    """The card holds at least one cluster of each size K1 launches."""
    for dtype in (torch.float32, torch.float64):
        assert k1_clusters_that_fit(8, dtype, dev) >= 1
        assert k1_clusters_that_fit(16, dtype, dev) >= 1


def test_occupancy_helpers_take_an_explicit_device_index(dev):
    """K1's and K2b's occupancy helpers ask the card they are given, by index
    or by a tensor's device, not device 0 or the current one."""
    last = torch.cuda.device_count() - 1
    t = torch.zeros(1, device=torch.device("cuda", last))
    for dtype in (torch.float32, torch.float64):
        for cl in (8, 16):
            assert k1_clusters_that_fit(cl, dtype, last) == k1_clusters_that_fit(cl, dtype,
                                                                                  t.device) >= 1
        assert gram_bwd_cluster(1, dtype, last) == gram_bwd_cluster(1, dtype, t.device) == 16
    with pytest.raises(ValueError, match="CUDA device with an index"):
        k1_clusters_that_fit(8, torch.float32, torch.device("cpu"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k1_non_pd_member_is_nan_and_the_others_finite(dev, dtype):
    A = _spd((3, 100, 100), 4, dev)
    A[1, 60, 60] = -1e4
    L = chol_batched_cuda(A.to(dtype))
    assert torch.isnan(L[1]).all()
    assert torch.isfinite(L[[0, 2]]).all()
    _check_factor(L[[0, 2]], A[[0, 2]], chol_batched_plain)


@pytest.mark.parametrize("formula", [
    "y ~| SqExp(:t) * Cat(:g) + Linear(:x) + OU(:t2) + Noise",
    "y ~| Matern32(:t) + Matern52(:t2) * Periodic(:s; l=1.2, p=2.5) + RQ(:x; l=0.8, alpha=1.5)",
])
@pytest.mark.parametrize("symmetric", [True, False])
def test_k2_and_k2b_match_plain(dev, formula, symmetric):
    ck = compile_formula(parse_formula(formula).formula)
    rng = np.random.default_rng(0)
    X1 = rng.normal(size=(45, 4))
    X1[:, 1] = np.floor(np.abs(X1[:, 1]) * 2)
    X1 = torch.as_tensor(X1, device=dev)
    X2 = None if symmetric else torch.as_tensor(rng.normal(size=(17, 4)), device=dev)
    p = ck.default_params(torch.float64, dev).expand(3, -1) * torch.as_tensor(
        rng.uniform(0.7, 1.4, (3, ck.n_params)), device=dev)
    p = p.contiguous()
    assert _rel(gram_cuda(ck, p, X1, X2, 0.1), gram_plain(ck, p, X1, X2, 0.1)) < F64_RTOL
    G = torch.as_tensor(rng.normal(size=(3, 45, 45 if symmetric else 17)), device=dev)
    assert _rel(gram_bwd_cuda(ck, p, X1, X2, G), gram_bwd_plain(ck, p, X1, X2, G)) < F64_RTOL


def test_k2_and_k2b_for_one_term_of_a_formula(dev):
    """A formula cut to one of its terms (fitplot's term grams): the
    descriptor's leaf list holds fewer entries than the formula has leaves,
    and the kernels read no further."""
    from gaplac_tpu_torch.kernels.covariance import CompiledKernel

    ck = compile_formula(parse_formula(
        "y ~| SqExp(:t) * Cat(:g) + Linear(:x) + OU(:t2) + Noise").formula)
    rng = np.random.default_rng(2)
    X = rng.normal(size=(40, 4))
    X[:, 1] = np.floor(np.abs(X[:, 1]) * 2)
    X = torch.as_tensor(X, device=dev)
    p = ck.default_params(torch.float64, dev)[None].contiguous()
    G = torch.as_tensor(rng.normal(size=(1, 40, 40)), device=dev)
    for term in ck.terms:
        sub = CompiledKernel(ck.varnames, ck.kinds, ck.cols, (term,), ck.defaults, ck.leaf_vars,
                             ck.extras)
        for _ in range(20):
            assert _rel(gram_cuda(sub, p, X, None, 0.0), gram_plain(sub, p, X, None, 0.0)) \
                < F64_RTOL
        assert _rel(gram_bwd_cuda(sub, p, X, None, G), gram_bwd_plain(sub, p, X, None, G)) \
            < F64_RTOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k2_at_a_batch_of_512(dev, dtype):
    """SMC's particle batch, (512, 128, 128): one grid row a particle."""
    ck = compile_formula(parse_formula("y ~| SqExp(:x)").formula)
    rng = np.random.default_rng(7)
    X = torch.as_tensor(rng.uniform(-5, 5, (128, 1)), device=dev)
    p = torch.as_tensor(rng.uniform(0.5, 3.0, (512, 1)), device=dev)
    ref = gram_plain(ck, p, X, None, 0.1)
    K = gram_cuda(ck, p.to(dtype), X.to(dtype), None, 0.1)
    if dtype == torch.float64:
        assert _rel(K, ref) < F64_RTOL
    else:
        plain = gram_plain(ck, p.float(), X.float(), None, 0.1).double()
        assert _rel(K.double(), ref) <= max(F32_FACTOR * _rel(plain, ref), F32_FLOOR)


def test_k2b_repeats_bit_for_bit(dev):
    """K2b sums in a fixed order: two launches give equal bits."""
    ck = compile_formula(parse_formula("y ~| SqExp(:x)").formula)
    gen = torch.Generator(device=dev).manual_seed(0)
    X = torch.rand((500, 1), generator=gen, device=dev) * 10 - 5
    p = 1 + torch.rand((8, 1), generator=gen, device=dev)
    G = torch.randn((8, 500, 500), generator=gen, device=dev)
    a, b = gram_bwd_cuda(ck, p, X, None, G), gram_bwd_cuda(ck, p, X, None, G)
    assert torch.equal(a, b)


COMPOSITE = "y ~| SqExp(:t) * Cat(:g) + Linear(:x) + OU(:t2) + Noise"
EXTENDED = ("y ~| Matern32(:t) + Matern52(:t2) * Periodic(:s; l=1.2, p=2.5)"
            " + RQ(:x; l=0.8, alpha=1.5)")
#: the cross gram's column count beside each row count: n2 % 4 == 0 takes
#: the kernels' 16-byte path, any other n2 the scalar one
CROSS_N2 = {1: 3, 63: 64, 64: 70, 65: 128, 500: 129}


def _gram_inputs(ck, C, n1, n2, dev, seed):
    """float64 X1 (n1, 4) with a categorical column, X2 (n2, 4) or None, params
    (C, n_params) about the defaults, and a cotangent (C, n1, n2 or n1) that
    is not symmetric."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n1 + (n2 or 0), 4))
    X[:, 1] = np.floor(np.abs(X[:, 1]) * 2)
    X = torch.as_tensor(X, device=dev)
    X1, X2 = X[:n1].contiguous(), None if n2 is None else X[n1:].contiguous()
    p = ck.default_params(torch.float64, dev).expand(C, -1) * torch.as_tensor(
        rng.uniform(0.7, 1.4, (C, ck.n_params)), device=dev)
    G = torch.as_tensor(rng.normal(size=(C, n1, n2 or n1)), device=dev)
    return X1, X2, p.contiguous(), G


def _check_kernel(got, plain, args64, dtype):
    """got (the kernel in dtype) against plain(*args64) in float64, with the
    float32 rule or F64_RTOL."""
    ref = plain(*args64)
    if dtype == torch.float64:
        assert _rel(got, ref) < F64_RTOL
    else:
        f32 = [a.float() if isinstance(a, torch.Tensor) else a for a in args64]
        tol = max(F32_FACTOR * _rel(plain(*f32).double(), ref), F32_FLOOR)
        assert _rel(got.double(), ref) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("C", [1, 8])
@pytest.mark.parametrize("n", sorted(CROSS_N2))
def test_k2_and_k2b_edge_shapes(dev, n, C, symmetric, dtype):
    """Tiles of 32 cut at n = 1, 63, 64, 65 and 500, with a cotangent that is
    not symmetric for a symmetric gram (K2b folds gK_ij + gK_ji)."""
    ck = compile_formula(parse_formula(COMPOSITE).formula)
    X1, X2, p, G = _gram_inputs(ck, C, n, None if symmetric else CROSS_N2[n], dev, n + C)
    c = lambda t: None if t is None else t.to(dtype)
    _check_kernel(gram_cuda(ck, c(p), c(X1), c(X2), 0.1),
                  lambda *a: gram_plain(ck, *a, 0.1), (p, X1, X2), dtype)
    _check_kernel(gram_bwd_cuda(ck, c(p), c(X1), c(X2), c(G)),
                  lambda *a: gram_bwd_plain(ck, *a), (p, X1, X2, G), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("formula", [COMPOSITE, EXTENDED])
def test_k2_symmetric_output_is_symmetric_bit_for_bit(dev, formula, dtype):
    ck = compile_formula(parse_formula(formula).formula)
    X1, _, p, _ = _gram_inputs(ck, 8, 500, None, dev, 1)
    K = gram_cuda(ck, p.to(dtype), X1.to(dtype), None, 0.1)
    assert torch.equal(K, K.mT)


def test_k2b_repeats_bit_for_bit_one_chain(dev):
    """At NUTS's (1, 500, 500), where the launcher takes clusters of 16."""
    ck = compile_formula(parse_formula("y ~| SqExp(:x)").formula)
    gen = torch.Generator(device=dev).manual_seed(1)
    X = torch.rand((500, 1), generator=gen, device=dev) * 10 - 5
    p = 1 + torch.rand((1, 1), generator=gen, device=dev)
    G = torch.randn((1, 500, 500), generator=gen, device=dev)
    first = gram_bwd_cuda(ck, p, X, None, G)
    for _ in range(19):
        assert torch.equal(gram_bwd_cuda(ck, p, X, None, G), first)


def test_k2b_cluster_size(dev):
    for dtype in (torch.float32, torch.float64):
        assert gram_bwd_cluster(1, dtype, dev) == 16
        assert gram_bwd_cluster(8, dtype, dev) in (8, 16)
        assert gram_bwd_cluster(10 ** 4, dtype, dev) == 8


#: K2/K2b at global row offsets (r1, r2), n1 x n2, against a matrix of 300
#: rows: panels whose diagonal r1 + i == r2 + j crosses them (the fused
#: factorization's (j0, j0), ragged too) and panels wholly below it
OFFSET_PANELS = [(0, 0, 300, 128), (128, 128, 172, 128), (256, 256, 44, 44), (40, 13, 97, 61),
                 (200, 0, 100, 128), (128, 0, 172, 64)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("formula", [COMPOSITE, "y ~| Noise"])
@pytest.mark.parametrize("r1, r2, n1, n2", OFFSET_PANELS)
def test_k2_and_k2b_at_row_offsets_match_plain(dev, r1, r2, n1, n2, formula, dtype):
    ck = compile_formula(parse_formula(formula).formula)
    X, _, p, _ = _gram_inputs(ck, 2, 300, None, dev, r1 + n2)
    X = X[:, :len(ck.varnames)]  # "y ~| Noise" reads no column
    X1, X2 = X[r1:r1 + n1].contiguous(), X[r2:r2 + n2].contiguous()
    G = torch.as_tensor(np.random.default_rng(r2).normal(size=(2, n1, n2)), device=dev)
    c = lambda t: t.to(dtype)
    before = dict(_build.counts)
    K = gram_cuda(ck, c(p), c(X1), c(X2), 0.1, offsets=(r1, r2))
    dp = gram_bwd_cuda(ck, c(p), c(X1), c(X2), c(G), offsets=(r1, r2))
    assert (_build.counts["K2"] - before["K2"], _build.counts["K2b"] - before["K2b"]) == (1, 1)
    if formula == COMPOSITE:
        _check_kernel(K, lambda *a: gram_plain(ck, *a, 0.1, offsets=(r1, r2)), (p, X1, X2),
                      dtype)
        _check_kernel(dp, lambda *a: gram_bwd_plain(ck, *a, offsets=(r1, r2)),
                      (p, X1, X2, G), dtype)
        return
    # bare Noise: p + 0.1 exactly where the global ids meet, else 0; its
    # gradient the sum of gK there (none on a panel wholly below the diagonal)
    meet = (torch.arange(r1, r1 + n1, device=dev)[:, None]
            == torch.arange(r2, r2 + n2, device=dev)[None])
    assert torch.equal(K, torch.where(meet, c(p)[:, :1, None] + 0.1, 0.0).to(dtype))
    want = (c(G) * meet).sum(dim=(1, 2))[:, None]
    if meet.any():
        assert _rel(dp.double(), want.double()) < (F64_RTOL if dtype == torch.float64 else 1e-5)
    else:
        assert torch.equal(dp, torch.zeros_like(dp))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("formula", [COMPOSITE, EXTENDED])
def test_k2_gram_is_the_cross_gram_at_offsets_zero_bit_for_bit(dev, formula, dtype):
    """The symmetric gram is the case r1 == r2 with X1 = X2; a cross gram
    without offsets keys bare leaves on nothing, as at offsets whose ranges
    never meet, and its bare Noise adds exact zeros."""
    ck = compile_formula(parse_formula(formula).formula)
    X1, X2, p, G = _gram_inputs(ck, 3, 130, 70, dev, 5)
    p, X1, X2, G = p.to(dtype), X1.to(dtype), X2.to(dtype), G.to(dtype)
    assert torch.equal(gram_cuda(ck, p, X1, None, 0.1),
                       gram_cuda(ck, p, X1, X1, 0.1, offsets=(0, 0)))
    cross = gram_cuda(ck, p, X1, X2, 0.1)
    assert torch.equal(cross, gram_cuda(ck, p, X1, X2, 0.1, offsets=(0, 130)))
    assert torch.equal(gram_bwd_cuda(ck, p, X1, X2, G),
                       gram_bwd_cuda(ck, p, X1, X2, G, offsets=(500, 0)))
    if formula == COMPOSITE:  # the same formula without its bare Noise
        sub = compile_formula(parse_formula(
            "y ~| SqExp(:t) * Cat(:g) + Linear(:x) + OU(:t2)").formula)
        assert torch.equal(cross, gram_cuda(sub, p[:, :4].contiguous(), X1, X2, 0.1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fused_factor_matches_two_step(dev, dtype):
    """The fused factorization at n = 4096 (two panels of 2048 from K2 at row
    offsets, 16 K3 tiles each) against blocked_cholesky of K2's gram, by the
    float32 rule against the float64 two-step."""
    from gaplac_tpu_torch.ops.fused import fused_gram_cholesky

    ck = compile_formula(parse_formula("y ~| SqExp(:t) * Cat(:g) + Linear(:x) + Noise").formula)
    rng = np.random.default_rng(3)
    X = rng.normal(size=(4096, 3))
    X[:, 1] = np.floor(np.abs(X[:, 1]) * 2)
    X = torch.as_tensor(X, device=dev)
    p = ck.default_params(torch.float64, dev)
    two_step = lambda p_, X_: blocked_cholesky(gram_cuda(ck, p_[None], X_, None, 1.1)[0])
    ref = two_step(p, X)
    before = dict(_build.counts)
    L = fused_gram_cholesky(ck, 1.1, 2048, p.to(dtype), X.to(dtype))
    assert (_build.counts["K2"] - before["K2"], _build.counts["K3"] - before["K3"]) == (2, 32)
    if dtype == torch.float64:
        assert _rel(L, ref) < F64_RTOL
    else:
        tol = max(F32_FACTOR * _rel(two_step(p.float(), X.float()).double(), ref), F32_FLOOR)
        assert _rel(L.double(), ref) <= tol
    assert float(L.triu(1).abs().max()) == 0.0


@pytest.mark.parametrize("n", [1, 37, 127, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k3_matches_plain(dev, n, dtype):
    gen = torch.Generator(device=dev).manual_seed(n)
    X = torch.randn((n, n), dtype=torch.float64, device=dev, generator=gen)
    A = X @ X.mT + n * torch.eye(n, dtype=torch.float64, device=dev)
    before = _build.counts["K3"]
    L = chol_tile_cuda(A.to(dtype))
    assert _build.counts["K3"] == before + 1
    tol = F64_RTOL if dtype == torch.float64 else 1e-5
    assert _rel(L.double(), chol_tile_plain(A)) < tol
    assert float(L.triu(1).abs().max()) == 0.0
    assert torch.isnan(chol_tile_cuda(-A.to(dtype))).all()


@pytest.mark.parametrize("n", [1, 37, 127, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k3_on_strided_views(dev, n, dtype):
    """K3 reads a block of a larger matrix (lda > n) and writes the factor into
    a block of another (ldl > n); nothing outside that block changes."""
    A = _spd((n, n), 100 + n, dev)
    big = torch.randn((n + 40, n + 56), dtype=torch.float64, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(n)).to(dtype)
    big[7:7 + n, 13:13 + n] = A.to(dtype)
    out = torch.full((n + 30, n + 70), 7.0, dtype=dtype, device=dev)
    view = out[5:5 + n, 21:21 + n]
    before = _build.counts["K3"]
    assert chol_tile_cuda(big[7:7 + n, 13:13 + n], view) is view
    assert _build.counts["K3"] == before + 1
    _check_factor(view, A, chol_tile_plain)
    outside = torch.ones_like(out, dtype=torch.bool)
    outside[5:5 + n, 21:21 + n] = False
    assert (out[outside] == 7.0).all()
    big[7 + n // 2, 13 + n // 2] = -1.0  # not positive definite: the whole view is NaN
    assert torch.isnan(chol_tile_cuda(big[7:7 + n, 13:13 + n], view)).all()
    assert (out[outside] == 7.0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n, tiles", [(700, 6), (4096, 32)])  # 700 pads to 768
def test_blocked_through_k3_matches_cholesky(dev, n, tiles, dtype):
    """The blocked route (at path 2's n, and ragged) against cuSOLVER."""
    A = _spd((n, n), n, dev)
    before = _build.counts["K3"]
    L = blocked_cholesky(A.to(dtype))
    assert _build.counts["K3"] - before == tiles
    _check_factor(L, A, torch.linalg.cholesky)


def test_wrappers_refuse_cpu_tensors(dev):
    with pytest.raises(ValueError):
        chol_batched_cuda(torch.eye(3, dtype=torch.float64)[None])
    with pytest.raises(ValueError):
        chol_tile_cuda(torch.eye(3, dtype=torch.float64))
    with pytest.raises(ValueError):  # beyond K3's tile
        chol_tile_cuda(torch.eye(129, dtype=torch.float64, device=dev))
    with pytest.raises(ValueError):  # rows not contiguous
        chol_tile_cuda(torch.eye(8, dtype=torch.float64, device=dev).mT[::2, ::2])
