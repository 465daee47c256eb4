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
                                           chol_batched_plain, chol_tile_cuda, chol_tile_plain)
from gaplac_tpu_torch.ops.gram import gram_bwd_cuda, gram_bwd_plain, gram_cuda, gram_plain

pytestmark = pytest.mark.cuda

F64_RTOL = 1e-10  # float64 kernels against float64 plain versions


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    _build.library()
    return torch.device("cuda", 0)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("n", [1, 31, 32, 33, 100, 129])
def test_k1_matches_plain(dev, n):
    X = torch.randn((4, n, n), dtype=torch.float64, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(n))
    A = X @ X.mT + n * torch.eye(n, dtype=torch.float64, device=dev)
    before = _build.counts["K1"]
    L = chol_batched_cuda(A)
    assert _build.counts["K1"] == before + 1
    assert _rel(L, chol_batched_plain(A)) < F64_RTOL
    assert float(L.triu(1).abs().max()) == 0.0


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


def test_k2b_repeats_bit_for_bit(dev):
    """K2b sums in a fixed order: two launches give equal bits."""
    ck = compile_formula(parse_formula("y ~| SqExp(:x)").formula)
    gen = torch.Generator(device=dev).manual_seed(0)
    X = torch.rand((500, 1), generator=gen, device=dev) * 10 - 5
    p = 1 + torch.rand((8, 1), generator=gen, device=dev)
    G = torch.randn((8, 500, 500), generator=gen, device=dev)
    a, b = gram_bwd_cuda(ck, p, X, None, G), gram_bwd_cuda(ck, p, X, None, G)
    assert torch.equal(a, b)


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


def test_blocked_through_k3_matches_cholesky(dev):
    gen = torch.Generator(device=dev).manual_seed(1)
    X = torch.randn((700, 700), dtype=torch.float64, device=dev, generator=gen)
    A = X @ X.mT + 700 * torch.eye(700, dtype=torch.float64, device=dev)
    before = _build.counts["K3"]
    L = blocked_cholesky(A)
    assert _build.counts["K3"] - before == 6  # 700 pads to 768: six 128-tiles
    assert _rel(L, torch.linalg.cholesky(A)) < F64_RTOL


def test_wrappers_refuse_cpu_tensors(dev):
    with pytest.raises(ValueError):
        chol_batched_cuda(torch.eye(3, dtype=torch.float64)[None])
    with pytest.raises(ValueError):
        chol_tile_cuda(torch.eye(3, dtype=torch.float64))
    with pytest.raises(ValueError):  # beyond K3's tile
        chol_tile_cuda(torch.eye(129, dtype=torch.float64, device=dev))
