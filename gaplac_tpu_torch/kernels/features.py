"""Feature-map compiler: CompiledKernel -> Phi(params, X) with K ~ Phi Phi^T
(port of ``gaplac_tpu/kernels/features.py``).

The low-rank companion to ``kernels/covariance.py``: every formula lowers to
an (n, m) feature matrix whose outer product approximates (for finite-rank
leaves, equals) the dense gram, so the inference runs in the O(n m^2)
weight-space algebra of ``ops/lowrank.py`` and no n x n matrix is formed.

Per-leaf features, as in ``gaplac_tpu``:
  SqExp/OU/Matern32/Matern52/RQ: random Fourier features
      phi_j(x) = sqrt(2/m) cos(w0_j x / l + b_j),
    with w0 drawn once from the kernel's spectral density at unit
    lengthscale, so the lengthscale enters only through the 1/l scaling.
  Periodic(p; l): RFF of SqExp on the warped u(x) = (cos 2pi x/p, sin 2pi x/p).
  Linear(c) [x, sqrt(c)]; Constant(c) [sqrt(c)]; Cat(v) one-hot over the
    vocabulary; Noise(v) sqrt(s2) one-hot: exact.
  bare Noise: no feature; a product term holding it adds to the covariance
    diagonal only (``noise_diag``).
Products are row-wise Khatri-Rao products of the leaf features, sums concatenate.

The frequencies and phases are drawn with numpy's ``default_rng(seed)`` in
``gaplac_tpu``'s order (leaf by leaf: w0, then b0), so a seed gives the same
features in both packages.  They are host constants, moved to the device
once, when the map is built.  ``phi`` takes a parameter vector (P,) ->
(n, m_total), or a batch (C, P) -> (C, n, m_total).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gaplac_tpu_torch.kernels.covariance import (
    K_CAT,
    K_CONST,
    K_LINEAR,
    K_MATERN32,
    K_MATERN52,
    K_NOISE,
    K_OU,
    K_PERIODIC,
    K_RQ,
    K_SQEXP,
    KIND_NAMES,
    CompiledKernel,
    _leaf_diag,
)

#: stationary leaves approximated by random Fourier features
RFF_KINDS = (K_SQEXP, K_OU, K_MATERN32, K_MATERN52, K_RQ, K_PERIODIC)


def _draw_base_frequencies(
    rng: np.random.Generator, kind: int, m: int, extra: Tuple[float, ...]
) -> np.ndarray:
    """Base frequencies at unit lengthscale, from the kernel's spectral
    density (the draws and their order are ``gaplac_tpu``'s)."""
    if kind == K_SQEXP:
        return rng.standard_normal(m)
    if kind == K_OU:  # Matern nu=1/2: Cauchy
        return rng.standard_cauchy(m)
    if kind == K_MATERN32:  # Student-t, df = 2 nu = 3
        return rng.standard_t(3.0, m)
    if kind == K_MATERN52:  # df = 5
        return rng.standard_t(5.0, m)
    if kind == K_RQ:  # a Gaussian scale mixture, precision ~ Gamma(alpha, rate alpha)
        alpha = extra[0]
        s = rng.gamma(alpha, 1.0 / alpha, m)
        return rng.standard_normal(m) * np.sqrt(s)
    if kind == K_PERIODIC:  # 2-D Gaussian on the warped circle coordinates
        return rng.standard_normal((m, 2))
    raise ValueError(f"kind {kind} has no spectral sampler")


@dataclass(frozen=True)
class FeatureMap:
    """Compiled feature map.  ``phi(params, X)``: params (..., P) -> (..., n,
    m_total), differentiable in params.  ``noise_diag(params, X)`` is the
    bare-Noise diagonal of a symmetric covariance, (n,) or (..., n)."""

    ck: CompiledKernel
    num_features: int
    seed: int
    m_total: int
    _leaf_builders: Tuple[Optional[Callable], ...]
    _feature_terms: Tuple[Tuple[int, ...], ...]
    _diag_terms: Tuple[Tuple[int, ...], ...]
    #: per ck.terms index: the (start, stop) columns of phi for that additive
    #: term, or None for a bare-Noise diagonal term (fitplot's components)
    term_slices: Tuple[Optional[Tuple[int, int]], ...]

    def phi(self, params: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
        blocks = []
        for term in self._feature_terms:
            block = None
            for li in term:
                f = self._leaf_builders[li](params, X)  # (..., n, m_leaf)
                if block is None:
                    block = f
                else:  # row-wise Khatri-Rao product
                    block = (block[..., :, None] * f[..., None, :]).flatten(-2)
            blocks.append(block)
        return torch.cat(blocks, dim=-1)

    def term_diag(self, params: torch.Tensor, X: torch.Tensor, term) -> torch.Tensor:
        """Diagonal of one bare-Noise product term (a tuple of leaf indices).
        Leaves without a column key on row identity (the ``arange``)."""
        ck = self.ck
        block = None
        for li in term:
            col = ck.cols[li]
            x = X[:, col] if col >= 0 else torch.arange(X.shape[0], dtype=X.dtype,
                                                        device=X.device)
            b = _leaf_diag(ck.kinds[li], x, params[..., li, None])
            block = b if block is None else block * b
        return block

    def noise_diag(self, params: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
        """Diagonal of the product terms that hold a bare Noise leaf (zero off
        the diagonal: row identity, as ``CompiledKernel.gram``)."""
        d = torch.zeros(X.shape[0], dtype=X.dtype, device=X.device)
        for term in self._diag_terms:
            d = d + self.term_diag(params, X, term)
        return d


def build_feature_map(
    ck: CompiledKernel,
    data: Sequence[torch.Tensor],
    num_features: int = 256,
    seed: int = 0,
) -> FeatureMap:
    """Compile ``ck`` into a FeatureMap for inputs of ``data[0]``'s dtype and
    device.

    ``data``: every (n_i, n_cols) input matrix the map will be applied to
    (training inputs and any prediction inputs); Cat/Noise vocabularies are
    collected over all of them.  ``num_features``: random features per
    stationary leaf (finite-rank leaves take their natural dimension).
    """
    rng = np.random.default_rng(seed)
    dtype, device = data[0].dtype, data[0].device
    mats = [a.cpu().numpy() for a in data]
    const = lambda a: torch.as_tensor(a, dtype=dtype, device=device)

    def _vocab(col: int) -> np.ndarray:
        return np.unique(np.concatenate([m[:, col] for m in mats]))

    def batch_of(params, X):
        return (*params.shape[:-1], X.shape[0])

    builders: List[Optional[Callable]] = []
    leaf_dims: List[int] = []
    for li, kind in enumerate(ck.kinds):
        col = ck.cols[li]
        extra = ck.extras[li] if ck.extras else ()
        if kind in RFF_KINDS:
            w0 = const(_draw_base_frequencies(rng, kind, num_features, extra))
            b0 = const(rng.uniform(0.0, 2.0 * np.pi, num_features))
            scale = float(np.sqrt(2.0 / num_features))
            if kind == K_PERIODIC:
                tau = 2.0 * np.pi / extra[0]

                def builder(params, X, *, col=col, li=li, w0=w0, b0=b0, tau=tau, scale=scale):
                    x = X[:, col]
                    u = torch.stack([torch.cos(tau * x), torch.sin(tau * x)], dim=1)
                    w = w0 / params[..., li, None, None]            # (..., m, 2)
                    return scale * torch.cos(u @ w.mT + b0)
            else:

                def builder(params, X, *, col=col, li=li, w0=w0, b0=b0, scale=scale):
                    w = w0 / params[..., li, None]                  # (..., m)
                    return scale * torch.cos(X[:, col, None] * w[..., None, :] + b0)

            builders.append(builder)
            leaf_dims.append(num_features)
        elif kind == K_LINEAR:

            def builder(params, X, *, col=col, li=li):
                c = torch.sqrt(torch.clamp(params[..., li, None], min=0.0))
                shape = batch_of(params, X)
                return torch.stack([X[:, col].expand(shape), c.expand(shape)], dim=-1)

            builders.append(builder)
            leaf_dims.append(2)
        elif kind == K_CONST:

            def builder(params, X, *, li=li):
                c = torch.sqrt(torch.clamp(params[..., li, None, None], min=0.0))
                return c.expand(*batch_of(params, X), 1)

            builders.append(builder)
            leaf_dims.append(1)
        elif kind == K_CAT or (kind == K_NOISE and col >= 0):
            vocab = const(_vocab(col))

            def builder(params, X, *, col=col, li=li, vocab=vocab, kind=kind):
                onehot = (X[:, col, None] == vocab).to(X.dtype)
                if kind == K_NOISE:
                    return onehot * torch.sqrt(torch.clamp(params[..., li, None, None],
                                                           min=0.0))
                return onehot.expand(*batch_of(params, X), -1)

            builders.append(builder)
            leaf_dims.append(int(vocab.shape[0]))
        elif kind == K_NOISE:  # bare Noise: a rank-n diagonal, no feature
            builders.append(None)
            leaf_dims.append(0)
        else:  # pragma: no cover - every kind is handled above
            raise ValueError(f"unsupported leaf kind {KIND_NAMES[kind]}")

    feature_terms: List[Tuple[int, ...]] = []
    diag_terms: List[Tuple[int, ...]] = []
    term_slices: List[Optional[Tuple[int, int]]] = []
    m_total = 0
    for term in ck.terms:
        if any(builders[li] is None for li in term):
            diag_terms.append(term)
            term_slices.append(None)
        else:
            feature_terms.append(term)
            m_term = 1
            for li in term:
                m_term *= leaf_dims[li]
            term_slices.append((m_total, m_total + m_term))
            m_total += m_term
    if not feature_terms:
        raise ValueError(
            "formula has no feature-representable term (only bare Noise); "
            "use the exact path"
        )

    return FeatureMap(
        ck, num_features, seed, m_total, tuple(builders),
        tuple(feature_terms), tuple(diag_terms), tuple(term_slices),
    )
