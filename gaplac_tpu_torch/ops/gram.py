"""Batched gram and its backward: kernels K2 and K2b (``csrc/gram.cu``).

K2 replaces the Pallas tiled gram ``gaplac_tpu/ops/gram.py::
_make_gram_kernel``; K2b, its backward to the hyperparameters, is new (the
Pallas kernel had no VJP, and ``gaplac_tpu`` differentiated the plain jnp
gram instead).  Beside each kernel is its plain PyTorch version:
``gram_plain`` evaluates the formula leaf by leaf as
``CompiledKernel.gram``/``bind`` do in ``gaplac_tpu``, and ``gram_bwd_plain``
writes out the closed-form leaf derivatives that K2b implements (not
autograd, so it checks K2b's formulas).  A cross gram may take global row
offsets (r1, r2), on which its bare leaves and ``diag`` key: the fused
factorization's panels (``ops/fused.py``).  ``GramBound`` wires both into
autograd.  A CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises.

On the card a call's host work is the checks that raise, one dictionary
lookup for the formula's descriptor (host memory; the launcher passes the
formula to the kernel by value) and bound C entry points, one output
allocation and the launch: K2b is one kernel with no scratch.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from gaplac_tpu_torch.kernels.covariance import (
    _SQRT3,
    _SQRT5,
    CompiledKernel,
    K_CONST,
    K_LINEAR,
    K_MATERN32,
    K_MATERN52,
    K_NOISE,
    K_OU,
    K_PERIODIC,
    K_RQ,
    K_SQEXP,
    _leaf_cross,
)
from gaplac_tpu_torch.ops import _build

_MAX_LEAVES, _MAX_TERMS, _MAX_PARAMS = 32, 32, 64  # input columns too: at most _MAX_LEAVES


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


#: a gram's global row offsets (r1, r2): a bare leaf of K[i, j] keys on the
#: ids r1 + i and r2 + j
Offsets = Optional[Tuple[int, int]]


def _keyed(symmetric: bool, offsets: Offsets) -> tuple:
    """(keyed, r1, r2): bare leaves and ``diag`` match where r1 + i == r2 + j
    when keyed, nowhere otherwise; a symmetric gram is keyed at (0, 0), a
    cross gram without offsets not at all."""
    if symmetric and offsets is not None:
        raise ValueError("offsets are for cross grams; a symmetric gram has r1 == r2 == 0")
    if offsets is None:
        return int(symmetric), 0, 0
    r1, r2 = (int(r) for r in offsets)
    if min(r1, r2) < 0 or max(r1, r2) >= 2**31:
        raise ValueError(f"row offsets {offsets} outside [0, 2^31)")
    return 1, r1, r2


def _row_ids(n1: int, n2: int, keyed: tuple, dtype, device):
    """The ids bare Noise/Constant leaves key on, from ``_keyed``'s triple:
    r1 + i and r2 + j when keyed, else ids that never match."""
    on, r1, r2 = keyed
    ids1 = torch.arange(r1, r1 + n1, dtype=dtype, device=device)
    if on:
        return ids1, torch.arange(r2, r2 + n2, dtype=dtype, device=device)
    return ids1, torch.full((n2,), -1.0, dtype=dtype, device=device)


def _leaf_inputs(ck: CompiledKernel, li: int, params, X1, X2, ids):
    """(x1, x2, p, e) for leaf ``li``; p, e shaped (C, 1, 1).  Bare leaves key
    on the row ids ``ids``."""
    col = ck.cols[li]
    x1, x2 = (X1[:, col], X2[:, col]) if col >= 0 else ids
    p = params[:, li, None, None]
    es = ck.extra_slots[li]
    e = params[:, es[0], None, None] if es else None
    return x1, x2, p, e


def gram_ids_plain(ck: CompiledKernel, params: torch.Tensor, X1: torch.Tensor,
                   X2: torch.Tensor, ids1: torch.Tensor, ids2: torch.Tensor,
                   diag: float = 0.0) -> torch.Tensor:
    """params (C, n_params) -> (C, n1, n2), bare leaves keyed on the row ids
    ``ids1`` (n1,) and ``ids2`` (n2,), ``diag`` added where they match."""
    C, n1, n2 = params.shape[0], X1.shape[0], X2.shape[0]
    K = torch.zeros((C, n1, n2), dtype=params.dtype, device=params.device)
    for term in ck.terms:
        block = None
        for li in term:
            x1, x2, p, e = _leaf_inputs(ck, li, params, X1, X2, (ids1, ids2))
            b = _leaf_cross(ck.kinds[li], x1, x2, p, e)
            block = b if block is None else block * b
        K = K + block
    if diag:
        K = K + diag * (ids1[:, None] == ids2[None, :]).to(K.dtype)
    return K


def gram_plain(ck: CompiledKernel, params: torch.Tensor, X1: torch.Tensor,
               X2: Optional[torch.Tensor] = None, diag: float = 0.0,
               offsets: Offsets = None) -> torch.Tensor:
    """params (C, n_params) -> (C, n1, n2); ``diag`` on i == j when symmetric,
    on r1 + i == r2 + j under ``offsets`` (r1, r2), nowhere in a cross gram
    without them."""
    symmetric = X2 is None
    X2v = X1 if symmetric else X2
    keyed = _keyed(symmetric, offsets)
    ids = _row_ids(X1.shape[0], X2v.shape[0], keyed, X1.dtype, X1.device)
    return gram_ids_plain(ck, params, X1, X2v, *ids, diag if keyed[0] else 0.0)


def _leaf_dcross(kind, x1, x2, p, e, b):
    """Closed-form (d leaf/d p, d leaf/d e or None) given the leaf value b."""
    d = x1[:, None] - x2[None, :]
    if kind == K_SQEXP:
        return b * d * d / (p * p * p), None
    if kind == K_OU:
        return b * torch.abs(d) / (p * p), None
    if kind in (K_LINEAR, K_CONST):
        return torch.ones_like(b), None
    if kind == K_NOISE:
        return (d == 0).to(b.dtype).expand_as(b), None
    if kind == K_MATERN32:
        r = _SQRT3 * torch.abs(d) / p
        return r * r * torch.exp(-r) / p, None
    if kind == K_MATERN52:
        r = _SQRT5 * torch.abs(d) / p
        return r * r * (1.0 + r) * torch.exp(-r) / (3.0 * p), None
    if kind == K_PERIODIC:
        a = math.pi * d / e
        sn = torch.sin(a)
        return (b * 4.0 * sn * sn / (p * p * p),
                b * (2.0 / (p * p)) * torch.sin(2.0 * a) * a / e)
    if kind == K_RQ:
        t = d * d / (2.0 * e * p * p)
        return b * 2.0 * e * t / (p * (1.0 + t)), b * (t / (1.0 + t) - torch.log1p(t))
    return None, None  # Cat: no hyperparameter


def gram_bwd_plain(ck: CompiledKernel, params: torch.Tensor, X1: torch.Tensor,
                   X2: Optional[torch.Tensor], gK: torch.Tensor,
                   offsets: Offsets = None) -> torch.Tensor:
    """dparams[c, s] = sum_ij gK[c,i,j] dK[c,i,j]/dparams[c,s], (C, n_params)."""
    symmetric = X2 is None
    X2v = X1 if symmetric else X2
    ids = _row_ids(X1.shape[0], X2v.shape[0], _keyed(symmetric, offsets), X1.dtype,
                   X1.device)
    cols = [torch.zeros(params.shape[0], dtype=params.dtype, device=params.device)
            for _ in range(params.shape[1])]
    for term in ck.terms:
        ins = [_leaf_inputs(ck, li, params, X1, X2v, ids) for li in term]
        vals = [_leaf_cross(ck.kinds[li], *a) for li, a in zip(term, ins)]
        for k, li in enumerate(term):
            w = gK
            for m, v in enumerate(vals):
                if m != k:
                    w = w * v
            dp, de = _leaf_dcross(ck.kinds[li], *ins[k], vals[k])
            if dp is not None:
                cols[li] = cols[li] + (w * dp).sum(dim=(1, 2))
            if de is not None:
                s = ck.extra_slots[li][0]
                cols[s] = cols[s] + (w * de).sum(dim=(1, 2))
    return torch.stack(cols, dim=1)


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------


def descriptor(ck: CompiledKernel) -> np.ndarray:
    """int32 formula table for K2/K2b:
    kind[L] col[L] extra[L] term_ptr[NT + 1] term_leaf[sum of term lengths];
    the C launcher checks it and passes it to the kernel by value."""
    L, NT, d = ck.n_leaves, len(ck.terms), len(ck.varnames)
    if L > _MAX_LEAVES or NT > _MAX_TERMS or ck.n_params > _MAX_PARAMS or d > _MAX_LEAVES:
        raise ValueError(f"formula too large for the gram kernel ({L} leaves, {NT} terms, "
                         f"{ck.n_params} params, {d} input columns; limits {_MAX_LEAVES}/"
                         f"{_MAX_TERMS}/{_MAX_PARAMS}/{_MAX_LEAVES})")
    for li, (kind, col) in enumerate(zip(ck.kinds, ck.cols)):
        if col < 0 and kind not in (K_NOISE, K_CONST):
            raise ValueError(f"leaf {li}: only Noise and Constant may lack a column")
    extra = [es[0] if es else -1 for es in ck.extra_slots]
    ptr = np.cumsum([0] + [len(t) for t in ck.terms])
    flat = [li for t in ck.terms for li in t]
    return np.asarray(list(ck.kinds) + list(ck.cols) + extra + list(ptr) + flat, np.int32)


class _Launch(NamedTuple):
    """What a launch of K2 or K2b needs of one formula in one dtype, made
    once: the descriptor (host memory; the launcher passes the formula to the
    kernel by value) and the bound C entry points."""

    ck: CompiledKernel
    desc: np.ndarray
    head: tuple  # (descriptor pointer, leaves, terms)
    fwd: object
    bwd: object
    d: int
    n_params: int


_launches: dict = {}


def _launch(ck: CompiledKernel, dtype: torch.dtype) -> _Launch:
    key = (id(ck), dtype)
    entry = _launches.get(key)
    if entry is not None:  # the entry holds ck, so no other formula takes its id
        return entry
    lib = _build.library()
    sfx = "f32" if dtype == torch.float32 else "f64"
    desc = descriptor(ck)
    entry = _Launch(ck, desc, (desc.ctypes.data, ck.n_leaves, len(ck.terms)),
                    getattr(lib, f"gaplac_gram_fwd_{sfx}"), getattr(lib, f"gaplac_gram_bwd_{sfx}"),
                    len(ck.varnames), ck.n_params)
    _launches[key] = entry
    return entry


def _gram_args(ck, params, X1, X2v, what, *more):
    """The launch entry after the checks that raise: one CUDA device, one
    float dtype, contiguous, params (C, n_params), X (n, d)."""
    dtype = _build.require_cuda(what, params, X1, X2v, *more)
    e = _launch(ck, dtype)
    if (params.dim() != 2 or params.shape[1] != e.n_params or X1.dim() != 2
            or X2v.dim() != 2 or X1.shape[1] != e.d or X2v.shape[1] != e.d):
        raise ValueError(f"{what}: params (C, {e.n_params}) and X (n, {e.d}) expected, got "
                         f"{tuple(params.shape)}, {tuple(X1.shape)}, {tuple(X2v.shape)}")
    if params.shape[0] > 65535:
        raise ValueError(f"{what}: a batch of more than 65535 beyond the launch grid")
    return e


def gram_cuda(ck: CompiledKernel, params: torch.Tensor, X1: torch.Tensor,
              X2: Optional[torch.Tensor] = None, diag: float = 0.0,
              offsets: Offsets = None) -> torch.Tensor:
    """K2: params (C, n_params) -> (C, n1, n2) on the card; ``offsets`` as in
    ``gram_plain``."""
    symmetric = X2 is None
    X2v = X1 if symmetric else X2
    keyed = _keyed(symmetric, offsets)
    e = _gram_args(ck, params, X1, X2v, "gram (K2)")
    C, n1, n2 = params.shape[0], X1.shape[0], X2v.shape[0]
    out = torch.empty((C, n1, n2), dtype=params.dtype, device=params.device)
    err = e.fwd(*e.head, X1.data_ptr(), X2v.data_ptr(), n1, n2, e.d, params.data_ptr(), C,
                e.n_params, float(diag), int(symmetric), *keyed, out.data_ptr(),
                params.device.index, _build.stream_of(params))
    _build.check(err, "gram (K2)")
    _build.counts["K2"] += 1
    return out


def gram_bwd_cuda(ck: CompiledKernel, params: torch.Tensor, X1: torch.Tensor,
                  X2: Optional[torch.Tensor], gK: torch.Tensor,
                  offsets: Offsets = None) -> torch.Tensor:
    """K2b: the (C, n_params) gradient of <gK, K(params)> on the card, one
    launch; gK need not be symmetric; ``offsets`` as in ``gram_plain``."""
    symmetric = X2 is None
    X2v = X1 if symmetric else X2
    keyed = _keyed(symmetric, offsets)
    e = _gram_args(ck, params, X1, X2v, "gram backward (K2b)", gK)
    C, n1, n2 = params.shape[0], X1.shape[0], X2v.shape[0]
    if gK.shape != (C, n1, n2):
        raise ValueError(f"gram backward (K2b): gK of shape {tuple(gK.shape)}")
    dparams = torch.empty_like(params)
    err = e.bwd(*e.head, X1.data_ptr(), X2v.data_ptr(), n1, n2, e.d, params.data_ptr(), C,
                e.n_params, int(symmetric), *keyed, gK.data_ptr(), dparams.data_ptr(),
                params.device.index, _build.stream_of(params))
    _build.check(err, "gram backward (K2b)")
    _build.counts["K2b"] += 1
    return dparams


def gram_bwd_cluster(C: int, dtype: torch.dtype, device) -> int:
    """The cluster size K2b takes for C chains on the card ``device`` (an
    index, or the device of the tensor K2b launches on): 16 where C clusters
    of 16 fit on it at once, else 8."""
    got = _build.library().gaplac_gram_bwd_cluster(C, int(dtype == torch.float64),
                                                   _build.device_index(device))
    if got < 0:
        _build.check(-got, "gram backward (K2b) occupancy")
    return got


def gram(ck, params, X1, X2=None, diag=0.0, offsets: Offsets = None):
    """Forward gram by device: K2 on CUDA, the plain version on the CPU."""
    if params.is_cuda:
        return gram_cuda(ck, params, X1, X2, diag, offsets)
    return gram_plain(ck, params, X1, X2, diag, offsets)


def gram_bwd(ck, params, X1, X2, gK, offsets: Offsets = None):
    if params.is_cuda:
        return gram_bwd_cuda(ck, params, X1, X2, gK, offsets)
    return gram_bwd_plain(ck, params, X1, X2, gK, offsets)


class GramBound(torch.autograd.Function):
    """params (C, n_params) -> K (C, n1, n2) = gram + diag I (symmetric),
    differentiable in params through K2b (CUDA) or its plain version."""

    @staticmethod
    def forward(ctx, params, ck, X1, X2, diag):
        params = params.contiguous()
        ctx.ck, ctx.X1, ctx.X2 = ck, X1, X2
        ctx.save_for_backward(params)
        return gram(ck, params, X1, X2, diag)

    @staticmethod
    def backward(ctx, gK):
        (params,) = ctx.saved_tensors
        return gram_bwd(ctx.ck, params, ctx.X1, ctx.X2, gK.contiguous()), None, None, None, None
