"""Covariance library and formula compiler (port of
``gaplac_tpu/kernels/covariance.py``).

A formula's leaves, left to right, define the input-matrix columns; the
compiled kernel is a SUM over product terms, each the elementwise PRODUCT of
its leaves' 1-D kernels on their own columns.  ``CompiledKernel`` is the
same static description as in ``gaplac_tpu`` and is built from the same
AST.  Its grams are batched over a leading axis of parameter vectors
``(C, n_params)`` -> ``(C, n1, n2)`` and go through ``ops/gram.py``: the K2
kernel for CUDA tensors, the plain version below for CPU tensors.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import cached_property
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from gaplac_tpu_torch.dsl.ast import (
    Cat,
    Constant,
    GPComponent,
    Linear,
    Matern32,
    Matern52,
    Noise,
    OU,
    Periodic,
    RQ,
    SqExp,
    leaves as ast_leaves,
    sum_of_products,
)

(K_SQEXP, K_OU, K_LINEAR, K_CAT, K_NOISE, K_CONST,
 K_MATERN32, K_MATERN52, K_PERIODIC, K_RQ) = range(10)

_KIND_OF = {
    SqExp: K_SQEXP, OU: K_OU, Linear: K_LINEAR, Cat: K_CAT, Noise: K_NOISE,
    Constant: K_CONST, Matern32: K_MATERN32, Matern52: K_MATERN52,
    Periodic: K_PERIODIC, RQ: K_RQ,
}

#: kind code -> display name (the CLI's labels)
KIND_NAMES = {
    K_SQEXP: "SqExp", K_OU: "OU", K_LINEAR: "Linear", K_CAT: "Cat", K_NOISE: "Noise",
    K_CONST: "Constant", K_MATERN32: "Matern32", K_MATERN52: "Matern52",
    K_PERIODIC: "Periodic", K_RQ: "RQ",
}

#: kinds whose scalar hyperparameter is a lengthscale (the chain-sampled
#: class that predict/sample take from a chain without --infer)
LENGTHSCALE_KINDS = (K_SQEXP, K_OU, K_MATERN32, K_MATERN52, K_PERIODIC, K_RQ)

_SQRT3 = 3.0 ** 0.5
_SQRT5 = 5.0 ** 0.5


def _leaf_cross(kind: int, x1: torch.Tensor, x2: torch.Tensor, p: torch.Tensor,
                e: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One leaf's cross covariance k(x1[:, None], x2[None, :]).

    ``x1`` (n1,), ``x2`` (n2,); ``p`` the leaf's hyperparameter and ``e`` its
    shape parameter (Periodic period, RQ alpha), each broadcastable against
    (n1, n2), e.g. (C, 1, 1).  Definitions as in ``gaplac_tpu``:
      SqExp exp(-d^2/2l^2); OU exp(-|d|/l); Linear x x' + c; Cat 1[x == x'];
      Noise s2 1[x == x']; Constant c; Matern32 (1+r)e^-r, r = sqrt3|d|/l;
      Matern52 (1+r+r^2/3)e^-r, r = sqrt5|d|/l; Periodic
      exp(-2 sin^2(pi d/p)/l^2); RQ (1 + d^2/(2 alpha l^2))^-alpha.
    """
    d = x1[:, None] - x2[None, :]
    if kind == K_SQEXP:
        return torch.exp(-d * d * (0.5 / (p * p)))
    if kind == K_OU:
        return torch.exp(-torch.abs(d) / p)
    if kind == K_LINEAR:
        return x1[:, None] * x2[None, :] + p
    if kind == K_CAT:
        return (d == 0).to(x1.dtype)
    if kind == K_NOISE:
        return p * (d == 0).to(x1.dtype)
    if kind == K_CONST:
        return p * torch.ones_like(d)
    if kind == K_MATERN32:
        r = _SQRT3 * torch.abs(d) / p
        return (1.0 + r) * torch.exp(-r)
    if kind == K_MATERN52:
        r = _SQRT5 * torch.abs(d) / p
        return (1.0 + r + r * r / 3.0) * torch.exp(-r)
    if kind == K_PERIODIC:
        s = torch.sin(math.pi * d / e) ** 2
        return torch.exp(-2.0 * s / (p * p))
    if kind == K_RQ:
        return (1.0 + d * d / (2.0 * e * p * p)) ** (-e)
    raise ValueError(f"unknown leaf kind {kind}")


def _leaf_diag(kind: int, x: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """k(x_i, x_i) of one leaf; ``p`` broadcastable against (n,)."""
    one = torch.ones_like(x)
    if kind in (K_SQEXP, K_OU, K_CAT, K_MATERN32, K_MATERN52, K_PERIODIC, K_RQ):
        return one
    if kind == K_LINEAR:
        return x * x + p
    if kind in (K_NOISE, K_CONST):
        return p * one
    raise ValueError(f"unknown leaf kind {kind}")


@dataclass(frozen=True)
class CompiledKernel:
    """Static compilation of a formula AST; the same fields as
    ``gaplac_tpu.kernels.covariance.CompiledKernel``.

    varnames : data columns, formula left-to-right order
    kinds    : per-leaf kernel kind code
    cols     : per-leaf input column, or -1 for bare Noise/Constant (which
               key on row identity)
    terms    : sum-of-products structure as leaf-index tuples
    defaults : per-leaf default hyperparameter values
    leaf_vars: per-leaf varname ("" for bare Noise/Constant)
    extras   : per-leaf shape parameters (Periodic period, RQ alpha); they
               also occupy trailing slots of the extended parameter vector
    """

    varnames: Tuple[str, ...]
    kinds: Tuple[int, ...]
    cols: Tuple[int, ...]
    terms: Tuple[Tuple[int, ...], ...]
    defaults: Tuple[float, ...]
    leaf_vars: Tuple[str, ...]
    extras: Tuple[Tuple[float, ...], ...] = ()

    # -- construction ------------------------------------------------------

    @staticmethod
    def compile(formula: GPComponent) -> "CompiledKernel":
        lvs = ast_leaves(formula)
        varnames: list[str] = []
        cols: list[int] = []
        for lf in lvs:
            if lf.varnames():
                cols.append(len(varnames))
                varnames.append(lf.varname)
            else:
                cols.append(-1)
        index_of = {id(lf): i for i, lf in enumerate(lvs)}
        terms = tuple(
            tuple(index_of[id(lf)] for lf in term) for term in sum_of_products(formula)
        )
        kinds = tuple(_KIND_OF[type(lf)] for lf in lvs)
        defaults = tuple(
            lf.hyperparam_default() if lf.hyperparam_name is not None else 0.0 for lf in lvs
        )
        leaf_vars = tuple(lf.varname for lf in lvs)
        extras = tuple(
            (float(lf.p),) if isinstance(lf, Periodic)
            else (float(lf.alpha),) if isinstance(lf, RQ)
            else ()
            for lf in lvs
        )
        return CompiledKernel(tuple(varnames), kinds, tuple(cols), terms, defaults,
                              leaf_vars, extras)

    @staticmethod
    def from_fields(varnames, kinds, cols, terms, defaults, leaf_vars,
                    extras=()) -> "CompiledKernel":
        """Rebuild from the plain tuples of a ``gaplac_tpu`` CompiledKernel."""
        return CompiledKernel(
            tuple(varnames), tuple(int(k) for k in kinds), tuple(int(c) for c in cols),
            tuple(tuple(int(i) for i in t) for t in terms),
            tuple(float(v) for v in defaults), tuple(leaf_vars),
            tuple(tuple(float(v) for v in e) for e in extras),
        )

    # -- parameters --------------------------------------------------------

    @property
    def n_leaves(self) -> int:
        return len(self.kinds)

    @cached_property
    def extra_slots(self) -> Tuple[Tuple[int, ...], ...]:
        """Per-leaf indices of its shape parameters in the extended vector."""
        slots = []
        off = self.n_leaves
        for e in (self.extras or ((),) * self.n_leaves):
            slots.append(tuple(range(off, off + len(e))))
            off += len(e)
        return tuple(slots)

    @property
    def n_params(self) -> int:
        """Extended parameter-vector length: leaf params + trailing extras."""
        return self.n_leaves + (sum(len(e) for e in self.extras) if self.extras else 0)

    def default_params(self, dtype=torch.float64, device=None) -> torch.Tensor:
        flat_extras = [v for e in (self.extras or ()) for v in e]
        return torch.tensor(tuple(self.defaults) + tuple(flat_extras), dtype=dtype,
                            device=device)

    def params_from_numpy(self, p, dtype=torch.float64, device=None) -> torch.Tensor:
        """A parameter vector written by ``gaplac_tpu`` (as numpy, either
        length), as an extended ``(..., n_params)`` tensor."""
        return self.full_params(torch.as_tensor(np.asarray(p), dtype=dtype, device=device))

    def full_params(self, params: torch.Tensor) -> torch.Tensor:
        """Extend ``(..., n_leaves)`` params with the static shape parameters;
        ``(..., n_params)`` params pass through."""
        if params.shape[-1] == self.n_params:
            return params
        if params.shape[-1] != self.n_leaves:
            raise ValueError(f"params of length {params.shape[-1]}: expected "
                             f"{self.n_leaves} or {self.n_params}")
        tail = self.default_params(params.dtype, params.device)[self.n_leaves:]
        return torch.cat([params, tail.expand(*params.shape[:-1], -1)], dim=-1)

    def extra_slots_for_vars(self, varnames: Sequence[str]) -> Tuple[int, ...]:
        """Extended-param indices of the shape parameters of every leaf on the
        named variables (--infer-extra)."""
        want = set(varnames)
        slots = tuple(
            s for v, es in zip(self.leaf_vars, self.extra_slots) if v in want for s in es
        )
        if not slots:
            raise ValueError(
                f"--infer-extra variables {sorted(want)} match no kernel shape "
                f"parameter (only Periodic's period and RQ's alpha are shape "
                f"parameters; formula vars: {self.varnames})"
            )
        return slots

    def param_slots_for_vars(self, inferable: Sequence[str]) -> Tuple[int, ...]:
        """Leaf-param indices whose hyperparameter is replaced when inferring
        the named variables (one shared scalar for all)."""
        inferable = set(inferable)
        slots = tuple(
            i for i, (v, kind) in enumerate(zip(self.leaf_vars, self.kinds))
            if v in inferable and kind != K_CAT
        )
        if not slots:
            raise ValueError(
                f"--infer variables {sorted(inferable)} match no inferable kernel "
                f"hyperparameter (formula vars: {self.varnames})"
            )
        return slots

    def set_params(self, params: torch.Tensor, slots: Tuple[int, ...], value) -> torch.Tensor:
        """Out-of-place hyperparameter override: params with ``slots`` <- value."""
        idx = torch.as_tensor(slots, device=params.device)
        src = torch.as_tensor(value, dtype=params.dtype, device=params.device)
        return params.index_copy(-1, idx, src.expand(*params.shape[:-1], len(slots)))

    # -- grams ---------------------------------------------------------------

    def gram(self, params: torch.Tensor, X1: torch.Tensor,
             X2: Optional[torch.Tensor] = None, diag: float = 0.0) -> torch.Tensor:
        """K[i, j] = k(X1[i], X2[j]) for params (P,) -> (n1, n2) or (C, P) ->
        (C, n1, n2).  With ``X2 is None`` the gram is symmetric: bare Noise
        hits the diagonal and ``diag`` is added there; in a cross gram bare
        Noise contributes 0.  Differentiable in params."""
        from gaplac_tpu_torch.ops.gram import GramBound

        p = self.full_params(params)
        K = GramBound.apply(p.reshape(-1, p.shape[-1]), self, X1, X2, float(diag))
        return K if params.dim() > 1 else K[0]

    def gram_cross_with_rowids(self, params: torch.Tensor, X1: torch.Tensor, X2: torch.Tensor,
                               row_ids1: torch.Tensor, row_ids2: torch.Tensor) -> torch.Tensor:
        """Cross gram whose bare Noise/Constant leaves key on the explicit
        global row ids ``row_ids1`` (n1,) and ``row_ids2`` (n2,); params (P,)
        -> (n1, n2) or (C, P) -> (C, n1, n2).  The plain version, always (K2
        takes ids as the offsets of contiguous ranges: ``ops.gram.gram``'s
        ``offsets``).  Differentiable through autograd."""
        from gaplac_tpu_torch.ops.gram import gram_ids_plain

        p = self.full_params(params)
        K = gram_ids_plain(self, p.reshape(-1, p.shape[-1]), X1, X2,
                           row_ids1.to(X1.dtype), row_ids2.to(X1.dtype))
        return K if params.dim() > 1 else K[0]

    def bind(self, X: torch.Tensor, dynamic_slots: Sequence[int] = (),
             diag: float = 0.0) -> "BoundGram":
        """Symmetric gram at fixed inputs ``X``: ``bind(X, slots,
        diag)(params)`` is ``gram(params, X) + diag I`` with every slot not in
        ``dynamic_slots`` held at its default value (``gaplac_tpu``'s
        ``bind`` semantics)."""
        return BoundGram(self, X, tuple(int(s) for s in dynamic_slots), float(diag))

    def gram_diag(self, params: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
        """diag(gram(params, X)) without forming the matrix; params (P,)."""
        d = torch.zeros(X.shape[0], dtype=X.dtype, device=X.device)
        for term in self.terms:
            block = None
            for li in term:
                x = (X[:, self.cols[li]] if self.cols[li] >= 0
                     else torch.arange(X.shape[0], dtype=X.dtype, device=X.device))
                b = _leaf_diag(self.kinds[li], x, params[li])
                block = b if block is None else block * b
            d = d + block
        return d


class BoundGram:
    """``CompiledKernel.bind``'s result: params (C, P) -> (C, n, n)."""

    def __init__(self, ck: CompiledKernel, X: torch.Tensor, dynamic_slots: Tuple[int, ...],
                 diag: float):
        self.ck, self.X, self.diag = ck, X, diag
        self.defaults = ck.default_params(X.dtype, X.device)
        mask = torch.zeros(ck.n_params, dtype=torch.bool)
        mask[list(dynamic_slots)] = True
        self.dynamic = mask.to(X.device)

    def __call__(self, params: torch.Tensor) -> torch.Tensor:
        from gaplac_tpu_torch.ops.gram import GramBound

        p = torch.where(self.dynamic, self.ck.full_params(params), self.defaults)
        K = GramBound.apply(p.reshape(-1, p.shape[-1]), self.ck, self.X, None, self.diag)
        return K if params.dim() > 1 else K[0]


def compile_formula(formula: GPComponent) -> CompiledKernel:
    return CompiledKernel.compile(formula)
