"""Kernel AST — the formula's object model (the port's own copy of
``gaplac_tpu/dsl/ast.py``; the port imports nothing of ``gaplac_tpu``).

Reference parity: GaPLAC src/gp_parts.jl:3-61 defines leaf types
(SqExp, Linear, OU, Cat) and a binary op tree (GPOperation{add|multiply}).
We additionally implement Noise and Constant, which the reference's guide and
legacy tests use (README.md:43, test/oldtests.jl:25,48) but whose
implementations are missing from the reference's src/ (SURVEY.md §2.3.1).

Design: plain frozen dataclasses; the tree is produced by the recursive
descent parser (dsl/parser.py) and lowered once, at trace time, by
kernels/covariance.py into a ``CompiledKernel``.
No ``eval`` anywhere (the reference eval's formulas as live Julia code,
src/interface.jl:25,31 — unsafe).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple, Union


class GPComponent:
    """Abstract base for kernel-AST nodes (ref: GPCompnent, gp_parts.jl:3)."""

    def __add__(self, other: "GPComponent") -> "GPOperation":
        return GPOperation("add", self, other)

    def __mul__(self, other: "GPComponent") -> "GPOperation":
        return GPOperation("multiply", self, other)

    def varnames(self) -> Tuple[str, ...]:
        raise NotImplementedError


@dataclass(frozen=True)
class GPOperation(GPComponent):
    """Binary node: ``+`` -> add (kernel sum), ``*`` -> multiply
    (tensor product across *different* columns; SURVEY.md §2.2).
    Ref: gp_parts.jl:5-9,55-61."""

    op: str  # "add" | "multiply"
    lhs: GPComponent
    rhs: GPComponent

    def varnames(self) -> Tuple[str, ...]:
        return self.lhs.varnames() + self.rhs.varnames()


@dataclass(frozen=True)
class Leaf(GPComponent):
    """Base for leaf kernels. ``varname`` is the data column this leaf reads.

    Left-to-right leaf order in the formula defines input-matrix column
    order (ref: varnames, gp_parts.jl:51-53; SelectTransform loop,
    abstractgp_translations.jl:45-69).
    """

    varname: str

    def varnames(self) -> Tuple[str, ...]:
        return (self.varname,)

    #: name of the leaf's natural (inferable) hyperparameter, or None
    hyperparam_name: Optional[str] = field(default=None, init=False)

    def hyperparam_default(self) -> float:
        raise NotImplementedError(f"{type(self).__name__} has no hyperparameter")


@dataclass(frozen=True)
class SqExp(Leaf):
    """Squared-exponential kernel, k(x,x') = exp(-(x-x')^2 / (2 l^2)).

    Matches KernelFunctions SqExponentialKernel + with_lengthscale
    (ref: gp_parts.jl:21-27, abstractgp_translations.jl:8).
    """

    l: float = 1.0

    def __post_init__(self):
        object.__setattr__(self, "hyperparam_name", "l")

    def hyperparam_default(self) -> float:
        return float(self.l)


@dataclass(frozen=True)
class OU(Leaf):
    """Ornstein-Uhlenbeck / exponential kernel, k = exp(-|x-x'| / l).

    Ref: gp_parts.jl:37-43, ExponentialKernel (abstractgp_translations.jl:10).
    """

    l: float = 1.0

    def __post_init__(self):
        object.__setattr__(self, "hyperparam_name", "l")

    def hyperparam_default(self) -> float:
        return float(self.l)


@dataclass(frozen=True)
class Linear(Leaf):
    """Linear (dot-product) kernel, k(x,x') = x*x' + c.

    Ref: gp_parts.jl:29-35, LinearKernel(c) (abstractgp_translations.jl:11).
    """

    c: float = 0.0

    def __post_init__(self):
        object.__setattr__(self, "hyperparam_name", "c")

    def hyperparam_default(self) -> float:
        return float(self.c)


@dataclass(frozen=True)
class Cat(Leaf):
    """Categorical / indicator kernel: 1 if values equal else 0.

    Group / subject random-effect kernel.
    Ref: CategoricalKernel, gp_parts.jl:11-13,45-47.
    """

    def __post_init__(self):
        object.__setattr__(self, "hyperparam_name", None)


@dataclass(frozen=True)
class Noise(Leaf):
    """White-noise kernel, k(x,x') = s2 * 1[x == x'].

    Referenced by the guide (README.md:43) and legacy tests
    (test/oldtests.jl:25) but absent from the reference's src/ —
    implemented here per SURVEY.md §2.3.1. ``varname`` may be "" when the
    formula writes bare ``Noise`` (row-identity noise, applied on the row
    index rather than a data column).
    """

    s2: float = 1.0

    def __post_init__(self):
        object.__setattr__(self, "hyperparam_name", "s2")

    def hyperparam_default(self) -> float:
        return float(self.s2)

    def varnames(self) -> Tuple[str, ...]:
        return (self.varname,) if self.varname else ()


@dataclass(frozen=True)
class Constant(Leaf):
    """Constant kernel, k(x,x') = c (a.k.a. ``1(c)`` in the legacy DSL).

    Referenced by README.md:43 / img/cov_constant.png; absent from the
    reference's src/ — implemented per SURVEY.md §2.3.1.
    """

    c: float = 1.0

    def __post_init__(self):
        object.__setattr__(self, "hyperparam_name", "c")

    def hyperparam_default(self) -> float:
        return float(self.c)

    def varnames(self) -> Tuple[str, ...]:
        return (self.varname,) if self.varname else ()


@dataclass(frozen=True)
class Matern32(Leaf):
    """Matern-3/2 kernel, k = (1 + sqrt(3) d/l) exp(-sqrt(3) d/l).

    Capability extension: the reference's eval-based DSL could reach any
    KernelFunctions kernel (Matern32Kernel among them); a complete
    replacement offers the standard GP kernel set natively."""

    l: float = 1.0

    def __post_init__(self):
        object.__setattr__(self, "hyperparam_name", "l")

    def hyperparam_default(self) -> float:
        return float(self.l)


@dataclass(frozen=True)
class Matern52(Leaf):
    """Matern-5/2 kernel, k = (1 + sqrt(5) d/l + 5 d^2/(3 l^2)) exp(-sqrt(5) d/l)."""

    l: float = 1.0

    def __post_init__(self):
        object.__setattr__(self, "hyperparam_name", "l")

    def hyperparam_default(self) -> float:
        return float(self.l)


@dataclass(frozen=True)
class Periodic(Leaf):
    """Exp-sine-squared periodic kernel, k = exp(-2 sin^2(pi d / p) / l^2).

    ``l`` is the inferable hyperparameter; the period ``p`` is a static
    shape parameter baked into the compiled kernel."""

    l: float = 1.0
    p: float = 1.0

    def __post_init__(self):
        object.__setattr__(self, "hyperparam_name", "l")

    def hyperparam_default(self) -> float:
        return float(self.l)


@dataclass(frozen=True)
class RQ(Leaf):
    """Rational-quadratic kernel, k = (1 + d^2 / (2 alpha l^2))^(-alpha).

    ``l`` is the inferable hyperparameter; ``alpha`` (scale-mixture shape)
    is static."""

    l: float = 1.0
    alpha: float = 2.0

    def __post_init__(self):
        object.__setattr__(self, "hyperparam_name", "l")

    def hyperparam_default(self) -> float:
        return float(self.l)


ASTNode = Union[GPOperation, Leaf]


def leaves(node: GPComponent) -> Tuple[Leaf, ...]:
    """All leaves of the tree, left-to-right (the column-order contract;
    ref: varnames, gp_parts.jl:53)."""
    if isinstance(node, GPOperation):
        return leaves(node.lhs) + leaves(node.rhs)
    assert isinstance(node, Leaf)
    return (node,)


def sum_of_products(node: GPComponent) -> Tuple[Tuple[Leaf, ...], ...]:
    """Flatten the AST into sum-of-products form: a tuple of terms, each term
    a tuple of leaves to be multiplied (each applied to its own column —
    ANOVA-style tensor product, SURVEY.md §2.2).

    ``*`` does NOT distribute over ``+`` here: the reference's kernel
    algebra builds KernelSum/KernelTensorProduct trees where a product of
    sums is a single product node whose factors are composite; the live
    DSL never produces that shape (products only combine leaves, e.g.
    ``Cat(:a) * Cat(:b) + Linear(:x)``).  We support leaf-only products and
    raise on products of sums, matching the reference compiler which only
    walks the *top* level of the kernel tree
    (abstractgp_translations.jl:51-67).
    """
    if isinstance(node, Leaf):
        return ((node,),)
    assert isinstance(node, GPOperation)
    if node.op == "add":
        return sum_of_products(node.lhs) + sum_of_products(node.rhs)
    if node.op == "multiply":
        lhs_terms = sum_of_products(node.lhs)
        rhs_terms = sum_of_products(node.rhs)
        if len(lhs_terms) != 1 or len(rhs_terms) != 1:
            raise ValueError(
                "Products of kernel sums are not supported (write the formula "
                "in sum-of-products form, e.g. 'A*B + A*C' instead of 'A*(B+C)')"
            )
        return (lhs_terms[0] + rhs_terms[0],)
    raise ValueError(f"Unknown kernel operation {node.op!r}")
