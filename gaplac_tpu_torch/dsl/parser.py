"""Formula parser — ``"resp [: lik] ~| kernelexpr"`` -> Spec.
(The port's own copy of ``gaplac_tpu/dsl/parser.py``.)

Reference parity: GaPLAC src/interface.jl:12-34 (gp_spec) splits on
``:`` / ``~|`` and then ``eval``'s the kernel expression and likelihood as
live Julia code.  We instead run a real tokenizer + recursive-descent parser
(required anyway: no ``eval`` under jit; SURVEY.md §2.3.7).

Grammar (SURVEY.md §2.2 + legacy envelope §2.11):

    formula    := response [":" [likelihood]] "~|" kernelexpr
    response   := identifier
    likelihood := Name ["(" args ")"]          # empty => Gaussian()
    kernelexpr := term ("+" term)*
    term       := factor ("*" factor)*
    factor     := KernelName "(" var_and_params ")" | "Noise" | "Constant"
                  | "(" kernelexpr ")"
    var        := ":" identifier | identifier   # Julia symbol or bare name
    params     := name "=" number, separated by ";" or ","

``":~|"`` (colon immediately before ``~``) also yields the Gaussian marker
(ref: interface.jl:25; README.md:39 "model the GP without a likelihood").
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List, Optional, Tuple

from gaplac_tpu_torch.dsl.ast import (
    Cat,
    Constant,
    GPComponent,
    GPOperation,
    Leaf,
    Linear,
    Matern32,
    Matern52,
    Noise,
    OU,
    Periodic,
    RQ,
    SqExp,
)


class FormulaError(ValueError):
    """Invalid formula specification (ref throws ArgumentError, interface.jl:15-16)."""


# ---------------------------------------------------------------------------
# Likelihoods (data model only; density code lives in inference/likelihoods.py)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LikelihoodSpec:
    """Parsed data likelihood.

    The reference's live registry has only a bare ``Gaussian`` marker
    (src/liklihoods.jl:1-3); the legacy envelope adds parameterized
    ``Gaussian(σ²)`` and ``Binomial(Reads)`` (test/oldtests.jl:11,25) and
    BASELINE.json adds Bernoulli / Poisson / Student-t.  ``args`` are
    positional numeric parameters; ``colref`` names a data column parameter
    (e.g. Binomial trial counts).
    """

    name: str  # canonical: gaussian|bernoulli|poisson|studentt|binomial
    args: Tuple[float, ...] = ()
    colref: Optional[str] = None


GAUSSIAN = LikelihoodSpec("gaussian")

_LIK_CANON = {
    "gaussian": "gaussian",
    "normal": "gaussian",
    "bernoulli": "bernoulli",
    "poisson": "poisson",
    "studentt": "studentt",
    "tdist": "studentt",
    "binomial": "binomial",
}


@dataclass(frozen=True)
class Spec:
    """Parsed formula (ref: struct Spec, interface.jl:1-5).

    ``transform`` carries legacy response arithmetic (``y*Reads/100``,
    test/oldtests.jl:25): a chain of (op, operand) applied to the response
    column, operand being a column name or a number.
    """

    response: str
    likelihood: LikelihoodSpec
    formula: GPComponent
    transform: Tuple[Tuple[str, object], ...] = ()

    def varnames(self) -> Tuple[str, ...]:
        return self.formula.varnames()


# ---------------------------------------------------------------------------
# Tokenizer
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""
    (?P<num>   [0-9]+\.[0-9]*([eE][+-]?[0-9]+)? | \.[0-9]+([eE][+-]?[0-9]+)?
             | [0-9]+([eE][+-]?[0-9]+)? )
  | (?P<name>  [A-Za-z_µα-ωΑ-Ω][A-Za-z_0-9µα-ωΑ-Ω]* )
  | (?P<sym>   [():;,=+*/\-] )
  | (?P<ws>    \s+ )
    """,
    re.VERBOSE,
)


@dataclass
class _Tok:
    kind: str  # "num" | "name" | "sym"
    text: str
    pos: int


def _tokenize(s: str) -> List[_Tok]:
    toks: List[_Tok] = []
    i = 0
    while i < len(s):
        m = _TOKEN_RE.match(s, i)
        if m is None:
            raise FormulaError(f"Unexpected character {s[i]!r} at position {i} in {s!r}")
        i = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        toks.append(_Tok(kind, m.group(), m.start()))
    return toks


class _Parser:
    def __init__(self, toks: List[_Tok], src: str):
        self.toks = toks
        self.src = src
        self.i = 0

    def peek(self) -> Optional[_Tok]:
        return self.toks[self.i] if self.i < len(self.toks) else None

    def next(self) -> _Tok:
        t = self.peek()
        if t is None:
            raise FormulaError(f"Unexpected end of input in {self.src!r}")
        self.i += 1
        return t

    def expect(self, text: str) -> _Tok:
        t = self.next()
        if t.text != text:
            raise FormulaError(
                f"Expected {text!r} but found {t.text!r} at position {t.pos} in {self.src!r}"
            )
        return t

    def at_end(self) -> bool:
        return self.i >= len(self.toks)

    # -- number with optional leading minus -------------------------------
    def number(self) -> float:
        t = self.next()
        if t.text == "-":
            t2 = self.next()
            if t2.kind != "num":
                raise FormulaError(f"Expected number after '-' at {t2.pos} in {self.src!r}")
            return -float(t2.text)
        if t.kind != "num":
            raise FormulaError(f"Expected number, found {t.text!r} at {t.pos} in {self.src!r}")
        return float(t.text)


# ---------------------------------------------------------------------------
# Kernel-expression parsing
# ---------------------------------------------------------------------------

_KERNEL_NAMES = {
    "sqexp", "ou", "linear", "cat", "noise", "constant", "const",
    # extended GP kernel set (the reference's eval-DSL could reach any
    # KernelFunctions kernel; we provide the standard ones natively)
    "matern32", "matern52", "periodic", "rq", "rationalquadratic",
}


def _parse_var(p: _Parser) -> str:
    """Accept ``:x`` (Julia symbol, ref DSL) or bare ``x`` (legacy DSL,
    e.g. ``Cat(PersonID)`` in test/pred.jl:3)."""
    t = p.next()
    if t.text == ":":
        t = p.next()
    if t.kind != "name":
        raise FormulaError(f"Expected variable name, found {t.text!r} at {t.pos}")
    return t.text


def _parse_leaf_args(p: _Parser) -> Tuple[Optional[str], dict, List[float]]:
    """Parse ``(`` [var] [sep kw=val ...] [sep num] ``)``; returns
    (varname|None, kwargs, positional numbers). Separators ``;`` and ``,``
    are interchangeable (the guide uses both: ``SqExp(:x; l=1)`` README.md:28
    and ``SqExp(:x, l=2)`` README.md:104)."""
    p.expect("(")
    varname: Optional[str] = None
    kwargs: dict = {}
    pos_args: List[float] = []
    first = True
    while True:
        t = p.peek()
        if t is None:
            raise FormulaError(f"Unclosed '(' in {p.src!r}")
        if t.text == ")":
            p.next()
            break
        if not first:
            if t.text not in (";", ","):
                raise FormulaError(f"Expected ';' or ',' at {t.pos} in {p.src!r}")
            p.next()
            t = p.peek()
        first = False
        if t is None or t.text == ")":
            continue
        # name=value | :var | bare var | number
        if t.kind == "name" and self_is_kw(p):
            key = p.next().text
            p.expect("=")
            kwargs[key] = p.number()
        elif t.text == ":" or t.kind == "name":
            if varname is not None:
                raise FormulaError(f"Multiple variable names in kernel args at {t.pos}")
            varname = _parse_var(p)
        else:
            pos_args.append(p.number())
    return varname, kwargs, pos_args


def self_is_kw(p: _Parser) -> bool:
    """True if the upcoming tokens are ``name =`` (keyword argument)."""
    t = p.peek()
    if t is None or t.kind != "name":
        return False
    nxt = p.toks[p.i + 1] if p.i + 1 < len(p.toks) else None
    return nxt is not None and nxt.text == "="


# per-kernel positional arity (excess positionals used to be silently dropped)
_MAX_POSITIONAL = {
    "sqexp": 1, "ou": 1, "matern32": 1, "matern52": 1, "linear": 1, "cat": 0,
    "periodic": 2, "rq": 2, "rationalquadratic": 2, "noise": 1,
    "constant": 1, "const": 1,
}
# keyword aliases that must not BOTH be supplied (the alias used to be
# silently popped and discarded)
_KW_ALIASES = {
    "periodic": (("p", "period"),),
    "rq": (("alpha", "a"),),
    "rationalquadratic": (("alpha", "a"),),
    "noise": (("s2", "s"),),
}


def _make_leaf(name: str, varname: Optional[str], kwargs: dict, pos: List[float]) -> Leaf:
    lname = name.lower()
    if kwargs and pos:
        # `Periodic(:t; l=2, 5)` — which slot does 5 bind? Binding positionals
        # by index once keywords consumed some slots silently drops values;
        # reject the mix outright.
        raise FormulaError(
            f"{name}: mixing keyword and positional parameters is ambiguous; "
            f"use keywords for all of them"
        )
    max_pos = _MAX_POSITIONAL.get(lname)
    if max_pos is not None and len(pos) > max_pos:
        raise FormulaError(
            f"{name} takes at most {max_pos} positional parameter(s), got {len(pos)}"
        )
    for a, b in _KW_ALIASES.get(lname, ()):
        if a in kwargs and b in kwargs:
            raise FormulaError(
                f"{name}: {a!r} and {b!r} are aliases — supply only one"
            )
    if lname == "sqexp":
        if varname is None:
            raise FormulaError("SqExp requires a variable, e.g. SqExp(:x)")
        l = kwargs.pop("l", pos[0] if pos else 1.0)
        _no_extra(name, kwargs)
        return SqExp(varname, l=float(l))
    if lname == "ou":
        if varname is None:
            raise FormulaError("OU requires a variable, e.g. OU(:t)")
        l = kwargs.pop("l", pos[0] if pos else 1.0)
        _no_extra(name, kwargs)
        return OU(varname, l=float(l))
    if lname == "linear":
        if varname is None:
            raise FormulaError("Linear requires a variable, e.g. Linear(:x)")
        c = kwargs.pop("c", pos[0] if pos else 0.0)
        _no_extra(name, kwargs)
        return Linear(varname, c=float(c))
    if lname == "cat":
        if varname is None:
            raise FormulaError("Cat requires a variable, e.g. Cat(:subject)")
        _no_extra(name, kwargs)
        return Cat(varname)
    if lname in ("matern32", "matern52"):
        if varname is None:
            raise FormulaError(f"{name} requires a variable, e.g. {name}(:x)")
        l = kwargs.pop("l", pos[0] if pos else 1.0)
        _no_extra(name, kwargs)
        cls = Matern32 if lname == "matern32" else Matern52
        return cls(varname, l=float(l))
    if lname == "periodic":
        if varname is None:
            raise FormulaError("Periodic requires a variable, e.g. Periodic(:t; l=1, p=1)")
        l = kwargs.pop("l", pos[0] if pos else 1.0)
        p_ = kwargs.pop("p", kwargs.pop("period", pos[1] if len(pos) > 1 else 1.0))
        _no_extra(name, kwargs)
        if float(p_) <= 0:
            # the period is static (never sampled) — a bad value can only be
            # fixed here, not by inference
            raise FormulaError(f"Periodic period must be > 0, got {p_}")
        return Periodic(varname, l=float(l), p=float(p_))
    if lname in ("rq", "rationalquadratic"):
        if varname is None:
            raise FormulaError("RQ requires a variable, e.g. RQ(:x; l=1, alpha=2)")
        l = kwargs.pop("l", pos[0] if pos else 1.0)
        alpha = kwargs.pop("alpha", kwargs.pop("a", pos[1] if len(pos) > 1 else 2.0))
        _no_extra(name, kwargs)
        if float(alpha) <= 0:
            raise FormulaError(f"RQ alpha must be > 0, got {alpha}")
        return RQ(varname, l=float(l), alpha=float(alpha))
    if lname == "noise":
        s2 = kwargs.pop("s2", kwargs.pop("s", pos[0] if pos else 1.0))
        _no_extra(name, kwargs)
        return Noise(varname or "", s2=float(s2))
    if lname in ("constant", "const"):
        c = kwargs.pop("c", pos[0] if pos else 1.0)
        _no_extra(name, kwargs)
        return Constant(varname or "", c=float(c))
    raise FormulaError(f"Unknown kernel {name!r}")


def _no_extra(name: str, kwargs: dict) -> None:
    if kwargs:
        raise FormulaError(f"Unknown parameter(s) {sorted(kwargs)} for kernel {name}")


def _parse_factor(p: _Parser) -> GPComponent:
    t = p.peek()
    if t is None:
        raise FormulaError(f"Unexpected end of kernel expression in {p.src!r}")
    if t.text == "(":
        p.next()
        node = _parse_kernelexpr(p)
        p.expect(")")
        return node
    if t.kind == "num" and t.text == "1":
        # legacy constant-kernel spelling `1` / `1(c)` (test/oldtests.jl:48
        # "1(1) * Cat(person) * ..."; SURVEY.md §2.11)
        p.next()
        nxt = p.peek()
        if nxt is not None and nxt.text == "(":
            p.next()
            c = p.number()
            p.expect(")")
        else:
            c = 1.0
        return Constant("", c=float(c))
    if t.kind != "name" or t.text.lower() not in _KERNEL_NAMES:
        raise FormulaError(
            f"Unknown kernel {t.text!r} at {t.pos} "
            f"(available: SqExp, OU, Linear, Cat, Noise, Constant, "
            f"Matern32, Matern52, Periodic, RQ)"
        )
    name = p.next().text
    nxt = p.peek()
    if nxt is not None and nxt.text == "(":
        varname, kwargs, pos = _parse_leaf_args(p)
    else:
        # bare `Noise` / `Constant` (legacy DSL, test/oldtests.jl:25)
        if name.lower() not in ("noise", "constant", "const"):
            raise FormulaError(f"Kernel {name} requires arguments, e.g. {name}(:x)")
        varname, kwargs, pos = None, {}, []
    return _make_leaf(name, varname, kwargs, pos)


def _parse_term(p: _Parser) -> GPComponent:
    node = _parse_factor(p)
    while (t := p.peek()) is not None and t.text == "*":
        p.next()
        node = GPOperation("multiply", node, _parse_factor(p))
    return node


def _parse_kernelexpr(p: _Parser) -> GPComponent:
    node = _parse_term(p)
    while (t := p.peek()) is not None and t.text == "+":
        p.next()
        node = GPOperation("add", node, _parse_term(p))
    return node


def parse_kernel_expr(s: str) -> GPComponent:
    """Parse a bare kernel expression like ``"SqExp(:t) * Cat(:g) + Linear(:x)"``."""
    p = _Parser(_tokenize(s), s)
    node = _parse_kernelexpr(p)
    if not p.at_end():
        t = p.peek()
        raise FormulaError(f"Trailing input {t.text!r} at {t.pos} in {s!r}")
    return node


# ---------------------------------------------------------------------------
# Likelihood parsing
# ---------------------------------------------------------------------------


def parse_likelihood(s: str) -> LikelihoodSpec:
    s = s.strip()
    if not s:
        return GAUSSIAN
    p = _Parser(_tokenize(s), s)
    t = p.next()
    if t.kind != "name":
        raise FormulaError(f"Invalid likelihood {s!r}")
    canon = _LIK_CANON.get(t.text.lower())
    if canon is None:
        raise FormulaError(
            f"Unknown likelihood {t.text!r} "
            f"(available: Gaussian, Bernoulli, Poisson, StudentT, Binomial)"
        )
    args: List[float] = []
    colref: Optional[str] = None
    nxt = p.peek()
    if nxt is not None and nxt.text == "(":
        p.next()
        first = True
        while True:
            t = p.peek()
            if t is None:
                raise FormulaError(f"Unclosed '(' in likelihood {s!r}")
            if t.text == ")":
                p.next()
                break
            if not first:
                if t.text not in (",", ";"):
                    raise FormulaError(f"Expected ',' in likelihood args at {t.pos}")
                p.next()
                t = p.peek()
            first = False
            if t is None or t.text == ")":
                continue
            if t.kind == "name":
                # column reference, e.g. Binomial(Reads) (test/oldtests.jl:25)
                colref = p.next().text
            else:
                args.append(p.number())
    if not p.at_end():
        raise FormulaError(f"Trailing input in likelihood {s!r}")
    return LikelihoodSpec(canon, tuple(args), colref)


# ---------------------------------------------------------------------------
# Full formula
# ---------------------------------------------------------------------------


def parse_formula(formula: str) -> Spec:
    """Parse ``"resp [: lik] ~| kernelexpr"`` (ref: gp_spec, interface.jl:12-34).

    The split rule mirrors the reference exactly: the likelihood slot is the
    text between the *first* ``:`` and the ``~`` — but only when that ``:``
    precedes the ``~`` (a ``:`` afterwards is a Julia symbol like ``:x``).
    """
    tilde = formula.find("~")
    if tilde < 0 or tilde + 1 >= len(formula) or formula[tilde + 1] != "|":
        raise FormulaError(
            f"Invalid formula specification {formula!r}: expected 'response [: lik] ~| kernel'"
        )
    colon = formula.find(":")
    if colon < 0 or colon > tilde:
        lik = GAUSSIAN
        resp = formula[:tilde].strip()
    else:
        lik = parse_likelihood(formula[colon + 1 : tilde])
        resp = formula[:colon].strip()
    name, transform = _parse_response(resp, formula)
    kern = parse_kernel_expr(formula[tilde + 2 :].strip())
    return Spec(name, lik, kern, transform)


def _parse_response(resp: str, formula: str):
    """Response slot: an identifier optionally followed by the legacy
    arithmetic chain ``*``/``/`` (column or number), e.g. ``y*Reads/100``
    (test/oldtests.jl:25)."""
    if re.fullmatch(r"[A-Za-z_][A-Za-z_0-9]*", resp or ""):
        return resp, ()
    p = _Parser(_tokenize(resp or ""), formula)
    t = p.peek()
    if t is None or t.kind != "name":
        raise FormulaError(f"Invalid response {resp!r} in formula {formula!r}")
    name = p.next().text
    transform = []
    while not p.at_end():
        op = p.next()
        if op.text not in ("*", "/"):
            raise FormulaError(
                f"Invalid response transform near {op.text!r} in {resp!r} "
                f"(only '*' and '/' are supported)"
            )
        t = p.next()
        if t.kind == "name":
            operand: object = t.text
        elif t.kind == "num":
            operand = float(t.text)
        else:
            raise FormulaError(f"Invalid transform operand {t.text!r} in {resp!r}")
        transform.append((op.text, operand))
    return name, tuple(transform)
