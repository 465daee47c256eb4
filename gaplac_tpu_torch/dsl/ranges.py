"""``--at`` range parser — ``"x=-5:0.1:5; g=[1,2]; n = rand(Uniform(-5,5), 50)"``.
(The port's own copy of ``gaplac_tpu/dsl/ranges.py``.)

Reference parity: GaPLAC src/interface.jl:44-66 ``Meta.parse`` +
eval's the assignments as Julia code.  We support the documented subset with
a real parser (SURVEY.md §2.12 "dsl" row):

    assignments := assignment ((";" | newline) assignment)*
    assignment  := var ["/" group] "=" value     # var/group: per-group values
    value       := range | scalar | list | randcall | rangecall
    range       := num ":" num [":" num]        # Julia a:b / a:step:b, INCLUSIVE
    list        := "[" num ("," num)* "]"
    randcall    := "rand" "(" dist "," int ")"
    dist        := ("Uniform"|"Normal") "(" num "," num ")"
    rangecall   := "range" "(" num "," num "," "length" "=" int ")"

``var/group=value`` (legacy: bin/old_options.jl:87, test/oldtests.jl:48) nests
the variable inside each level of ``group``: the value expression is
re-evaluated per distinct group level (fresh ``rand`` draws per level), and
the frame is expanded accordingly (see ``build_at_frame``).

Unspecified formula variables get per-kernel default ranges
(ref: _default_range, abstractgp_translations.jl:3-6): SqExp/OU -> 1:10,
Linear -> -3:0.1:3, Cat -> [1,2,3].
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Sequence

import numpy as np

from gaplac_tpu_torch.dsl.ast import (
    Cat, Constant, GPComponent, Leaf, Linear, Matern32, Matern52, Noise, OU,
    Periodic, RQ, SqExp, leaves,
)


class RangeError(ValueError):
    pass


_NUM = r"[+-]?(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?"


def _julia_range(start: float, step: float, stop: float) -> np.ndarray:
    """Julia's ``a:s:b`` — inclusive of ``b`` when it lands on the grid
    (within fp tolerance), e.g. -5:0.1:5 has 101 points."""
    if step == 0:
        raise RangeError("Range step must be nonzero")
    n = int(np.floor((stop - start) / step + 1e-9)) + 1
    if n <= 0:
        return np.array([], dtype=float)
    return start + step * np.arange(n, dtype=float)


def _parse_value(text: str, rng: np.random.Generator) -> np.ndarray:
    text = text.strip()
    # rand(Dist(a, b), n)
    m = re.fullmatch(
        rf"rand\s*\(\s*(Uniform|Normal)\s*\(\s*({_NUM})\s*,\s*({_NUM})\s*\)\s*,\s*(\d+)\s*\)",
        text,
    )
    if m:
        dist, a, b, n = m.group(1), float(m.group(2)), float(m.group(3)), int(m.group(4))
        if dist == "Uniform":
            return rng.uniform(a, b, size=n)
        return rng.normal(a, b, size=n)
    # range(a, b, length=n)  (Julia range call, test/oldtests.jl:48)
    m = re.fullmatch(
        rf"range\s*\(\s*({_NUM})\s*,\s*({_NUM})\s*,\s*length\s*=\s*(\d+)\s*\)", text
    )
    if m:
        return np.linspace(float(m.group(1)), float(m.group(2)), int(m.group(3)))
    # [a, b, c]
    m = re.fullmatch(r"\[(.*)\]", text)
    if m:
        items = [s for s in m.group(1).split(",") if s.strip()]
        try:
            return np.array([float(s) for s in items], dtype=float)
        except ValueError as e:
            raise RangeError(f"Invalid list {text!r}") from e
    # a:s:b
    m = re.fullmatch(rf"({_NUM})\s*:\s*({_NUM})\s*:\s*({_NUM})", text)
    if m:
        return _julia_range(float(m.group(1)), float(m.group(2)), float(m.group(3)))
    # a:b (step 1)
    m = re.fullmatch(rf"({_NUM})\s*:\s*({_NUM})", text)
    if m:
        return _julia_range(float(m.group(1)), 1.0, float(m.group(2)))
    # scalar
    m = re.fullmatch(_NUM, text)
    if m:
        return np.array([float(text)], dtype=float)
    raise RangeError(
        f"Cannot parse range value {text!r} "
        f"(supported: a:b, a:step:b, scalar, [v1,v2,...], rand(Uniform(a,b), n), "
        f"rand(Normal(mu,sd), n))"
    )


def default_range(leaf: Leaf) -> np.ndarray:
    """Per-kernel default evaluation range (ref: abstractgp_translations.jl:3-6)."""
    if isinstance(leaf, (SqExp, OU, Matern32, Matern52, Periodic, RQ)):
        return np.arange(1.0, 11.0)
    if isinstance(leaf, Linear):
        return _julia_range(-3.0, 0.1, 3.0)
    if isinstance(leaf, Cat):
        return np.array([1.0, 2.0, 3.0])
    if isinstance(leaf, (Noise, Constant)):
        return np.arange(1.0, 11.0)
    raise RangeError(f"No default range for {type(leaf).__name__}")


def _split_assignments(at: str):
    """``--at`` assignments as (var, group|None, value_text) triples."""
    entries = []
    for seg in re.split(r"[;\n]", at):
        seg = seg.strip()
        if not seg:
            continue
        m = re.match(
            r"([A-Za-z_][A-Za-z_0-9]*)\s*(?:/\s*([A-Za-z_][A-Za-z_0-9]*))?\s*=\s*(.*)",
            seg,
            re.DOTALL,
        )
        if m is None:
            raise RangeError(f"Only assignments allowed in `--at` argument (got {seg!r})")
        entries.append((m.group(1), m.group(2), m.group(3)))
    return entries


def parse_at_ranges(
    at: str,
    formula: Optional[GPComponent] = None,
    seed: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """Parse the ``--at`` argument into {var: values}; unspecified formula
    variables are filled from per-kernel defaults (ref: getatrange,
    interface.jl:44-66). Assignments separate on ';' or newlines (legacy DSL
    used ';', bin/old_options.jl:87).  Grouped ``var/group=`` assignments need
    a frame, not a dict — use :func:`build_at_frame`."""
    atdict: Dict[str, np.ndarray] = {}
    rng = np.random.default_rng(seed)
    for var, group, text in _split_assignments(at):
        if group is not None:
            raise RangeError(
                f"Grouped assignment {var}/{group} requires build_at_frame "
                "(supported by the sample/predict commands)"
            )
        atdict[var] = _parse_value(text, rng)
    if formula is not None:
        for leaf in leaves(formula):
            for var in leaf.varnames():
                if var not in atdict:
                    atdict[var] = default_range(leaf)
    return atdict


def build_at_frame(
    at: str,
    formula: Optional[GPComponent] = None,
    seed: Optional[int] = None,
):
    """Evaluate ``--at`` to a pandas DataFrame of evaluation points.

    Ungrouped assignments form a Cartesian grid (first variable varying
    fastest — ref: _make_test_grid, utils.jl:1-6).  A grouped assignment
    ``var/group=value`` (legacy --at syntax, bin/old_options.jl:87; driven in
    test/oldtests.jl:48 as ``time/person=range(-5,5,length=6)``) expands each
    existing row by the value list, re-evaluating the value expression per
    distinct level of ``group`` — so ``rand`` draws differ between groups.
    Unspecified formula variables get per-kernel default ranges.
    """
    import pandas as pd

    rng = np.random.default_rng(seed)
    entries = _split_assignments(at)
    specified = {var for var, _, _ in entries}
    if formula is not None:
        for leaf in leaves(formula):
            for var in leaf.varnames():
                if var not in specified:
                    entries.append((var, None, None))
                    specified.add(var)

    values_of = {var: (group, text) for var, group, text in entries}
    grouped = [(var, g, t) for var, g, t in entries if g is not None]

    # Cartesian base-grid axis order follows the FORMULA's variable order
    # (first variable fastest — the reference builds the grid from
    # varnames(formula), sample.jl:23 + utils.jl:1-6, so output rows match
    # row-for-row); --at-only variables append in assignment order.
    ordered = []
    if formula is not None:
        for leaf in leaves(formula):
            for var in leaf.varnames():
                if var in values_of and var not in ordered:
                    ordered.append(var)
    for var, group, _ in entries:
        if var not in ordered:
            ordered.append(var)

    base_vars, base_vals = [], []
    for var in ordered:
        group, text = values_of[var]
        if group is not None:
            continue  # grouped vars expand after the base grid
        vals = _parse_value(text, rng) if text is not None else _default_for(formula, var)
        base_vars.append(var)
        base_vals.append(vals)
    from gaplac_tpu_torch.data.grid import make_test_grid

    grid = make_test_grid(*base_vals)
    df = pd.DataFrame(grid, columns=base_vars)

    for var, group, text in grouped:
        if group not in df.columns:
            raise RangeError(
                f"Grouping variable {group!r} for {var!r} is not defined before it"
            )
        # one value list per distinct group level (fresh rand draws per
        # level); expand each row in place, var varying fastest
        levels = list(dict.fromkeys(df[group].tolist()))  # first-appearance order
        per_level = {g: np.asarray(_parse_value(text, rng), dtype=float)
                     for g in levels}
        counts = df[group].map({g: len(v) for g, v in per_level.items()}).to_numpy()
        out = df.loc[df.index.repeat(counts)].reset_index(drop=True)
        out[var] = np.concatenate([per_level[g] for g in df[group]]) if len(df) else []
        df = out
    return df


def _default_for(formula: Optional[GPComponent], var: str) -> np.ndarray:
    if formula is not None:
        for leaf in leaves(formula):
            if var in leaf.varnames():
                return default_range(leaf)
    raise RangeError(f"No value given and no default range for variable {var!r}")
