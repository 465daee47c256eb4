"""Cartesian test grid.
(The port's own copy of ``gaplac_tpu/data/grid.py``.)

Reference parity: GaPLAC src/utils.jl:1-14 — ``_make_test_grid``
builds the (prod(lengths), nvars) matrix of all combinations of the per-var
ranges.  Julia's ``Iterators.product`` varies the FIRST argument fastest; we
reproduce that ordering so outputs match row-for-row.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import pandas as pd


def make_test_grid(*ranges: Sequence[float]) -> np.ndarray:
    """All combinations of the given 1-D ranges, first range varying fastest
    (ref: utils.jl:1-6). Shape (prod(len(r)), len(ranges))."""
    arrays = [np.asarray(r, dtype=float) for r in ranges]
    if not arrays:
        return np.zeros((1, 0))
    # meshgrid with indexing="ij" then first axis fastest == Fortran order
    mesh = np.meshgrid(*arrays, indexing="ij")
    cols = [m.reshape(-1, order="F") for m in mesh]
    return np.stack(cols, axis=1)


def make_test_df(ranges: Dict[str, Sequence[float]], varnames: Sequence[str]) -> pd.DataFrame:
    """DataFrame over the Cartesian grid, columns in formula-variable order
    (ref: _make_test_df, utils.jl:8-10)."""
    grid = make_test_grid(*[ranges[v] for v in varnames])
    return pd.DataFrame(grid, columns=list(varnames))
