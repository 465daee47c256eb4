"""Outlier removal — legacy CLI capability (``--rmv_outliers none|fence``,
GaPLAC bin/old_options.jl:32-41; SURVEY.md §2.11).
(The port's own copy of ``gaplac_tpu/data/outliers.py``.)

``fence`` removes rows outside the Tukey fences (Q1 - k*IQR, Q3 + k*IQR) of
the response column plus any ``extra_fields``, minus ``ignore_fields``.
"""

from __future__ import annotations

import logging
from typing import Iterable, Sequence

import numpy as np
import pandas as pd

log = logging.getLogger("gaplac")


def tukey_fence_mask(v: np.ndarray, k: float = 3.0) -> np.ndarray:
    q1, q3 = np.nanpercentile(v, [25, 75])
    iqr = q3 - q1
    lo, hi = q1 - k * iqr, q3 + k * iqr
    return (v >= lo) & (v <= hi)


def remove_outliers(
    df: pd.DataFrame,
    method: str,
    response: str,
    extra_fields: Sequence[str] = (),
    ignore_fields: Sequence[str] = (),
    k: float = 3.0,
) -> pd.DataFrame:
    """Apply the legacy outlier policy; returns the filtered frame."""
    if method in (None, "", "none"):
        return df
    if method != "fence":
        raise ValueError(f"Unknown outlier removal method {method!r} (none|fence)")
    fields = [response, *extra_fields]
    fields = [f for f in dict.fromkeys(fields) if f not in set(ignore_fields)]
    mask = np.ones(len(df), dtype=bool)
    for f in fields:
        if f not in df.columns:
            raise ValueError(f"Outlier field {f!r} not in data columns {list(df.columns)}")
        col = pd.to_numeric(df[f], errors="coerce").to_numpy(dtype=float)
        was_missing = pd.isna(df[f]).to_numpy()
        if np.isnan(col).all():
            raise ValueError(
                f"Outlier field {f!r} is not numeric; use --outlier-ignore "
                f"or pick numeric fields"
            )
        # missing cells are not outliers — leave them for complete-cases
        mask &= tukey_fence_mask(col, k) | np.isnan(col) | was_missing
    removed = int((~mask).sum())
    if removed:
        log.info("outlier removal (fence): dropped %d of %d rows", removed, len(df))
    return df.loc[mask].reset_index(drop=True)
