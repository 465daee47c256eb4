"""Shared CLI helpers: formula-driven data extraction from tables (port of
``gaplac_tpu/cli/common.py``, which imports JAX through its kernel module)."""

from __future__ import annotations

import logging

import numpy as np
import pandas as pd

from gaplac_tpu.dsl.parser import Spec
from gaplac_tpu_torch.kernels.covariance import CompiledKernel

log = logging.getLogger("gaplac")


def column_values(df: pd.DataFrame, name: str) -> np.ndarray:
    """A data column as float; non-numeric (categorical) columns are
    factorized to integer codes (the Cat/Noise kernels only test equality)."""
    if name not in df.columns:
        raise ValueError(
            f"Column {name!r} not found in data (available: {list(df.columns)})"
        )
    col = df[name]
    if pd.api.types.is_numeric_dtype(col):
        return col.to_numpy(dtype=float)
    coerced = pd.to_numeric(col, errors="coerce")
    if (coerced.isna() == col.isna()).all():
        # numeric-valued object column (e.g. a stringly-typed CSV): keep the numbers
        return coerced.to_numpy(dtype=float)
    codes, _ = pd.factorize(col)
    log.debug("Factorized non-numeric column %s to %d levels", name, codes.max() + 1)
    return codes.astype(float)


def design_matrix(df: pd.DataFrame, ck: CompiledKernel) -> np.ndarray:
    """(n, n_cols) input matrix in formula left-to-right column order."""
    cols = [column_values(df, v) for v in ck.varnames]
    if not cols:
        return np.zeros((len(df), 0))
    return np.stack(cols, axis=1)


def resolve_hyper_columns(df: pd.DataFrame, n_hyper: int, path: str) -> list:
    """Chain-schema hyperparameter column names (ℓ, ℓ_2, ... with ASCII
    fallbacks)."""
    names = []
    for g in range(n_hyper):
        cands = (["ℓ", "l"] if g == 0 else []) + [f"ℓ_{g+1}", f"l_{g+1}"]
        found = next((c for c in cands if c in df.columns), None)
        if found is None:
            raise ValueError(
                f"Chain file {path!r} lacks hyperparameter column for group {g} "
                f"(expected one of {cands}; found {list(df.columns)[:8]}...)"
            )
        names.append(found)
    return names


def apply_outlier_policy(df: pd.DataFrame, args, response: str) -> pd.DataFrame:
    """Legacy --rmv-outliers handling."""
    method = getattr(args, "rmv_outliers", "none")
    if method in (None, "", "none"):
        return df
    from gaplac_tpu.data.outliers import remove_outliers

    extra = [f for f in getattr(args, "outlier_fields", "").split(";") if f]
    ignore = [f for f in getattr(args, "outlier_ignore", "").split(";") if f]
    return remove_outliers(df, method, response, extra, ignore)


def response_vector(df: pd.DataFrame, spec: Spec) -> np.ndarray:
    if spec.response not in df.columns:
        raise ValueError(
            f"Response column {spec.response!r} not found in data "
            f"(available: {list(df.columns)})"
        )
    y = df[spec.response].to_numpy(dtype=float)
    # legacy response arithmetic, e.g. y*Reads/100
    for op, operand in spec.transform:
        val = column_values(df, operand) if isinstance(operand, str) else float(operand)
        y = y * val if op == "*" else y / val
    if np.isnan(y).any():
        raise ValueError(f"Response column {spec.response!r} contains missing values")
    return y
