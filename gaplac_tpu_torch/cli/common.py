"""Shared CLI helpers: formula-driven data extraction from tables (port of
``gaplac_tpu/cli/common.py``)."""

from __future__ import annotations

import logging
from typing import Tuple

import numpy as np
import pandas as pd

from gaplac_tpu_torch.dsl.parser import Spec
from gaplac_tpu_torch.kernels.covariance import LENGTHSCALE_KINDS, CompiledKernel

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


def design_matrices(
    df_train: pd.DataFrame, df_test: pd.DataFrame, ck: CompiledKernel
) -> Tuple[np.ndarray, np.ndarray]:
    """Train and test input matrices with CONSISTENT categorical codes:
    non-numeric columns are factorized over the union of both tables so Cat
    kernel equality compares the same levels across tables."""
    n_train = len(df_train)
    cols_train, cols_test = [], []
    for v in ck.varnames:
        for df in (df_train, df_test):
            if v not in df.columns:
                raise ValueError(
                    f"Column {v!r} not found in data (available: {list(df.columns)})"
                )
        a, b = df_train[v], df_test[v]
        an = pd.to_numeric(a, errors="coerce")
        bn = pd.to_numeric(b, errors="coerce")
        if (an.isna() == a.isna()).all() and (bn.isna() == b.isna()).all():
            # both sides numeric-valued (possibly one as strings): compare
            # numerically; stringifying would give '1' vs '1.0'
            cols_train.append(an.to_numpy(dtype=float))
            cols_test.append(bn.to_numpy(dtype=float))
        else:
            codes, _ = pd.factorize(pd.concat([a.astype(str), b.astype(str)],
                                              ignore_index=True))
            codes = codes.astype(float)
            cols_train.append(codes[:n_train])
            cols_test.append(codes[n_train:])
    if not cols_train:
        return np.zeros((n_train, 0)), np.zeros((len(df_test), 0))
    return np.stack(cols_train, axis=1), np.stack(cols_test, axis=1)


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


def default_slot_groups(ck: CompiledKernel):
    """Hyperparameter slot groups assumed when a chain-consuming command
    (predict, sample --mcmc) runs without --infer: ONE shared scalar over
    every lengthscale-kind leaf, the reference mcmc's common case, so both
    commands rebuild the same model from the same chain."""
    shared = tuple(
        i for i, k in enumerate(ck.kinds)
        if ck.leaf_vars[i] and k in LENGTHSCALE_KINDS
    )
    if not shared:
        raise ValueError(
            "--mcmc needs --infer to know which hyperparameters the chain sampled"
        )
    return (shared,)


def chain_slot_groups(ck: CompiledKernel, args):
    """The slot groups an --mcmc chain's hyperparameter columns fill: from
    --infer/--infer-mode/--infer-extra as in the mcmc run, else the default."""
    from gaplac_tpu_torch.inference.model import slot_groups_for

    extras = list(args.infer_extra or [])
    if extras and args.approx == "rff":
        raise ValueError("--infer-extra chains cannot be used with --approx rff (feature "
                         "maps need static shape parameters)")
    if args.infer or extras:
        return slot_groups_for(ck, args.infer or [], shared=args.infer_mode == "shared",
                               infer_extras=extras)
    return default_slot_groups(ck)


def apply_outlier_policy(df: pd.DataFrame, args, response: str) -> pd.DataFrame:
    """Legacy --rmv-outliers handling."""
    method = getattr(args, "rmv_outliers", "none")
    if method in (None, "", "none"):
        return df
    from gaplac_tpu_torch.data.outliers import remove_outliers

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
