"""Table IO — TSV/CSV read and the extension-dispatched output rule.
(The port's own copy of ``gaplac_tpu/data/io.py``.)

Reference parity: GaPLAC src/utils.jl:30-40 (``_df_output``: '.csv'
-> comma, '.tsv' -> tab, anything else errors; no ``--output`` -> print the
frame) and CSV.read with delimiter sniffing (CLI/src/mcmc.jl:17,
select.jl:16,38 read both true TSVs and the legacy comma-in-.tsv fixtures,
test/testin/mcmc_109.tsv:1).

All-numeric tables (mcmc chain files: n_obs+8 float columns a row) are
read and written in one pass by the native reader and writer
(``native/fastio.cpp`` through ``data/fastio.py``), as ``gaplac_tpu``
does: float64 with exact parsing, written as ``%.1f`` for integral values
and ``%.17g`` otherwise, so the port writes the same bytes.  A table with a
field that is not a number goes to pandas.  ``_write_numeric`` is the
writer's plain version, which the tests hold it against.
"""

from __future__ import annotations

import io
import logging
import os
import re
import sys
from typing import Optional

import numpy as np
import pandas as pd

from gaplac_tpu_torch.data import fastio

log = logging.getLogger("gaplac")


def _sniff_header(header: str) -> str:
    return "\t" if header.count("\t") >= header.count(",") and "\t" in header else ","


def _sniff_sep(path: str) -> str:
    with open(path, "r") as fh:
        header = fh.readline()
    return _sniff_header(header)


def read_table(path: str) -> pd.DataFrame:
    """Read a delimited table, sniffing ',' vs '\\t' from the header line
    (Julia's CSV.read auto-detects; the legacy chain fixtures are
    comma-delimited despite their .tsv names — SURVEY.md §2.3.2)."""
    path = os.path.expanduser(path)
    sep = _sniff_sep(path)
    native = fastio.read_numeric(path, sep)
    if native is not None:
        names, arr = native
        return pd.DataFrame(arr, columns=names, copy=False)
    df = pd.read_csv(path, sep=sep, float_precision="round_trip")
    if all(_is_number(df[c]) for c in df.columns):
        df = df.astype(np.float64)  # an all-numeric table is float, as gaplac_tpu reads it
    return df


def _is_number(col: pd.Series) -> bool:
    return pd.api.types.is_numeric_dtype(col) and not pd.api.types.is_bool_dtype(col)


def _write_numeric(path: str, sep: str, df: pd.DataFrame) -> None:
    """The native writer's plain version: an all-numeric table as
    ``gaplac_tpu``'s native writer formats it:
    integral values below 1e15 as ``%.1f``, the rest as ``%.17g`` (a NaN
    with its sign bit set as ``-nan``, as C's printf gives it)."""
    flat = df.to_numpy(dtype=np.float64).ravel()
    integral = ((np.abs(flat) < 1e15) & (flat == np.trunc(flat))).tolist()
    fields = [("%.1f" if i else "%.17g") % v for v, i in zip(flat.tolist(), integral)]
    for k in np.flatnonzero(np.isnan(flat) & np.signbit(flat)):
        fields[k] = "-nan"
    cols = df.shape[1]
    with open(path, "w", encoding="utf-8", newline="") as fh:
        fh.write(sep.join(str(c) for c in df.columns) + "\n")
        fh.writelines(sep.join(fields[r:r + cols]) + "\n" for r in range(0, len(fields), cols))


def _transpose_table(df: pd.DataFrame) -> pd.DataFrame:
    """'#' flag: transpose a wide table.  The first column becomes the header
    (its values name the new columns); the original header row becomes a new
    first column, named after the original first-column header.  Numeric
    columns are re-coerced after the transpose — the same inference pandas
    applies when reading an untransposed table, so join keys keep IDENTICAL
    typing on both sides of a merge."""
    first = str(df.columns[0])
    out = df.set_index(df.columns[0]).T.reset_index(names=first)
    out.columns = [str(c) for c in out.columns]
    for c in out.columns:
        coerced = pd.to_numeric(out[c], errors="coerce")
        # accept the coercion when every non-missing value parsed (a column
        # with a missing cell must still become numeric — pandas would)
        if (coerced.isna() == out[c].isna()).all():
            out[c] = coerced
    return out


def _load_one_source(part: str) -> tuple:
    """One ``--data`` entry: ``[flags][joinkey]:path`` or plain ``path``.

    Flags (legacy mini-DSL, bin/old_options.jl:32): ``#`` transposes the
    table, ``,`` forces CSV, ``~`` forces TSV (otherwise the delimiter is
    sniffed); remaining prefix characters name the join column (after
    transposition, a row key becomes a column key).  ``stdin`` reads the
    table from standard input.  Returns (join_key or None, DataFrame).
    """
    part = part.strip()
    prefix, sep_flag, transpose = "", None, False
    if ":" in part:
        prefix, rest = part.split(":", 1)
        # a ':' may also appear inside a plain path; only treat the prefix as
        # flags when it looks like one (flag chars + identifier, no / or .)
        if re.fullmatch(r"[#,~]*[A-Za-z_][A-Za-z_0-9]*|[#,~]+|", prefix):
            part = rest
        else:
            prefix = ""
    key = ""
    for ch in prefix:
        if ch == "#":
            transpose = True
        elif ch == ",":
            sep_flag = ","
        elif ch == "~":
            sep_flag = "\t"
        else:
            key += ch
    if part == "stdin":
        text = sys.stdin.read()
        header = text.splitlines()[0] if text else ""
        sep = sep_flag or _sniff_header(header)
        df = pd.read_csv(io.StringIO(text), sep=sep)
    elif sep_flag is not None:
        df = pd.read_csv(os.path.expanduser(part), sep=sep_flag)
    else:
        df = read_table(part)  # sniffed delimiter
    if transpose:
        df = _transpose_table(df)
    return (key or None, df)


def load_tables(arg: str) -> pd.DataFrame:
    """Legacy ``--data`` mini-DSL (bin/old_options.jl:32): ``;``-separated
    sources joined left-to-right.  ``id:data.tsv;#subjectid:subjects.tsv``
    reads data.tsv, transposes subjects.tsv, and inner-joins data.tsv's
    ``id`` column against subjects.tsv's ``subjectid`` row.  Sources without
    join keys merge on their common columns.  A single plain path goes
    through the fast :func:`read_table` reader."""
    parts = [s for s in arg.split(";") if s.strip()]
    if not parts:
        raise ValueError("--data argument is empty")
    if len(parts) == 1 and ":" not in parts[0] and parts[0].strip() != "stdin":
        return read_table(parts[0].strip())
    result, base_key = None, None
    for part in parts:
        key, df = _load_one_source(part)
        if result is None:
            result, base_key = df, key
            continue
        if base_key or key:
            # a one-sided key joins against the same-named column on the
            # other side; validate presence for a clean error (not KeyError)
            lk, rk = base_key or key, key or base_key
            if lk not in result.columns or rk not in df.columns:
                missing = lk if lk not in result.columns else rk
                raise ValueError(
                    f"Cannot join {part!r}: join column {missing!r} not found "
                    f"(left columns: {list(result.columns)[:8]}..., "
                    f"right columns: {list(df.columns)[:8]}...)"
                )
            left, right = _align_key_dtypes(result, lk, df, rk)
            merged = left.merge(right, left_on=lk, right_on=rk, how="inner")
        else:
            common = [c for c in result.columns if c in df.columns]
            if not common:
                raise ValueError(
                    f"Cannot join {part!r}: no join key given and no common columns"
                )
            merged = result.merge(df, on=common, how="inner")
        log.info("Joined %s: %d rows (was %d + %d)", part, len(merged),
                 len(result), len(df))
        result = merged
    return result


def _align_key_dtypes(left: pd.DataFrame, lk: str, right: pd.DataFrame, rk: str):
    """Merge keys must agree in dtype (pandas raises on object-vs-float).
    Numeric-vs-numeric mismatches (int64 vs float64) compare as float;
    anything else compares as strings."""
    a, b = left[lk], right[rk]
    if a.dtype == b.dtype:
        return left, right
    if pd.api.types.is_numeric_dtype(a) and pd.api.types.is_numeric_dtype(b):
        cast = lambda s: s.astype("float64")
    else:
        # text comparison; integral floats render without the ".0" so a
        # numeric side ('1.0' from the fast reader) matches text '1'
        def cast(s):
            if pd.api.types.is_numeric_dtype(s):
                return s.map(
                    lambda v: str(int(v)) if float(v).is_integer() else str(v)
                )
            return s.astype(str)
    return left.assign(**{lk: cast(a)}), right.assign(**{rk: cast(b)})


def complete_cases(df: pd.DataFrame) -> pd.DataFrame:
    """Drop rows with missing values (ref: completecases filter, select.jl:39)."""
    return df.dropna().reset_index(drop=True)


def df_output(df: pd.DataFrame, output: Optional[str]) -> None:
    """Write by extension, or print when no output path (ref: utils.jl:30-40)."""
    if output in ("stdout", "-"):
        # legacy default: full table to stdout (bin/old_options.jl:60)
        df.to_csv(sys.stdout, sep="\t", index=False)
    elif output is not None:
        log.info("Writing to `%s`", output)
        out = os.path.expanduser(output)
        if out.endswith(".csv"):
            sep = ","
        elif out.endswith(".tsv"):
            sep = "\t"
        else:
            raise ValueError("--output arg must be '.tsv' or '.csv'")
        if len(df.columns) and all(_is_number(df[c]) for c in df.columns):
            fastio.write_numeric(out, sep, [str(c) for c in df.columns],
                                 df.to_numpy(dtype=np.float64))
        else:
            df.to_csv(out, sep=sep, index=False)
    else:
        with pd.option_context("display.max_rows", 20, "display.width", 120):
            print(df)
