"""ctypes binding of the native numeric-table reader and writer
(``native/fastio.cpp``, the port's copy of ``gaplac_tpu``'s).

The library is compiled at first use with the system C++ compiler
(``$CXX``, else ``g++``; ``-O3 -shared -fPIC``) into ``gaplac_tpu_torch/_build/``,
named by a hash of its source, and loaded with ctypes.  A failed build
raises with the compiler's message: nothing falls back.  ``data/io.py``
reads and writes all-numeric tables through it (chain tables of n_obs + 8
float columns, data tables of 2^20 rows); a table with a field that is not
a number goes to pandas, as in ``gaplac_tpu`` (return code -3).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SRC = _PKG / "native" / "fastio.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lib: Optional[ctypes.CDLL] = None

_DOUBLE_P = ctypes.POINTER(ctypes.c_double)


def library() -> ctypes.CDLL:
    """The loaded library, built on first call."""
    global _lib
    if _lib is not None:
        return _lib
    cxx = os.environ.get("CXX", "g++")
    digest = hashlib.sha256(" ".join((cxx,) + CXX_FLAGS).encode() + SRC.read_bytes())
    out = BUILD_DIR / f"libfastio_{digest.hexdigest()[:16]}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        try:
            proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SRC)],
                                  capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.SubprocessError) as e:
            raise RuntimeError(f"fastio: the C++ build ({cxx}) did not run: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"fastio: {cxx} failed with code {proc.returncode}:\n"
                               f"{proc.stderr}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    lib.fastio_read.restype = ctypes.c_int
    lib.fastio_read.argtypes = [
        ctypes.c_char_p, ctypes.c_char, ctypes.POINTER(_DOUBLE_P),
        ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_char_p),
    ]
    lib.fastio_write.restype = ctypes.c_int
    lib.fastio_write.argtypes = [ctypes.c_char_p, ctypes.c_char, ctypes.c_char_p, _DOUBLE_P,
                                 ctypes.c_long, ctypes.c_long]
    lib.fastio_free.restype = None
    lib.fastio_free.argtypes = [_DOUBLE_P]
    lib.fastio_free_str.restype = None
    lib.fastio_free_str.argtypes = [ctypes.c_char_p]
    _lib = lib
    return lib


def read_numeric(path: str, delim: str) -> Optional[Tuple[List[str], np.ndarray]]:
    """(column names, (rows, cols) float64 array) of an all-numeric table, or
    None for a table pandas must read: a field that is not a number, or no
    data row.  Raises OSError when the file cannot be read."""
    lib = library()
    data = _DOUBLE_P()
    rows, cols = ctypes.c_long(), ctypes.c_long()
    header = ctypes.c_char_p()
    rc = lib.fastio_read(os.fsencode(path), delim.encode(), ctypes.byref(data),
                         ctypes.byref(rows), ctypes.byref(cols), ctypes.byref(header))
    if rc == -1:
        raise OSError(f"fastio: cannot read {path}")
    if rc != 0:
        return None
    try:
        arr = np.ctypeslib.as_array(data, shape=(rows.value, cols.value)).copy()
        text = header.value.decode("utf-8", "replace")
    finally:
        lib.fastio_free(data)
        lib.fastio_free_str(header)
    # R's write.csv quotes header names; pandas unquotes them, and so must this
    return [s.strip().strip('"').strip("'") for s in text.split(delim)], arr


def write_numeric(path: str, delim: str, names: List[str], data: np.ndarray) -> None:
    """Write a float table in ``gaplac_tpu``'s format: integral values below
    1e15 as ``%.1f``, the rest as ``%.17g``.  Raises OSError on failure."""
    data = np.ascontiguousarray(data, dtype=np.float64)
    if data.ndim != 2 or data.shape[1] != len(names):
        raise ValueError(f"fastio: {len(names)} names for data of shape {data.shape}")
    rc = library().fastio_write(os.fsencode(path), delim.encode(),
                                delim.join(names).encode(), data.ctypes.data_as(_DOUBLE_P),
                                data.shape[0], data.shape[1])
    if rc != 0:
        raise OSError(f"fastio: cannot write {path}")
