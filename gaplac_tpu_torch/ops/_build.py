"""Build the CUDA kernels of ``csrc/`` at first CUDA use and bind them.

``nvcc`` compiles every ``csrc/*.cu`` into an object, one process per source,
all started together, and links them into one shared library with a plain
C interface, cached under ``gaplac_tpu_torch/_build/`` by a hash of the
sources and flags; ``ctypes`` loads it.  Each C entry point returns
``cudaGetLastError()`` after its launch; :func:`check` raises on anything
but 0.  A failed build raises: nothing falls back.

``counts`` holds one plain integer per kernel, raised by one each time its
wrapper launches it, so a run can show that its main path went through the
kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

#: launches per kernel: K1 batched Cholesky, K2 gram, K2b gram backward,
#: K3 Cholesky of one tile (the blocked factorization's base case)
counts = {"K1": 0, "K2": 0, "K2b": 0, "K3": 0}
#: wall-clock seconds of the nvcc build in this process (None: cached or not built)
build_seconds = None
_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "gaplac_chol_batched_f32": (_P, _I, _I, _I, _I, _P),
    "gaplac_chol_batched_f64": (_P, _I, _I, _I, _I, _P),
    "gaplac_gram_fwd_f32": (_P, _I, _I, _P, _P, _I, _I, _I, _P, _I, _I, ctypes.c_double,
                            _I, _I, _I, _I, _P, _I, _P),
    "gaplac_gram_fwd_f64": (_P, _I, _I, _P, _P, _I, _I, _I, _P, _I, _I, ctypes.c_double,
                            _I, _I, _I, _I, _P, _I, _P),
    "gaplac_gram_bwd_f32": (_P, _I, _I, _P, _P, _I, _I, _I, _P, _I, _I, _I, _I, _I, _I, _P,
                            _P, _I, _P),
    "gaplac_gram_bwd_f64": (_P, _I, _I, _P, _P, _I, _I, _I, _P, _I, _I, _I, _I, _I, _I, _P,
                            _P, _I, _P),
    "gaplac_gram_bwd_cluster": (_I, _I, _I),
    "gaplac_chol_batched_clusters": (_I, _I, _I),
    "gaplac_chol_tile_f32": (_P, _I, _P, _I, _I, _I, _P),
    "gaplac_chol_tile_f64": (_P, _I, _P, _I, _I, _I, _P),
}


def reset_counts() -> None:
    for k in counts:
        counts[k] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (looked on PATH and in /usr/local/cuda/bin); "
                           "the CUDA kernels cannot be built")
    return path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sources + sorted(CSRC.glob("*.cuh")):
        digest.update(f.name.encode())
        digest.update(f.read_bytes())
    out = BUILD_DIR / f"libgaplac_kernels_{digest.hexdigest()[:16]}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        objs = [BUILD_DIR / f"{f.stem}.{os.getpid()}.o" for f in sources]
        procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", str(o), str(f)],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for f, o in zip(sources, objs)]
        try:
            for f, proc in zip(sources, procs):
                _, err = proc.communicate()
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed on {f.name} with code "
                                       f"{proc.returncode}:\n{err}")
        finally:
            for proc in procs:  # after a failure, stop the builds still running
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed with code {proc.returncode}:\n{proc.stderr}")
        os.replace(tmp, out)
        for o in objs:
            o.unlink()
        build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(out))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.gaplac_error_string.argtypes = (ctypes.c_int,)
    lib.gaplac_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a kernel's launch reported a CUDA error."""
    if err != 0:
        msg = _lib.gaplac_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def device_index(device) -> int:
    """The CUDA device index of ``device``: an index, or a ``torch.device``
    with one (a CUDA tensor's ``.device``)."""
    if isinstance(device, int):
        return device
    device = torch.device(device)
    if device.type != "cuda" or device.index is None:
        raise ValueError(f"a CUDA device with an index expected, got {device}")
    return device.index


def require_cuda(what: str, *tensors: torch.Tensor, contiguous: bool = True) -> torch.dtype:
    """Check that the kernel's tensors share one CUDA device and one float
    dtype (float32 or float64) and, unless ``contiguous`` is False, are
    contiguous; returns the dtype."""
    t0 = tensors[0]
    for t in tensors:
        if not t.is_cuda or t.device != t0.device:
            raise ValueError(f"{what}: all tensors must be on one CUDA device")
        if t.dtype != t0.dtype or t.dtype not in (torch.float32, torch.float64):
            raise ValueError(f"{what}: tensors must all be float32 or all float64")
        if contiguous and not t.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous")
    return t0.dtype
