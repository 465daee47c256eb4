"""Device and dtype seam (port of ``gaplac_tpu/cli/runtime.py``).

float32 on CUDA and float64 on the CPU unless ``--precision`` says
otherwise.  TF32 is switched off for matmuls and cuDNN: reduced-precision
products erred by about one nat in the dense marginal on the TPU
(``gaplac_tpu/ops/cholesky.py`` PROD_PREC note), and TF32 is the same kind
of shortcut.
"""

from __future__ import annotations

import logging
from typing import NamedTuple, Optional

import torch

log = logging.getLogger("gaplac")


class Runtime(NamedTuple):
    device: torch.device
    dtype: torch.dtype


def configure(platform: Optional[str] = None, precision: Optional[str] = None) -> Runtime:
    """platform: cpu|cuda|None (auto); precision: f32|f64|None (auto)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if platform == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--platform cuda: no CUDA device is available")
    if platform is None:
        platform = "cuda" if torch.cuda.is_available() else "cpu"
        log.info("auto platform: %s", platform)
    device = torch.device(platform)
    if precision is None:
        precision = "f64" if device.type == "cpu" else "f32"
    dtype = torch.float64 if precision == "f64" else torch.float32
    log.info("torch device: %s%s, precision: %s", device,
             f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else "",
             precision)
    return Runtime(device, dtype)
