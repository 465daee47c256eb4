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
    """platform: cuda|cpu|None (None: the card); precision: f32|f64|None (auto).

    The port runs on the card: without a CUDA device it raises, unless the
    caller asks for the CPU with ``platform="cpu"`` (``--platform cpu``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if platform is None:
        platform = "cuda"
    if platform == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --platform cpu to run on "
                           "the CPU")
    device = torch.device(platform)
    if precision is None:
        precision = "f64" if device.type == "cpu" else "f32"
    dtype = torch.float64 if precision == "f64" else torch.float32
    log.info("torch device: %s%s, precision: %s", device,
             f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else "",
             precision)
    return Runtime(device, dtype)
