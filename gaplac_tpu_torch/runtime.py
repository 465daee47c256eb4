"""Device and dtype seam (port of ``gaplac_tpu/cli/runtime.py``).

float32 on CUDA and float64 on the CPU unless ``--precision`` says
otherwise.  TF32 is switched off for matmuls and cuDNN: reduced-precision
products erred by about one nat in the dense marginal on the TPU
(``gaplac_tpu/ops/cholesky.py`` PROD_PREC note), and TF32 is the same kind
of shortcut.

In a multi-process run (``GAPLAC_COORDINATOR`` and ``GAPLAC_PROCESS_ID``
set, ``parallel/multihost.py``) rank i binds ``cuda:(i % device_count)``:
one process a card.
"""

from __future__ import annotations

import logging
from typing import NamedTuple, Optional

import torch

from gaplac_tpu_torch.parallel.multihost import env_process_id

log = logging.getLogger("gaplac")


class Runtime(NamedTuple):
    device: torch.device
    dtype: torch.dtype


def configure(platform: Optional[str] = None, precision: Optional[str] = None) -> Runtime:
    """platform: cuda|cpu|None (None: the card); precision: f32|f64|None (auto).

    The port runs on the card: without a CUDA device it raises, unless the
    caller asks for the CPU with ``platform="cpu"`` (``--platform cpu``).
    A rank of a multi-process run gets its card, made the current device."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if platform is None:
        platform = "cuda"
    if platform == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --platform cpu to run on "
                           "the CPU")
    device = torch.device(platform)
    rank = env_process_id()
    if device.type == "cuda" and rank is not None:
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    if precision is None:
        precision = "f64" if device.type == "cpu" else "f32"
    dtype = torch.float64 if precision == "f64" else torch.float32
    log.info("torch device: %s%s, precision: %s", device,
             f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else "",
             precision)
    return Runtime(device, dtype)
