"""Segmented lockstep HMC (port of ``gaplac_tpu/inference/segmented.py``).

``gaplac_tpu`` compiles one short segment of transitions and drives warmup
and sampling from the host, because whole-sampler programs faulted its TPU
worker at n >= 2^18.  Eager PyTorch has no program to cut, so the port keeps
only the behaviour, and ``run_hmc`` (``inference/chees.py``) has it: the
same transition driven in segments of ``segment_size`` with the whole
``HmcCarry`` (generator included) passed through, so the draws equal the
unsegmented run's for the same seed, and a checkpoint callback after every
sampling segment.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from gaplac_tpu_torch.inference.chees import HmcResult, run_hmc


def run_hmc_segmented(
    gen: torch.Generator,
    logdensity: Callable[[torch.Tensor], torch.Tensor],
    initial_positions: torch.Tensor,   # (chains, dim)
    num_samples: int,
    segment_size: int = 25,
    checkpoint_cb: Optional[Callable[[dict], None]] = None,
    **kwargs,
) -> HmcResult:
    """``run_hmc`` in segments of ``segment_size`` transitions; the other
    keyword arguments are ``run_hmc``'s."""
    return run_hmc(gen, logdensity, initial_positions, num_samples,
                   segment_size=segment_size, checkpoint_cb=checkpoint_cb, **kwargs)
