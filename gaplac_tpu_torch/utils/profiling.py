"""Phase timers and a profiler trace (port of ``gaplac_tpu/utils/profiling.py``).

Two mechanisms, both off unless the CLI's ``--profile`` or ``--profile-dir``
turns them on:
  - ``phase(name)``: wall-clock phase timers accumulated into a report
    (``print_report``), in ``gaplac_tpu``'s format.  On the card a phase
    ends with ``torch.cuda.synchronize``: launches are asynchronous, and
    without it a phase would time the host's queueing of its work;
  - ``trace(logdir)``: ``torch.profiler`` over CPU and CUDA activity, written
    as a ``*.pt.trace.json`` that TensorBoard and Perfetto read.

The timers are process state, as in ``gaplac_tpu``; ``reset`` clears them
and turns them off, so that several commands in one process each report
their own phases.
"""

from __future__ import annotations

import contextlib
import logging
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import torch

log = logging.getLogger("gaplac")

_phases: Dict[str, float] = defaultdict(float)
_counts: Dict[str, int] = defaultdict(int)
_enabled = False


def enable() -> None:
    global _enabled
    _enabled = True


def enabled() -> bool:
    return _enabled


def reset() -> None:
    """Clear the timers and turn them off."""
    global _enabled
    _enabled = False
    _phases.clear()
    _counts.clear()


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def phase(name: str) -> Iterator[None]:
    """Accumulate wall-clock under ``name`` (no-op unless enabled)."""
    if not _enabled:
        yield
        return
    _sync()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _sync()
        _phases[name] += time.perf_counter() - t0
        _counts[name] += 1


@contextlib.contextmanager
def trace(logdir: Optional[str]) -> Iterator[None]:
    """A ``torch.profiler`` trace of the block into ``logdir``, when given."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)):
        yield
    log.info("profiler trace written to %s (view with TensorBoard or Perfetto)", logdir)


def report() -> str:
    if not _phases:
        return ""
    total = sum(_phases.values())
    lines = ["phase breakdown:"]
    for name, t in sorted(_phases.items(), key=lambda kv: -kv[1]):
        lines.append(
            f"  {name:<24s} {t:8.3f}s  ({100 * t / total:5.1f}%)  x{_counts[name]}"
        )
    return "\n".join(lines)


def print_report() -> None:
    r = report()
    if r:
        log.info("%s", r)
        print(r)
