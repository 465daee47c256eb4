"""Sampler progress lines on stderr (port of
``gaplac_tpu/inference/progress.py``).

``gaplac_tpu`` emits them from inside a compiled scan through host
callbacks; the port's sampler loops run on the host, so the emitter is a
plain function called after each transition.
"""

from __future__ import annotations

import sys
from typing import Callable


def progress_emitter(phase: str, total: int, enabled: bool) -> Callable[[int], None]:
    """An ``emit(i)`` to call with the 0-based iteration index; prints
    ``[phase] done/total`` about every 5% (and at completion) to stderr."""
    if not enabled or total <= 0:
        return lambda i: None
    stride = max(1, total // 20)

    def emit(i: int) -> None:
        done = i + 1
        if done % stride == 0 or done == total:
            end = "\n" if done >= total else ""
            print(f"\r[{phase}] {done}/{total}", end=end, file=sys.stderr, flush=True)

    return emit
