"""The traced window: ``torch.profiler`` over it, the reduction of its events
to what the per-layer metrics read, and the readers themselves, one file each
under ``metrics/``, found by the metric's name.

A reader is ``read(ctx) -> float | None``: ``None`` when the trace holds
nothing for it to read, and the harness then leaves the metric out.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Tuple

import numpy as np

from portbench import cell as cells

METRICS = cells.ROOT / "metrics"


def profiler():
    """A profiler of host operations and device activity, without shapes or
    stacks; the window starts and stops it."""
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   record_shapes=False, profile_memory=False, with_stack=False)


def _label(name: str) -> str:
    """A kernel or operation name cut to the characters and length of a
    benchmark name."""
    return re.sub(r"[^A-Za-z0-9_.-]", "_", name)[:64]


@dataclass
class Summary:
    """The device's activity in the traced window: each operation's name,
    start and duration (ns), which of them are kernels, and the host
    operations with their spans, for naming idle gaps."""

    names: List[str]
    start_ns: np.ndarray
    dur_ns: np.ndarray
    is_kernel: np.ndarray
    host_names: List[str]
    host_start_ns: np.ndarray
    host_end_ns: np.ndarray
    host_is_runtime: np.ndarray

    @property
    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        if not len(self.start_ns):
            return 0.0
        order = np.argsort(self.start_ns)
        s, e = self.start_ns[order], (self.start_ns + self.dur_ns)[order]
        reach = np.maximum.accumulate(e)
        new = np.empty(len(s), bool)
        new[0] = True
        new[1:] = s[1:] > reach[:-1]
        # union of intervals: each run of overlapping operations ends at its reach
        starts = s[new]
        ends = reach[np.r_[np.nonzero(new)[0][1:] - 1, len(s) - 1]]
        return float((ends - starts).sum()) * 1e-9

    def kernel_seconds(self, pattern: str) -> Tuple[float, int]:
        """Device seconds and count of the kernels whose name matches."""
        rx = re.compile(pattern)
        hit = np.array([bool(self.is_kernel[i] and rx.search(n)) for i, n in
                        enumerate(self.names)], bool)
        return float(self.dur_ns[hit].sum()) * 1e-9, int(hit.sum())

    @property
    def kernels(self) -> int:
        return int(self.is_kernel.sum())

    def top_ops(self, k: int) -> list:
        """The ``k`` device operations that took most time: [name, seconds]."""
        tot: dict = {}
        for n, d in zip(self.names, self.dur_ns):
            tot[n] = tot.get(n, 0) + int(d)
        best = sorted(tot.items(), key=lambda kv: -kv[1])[:k]
        return [[_label(n), d * 1e-9] for n, d in best]

    def top_gaps(self, k: int) -> list:
        """The ``k`` longest stretches with nothing on the device, each named
        by the innermost host operation running when it began (a runtime
        call under its operation as ``op_call``), or "host: between
        operations": [name, seconds]."""
        if len(self.start_ns) < 2:
            return []
        order = np.argsort(self.start_ns)
        s, e = self.start_ns[order], (self.start_ns + self.dur_ns)[order]
        reach = np.maximum.accumulate(e)
        gap = s[1:] - reach[:-1]
        out = []
        for i in np.argsort(-gap)[:k]:
            if gap[i] <= 0:
                break
            out.append([self._host_at(int(reach[i])), float(gap[i]) * 1e-9])
        return out

    def _host_at(self, t: int) -> str:
        inside = np.nonzero((self.host_start_ns <= t) & (self.host_end_ns > t))[0]
        if not len(inside):
            return "host: between operations"
        # innermost: the latest start among those running
        inside = inside[np.argsort(self.host_start_ns[inside])]
        last = inside[-1]
        name = self.host_names[last]
        if self.host_is_runtime[last]:
            ops = [i for i in inside if not self.host_is_runtime[i]]
            if ops:
                name = f"{self.host_names[ops[-1]]}_{name}"
        return _label(name)


#: the device activities that are operations (not annotations spanning them);
#: "" where the profiler's events do not say (torch 2.11's have no
#: ``activity_type``: every CUDA event is an operation, a kernel unless it is
#: named as a copy or a fill)
DEVICE_OPS = ("kernel", "gpu_memcpy", "gpu_memset", "")


def _activity(e) -> str:
    return e.activity_type() if hasattr(e, "activity_type") else ""


def summarize(prof) -> Summary:
    """The profiler's raw events, reduced without building its event tree."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    dev, host = [], []
    for e in events:
        if e.device_type() != DeviceType.CUDA:
            host.append(e)
        elif _activity(e) in DEVICE_OPS:
            dev.append(e)
    names = [e.name() for e in dev]
    is_kernel = np.array([_activity(e) == "kernel" if _activity(e)
                          else not n.startswith(("Memcpy", "Memset"))
                          for e, n in zip(dev, names)], bool)
    host_names = [e.name() for e in host]
    hs = np.array([e.start_ns() for e in host], np.int64)
    hd = np.array([e.duration_ns() for e in host], np.int64)
    runtime = np.array([n.startswith("cu") for n in host_names], bool)
    return Summary(names, np.array([e.start_ns() for e in dev], np.int64),
                   np.array([e.duration_ns() for e in dev], np.int64), is_kernel,
                   host_names, hs, hs + hd, runtime)


class Context(NamedTuple):
    """What a reader may read: the cell, its traced window, the trace's
    summary, the batched leapfrogs in the window, and the chain-leapfrogs
    attempted and failed (non-finite log density)."""

    cell: "cells.Cell"
    window: "cells.Window"
    trace: Summary
    calls: int
    attempted: int
    failed: int


def read_metric(name: str, ctx: Context) -> Optional[float]:
    """The metric ``name`` by its reader ``metrics/<name>.py``."""
    return cells.load_module(METRICS / f"{name}.py").read(ctx)
