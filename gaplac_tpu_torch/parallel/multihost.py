"""Multi-process launch on ``torch.distributed`` (port of
``gaplac_tpu/parallel/multihost.py``).

Environment-driven, as ``gaplac_tpu``'s:

    GAPLAC_COORDINATOR=host:port   GAPLAC_NUM_PROCESSES=N   GAPLAC_PROCESS_ID=i

or explicit kwargs.  One process per card: rank i binds
``cuda:(i % device_count)`` (``runtime.configure``), and the process group
runs NCCL on the card and gloo on the CPU.  ``init_process_group`` is given
its address, world size and rank; nothing is discovered, so the count and
the id are required whenever a coordinator is.  The CLI calls
``maybe_initialize`` once, after ``configure``; without a coordinator it
does nothing, and a run makes no collective.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

log = logging.getLogger("gaplac")

_initialized = False


def env_process_id() -> Optional[int]:
    """This process's rank from ``GAPLAC_PROCESS_ID`` when
    ``GAPLAC_COORDINATOR`` is set, else None."""
    if os.environ.get("GAPLAC_COORDINATOR") is None or "GAPLAC_PROCESS_ID" not in os.environ:
        return None
    return int(os.environ["GAPLAC_PROCESS_ID"])


def maybe_initialize(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: Optional[torch.device] = None,
) -> bool:
    """Initialize the default process group when configured; True if it is.

    A no-op (False) when neither ``coordinator`` nor ``GAPLAC_COORDINATOR``
    is set: single-process runs stay untouched.  ``device`` is the run's
    device (``runtime.configure``'s; None: the card): NCCL on CUDA, gloo on
    the CPU.  A second call returns True and does nothing."""
    global _initialized
    if _initialized:
        return True
    coordinator = coordinator or os.environ.get("GAPLAC_COORDINATOR")
    if coordinator is None:
        return False
    num_processes = num_processes or int(os.environ.get("GAPLAC_NUM_PROCESSES", "0")) or None
    process_id = (
        process_id
        if process_id is not None
        else (int(os.environ["GAPLAC_PROCESS_ID"]) if "GAPLAC_PROCESS_ID" in os.environ else None)
    )
    if num_processes is None or process_id is None:
        raise ValueError("a multi-process run needs GAPLAC_NUM_PROCESSES and "
                         "GAPLAC_PROCESS_ID beside GAPLAC_COORDINATOR")
    device = torch.device("cuda" if device is None else device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    _initialized = True
    log.info("torch.distributed initialized (%s): rank %d, world size %d, device %s",
             backend, dist.get_rank(), dist.get_world_size(), device)
    return True


def shutdown() -> None:
    """Destroy the default process group, so that a later
    ``maybe_initialize`` in this process starts a new one."""
    global _initialized
    if dist.is_initialized():
        dist.destroy_process_group()
    _initialized = False


def is_multihost() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def is_primary() -> bool:
    """True on rank 0, and in a run without a process group: the process
    that writes a command's files and prints its results."""
    return not dist.is_initialized() or dist.get_rank() == 0


def global_chain_mesh():
    """The 1-D "chains" mesh over all ranks."""
    from gaplac_tpu_torch.parallel.mesh import chain_mesh

    return chain_mesh()
