"""Chain-level data parallelism over ranks (port of
``gaplac_tpu/parallel/mesh.py``).

JAX places a chain axis on a 1-D device mesh and XLA partitions the vmapped
chains; here a mesh is a process group, each rank runs its contiguous slice
of the chains, and ``gather_chain_axis`` collects the slices in chain order,
the step JAX gets implicitly from a global array.  ``mesh=None`` means no
mesh: the arrays stay whole and no collective runs.  A mesh of one rank
still runs its collectives (copies).
"""

from __future__ import annotations

import logging
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

log = logging.getLogger("gaplac")


class Mesh(NamedTuple):
    """A 1-D mesh of ranks: the process group its collectives run on, its
    size and this rank's index on it."""

    group: object
    size: int
    rank: int


def rank_mesh(n_devices: Optional[int] = None) -> Optional[Mesh]:
    """The mesh over the first ``n_devices`` ranks (all by default); every
    rank must call it.  A rank outside the mesh gets None (no
    collectives)."""
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs an initialized process group "
                           "(parallel.multihost.maybe_initialize)")
    world = dist.get_world_size()
    n = n_devices or world
    if not 1 <= n <= world:
        raise ValueError(f"a mesh of {n} ranks in a world of {world}")
    group = dist.group.WORLD if n == world else dist.new_group(list(range(n)))
    rank = dist.get_rank()
    return Mesh(group, n, rank) if rank < n else None


def chain_mesh(n_devices: Optional[int] = None) -> Optional[Mesh]:
    """The 1-D "chains" mesh over (up to) all ranks."""
    return rank_mesh(n_devices)


def shards_evenly(n: int, mesh: Optional[Mesh]) -> bool:
    """Whether ``n`` chains split into equal slices over ``mesh``."""
    return mesh is not None and n % mesh.size == 0


def shard_chain_axis(*arrays, mesh: Optional[Mesh] = None):
    """This rank's contiguous slice of each array's leading (chain) axis when
    it divides evenly over the mesh; otherwise the arrays whole (every rank
    runs every chain).  Returns the arrays in the same order, a single one
    bare."""
    n = arrays[0].shape[0]
    if not shards_evenly(n, mesh):
        if mesh is not None:
            log.warning(
                "chains (%d) not divisible by devices (%d); running UNSHARDED "
                "on one device — pick a chain count that is a multiple of %d",
                n, mesh.size, mesh.size,
            )
        return arrays if len(arrays) > 1 else arrays[0]
    nb = n // mesh.size
    out = tuple(a[mesh.rank * nb:(mesh.rank + 1) * nb] for a in arrays)
    log.info("sharded %d chains over %d devices", n, mesh.size)
    return out if len(out) > 1 else out[0]


def gather_chain_axis(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Every rank's slice of the leading axis, concatenated in rank (chain)
    order, on every rank; ``x`` itself without a mesh."""
    if mesh is None:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x, group=mesh.group)
    return torch.cat(parts)
