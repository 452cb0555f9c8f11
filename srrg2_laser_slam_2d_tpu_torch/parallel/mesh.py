"""Process groups for the parallel layer (counterpart of
``srrg2_laser_slam_2d_tpu/parallel/mesh.py``).

The JAX layer shards over the axis ``graph`` of a device mesh with
``shard_map`` and ``psum``; the port shards over the ranks of a
``torch.distributed`` process group, one device a rank, and sums with
``all_reduce``. The backend follows the device: ``gloo`` on the CPU,
``nccl`` on CUDA cards (``multihost.init_multiprocess``); there is no
fallback from one to the other.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

GRAPH_AXIS = "graph"


def make_group(world_size: int | None = None):
    """The default group, or a new group over the first ``world_size``
    ranks. COLLECTIVE: every rank of the default group must call it in the
    same order; ranks outside the new group get ``GroupMember.NON_GROUP_MEMBER``."""
    if world_size is None or world_size == dist.get_world_size():
        return dist.group.WORLD
    if not 1 <= world_size <= dist.get_world_size():
        raise ValueError(f"a group of {world_size} ranks in a world of {dist.get_world_size()}")
    return dist.new_group(ranks=list(range(world_size)))


def rank_slice(n: int, group=None) -> slice:
    """The contiguous block of a length-``n`` axis that this rank owns
    (``n`` must be a multiple of the group's size)."""
    world = dist.get_world_size(group)
    if n % world:
        raise ValueError(f"axis of {n} not divisible by {world} ranks")
    per = n // world
    r = dist.get_rank(group)
    return slice(r * per, (r + 1) * per)


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def all_gather_cat(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``x`` (the same shape on each) concatenated along the
    first axis in rank order, on every rank."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)
