"""Distributed pose-graph optimization over a process group (counterpart of
``srrg2_laser_slam_2d_tpu/parallel/dist_pgo.py``).

The edge set is sharded over the ranks (``shard_edges``: each rank keeps a
contiguous block of edges, the variables replicated); each rank linearizes
its own edges in ``solver/pgo.optimize``'s loop, whose ``reduce`` hook
``all_reduce``s the dense normal systems and chi, and every rank solves the
same reduced system. The loop's exit and its divergence guard read the
REDUCED chi, so every rank takes the same branch (a rank's own chi would
let one rank leave the loop while another waits in the next collective).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..solver import pgo
from ..solver.pgo import PGOConfig, PoseGraph
from .mesh import pad_to_multiple, rank_slice

_EDGE_FIELDS = ("edge_i", "edge_j", "edge_meas", "edge_info", "edge_valid")


def shard_edges(graph: PoseGraph, group=None) -> PoseGraph:
    """This rank's contiguous block of the edges (the edge arrays padded
    with invalid edges to a multiple of the group's size); the variables
    are replicated."""
    world = dist.get_world_size(group)
    ec = graph.edge_capacity
    pad = pad_to_multiple(ec, world) - ec
    sl = rank_slice(ec + pad, group)
    out = {}
    for name in _EDGE_FIELDS:
        x = getattr(graph, name)
        if pad:
            x = torch.cat([x, torch.zeros((pad,) + x.shape[1:], dtype=x.dtype, device=x.device)])
        out[name] = x[sl]
    return graph._replace(**out)


def optimize_sharded(cfg: PGOConfig, graph: PoseGraph, group=None):
    """``pgo.optimize`` over a graph whose edges are this rank's shard
    (``shard_edges``), H, b and chi summed over the group (the divergence
    guard's chi too). Returns (graph with the solved poses, chi,
    iterations), equal on every rank."""
    return pgo.optimize(cfg, graph, reduce=lambda t: dist.all_reduce(t, group=group))
