"""Streamed tracking and batched preprocessing (counterpart of
``srrg2_laser_slam_2d_tpu/bench/pipeline.py``: ``track_sequence``,
``preprocess_batch``, ``track_sequence_batch``).

The frame loop is sequential: ``track_sequence`` steps the tracker over T
pre-staged scans with no host round-trip of its own (the traces stay on the
device), the counterpart of the JAX ``lax.scan`` over the same step.
"""

from __future__ import annotations

import torch

from ..models import tracker as tracker_mod
from ..models.preprocessor import PreprocessorConfig, preprocess_scan
from ..ops.projector import PolarProjection
from ..utils.cloud import Cloud


def tree_index(tree, k):
    """The ``k``-th entry of every tensor of a NamedTuple tree (a Cloud, a
    TrackerState with its nested clouds)."""
    if isinstance(tree, torch.Tensor):
        return tree[k]
    return type(tree)(*(tree_index(x, k) for x in tree))


def tree_stack(trees):
    """The NamedTuple tree of stacked leaves of a list of equal trees."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(trees)
    return type(first)(*(tree_stack([t[i] for t in trees]) for i in range(len(first))))


def track_sequence(cfg: tracker_mod.TrackerConfig, state: tracker_mod.TrackerState,
                   meas_stack: Cloud, odoms: torch.Tensor, odom_valid: torch.Tensor):
    """T sequential tracking steps over ``meas_stack`` [T, N, ...],
    ``odoms`` [T, 3] and ``odom_valid`` [T]. Returns the final state and the
    per-frame traces (poses [T, 3], chi [T], inliers [T]). With
    ``reuse_clip_canvas`` the first frame clips from the scene (no cache
    yet) and the others reuse the merge canvas, as in the JAX package."""
    poses, chis, inliers = [], [], []
    for t in range(odoms.shape[0]):
        state, stats = tracker_mod.track_step(
            cfg, state, tree_index(meas_stack, t), odoms[t], odom_valid[t],
            use_clip_cache=cfg.reuse_clip_canvas and t > 0)
        poses.append(state.robot_in_local_map)
        chis.append(stats.chi)
        inliers.append(stats.num_inliers)
    return state, (torch.stack(poses), torch.stack(chis), torch.stack(inliers))


def preprocess_batch(proj: PolarProjection, pcfg: PreprocessorConfig,
                     ranges: torch.Tensor) -> Cloud:
    """[T, num_beams] ranges -> a [T, num_beams, ...] Cloud stack."""
    return preprocess_scan(proj, pcfg, ranges)


def track_sequence_batch(cfg: tracker_mod.TrackerConfig, states: tracker_mod.TrackerState,
                         meas_stack: Cloud, odoms: torch.Tensor, odom_valid: torch.Tensor):
    """B independent tracking streams advanced T frames each: ``states``
    [B, ...], ``meas_stack`` [B, T, N, ...], ``odoms`` [B, T, 3],
    ``odom_valid`` [B, T]. Each stream is one ``track_sequence``; the
    results are stacked over B."""
    outs = [track_sequence(cfg, tree_index(states, b), tree_index(meas_stack, b), odoms[b],
                           odom_valid[b]) for b in range(odoms.shape[0])]
    return (tree_stack([o[0] for o in outs]),
            tuple(torch.stack([o[1][i] for o in outs]) for i in range(3)))
