"""Batched scan alignment sharded over a process group (counterpart of
``srrg2_laser_slam_2d_tpu/parallel/batch_align.py``).

Loop-closure candidates align independently, so K candidates split over the
ranks with no collective but the final gather: each rank aligns its K / n
candidates through the batched plain aligner
(``models/loop_closure._batch_align_pairs``: ``icp.align`` over a batch of
fixed and moving clouds, the batched form of ``_batch_align``), and
``all_gather`` puts the ``AlignResult`` back together in the original
order on every rank.
"""

from __future__ import annotations

import torch

from ..models.loop_closure import _batch_align_pairs
from ..ops import icp
from ..ops.projector import PolarProjection
from ..utils.cloud import Cloud
from .mesh import all_gather_cat, rank_slice


def batch_align_sharded(acfg: icp.AlignerConfig, proj: PolarProjection, group,
                        fixed_batch: Cloud, moving_batch: Cloud,
                        initials: torch.Tensor) -> icp.AlignResult:
    """``fixed_batch`` and ``moving_batch`` [K, N, ...], ``initials`` [K, 3];
    K must be a multiple of the group's size."""
    sl = rank_slice(initials.shape[0], group)
    local = _batch_align_pairs(acfg, proj, fixed_batch.map(lambda x: x[sl]),
                               moving_batch.map(lambda x: x[sl]), initials[sl])
    return icp.AlignResult(*(all_gather_cat(x, group) for x in local))
