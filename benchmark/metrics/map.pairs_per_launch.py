"""Closure pairs a launch of kernel 2: the program's counters
``ops/nn_icp_kernel.pairs`` (pairs aligned, on either route) over
``ops/nn_icp_kernel.launches`` (launches on the card), over the whole run.
The warm-up pass is counted too: one of some 30-40 passes of the same log,
it enters the numerator and the denominator alike. None where the program
has no ``pairs`` counter or launched nothing."""

from srrg2_laser_slam_2d_tpu_torch.ops import nn_icp_kernel


def read(ctx):
    pairs = getattr(nn_icp_kernel, "pairs", None)
    launches = getattr(nn_icp_kernel, "launches", 0)
    return pairs / launches if pairs is not None and launches else None
