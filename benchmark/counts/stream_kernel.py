"""Kernel 3's count (``csrc/stream_kernel.cu``, one launch of K streams x T
frames), frozen from the port's ``chip_smoke.py:check_stream_kernel`` and
``ops/stream_kernel.py:flops_per_lane_frame`` as the benchmark was written.
"""


def flops_per_lane_frame(iterations: int, corr_refresh: int = 1) -> int:
    """Operations per beam lane per frame: 14 to re-frame the cache cell;
    per Gauss-Newton pass (``iterations`` + 1) 43 for the transform and
    beam assignment, 50 for the gates and normal-equation terms, 13 for the
    block sums; 4 per canvas gather (one per ``corr_refresh`` updates and
    one for the last pass); 60 for the merge."""
    passes = iterations + 1
    gathers = -(-iterations // max(int(corr_refresh), 1)) + 1
    return 14 + 106 * passes + 4 * gathers + 60


def launch_bytes(T: int, K: int, B: int) -> int:
    """What one launch reads and writes, once each: canvas rows 0-5 and the
    odometry in, all 8 payload rows out, cache rows 0-5 and the pose in, 8
    cache rows and the pose out."""
    return 4 * (T * (6 + 8) * K * B + T * K * 8 + (6 + 8) * K * B + 2 * K * 16)


def launch_flops(T: int, K: int, B: int, iterations: int, corr_refresh: int) -> int:
    return T * K * B * flops_per_lane_frame(iterations, corr_refresh)
