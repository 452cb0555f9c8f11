"""Kernel 6's count (``csrc/multicue_align_kernel.cu``, one launch aligns
one multi-cue frame), frozen from the port's
``ops/multicue_align_kernel.py:flops_per_pass`` and the launch's arguments
as the benchmark was written.
"""


def flops_per_pass(n_cues: int, n_moving: int) -> float:
    """Operations of one Gauss-Newton pass: 110 per moving row and cue (43
    for the transform and beam assignment, 54 for the match and the
    normal-equation terms, 13 for the sums), plus 60 per cue for the cue
    pose, the remap and the solve. Every row of the moving cloud is
    counted, valid or not (the kernel packs the valid ones)."""
    return n_cues * (110 * n_moving + 60)


def launch_flops(n_cues: int, n_moving: float, iterations: int) -> float:
    """``iterations`` updates and one pass for the final statistics."""
    return (iterations + 1) * flops_per_pass(n_cues, n_moving)


def launch_bytes(n_cues: int, n_fixed: float, n_moving: float, iterations: int) -> float:
    """What one launch reads and writes, once each: every fixed and moving
    row (float2 point, float2 normal, one byte of validity), the initial
    guess, the prior and the cues' extrinsics in; the pose (padded to 4
    floats), the 4 final statistics and 4 floats a pass's record out."""
    return 17 * (n_fixed + n_moving) + 4 * (3 + 3 + 3 * n_cues) + 4 * (4 + 4 + 4 * iterations)
