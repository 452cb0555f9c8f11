"""Frozen operation and byte counts of the port's kernels, and the card's
published peaks: the yardstick of the roofline metrics."""

# NVIDIA H100 SXM data sheet: HBM3 bandwidth, float32 outside the tensor cores
H100_BYTES_PER_S = 3.35e12
H100_F32_FLOPS = 67e12


def bound_s(bytes_moved: float, flops: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(bytes_moved / H100_BYTES_PER_S, flops / H100_F32_FLOPS)
