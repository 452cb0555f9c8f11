"""Share of the aligner's card calls (``ops/icp.align``: the relocalizer's
and the loop detector's alignments) served by replaying a captured CUDA
graph: the program's counters ``ops/icp.graph_replays`` over
``graph_replays + graph_captures + eager_card_calls``, over the whole run
(the warm-up's calls are counted too). None where the program has no such
counters or made no card call of ``icp.align``."""

from srrg2_laser_slam_2d_tpu_torch.ops import icp

COUNTERS = ("graph_replays", "graph_captures", "eager_card_calls")


def read(ctx):
    counts = [getattr(icp, k, None) for k in COUNTERS]
    if any(c is None for c in counts) or not sum(counts):
        return None
    return counts[0] / sum(counts)
