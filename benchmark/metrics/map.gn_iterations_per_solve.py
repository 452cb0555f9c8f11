"""Gauss-Newton iterations a solve, each one read of chi on the host: the
program's counters ``solver/pgo.iterations`` over ``solver/pgo.solves``
(every ``pgo.optimize``: the validator's partition solves and the global
solve), over the whole run. The warm-up pass is counted too: one of some
30-40 passes of the same log, it enters the numerator and the denominator
alike. None where the program has no such counters or solved nothing."""

from srrg2_laser_slam_2d_tpu_torch.solver import pgo


def read(ctx):
    iterations = getattr(pgo, "iterations", None)
    solves = getattr(pgo, "solves", 0)
    return iterations / solves if iterations is not None and solves else None
