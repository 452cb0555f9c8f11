"""Per-stage status codes (Error / Ready / Successful), plain ints so they
can sit in a ``TrackStats`` field as well as on host-side wrappers.
Counterpart of ``srrg2_laser_slam_2d_tpu/utils/status.py``.
"""

from __future__ import annotations

import enum


class Status(enum.IntEnum):
    ERROR = 0        # stage ran and failed (e.g. alignment below min inliers)
    READY = 1        # stage initialized, nothing processed yet
    SUCCESS = 2      # stage ran and produced a valid result


def describe(code: int) -> str:
    try:
        return Status(int(code)).name
    except ValueError:
        return f"UNKNOWN({code})"
