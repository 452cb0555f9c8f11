"""ctypes bindings for the repository's native CARMEN parser
(``native/dataloader.cpp``), with the pure-Python parser of ``io/carmen.py``
as the fallback where no C++ compiler is at hand. Counterpart of
``srrg2_laser_slam_2d_tpu/io/native_loader.py``.

The native path parses a whole log in one pass into contiguous arrays.
The library is built at first use with ``g++`` into
``build/torch_native/libdataloader.so`` at the repository root (ignored by
git); nothing is written under ``native/``. The returned ``backend`` says
which parser ran.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parent.parent.parent
SOURCE = _ROOT / "native" / "dataloader.cpp"
LIBRARY = _ROOT / "build" / "torch_native" / "libdataloader.so"

_LIB = None
_LIB_TRIED = False


def _build() -> None:
    """Compile ``SOURCE`` into ``LIBRARY`` (replaced atomically)."""
    LIBRARY.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=LIBRARY.parent)
    os.close(fd)
    try:
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17", str(SOURCE),
                        "-o", tmp], check=True, capture_output=True)
        os.replace(tmp, LIBRARY)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load_library():
    global _LIB, _LIB_TRIED
    if _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    try:
        if not LIBRARY.exists() or LIBRARY.stat().st_mtime < SOURCE.stat().st_mtime:
            _build()
        lib = ctypes.CDLL(str(LIBRARY))
        lib.carmen_open.restype = ctypes.c_void_p
        lib.carmen_open.argtypes = [ctypes.c_char_p]
        lib.carmen_num_scans.restype = ctypes.c_int
        lib.carmen_num_scans.argtypes = [ctypes.c_void_p]
        lib.carmen_num_beams.restype = ctypes.c_int
        lib.carmen_num_beams.argtypes = [ctypes.c_void_p]
        lib.carmen_fill.restype = None
        lib.carmen_fill.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 5
        lib.carmen_close.restype = None
        lib.carmen_close.argtypes = [ctypes.c_void_p]
        _LIB = lib
    except (OSError, subprocess.CalledProcessError):
        _LIB = None
    return _LIB


def available() -> bool:
    """Whether the native parser builds and loads."""
    return _load_library() is not None


def load_carmen_arrays(path: str) -> dict:
    """Parse a CARMEN log into flat arrays: ranges [N, B] (padded with -1),
    laser_pose [N, 3], odom_pose [N, 3], timestamp [N] (float64), meta
    [N, 4] = (n_beams, angle_min, fov, range_max), and ``backend``
    ("native" or "python")."""
    lib = _load_library()
    if lib is not None:
        h = lib.carmen_open(str(path).encode())
        if h:
            try:
                n = lib.carmen_num_scans(h)
                b = lib.carmen_num_beams(h)
                ranges = np.empty((n, b), np.float32)
                laser_pose = np.empty((n, 3), np.float32)
                odom_pose = np.empty((n, 3), np.float32)
                timestamp = np.empty((n,), np.float64)
                meta = np.empty((n, 4), np.float32)
                lib.carmen_fill(h, *(a.ctypes.data_as(ctypes.c_void_p) for a in (
                    ranges, laser_pose, odom_pose, timestamp, meta)))
                return {"ranges": ranges, "laser_pose": laser_pose, "odom_pose": odom_pose,
                        "timestamp": timestamp, "meta": meta, "backend": "native"}
            finally:
                lib.carmen_close(h)
    from . import carmen as carmen_py

    scans = [s for s in carmen_py.parse_carmen(path) if isinstance(s, carmen_py.CarmenScan)]
    n = len(scans)
    b = max((len(s.ranges) for s in scans), default=0)
    ranges = np.full((n, b), -1.0, np.float32)
    laser_pose = np.zeros((n, 3), np.float32)
    odom_pose = np.zeros((n, 3), np.float32)
    timestamp = np.zeros((n,), np.float64)
    meta = np.zeros((n, 4), np.float32)
    for k, s in enumerate(scans):
        ranges[k, : len(s.ranges)] = s.ranges
        laser_pose[k] = s.laser_pose
        odom_pose[k] = s.odom_pose
        timestamp[k] = s.timestamp
        meta[k] = (len(s.ranges), s.angle_min, s.fov, s.range_max)
    return {"ranges": ranges, "laser_pose": laser_pose, "odom_pose": odom_pose,
            "timestamp": timestamp, "meta": meta, "backend": "python"}
