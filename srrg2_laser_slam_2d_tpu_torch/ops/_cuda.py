"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface (the beam-space kernels
share the device functions of ``csrc/frame_common.cuh``) and is compiled by ``nvcc``
into ``build/torch_kernels/lib<name>.so`` at the repository root, then
loaded with ``ctypes``. A build takes seconds; nothing here runs at import
time. The C entry points return a ``cudaError_t`` (0 = success).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
KERNELS = ("frame_kernel", "nn_icp_kernel", "stream_kernel", "projector_kernel",
           "scene_kernel", "banded_align_kernel", "projective_align_kernel",
           "multicue_align_kernel", "beam_zbuffer_kernel", "gather_probe_kernel",
           "materialize_kernel")

# --fmad=false: no multiply-add contraction, so the kernels round each
# operation as the plain PyTorch versions do (one kernel per operation)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "--fmad=false", "-Xptxas", "-v"]

_VOID = ctypes.c_void_p
_INT = ctypes.c_int
_FLOAT = ctypes.c_float
# (cloud xy, normal, valid, rows) twice, t0, prior, three outputs, params, stream
_ALIGN_ARGS = ([_VOID] * 3 + [_INT]) * 2 + [_VOID] * 7
_SIGNATURES = {
    "frame_kernel": {"frame_track_grid": [_VOID] * 6 + [ctypes.c_void_p, _VOID],
                     # terms, out, threads, stream (the reduction alone, for tests)
                     "frame_block_sum13": [_VOID, _VOID, _INT, _VOID]},
    "nn_icp_kernel": {"nn_icp_align_pairs": [_VOID] * 5 + [ctypes.c_void_p, _VOID]},
    "stream_kernel": {"stream_track_grid": [_VOID] * 7 + [ctypes.c_void_p, _VOID]},
    "projector_kernel": {"project_local": [_VOID] * 7},
    "scene_kernel": {"scene_canvas": [_VOID] * 8},
    "banded_align_kernel": {"banded_align": _ALIGN_ARGS},
    "projective_align_kernel": {"projective_align": _ALIGN_ARGS},
    # fixed (xy, normal, valid, cues, rows), moving (xy, normal, valid, rows), t0,
    # prior, extrinsics, three outputs, params, damping, min_corr, stream
    "multicue_align_kernel": {"multicue_align": [_VOID] * 3 + [_INT] * 2 + [_VOID] * 3 + [_INT]
                              + [_VOID] * 7 + [_FLOAT] * 2 + [_VOID],
                              # terms, cues, out, threads, stream (the reduction alone)
                              "multicue_block_sums_test": [_VOID, _INT, _VOID, _INT, _VOID]},
    # geoT, out, B, cols, f, c, range_min, range_max, max_shift, stream
    "beam_zbuffer_kernel": {"beam_zbuffer": [_VOID] * 2 + [_INT] * 2 + [_FLOAT] * 4
                            + [_INT, _VOID],
                            # B, stream (an empty kernel at the probe's launch shape)
                            "beam_zbuffer_floor": [_INT, _VOID]},
    # canvas, idx, out, K, B, shift, iterations, form, stream
    "gather_probe_kernel": {"gather_probe": [_VOID] * 3 + [_INT] * 5 + [_VOID],
                            # K, B, shift, form, stream (an empty kernel at its launch shape)
                            "gather_probe_floor": [_INT] * 4 + [_VOID]},
    # payload, old xy, old normal, counts, three outputs, partial table, params, stream
    "materialize_kernel": {"materialize_scenes": [_VOID] * 8 + [ctypes.c_void_p, _VOID]},
}
_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("CUDA toolkit not found (set CUDA_HOME)")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = library_path(name)
    if not lib.exists():
        return True
    newest = max(p.stat().st_mtime for p in CSRC.glob("*.cu*"))
    return lib.stat().st_mtime < newest


def compile_all(jobs) -> dict[str, str]:
    """Run one ``nvcc`` per job, all started together. A job is (key,
    source, library, extra flags); each library is replaced atomically once
    its build succeeds. Returns each compiler's output (register and
    shared-memory use from ``-Xptxas -v``); raises if any build fails."""
    nvcc = _nvcc()
    procs = {}
    for key, src, lib, extra in jobs:
        lib.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib.parent)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-o", tmp, str(src)]
        procs[key] = (tmp, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for key, (tmp, lib, proc) in procs.items():
        out, _ = proc.communicate()
        logs[key] = out
        if proc.returncode != 0:
            failed.append(key)
            os.unlink(tmp)
        else:
            os.replace(tmp, lib)   # atomic for concurrent users
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[k] for k in failed))
    return logs


def build(names=KERNELS, force: bool = False) -> dict[str, str]:
    """Compile the named kernels into ``BUILD_DIR`` (``compile_all``)."""
    return compile_all([(name, CSRC / f"{name}.cu", library_path(name), ())
                        for name in names if force or _stale(name)])


def load(name: str) -> ctypes.CDLL:
    """The loaded kernel library, built first if missing or stale."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    if _stale(name):
        build([name])
    lib = ctypes.CDLL(str(library_path(name)))
    for fn, argtypes in _SIGNATURES[name].items():
        if not hasattr(lib, fn):   # an older source without a test entry point
            continue
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    _LIBS[name] = lib
    return lib


def check_tensor(name: str, t, shape: tuple, device) -> None:
    """Raise unless ``t`` is a contiguous float32 tensor of ``shape`` on
    ``device`` (what the kernels' C interfaces take)."""
    if t.device != device or t.dtype != torch.float32 or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous float32 {shape} tensor on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def check_aligned(name: str, t) -> None:
    """Raise unless ``t`` starts on a 16-byte boundary (the frame kernels
    copy their canvas rows in 16-byte pieces)."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel needs a 16-byte aligned tensor "
                         f"(storage offset {t.storage_offset()})")


def cloud_tensors(name: str, xy, normal, valid, device):
    """The fields of a cloud as the kernels take them: contiguous float32
    [N, 2] coordinates and normals and a contiguous bool [N] mask, all on
    ``device`` (no copy when they already are). ``normal`` may be None."""
    n = xy.shape[0]
    out = []
    for label, t, shape, dtype in ((f"{name}.xy", xy, (n, 2), torch.float32),
                                   (f"{name}.normal", normal, (n, 2), torch.float32),
                                   (f"{name}.valid", valid, (n,), torch.bool)):
        if t is None:
            out.append(None)
            continue
        if t.device != device or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{label}: need a {dtype} {shape} tensor on {device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        out.append(t.contiguous())
    return out


def stream_of(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def error_string(code: int) -> str:
    """cudaGetErrorString of a returned error code."""
    lib = load("frame_kernel")
    lib.kernel_error_string.restype = ctypes.c_char_p
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    return f"{code} ({lib.kernel_error_string(code).decode()})"
