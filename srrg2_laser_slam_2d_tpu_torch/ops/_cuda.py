"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface (the frame kernels share
the device functions of ``csrc/frame_common.cuh``) and is compiled by ``nvcc``
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
KERNELS = ("frame_kernel", "nn_icp_kernel", "stream_kernel")

# --fmad=false: no multiply-add contraction, so the kernels round each
# operation as the plain PyTorch versions do (one kernel per operation)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "--fmad=false", "-Xptxas", "-v"]

_VOID = ctypes.c_void_p
_SIGNATURES = {
    "frame_kernel": {"frame_track_grid": [_VOID] * 6 + [ctypes.c_void_p, _VOID]},
    "nn_icp_kernel": {"nn_icp_align_pairs": [_VOID] * 5 + [ctypes.c_void_p, _VOID]},
    "stream_kernel": {"stream_track_grid": [_VOID] * 7 + [ctypes.c_void_p, _VOID]},
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


def build(names=KERNELS, force: bool = False) -> dict[str, str]:
    """Compile the named kernels, one ``nvcc`` per source, all started
    together. Returns each compiler's output (register and shared-memory
    use from ``-Xptxas -v``); raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        if not force and not _stale(name):
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(name)
            os.unlink(tmp)
        else:
            os.replace(tmp, library_path(name))   # atomic for concurrent users
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded kernel library, built first if missing or stale."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    if _stale(name):
        build([name])
    lib = ctypes.CDLL(str(library_path(name)))
    for fn, argtypes in _SIGNATURES[name].items():
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


def error_string(code: int) -> str:
    """cudaGetErrorString of a returned error code."""
    lib = load("frame_kernel")
    lib.kernel_error_string.restype = ctypes.c_char_p
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    return f"{code} ({lib.kernel_error_string(code).decode()})"
