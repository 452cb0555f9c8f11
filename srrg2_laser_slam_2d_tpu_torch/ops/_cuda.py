"""Build, load and launch the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface (the beam-space kernels
share the device functions of ``csrc/frame_common.cuh``) and is compiled by ``nvcc``
into ``build/torch_kernels/lib<name>.so`` at the repository root, then
loaded with ``ctypes``. Each wrapper module declares the C entry points it
calls as ``Entry`` objects beside its parameter struct's mirror; calling
one is the whole host side of a launch. A wrapper takes its route by
``on_card``: CPU tensors take the plain version, CUDA tensors the kernel.
A build takes seconds; nothing is built at import time. The C entry points
return a ``cudaError_t`` (0 = success).
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
KERNELS = tuple(sorted(p.stem for p in CSRC.glob("*.cu")))

# --fmad=false: no multiply-add contraction, so the kernels round each
# operation as the plain PyTorch versions do (one kernel per operation)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "--fmad=false", "-Xptxas", "-v"]

# the C types of the entry points' parameters (PTR: a device or host address)
PTR = ctypes.c_void_p
INT = ctypes.c_int
FLOAT = ctypes.c_float
_LIBS: dict[str, ctypes.CDLL] = {}      # by path
# every declaration that loads from the package's build (``use_build``)
ENTRIES: list[Entry] = []


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


def _load(name: str, path: Path | None) -> ctypes.CDLL:
    """The library at ``path``, loaded once; None is the package's own,
    built first if missing or stale."""
    own = path is None
    path = str(library_path(name) if own else path)
    lib = _LIBS.get(path)
    if lib is None:
        if own and _stale(name):
            build([name])
        lib = _LIBS[path] = ctypes.CDLL(path)
    return lib


class Entry:
    """One C entry point of ``csrc/<lib>.cu``: its name and the types of
    all its parameters, the last of them the stream unless ``stream`` is
    False. ``entry(device, *args)`` calls it with ``args`` and ``device``'s
    current stream: the library is loaded (built if need be) at the first
    call and the function handle kept; the device guard is entered only
    when ``device`` is not the current one; a non-zero return (a
    ``cudaError_t``) raises RuntimeError."""

    def __init__(self, lib: str, fn: str, argtypes, stream: bool = True,
                 path: Path | None = None):
        self.lib, self.fn, self.argtypes, self.stream = lib, fn, tuple(argtypes), stream
        self.path = path
        self._handle = None
        if path is None:
            ENTRIES.append(self)

    def bind(self, path) -> Entry:
        """The same entry point in the library at ``path`` (another build)."""
        return Entry(self.lib, self.fn, self.argtypes, self.stream, Path(path))

    def _resolve(self):
        if self._handle is None:
            h = _load(self.lib, self.path)[self.fn]
            h.argtypes, h.restype = self.argtypes, ctypes.c_int
            self._handle = h
        return self._handle

    def __call__(self, device: torch.device, *args) -> None:
        fn = self._resolve()
        if self.stream:
            args += (torch.cuda.current_stream(device).cuda_stream,)
        if device.index in (None, torch.cuda.current_device()):
            err = fn(*args)
        else:
            with torch.cuda.device(device):
                err = fn(*args)
        if err != 0:
            raise RuntimeError(f"{self.lib}.{self.fn} launch failed: {error_string(err)}")


def use_build(csrc, build_dir) -> None:
    """Take the kernels from the libraries built from ``csrc`` into
    ``build_dir``: every declaration not bound to a path of its own loads
    from there at its next call."""
    global CSRC, BUILD_DIR
    CSRC, BUILD_DIR = Path(csrc), Path(build_dir)
    for entry in ENTRIES:
        entry._handle = None


def on_card(t: torch.Tensor) -> bool:
    """Whether a wrapper launches its kernel for ``t``: True on a CUDA
    device, False on the CPU (the plain version); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type != "cpu":
        raise ValueError(f"unsupported device {t.device}")
    return False


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


def error_string(code: int) -> str:
    """``code (cudaGetErrorString(code))``, from PyTorch's CUDA runtime."""
    rt = torch.cuda.cudart()
    return f"{code} ({rt.cudaGetErrorString(rt.cudaError(code))})"
