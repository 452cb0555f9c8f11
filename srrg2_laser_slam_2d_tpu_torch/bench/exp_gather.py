"""Probe: a banded lane gather on the card, in two CUDA forms. Counterpart
of ``bench/exp_gather.py`` (a TPU probe of three Mosaic formulations of one
gather). Both compute

    out[f, k, b] = sum over ``iters`` passes of canvas[f, k, idx[k, b]]

for canvas [8, K, B] float32 and idx = clip(lane + delta, 0, B - 1),
|delta| <= S, B = 768, S = 64, from numpy's generator seeded 0 as in the
TPU probe. Both forms stage each canvas row in shared memory once (the
TPU probe's canvas sits in VMEM); ``direct`` gathers the lane's cell from it
in every pass, ``roll`` reads all 2S + 1 shifted lanes in every pass and
keeps the one whose shift is idx - lane. The CUDA kernel is
``csrc/gather_probe_kernel.cu``; ``gather_probe_plain`` is its plain PyTorch
version. Each run checks against numpy (``take_along_axis`` times
``iters``) and prints the error and the best time of 20 host-timed calls,
as the TPU probe does.

Usage (the CUDA card by default; without one it raises):
  python -m srrg2_laser_slam_2d_tpu_torch.bench.exp_gather [--forms direct,roll]
      [--ks 8,32] [--iters 10] [--device cuda]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .._device import resolve_device
from ..ops import _cuda

# launches of the CUDA kernel (reset by callers that count a run)
launches = 0
B = 768
S = 64
FORMS = ("direct", "roll")
# canvas, idx, out, K, B, shift, iterations, form, stream
GATHER_PROBE = _cuda.Entry("gather_probe_kernel", "gather_probe",
                           [_cuda.PTR] * 3 + [_cuda.INT] * 5 + [_cuda.PTR])
# K, B, shift, form, stream: an empty kernel at the probe's launch shape
GATHER_PROBE_FLOOR = _cuda.Entry("gather_probe_kernel", "gather_probe_floor",
                                 [_cuda.INT] * 4 + [_cuda.PTR])


def make_inputs(K: int, device, lanes: int = B, shift: int = S):
    """(canvas [8, K, B] float32, idx [K, B] int32) as the TPU probe draws
    them."""
    rng = np.random.default_rng(0)
    canvas = rng.normal(size=(8, K, lanes)).astype(np.float32)
    delta = rng.integers(-shift, shift + 1, size=(K, lanes)).astype(np.int32)
    idx = np.clip(np.arange(lanes, dtype=np.int32)[None, :] + delta, 0, lanes - 1)
    return torch.from_numpy(canvas).to(device), torch.from_numpy(idx).to(device)


def reference(canvas: np.ndarray, idx: np.ndarray, iters: int) -> np.ndarray:
    """The TPU probe's numpy check."""
    return np.stack([np.take_along_axis(canvas[f], idx, axis=1) for f in range(8)]) * iters


def gather_probe_plain(canvas: torch.Tensor, idx: torch.Tensor, iters: int) -> torch.Tensor:
    """Plain PyTorch version of ``gather_probe`` (either form)."""
    g = torch.gather(canvas, 2, idx.to(torch.int64)[None].expand(canvas.shape))
    acc = torch.zeros_like(canvas)
    for _ in range(iters):
        acc = acc + g
    return acc


def gather_probe(canvas: torch.Tensor, idx: torch.Tensor, iters: int = 10,
                 form: str = "direct", shift: int = S) -> torch.Tensor:
    """canvas [8, K, B] float32, idx [K, B] int32 (within +-``shift`` of
    each lane) -> out [8, K, B]. CUDA tensors launch the kernel; CPU tensors
    take the plain version."""
    global launches
    if form not in FORMS:
        raise ValueError(f"form must be one of {FORMS}")
    if not _cuda.on_card(canvas):
        return gather_probe_plain(canvas, idx, iters)
    _, K, lanes = canvas.shape
    _check_lanes(lanes)
    _cuda.check_tensor("canvas", canvas, (8, K, lanes), canvas.device)
    _cuda.check_aligned("canvas", canvas)
    if idx.dtype != torch.int32 or tuple(idx.shape) != (K, lanes) or idx.device != canvas.device:
        raise ValueError(f"idx: need an int32 ({K}, {lanes}) tensor on {canvas.device}")
    out = torch.empty_like(canvas)
    GATHER_PROBE(canvas.device, canvas.data_ptr(), idx.contiguous().data_ptr(), out.data_ptr(),
                 K, lanes, int(shift), int(iters), FORMS.index(form))
    launches += 1
    return out


def _check_lanes(lanes: int) -> None:
    """The kernel runs one thread a lane and stages each row with one bulk
    copy in 16-byte pieces."""
    if lanes > 1024 or lanes % 4:
        raise ValueError(f"{lanes} lanes: the kernel takes a multiple of 4, at most 1024")


def empty_launch(K: int, lanes: int = B, shift: int = S, form: str = "direct",
                 device=None) -> None:
    """One launch of an empty kernel at the probe's grid, block and shared
    memory (not counted in ``launches``): the floor under its device time."""
    _check_lanes(lanes)
    GATHER_PROBE_FLOOR(torch.device(device or "cuda"), K, lanes, int(shift), FORMS.index(form))


def bytes_moved(K: int, lanes: int = B) -> int:
    """Each input read once, the output written once."""
    return 4 * (2 * 8 * K * lanes + K * lanes)


def flops(K: int, iters: int, lanes: int = B) -> int:
    return 8 * K * lanes * iters


def run(form: str, K: int, iters: int = 10, device=None) -> dict:
    """One form at one K: the error against numpy and the best of 20
    host-timed calls (each synchronised)."""
    device = resolve_device(device)
    canvas, idx = make_inputs(K, device)
    out = gather_probe(canvas, idx, iters, form)
    err = float(np.abs(out.cpu().numpy()
                       - reference(canvas.cpu().numpy(), idx.cpu().numpy(), iters)).max())
    best = float("inf")
    for _ in range(20):
        t0 = time.perf_counter()
        gather_probe(canvas, idx, iters, form)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        best = min(best, time.perf_counter() - t0)
    print(f"{form:8s} K={K:3d} iters={iters} err={err:.2e} best={best * 1e6:.1f}us", flush=True)
    return {"form": form, "k": K, "iters": iters, "err": err, "best_us": best * 1e6}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--forms", default=",".join(FORMS))
    ap.add_argument("--ks", default="8,32")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    for k in [int(x) for x in args.ks.split(",")]:
        for form in args.forms.split(","):
            run(form, k, args.iters, args.device)


if __name__ == "__main__":
    main()
