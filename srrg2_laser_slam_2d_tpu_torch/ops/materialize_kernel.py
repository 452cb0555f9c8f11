"""Scene materialization as one kernel: fold [..., T, 8, B] frame payloads
into their scenes, for each scene row the last write (highest frame, then
highest lane) winning, the first ``final_count`` rows valid.

The JAX package's ``models/fast_tracker.materialize`` is XLA code (two sorts
and one scatter), not a Pallas kernel; ``materialize_plain`` is the port's
plain PyTorch version of it. On the card ``csrc/materialize_kernel.cu``
reads payload rows 4 and 5 once through the payload's strides (the fleet's
``movedim`` view of the kernel layout is not copied), picks each row's
winner with a 32-bit ``atomicMax`` on a shared-memory table, and writes the
new scene from the winners' rows 0-3 or the old scene: the same floats as
the plain version, bit for bit. With at least half as many scenes as the
card has SMs one block takes each scene (one launch); with fewer, each
scene's lanes are split over several blocks and a second launch writes the
rows (``blocks_per_scene``).
"""

from __future__ import annotations

import ctypes
from collections import Counter

import torch

from ..utils.cloud import Cloud
from . import _cuda

# launches of the CUDA kernels (reset by callers that count a run): one a
# call with one block a scene, two with the lanes split
launches = 0
# calls that launched the kernel, by (scenes, frames)
calls: Counter = Counter()
# the winner key t * B + b is a 32-bit int
MAX_LANES = 2 ** 31
# the shared-memory table of cap int32 entries fits in 227 KB
MAX_CAPACITY = 56 * 1024
# the fewest lanes a block takes when a scene's lanes are split
MIN_BLOCK_LANES = 8 * 1024


class _MaterializeParams(ctypes.Structure):
    """Mirror of ``MaterializeParams`` in csrc/materialize_kernel.cu."""

    _fields_ = [("pay_stride", ctypes.c_longlong * 4), ("xy_stride", ctypes.c_longlong * 3),
                ("nm_stride", ctypes.c_longlong * 3), ("count_stride", ctypes.c_longlong),
                ("S", ctypes.c_int), ("T", ctypes.c_int), ("B", ctypes.c_int),
                ("cap", ctypes.c_int), ("blocks_per_scene", ctypes.c_int),
                ("count_dtype", ctypes.c_int)]


# payload, old xy, old normal, counts, three outputs, partial table, params, stream
MATERIALIZE_SCENES = _cuda.Entry("materialize_kernel", "materialize_scenes", [_cuda.PTR] * 10)


def materialize_plain(spec, scene: Cloud, payloads: torch.Tensor, final_count) -> Cloud:
    """Plain PyTorch version of ``materialize``."""
    lead = payloads.shape[:-3]
    T, _, B = payloads.shape[-3:]
    cap = spec.scene_capacity
    dev = payloads.device
    P = payloads.reshape((-1, T, 8, B))
    S_ = P.shape[0]
    rows = P[:, :, 4, :].to(torch.int64).reshape(S_, T * B)
    kind = P[:, :, 5, :].reshape(S_, T * B)
    live = (kind > 0) & (rows >= 0) & (rows < cap)
    flat = torch.arange(T * B, device=dev).expand(S_, -1)
    win = torch.full((S_, cap + 1), -1, dtype=torch.int64, device=dev).scatter_reduce(
        1, torch.where(live, rows, torch.full_like(rows, cap)),
        torch.where(live, flat, torch.full_like(flat, -1)), "amax")[:, :cap]
    has = (win >= 0)[..., None]
    vals = P[:, :, 0:4, :].permute(0, 1, 3, 2).reshape(S_, T * B, 4)
    picked = torch.gather(vals, 1, win.clamp(min=0)[..., None].expand(S_, cap, 4))
    xy0 = scene.xy.reshape(S_, cap, 2)
    nm0 = scene.normal.reshape(S_, cap, 2)
    xy = torch.where(has, picked[..., 0:2], xy0)
    nm = torch.where(has, picked[..., 2:4], nm0)
    counts = torch.as_tensor(final_count, device=dev).to(torch.int64).reshape(S_, 1)
    valid = torch.arange(cap, device=dev) < counts
    return Cloud(xy.reshape(lead + (cap, 2)), nm.reshape(lead + (cap, 2)),
                 valid.reshape(lead + (cap,)))


def blocks_per_scene(scenes: int, lanes: int, sms: int) -> int:
    """Blocks that share one scene's lanes: one when the scenes alone fill
    at least half the SMs or a scene has few lanes; else enough for about
    two blocks an SM, each taking at least ``MIN_BLOCK_LANES`` lanes."""
    if 2 * scenes >= sms:
        return 1
    return max(1, min(-(-2 * sms // scenes), lanes // MIN_BLOCK_LANES))


def materialize(spec, scene: Cloud, payloads: torch.Tensor, final_count) -> Cloud:
    """Fold [..., T, 8, B] payloads into scenes [..., cap, ...]: for each
    scene row the last write (highest frame, then highest lane) wins; the
    first ``final_count`` rows are valid. Leading dimensions batch scenes.
    CUDA tensors launch the kernel; CPU tensors take the plain version.
    Neither writes to its inputs."""
    global launches
    dev = payloads.device
    if not _cuda.on_card(payloads):
        return materialize_plain(spec, scene, payloads, final_count)
    lead = payloads.shape[:-3]
    T, C, B = payloads.shape[-3:]
    if payloads.dtype != torch.float32 or C != 8:
        raise ValueError(f"payloads: need float32 [..., T, 8, B], got {payloads.dtype} "
                         f"{tuple(payloads.shape)}")
    cap = spec.scene_capacity
    P = payloads.reshape((-1, T, 8, B))
    S = P.shape[0]
    if T * B >= MAX_LANES:
        raise ValueError(f"{T} frames x {B} lanes: the kernel keys lanes in 32 bits "
                         f"(T * B < {MAX_LANES})")
    if cap > MAX_CAPACITY:
        raise ValueError(f"scene capacity {cap}: the kernel holds at most {MAX_CAPACITY} rows")
    xy0 = scene.xy.reshape(S, cap, 2)
    nm0 = scene.normal.reshape(S, cap, 2)
    for name, t in (("scene.xy", xy0), ("scene.normal", nm0)):
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"{name}: need float32 on {dev}, got {t.dtype} on {t.device}")
    # the kernel reads float32 counts as they are (the fleet's pB[:, 7]) and
    # truncates them as .to(torch.int64) does; other types are cast first
    counts = torch.as_tensor(final_count, device=dev)
    if counts.dtype != torch.float32:
        counts = counts.to(torch.int64)
    counts = counts.reshape(S)
    G = blocks_per_scene(S, T * B, torch.cuda.get_device_properties(dev).multi_processor_count)
    xy = torch.empty((S, cap, 2), dtype=torch.float32, device=dev)
    nm = torch.empty((S, cap, 2), dtype=torch.float32, device=dev)
    valid = torch.empty((S, cap), dtype=torch.bool, device=dev)
    partial = torch.empty((S, G, cap), dtype=torch.int32, device=dev) if G > 1 else None
    params = _MaterializeParams(
        pay_stride=(ctypes.c_longlong * 4)(*P.stride()),
        xy_stride=(ctypes.c_longlong * 3)(*xy0.stride()),
        nm_stride=(ctypes.c_longlong * 3)(*nm0.stride()),
        count_stride=counts.stride(0), S=S, T=T, B=B, cap=cap, blocks_per_scene=G,
        count_dtype=0 if counts.dtype == torch.float32 else 1)
    MATERIALIZE_SCENES(dev, P.data_ptr(), xy0.data_ptr(), nm0.data_ptr(), counts.data_ptr(),
                       xy.data_ptr(), nm.data_ptr(), valid.data_ptr(),
                       0 if partial is None else partial.data_ptr(), ctypes.addressof(params))
    launches += 1 if G == 1 else 2
    calls[(S, T)] += 1
    return Cloud(xy.reshape(lead + (cap, 2)), nm.reshape(lead + (cap, 2)),
                 valid.reshape(lead + (cap,)))
