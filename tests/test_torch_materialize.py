"""The port's scene materialization on the CPU
(``models/fast_tracker.materialize``, which takes
``ops/materialize_kernel.materialize_plain`` for CPU tensors) against the
JAX package's ``fast_tracker.materialize``, scene by scene, on payloads
made with numpy.

Both packages only choose values (the last write to a row wins: highest
frame, then highest lane), so points, normals and validity are EQUAL.
Rows that are NaN are left out here: the two frameworks cast NaN to an
integer differently, and the card test holds the kernel to the plain
version on them (``tests/test_torch_cuda_kernels.py``)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srrg2_laser_slam_2d_tpu.models import fast_tracker as jft
from srrg2_laser_slam_2d_tpu.utils.cloud import Cloud as JCloud
from srrg2_laser_slam_2d_tpu_torch.models import fast_tracker as tft
from srrg2_laser_slam_2d_tpu_torch.ops import materialize_kernel as mk
from srrg2_laser_slam_2d_tpu_torch.utils.cloud import Cloud

CAP, T, B = 64, 6, 16


@dataclasses.dataclass(frozen=True)
class _Spec:
    """What both ``materialize`` read of a frame spec (hashable: the JAX
    function takes it as a static argument)."""

    scene_capacity: int = CAP


SPEC = _Spec()


def _payloads(rng, lead: tuple, live: float = 0.5) -> np.ndarray:
    """[*lead, T, 8, B] payloads: rows over [-2, CAP + 2), so some lanes
    miss the scene and rows collide across frames and lanes."""
    pay = rng.standard_normal(lead + (T, 8, B)).astype(np.float32)
    pay[..., 4, :] = rng.integers(-2, CAP + 2, size=lead + (T, B))
    pay[..., 5, :] = (rng.random(lead + (T, B)) < live) * rng.integers(1, 3, size=lead + (T, B))
    return pay


def _scene(rng, lead: tuple) -> Cloud:
    return Cloud(torch.from_numpy(rng.standard_normal(lead + (CAP, 2)).astype(np.float32)),
                 torch.from_numpy(rng.standard_normal(lead + (CAP, 2)).astype(np.float32)),
                 torch.zeros(lead + (CAP,), dtype=torch.bool))


def _hold_to_jax(got: Cloud, scene: Cloud, payloads: np.ndarray, counts) -> None:
    """Each scene of ``got`` EQUAL to the JAX package's materialize of its
    own [T', 8, B] payloads (``payloads[k]``, or one array for one scene)
    and count."""
    S = int(np.prod(got.valid.shape[:-1], dtype=np.int64))
    xy, nm, valid = (x.reshape((S,) + x.shape[got.valid.dim() - 1:]).numpy() for x in got)
    xy0, nm0 = (x.reshape(S, CAP, 2).numpy() for x in (scene.xy, scene.normal))
    counts = np.asarray(counts, np.float32).reshape(S)
    for k in range(S):
        pay = payloads[k] if S > 1 or payloads.ndim == 4 else payloads
        want = jft.materialize(SPEC, JCloud(jnp.asarray(xy0[k]), jnp.asarray(nm0[k]),
                                            jnp.zeros(CAP, bool)),
                               jnp.asarray(pay), jnp.asarray(counts[k]))
        np.testing.assert_array_equal(valid[k], np.asarray(want.valid))
        np.testing.assert_array_equal(xy[k], np.asarray(want.xy))
        np.testing.assert_array_equal(nm[k], np.asarray(want.normal))


def test_fleet_strided_view_matches_jax():
    """The fleet hands in the K-stream kernel's [T, 8, K, B] payload as a
    ``movedim(2, 0)`` view and its counts as the column ``pB[:, 7]``."""
    rng = np.random.default_rng(0)
    K = 3
    base = np.ascontiguousarray(np.moveaxis(_payloads(rng, (K,)), 0, 2))    # [T, 8, K, B]
    payloads = torch.from_numpy(base).movedim(2, 0)
    assert not payloads.is_contiguous()
    pB = torch.zeros(K, 16)
    pB[:, 7] = torch.tensor([CAP / 2, 10.0, CAP])
    scene = _scene(rng, (K,))
    got = tft.materialize(SPEC, scene, payloads, pB[:, 7])
    assert got.xy.shape == (K, CAP, 2) and got.valid.shape == (K, CAP)
    _hold_to_jax(got, scene, np.moveaxis(base, 2, 0), pB[:, 7].numpy())


@pytest.mark.parametrize("writers", ["frames", "lanes"])
def test_last_write_wins(writers):
    """Row 5 written in frames 0, 2 and 4 by lane 3 (the frame 4 write
    wins), or by lanes 2, 9 and 11 of frame 1 (lane 11 wins); no other
    lane is live."""
    rng = np.random.default_rng(1)
    pay = _payloads(rng, (), live=0.0)
    hits = [(0, 3), (2, 3), (4, 3)] if writers == "frames" else [(1, 2), (1, 9), (1, 11)]
    for t, b in hits:
        pay[t, 4, b], pay[t, 5, b] = 5.0, 1.0
    scene = _scene(rng, ())
    got = tft.materialize(SPEC, scene, torch.from_numpy(pay), float(CAP))
    t, b = hits[-1]
    assert got.xy[5].tolist() == pay[t, 0:2, b].tolist()
    assert got.normal[5].tolist() == pay[t, 2:4, b].tolist()
    others = torch.arange(CAP) != 5
    assert torch.equal(got.xy[others], scene.xy[others])
    _hold_to_jax(got, scene, pay, float(CAP))


@pytest.mark.parametrize("row,written", [(-1.0, None), (float(CAP), None), (2.7, 2),
                                         (-0.5, 0), (CAP - 0.5, CAP - 1), (1e10, None),
                                         (-1e10, None)])
def test_edge_rows_match_jax(row, written):
    """One lane with kind > 0 targets ``row``: non-integer rows truncate
    toward zero (-0.5 writes row 0), rows outside [0, cap) write nothing.
    Lanes with kind 0 or below on a valid row write nothing either."""
    rng = np.random.default_rng(2)
    pay = _payloads(rng, (), live=0.0)
    pay[:, 4, :] = 9.0
    pay[:, 5, :] = 0.0
    pay[1, 5, 0] = -1.0
    pay[3, 4, 4], pay[3, 5, 4] = row, 2.0
    scene = _scene(rng, ())
    got = tft.materialize(SPEC, scene, torch.from_numpy(pay), 20.0)
    changed = (got.xy != scene.xy).any(-1).nonzero().flatten().tolist()
    assert changed == ([] if written is None else [written])
    _hold_to_jax(got, scene, pay, 20.0)


@pytest.mark.parametrize("form", ["float", "numpy", "tensor"])
def test_final_count_forms_match_jax(form):
    """``final_count`` as the corridor's first segment hands it (a Python
    float, one scene), as its fresh maps do (a numpy array), and as the
    fleet does (a tensor)."""
    rng = np.random.default_rng(3)
    lead = () if form == "float" else (2,)
    pay = _payloads(rng, lead)
    counts = np.array([37.0, 5.0], np.float32)[: 1 if form == "float" else 2]
    final_count = {"float": float(counts[0]), "numpy": counts,
                   "tensor": torch.from_numpy(counts)}[form]
    scene = _scene(rng, lead)
    got = tft.materialize(SPEC, scene, torch.from_numpy(pay), final_count)
    assert got.valid.reshape(-1, CAP).sum(-1).tolist() == counts.astype(int).tolist()
    _hold_to_jax(got, scene, pay, counts)


def test_padded_fresh_scenes_match_jax():
    """``ChunkedSlamRunner``'s fresh maps: segments of 6, 3 and 1 frames
    padded with dead (zero) frames into one batch over empty scenes, held to
    the JAX package's materialize of each unpadded segment."""
    rng = np.random.default_rng(4)
    lengths = (6, 3, 1)
    segs = [_payloads(rng, ())[:n] for n in lengths]
    seg = torch.zeros((len(lengths), T, 8, B))
    for k, s in enumerate(segs):
        seg[k, : len(s)] = torch.from_numpy(s)
    empty = Cloud(torch.zeros(3, CAP, 2), torch.zeros(3, CAP, 2),
                  torch.zeros(3, CAP, dtype=torch.bool))
    counts = np.array([30.0, 12.0, 4.0], np.float32)
    got = tft.materialize(SPEC, empty, seg, torch.as_tensor(counts))
    for k, s in enumerate(segs):
        one = Cloud(*(x[k] for x in got))
        _hold_to_jax(one, Cloud(*(x[k] for x in empty)), s, counts[k])


def test_cpu_tensors_launch_no_kernel():
    rng = np.random.default_rng(5)
    scene = _scene(rng, (2,))
    launches, calls = mk.launches, sum(mk.calls.values())
    tft.materialize(SPEC, scene, torch.from_numpy(_payloads(rng, (2,))), torch.tensor([3, 4]))
    assert mk.launches == launches and sum(mk.calls.values()) == calls


def test_other_devices_are_refused():
    pay = torch.zeros((T, 8, B), device="meta")
    scene = Cloud(*(torch.zeros(s, device="meta") for s in ((CAP, 2), (CAP, 2), (CAP,))))
    with pytest.raises(ValueError, match="unsupported device"):
        mk.materialize(SPEC, scene, pay, 1.0)


@pytest.mark.parametrize("scenes,lanes,blocks", [
    (128, 255 * 768, 1),      # the fleet's K = 128: one block a scene, one launch
    (66, 255 * 768, 1),       # half the SMs
    (65, 255 * 768, 5),
    (8, 255 * 768, 23),       # K = 8: the lanes split, two launches
    (1, 1024 * 768, 96),      # the corridor's chunk
    (1, 768, 1)])             # FastTracker.flush: T = 1
def test_blocks_per_scene_follows_the_scenes(scenes, lanes, blocks):
    """The grid adapts to the number of scenes on a 132-SM card."""
    assert mk.blocks_per_scene(scenes, lanes, 132) == blocks
