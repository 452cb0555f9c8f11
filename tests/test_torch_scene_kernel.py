"""The scene canvas of the port (ops/scene_kernel.py) against the JAX
package's Pallas scene kernels in interpret mode: ``canvas``, the tie rule
of the chunked z-buffer, and the clip and merge built on the canvas.
Inputs come from numpy with a seed.

Tolerances: winner rows are equal; depths and fields agree to 2e-6 (XLA
fuses multiply-adds in the camera transform); merged scenes to 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srrg2_laser_slam_2d_tpu.ops import pallas_scene as jps
from srrg2_laser_slam_2d_tpu.ops.projector import PolarProjection as JProjection
from srrg2_laser_slam_2d_tpu.utils.cloud import Cloud as JCloud
from srrg2_laser_slam_2d_tpu_torch.ops import scene_kernel as sk
from srrg2_laser_slam_2d_tpu_torch.ops.projector import PolarProjection
from srrg2_laser_slam_2d_tpu_torch.utils.cloud import Cloud

COLS = 200
JP = JProjection.make(cols=COLS, angle_min=-np.pi, angle_max=np.pi, range_min=0.3,
                      range_max=20.0)
TP = PolarProjection(*JP)
CAM = np.array([0.3, -0.2, 0.4], np.float32)


def _arrays(seed: int, n: int, live: int | None = None):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-6, 6, (n, 2)).astype(np.float32)
    nm = rng.normal(size=(n, 2)).astype(np.float32)
    nm /= np.linalg.norm(nm, axis=1, keepdims=True)
    valid = rng.uniform(size=n) > 0.1 if live is None else np.arange(n) < live
    return xy, nm, valid


def _both(xy, nm, valid):
    return (JCloud(jnp.asarray(xy), jnp.asarray(nm), jnp.asarray(valid)),
            Cloud(torch.from_numpy(xy), torch.from_numpy(nm), torch.from_numpy(valid)))


@pytest.mark.parametrize("seed,n,chunk", [(0, 600, 256), (1, 512, 1024), (2, 900, 128)])
def test_canvas_plain_matches_pallas_interpret(seed, n, chunk):
    jc, tc = _both(*_arrays(seed, n))
    jo, jr = jps.canvas_pallas(JP, jc, jnp.asarray(CAM), chunk=chunk, interpret=True)
    before = sk.launches
    to, tr = sk.canvas(TP, tc, torch.from_numpy(CAM), chunk=chunk)
    assert sk.launches == before          # a CPU tensor takes the plain version
    assert int((tr >= 0).sum()) > 50
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=2e-6)


@pytest.mark.parametrize("n,chunk", [(2100, 1024), (1500, 256)])
def test_canvas_returns_int64_rows_equal_to_pallas(n, chunk):
    """``canvas`` returns int64 winner rows (the kernel writes them so),
    equal to ``canvas_pallas`` on scenes of more than 1,024 rows, the sizes
    the kernel spreads over a cluster."""
    jc, tc = _both(*_arrays(7 + n, n))
    jo, jr = jps.canvas_pallas(JP, jc, jnp.asarray(CAM), chunk=chunk, interpret=True)
    to, tr = sk.canvas(TP, tc, torch.from_numpy(CAM), chunk=chunk)
    assert tr.dtype == torch.int64 and tr.shape == (sk.cols_padded(TP),)
    assert int((tr >= 0).sum()) > 100 and int(tr.max()) >= 1024
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=2e-6)


def _tied_cloud(second_row: int, n: int = 64):
    """Rows 3 and ``second_row`` lie at the same depth on beam 100 (seen
    from the identity camera) with different normals; row 7 lies behind."""
    ang = (100.5 - JP.c) / JP.f
    ray = np.array([np.cos(ang), np.sin(ang)], np.float32)
    xy = np.zeros((n, 2), np.float32)
    nm = np.zeros((n, 2), np.float32)
    valid = np.zeros(n, bool)
    for row, depth, normal in ((3, 2.0, (1.0, 0.0)), (second_row, 2.0, (0.0, 1.0)),
                               (7, 4.0, (1.0, 0.0))):
        xy[row], nm[row], valid[row] = depth * ray, normal, True
    return xy, nm, valid


@pytest.mark.parametrize("second_row,expected_normal", [
    (5, (0.5, 0.5)),      # the same chunk: the tied points are averaged
    (40, (1.0, 0.0)),     # a later chunk: the earlier chunk keeps the beam
])
def test_tie_rule_average_inside_a_chunk_earlier_chunk_wins(second_row, expected_normal):
    jc, tc = _both(*_tied_cloud(second_row))
    cam = np.zeros(3, np.float32)
    to, tr = sk.canvas(TP, tc, torch.from_numpy(cam), chunk=16)
    jo, jr = jps.canvas_pallas(JP, jc, jnp.asarray(cam), chunk=16, interpret=True)
    assert int(tr[100]) == int(jr[100]) == 3          # the lowest row at the minimum
    assert int((tr >= 0).sum()) == 1
    np.testing.assert_allclose(to[3:5, 100].numpy(), expected_normal, atol=1e-6)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-6)
    assert float(to[0, 100]) == pytest.approx(2.0, abs=1e-6)


def test_clip_projective_matches_pallas_interpret():
    jc, tc = _both(*_arrays(3, 512))
    X = np.array([0.2, 0.1, -0.3], np.float32)
    S = np.array([0.1, 0.0, 0.05], np.float32)
    j = jps.clip_projective_pallas(JP, jc, jnp.asarray(X), jnp.asarray(S), chunk=256,
                                   interpret=True)
    t = sk.clip_projective(TP, tc, torch.from_numpy(X), torch.from_numpy(S), chunk=256)
    assert t.capacity == 256              # one row per PADDED beam
    np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))
    np.testing.assert_allclose(t.xy.numpy(), np.asarray(j.xy), atol=2e-6)
    np.testing.assert_allclose(t.normal.numpy(), np.asarray(j.normal), atol=2e-6)


@pytest.mark.parametrize("live", [300, 505])      # room to append; nearly full
def test_merge_projective_matches_pallas_interpret(live):
    """The merge on two canvases: merged, replaced and appended rows and the
    post-merge canvas; with a nearly full scene the appends that do not fit
    are dropped on both sides."""
    js, ts = _both(*_arrays(4, 512, live=live))
    mxy, mnm, mvalid = _arrays(5, 256)
    jm, tm = _both(mxy * 0.9, mnm, mvalid)
    pose = np.array([0.1, -0.05, 0.2], np.float32)
    jscene, jcanvas = jps.merge_projective_pallas(JP, js, jm, jnp.asarray(pose), chunk=256,
                                                  interpret=True, return_canvas=True)
    tscene, tcanvas = sk.merge_projective(TP, ts, tm, torch.from_numpy(pose), chunk=256,
                                          return_canvas=True)
    np.testing.assert_array_equal(tscene.valid.numpy(), np.asarray(jscene.valid))
    assert int(tscene.valid.sum()) > live
    v = np.asarray(jscene.valid)
    np.testing.assert_allclose(tscene.xy.numpy()[v], np.asarray(jscene.xy)[v], atol=1e-5)
    np.testing.assert_allclose(tscene.normal.numpy()[v], np.asarray(jscene.normal)[v], atol=1e-5)
    np.testing.assert_array_equal(tcanvas.valid.numpy(), np.asarray(jcanvas.valid))
    cv = np.asarray(jcanvas.valid)
    np.testing.assert_allclose(tcanvas.xy.numpy()[cv], np.asarray(jcanvas.xy)[cv], atol=1e-5)
    only_scene = sk.merge_projective(TP, ts, tm, torch.from_numpy(pose), chunk=256)
    assert torch.equal(only_scene.xy, tscene.xy)


def test_wrapper_refuses_a_device_that_is_neither_cpu_nor_cuda():
    _, tc = _both(*_arrays(6, 64))
    with pytest.raises(ValueError):
        sk.canvas(TP, tc.to("meta"), torch.zeros(3, device="meta"))
