"""The port's corridor world (``bench/synthetic.py``: ``CorridorConfig`` to
``simulate_corridors``) and ``synthetic_scene_generator --world corridors``
against the JAX package, on ``CorridorConfig(num_beams=361)`` (the CPU-sized
variant of ``tests/test_corridor_bench.py``).

Tolerances: the world, the drive and the segments are numpy in float64 in
both packages and EQUAL; the ray cast is the same float32 numpy loop on the
CPU, so the 160-frame ranges agree to 1e-5 (they are equal) and the hit
pattern is equal; the batched torch form of the ray cast (what a CUDA
device runs) agrees with the numpy loop to 1e-5 with the same hits; the
first scan's preprocessed point counts are equal (267)."""

import json

import numpy as np
import pytest
import torch

from srrg2_laser_slam_2d_tpu.apps import synthetic_scene_generator as jgen
from srrg2_laser_slam_2d_tpu.bench import synthetic as J
from srrg2_laser_slam_2d_tpu.models.preprocessor import LaserModel as JLaserModel
from srrg2_laser_slam_2d_tpu.models.preprocessor import PreprocessorConfig as JPC
from srrg2_laser_slam_2d_tpu.models.preprocessor import ScanPreprocessor as JPre
from srrg2_laser_slam_2d_tpu_torch.apps import synthetic_scene_generator as tgen
from srrg2_laser_slam_2d_tpu_torch.bench import synthetic as T
from srrg2_laser_slam_2d_tpu_torch.models.preprocessor import (LaserModel, PreprocessorConfig,
                                                               ScanPreprocessor)
from srrg2_laser_slam_2d_tpu_torch.ops import projector as tproj

JCFG = J.CorridorConfig(num_beams=361)
TCFG = T.CorridorConfig(num_beams=361)
SLICE = 160


@pytest.fixture(scope="module")
def slices():
    """The first 160 frames of the corridor dataset in each package."""
    gt = J.corridor_trajectory(JCFG)[:SLICE]
    return J.simulate_corridors(JCFG, poses=gt), T.simulate_corridors(TCFG, poses=gt,
                                                                      device="cpu")


def test_config_and_centerlines_match_jax():
    from dataclasses import asdict
    assert asdict(TCFG) == asdict(JCFG)
    for (ta, tb), (ja, jb) in zip(T.corridor_centerlines(TCFG), J.corridor_centerlines(JCFG),
                                  strict=True):
        np.testing.assert_array_equal(ta, ja)
        np.testing.assert_array_equal(tb, jb)
    assert T.corridor_waypoints(TCFG) == J.corridor_waypoints(JCFG)


def test_seg_distance_matches_jax():
    p = np.random.default_rng(3).uniform(-5.0, 60.0, size=(200, 2))
    for a, b in J.corridor_centerlines(JCFG):
        np.testing.assert_array_equal(T._seg_distance(p, a, b), J._seg_distance(p, a, b))
    # a degenerate segment is a point
    a = np.array([1.0, 2.0])
    np.testing.assert_array_equal(T._seg_distance(p, a, a), J._seg_distance(p, a, a))


def test_corridor_geometry_and_world_match_jax():
    jc, ja, jb = J.corridor_geometry(JCFG)
    tc, ta, tb = T.corridor_geometry(TCFG)
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_array_equal(tb, jb)
    assert ta.dtype == np.float32 and len(ta) > 9000
    for field in ("xy", "normal", "valid"):
        np.testing.assert_array_equal(getattr(tc, field).numpy(), np.asarray(getattr(jc, field)))
    world = T.corridor_world(TCFG)
    np.testing.assert_array_equal(world.xy.numpy(), np.asarray(J.corridor_world(JCFG).xy))


def test_corridor_trajectory_matches_jax_and_is_killian_scale():
    gt = T.corridor_trajectory(TCFG)
    np.testing.assert_array_equal(gt, J.corridor_trajectory(JCFG))
    assert len(gt) == 2871
    path = float(np.sum(np.linalg.norm(np.diff(gt[:, :2], axis=0), axis=1)))
    assert path > 300.0
    near = np.linalg.norm(gt[:, :2] - gt[0, :2], axis=1) < 1.0
    assert int(np.sum(near[1:] & ~near[:-1])) + int(near[0]) >= 4


@pytest.mark.parametrize("start", [0, 1500])
def test_raycast_ranges_matches_jax(start):
    _, seg_a, seg_b = J.corridor_geometry(JCFG)
    proj = T.projector_op.PolarProjection.make(
        cols=361, angle_min=JCFG.angle_min, angle_max=JCFG.angle_max,
        range_min=JCFG.range_min, range_max=JCFG.range_max)
    poses = J.corridor_trajectory(JCFG)[start:start + 12]
    jr = J.raycast_ranges(proj, poses, seg_a, seg_b)
    tr = T.raycast_ranges(proj, poses, seg_a, seg_b, device="cpu")
    np.testing.assert_allclose(tr, jr, atol=1e-5)
    np.testing.assert_array_equal(tr > 0, jr > 0)
    # the batched torch form a CUDA device runs, here on CPU tensors
    angles = tproj.beam_angles(proj).numpy()
    bt = T._raycast_torch(proj, poses, seg_a, seg_b, angles, torch.device("cpu"))
    np.testing.assert_allclose(bt, jr, atol=1e-5)
    np.testing.assert_array_equal(bt > 0, jr > 0)


def test_simulate_corridors_slice_matches_jax(slices):
    jd, td = slices
    np.testing.assert_allclose(td.ranges, jd.ranges, atol=1e-5)
    np.testing.assert_array_equal(td.ranges > 0, jd.ranges > 0)
    np.testing.assert_array_equal(td.robot_poses, jd.robot_poses)
    np.testing.assert_array_equal(td.sensor_poses, jd.sensor_poses)
    assert td.config == T.SyntheticConfig(**{k: getattr(jd.config, k) for k in (
        "num_beams", "angle_min", "angle_max", "range_min", "range_max", "steps", "seed",
        "sensor_in_robot")})
    assert tuple(td.projection) == tuple(jd.projection)
    np.testing.assert_array_equal(td.scene.xy.numpy(), np.asarray(jd.scene.xy))


def test_first_scan_exact_count(slices):
    """The reference asserts exact adapted-cloud sizes for each dataset's
    first scan; both packages give the corridor's 267."""
    jd, td = slices
    model = dict(num_beams=361, angle_min=JCFG.angle_min, angle_max=JCFG.angle_max,
                 range_min=JCFG.range_min, range_max=JCFG.range_max)
    jpre = JPre(JPC(voxelize_resolution=0.02, normal_window=8))
    jpre.set_model(JLaserModel(**model))
    tpre = ScanPreprocessor(PreprocessorConfig(voxelize_resolution=0.02, normal_window=8),
                            device="cpu")
    tpre.set_model(LaserModel(**model))
    for k in (0, 80):
        jn = int(jpre.compute(jd.ranges[k]).count())
        tn = int(tpre.compute(td.ranges[k]).count())
        assert tn == jn
    assert int(tpre.compute(td.ranges[0]).count()) == 267


def test_generator_world_corridors_writes_the_jax_log(tmp_path, monkeypatch):
    """``--world corridors`` in both packages over the first 12 frames of
    the drive (the trajectory cut in both modules): the same messages and
    ground truth."""
    short = J.corridor_trajectory(JCFG)[:12]
    monkeypatch.setattr(J, "corridor_trajectory", lambda cfg: short)
    monkeypatch.setattr(T, "corridor_trajectory", lambda cfg: short)
    outs = {}
    for name, gen, extra in (("jax", jgen, []), ("torch", tgen, ["--device", "cpu"])):
        log, gt = tmp_path / f"{name}.jsonl", tmp_path / f"{name}_gt.tum"
        gen.main(["-m", str(log), "--gt", str(gt), "--world", "corridors", "--beams", "361",
                  *extra])
        outs[name] = ([json.loads(line) for line in log.read_text().splitlines()],
                      gt.read_text())
    (jm, jgt), (tm, tgt) = outs["jax"], outs["torch"]
    assert tgt == jgt
    assert len(tm) == len(jm) == 1 + 3 * 12
    _assert_close(tm, jm)


def _assert_close(t, j):
    """Equal JSON values, numbers within 1e-5."""
    if isinstance(j, dict):
        assert t.keys() == j.keys()
        for k in j:
            _assert_close(t[k], j[k])
    elif isinstance(j, list):
        assert len(t) == len(j)
        for a, b in zip(t, j):
            _assert_close(a, b)
    elif isinstance(j, float):
        assert abs(t - j) <= 1e-5, (t, j)
    else:
        assert t == j
