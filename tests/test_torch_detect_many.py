"""The loop detector's batched alignments against the JAX package's
(srrg2_laser_slam_2d_tpu/models/loop_closure.py): ``_batch_align`` (one
query scene against K candidates), ``_batch_align_pairs`` (J independent
pairs, the chunked loop's ``projective`` backend) and
``BruteForceLoopDetector.detect_many`` (selection, the power-of-two job
bucket padded with copies of the first job, the ``capacity`` cut, the
gates), on local-map scenes of one room made from a seed with numpy.

The scenes' points are sampled along the walls at random, off any beam
grid, so both packages put every point in the same beam. Estimates agree
within 1e-4 m / rad (observed 1.2e-7): the two run the same float32
operations, PyTorch eagerly and XLA fused, and differ in their last bits.
Counts agree within 1 (a point at the distance or normal gate by
rounding). Which candidates pass the gates must be equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srrg2_laser_slam_2d_tpu.models import loop_closure as jlc
from srrg2_laser_slam_2d_tpu.ops import icp as jicp
from srrg2_laser_slam_2d_tpu.ops.projector import PolarProjection as JProjection
from srrg2_laser_slam_2d_tpu.utils.cloud import Cloud as JCloud
from srrg2_laser_slam_2d_tpu_torch.models import loop_closure as tlc
from srrg2_laser_slam_2d_tpu_torch.ops import icp as ticp
from srrg2_laser_slam_2d_tpu_torch.ops.projector import PolarProjection as TProjection
from srrg2_laser_slam_2d_tpu_torch.utils.cloud import Cloud as TCloud

EST_TOL = 1e-4
COLS = 400
# a 9 m x 7 m room with two pillars: wall segments (start, end)
WALLS = np.array([[[-4.5, -3.5], [4.5, -3.5]], [[4.5, -3.5], [4.5, 3.5]],
                  [[4.5, 3.5], [-4.5, 3.5]], [[-4.5, 3.5], [-4.5, -3.5]],
                  [[1.0, 0.5], [1.6, 0.5]], [[1.6, 0.5], [1.6, 1.1]],
                  [[-2.0, -1.2], [-1.2, -1.2]], [[-1.2, -1.2], [-1.2, -0.6]]])
# local-map origins (world), a chain of maps around the room
MAP_POSES = np.array([[0.0, 0.0, 0.0], [0.6, 0.1, 0.1], [1.2, 0.3, 0.25],
                      [0.7, -0.6, 0.4], [0.1, -0.5, 0.6], [-0.4, 0.2, -0.3]], np.float32)


def _room_scene(rng, pose, n, capacity, invalid=0.03):
    """``n`` points of the room's walls in the frame of ``pose``, with
    inward normals, noise and a few invalid rows, padded to ``capacity``."""
    seg = rng.integers(0, len(WALLS), n)
    u = rng.uniform(0, 1, (n, 1))
    a, b = WALLS[seg, 0], WALLS[seg, 1]
    p = a + u * (b - a)
    d = (b - a) / np.linalg.norm(b - a, axis=1, keepdims=True)
    nrm = np.stack([-d[:, 1], d[:, 0]], 1)
    c, s = np.cos(pose[2]), np.sin(pose[2])
    R = np.array([[c, -s], [s, c]])
    xy = (p - pose[:2]) @ R + rng.normal(0, 0.003, (n, 2))
    nm = nrm @ R
    flip = (nm * xy).sum(1) > 0            # normals toward the sensor
    nm[flip] *= -1
    out_xy = np.zeros((capacity, 2), np.float32)
    out_nm = np.zeros((capacity, 2), np.float32)
    valid = np.zeros(capacity, bool)
    out_xy[:n], out_nm[:n] = xy, nm
    valid[:n] = rng.uniform(size=n) > invalid
    return out_xy, out_nm, valid


@pytest.fixture(scope="module")
def world():
    """Six local-map scenes (capacities 1024 and 512, one map too sparse to
    pass the inlier gate), the map poses with a little drift, and a chain
    adjacency."""
    rng = np.random.default_rng(11)
    sizes = [(900, 1024), (700, 1024), (480, 512), (800, 1024), (60, 1024), (650, 1024)]
    scenes = [_room_scene(rng, MAP_POSES[k], n, cap) for k, (n, cap) in enumerate(sizes)]
    drift = (MAP_POSES + rng.normal(0, [0.03, 0.03, 0.01], MAP_POSES.shape)).astype(np.float32)
    adjacency = [set() for _ in MAP_POSES]
    for k in range(len(MAP_POSES) - 1):
        adjacency[k].add(k + 1)
        adjacency[k + 1].add(k)
    return scenes, drift, adjacency


def _aligner():
    return dict(max_iterations=15, point_distance=1.414, normal_cos=0.8,
                chi_threshold=0.05, odom_weight=0.0)


def _detector_configs():
    kw = dict(relocalize_min_inliers=60, relocalize_min_inliers_ratio=0.5,
              relocalize_max_chi_inliers=0.1, max_candidates=4)
    return (jlc.LoopDetectorConfig(aligner=jicp.AlignerConfig(**_aligner()), **kw),
            tlc.LoopDetectorConfig(aligner=ticp.AlignerConfig(**_aligner()), **kw))


def _projections():
    kw = dict(cols=COLS, angle_min=-np.pi, angle_max=np.pi, range_min=0.1, range_max=30.0)
    return JProjection.make(**kw), TProjection.make(**kw)


def _jcloud(xy, nm, v):
    return JCloud(jnp.asarray(xy), jnp.asarray(nm), jnp.asarray(v))


def _tcloud(xy, nm, v):
    return TCloud(torch.from_numpy(np.ascontiguousarray(xy)),
                  torch.from_numpy(np.ascontiguousarray(nm)), torch.from_numpy(v))


def _padded(scene, capacity):
    """A scene's rows padded with invalid zeros to ``capacity``."""
    pad = capacity - scene[0].shape[0]
    return tuple(np.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1)) for x in scene)


def _stacked(scenes, ids):
    return tuple(np.stack([scenes[i][f] for i in ids]) for f in range(3))


def _hold(jres, tres):
    np.testing.assert_allclose(tres.estimate.numpy(), np.asarray(jres.estimate), atol=EST_TOL)
    for f in ("num_inliers", "num_correspondences"):
        d = np.abs(getattr(tres, f).numpy() - np.asarray(getattr(jres, f)))
        assert d.max() <= 1, (f, d)
    assert np.asarray(jres.num_inliers).min() >= 1


def test_batch_align_matches_jax(world):
    """One query scene against four candidates at once."""
    scenes, poses, _ = world
    jdet, tdet = _detector_configs()
    jproj, tproj = _projections()
    ids, q = [1, 3, 5, 0], 2
    init = np.stack([jlc.relative_np(poses[m], poses[q]) for m in ids])
    fixed = _stacked(scenes, ids)
    moving = _padded(scenes[q], 1024)
    jres = jlc._batch_align(jdet.aligner, jproj, _jcloud(*fixed), _jcloud(*moving),
                            jnp.asarray(init))
    tres = tlc._batch_align(tdet.aligner, tproj, _tcloud(*fixed), _tcloud(*moving),
                            torch.from_numpy(init))
    _hold(jres, tres)


def test_batch_align_pairs_matches_jax(world):
    """Five independent (query, candidate) pairs, each with its own moving
    scene, through the chunked loop's ``projective`` backend."""
    scenes, poses, _ = world
    jdet, tdet = _detector_configs()
    jproj, tproj = _projections()
    jobs = [(0, 2), (1, 3), (3, 5), (5, 0), (2, 4)]
    big = [_padded(s, 1024) for s in scenes]
    fixed = _stacked(big, [m for _, m in jobs])
    moving = _stacked(big, [q for q, _ in jobs])
    init = np.stack([jlc.relative_np(poses[m], poses[q]) for q, m in jobs])
    jres = jlc._batch_align_pairs(jdet.aligner, jproj, _jcloud(*fixed), _jcloud(*moving),
                                  jnp.asarray(init))
    tres = tlc._batch_align_pairs(tdet.aligner, tproj, _tcloud(*fixed), _tcloud(*moving),
                                  torch.from_numpy(init))
    _hold(jres, tres)
    # the true relative poses: the scenes were cut from one room
    truth = np.stack([jlc.relative_np(MAP_POSES[m], MAP_POSES[q]) for q, m in jobs])
    ok = tres.num_inliers.numpy() >= 60
    assert ok.sum() >= 3
    np.testing.assert_allclose(tres.estimate.numpy()[ok], truth[ok], atol=0.03)


class _Recorder:
    """Wraps a package's ``_batch_align_pairs`` and keeps its inputs."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, acfg, proj, fixed, moving, initials):
        self.calls.append(tuple(np.asarray(x) for x in (*fixed, *moving, initials)))
        return self.fn(acfg, proj, fixed, moving, initials)


@pytest.mark.parametrize("queries,pad_to,capacity,n_jobs", [
    ([3, 4, 5], 8, None, 16), ([5], 8, None, 8), ([3, 4, 5], 2, 512, 16)])
def test_detect_many_matches_jax(world, monkeypatch, queries, pad_to, capacity, n_jobs):
    """The query maps against their selected candidates: the same padded
    jobs and scenes go into the batched alignment (the bucket is the
    smallest power of two >= ``pad_to`` that holds the jobs, the padding
    repeats the first job; the 512-row scene is padded to 1024, or the
    others cut to ``capacity``), the same candidates pass the gates (the
    sparse map 4 fails them), and their estimates and counts agree."""
    scenes, poses, adjacency = world
    jdet_cfg, tdet_cfg = _detector_configs()
    jproj, tproj = _projections()
    jrec = _Recorder(jlc._batch_align_pairs)
    trec = _Recorder(tlc._batch_align_pairs)
    monkeypatch.setattr(jlc, "_batch_align_pairs", jrec)
    monkeypatch.setattr(tlc, "_batch_align_pairs", trec)
    jout = jlc.BruteForceLoopDetector(jdet_cfg, jproj).detect_many(
        queries, [_jcloud(*s) for s in scenes], poses, len(scenes), adjacency,
        pad_to=pad_to, capacity=capacity)
    tout = tlc.BruteForceLoopDetector(tdet_cfg, tproj).detect_many(
        queries, [_tcloud(*s) for s in scenes], poses, len(scenes), adjacency,
        pad_to=pad_to, capacity=capacity)
    assert len(jrec.calls) == len(trec.calls) == 1
    jin, tin = jrec.calls[0], trec.calls[0]
    for a, b in zip(jin, tin):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert jin[0].shape[:2] == (n_jobs, capacity or 1024)
    jobs = [(q, m) for q in queries
            for m in tlc.BreadthFirstSelector(tdet_cfg).select(q, poses, len(scenes),
                                                                adjacency)]
    assert len(jobs) < n_jobs          # the bucket holds padding
    np.testing.assert_array_equal(tin[-1][len(jobs):],
                                  np.repeat(tin[-1][:1], n_jobs - len(jobs), 0))
    assert [(c.query_map, c.candidate_map) for c in tout] == \
        [(c.query_map, c.candidate_map) for c in jout]
    assert {c.query_map for c in tout} == set(queries) - {4}
    for jc, tc in zip(jout, tout):
        np.testing.assert_allclose(tc.estimate, jc.estimate, atol=EST_TOL)
        assert abs(tc.num_inliers - jc.num_inliers) <= 1
        assert abs(tc.num_correspondences - jc.num_correspondences) <= 1
        assert tc.chi_inliers == pytest.approx(jc.chi_inliers, rel=1e-3, abs=1e-6)
