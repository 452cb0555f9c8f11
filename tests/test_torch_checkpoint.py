"""Checkpoints across the two packages on the CPU: a run saved by the JAX
package at frame 8 and loaded by the port, and the reverse, each with the
plain tracker (``LaserTracker``) and the frame-kernel tracker
(``FastTracker``: the JAX kernel in interpret mode, the port's plain
version). Then both go on for the 5 frames left.

The drive is ``tests/test_aux.py``'s: 512 beams over +-0.4 pi tracked on
a 512-column canvas over +-pi, 0.11 m a step, local maps of 0.5 m (three
maps, two edges by frame 12). Tolerances: right after a load the graph,
the maps' scenes and the pose are those of the file (1e-6); after the 5
more frames ``robot_in_world`` agrees within 1e-3 (one step off the beam
grid agrees to 1e-5, ``ROADMAP.md`` Queue 3; five steps and a split add
merge decisions on bin edges). The file of either package holds the same
arrays, shapes and dtypes. The draw calls of both packages' runners after
the continued runs agree within 1e-4 (poses, edges, trajectory); their
scenes as ``tests/test_torch_slam_app.py`` holds them.
"""

import dataclasses

import numpy as np
import pytest

from srrg2_laser_slam_2d_tpu.bench import synthetic
from srrg2_laser_slam_2d_tpu.models import runner as jrunner
from srrg2_laser_slam_2d_tpu.models import slam as jslam_mod
from srrg2_laser_slam_2d_tpu.utils import checkpoint as jckpt
from srrg2_laser_slam_2d_tpu_torch.models import runner as trunner
from srrg2_laser_slam_2d_tpu_torch.models import slam as tslam_mod
from srrg2_laser_slam_2d_tpu_torch.utils import checkpoint as tckpt
from srrg2_laser_slam_2d_tpu_torch.utils.cloud import Cloud
from tests.test_slam import make_pipeline
from tests.test_torch_slam import _port_config, _port_preprocessor
from tests.test_torch_slam_app import RecordingCanvas, assert_scene_points_agree

SAVE_AT = 8
LOAD_TOL = 1e-6
CONTINUE_TOL = 1e-3
DRAW_TOL = 1e-4
RUNS_TOL = 1e-2


@pytest.fixture(scope="module")
def drive():
    ds = synthetic.simulate(synthetic.SyntheticConfig(
        steps=12, num_beams=512, max_variance=0.0, drift=(0.11, 0.0, 0.0)))
    jslam, jpre = make_pipeline(ds, local_map_distance=0.5, enable_loops=False)
    tpre = _port_preprocessor(ds.config)
    jclouds = [jpre.compute(r) for r in ds.ranges]
    tclouds = [tpre.compute(r) for r in ds.ranges]
    return ds, jslam.cfg, jclouds, tclouds


class Side:
    """One package's GraphSLAM2D, its clouds and its trajectory."""

    def __init__(self, pkg, slam, clouds):
        self.pkg, self.slam, self.clouds, self.trajectory = pkg, slam, clouds, []

    def step(self, ds, k):
        self.slam.process(self.clouds[k], ds.robot_poses[k])
        self.trajectory.append((0.1 * k, self.pose(), 0.0))

    def pose(self):
        return np.asarray(self.slam.robot_in_world(), np.float32)

    def save(self, path):
        (jckpt if self.pkg == "jax" else tckpt).save(path, self.slam, self.trajectory)

    def load(self, path):
        (jckpt if self.pkg == "jax" else tckpt).load(path, self.slam)
        self.trajectory = [(t, p, 0.0) for t, p in
                           (jckpt if self.pkg == "jax" else tckpt).trajectory_from(path)]


def _sides(drive, fast, tmp_path):
    ds, cfg, jclouds, tclouds = drive
    cfg = dataclasses.replace(cfg, use_fast_tracker=fast)
    sir = np.array(ds.config.sensor_in_robot, np.float32)

    def make(pkg):
        if pkg == "jax":
            return Side("jax", jslam_mod.GraphSLAM2D(cfg, sensor_in_robot=sir), jclouds)
        tcfg = _port_config(cfg, tmp_path / f"slam_{len(list(tmp_path.iterdir()))}.json")
        return Side("port", tslam_mod.GraphSLAM2D(tcfg, sensor_in_robot=sir, device="cpu"),
                    tclouds)
    return ds, make


def _host(x):
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def _scenes(slam):
    out = []
    for m in range(slam.n_maps):
        s = slam.scene_of(m)
        out.append(None if s is None else _host(s.xy)[_host(s.valid).astype(bool)])
    return out


@pytest.mark.parametrize("fast", [False, True], ids=["laser_tracker", "fast_tracker"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_is_read_by_the_other_package(drive, fast, writer, tmp_path):
    ds, make = _sides(drive, fast, tmp_path)
    reader = "port" if writer == "jax" else "jax"
    w = make(writer)
    for k in range(SAVE_AT):
        w.step(ds, k)
    path = str(tmp_path / "ckpt.npz")
    w.save(path)
    r = make(reader)
    r.load(path)
    assert (r.slam.n_maps, r.slam.n_edges, r.slam.current_map) == \
        (w.slam.n_maps, w.slam.n_edges, w.slam.current_map)
    assert w.slam.n_maps >= 2 and r.slam.adjacency == w.slam.adjacency
    np.testing.assert_allclose(np.asarray(r.slam.poses_np)[: r.slam.n_maps],
                               np.asarray(w.slam.poses_np)[: w.slam.n_maps], atol=LOAD_TOL)
    np.testing.assert_allclose(r.pose(), w.pose(), atol=LOAD_TOL)
    for a, b in zip(_scenes(r.slam), _scenes(w.slam)):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(a, b, atol=LOAD_TOL)
    assert len(r.trajectory) == SAVE_AT
    np.testing.assert_allclose(np.stack([p for _, p, _ in r.trajectory]),
                               np.stack([p for _, p, _ in w.trajectory]), atol=LOAD_TOL)
    for k in range(SAVE_AT, len(ds.ranges)):
        w.step(ds, k)
        r.step(ds, k)
        d = np.abs(r.pose() - w.pose())
        assert d.max() < CONTINUE_TOL, (k, d)
        assert r.slam.n_maps == w.slam.n_maps, k
    assert w.slam.n_maps == 3 and w.slam.n_edges == 2
    if writer == "jax" and not fast:
        _assert_draw_calls_agree(w, r)


def _assert_draw_calls_agree(jside, tside):
    """Both packages' ``SlamRunner.draw`` over the two continued runs."""
    calls = []
    for side, runner_mod in ((jside, jrunner), (tside, trunner)):
        runner = (runner_mod.SlamRunner() if side.pkg == "jax"
                  else runner_mod.SlamRunner(device="cpu"))
        runner.slam, runner.trajectory = side.slam, side.trajectory
        canvas = RecordingCanvas()
        runner.draw(canvas)
        calls.append(canvas.calls)
    jcalls, tcalls = calls
    assert [c[0] for c in tcalls] == [c[0] for c in jcalls]
    assert [c[0] for c in tcalls].count("put_cloud") == 3
    for (name, tv), (_, jv) in zip(tcalls, jcalls):
        for a, b in zip(tv, jv):
            if isinstance(b, str):
                assert a == b, name
                continue
            if name == "put_segments":      # the JAX graph's edge rows past n_edges
                b = b[: len(a)]
            if name == "put_cloud":
                assert_scene_points_agree(a, b)
            else:
                np.testing.assert_allclose(a, b, atol=DRAW_TOL, err_msg=name)


def test_both_packages_write_the_same_arrays(drive, tmp_path):
    """Both packages' own runs to frame 8, each saved by its package: the
    same keys, shapes and dtypes, the same metadata, and the values of two
    independent runs (within 1e-2, as ``tests/test_torch_slam.py`` holds the
    straight drive; observed 2.1e-3 rad at the split)."""
    ds, make = _sides(drive, False, tmp_path)
    files = {}
    for pkg in ("jax", "port"):
        side = make(pkg)
        for k in range(SAVE_AT):
            side.step(ds, k)
        files[pkg] = str(tmp_path / f"{pkg}.npz")
        side.save(files[pkg])
    j, t = np.load(files["jax"]), np.load(files["port"])
    assert sorted(t.files) == sorted(j.files)
    for key in j.files:
        assert (t[key].shape, t[key].dtype) == (j[key].shape, j[key].dtype), key
        if key.endswith(".valid"):
            assert abs(int(t[key].sum()) - int(j[key].sum())) <= 2, key
        elif not key.startswith("scene.") and not key.startswith("tracker.scene."):
            np.testing.assert_allclose(t[key], j[key], atol=RUNS_TOL, err_msg=key)
    import json

    jm = json.load(open(files["jax"][:-4] + ".meta.json"))
    tm = json.load(open(files["port"][:-4] + ".meta.json"))
    assert tm == jm


def test_fast_tracker_checkpoint_folds_pending_payloads(drive, tmp_path):
    """``save`` folds the fast tracker's pending payloads into its scene; a
    resumed tracker starts with none pending and the same scene."""
    ds, make = _sides(drive, True, tmp_path)
    side = make("port")
    for k in range(3):
        side.step(ds, k)
    tracker = side.slam.tracker
    assert len(tracker._pending) == 2
    path = str(tmp_path / "fast.npz")
    side.save(path)
    assert tracker._pending == []
    back = make("port")
    back.load(path)
    assert back.slam.tracker._pending == [] and back.slam.tracker._last_payload is None
    s0, s1 = tracker.scene, back.slam.tracker.scene
    assert isinstance(s1, Cloud)
    np.testing.assert_array_equal(s1.xy.numpy(), s0.xy.numpy())
    np.testing.assert_array_equal(back.slam.tracker.state.cacheT.numpy(),
                                  tracker.state.cacheT.numpy())
    bare = str(tmp_path / "bare")
    tckpt.save(bare, side.slam)
    assert tckpt.trajectory_from(bare + ".npz") == [] and len(tckpt.trajectory_from(path)) == 3
