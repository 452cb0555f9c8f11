"""The slice as a whole: the port's per-message ``GraphSLAM2D.process``
loop against the JAX package's on the three synthetic drives of
tests/test_slam.py (straight line: graph topology; circle: loop closure;
circle with the relocalizer: jumps onto existing maps), 512 beams, the
plain projective-ICP tracker on both sides (route C, the parity oracle),
both packages reading one configuration file.

Variables, factors, closures and relocalizations must be EQUAL after every
message. Trajectories: the synthetic scans have the tracker canvas's own
beam grid (512 beams over +-pi), so every point of a measurement, and of a
freshly seeded local map, lies exactly ON a beam-bin edge in its own frame,
where the last bit of ``atan2`` (XLA's against libm's) decides its beam. A
handful of cells per frame therefore match or merge differently, and one
tracking step from IDENTICAL inputs can differ by 6e-4 in the pose (with 80
correspondences in a sparse new map). So the straight drive is held to
1e-2 m / 1e-2 rad (observed 4.0e-3 m, 2.6e-3 rad). On the circle drives
every new local map also triggers closures, a global solve and a jump onto
a fused scene whose near-duplicate points tie in the z-buffer, and each
solve amplifies the differences: the two runs stay within 5e-2 m / 5e-2 rad
(observed 2.4e-2 m, 1.1e-2 rad), an order of magnitude below the 0.2 m the
JAX test allows against the ground truth. Away from bin edges one tracking
step from one carried-over state agrees to 1e-5
(tests/test_torch_tracker.py)."""

import dataclasses

import numpy as np
import pytest
import torch

from srrg2_laser_slam_2d_tpu.bench import synthetic
from srrg2_laser_slam_2d_tpu.utils import config as jconfig
from srrg2_laser_slam_2d_tpu.utils import presets  # noqa: F401  (registers the JAX config classes)
from srrg2_laser_slam_2d_tpu_torch.models import loop_closure as tlc
from srrg2_laser_slam_2d_tpu_torch.models import preprocessor as tpre
from srrg2_laser_slam_2d_tpu_torch.models import slam as tslam_mod
from srrg2_laser_slam_2d_tpu_torch.utils import config as tconfig
from tests.test_slam import make_pipeline

DRIVES = {
    "straight": dict(sim=dict(steps=20, max_variance=0.0, drift=(0.11, 0.0, 0.0)),
                     loops=False, relocalizer=False, tol=1e-2),
    "circle": dict(sim=dict(steps=40, max_variance=0.02, drift=(0.15, 0.0, 2 * np.pi / 40),
                            seed=5), loops=True, relocalizer=False, tol=5e-2),
    "relocalizer": dict(sim=dict(steps=44, max_variance=0.02,
                                 drift=(0.15, 0.0, 2 * np.pi / 40), seed=7),
                        loops=True, relocalizer=True, tol=5e-2),
}


def _port_config(cfg, path):
    mgr = jconfig.ConfigManager()
    mgr.add(cfg, "slam")
    mgr.write(str(path))
    return tconfig.ConfigManager.read(str(path)).get_by_name("slam")


def _port_preprocessor(c):
    pre = tpre.ScanPreprocessor(tpre.PreprocessorConfig(voxelize_resolution=0.02,
                                                        normal_window=8), device="cpu")
    pre.set_model(tpre.LaserModel(c.num_beams, c.angle_min, c.angle_max, c.range_min,
                                  c.range_max))
    return pre


@pytest.fixture(scope="module", params=list(DRIVES))
def run(request, tmp_path_factory):
    """Both loops over one drive; the graph counters after every message."""
    drive = DRIVES[request.param]
    ds = synthetic.simulate(synthetic.SyntheticConfig(num_beams=512, **drive["sim"]))
    jslam, jpre = make_pipeline(ds, local_map_distance=0.5, enable_loops=drive["loops"])
    jslam.cfg = dataclasses.replace(jslam.cfg, enable_relocalizer=drive["relocalizer"])
    tcfg = _port_config(jslam.cfg, tmp_path_factory.mktemp("cfg") / "slam.json")
    sir = np.array(ds.config.sensor_in_robot, np.float32)
    tslam = tslam_mod.GraphSLAM2D(tcfg, sensor_in_robot=sir, device="cpu")
    tp = _port_preprocessor(ds.config)
    counters, worlds = [], []
    for k in range(len(ds.ranges)):
        jslam.process(jpre.compute(ds.ranges[k]), ds.robot_poses[k])
        tslam.process(tp.compute(ds.ranges[k]), ds.robot_poses[k])
        counters.append(((jslam.num_variables(), jslam.num_factors(), jslam.num_closures,
                          jslam.relocalizations, jslam.current_map),
                         (tslam.num_variables(), tslam.num_factors(), tslam.num_closures,
                          tslam.relocalizations, tslam.current_map)))
        worlds.append((np.asarray(jslam.robot_in_world()), tslam.robot_in_world()))
    return request.param, ds, jslam, tslam, counters, worlds


def test_graph_closures_and_relocalizations_equal_jax_after_every_message(run):
    name, _, jslam, tslam, counters, _ = run
    for k, (j, t) in enumerate(counters):
        assert t == j, (name, k, j, t)
    if name == "straight":
        assert (tslam.num_variables(), tslam.num_factors()) == (5, 4)
    else:
        assert tslam.num_variables() >= 8 and tslam.num_closures >= 1
        assert tslam.num_factors() > tslam.num_variables() - 1
    if name == "relocalizer":
        assert tslam.relocalizations >= 1
    assert tslam.adjacency == jslam.adjacency


def test_trajectory_and_graph_poses_match_jax(run):
    name, ds, jslam, tslam, _, worlds = run
    tol = DRIVES[name]["tol"]
    d = np.abs(np.stack([t for _, t in worlds]) - np.stack([j for j, _ in worlds]))
    d[:, 2] = np.abs(np.arctan2(np.sin(d[:, 2]), np.cos(d[:, 2])))
    assert d.max() < tol, (name, d.max(axis=0))
    np.testing.assert_allclose(tslam.poses_np, np.asarray(jslam.poses_np)[: tslam.n_maps],
                               atol=tol)
    if name != "relocalizer":     # the JAX test holds only these two to the ground truth
        err = np.abs(tslam.robot_in_world() - ds.robot_poses[-1])
        assert np.linalg.norm(err[:2]) < (0.08 if name == "straight" else 0.2), err


def test_scenes_and_device_graph_follow_the_host_bookkeeping(run):
    name, _, jslam, tslam, _, _ = run
    g = tslam.graph
    assert int(g.var_valid.sum()) == tslam.n_maps and int(g.edge_valid.sum()) == tslam.n_edges
    assert bool(g.var_fixed[0]) and int(g.var_fixed.sum()) == 1
    np.testing.assert_allclose(g.poses[: tslam.n_maps].numpy(), tslam.poses_np)
    for m in range(tslam.n_maps):
        js, ts = jslam.scene_of(m), tslam.scene_of(m)
        assert (js is None) == (ts is None)
        if ts is not None:
            # live points: equal but for the cells that merged differently
            assert abs(int(ts.valid.sum()) - int(np.asarray(js.valid).sum())) <= 8, (name, m)
    assert tslam.scene_of(tslam.current_map) is tslam.tracker.capture_scene()
    assert set(tslam.phase_times) >= {"track"}


def test_fast_tracker_route_builds_the_same_graph_as_the_plain_tracker():
    """``use_fast_tracker`` (one launch of the frame kernel per message, here
    its plain version) against the plain tracker on the straight drive:
    same topology, end poses within 0.05 m (the frame kernel's lean merge is
    trajectory-equivalent, not identical)."""
    drive = DRIVES["straight"]
    ds = synthetic.simulate(synthetic.SyntheticConfig(num_beams=512, **drive["sim"]))
    jslam, _ = make_pipeline(ds, local_map_distance=0.5, enable_loops=False)
    sir = np.array(ds.config.sensor_in_robot, np.float32)
    tp = _port_preprocessor(ds.config)
    ends = {}
    for fast in (False, True):
        mgr = jconfig.ConfigManager()
        mgr.add(dataclasses.replace(jslam.cfg, use_fast_tracker=fast), "slam")
        import tempfile

        with tempfile.NamedTemporaryFile(suffix=".json") as f:
            mgr.write(f.name)
            cfg = tconfig.ConfigManager.read(f.name).get_by_name("slam")
        slam = tslam_mod.GraphSLAM2D(cfg, sensor_in_robot=sir, device="cpu")
        for k in range(len(ds.ranges)):
            slam.process(tp.compute(ds.ranges[k]), ds.robot_poses[k])
        assert (slam.num_variables(), slam.num_factors()) == (5, 4)
        ends[fast] = slam.robot_in_world()
    assert np.abs(ends[True] - ends[False]).max() < 0.05, ends


def test_selector_and_unported_options():
    """``select`` gives one query's candidates in the order ``select_many``
    gives them; multi-cue tracking builds the multi-cue tracker; the cg /
    schur global solvers construct on the CPU."""
    rng = np.random.default_rng(3)
    poses = np.concatenate([rng.uniform(-2, 2, (12, 2)), np.zeros((12, 1))], 1).astype(np.float32)
    adjacency = [set() for _ in range(12)]
    for i in range(11):
        adjacency[i].add(i + 1)
        adjacency[i + 1].add(i)
    sel = tlc.BreadthFirstSelector(tlc.LoopDetectorConfig(max_candidates=4))
    for q in (0, 5, 11):
        assert [(q, m) for m in sel.select(q, poses, 12, adjacency)] == \
            sel.select_many([q], poses, 12, adjacency)
    assert any(sel.select(q, poses, 12, adjacency) for q in range(12))
    multi = tslam_mod.GraphSLAM2D(tslam_mod.GraphSLAMConfig(cue_extrinsics=((0, 0, 0),)),
                                  device="cpu")
    assert type(multi.tracker).__name__ == "MultiCueTracker"
    for kind in ("schur", "cg"):
        slam = tslam_mod.GraphSLAM2D(tslam_mod.GraphSLAMConfig(global_solver_kind=kind),
                                     device="cpu")
        assert slam.cfg.global_solver_kind == kind and slam.device == torch.device("cpu")
    assert tslam_mod.GraphSLAM2D(device="cpu").robot_in_world().tolist() == [0, 0, 0]
    monkey = torch.cuda.is_available
    try:
        torch.cuda.is_available = lambda: False
        with pytest.raises(RuntimeError, match="CUDA"):
            tslam_mod.GraphSLAM2D()
    finally:
        torch.cuda.is_available = monkey
