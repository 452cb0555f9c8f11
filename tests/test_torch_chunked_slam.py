"""The slice as a whole: the port's chunk-batched SLAM loop
(srrg2_laser_slam_2d_tpu_torch/models/chunked_slam.py) against the JAX
package's on the noisy synthetic loop drive of
tests/test_chunked_slam.py::test_chunked_loop_closure_closes_and_solves
(44 steps, 512 beams, chunk 16, validator and relocalizer on), with the
loop detector on the ``fused_nn`` backend that the corridor configuration
selects and on the default ``projective`` backend (batched projective ICP
over the closure pairs, no kernel). Both read one configuration file; the
JAX side runs its Pallas kernels in interpret mode, the port its plain
PyTorch versions.

On ``fused_nn``, graph topology, closures and relocalizations must be
equal, and world trajectories agree within 1e-2 m / 1e-2 rad (observed
maximum: 2.5e-3 m, 1.4e-3 rad). On ``projective``, the detection rounds,
their gates and the relocalizations must be equal; the accepted closures
are held through the aligner and the validator on each other's recorded
inputs (see ``test_graph_and_closures_match_jax_projective``)."""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from srrg2_laser_slam_2d_tpu.bench import synthetic
from srrg2_laser_slam_2d_tpu.models import chunked_slam as jcs
from srrg2_laser_slam_2d_tpu.utils import config as jconfig
from srrg2_laser_slam_2d_tpu.utils import presets  # noqa: F401  (registers the JAX config classes)
from srrg2_laser_slam_2d_tpu_torch.io import logfile as tlogfile
from srrg2_laser_slam_2d_tpu_torch.io.messages import LaserMessage, OdometryMessage
from srrg2_laser_slam_2d_tpu_torch.io.sources import JsonlFileSource
from srrg2_laser_slam_2d_tpu_torch.models import chunked_slam as tcs
from srrg2_laser_slam_2d_tpu_torch.models import preprocessor as tpre
from srrg2_laser_slam_2d_tpu_torch.models.slam import GraphSLAMConfig
from srrg2_laser_slam_2d_tpu_torch.utils import config as tconfig
from tests.test_slam import make_pipeline

CHUNK = 16


def _port_config(cfg, path):
    """The port's GraphSLAMConfig for a JAX one, through a config file."""
    mgr = jconfig.ConfigManager()
    mgr.add(cfg, "slam")
    mgr.write(str(path))
    return tconfig.ConfigManager.read(str(path)).get_by_name("slam")


def _drive(tmp_path_factory, **detector):
    ds = synthetic.simulate(synthetic.SyntheticConfig(
        steps=44, num_beams=512, max_variance=0.02,
        drift=(0.15, 0.0, 2 * np.pi / 40), seed=7))
    base, pre = make_pipeline(ds, local_map_distance=0.5, enable_loops=True)
    cfg = dataclasses.replace(
        base.cfg, use_fast_tracker=True, enable_relocalizer=True,
        validator=dataclasses.replace(base.cfg.validator, enabled=True,
                                      min_times_checked=1),
        detector=dataclasses.replace(base.cfg.detector, **detector))
    path = tmp_path_factory.mktemp("cfg") / "slam.json"
    return ds, pre, cfg, _port_config(cfg, path)


@pytest.fixture(scope="module")
def drive(tmp_path_factory):
    return _drive(tmp_path_factory, backend="fused_nn", fused_corr_refresh=3)


@pytest.fixture(scope="module")
def drive_projective(tmp_path_factory):
    """The same drive on the detector's default ``projective`` backend."""
    ds, pre, cfg, tcfg = _drive(tmp_path_factory)
    assert cfg.detector.backend == tcfg.detector.backend == "projective"
    return ds, pre, cfg, tcfg


def _chunks(ds):
    n = len(ds.ranges)
    for a in range(0, n, CHUNK):
        b = min(a + CHUNK, n)
        pad = CHUNK - (b - a)
        ranges = np.concatenate([ds.ranges[a:b], np.zeros((pad, ds.ranges.shape[1]), np.float32)])
        odoms = np.concatenate([ds.robot_poses[a:b], np.repeat(ds.robot_poses[b - 1:b], pad, 0)])
        yield ranges, odoms.astype(np.float32), b - a


def _run_both(drive):
    ds, pre, jcfg, tcfg = drive
    sir = np.array(ds.config.sensor_in_robot, np.float32)
    jslam = jcs.ChunkedGraphSLAM2D(jcfg, sensor_in_robot=sir, chunk=CHUNK)
    # fewer padding pairs per interpret-mode detection launch; the padding
    # repeats the batch's first pair, so the results are the same
    jslam.detect_batch = 8
    tslam = tcs.ChunkedGraphSLAM2D(tcfg, sensor_in_robot=sir, chunk=CHUNK, device="cpu")
    c = ds.config
    tp = tpre.ScanPreprocessor(tpre.PreprocessorConfig(voxelize_resolution=0.02,
                                                       normal_window=8), device="cpu")
    tp.set_model(tpre.LaserModel(c.num_beams, c.angle_min, c.angle_max, c.range_min,
                                 c.range_max))
    for ranges, odoms, n in _chunks(ds):
        clouds = jax.tree.map(lambda *xs: jnp.stack(xs), *[pre.compute(r) for r in ranges])
        jslam.process_chunk(clouds, odoms, n_frames=n)
        tslam.process_chunk(tp.compute(ranges), odoms, n_frames=n)
    return jslam, tslam


@pytest.fixture(scope="module")
def runs(drive):
    return _run_both(drive)


class _Detections:
    """Records, per detection round of one package, the pairs that enter
    ``gate_candidates`` and the candidates that pass its gates, the inputs
    and results of ``_batch_align_pairs`` (tagged with their round), and
    each ``ClosureValidator.vote``: the pending entries before it, its
    arguments and the pairs it accepted."""

    def __init__(self, lc_mod):
        self.rounds, self.aligned, self.votes = [], [], []
        self._gate, self._align = lc_mod.gate_candidates, lc_mod._batch_align_pairs
        self._vote = lc_mod.ClosureValidator.vote

    def gate(self, cfg, jobs, *stats):
        out = self._gate(cfg, jobs, *stats)
        self.rounds.append((list(jobs), [(c.query_map, c.candidate_map) for c in out]))
        return out

    def align(self, acfg, proj, fixed, moving, initials):
        res = self._align(acfg, proj, fixed, moving, initials)
        self.aligned.append((len(self.rounds),
                             [np.array(x) for x in (*fixed, *moving, initials)], res))
        return res

    def vote(self, validator, poses, adjacency, graph_edges):
        pending = copy.deepcopy(validator.pending)
        out = self._vote(validator, poses, adjacency, graph_edges)
        self.votes.append((pending, np.array(poses), copy.deepcopy(adjacency),
                           copy.deepcopy(list(graph_edges)),
                           [(c.query_map, c.candidate_map) for c in out]))
        return out

    def round_inputs(self, r):
        """Round ``r``'s alignment inputs (fixed xy, normal, valid, moving xy,
        normal, valid, initial guesses) and estimates, one row per job: the
        batches concatenated, the padding of the last batch cut."""
        n = len(self.rounds[r][0])
        recs = [(x, res) for k, x, res in self.aligned if k == r]
        inputs = [np.concatenate([x[i] for x, _ in recs])[:n] for i in range(7)]
        return inputs, np.concatenate([np.asarray(res.estimate) for _, res in recs])[:n]


@pytest.fixture(scope="module")
def runs_projective(drive_projective):
    """Both loops on the ``projective`` backend, every detection round and
    vote recorded."""
    from srrg2_laser_slam_2d_tpu.models import loop_closure as jlc
    from srrg2_laser_slam_2d_tpu_torch.models import loop_closure as tlc

    jrec, trec = _Detections(jlc), _Detections(tlc)
    with pytest.MonkeyPatch.context() as mp:
        for mod, rec in ((jlc, jrec), (tlc, trec)):
            mp.setattr(mod, "gate_candidates", rec.gate)
            mp.setattr(mod, "_batch_align_pairs", rec.align)
            mp.setattr(mod.ClosureValidator, "vote",
                       lambda v, *a, rec=rec: rec.vote(v, *a))
        jslam, tslam = _run_both(drive_projective)
    return jslam, tslam, jrec, trec


def _hold_graphs(jslam, tslam):
    assert tslam.num_variables() == jslam.num_variables()
    assert tslam.num_factors() == jslam.num_factors()
    assert tslam.num_closures == jslam.num_closures >= 1
    assert tslam.relocalizations == jslam.relocalizations
    assert tslam.num_factors() > tslam.num_variables() - 1


def _hold_trajectories(jslam, tslam):
    wj, wt = np.stack(jslam.world_trajectory), np.stack(tslam.world_trajectory)
    assert wt.shape == wj.shape
    d = np.abs(wt - wj)
    assert d[:, :2].max() < 1e-2 and d[:, 2].max() < 1e-2, d.max(axis=0)
    np.testing.assert_allclose(tslam.poses_np, np.asarray(jslam.poses_np), atol=1e-2)
    np.testing.assert_allclose(tslam.robot_in_world(), np.asarray(jslam.robot_in_world()),
                               atol=1e-2)


def test_graph_and_closures_match_jax(runs):
    _hold_graphs(*runs)


def test_world_trajectory_matches_jax(runs):
    _hold_trajectories(*runs)


def test_draw_calls_match_jax(runs):
    """``ChunkedSlamRunner.draw`` of both packages over the two runs on a
    recording canvas: the same calls in the same order; poses, reference
    frames, edges and trajectory within the trajectories' 1e-2, and each
    scene's point count within 5 % (the scenes are built along trajectories
    that drift apart by up to 1e-2)."""
    from tests.test_torch_slam_app import RecordingCanvas

    jslam, tslam = runs
    calls = []
    for slam, runner in ((jslam, jcs.ChunkedSlamRunner(chunk=CHUNK)),
                         (tslam, tcs.ChunkedSlamRunner(chunk=CHUNK, device="cpu"))):
        runner.slam = slam
        runner.trajectory = [(0.1 * k, np.asarray(p), 0.0)
                             for k, p in enumerate(slam.world_trajectory)]
        canvas = RecordingCanvas()
        runner.draw(canvas)
        calls.append(canvas.calls)
    jcalls, tcalls = calls
    assert [c[0] for c in tcalls] == [c[0] for c in jcalls]
    assert [c[0] for c in tcalls].count("put_cloud") == tslam.n_maps >= 8
    for (name, tv), (_, jv) in zip(tcalls, jcalls):
        for a, b in zip(tv, jv):
            if isinstance(b, str):
                assert a == b, name
            elif name == "put_cloud":
                assert abs(len(a) - len(b)) <= 0.05 * max(len(a), len(b)), (len(a), len(b))
            else:
                np.testing.assert_allclose(a, b, atol=1e-2, err_msg=name)


def test_graph_and_closures_match_jax_projective(runs_projective):
    """The chunked loop on ``GraphSLAMConfig``'s default detector backend,
    closure pairs aligned by batched projective ICP in both packages, on the
    same drive: every detection round proposes the same (query, candidate)
    pairs and the same ones pass the detector's gates; the local maps and
    the relocalizations are equal and both loops close.

    The closures the validator then accepts are not held equal here (JAX
    17, the port 15 over the three rounds). The drive's scans lie on the
    tracker canvas's own 512-beam grid, so the two loops' scenes differ in
    a few points and their initial guesses by up to ~6e-3
    (``test_projective_scenes_differ_only_by_the_tracking_drift``), and 15
    projective iterations carry that into candidate estimates up to 2e-2
    apart, across the validator's single chi vote. On identical inputs the
    aligner (``test_projective_detection_matches_jax_on_the_drive``) and
    the validator (``test_validator_votes_match_jax_on_the_drive``) agree."""
    jslam, tslam, jrec, trec = runs_projective
    assert tslam.num_variables() == jslam.num_variables()
    assert tslam.relocalizations == jslam.relocalizations
    assert len(trec.rounds) == len(jrec.rounds) >= 2
    for (jjobs, jpass), (tjobs, tpass) in zip(jrec.rounds, trec.rounds):
        assert tjobs == jjobs
        assert tpass == jpass
    assert sum(len(p) for _, p in trec.rounds) >= 10
    for slam in (jslam, tslam):
        assert slam.num_closures >= 1 and slam.num_factors() > slam.num_variables() - 1


def test_projective_detection_matches_jax_on_the_drive(runs_projective):
    """Every detection batch of each run, replayed through the other
    package's ``_batch_align_pairs`` on the same scenes and initial guesses:
    the JAX batches through the port's, the port's through the JAX
    package's. Estimates within 1e-5 (observed 4e-7), inlier and
    correspondence counts equal."""
    import jax.numpy as jnp
    import torch

    from srrg2_laser_slam_2d_tpu.models import loop_closure as jlc
    from srrg2_laser_slam_2d_tpu.utils.cloud import Cloud as JCloud
    from srrg2_laser_slam_2d_tpu_torch.models import loop_closure as tlc
    from srrg2_laser_slam_2d_tpu_torch.ops.projector import PolarProjection
    from srrg2_laser_slam_2d_tpu_torch.utils.cloud import Cloud

    jslam, tslam, jrec, trec = runs_projective
    acfg, proj = tslam.detector.cfg.aligner, tslam.detector.proj
    assert len(jrec.aligned) >= 3 and len(trec.aligned) >= 3

    def hold(res, ref):
        np.testing.assert_allclose(np.asarray(res.estimate), np.asarray(ref.estimate),
                                   atol=1e-5)
        for name in ("num_inliers", "num_correspondences"):
            np.testing.assert_array_equal(np.asarray(getattr(res, name)),
                                          np.asarray(getattr(ref, name)))

    for _, arrays, jres in jrec.aligned:
        t = [torch.from_numpy(x) for x in arrays]
        hold(tlc._batch_align_pairs(acfg, proj, Cloud(*t[0:3]), Cloud(*t[3:6]), t[6]),
             jres)
    jproj = jslam.detector.proj
    assert proj == PolarProjection.make(jproj.cols, jproj.angle_min, jproj.angle_max,
                                        jproj.range_min, jproj.range_max)
    for _, arrays, tres in trec.aligned:
        x = [jnp.asarray(a) for a in arrays]
        jres = jlc._batch_align_pairs(jslam.detector.cfg.aligner, jproj, JCloud(*x[0:3]),
                                      JCloud(*x[3:6]), x[6])
        hold(tres, jres)


def _near_share(a, a_valid, b, b_valid, tol):
    """Share of the valid points of ``a`` with a valid point of ``b`` within
    ``tol``."""
    a, b = a[a_valid > 0].astype(np.float64), b[b_valid > 0].astype(np.float64)
    d = np.sqrt(((a[:, None] - b[None]) ** 2).sum(-1)).min(1)
    return float((d < tol).mean())


def test_projective_scenes_differ_only_by_the_tracking_drift(runs_projective):
    """What the two loops feed ``_batch_align_pairs`` in each detection
    round, pair by pair: the fixed and moving scenes hold the same points
    but for the merge decisions that the on-grid scans flip, so valid
    counts differ by at most 5 (observed 3, of 200-620) and at least 95 %
    of either scene's points lie within 1e-2 m of a point of the other
    (observed at least 97.1 %); the initial guesses differ by at most 1e-2
    (observed 5.9e-3). That is all that parts the candidate estimates (up
    to 2e-2 apart): on equal inputs both aligners agree to 1e-5."""
    _, _, jrec, trec = runs_projective
    for r in range(len(jrec.rounds)):
        (jx, jest), (tx, test) = jrec.round_inputs(r), trec.round_inputs(r)
        assert np.abs(tx[6] - jx[6]).max() <= 1e-2
        for i in range(len(jest)):
            for xy, valid in ((0, 2), (3, 5)):
                assert abs(int(jx[valid][i].sum()) - int(tx[valid][i].sum())) <= 5
                assert _near_share(jx[xy][i], jx[valid][i], tx[xy][i], tx[valid][i],
                                   1e-2) >= 0.95
                assert _near_share(tx[xy][i], tx[valid][i], jx[xy][i], jx[valid][i],
                                   1e-2) >= 0.95
        assert np.abs(test - jest).max() < 5e-2


def test_validator_votes_match_jax_on_the_drive(runs_projective):
    """Every vote of each run replayed through the other package's
    ``ClosureValidator`` from the same pending closures, poses, adjacency
    and graph edges: the same closures are accepted, so the JAX run's 17
    accepted closures are the port validator's too."""
    from srrg2_laser_slam_2d_tpu.models import loop_closure as jlc
    from srrg2_laser_slam_2d_tpu_torch.models import loop_closure as tlc

    jslam, tslam, jrec, trec = runs_projective
    for rec, slam, other in ((jrec, tslam, tlc), (trec, jslam, jlc)):
        assert len(rec.votes) >= 2
        accepted = 0
        for pending, poses, adjacency, edges, out in rec.votes:
            kw = {"device": "cpu"} if other is tlc else {}
            validator = other.ClosureValidator(slam.validator.cfg,
                                               slam.validator.closure_info, **kw)
            for p in pending:
                c = p["closure"]
                validator.pending.append({
                    "closure": other.ClosureCandidate(
                        c.query_map, c.candidate_map, np.asarray(c.estimate),
                        c.num_inliers, c.num_correspondences, c.chi_inliers),
                    "checks": p["checks"], "votes": p["votes"]})
            got = validator.vote(poses, adjacency, edges)
            assert [(c.query_map, c.candidate_map) for c in got] == out
            accepted += len(out)
        assert accepted >= (15 if rec is trec else 17)


def test_default_config_constructs():
    """``ChunkedGraphSLAM2D(GraphSLAMConfig())`` builds, as the JAX class
    does: the default ``projective`` backend is served."""
    slam = tcs.ChunkedGraphSLAM2D(GraphSLAMConfig(), device="cpu")
    assert slam.detector.cfg.backend == "projective" and slam.num_variables() == 0


def test_runner_message_surface_over_jsonl(tmp_path):
    """ChunkedSlamRunner consumes a JSONL message log (laser + odometry) and
    returns a timestamped trajectory with per-chunk timings and phases
    (the straight drive of tests/test_chunked_slam.py's runner test)."""
    ds = synthetic.simulate(synthetic.SyntheticConfig(
        steps=14, num_beams=512, max_variance=0.0, drift=(0.11, 0.0, 0.0)))
    base, _ = make_pipeline(ds, local_map_distance=0.5, enable_loops=False)
    tcfg = _port_config(dataclasses.replace(base.cfg, use_fast_tracker=True),
                        tmp_path / "slam.json")
    c = ds.config
    msgs = []
    for k in range(len(ds.ranges)):
        msgs.append(OdometryMessage(topic="/odom", timestamp=0.1 * k,
                                    pose=ds.robot_poses[k].astype(np.float32)))
        msgs.append(LaserMessage(topic="/scan", timestamp=0.1 * k, ranges=ds.ranges[k],
                                 angle_min=c.angle_min, angle_max=c.angle_max,
                                 range_min=c.range_min, range_max=c.range_max))
    path = str(tmp_path / "log.jsonl")
    tlogfile.write_jsonl(path, msgs)
    runner = tcs.ChunkedSlamRunner(
        slam_config=tcfg,
        preprocessor_config=tpre.PreprocessorConfig(voxelize_resolution=0.02,
                                                    normal_window=8),
        chunk=8, sensor_in_robot=np.array(c.sensor_in_robot, np.float32), device="cpu")
    n = runner.run(JsonlFileSource(path))
    assert n == len(ds.ranges) and len(runner.trajectory) == n
    assert [t for t, _, _ in runner.trajectory] == pytest.approx([0.1 * k for k in range(n)])
    summary = runner.timing_summary()
    assert summary["frames"] == n and summary["chunks"] == 2
    assert {"track", "materialize"} <= set(summary["phases"])
    err = np.abs(runner.trajectory[-1][1] - ds.robot_poses[-1])
    assert err[:2].max() < 0.15, err
