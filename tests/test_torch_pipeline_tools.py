"""``bench/pipeline.py`` of the port (``track_sequence``,
``track_sequence_batch``) against the JAX package's, from one carried-over
populated state on routes C (plain ICP), A (banded aligner) and B (dense
aligner), each also with the merge canvas reused as the next clip.

Inputs: ``bench/synthetic.simulate`` (seed 0) at 256 beams over +-0.4 pi,
tracked on a 256-beam canvas over +-pi, so no measurement point sits on a
beam-bin edge (on-grid scans differ by bin-edge flips; ``ROADMAP.md`` Queue
3). The JAX side runs its Pallas kernels in interpret mode.

Tolerances: the first frame, tracked from one state, to 1e-5 (chi rtol 1e-3,
inliers equal) on every route; on the plain routes every frame to 1e-5
against the reference's step chain (``track_step_impl`` frame by frame; the
port reads 2.3e-7). Over the whole sequence a scene point that one merge
puts on a beam-bin edge is merged in one package and appended in the other
(as in ``tests/test_torch_tracker.py``), and the next frames carry it: the
reference's own ``lax.scan`` and its own step chain differ by up to 2.4e-5
on route C and 5.5e-4 on route B with reuse on this drive, so every frame
is held to 1e-3 against ``track_sequence`` (inliers within 1, scene counts
within 2). ``track_sequence_batch`` equals B single
``track_sequence`` calls exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srrg2_laser_slam_2d_tpu.bench import pipeline as jpipe
from srrg2_laser_slam_2d_tpu.bench import synthetic as jsyn
from srrg2_laser_slam_2d_tpu.models import tracker as jtracker
from srrg2_laser_slam_2d_tpu.models.preprocessor import PreprocessorConfig as JPC
from srrg2_laser_slam_2d_tpu.ops import icp as jicp
from srrg2_laser_slam_2d_tpu.ops.projector import PolarProjection as JProjection
from srrg2_laser_slam_2d_tpu_torch.bench import pipeline as tpipe
from srrg2_laser_slam_2d_tpu_torch.bench import synthetic as tsyn
from srrg2_laser_slam_2d_tpu_torch.models import tracker as ttracker
from srrg2_laser_slam_2d_tpu_torch.models.preprocessor import PreprocessorConfig
from srrg2_laser_slam_2d_tpu_torch.ops import icp as ticp
from srrg2_laser_slam_2d_tpu_torch.ops.projector import PolarProjection
from srrg2_laser_slam_2d_tpu_torch.utils.interop import state_from_numpy

BEAMS = 256
ITS = 10
STEPS = 5
JP = JProjection.make(cols=BEAMS, angle_min=-np.pi, angle_max=np.pi, range_min=0.3,
                      range_max=20.0)
ROUTES = {
    "C": {},
    "C-reuse": dict(reuse_clip_canvas=True),
    "A": dict(use_fused_aligner=True, banded_aligner=True),
    "A-reuse": dict(use_fused_aligner=True, banded_aligner=True, reuse_clip_canvas=True),
    "B": dict(use_fused_aligner=True),
    "B-reuse": dict(use_fused_aligner=True, reuse_clip_canvas=True),
}


def _port(tree):
    return state_from_numpy(jax.tree.map(np.asarray, tree))


@pytest.fixture(scope="module")
def drive():
    ds = jsyn.simulate(jsyn.SyntheticConfig(steps=STEPS, num_beams=BEAMS))
    meas = jpipe.preprocess_batch(ds.projection, JPC(voxelize_resolution=0.02, normal_window=8),
                                  jnp.asarray(ds.ranges))
    return ds, meas


def _configs(flags):
    al = dict(max_iterations=ITS, point_distance=0.5, normal_cos=0.8)
    jcfg = jtracker.TrackerConfig(scene_capacity=512, projection=JP,
                                  aligner=jicp.AlignerConfig(**al), **flags)
    tcfg = ttracker.TrackerConfig(scene_capacity=512, projection=PolarProjection(*JP),
                                  aligner=ticp.AlignerConfig(**al), **flags)
    return jcfg, tcfg


def _populated(jcfg, ds, meas):
    sir = np.array(ds.config.sensor_in_robot, np.float32)
    js = jtracker.populate(jcfg, jtracker.init_state(jcfg, sir),
                           jax.tree.map(lambda x: x[0], meas))
    return js._replace(last_odom=jnp.asarray(ds.robot_poses[0], jnp.float32),
                       has_odom=jnp.asarray(True))


def _jax_stepped(jcfg, js, rest, odoms, ov):
    """The JAX ``track_sequence``'s body frame by frame
    (``track_step_impl``, the clip cache from the second frame on where the
    route reuses it): poses [T, 3]."""
    poses = []
    for k in range(odoms.shape[0]):
        js, _ = jtracker.track_step_impl(jcfg, js, jax.tree.map(lambda x: x[k], rest), odoms[k],
                                         ov[k], use_clip_cache=jcfg.reuse_clip_canvas and k > 0)
        poses.append(np.asarray(js.robot_in_local_map))
    return np.stack(poses)


@pytest.mark.parametrize("route", list(ROUTES))
def test_track_sequence_matches_jax(drive, route):
    ds, meas = drive
    jcfg, tcfg = _configs(ROUTES[route])
    js = _populated(jcfg, ds, meas)
    rest = jax.tree.map(lambda x: x[1:], meas)
    odoms = jnp.asarray(ds.robot_poses[1:], jnp.float32)
    ov = jnp.ones(STEPS, bool)
    jfin, (jposes, jchi, jinl) = jpipe.track_sequence(jcfg, js, rest, odoms, ov)
    tfin, (tposes, tchi, tinl) = tpipe.track_sequence(
        tcfg, _port(js), _port(rest), torch.from_numpy(np.array(odoms)),
        torch.ones(STEPS, dtype=torch.bool))
    assert tposes.shape == (STEPS, 3) and tchi.shape == tinl.shape == (STEPS,)
    jposes, tposes = np.asarray(jposes), tposes.numpy()
    # the first frame, tracked from one state in both packages
    np.testing.assert_allclose(tposes[0], jposes[0], atol=1e-5)
    np.testing.assert_allclose(float(tchi[0]), float(jchi[0]), rtol=1e-3)
    assert int(tinl[0]) == int(jinl[0]) > 50
    if not jcfg.use_fused_aligner:
        # plain ICP: every frame against the reference's step chain
        np.testing.assert_allclose(tposes, _jax_stepped(jcfg, js, rest, odoms, ov), atol=1e-5)
    # every frame: the merges carry bin-edge flips of scene points forward
    np.testing.assert_allclose(tposes, jposes, atol=1e-3)
    assert np.abs(tinl.numpy() - np.asarray(jinl)).max() <= 1
    np.testing.assert_allclose(tfin.robot_in_local_map.numpy(),
                               np.asarray(jfin.robot_in_local_map), atol=1e-3)
    assert abs(int(tfin.scene.valid.sum()) - int(jfin.scene.valid.sum())) <= 2


def test_track_sequence_batch_equals_single_calls(drive):
    """Two streams (two different populated states over two different
    drives) through ``track_sequence_batch`` equal two ``track_sequence``
    calls."""
    ds, meas = drive
    ds1 = tsyn.simulate(tsyn.SyntheticConfig(steps=STEPS, num_beams=BEAMS, seed=1), "cpu")
    _, tcfg = _configs(ROUTES["A-reuse"])
    pcfg = PreprocessorConfig(voxelize_resolution=0.02, normal_window=8)
    stacks = [_port(meas), tpipe.preprocess_batch(ds1.projection, pcfg,
                                                  torch.from_numpy(ds1.ranges))]
    odoms = [torch.from_numpy(ds.robot_poses), torch.from_numpy(ds1.robot_poses)]
    sir = np.array(ds.config.sensor_in_robot, np.float32)
    states = [ttracker.populate(tcfg, ttracker.init_state(tcfg, sir), tpipe.tree_index(s, 0))
              for s in stacks]
    rests = [s.map(lambda x: x[1:]) for s in stacks]
    ov = torch.ones(STEPS, dtype=torch.bool)
    singles = [tpipe.track_sequence(tcfg, st, r, o[1:], ov)
               for st, r, o in zip(states, rests, odoms)]
    bfin, btr = tpipe.track_sequence_batch(
        tcfg, tpipe.tree_stack(states), tpipe.tree_stack(rests),
        torch.stack([o[1:] for o in odoms]), torch.stack([ov, ov]))
    assert btr[0].shape == (2, STEPS, 3)
    for b, (fin, tr) in enumerate(singles):
        for i in range(3):
            assert torch.equal(btr[i][b], tr[i])
        assert torch.equal(bfin.robot_in_local_map[b], fin.robot_in_local_map)
        assert torch.equal(bfin.scene.xy[b], fin.scene.xy)
        assert torch.equal(bfin.clip_cache_rows[b], fin.clip_cache_rows)
    # the two streams really differ
    assert not torch.equal(btr[0][0], btr[0][1])


def test_track_sequence_reuse_matches_plain():
    """The JAX golden ``tests/test_visual_apps.py``: canvas reuse follows the
    plain path to sub-centimetre over 8 frames at 512 beams."""
    ds = tsyn.simulate(tsyn.SyntheticConfig(steps=7, num_beams=512), "cpu")
    pcfg = PreprocessorConfig(voxelize_resolution=0.02, normal_window=8)
    proj = PolarProjection.make(cols=512, angle_min=-np.pi, angle_max=np.pi, range_min=0.1,
                                range_max=30.0)
    meas = tpipe.preprocess_batch(ds.projection, pcfg, torch.from_numpy(ds.ranges))
    odoms = torch.from_numpy(ds.robot_poses)
    ov = torch.ones(len(ds.ranges), dtype=torch.bool)
    results = {}
    for reuse in (False, True):
        tcfg = ttracker.TrackerConfig(scene_capacity=2048, projection=proj,
                                      aligner=ticp.AlignerConfig(max_iterations=8),
                                      reuse_clip_canvas=reuse)
        s0 = ttracker.init_state(tcfg, sensor_in_robot=np.array(ds.config.sensor_in_robot,
                                                                 np.float32))
        s0 = ttracker.populate(tcfg, s0, tpipe.tree_index(meas, 0))
        _, traces = tpipe.track_sequence(tcfg, s0, meas, odoms, ov)
        results[reuse] = traces[0].numpy()
    np.testing.assert_allclose(results[True], results[False], atol=0.01)
