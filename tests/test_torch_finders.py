"""The port's grid and brute-force correspondence finders
(srrg2_laser_slam_2d_tpu_torch/ops/{distance_map,correspond}.py) and their
routes through ``icp.align`` against the JAX package on the CPU, case by
case after tests/test_finders.py and tests/test_finder_plugins.py:

- the jump-flooded nearest field: ``idx`` EQUAL, ``dist2`` within 1e-6;
- ``lookup``: EQUAL;
- ``find_nn_grid``: correspondences EQUAL;
- ``find_bruteforce_nn``: indices equal except where the two candidates'
  squared distances differ by less than 1e-6 (the distance matrix's cross
  term is a product whose rounding may differ);
- ``icp.align`` on two synthetic scans with each of the three finders: the
  port's estimate within 1e-4 of the JAX package's, both within 0.03 of the
  ground truth; a batched call over K = 3 fixed clouds equal to three
  single calls.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srrg2_laser_slam_2d_tpu.ops import correspond as jcorr
from srrg2_laser_slam_2d_tpu.ops import distance_map as jdm
from srrg2_laser_slam_2d_tpu.ops import icp as jicp
from srrg2_laser_slam_2d_tpu.utils import cloud as jcloud
from srrg2_laser_slam_2d_tpu.utils import geometry as jg
from srrg2_laser_slam_2d_tpu_torch.ops import correspond as tcorr
from srrg2_laser_slam_2d_tpu_torch.ops import distance_map as tdm
from srrg2_laser_slam_2d_tpu_torch.ops import icp as ticp
from srrg2_laser_slam_2d_tpu_torch.ops.projector import PolarProjection as TPolarProjection
from srrg2_laser_slam_2d_tpu_torch.utils import cloud as tcloud
from tests.test_finder_plugins import PROJ, setup_scans


def _fixed():
    """tests/test_finders.py's fixed cloud: 64 points, capacity 128."""
    rng = np.random.default_rng(0)
    xy = rng.uniform(-2, 2, size=(64, 2)).astype(np.float32)
    nrm = rng.normal(size=(64, 2)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return xy, nrm


def _both(xy, nrm, capacity=128):
    return (jcloud.from_numpy(xy, nrm, capacity=capacity),
            tcloud.from_numpy(xy, nrm, capacity=capacity))


def _port_cloud(c) -> tcloud.Cloud:
    return tcloud.Cloud(*(torch.from_numpy(np.array(x)) for x in c))


@pytest.mark.parametrize("rows,res", [(128, 0.05), (256, 0.02)])
def test_nearest_field_matches_jax(rows, res):
    xy, nrm = _fixed()
    jf, tf = _both(xy, nrm)
    jfield = jdm.build(jf, rows=rows, cols=rows, resolution=res)
    tfield = tdm.build(tf, rows=rows, cols=rows, resolution=res)
    np.testing.assert_array_equal(tfield.origin.numpy(), np.asarray(jfield.origin))
    np.testing.assert_array_equal(tfield.idx.numpy(), np.asarray(jfield.idx))
    np.testing.assert_allclose(tfield.dist2.numpy(), np.asarray(jfield.dist2), rtol=1e-6,
                               atol=1e-6)
    assert (tfield.idx.numpy() >= 0).all()


def test_lookup_matches_jax():
    xy, nrm = _fixed()
    jf, tf = _both(xy, nrm)
    jfield = jdm.build(jf, rows=256, cols=256, resolution=0.02)
    tfield = tdm.build(tf, rows=256, cols=256, resolution=0.02)
    rng = np.random.default_rng(1)
    # inside the grid, the fixed points themselves, and outside it
    q = np.concatenate([rng.uniform(-1.8, 1.8, size=(200, 2)), xy,
                        rng.uniform(-9, 9, size=(50, 2))]).astype(np.float32)
    ji, jd = jdm.lookup(jfield, jnp.asarray(q))
    ti, td = tdm.lookup(tfield, torch.from_numpy(q))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert (ti.numpy() == -1).any() and (ti.numpy()[:264] >= 0).all()


def _estimate_case():
    """Fixed points moved back by the inverse of an estimate: seen through
    the estimate, each matches itself."""
    xy, nrm = _fixed()
    jf, tf = _both(xy, nrm)
    t = jnp.array([0.3, -0.2, 0.25])
    inv = jg.inverse(t)
    jm = jcloud.Cloud(xy=jg.transform_points(inv, jf.xy), normal=jg.rotate_vectors(inv, jf.normal),
                      valid=jf.valid)
    return jf, tf, jm, _port_cloud(jm), t


@pytest.mark.parametrize("case", ["identity", "estimate"])
def test_grid_finder_matches_jax(case):
    if case == "identity":
        xy, nrm = _fixed()
        jf, tf = _both(xy, nrm)
        jm, tm, t = jf, tf, jnp.zeros(3)
    else:
        jf, tf, jm, tm, t = _estimate_case()
    jfield = jdm.build(jf, rows=256, cols=256, resolution=0.02)
    tfield = tdm.build(tf, rows=256, cols=256, resolution=0.02)
    jc = jcorr.find_nn_grid(jfield, jf, jm, t, max_distance_m=0.5, normal_cos=0.8)
    tc = tcorr.find_nn_grid(tfield, tf, tm, torch.from_numpy(np.array(t)),
                            max_distance_m=0.5, normal_cos=0.8)
    for name, a, b in zip(jc._fields, jc, tc):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
    v = tc.valid.numpy()
    assert v[:64].all() and not v[64:].any()
    np.testing.assert_array_equal(tc.fixed_idx.numpy()[:64], np.arange(64))


def _hold_bruteforce(jc, tc, fixed_xy, moved_xy):
    ji, ti = np.asarray(jc.fixed_idx), tc.fixed_idx.numpy()
    diff = ji != ti
    if diff.any():
        d2 = ((fixed_xy[:, None, :].astype(np.float64)
               - moved_xy[None, :, :].astype(np.float64)) ** 2).sum(-1)
        k = np.where(diff)[0]
        assert np.all(np.abs(d2[ji[k], k] - d2[ti[k], k]) < 1e-6), k
    same = ~diff
    np.testing.assert_array_equal(tc.valid.numpy()[same], np.asarray(jc.valid)[same])
    np.testing.assert_array_equal(tc.moving_idx.numpy(), np.asarray(jc.moving_idx))


@pytest.mark.parametrize("case", ["shift_5mm", "shift_5cm", "estimate", "random"])
def test_bruteforce_finder_matches_jax(case):
    xy, nrm = _fixed()
    jf, tf = _both(xy, nrm)
    t = jnp.zeros(3)
    if case == "estimate":
        jf, tf, jm, tm, t = _estimate_case()
        cos = 0.9
    else:
        if case == "random":
            rng = np.random.default_rng(5)
            mxy = rng.uniform(-2, 2, size=(100, 2)).astype(np.float32)
            mnrm = rng.normal(size=(100, 2)).astype(np.float32)
            mnrm /= np.linalg.norm(mnrm, axis=1, keepdims=True)
        else:
            shift = 0.005 if case == "shift_5mm" else 0.05
            mxy, mnrm = xy + np.array([shift, 0.0], np.float32), nrm
        jm, tm = _both(mxy, mnrm)
        cos = -1.0 if case == "random" else 0.8
    max_d = 0.3 if case == "random" else 0.01
    jc = jcorr.find_bruteforce_nn(jf, jm, t, max_distance_m=max_d, normal_cos=cos)
    tc = tcorr.find_bruteforce_nn(tf, tm, torch.from_numpy(np.array(t)),
                                  max_distance_m=max_d, normal_cos=cos)
    moved = np.asarray(jg.transform_points(t, jm.xy))
    _hold_bruteforce(jc, tc, np.asarray(jf.xy), moved)
    v = tc.valid.numpy()
    if case in ("shift_5mm", "estimate"):
        assert v[:64].all()
        np.testing.assert_array_equal(tc.fixed_idx.numpy()[:64], np.arange(64))
    elif case == "shift_5cm":
        assert not v.any()


_TPROJ = TPolarProjection.make(cols=512, angle_min=-np.pi, angle_max=np.pi,
                               range_min=0.1, range_max=30.0)


def _aligner(finder):
    kw = dict(max_iterations=10, finder=finder, finder_max_distance=0.5,
              finder_resolution=0.05, finder_grid_size=512)
    return jicp.AlignerConfig(**kw), ticp.AlignerConfig(**kw)


@pytest.mark.parametrize("finder", ["projective", "nn_grid", "bruteforce"])
def test_finder_plugins_align_to_gt(finder):
    ds, clouds = setup_scans()
    jfixed, jmoving = clouds[0], clouds[1]
    t_gt = np.asarray(jg.relative(jnp.asarray(ds.sensor_poses[0]),
                                  jnp.asarray(ds.sensor_poses[1])))
    jcfg, tcfg = _aligner(finder)
    jres = jicp.align(jcfg, PROJ, jfixed, jmoving, jnp.zeros(3))
    tres = ticp.align(tcfg, _TPROJ, _port_cloud(jfixed), _port_cloud(jmoving), torch.zeros(3))
    est = tres.estimate.numpy()
    np.testing.assert_allclose(est, np.asarray(jres.estimate), atol=1e-4)
    assert np.abs(est - t_gt).max() < 0.03, (finder, est, t_gt)
    assert int(tres.num_correspondences) > 50
    assert abs(int(tres.num_correspondences) - int(jres.num_correspondences)) <= 2
    assert int(tres.iterations) == int(jres.iterations)


@pytest.mark.parametrize("finder", ["nn_grid", "bruteforce"])
def test_batched_align_equals_single_calls(finder):
    """One ``align`` over K = 3 fixed clouds (the loop detector's batch;
    one nearest field each) against three single calls."""
    _, clouds = setup_scans()
    fixed = [_port_cloud(c) for c in clouds[:3]]
    moving = _port_cloud(clouds[3])
    _, tcfg = _aligner(finder)
    inits = torch.tensor([[0.0, 0.0, 0.0], [0.02, -0.01, 0.01], [-0.01, 0.0, -0.02]])
    batched = ticp.align(tcfg, _TPROJ, tcloud.stack(fixed), moving, inits)
    for k in range(3):
        one = ticp.align(tcfg, _TPROJ, fixed[k], moving, inits[k])
        np.testing.assert_allclose(batched.estimate[k].numpy(), one.estimate.numpy(), atol=1e-6)
        assert int(batched.num_correspondences[k]) == int(one.num_correspondences)
        assert int(batched.iterations[k]) == int(one.iterations)
