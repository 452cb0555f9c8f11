"""Port of the SE(2) geometry and the masked cloud
(srrg2_laser_slam_2d_tpu_torch/utils/{geometry,cloud}.py) against the JAX
package, from the same seeded numpy inputs. Both sides run the same float32
operations, so they agree to within a few ulp (atol 1e-6). The one
exception is ``voxelize_sequential``: it takes each run's sum as the
difference of two prefix sums over the whole scan, and XLA and PyTorch add
those prefixes in different orders, so the run means differ at the ulp of
the running total (|prefix| ~ 1e3 m here, ulp ~ 6e-5): atol 1e-4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srrg2_laser_slam_2d_tpu.utils import cloud as jcloud
from srrg2_laser_slam_2d_tpu.utils import geometry as jgeo
from srrg2_laser_slam_2d_tpu_torch.utils import cloud as tcloud
from srrg2_laser_slam_2d_tpu_torch.utils import geometry as tgeo
from srrg2_laser_slam_2d_tpu_torch.utils.interop import state_from_numpy

ATOL = 1e-6


def _poses(rng, n):
    p = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    p[:, 2] = rng.uniform(-3.1, 3.1, n)
    return p


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=0)


@pytest.mark.parametrize("fn", ["compose", "relative"])
def test_pose_pairs_match_jax(fn):
    rng = np.random.default_rng(0)
    a, b = _poses(rng, 64), _poses(rng, 64)
    want = getattr(jgeo, fn)(jnp.asarray(a), jnp.asarray(b))
    got = getattr(tgeo, fn)(torch.from_numpy(a), torch.from_numpy(b))
    _close(got, want)
    # the angle is wrapped to (-pi, pi]
    assert np.all(np.abs(got[:, 2].numpy()) <= np.pi + 1e-6)


@pytest.mark.parametrize("fn", ["inverse", "v2t", "wrap_angle", "rot", "exp_se2",
                                "get3d_from_2d_pose", "t2tqxyzw"])
def test_pose_maps_match_jax(fn):
    rng = np.random.default_rng(1)
    a = _poses(rng, 64)
    arg = {"wrap_angle": a[:, 2] * 3, "rot": a[:, 2]}.get(fn, a)
    _close(getattr(tgeo, fn)(torch.from_numpy(arg)),
           getattr(jgeo, fn)(jnp.asarray(arg)))


def test_t2v_inverts_v2t_like_jax():
    rng = np.random.default_rng(2)
    T = np.asarray(jgeo.v2t(jnp.asarray(_poses(rng, 32))))
    _close(tgeo.t2v(torch.from_numpy(T.copy())), jgeo.t2v(jnp.asarray(T)))


def _cloud(rng, n, frac_valid=0.7):
    xy = rng.uniform(-6, 6, (n, 2)).astype(np.float32)
    ang = rng.uniform(-np.pi, np.pi, n)
    nm = np.stack([np.cos(ang), np.sin(ang)], 1).astype(np.float32)
    valid = rng.uniform(size=n) < frac_valid
    return xy, nm, valid


def _jc(xy, nm, valid):
    return jcloud.Cloud(jnp.asarray(xy), jnp.asarray(nm), jnp.asarray(valid))


def _same_cloud(got, want, atol=ATOL):
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    v = got.valid.numpy()
    _close(got.xy.numpy()[v], np.asarray(want.xy)[v], atol)
    _close(got.normal.numpy()[v], np.asarray(want.normal)[v], atol)


def test_transform_compact_repad_match_jax():
    rng = np.random.default_rng(3)
    xy, nm, valid = _cloud(rng, 200)
    pose = _poses(rng, 1)[0]
    jc, tc = _jc(xy, nm, valid), state_from_numpy(_jc(xy, nm, valid))
    _same_cloud(tcloud.transform(tc, torch.from_numpy(pose)),
                jcloud.transform(jc, jnp.asarray(pose)))
    _same_cloud(tcloud.compact(tc), jcloud.compact(jc))
    for cap in (128, 200, 256):
        _same_cloud(tcloud.repad(tc, cap), jcloud.repad(jc, cap))
    assert int(tc.count()) == int(jc.count())


def test_voxelize_grid_matches_jax():
    rng = np.random.default_rng(4)
    xy, nm, valid = _cloud(rng, 300)
    xy = np.round(xy * 4) / 4 + rng.normal(0, 0.01, xy.shape).astype(np.float32)
    got = tcloud.voxelize(state_from_numpy(_jc(xy, nm, valid)), 0.1, 1.0)
    want = jcloud.voxelize(_jc(xy, nm, valid), 0.1, 1.0)
    _same_cloud(got, want, atol=1e-5)


def test_voxelize_sequential_matches_jax_on_scan_ordered_clouds():
    """Scan-ordered points (consecutive beams of a polar scan) so that runs
    of same-cell points form, batched over two scans."""
    rng = np.random.default_rng(5)
    scans = []
    for k in range(2):
        ang = np.linspace(-np.pi, np.pi, 361, endpoint=False)
        r = 3.0 + 0.5 * np.sin(3 * ang + k) + rng.normal(0, 0.003, ang.size)
        xy = np.stack([r * np.cos(ang), r * np.sin(ang)], 1).astype(np.float32)
        nm = -xy / np.linalg.norm(xy, axis=1, keepdims=True)
        scans.append((xy, nm.astype(np.float32), rng.uniform(size=361) < 0.9))
    xy, nm, valid = (np.stack(f) for f in zip(*scans))
    got = tcloud.voxelize_sequential(
        tcloud.Cloud(torch.from_numpy(xy), torch.from_numpy(nm), torch.from_numpy(valid)),
        0.05, 1.0)
    for k in range(2):
        want = jcloud.voxelize_sequential(_jc(xy[k], nm[k], valid[k]), 0.05, 1.0)
        _same_cloud(got.map(lambda x: x[k]), want, atol=1e-4)
