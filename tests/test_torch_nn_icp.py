"""NN-ICP kernel port (srrg2_laser_slam_2d_tpu_torch/ops/nn_icp_kernel.py):
the plain PyTorch ``fused_align_pairs`` against the JAX Pallas kernel in
interpret mode, J = 4 pairs of F = M = 512 points from one seed. Estimates
agree within 1e-4; inlier and correspondence counts within 1 % (the two
sides sum the normal equations in different orders).

The CUDA kernel compares only VALID points (csrc/nn_icp_kernel.cu packs
them to the front of each 512-point tile). That is exact because the
reference's result does not depend on what an invalid point holds:
``test_invalid_points_never_change_the_result`` gives invalid fixed and
moving points arbitrary coordinates and normals, and the plain result is
EQUAL to the one with zeros there, and agrees with the Pallas kernel."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srrg2_laser_slam_2d_tpu.ops import pallas_icp
from srrg2_laser_slam_2d_tpu.utils.cloud import Cloud as JCloud
from srrg2_laser_slam_2d_tpu_torch.ops import nn_icp_kernel as tnn
from srrg2_laser_slam_2d_tpu_torch.utils.interop import state_from_numpy

J, N = 4, 512


def _pairs(seed=0):
    """Walls with normals; moving = fixed seen from a perturbed pose, noisy,
    with some invalid points; initial guesses off the truth."""
    rng = np.random.default_rng(seed)
    f_xy, f_n, m_xy, m_n, inits = [], [], [], [], []
    for _ in range(J):
        a = rng.uniform(-6, 6, (6, 2))
        b = a + rng.uniform(-3, 3, (6, 2))
        seg = rng.integers(0, 6, N)
        p = a[seg] + rng.uniform(0, 1, (N, 1)) * (b[seg] - a[seg])
        d = (b - a)[seg]
        nrm = np.stack([-d[:, 1], d[:, 0]], 1) / np.linalg.norm(d, axis=1, keepdims=True)
        t = np.array([rng.uniform(-0.3, 0.3), rng.uniform(-0.3, 0.3),
                      rng.uniform(-0.1, 0.1)])
        c, s = np.cos(t[2]), np.sin(t[2])
        R = np.array([[c, -s], [s, c]])
        perm = rng.permutation(N)
        f_xy.append(p)
        f_n.append(nrm)
        m_xy.append((p[perm] - t[:2]) @ R + rng.normal(0, 0.005, (N, 2)))
        m_n.append(nrm[perm] @ R)
        inits.append(t + rng.normal(0, 0.05, 3))
    f32 = np.float32
    fixed = JCloud(np.array(f_xy, f32), np.array(f_n, f32), rng.uniform(size=(J, N)) > 0.05)
    moving = JCloud(np.array(m_xy, f32), np.array(m_n, f32), rng.uniform(size=(J, N)) > 0.05)
    return fixed, moving, np.array(inits, f32)


@pytest.mark.parametrize("refresh", [1, 3])
def test_plain_fused_align_pairs_matches_pallas(refresh):
    fixed, moving, inits = _pairs()
    kw = dict(iterations=12, max_distance=1.414, normal_cos=0.8, chi_threshold=0.05,
              min_inliers=10, corr_refresh=refresh)
    want = pallas_icp.fused_align_pairs(
        JCloud(*map(jnp.asarray, fixed)), JCloud(*map(jnp.asarray, moving)),
        jnp.asarray(inits), interpret=True, **kw)
    got = tnn.fused_align_pairs(state_from_numpy(fixed), state_from_numpy(moving),
                                torch.from_numpy(inits), **kw)
    np.testing.assert_allclose(got.estimate.numpy(), np.asarray(want.estimate), atol=1e-4)
    for field in ("num_inliers", "num_correspondences"):
        g, w = getattr(got, field).numpy(), np.asarray(getattr(want, field))
        assert np.all(np.abs(g - w) <= 0.01 * np.maximum(w, 1.0)), (field, g, w)
        assert w.min() > 100       # the pairs do align
    np.testing.assert_allclose(got.chi_inliers.numpy(), np.asarray(want.chi_inliers),
                               rtol=0.02, atol=1e-5)


def test_tied_nearest_fixed_points_are_averaged_like_pallas():
    """Duplicated fixed points (exact ties inside one 512-point tile) and a
    copy in a later tile, which must not replace the match (it is not
    strictly closer)."""
    fixed, moving, inits = _pairs(seed=1)
    xy = np.array(fixed.xy)
    xy[:, 100:150] = xy[:, 0:50]
    fixed = fixed._replace(xy=np.concatenate([xy, xy], axis=1),
                           normal=np.concatenate([fixed.normal] * 2, axis=1),
                           valid=np.concatenate([fixed.valid] * 2, axis=1))
    kw = dict(iterations=6, max_distance=1.414, normal_cos=0.8, chi_threshold=0.05,
              min_inliers=10, corr_refresh=2)
    want = pallas_icp.fused_align_pairs(
        JCloud(*map(jnp.asarray, fixed)), JCloud(*map(jnp.asarray, moving)),
        jnp.asarray(inits), interpret=True, **kw)
    got = tnn.fused_align_pairs(state_from_numpy(fixed), state_from_numpy(moving),
                                torch.from_numpy(inits), **kw)
    np.testing.assert_allclose(got.estimate.numpy(), np.asarray(want.estimate), atol=1e-4)
    # the expanded squared distance cancels (|m|^2 + |f|^2 ~ 1e2, ulp ~ 1e-5),
    # and XLA fuses its multiply-adds, so a match whose distance sits at the
    # gate may fall on either side: 2 % on the doubled fixed cloud
    np.testing.assert_allclose(got.num_correspondences.numpy(),
                               np.asarray(want.num_correspondences), rtol=0.02)


def test_cuda_wrapper_rejects_what_the_kernel_does_not_take():
    fixed, moving, inits = _pairs()
    fixedP = tnn.pack_fixed(state_from_numpy(fixed))
    movingP = tnn.pack_moving(state_from_numpy(moving))
    with pytest.raises(ValueError):    # CPU tensors never reach the launcher
        tnn._launch(fixedP, movingP, torch.from_numpy(inits), 3, 1.0, 0.8, 0.05, 10, 1)


def _ragged_pairs(rng, n_pairs: int, F: int, live: int, M: int):
    """Fixed clouds of F rows of which the first ``live`` hold wall points
    (the rest invalid, zeros), moving clouds of M points seen from a pose
    near the identity, 5 % of both invalid at random; initial guesses."""
    f32 = np.float32
    fxy, fn = np.zeros((n_pairs, F, 2), f32), np.zeros((n_pairs, F, 2), f32)
    mxy, mn = np.zeros((n_pairs, M, 2), f32), np.zeros((n_pairs, M, 2), f32)
    inits = np.zeros((n_pairs, 3), f32)
    for j in range(n_pairs):
        a = rng.uniform(-6, 6, (6, 2))
        b = a + rng.uniform(-3, 3, (6, 2))
        seg = rng.integers(0, 6, live)
        p = a[seg] + rng.uniform(0, 1, (live, 1)) * (b[seg] - a[seg])
        d = (b - a)[seg]
        nrm = np.stack([-d[:, 1], d[:, 0]], 1) / np.linalg.norm(d, axis=1, keepdims=True)
        t = np.array([rng.uniform(-0.3, 0.3), rng.uniform(-0.3, 0.3), rng.uniform(-0.1, 0.1)])
        c, s = np.cos(t[2]), np.sin(t[2])
        R = np.array([[c, -s], [s, c]])
        pick = rng.integers(0, live, M)
        fxy[j, :live], fn[j, :live] = p, nrm
        mxy[j] = (p[pick] - t[:2]) @ R + rng.normal(0, 0.005, (M, 2))
        mn[j] = nrm[pick] @ R
        inits[j] = t + rng.normal(0, 0.05, 3)
    fvalid = (np.arange(F) < live)[None] & (rng.uniform(size=(n_pairs, F)) > 0.05)
    mvalid = rng.uniform(size=(n_pairs, M)) > 0.05
    return JCloud(fxy, fn, fvalid), JCloud(mxy, mn, mvalid), inits


def _scramble_invalid(rng, cloud):
    """The cloud with arbitrary coordinates (within 50 m) and unit normals
    in every invalid row."""
    bad = ~cloud.valid
    xy, nm = np.array(cloud.xy), np.array(cloud.normal)
    xy[bad] = rng.uniform(-50, 50, (bad.sum(), 2))
    ang = rng.uniform(-np.pi, np.pi, bad.sum())
    nm[bad] = np.stack([np.cos(ang), np.sin(ang)], 1)
    return cloud._replace(xy=xy.astype(np.float32), normal=nm.astype(np.float32))


@pytest.mark.parametrize("case", ["ragged-fixed", "invalid-tile"])
def test_invalid_points_never_change_the_result(case):
    """Case "ragged-fixed": 700 live fixed rows in a 1,024-row cloud (the
    CUDA kernel takes F = 700 as it is) and M = 600 moving points; case
    "invalid-tile": F = 1,536 with the whole second 512-point tile invalid,
    M = 900. Invalid rows with arbitrary contents give the EQUAL plain
    result; it agrees with the Pallas kernel in interpret mode as above."""
    rng = np.random.default_rng(5)
    if case == "ragged-fixed":
        fixed, moving, inits = _ragged_pairs(rng, 2, 1024, 700, 600)
    else:
        fixed, moving, inits = _ragged_pairs(rng, 2, 1536, 1536, 900)
        fixed = fixed._replace(valid=fixed.valid & ((np.arange(1536) < 512)
                                                    | (np.arange(1536) >= 1024))[None])
    kw = dict(iterations=12, max_distance=1.414, normal_cos=0.8, chi_threshold=0.05,
              min_inliers=10, corr_refresh=3)
    clean = tnn.fused_align_pairs(state_from_numpy(fixed), state_from_numpy(moving),
                                  torch.from_numpy(inits), **kw)
    sf, sm = _scramble_invalid(rng, fixed), _scramble_invalid(rng, moving)
    assert np.abs(np.array(sf.xy) - np.array(fixed.xy)).max() > 10
    got = tnn.fused_align_pairs(state_from_numpy(sf), state_from_numpy(sm),
                                torch.from_numpy(inits), **kw)
    for field in got._fields:
        assert torch.equal(getattr(got, field), getattr(clean, field)), field
    want = pallas_icp.fused_align_pairs(
        JCloud(*map(jnp.asarray, sf)), JCloud(*map(jnp.asarray, sm)), jnp.asarray(inits),
        interpret=True, **kw)
    np.testing.assert_allclose(got.estimate.numpy(), np.asarray(want.estimate), atol=1e-4)
    for field in ("num_inliers", "num_correspondences"):
        g, w = getattr(got, field).numpy(), np.asarray(getattr(want, field))
        assert np.all(np.abs(g - w) <= 0.01 * np.maximum(w, 1.0)), (field, g, w)
        assert w.min() > 100
