"""The polar projector of the port against the JAX package: the plain
version of the projector kernel against ``project_local_pallas`` in
interpret mode, the tie rule, the sort backend and the backend switch of
``ops/projector.project_local``. Inputs come from numpy with a seed.

Tolerances: depths agree to 1e-6 (XLA may fuse x*x + y*y into one
multiply-add); winner indices are equal on these clouds (a point on a
beam-bin edge could differ; none lies there)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srrg2_laser_slam_2d_tpu.ops import pallas_projector as jpp
from srrg2_laser_slam_2d_tpu.ops import projector as jproj
from srrg2_laser_slam_2d_tpu.utils.cloud import Cloud as JCloud
from srrg2_laser_slam_2d_tpu_torch.ops import projector as tproj
from srrg2_laser_slam_2d_tpu_torch.ops import projector_kernel as pk
from srrg2_laser_slam_2d_tpu_torch.utils.cloud import Cloud

COLS = 200
JP = jproj.PolarProjection.make(cols=COLS, angle_min=-np.pi, angle_max=np.pi,
                                range_min=0.3, range_max=20.0)
TP = tproj.PolarProjection(*JP)


def _cloud(seed: int, n: int = 600):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-6, 6, (n, 2)).astype(np.float32)
    nm = rng.normal(size=(n, 2)).astype(np.float32)
    nm /= np.linalg.norm(nm, axis=1, keepdims=True)
    return xy, nm, rng.uniform(size=n) > 0.1


def _assert_canvas(t, j, depth_tol=1e-6):
    np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))
    np.testing.assert_array_equal(t.idx.numpy(), np.asarray(j.idx))
    v = np.asarray(j.valid)
    np.testing.assert_allclose(t.depth.numpy()[v], np.asarray(j.depth)[v], atol=depth_tol)


@pytest.mark.parametrize("seed,n,chunk", [(0, 600, 256), (1, 300, 1024), (2, 1000, 128)])
def test_plain_version_matches_pallas_interpret(seed, n, chunk):
    xy, _, valid = _cloud(seed, n)
    j = jpp.project_local_pallas(JP, jnp.asarray(xy), jnp.asarray(valid), chunk=chunk,
                                 interpret=True)
    before = pk.launches
    t = pk.project_local(TP, torch.from_numpy(xy), torch.from_numpy(valid))
    assert pk.launches == before          # a CPU tensor takes the plain version
    assert int(t.valid.sum()) > 50
    _assert_canvas(t, j)


def test_tie_rule_closest_depth_then_lowest_index():
    """Three points on one beam: the closer one wins; of two at the same
    depth the lower index wins, in the port and in the Pallas kernel."""
    ang = (100.5 - JP.c) / JP.f
    ray = np.array([np.cos(ang), np.sin(ang)], np.float32)
    xy = np.stack([3.0 * ray, 2.0 * ray, 2.0 * ray, 5.0 * ray]).astype(np.float32)
    valid = np.ones(4, bool)
    t = pk.project_local(TP, torch.from_numpy(xy), torch.from_numpy(valid))
    j = jpp.project_local_pallas(JP, jnp.asarray(xy), jnp.asarray(valid), interpret=True)
    assert int(t.idx[100]) == int(j.idx[100]) == 1
    assert float(t.depth[100]) == pytest.approx(2.0, abs=1e-6)
    # with the first of the pair invalid the other one takes the beam
    valid[1] = False
    t = pk.project_local(TP, torch.from_numpy(xy), torch.from_numpy(valid))
    assert int(t.idx[100]) == 2 and int(t.valid.sum()) == 1


def test_sort_backend_matches_jax_sort():
    xy, nm, valid = _cloud(3)
    j = jproj.project_local_sort(JP, JCloud(jnp.asarray(xy), jnp.asarray(nm), jnp.asarray(valid)))
    t = tproj.project_local_sort(TP, Cloud(torch.from_numpy(xy), torch.from_numpy(nm),
                                           torch.from_numpy(valid)))
    _assert_canvas(t, j)


def test_backend_switch_scatter_sort_kernel_agree(monkeypatch):
    """The three backends give one canvas on a cloud without bin-edge
    points; the kernel backend takes batches cloud by cloud; an unknown
    backend raises."""
    xy, nm, valid = _cloud(4)
    cloud = Cloud(torch.from_numpy(xy), torch.from_numpy(nm), torch.from_numpy(valid))
    out = {}
    for backend in (None, "scatter", "sort", "kernel"):
        monkeypatch.setattr(tproj, "ZBUFFER_BACKEND", backend)
        out[backend] = tproj.project_local(TP, cloud)
    for backend in ("scatter", "sort", "kernel"):
        _assert_canvas(out[backend], out[None], depth_tol=0.0)
    batch = cloud.map(lambda x: torch.stack([x, x.flip(0)]))
    monkeypatch.setattr(tproj, "ZBUFFER_BACKEND", "kernel")
    kb = tproj.project_local(TP, batch)
    monkeypatch.setattr(tproj, "ZBUFFER_BACKEND", "scatter")
    sb = tproj.project_local(TP, batch)
    assert kb.depth.shape == (2, COLS)
    for a, b in zip(kb, sb):
        assert torch.equal(a, b)
    monkeypatch.setattr(tproj, "ZBUFFER_BACKEND", "pallas")
    with pytest.raises(ValueError, match="backend"):
        tproj.project_local(TP, cloud)


def test_wrapper_refuses_a_device_that_is_neither_cpu_nor_cuda():
    xy, _, valid = _cloud(5, 64)
    with pytest.raises(ValueError):
        pk.project_local(TP, torch.from_numpy(xy).to("meta"),
                         torch.from_numpy(valid).to("meta"))
