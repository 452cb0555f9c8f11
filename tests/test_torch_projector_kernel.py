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
    points; the kernel backend takes batches in one wrapper call; an unknown
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


@pytest.mark.parametrize("batch", [(1,), (3,), (2, 3)])
def test_kernel_backend_batch_matches_pallas_cloud_by_cloud(monkeypatch, batch):
    """A leading batch goes through ``project_local`` on the kernel backend
    in one wrapper call (the plain version on the CPU): each cloud's canvas
    is bit-equal to that cloud projected alone, and against
    ``project_local_pallas`` on that cloud the indices are equal and the
    depths agree to 1e-6 (the module's tolerance: XLA fuses x*x + y*y into
    one multiply-add, one ulp apart)."""
    k = int(np.prod(batch))
    clouds = [_cloud(10 + j, 300) for j in range(k)]
    xy = np.stack([c[0] for c in clouds]).reshape(batch + (300, 2))
    nm = np.stack([c[1] for c in clouds]).reshape(batch + (300, 2))
    valid = np.stack([c[2] for c in clouds]).reshape(batch + (300,))
    monkeypatch.setattr(tproj, "ZBUFFER_BACKEND", "kernel")
    before = pk.launches
    t = tproj.project_local(TP, Cloud(torch.from_numpy(xy), torch.from_numpy(nm),
                                      torch.from_numpy(valid)))
    assert pk.launches == before                  # CPU tensors: the plain version
    assert t.depth.shape == t.idx.shape == t.valid.shape == batch + (COLS,)
    for j in np.ndindex(*batch):
        alone = pk.project_local(TP, torch.from_numpy(xy[j]), torch.from_numpy(valid[j]))
        for a, b in zip(alone, (t.depth[j], t.idx[j], t.valid[j])):
            assert torch.equal(a, b)
        jc = jpp.project_local_pallas(JP, jnp.asarray(xy[j]), jnp.asarray(valid[j]),
                                      interpret=True)
        _assert_canvas(alone, jc)


def test_kernel_canvas_dtypes_and_empty_value():
    """The wrapper's Canvas: float32 depth of ``cols`` beams with 3e38 where
    empty, int64 index with -1, bool valid (what the scatter backend and
    every caller take)."""
    xy, nm, valid = _cloud(6, 40)
    for batch in ((), (2,)):
        x = torch.from_numpy(xy).expand(batch + xy.shape)
        v = torch.from_numpy(valid).expand(batch + valid.shape)
        t = pk.project_local(TP, x, v)
        s = tproj.project_local_scatter(TP, Cloud(x, torch.from_numpy(nm).expand(x.shape), v))
        for a, b, dtype in zip(t, s, (torch.float32, torch.int64, torch.bool)):
            assert a.dtype == b.dtype == dtype and a.shape == b.shape == batch + (COLS,)
        empty = ~t.valid
        assert bool(empty.any()) and bool(t.valid.any())
        assert bool((t.depth[empty] == 3.0e38).all()) and bool((t.idx[empty] == -1).all())
        assert torch.equal(t.valid, t.idx >= 0)


@pytest.mark.parametrize("n,blocks", [(1, 1), (768, 1), (1024, 1), (1025, 2), (8192, 8),
                                      (12288, 8), (40000, 8)])
def test_cluster_blocks(n, blocks):
    """Kernels 7 and 8 spread a cloud of more than 1,024 points over one
    block per 1,024 points, at most 8 (one thread: one or two points up to
    16,384)."""
    assert pk.cluster_blocks(n) == blocks


def test_wrapper_refuses_a_device_that_is_neither_cpu_nor_cuda():
    xy, _, valid = _cloud(5, 64)
    with pytest.raises(ValueError):
        pk.project_local(TP, torch.from_numpy(xy).to("meta"),
                         torch.from_numpy(valid).to("meta"))
