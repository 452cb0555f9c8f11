"""CARMEN ingest in the port against the JAX package on the CPU: the log
``to_carmen`` writes (byte for byte), ``parse_carmen`` / ``load_packs``,
both backends of the native loader, the preprocessor's ``status`` and
``process_message`` with the exact point count on scan 0, and
``generic_bench_app --carmen`` with ``--checkpoint`` (a run resumed from
its checkpoint against one that never stopped).

Tolerances: the parsers read the same text, so packs, arrays and counts
are EQUAL (float32 from the same decimal strings). The resumed run ends
within 1e-3 m of the uninterrupted one: it carries the same graph and
tracker state, but not the clip cache or pending closures (none here).
"""

import os

import numpy as np
import pytest

from srrg2_laser_slam_2d_tpu.bench import synthetic as jsyn
from srrg2_laser_slam_2d_tpu.io import carmen as jcarmen
from srrg2_laser_slam_2d_tpu.io import native_loader as jnative
from srrg2_laser_slam_2d_tpu.models import preprocessor as jpre
from srrg2_laser_slam_2d_tpu_torch.apps import generic_bench_app as app
from srrg2_laser_slam_2d_tpu_torch.bench import synthetic as tsyn
from srrg2_laser_slam_2d_tpu_torch.io import carmen as tcarmen
from srrg2_laser_slam_2d_tpu_torch.io import native_loader as tnative
from srrg2_laser_slam_2d_tpu_torch.io.messages import LaserMessage, OdometryMessage
from srrg2_laser_slam_2d_tpu_torch.models import preprocessor as tpre
from srrg2_laser_slam_2d_tpu_torch.utils.status import Status

RESUME_TOL = 1e-3


@pytest.fixture(scope="module")
def dataset():
    return jsyn.simulate(jsyn.SyntheticConfig(steps=12, num_beams=512))


def _port_dataset(ds):
    """The port's ``SyntheticDataset`` holding the JAX dataset's arrays."""
    import dataclasses

    return tsyn.SyntheticDataset(
        config=tsyn.SyntheticConfig(**dataclasses.asdict(ds.config)), scene=None,
        robot_poses=ds.robot_poses, sensor_poses=ds.sensor_poses, ranges=ds.ranges)


@pytest.fixture(scope="module")
def logs(dataset, tmp_path_factory):
    """The synthetic ROBOTLASER1 log written by both packages, and a FLASER
    log with ODOM lines (``tests/test_native_loader.py``'s)."""
    d = tmp_path_factory.mktemp("carmen")
    jpath, tpath = str(d / "jax.clf"), str(d / "port.clf")
    jsyn.to_carmen(dataset, jpath)
    tsyn.to_carmen(_port_dataset(dataset), tpath)
    flaser = str(d / "flaser.clf")
    rng = np.random.default_rng(0)
    lines = ["# comment line"]
    for k in range(5):
        rs = " ".join(f"{r:.3f}" for r in rng.uniform(0.5, 10.0, 12))
        lines.append(f"FLASER 12 {rs} {k*0.1:.3f} {k*0.2:.3f} 0.05 {k*0.1+0.01:.3f} "
                     f"{k*0.2:.3f} 0.06 {100.0+k:.2f} host {100.0+k:.2f}")
        lines.append(f"ODOM {k*0.1:.3f} {k*0.2:.3f} 0.06 0 0 0 {100.0+k+0.05:.2f} host x")
    with open(flaser, "w") as f:
        f.write("\n".join(lines) + "\n")
    return jpath, tpath, flaser


def test_to_carmen_writes_the_jax_packages_bytes(logs):
    jpath, tpath, _ = logs
    assert open(tpath, "rb").read() == open(jpath, "rb").read()


def test_port_simulate_writes_a_readable_log(tmp_path):
    ds = tsyn.simulate(tsyn.SyntheticConfig(steps=3, num_beams=64), device="cpu")
    path = str(tmp_path / "s.clf")
    tsyn.to_carmen(ds, path)
    packs, gt = tcarmen.load_packs(path)
    assert len(packs) == 4 and gt.shape == (4, 4)
    np.testing.assert_allclose(gt[:, 1:], ds.sensor_poses, atol=1e-5)


def _fields(msg):
    return {k: (np.asarray(v).tolist() if isinstance(v, np.ndarray) else v)
            for k, v in vars(msg).items() if k != "messages"}


@pytest.mark.parametrize("which", ["synthetic", "flaser"])
def test_parse_and_load_packs_match_the_jax_package(logs, which):
    path = logs[0] if which == "synthetic" else logs[2]
    jitems, titems = list(jcarmen.parse_carmen(path)), list(tcarmen.parse_carmen(path))
    assert [type(i).__name__ for i in titems] == [type(i).__name__ for i in jitems]
    for a, b in zip(titems, jitems):
        assert _fields(a) == _fields(b)
    for max_packs in (None, 3):
        (tp, tgt), (jp, jgt) = tcarmen.load_packs(path, max_packs), jcarmen.load_packs(path, max_packs)
        assert len(tp) == len(jp) == (max_packs or (13 if which == "synthetic" else 5))
        np.testing.assert_array_equal(tgt, jgt)
        for a, b in zip(tp, jp):
            assert _fields(a) == _fields(b)
            assert [_fields(m) for m in a.messages] == [_fields(m) for m in b.messages]
            assert isinstance(a.messages[0], LaserMessage)
            assert isinstance(a.messages[1], OdometryMessage)


def _python_backend(mod, path):
    saved = mod._LIB
    mod._LIB = None
    try:
        return mod.load_carmen_arrays(path)
    finally:
        mod._LIB = saved


@pytest.mark.parametrize("which", ["synthetic", "flaser"])
def test_native_loader_backends_match_the_jax_package(logs, which):
    path = logs[0] if which == "synthetic" else logs[2]
    assert tnative.available() and jnative.available()
    got = {"native": tnative.load_carmen_arrays(path),
           "python": _python_backend(tnative, path)}
    want = {"native": jnative.load_carmen_arrays(path),
            "python": _python_backend(jnative, path)}
    for backend in ("native", "python"):
        assert got[backend]["backend"] == want[backend]["backend"] == backend
        assert set(got[backend]) == set(want[backend])
        for key in ("ranges", "laser_pose", "odom_pose", "timestamp", "meta"):
            np.testing.assert_array_equal(got[backend][key], want[backend][key], err_msg=key)
            assert got[backend][key].dtype == want[backend][key].dtype
    # the two parsers of the port agree with each other
    for key in ("ranges", "laser_pose", "odom_pose", "timestamp"):
        np.testing.assert_allclose(got["native"][key], got["python"][key], atol=1e-6)
    np.testing.assert_array_equal(got["native"]["meta"][:, 0], got["python"]["meta"][:, 0])


def test_preprocessor_status_and_first_scan_exact_count(logs, dataset):
    """``tests/test_carmen_e2e.py::test_first_scan_exact_count`` and
    ``tests/test_status.py::test_preprocessor_status_surface`` on both
    packages: the cloud of CARMEN scan 0 through ``process_message`` has
    the JAX package's exact point count, which is that of preprocessing
    its ranges directly."""
    laser = tcarmen.load_packs(logs[1], max_packs=1)[0][0].messages[0]
    jlaser = jcarmen.load_packs(logs[0], max_packs=1)[0][0].messages[0]
    cfg = dict(voxelize_resolution=0.01)
    pre = tpre.ScanPreprocessor(tpre.PreprocessorConfig(**cfg), device="cpu")
    assert pre.status == Status.READY
    with pytest.raises(RuntimeError, match="laser model"):
        pre.compute(dataset.ranges[0])
    assert pre.status == Status.ERROR
    cloud = pre.process_message(laser)
    assert pre.status == Status.SUCCESS
    want = jpre.ScanPreprocessor(jpre.PreprocessorConfig(**cfg)).process_message(jlaser)
    direct = tpre.ScanPreprocessor(tpre.PreprocessorConfig(**cfg), device="cpu")
    direct.set_model(tpre.LaserModel(num_beams=512, angle_min=dataset.config.angle_min,
                                     angle_max=dataset.config.angle_max, range_min=0.0,
                                     range_max=80.0))
    n = int(cloud.count())
    assert n == int(want.count()) == int(direct.compute(dataset.ranges[0]).count()) and n > 300
    np.testing.assert_allclose(cloud.xy.numpy()[: n], np.asarray(want.xy)[: n], atol=1e-5)
    pre.compute(np.full(512, 1e9, np.float32))     # every range out of bounds: empty cloud
    assert pre.status == Status.ERROR


@pytest.fixture(scope="module")
def long_log(tmp_path_factory):
    """A 40-step drive along a gentle arc as a CARMEN log of the port."""
    ds = jsyn.simulate(jsyn.SyntheticConfig(steps=40, num_beams=512, max_variance=0.01,
                                            drift=(0.1, 0.0, 0.02), seed=3))
    path = str(tmp_path_factory.mktemp("long") / "long.clf")
    tsyn.to_carmen(_port_dataset(ds), path)
    return path


def test_bench_app_carmen_and_checkpoint_resume(long_log, tmp_path):
    base = ["--carmen", long_log, "--gate", "simul", "--device", "cpu"]
    rc, art, whole = app.run(app.parser().parse_args(base))
    assert rc == 0 and art["frames"] == 41 and art["input"] == long_log
    assert art["gate_verdict"] == "PASS" and art["ate"]["rmse_translation"] < 0.05
    assert art["graph_variables"] >= 3
    ckpt = str(tmp_path / "run.npz")
    first = app.parser().parse_args(base + ["--checkpoint", ckpt, "--checkpoint-every", "10",
                                            "--max-frames", "20"])
    rc, art, _ = app.run(first)
    assert rc == 0 and art["frames"] == 20
    assert os.path.exists(ckpt) and os.path.exists(str(tmp_path / "run.meta.json"))
    rc, art, resumed = app.run(app.parser().parse_args(base + ["--checkpoint", ckpt]))
    assert rc == 0 and art["frames"] == 21 and len(resumed.trajectory) == 41
    assert resumed.slam.tracker.steps == 21          # one tracked step per frame after the resume
    d = np.abs(resumed.trajectory[-1][1] - whole.trajectory[-1][1])
    print("resumed run's end pose apart by", d)
    assert d.max() < RESUME_TOL, d
    assert app.run(app.parser().parse_args(base + ["--checkpoint", ckpt, "--chunked", "8"]))[0] \
        == -1
