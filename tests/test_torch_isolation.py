"""The port stands alone: no module of srrg2_laser_slam_2d_tpu_torch and not
chip_smoke.py imports ``jax`` or the JAX package (checked on the syntax
tree of every file), the modules of the ``slam_app`` slice import no
``matplotlib`` either (the card's machine has none), its entry points run
on the CUDA card unless the caller asks for the CPU, and its native
loader builds under ``build/``, never under ``native/``."""

import ast
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "srrg2_laser_slam_2d_tpu")


def _port_files():
    return sorted((ROOT / "srrg2_laser_slam_2d_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


PER_MESSAGE_MODULES = (
    "apps/__init__.py", "apps/generic_bench_app.py", "models/runner.py", "models/slam.py",
    "models/tracker.py", "models/fast_tracker.py", "models/loop_closure.py", "ops/icp.py",
    "ops/clip.py", "ops/merge.py", "ops/projector.py", "ops/projector_kernel.py",
    "ops/scene_kernel.py", "ops/banded_align_kernel.py", "ops/projective_align_kernel.py",
    "solver/pgo.py", "utils/presets.py", "utils/status.py", "utils/interop.py",
)


def test_port_imports_neither_jax_nor_the_jax_package():
    files = _port_files()
    assert len(files) > 40
    scanned = {str(f.relative_to(ROOT / "srrg2_laser_slam_2d_tpu_torch"))
               for f in files if f.name != "chip_smoke.py"}
    assert set(PER_MESSAGE_MODULES) <= scanned, set(PER_MESSAGE_MODULES) - scanned
    bad = [(str(f.relative_to(ROOT)), m) for f in files for m in _imported_modules(f)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    from srrg2_laser_slam_2d_tpu_torch.models.chunked_slam import (
        ChunkedGraphSLAM2D, ChunkedSlamRunner)
    from srrg2_laser_slam_2d_tpu_torch.models import loop_closure as lc
    from srrg2_laser_slam_2d_tpu_torch.models.fast_tracker import FastTracker
    from srrg2_laser_slam_2d_tpu_torch.models.preprocessor import ScanPreprocessor
    from srrg2_laser_slam_2d_tpu_torch.models.runner import SlamRunner
    from srrg2_laser_slam_2d_tpu_torch.models.slam import (GraphSLAM2D, GraphSLAMConfig,
                                                           frame_spec)
    from srrg2_laser_slam_2d_tpu_torch.models.tracker import LaserTracker

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = GraphSLAMConfig(enable_loop_closure=False)
    public = [ChunkedSlamRunner, lambda **kw: ChunkedGraphSLAM2D(cfg, **kw),
              lambda **kw: FastTracker(frame_spec(cfg), **kw), ScanPreprocessor,
              lambda **kw: lc.ClosureValidator(cfg.validator, **kw),
              SlamRunner, lambda **kw: GraphSLAM2D(cfg, **kw),
              lambda **kw: LaserTracker(cfg.tracker, **kw)]
    for make in public:
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
        assert make(device="cpu").device == torch.device("cpu")
    runner = ChunkedSlamRunner(device="cpu")
    assert runner.device == torch.device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_kernel_wrappers_take_the_plain_version_only_for_cpu_tensors():
    """A CPU tensor goes to the plain version; any other device must launch
    the kernel (here a meta tensor, which no kernel takes, is refused)."""
    from srrg2_laser_slam_2d_tpu_torch.ops import frame_kernel
    from srrg2_laser_slam_2d_tpu_torch.ops.projector import PolarProjection

    spec = frame_kernel.FrameSpec(
        projection=PolarProjection.make(cols=100, angle_min=-1.0, angle_max=1.0),
        iterations=2)
    B = spec.cols_padded
    cache, pose = torch.zeros(8, B), torch.zeros(2, 8)
    before = frame_kernel.launches
    _, _, pay = frame_kernel.track_frames_grid(spec, cache, pose, torch.zeros(2, 8, B))
    assert pay.shape == (2, 8, B) and frame_kernel.launches == before
    with pytest.raises(ValueError):
        frame_kernel.track_frames_grid(spec, cache.to("meta"), pose.to("meta"),
                                       torch.zeros(2, 8, B, device="meta"))
    # the raw [T, F, 8] layout likewise
    raw = frame_kernel.FrameSpec(projection=spec.projection, iterations=2,
                                 meas_as_canvas=False)
    _, _, pay = frame_kernel.track_frames_grid(raw, cache, pose, torch.zeros(2, 50, 8))
    assert pay.shape == (2, 8, B) and frame_kernel.launches == before
    with pytest.raises(ValueError):
        frame_kernel.track_frames_grid(raw, cache.to("meta"), pose.to("meta"),
                                       torch.zeros(2, 50, 8, device="meta"))


def test_stream_wrapper_takes_the_plain_version_only_for_cpu_tensors():
    """The K-stream wrapper: CPU tensors go to the plain version and count
    no launch; a tensor on any other device must launch the kernel (a meta
    tensor, which no kernel takes, is refused, not handed to the plain
    version)."""
    from srrg2_laser_slam_2d_tpu_torch.ops import frame_kernel, stream_kernel
    from srrg2_laser_slam_2d_tpu_torch.ops.projector import PolarProjection

    spec = frame_kernel.FrameSpec(
        projection=PolarProjection.make(cols=100, angle_min=-1.0, angle_max=1.0),
        iterations=3, window=128, corr_refresh=2)
    K, T, B = 2, 2, spec.cols_padded
    cacheB, poseB = torch.zeros(8, K, B), torch.zeros(K, 16)
    measC, odomS = torch.zeros(T, 8, K, B), torch.zeros(T, K, 8)
    before = stream_kernel.launches
    c, p, pay = stream_kernel.track_streams_grid(spec, cacheB, poseB, measC, odomS)
    assert pay.shape == (T, 8, K, B) and c.shape == (8, K, B) and p.shape == (K, 16)
    assert stream_kernel.launches == before
    with pytest.raises(ValueError):
        stream_kernel.track_streams_grid(spec, cacheB.to("meta"), poseB.to("meta"),
                                         measC.to("meta"), odomS.to("meta"))
    with pytest.raises(ValueError):
        stream_kernel.stream_step(spec, measC[0].to("meta"), odomS[0].to("meta"),
                                  cacheB.to("meta"), poseB.to("meta"))


def test_per_message_wrappers_take_the_plain_version_only_for_cpu_tensors():
    """The four per-message kernels' wrappers: CPU tensors go to the plain
    version and count no launch; a tensor on any other device must launch
    the kernel (a meta tensor, which no kernel takes, is refused)."""
    from srrg2_laser_slam_2d_tpu_torch.ops import (banded_align_kernel,
                                                   projective_align_kernel,
                                                   projector_kernel, scene_kernel)
    from srrg2_laser_slam_2d_tpu_torch.ops.projector import PolarProjection
    from srrg2_laser_slam_2d_tpu_torch.utils import cloud as cloud_op

    proj = PolarProjection.make(cols=100, angle_min=-1.0, angle_max=1.0)
    xy = torch.tensor([[1.0, 0.1], [2.0, -0.3], [1.5, 0.4]])
    c = cloud_op.from_numpy(xy.numpy(), normal=torch.tensor([[1.0, 0.0]] * 3).numpy())
    beams = cloud_op.empty(100)
    mods = (projector_kernel, scene_kernel, banded_align_kernel, projective_align_kernel)
    before = [m.launches for m in mods]
    assert int(projector_kernel.project_local(proj, c.xy, c.valid).valid.sum()) == 3
    out, rows = scene_kernel.canvas(proj, c, torch.zeros(3))
    assert out.shape == (6, 128) and int((rows >= 0).sum()) == 3
    r = banded_align_kernel.fused_projective_align_banded(
        proj, c.xy, c.normal, c.valid, beams.xy, beams.normal, beams.valid, torch.zeros(3),
        iterations=2)
    assert r.iter_stats.shape == (2, 4)
    r = projective_align_kernel.fused_projective_align(
        proj, c.xy, c.normal, c.valid, c.xy, c.normal, c.valid, torch.zeros(3), iterations=2)
    assert float(r.num_corr) == 3.0
    assert [m.launches for m in mods] == before
    m = c.to("meta")
    with pytest.raises(ValueError):
        projector_kernel.project_local(proj, m.xy, m.valid)
    with pytest.raises(ValueError):
        scene_kernel.canvas(proj, m, torch.zeros(3, device="meta"))
    for fn in (banded_align_kernel.fused_projective_align_banded,
               projective_align_kernel.fused_projective_align):
        with pytest.raises(ValueError):
            fn(proj, m.xy, m.normal, m.valid, beams.xy.to("meta"), beams.normal.to("meta"),
               beams.valid.to("meta"), torch.zeros(3, device="meta"))


MULTICUE_MODULES = (
    "ops/multicue_align_kernel.py", "ops/beam_zbuffer_kernel.py", "bench/exp_gather.py",
    "bench/multicue_bench.py", "apps/synthetic_scene_generator.py", "models/tracker.py",
    "models/runner.py", "ops/icp.py", "utils/cloud.py", "utils/interop.py",
)


@pytest.mark.parametrize("module", MULTICUE_MODULES)
def test_multicue_modules_import_neither_jax_nor_the_jax_package(module):
    path = ROOT / "srrg2_laser_slam_2d_tpu_torch" / module
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, (module, bad)


def test_multicue_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    from srrg2_laser_slam_2d_tpu_torch.bench import exp_gather, multicue_bench
    from srrg2_laser_slam_2d_tpu_torch.models.runner import SlamRunner
    from srrg2_laser_slam_2d_tpu_torch.models.tracker import MultiCueTracker, TrackerConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda **kw: SlamRunner(scan_topics=["/scan_0", "/scan_1"], **kw),
                 lambda **kw: MultiCueTracker(TrackerConfig(), [(0, 0, 0), (0, 0, 3.14)], **kw)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
        assert make(device="cpu").device == torch.device("cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        multicue_bench.build_inputs(frames=2, num_beams=64)
    assert multicue_bench.build_inputs(frames=2, num_beams=64, device="cpu")["meas"].xy.shape \
        == (2, 2, 64, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        exp_gather.run("direct", 2)


def test_multicue_and_probe_wrappers_take_the_plain_version_only_for_cpu_tensors():
    """Kernel 6 and the two probes: CPU tensors go to the plain version and
    count no launch; a tensor on any other device must launch the kernel (a
    meta tensor, which no kernel takes, is refused)."""
    from srrg2_laser_slam_2d_tpu_torch.bench import exp_gather
    from srrg2_laser_slam_2d_tpu_torch.ops import beam_zbuffer_kernel as bzk
    from srrg2_laser_slam_2d_tpu_torch.ops import multicue_align_kernel as mak
    from srrg2_laser_slam_2d_tpu_torch.ops.projector import PolarProjection

    proj = PolarProjection.make(cols=100, angle_min=-3.0, angle_max=3.0)
    xy = torch.tensor([[[1.0, 0.1], [2.0, -0.3], [1.5, 0.4]]] * 2)
    nm = torch.tensor([[[1.0, 0.0]] * 3] * 2)
    valid = torch.ones(2, 3, dtype=torch.bool)
    extr = torch.tensor([[0.0, 0.0, 0.0], [0.0, 0.0, 3.14159]])
    before = (mak.launches, bzk.launches, exp_gather.launches)
    r = mak.fused_projective_align_multi(proj, xy, nm, valid, extr, xy[0], nm[0], valid[0],
                                         torch.zeros(3), iterations=2, min_inliers=1)
    assert r.iter_stats.shape == (2, 4) and float(r.num_corr) >= 3
    geoT = torch.zeros(8, 128)
    geoT[0, :3], geoT[4, :3] = 1.0, 1.0
    assert bzk.beam_zbuffer_probe(proj, geoT).shape == (8, 128)
    canvas, idx = exp_gather.make_inputs(2, "cpu", lanes=128, shift=8)
    assert exp_gather.gather_probe(canvas, idx, 3).shape == (8, 2, 128)
    assert (mak.launches, bzk.launches, exp_gather.launches) == before
    with pytest.raises(ValueError):
        mak.fused_projective_align_multi(proj, xy.to("meta"), nm.to("meta"), valid.to("meta"),
                                         extr.to("meta"), xy[0].to("meta"), nm[0].to("meta"),
                                         valid[0].to("meta"), torch.zeros(3, device="meta"))
    with pytest.raises(ValueError):
        bzk.beam_zbuffer_probe(proj, geoT.to("meta"))
    with pytest.raises(ValueError):
        exp_gather.gather_probe(canvas.to("meta"), idx.to("meta"), 3)
    with pytest.raises(ValueError):   # more cues than the kernel holds
        mak.fused_projective_align_multi(proj, xy.repeat(3, 1, 1), nm.repeat(3, 1, 1),
                                         valid.repeat(3, 1), extr.repeat(3, 1), xy[0], nm[0],
                                         valid[0], torch.zeros(3))


SLAM_APP_MODULES = (
    "apps/slam_app.py", "apps/generic_bench_app.py", "io/carmen.py", "io/native_loader.py",
    "utils/checkpoint.py", "viz/__init__.py", "viz/canvas.py", "utils/config.py",
    "utils/presets.py", "utils/geometry.py", "models/preprocessor.py", "models/runner.py",
    "models/slam.py", "models/chunked_slam.py", "models/fast_tracker.py", "bench/synthetic.py",
    "io/boss_config.py",
)


@pytest.mark.parametrize("module", SLAM_APP_MODULES)
def test_slam_app_modules_import_neither_jax_nor_matplotlib(module):
    path = ROOT / "srrg2_laser_slam_2d_tpu_torch" / module
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN + ("matplotlib",)]
    assert not bad, (module, bad)


SOLVER_FINDER_MODULES = (
    "utils/profiling.py", "solver/pgo.py", "solver/cg.py", "solver/schur.py",
    "bench/pgo_bench.py", "ops/distance_map.py", "ops/correspond.py", "ops/icp.py",
    "models/slam.py", "models/chunked_slam.py",
)


@pytest.mark.parametrize("module", SOLVER_FINDER_MODULES)
def test_solver_and_finder_modules_import_neither_jax_nor_the_jax_package(module):
    path = ROOT / "srrg2_laser_slam_2d_tpu_torch" / module
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, (module, bad)


def test_solver_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    from srrg2_laser_slam_2d_tpu_torch.bench import pgo_bench
    from srrg2_laser_slam_2d_tpu_torch.models.chunked_slam import ChunkedGraphSLAM2D
    from srrg2_laser_slam_2d_tpu_torch.models.slam import GraphSLAM2D, GraphSLAMConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pgo_bench.run(4, gn_iterations=1, cg_iterations=2, reps=1)
    assert pgo_bench.run(4, gn_iterations=1, cg_iterations=2, reps=1,
                         device="cpu").device == "cpu"
    for kind in ("cg", "schur"):
        cfg = GraphSLAMConfig(global_solver_kind=kind, enable_loop_closure=False)
        for make in (GraphSLAM2D, ChunkedGraphSLAM2D):
            with pytest.raises(RuntimeError, match="CUDA"):
                make(cfg)
            assert make(cfg, device="cpu").device == torch.device("cpu")


def test_slam_app_needs_a_card_unless_asked_for_the_cpu(monkeypatch, tmp_path):
    from srrg2_laser_slam_2d_tpu_torch.apps import slam_app

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = str(tmp_path / "cfg.json")
    with pytest.raises(RuntimeError, match="CUDA"):
        slam_app.main(["-j", "-c", path])
    assert slam_app.main(["-j", "-c", path, "--device", "cpu"]) == 0


def test_native_loader_builds_under_build_and_writes_nothing_under_native(tmp_path,
                                                                           monkeypatch):
    """A fresh build of the native loader: the library goes where
    ``LIBRARY`` says (``build/torch_native/`` by default), and ``native/``
    is left as it was, file by file."""
    from srrg2_laser_slam_2d_tpu_torch.io import native_loader as nl

    native = ROOT / "native"

    def snapshot():
        return {p.name: (p.stat().st_size, p.stat().st_mtime_ns) for p in native.iterdir()}

    assert nl.LIBRARY.parent == ROOT / "build" / "torch_native"
    assert nl.SOURCE == native / "dataloader.cpp"
    before = snapshot()
    monkeypatch.setattr(nl, "LIBRARY", tmp_path / "libdataloader.so")
    monkeypatch.setattr(nl, "_LIB", None)
    monkeypatch.setattr(nl, "_LIB_TRIED", False)
    assert nl.available()
    assert (tmp_path / "libdataloader.so").exists()
    assert [p.name for p in tmp_path.iterdir()] == ["libdataloader.so"]
    log = tmp_path / "one.clf"
    log.write_text("FLASER 3 1.0 2.0 3.0 0 0 0 0 0 0 1.5 host 1.5\n")
    out = nl.load_carmen_arrays(str(log))
    assert out["backend"] == "native" and out["ranges"].tolist() == [[1.0, 2.0, 3.0]]
    assert snapshot() == before
