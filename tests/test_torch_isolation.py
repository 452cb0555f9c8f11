"""The port stands alone: no module of srrg2_laser_slam_2d_tpu_torch and not
chip_smoke.py imports ``jax`` or the JAX package (checked on the syntax
tree of every file), and its entry points run on the CUDA card unless the
caller asks for the CPU."""

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


def test_port_imports_neither_jax_nor_the_jax_package():
    files = _port_files()
    assert len(files) > 20
    bad = [(str(f.relative_to(ROOT)), m) for f in files for m in _imported_modules(f)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    from srrg2_laser_slam_2d_tpu_torch.models.chunked_slam import (
        ChunkedGraphSLAM2D, ChunkedSlamRunner)
    from srrg2_laser_slam_2d_tpu_torch.models import loop_closure as lc
    from srrg2_laser_slam_2d_tpu_torch.models.fast_tracker import FastTracker
    from srrg2_laser_slam_2d_tpu_torch.models.preprocessor import ScanPreprocessor
    from srrg2_laser_slam_2d_tpu_torch.models.slam import GraphSLAMConfig, frame_spec

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = GraphSLAMConfig(enable_loop_closure=False)
    public = [ChunkedSlamRunner, lambda **kw: ChunkedGraphSLAM2D(cfg, **kw),
              lambda **kw: FastTracker(frame_spec(cfg), **kw), ScanPreprocessor,
              lambda **kw: lc.ClosureValidator(cfg.validator, **kw)]
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
    with pytest.raises(NotImplementedError):
        frame_kernel.track_frames_grid(
            frame_kernel.FrameSpec(projection=spec.projection, meas_as_canvas=False),
            cache, pose, torch.zeros(2, 8, B))


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
