"""The launch path of the port's CUDA kernels (``ops/_cuda.py``), on the CPU.

Each ``_cuda.Entry`` declaration is held to the ``extern "C"`` prototype
of its entry point, parsed from ``csrc/<lib>.cu`` and the headers it
includes: the number of parameters and the C type of each (a pointer is
``PTR``, ``int`` ``INT``, ``float`` ``FLOAT``), the stream last where the
call passes one. A mismatch would otherwise show only on the card. Every
public kernel wrapper takes the plain version for CPU tensors, launches for
CUDA tensors and refuses any other device; here a ``meta`` tensor of a
valid shape stands for the other devices."""

import re

import pytest
import torch

from srrg2_laser_slam_2d_tpu_torch.bench import exp_gather
from srrg2_laser_slam_2d_tpu_torch.ops import _cuda
from srrg2_laser_slam_2d_tpu_torch.ops import banded_align_kernel as bak
from srrg2_laser_slam_2d_tpu_torch.ops import beam_zbuffer_kernel as bzk
from srrg2_laser_slam_2d_tpu_torch.ops import frame_kernel as fk
from srrg2_laser_slam_2d_tpu_torch.ops import materialize_kernel as mk
from srrg2_laser_slam_2d_tpu_torch.ops import multicue_align_kernel as mak
from srrg2_laser_slam_2d_tpu_torch.ops import nn_icp_kernel as nk
from srrg2_laser_slam_2d_tpu_torch.ops import projective_align_kernel as pak
from srrg2_laser_slam_2d_tpu_torch.ops import projector_kernel as pk
from srrg2_laser_slam_2d_tpu_torch.ops import scene_kernel as sck
from srrg2_laser_slam_2d_tpu_torch.ops import stream_kernel as sk
from srrg2_laser_slam_2d_tpu_torch.ops.projector import PolarProjection
from srrg2_laser_slam_2d_tpu_torch.utils.cloud import Cloud

_PROTOTYPE = re.compile(r'extern\s+"C"\s+[\w\s]*?[\w*]\s*\**\s*(\w+)\s*\(([^)]*)\)')
_INCLUDE = re.compile(r'#include\s+"([^"]+)"')


def _prototypes(path) -> dict:
    """{entry point: [parameter, ...]} of a source and its local includes."""
    text = path.read_text()
    for header in _INCLUDE.findall(text):
        text += (path.parent / header).read_text()
    return {name: [p.strip() for p in params.split(",") if p.strip() not in ("", "void")]
            for name, params in _PROTOTYPE.findall(text)}


def _ctype(param: str):
    if "*" in param:
        return _cuda.PTR
    return {"int": _cuda.INT, "float": _cuda.FLOAT}[param.split()[-2]]


ENTRIES = {f"{e.lib}.{e.fn}": e for e in _cuda.ENTRIES}


def test_every_entry_point_has_one_declaration():
    """Every ``extern "C"`` function under ``csrc/`` is declared once."""
    defined = {(p.stem, fn) for p in _cuda.CSRC.glob("*.cu") for fn in _prototypes(p)}
    declared = [(e.lib, e.fn) for e in _cuda.ENTRIES]
    assert len(declared) == len(set(declared))
    assert set(declared) <= defined
    # frame_phase_cycles comes with csrc/frame_common.cuh into every kernel:
    # one declaration, bound to whichever build is read
    assert {fn for _, fn in defined} == {fn for _, fn in declared}


@pytest.mark.parametrize("name", sorted(ENTRIES))
def test_declaration_matches_the_c_prototype(name):
    entry = ENTRIES[name]
    params = _prototypes(_cuda.CSRC / f"{entry.lib}.cu")[entry.fn]
    assert len(entry.argtypes) == len(params), params
    assert list(entry.argtypes) == [_ctype(p) for p in params], params
    assert (params[-1].split()[-1] == "stream") == entry.stream


def test_kernels_are_the_csrc_sources():
    assert set(_cuda.KERNELS) == {p.stem for p in _cuda.CSRC.glob("*.cu")}
    assert {e.lib for e in _cuda.ENTRIES} <= set(_cuda.KERNELS)


def test_bind_and_use_build_point_declarations_at_another_build(tmp_path):
    """``bind`` gives an entry point of its own library, outside the
    registry; ``use_build`` moves every registered one at once, to load
    afresh at its next call."""
    bound = fk.FRAME_TRACK_GRID.bind(tmp_path / "libframe_kernel.so")
    assert bound.path == tmp_path / "libframe_kernel.so"
    assert (bound.lib, bound.fn, bound.argtypes, bound.stream) == (
        "frame_kernel", "frame_track_grid", fk.FRAME_TRACK_GRID.argtypes, True)
    assert all(e is not bound for e in _cuda.ENTRIES)
    own = (_cuda.CSRC, _cuda.BUILD_DIR)
    sk.STREAM_TRACK_GRID._handle = object()
    try:
        _cuda.use_build(tmp_path / "csrc", tmp_path / "build")
        assert _cuda.library_path("stream_kernel") == tmp_path / "build" / "libstream_kernel.so"
        assert all(e._handle is None for e in _cuda.ENTRIES)
    finally:
        _cuda.use_build(*own)
    assert _cuda.library_path("stream_kernel") == own[1] / "libstream_kernel.so"


def test_on_card_is_the_one_device_rule():
    assert _cuda.on_card(torch.zeros(1)) is False
    with pytest.raises(ValueError, match="unsupported device meta"):
        _cuda.on_card(torch.zeros(1, device="meta"))


# ------------------------------------------------ every wrapper's device rule

PROJ = PolarProjection.make(cols=100, angle_min=-3.0, angle_max=3.0)
SPEC = fk.FrameSpec(projection=PROJ, scene_capacity=64, iterations=2)
B = SPEC.cols_padded
K, T, N = 2, 3, 16


def _z(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype, device="meta")


def _cloud(*lead):
    return Cloud(_z(*lead, 2), _z(*lead, 2), _z(*lead, dtype=torch.bool))


WRAPPERS = {
    "frame_kernel.track_frames_grid":
        lambda: fk.track_frames_grid(SPEC, _z(8, B), _z(2, 8), _z(T, 8, B)),
    "frame_kernel.frame_step": lambda: fk.frame_step(SPEC, _z(8, B), _z(8, B), _z(2, 8)),
    "stream_kernel.track_streams_grid":
        lambda: sk.track_streams_grid(SPEC, _z(8, K, B), _z(K, 16), _z(T, 8, K, B),
                                      _z(T, K, 8)),
    "stream_kernel.stream_step":
        lambda: sk.stream_step(SPEC, _z(8, K, B), _z(K, 8), _z(8, K, B), _z(K, 16)),
    "nn_icp_kernel.fused_align_pairs":
        lambda: nk.fused_align_pairs(_cloud(K, N), _cloud(K, N), _z(K, 3)),
    "projector_kernel.project_local": lambda: pk.project_local(PROJ, _z(N, 2),
                                                               _z(N, dtype=torch.bool)),
    "scene_kernel.canvas": lambda: sck.canvas(PROJ, _cloud(N), _z(3)),
    "banded_align_kernel.fused_projective_align_banded":
        lambda: bak.fused_projective_align_banded(PROJ, *_cloud(N), *_cloud(PROJ.cols), _z(3)),
    "projective_align_kernel.fused_projective_align":
        lambda: pak.fused_projective_align(PROJ, *_cloud(N), *_cloud(N), _z(3)),
    "multicue_align_kernel.fused_projective_align_multi":
        lambda: mak.fused_projective_align_multi(PROJ, *_cloud(2, N), _z(2, 3), *_cloud(N),
                                                 _z(3)),
    "materialize_kernel.materialize":
        lambda: mk.materialize(SPEC, _cloud(SPEC.scene_capacity), _z(T, 8, B), 1.0),
    "beam_zbuffer_kernel.beam_zbuffer_probe": lambda: bzk.beam_zbuffer_probe(PROJ, _z(8, B)),
    "exp_gather.gather_probe":
        lambda: exp_gather.gather_probe(_z(8, K, B), _z(K, B, dtype=torch.int32)),
}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_wrapper_refuses_a_device_that_is_neither_cpu_nor_cuda(name):
    with pytest.raises(ValueError, match="unsupported device"):
        WRAPPERS[name]()
