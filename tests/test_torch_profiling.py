"""The port's profiling module (srrg2_laser_slam_2d_tpu_torch/utils/profiling.py)
against the JAX package's on the goldens of tests/test_aux.py (the switch,
the report, tic / toc), and its device hooks on the host: the idle share
of a hand-built Chrome trace with known intervals, a CPU trace written by
``device_trace`` (which holds no device work, so its idle share is
refused). The span recorder ``timed`` is ``tests/test_torch_tracing.py``'s."""

import json

import pytest
import torch

from srrg2_laser_slam_2d_tpu.utils import profiling as jprof
from srrg2_laser_slam_2d_tpu_torch.utils import profiling as tprof


@pytest.mark.parametrize("device", [None, "cpu"])
def test_profiler_records_when_enabled(device):
    reports = []
    for mod in (jprof, tprof):
        mod.reset()
        mod.enable_logging = True
        kw = {} if mod is jprof else {"device": device}
        with mod.timed("stage_a", **kw):
            x = sum(range(1000))
        with mod.timed("stage_a", **kw):
            x += 1
        mod.enable_logging = False
        with mod.timed("stage_b", **kw):
            pass  # not recorded
        reports.append(mod.report())
        mod.reset()
        del x
    jrep, trep = reports
    assert set(trep) == set(jrep) == {"stage_a"}
    assert set(trep["stage_a"]) == set(jrep["stage_a"])
    assert trep["stage_a"]["count"] == jrep["stage_a"]["count"] == 2
    r = trep["stage_a"]
    assert 0 <= r["p50_s"] <= r["p95_s"] <= r["total_s"]
    assert r["mean_s"] == pytest.approx(r["total_s"] / 2)
    assert tprof.report() == {}


def test_tic_toc():
    for mod in (jprof, tprof):
        mod.tic()
        mod.tic()
        inner = mod.toc()
        outer = mod.toc()
        assert 0 <= inner <= outer < 1.0


def _trace():
    """A host span of 100 us with two overlapping kernels (10-30, 20-40), a
    copy (60-70), a memset inside the second kernel and a host-side event
    that must not count as device work."""
    ev = [{"ph": "X", "cat": "cpu_op", "name": "step", "ts": 1000.0, "dur": 100.0},
          {"ph": "X", "cat": "kernel", "name": "k1", "ts": 1010.0, "dur": 20.0},
          {"ph": "X", "cat": "kernel", "name": "k2", "ts": 1020.0, "dur": 20.0},
          {"ph": "X", "cat": "gpu_memset", "name": "m", "ts": 1025.0, "dur": 5.0},
          {"ph": "X", "cat": "gpu_memcpy", "name": "c", "ts": 1060.0, "dur": 10.0},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 1005.0,
           "dur": 90.0},
          {"ph": "i", "cat": "kernel", "name": "instant", "ts": 1200.0}]
    return {"traceEvents": ev}


def test_idle_share_of_a_hand_built_trace(tmp_path):
    trace = _trace()
    assert tprof.busy_intervals(trace) == [(1010.0, 1040.0), (1060.0, 1070.0)]
    # busy 30 + 10 us of a 100 us window
    assert tprof.idle_share(trace) == pytest.approx(0.6)
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(trace))
    assert tprof.idle_share(str(path)) == pytest.approx(0.6)
    assert tprof.idle_share(trace["traceEvents"]) == pytest.approx(0.6)
    host_only = {"traceEvents": [e for e in trace["traceEvents"] if e["cat"] == "cpu_op"]}
    with pytest.raises(ValueError, match="no kernel"):
        tprof.idle_share(host_only)


def test_device_trace_writes_a_chrome_trace_on_the_host(tmp_path):
    with tprof.device_trace(str(tmp_path / "trace")) as path:
        a = torch.ones(64, 64)
        (a @ a).sum()
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("ph") == "X" for e in events)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError):
            tprof.idle_share(path)
