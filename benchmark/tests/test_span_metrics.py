"""The readers of the program's spans and counters on hand-built inputs:

  python -m pytest benchmark/tests/test_span_metrics.py -q -p no:randomly

A trace with known busy intervals and nested ``runner.flush`` /
``slam.closure`` annotations gives known idle shares, which sum to
``idle_pct.map``; the fleet's span readers give known means; the phase and
counter readers average and divide as their docstrings say, and read
nothing where the program has no such span or counter.
"""

from __future__ import annotations

import pytest

from benchmark import harness, spans
from benchmark.trace import Trace
from srrg2_laser_slam_2d_tpu_torch.ops import nn_icp_kernel
from srrg2_laser_slam_2d_tpu_torch.solver import pgo

IDLE = ("idle_pct.map.closure", "idle_pct.map.tracking", "idle_pct.map.outside_spans")


def _read(name: str, run=None, trace=None):
    return harness.metric_reader(name)(harness.Context("test", run, trace))


def _corridor_trace() -> Trace:
    """A 100 us window (1000-1100) with the card busy 1010-1020, 1030-1035
    and 1060-1090 (45 us); flushes 1005-1050 and 1055-1098, the second
    holding a closure round 1070-1095 and a kernel launched from it; a flush
    that starts before the window."""
    tr = Trace()
    tr.window = (1000.0, 1100.0)
    tr.device = [("k1", 1010.0, 1020.0, 1), ("k2", 1030.0, 1035.0, 2),
                 ("k3", 1060.0, 1090.0, 3), ("early", 900.0, 950.0, 4)]
    tr.annotations = {"runner.flush": [(980.0, 1002.0), (1005.0, 1050.0), (1055.0, 1098.0)],
                      "slam.closure": [(1070.0, 1095.0)],
                      "bench.window": [(1000.0, 1100.0)]}
    return tr


def test_the_idle_splits_by_the_spans_and_sums_to_the_idle_share():
    tr = _corridor_trace()
    # idle: 1000-1010, 1020-1030, 1035-1060, 1090-1100 (55 us)
    # closure 1070-1095: idle 1090-1095 (5 us)
    # flush less closure: 1000-1002, 1005-1050, 1055-1070, 1095-1098; idle
    #   1000-1002 + 1005-1010 + 1020-1030 + 1035-1050 + 1055-1060 + 1095-1098 = 40 us
    # outside: 1002-1005 + 1050-1055 + 1098-1100 = 10 us
    got = {name: _read(name, trace=tr) for name in IDLE + ("idle_pct.map",)}
    assert got["idle_pct.map.closure"] == pytest.approx(5.0)
    assert got["idle_pct.map.tracking"] == pytest.approx(40.0)
    assert got["idle_pct.map.outside_spans"] == pytest.approx(10.0)
    assert got["idle_pct.map"] == pytest.approx(55.0)
    assert sum(got[n] for n in IDLE) == pytest.approx(got["idle_pct.map"], abs=1e-9)


def test_a_closure_outside_any_flush_still_sums_to_the_idle_share():
    tr = _corridor_trace()
    tr.annotations["slam.closure"].append((1050.0, 1053.0))
    got = [_read(name, trace=tr) for name in IDLE]
    assert got[0] == pytest.approx(8.0) and got[2] == pytest.approx(7.0)
    assert sum(got) == pytest.approx(_read("idle_pct.map", trace=tr))


def test_the_idle_shares_read_nothing_without_the_programs_spans():
    tr = _corridor_trace()
    tr.annotations = {"bench.window": [(1000.0, 1100.0)]}
    assert all(_read(name, trace=tr) is None for name in IDLE)
    assert all(_read(name, trace=None) is None for name in IDLE)


def test_the_fleet_span_readers_read_the_programs_spans():
    tr = Trace()
    tr.window = (0.0, 10_000.0)
    # three calls inside the window (400, 600, 800 us) and one cut by its end
    tr.annotations = {"stream.track_streams_grid": [(100.0, 500.0), (3000.0, 3600.0),
                                                    (6000.0, 6800.0), (9900.0, 10_100.0)],
                      "tracker.materialize": [(1000.0, 2000.0), (4000.0, 5000.0)]}
    # materialize: 30 + 20 us launched in the first call, 70 in the second;
    # a kernel launched outside both spans does not count
    tr.launches = {1: 1100.0, 2: 1500.0, 3: 4100.0, 4: 2500.0}
    tr.device = [("a", 1200.0, 1230.0, 1), ("b", 1600.0, 1620.0, 2),
                 ("c", 4200.0, 4270.0, 3), ("d", 2600.0, 2700.0, 4)]
    assert _read("fleet.stream_host_ms", trace=tr) == pytest.approx(0.6)
    assert _read("fleet.materialize_span_ms", trace=tr) == pytest.approx(0.06)
    tr.annotations = {}
    assert _read("fleet.stream_host_ms", trace=tr) is None
    assert _read("fleet.materialize_span_ms", trace=tr) is None


class _Run:
    def __init__(self, phases):
        self.passes = [{"phases": p} for p in phases]


@pytest.mark.parametrize("name,key", [("map.preprocess_s", "preprocess"),
                                      ("map.detect_select_s", "detect.select"),
                                      ("map.detect_align_s", "detect.align"),
                                      ("map.vote_solve_s", "vote.solve")])
def test_the_phase_readers_average_over_the_passes(name, key):
    run = _Run([{key: 0.2, "detect": 1.0}, {key: 0.4, "detect": 1.0}, {"detect": 1.0}])
    assert _read(name, run=run) == pytest.approx(0.2)
    assert _read(name, run=_Run([{"detect": 1.0}])) is None


def test_the_counter_readers_divide_the_programs_counters(monkeypatch):
    monkeypatch.setattr(nn_icp_kernel, "pairs", 600)
    monkeypatch.setattr(nn_icp_kernel, "launches", 5)
    monkeypatch.setattr(pgo, "solves", 40)
    monkeypatch.setattr(pgo, "iterations", 300)
    assert _read("map.pairs_per_launch") == pytest.approx(120.0)
    assert _read("map.gn_iterations_per_solve") == pytest.approx(7.5)
    monkeypatch.setattr(nn_icp_kernel, "launches", 0)
    monkeypatch.setattr(pgo, "solves", 0)
    assert _read("map.pairs_per_launch") is None
    assert _read("map.gn_iterations_per_solve") is None
    monkeypatch.delattr(nn_icp_kernel, "pairs")
    monkeypatch.delattr(pgo, "iterations")
    monkeypatch.setattr(nn_icp_kernel, "launches", 5)
    monkeypatch.setattr(pgo, "solves", 40)
    assert _read("map.pairs_per_launch") is None
    assert _read("map.gn_iterations_per_solve") is None


def test_interval_arithmetic():
    a = spans.union([(5.0, 7.0), (0.0, 2.0), (1.0, 3.0), (9.0, 9.0)])
    assert a == [(0.0, 3.0), (5.0, 7.0)]
    assert spans.intersect(a, [(2.0, 6.0)]) == [(2.0, 3.0), (5.0, 6.0)]
    assert spans.subtract(a, [(1.0, 2.0), (6.0, 10.0)]) == [(0.0, 1.0), (2.0, 3.0),
                                                           (5.0, 6.0)]
    assert spans.length(a) == 5.0
