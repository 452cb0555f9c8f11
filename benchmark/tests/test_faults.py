"""Each fault a cell can have, planted under the timed path on the CPU at a
tiny size, turns ``correct`` false; the sound run beside it stays true.

  python -m pytest benchmark/tests/test_faults.py -q -p no:randomly

The corridor's closure faults need a log long enough to close loops, some
minutes of plain PyTorch on the CPU.
"""

from __future__ import annotations

import math
import time

import pytest
import torch

from benchmark import harness
from benchmark.tests.test_benchmark_harness import tiny

CPU = torch.device("cpu")
FRAMES_WITH_CLOSURES = 700       # the corridor's first loops close before this frame
CHUNK_WITH_CLOSURES = 128


def correct(cell) -> bool:
    out = harness.measure(cell, 2**31 + 77, 0.3, False, CPU, time.perf_counter())
    return out["correct"]


# ----------------------------------------------------------------- fleet

def _unchanged(real):
    def fault(spec, cacheB, poseB, measC_stack, odom_stack):
        _, _, pay = real(spec, cacheB, poseB, measC_stack, odom_stack)
        return cacheB.clone(), poseB.clone(), torch.zeros_like(pay)
    return fault


def _half_left_out(real):
    def fault(spec, cacheB, poseB, measC_stack, odom_stack):
        h = poseB.shape[0] // 2
        c, p, pay = real(spec, cacheB[:, :h].contiguous(), poseB[:h].contiguous(),
                         measC_stack[:, :, :h].contiguous(), odom_stack[:, :h].contiguous())
        pay_all = torch.zeros(pay.shape[:2] + (poseB.shape[0],) + pay.shape[3:])
        pay_all[:, :, :h] = pay
        return (torch.cat([c, cacheB[:, h:]], 1), torch.cat([p, poseB[h:]], 0), pay_all)
    return fault


def _answer_altered(real):
    def fault(spec, cacheB, poseB, measC_stack, odom_stack):
        c, p, pay = real(spec, cacheB, poseB, measC_stack, odom_stack)
        p = p.clone()
        p[0, 0] += 1.0
        return c, p, pay
    return fault


@pytest.mark.parametrize("fault", [None, _unchanged, _half_left_out, _answer_altered])
def test_fleet_fault_turns_correct_false(fault, monkeypatch):
    from srrg2_laser_slam_2d_tpu_torch.ops import stream_kernel as sk

    if fault is not None:
        monkeypatch.setattr(sk, "track_streams_grid", fault(sk.track_streams_grid))
    assert correct(tiny("fleet.k8")) is (fault is None)


# -------------------------------------------------------------- corridor

def _frames_unchanged(real):
    def fault(spec, cacheT, pose, measC):
        _, _, pay = real(spec, cacheT, pose, measC)
        return cacheT.clone(), pose.clone(), torch.zeros_like(pay)
    return fault


def _pairs_half_left_out(real):
    def fault(fixed, moving, initials, **kw):
        # the first half of the batch aligned, the rest (at least one pair)
        # left out: handed back at its initial guess
        n = initials.shape[0]
        h = n // 2
        if h == 0:
            r = real(fixed, moving, initials, **kw)
            return r._replace(estimate=initials.clone())
        r = real(fixed.map(lambda x: x[:h]), moving.map(lambda x: x[:h]), initials[:h], **kw)
        return type(r)(*(torch.cat([x, torch.zeros((n - h,) + x.shape[1:], dtype=x.dtype)])
                         if x is not r.estimate else torch.cat([x, initials[h:]]) for x in r))
    return fault


def _solve_altered(real):
    def fault(cfg, graph, *a, **kw):
        g, chi, it = real(cfg, graph, *a, **kw)
        poses = g.poses.clone()
        poses[int(graph.var_valid.nonzero()[-1]), 0] += 1.0
        return g._replace(poses=poses), chi, it
    return fault


def corridor_with_closures():
    cell = tiny("corridor.offline")
    cell.mix = dict(cell.mix, max_frames=FRAMES_WITH_CLOSURES, copies=1)
    cell.config = dict(cell.config, runner={"chunk": CHUNK_WITH_CLOSURES})
    return cell


def test_corridor_frame_fault_turns_correct_false(monkeypatch):
    from srrg2_laser_slam_2d_tpu_torch.models import chunked_slam

    cell = tiny("corridor.offline")
    assert correct(cell)
    monkeypatch.setattr(chunked_slam, "track_frames_grid",
                        _frames_unchanged(chunked_slam.track_frames_grid))
    assert not correct(cell)


@pytest.mark.parametrize("fault", [None, _pairs_half_left_out, _solve_altered])
def test_corridor_closure_fault_turns_correct_false(fault, monkeypatch):
    from srrg2_laser_slam_2d_tpu_torch.ops import nn_icp_kernel
    from srrg2_laser_slam_2d_tpu_torch.solver import pgo

    if fault is _pairs_half_left_out:
        monkeypatch.setattr(nn_icp_kernel, "fused_align_pairs",
                            fault(nn_icp_kernel.fused_align_pairs))
    elif fault is _solve_altered:
        monkeypatch.setattr(pgo, "optimize", fault(pgo.optimize))
    cell = corridor_with_closures()
    out = harness.measure(cell, 2**31 + 78, 0.3, False, CPU, time.perf_counter())
    closure_numbers = ("closure_estimate_off_share", "solve_chi_excess", "solve_pose_gap_m")
    assert all(math.isfinite(out["check"][k]["value"]) for k in closure_numbers)
    ok = all(out["check"][k]["value"] <= out["check"][k]["limit"] for k in closure_numbers)
    assert ok is (fault is None), out["check"]
