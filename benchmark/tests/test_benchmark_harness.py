"""The benchmark's own tests, on the CPU at tiny sizes (the cells' sizes run
on the card only):

  python -m pytest benchmark/tests -q -p no:randomly

What runs on the CPU drives the harness with ``device="cpu"``, where the
port takes its plain versions; nothing here needs a card.
"""

from __future__ import annotations

import ast
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import control, harness
from benchmark.counts import stream_kernel as count

BENCH = Path(harness.__file__).resolve().parent
ROOT = BENCH.parent
PORT = "srrg2_laser_slam_2d_tpu_torch"
CPU = torch.device("cpu")
CELL = harness.Cell


def tiny(name: str) -> harness.Cell:
    """A cell shrunk to run on the CPU in seconds."""
    cell = CELL(name)
    if cell.mix["generator"] == "fleet_batches":
        cell.mix = dict(cell.mix, robots=4, batch_frames=4, batches_per_drive=2,
                        robots_per_block=2)
    else:
        cell.mix = dict(cell.mix, max_frames=96, copies=2)
        cell.config = dict(cell.config, runner={"chunk": 64})
        # a 96-frame prefix of the log has no loop to close
        cell.limits = dict(cell.limits, frames_checked=8,
                           limits=dict(cell.limits["limits"], passes_without_closures=99))
    return cell


def cells() -> list[str]:
    return [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("kind", ["configs", "workloads", "traffic"])
def test_data_files_load(kind):
    files = sorted((BENCH / kind).glob("*.json"))
    assert files
    for f in files:
        assert isinstance(json.loads(f.read_text()), dict), f


@pytest.mark.parametrize("name", cells())
def test_every_cell_resolves(name):
    cell = harness.Cell(name)
    assert cell.end_to_end and cell.per_layer
    assert any(m["name"] == "setup_s" for m in cell.end_to_end)
    for m in cell.per_layer:
        assert (BENCH / "metrics" / f"{m['name']}.py").exists(), m["name"]
    assert (BENCH / "traffic" / f"{cell.mix['generator']}.py").exists()
    assert cell.limits["limits"]


@pytest.mark.parametrize("name", ["fleet.k8", "corridor.offline"])
def test_dry_run_prints_one_well_formed_line(name, monkeypatch, capsys):
    monkeypatch.setattr(harness, "Cell", lambda n: tiny(n))
    rc = harness.main(["--workload", name, "--seed", str(2**31 + 12345), "--seconds", "0.5",
                       "--trace", "0"], time.perf_counter(), device="cpu")
    assert rc == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    out = json.loads(last)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "check"
    assert out["correct"] is True
    cell = CELL(name)
    assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}
    for m in cell.end_to_end:
        assert out["metrics"][m["name"]]["unit"] == m["unit"]


def test_traced_dry_run_reads_the_window(monkeypatch, capsys):
    monkeypatch.setattr(harness, "Cell", lambda n: tiny(n))
    rc = harness.main(["--workload", "fleet.k8", "--seed", "3", "--seconds", "0.5",
                       "--trace", "1"], time.perf_counter(), device="cpu")
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def test_refuses_to_run_without_the_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = harness.main(["--workload", "fleet.k8", "--seed", "1", "--seconds", "1",
                       "--trace", "0"], time.perf_counter())
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, PORT + "._probe", sys)
    assert harness.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "srrg2_laser_slam_2d_tpu._probe", sys)
    assert harness.loaded_forbidden() == ["srrg2_laser_slam_2d_tpu"]


DRY_RUN = f"""
import sys, time
sys.path.insert(0, {str(ROOT)!r})
import torch
from benchmark import harness
from benchmark.tests.test_benchmark_harness import tiny
for name in ("fleet.k8", "corridor.offline"):
    harness.measure(tiny(name), 5, 0.3, False, torch.device("cpu"), time.perf_counter())
print(sorted({{m.split('.', 1)[0] for m in sys.modules}}))
"""


def test_a_run_loads_neither_jax_nor_the_jax_package():
    out = subprocess.run([sys.executable, "-c", DRY_RUN], capture_output=True, text=True,
                         cwd=ROOT, timeout=600, check=True).stdout
    tops = set(ast.literal_eval(out.strip().splitlines()[-1]))
    assert PORT in tops
    assert not tops & set(harness.FORBIDDEN)


def test_the_references_import_nothing_of_the_port():
    for f in sorted((BENCH / "reference").glob("*.py")):
        for node in ast.walk(ast.parse(f.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) and not node.level
                     else [])
            for n in names:
                assert n.split(".")[0] not in (PORT, *harness.FORBIDDEN), (f.name, n)
    probe = ("import sys; sys.path.insert(0, %r); import benchmark.reference.stream, "
             "benchmark.reference.frame, benchmark.reference.nn_icp, benchmark.reference.pgo, "
             "benchmark.reference.ate; print(sorted({m.split('.')[0] for m in sys.modules}))"
             % str(ROOT))
    tops = ast.literal_eval(subprocess.run([sys.executable, "-c", probe], capture_output=True,
                                           text=True, check=True, timeout=120).stdout)
    assert PORT not in tops


def test_frozen_counts_equal_chip_smokes_formula():
    src = (ROOT / "chip_smoke.py").read_text()
    bytes_expr = re.search(r"bytes_moved = (4 \* \(T \* \(6 \+ 8\).*?\))\n", src).group(1)
    from srrg2_laser_slam_2d_tpu_torch.ops import stream_kernel as sk

    T, K, B, its, refresh = 255, 32, 768, 10, 2
    assert count.launch_bytes(T, K, B) == eval(bytes_expr, {"T": T, "K": K, "B": B})
    assert count.launch_flops(T, K, B, its, refresh) == T * K * B * sk.flops_per_lane_frame(
        its, refresh)


@pytest.mark.parametrize("name", ["fleet.k8", "corridor.offline"])
def test_the_control_fails_the_check(name):
    row = control.readings(tiny(name), 11, 0.3, CPU)
    assert all(v <= row["limits"][k] for k, v in row["program"].items()), row
    assert any(v > row["limits"][k] for k, v in row["control"].items()), row


def test_the_corridor_copies_are_drawn_from_the_seed():
    from benchmark.traffic import log_passes

    cell = tiny("corridor.offline")
    cell.mix = dict(cell.mix, max_frames=4, copies=2)

    def ranges(seed):
        run = log_passes.setup(cell, seed, CPU)
        run.release()
        return [np.stack([m.ranges for m in c if isinstance(m, run.laser_type)])
                for c in run.copies]

    a, b, c = ranges(2**31 + 5), ranges(2**31 + 5), ranges(2**31 + 6)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], a[1])
    assert not any(np.array_equal(x, y) for x, y in zip(a, c))


def test_the_corridor_check_refuses_a_pass_it_did_not_see(monkeypatch):
    from benchmark.traffic import log_passes

    class Blind(log_passes.Hooks):
        """Hooks that see no call: as if the loop reached its entries
        through names the benchmark does not wrap."""

        def __init__(self):
            super().__init__()
            self.remove()

    cell = tiny("corridor.offline")
    sound = harness.measure(cell, 2**31 + 9, 0.3, False, CPU, time.perf_counter())
    assert sound["correct"] and "unchecked" not in sound["check"]
    monkeypatch.setattr(log_passes, "Hooks", Blind)
    blind = harness.measure(cell, 2**31 + 9, 0.3, False, CPU, time.perf_counter())
    assert not blind["correct"]
    assert blind["check"]["unchecked"] == {"value": 1.0, "limit": 0.0}


def test_kernel_1_windows_after_every_split_compare_their_own_frames():
    """Every window the check may draw, up to the chunk's last frame, reads
    nought on the CPU, where the program runs its plain frame step."""
    from benchmark.traffic import log_passes

    cell = tiny("corridor.offline")
    cell.mix = dict(cell.mix, max_frames=150, copies=1)
    run = log_passes.setup(cell, 7, CPU)
    rec, _, _ = run._pass(run.copies[0], None, capture=True)
    run.release()
    cap, msgs = rec["capture"], rec["msgs"]
    assert len(cap.frames) == 3
    seen = 0
    for c, (cacheT, pose, measC, (_, _, payloads)) in enumerate(cap.frames):
        for s in run.splits(msgs, c, payloads):
            state = run.split_state(msgs, c, s, cacheT, pose, payloads)
            nums = run._check_window(measC, payloads, msgs, c, s + 1, 8, *state, None)
            assert all(v == 0.0 for v in nums.values()), (c, s, nums)
            seen += 1
    assert seen > 10
