"""``bench/ablate.py`` of the port on the CPU at ``--frames 4``: it prints
the rows that the JAX module prints off its accelerator (the plain step
through ``track_sequence`` and the plain merge alone), in the same order
and format, and writes them with ``--json-out``. CPU times are not device
numbers: the result says so."""

import json
import re
import sys

from srrg2_laser_slam_2d_tpu_torch.bench import ablate

CPU_ROWS = ["xla full step", "xla full merge alone"]
ROW = re.compile(r"^(.{42}) +([0-9.]+) ms/(frame|call)")


def _rows(text: str) -> list[str]:
    return [m.group(1).strip() for m in map(ROW.match, text.splitlines()) if m]


def test_ablate_prints_every_cpu_row(tmp_path, capsys, monkeypatch):
    out_json = tmp_path / "rows.json"
    out = ablate.main(["--frames", "4", "--reps", "1", "--cap", "1024", "--device", "cpu",
                       "--json-out", str(out_json)])
    printed = capsys.readouterr().out
    assert _rows(printed) == CPU_ROWS
    assert [r["name"] for r in out["rows"]] == CPU_ROWS
    assert out["frames"] == 4 and out["mode"].startswith("cpu_plain")
    step, merge = out["rows"]
    assert step["ms_per_frame"] > 0 and step["scans_per_s"] > 0 and merge["ms_per_call"] > 0
    # the CPU runs plain versions: no kernel launches
    assert step["launches"] == {} and merge["launches"] == {}
    assert json.loads(out_json.read_text())["rows"] == out["rows"]

    # the JAX module's rows off its accelerator, in the same order
    from srrg2_laser_slam_2d_tpu.bench import ablate as jablate

    monkeypatch.setattr(sys, "argv", ["ablate", "--frames", "4", "--reps", "1", "--cap", "1024"])
    jablate.main()
    assert _rows(capsys.readouterr().out) == CPU_ROWS
