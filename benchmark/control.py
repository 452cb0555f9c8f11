"""The readings that a cell's limits are set from, on the chip:

  python -m benchmark.control --workload <cell> --seeds 1,2,3 [--seconds 3]

For each seed: the cell's set-up and a short window of the program at the
cell's own size, then its check twice over the same sampled work: the
program's numbers (the lower readings), and the control's, the reference
computed in bfloat16 in the program's place (the upper readings). One JSON
line a seed; all of them in ``chiprun_out/control_<cell>.jsonl``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

CONTROL_DTYPE = "bfloat16"


def readings(cell, seed: int, seconds: float, device) -> dict:
    import importlib

    import torch

    gen = importlib.import_module(f"benchmark.traffic.{cell.mix['generator']}")
    t0 = time.perf_counter()
    run = gen.setup(cell, seed, device)
    run.warm_up()
    run.run_window(seconds)
    run.release()
    t1 = time.perf_counter()
    program = run.check()
    t2 = time.perf_counter()
    control = run.check(control_dtype=getattr(torch, CONTROL_DTYPE))
    t3 = time.perf_counter()
    return {"cell": cell.name, "seed": seed, "attempted": run.attempted(),
            "setup_and_window_s": t1 - t0, "check_s": t2 - t1, "control_s": t3 - t2,
            "program": {n: v for n, v, _ in program},
            "control": {n: v for n, v, _ in control},
            "limits": {n: lim for n, _, lim in program}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    import torch

    from benchmark.harness import Cell

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = Cell(args.workload)
    os.makedirs("chiprun_out", exist_ok=True)
    path = os.path.join("chiprun_out", f"control_{cell.name}.jsonl")
    for s in (int(x) for x in args.seeds.split(",") if x):
        row = readings(cell, s, args.seconds, torch.device("cuda"))
        row["card"] = torch.cuda.get_device_name(0)
        print(json.dumps(row), flush=True)
        with open(path, "a") as f:
            f.write(json.dumps(row) + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
