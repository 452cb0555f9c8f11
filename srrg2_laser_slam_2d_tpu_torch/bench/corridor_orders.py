"""How many orders of the moving points ``chip_smoke.check_nn_icp_corridor``
needs to find every corridor pair whose plain NN-ICP estimate is bistable
under reordering.

    python -m srrg2_laser_slam_2d_tpu_torch.bench.corridor_orders [--runs R]
        [--out chiprun_out/corridor_orders.json]

Run it from the repository root, on a card. Each of ``R`` corridor runs
(``chip_smoke.corridor_run``; the run's own sums on the card make each
detection batch a little different) gives its largest NN-ICP batch. The
kernel and the plain version run on it once; then the plain version with
the moving points reversed and in 255 permutations from seed 0, the orders
of the check. After 16, 32, 64, 128 and 256 of them it prints what the
check would find with that many: pairs held, the largest excess over
max(1e-3, 2 x spread) among them, the pairs past it, and pass or fail.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

PREFIXES = (16, 32, 64, 128, 256)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--runs", type=int, default=24)
    ap.add_argument("--out", default="chiprun_out/corridor_orders.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("corridor_orders: no CUDA device")
    from .._device import card_description
    from ..bench import corridor_e2e
    from ..ops import nn_icp_kernel as nk

    # chip_smoke.py sits at the repository root, beside the package
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import chip_smoke

    device = torch.device("cuda")
    msgs = corridor_e2e.load_messages()

    def plain(fixed, moving, initials, kw):
        return nk._result(*nk.fused_align_pairs_plain(
            nk.pack_fixed(fixed), nk.pack_moving(moving), initials, kw["iterations"],
            float(kw["max_distance"]) ** 2, float(kw["normal_cos"]),
            float(kw["chi_threshold"]), int(kw["min_inliers"]), int(kw["corr_refresh"])))

    rows = []
    for r in range(args.runs):
        capture = chip_smoke.DetectionCapture()
        chip_smoke.corridor_run("configurations/corridor.json", msgs, device, capture)
        fixed, moving, initials, kw = capture.batch
        J, M = fixed.xy.shape[0], moving.xy.shape[1]
        p = plain(fixed, moving, initials, kw)
        k = nk.fused_align_pairs(fixed, moving, initials, **kw)
        pair_err = (k.estimate - p.estimate).abs().amax(1)
        gen = torch.Generator().manual_seed(0)
        orders = [torch.arange(M - 1, -1, -1)] + [torch.randperm(M, generator=gen)
                                                  for _ in range(PREFIXES[-1] - 1)]
        spread = torch.zeros(J, device=device)
        row = {"run": r}
        for n, order in enumerate(orders, 1):
            o = order.to(device)
            q = plain(fixed, moving.map(lambda x: x[:, o]), initials, kw)
            spread = torch.maximum(spread, (q.estimate - p.estimate).abs().amax(1))
            if n in PREFIXES:
                held = spread <= 1e-3
                limit = torch.clamp(2 * spread, min=1e-3)
                excess = float((pair_err - limit)[held].max())
                row[n] = {"held": int(held.sum()), "excess": excess,
                          "past": torch.nonzero(held & (pair_err > limit)).flatten().tolist(),
                          "pass": excess <= 0.0 and int(held.sum()) >= J - J // 8}
        print(json.dumps(row), flush=True)
        rows.append(row)
    result = {"card": card_description(device), "runs": rows,
              "fails": {n: sum(not row[n]["pass"] for row in rows) for n in PREFIXES}}
    print(json.dumps(result["fails"]))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
