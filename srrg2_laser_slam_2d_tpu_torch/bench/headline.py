"""Headline benchmark of the port: scan-to-local-map tracking throughput
per card. Twin of the repository's root ``bench.py`` for the JAX package.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "mode",
"streams"}. The value is the aggregate over ``STREAMS`` concurrent tracking
streams through the K-stream frame kernel (``bench/stream_bench.py``), 721
beams, 256 frames, every stream's scene materialized. ``vs_baseline`` is the
ratio to the single-core C++ implementation of the same per-stream pipeline
(``native/baseline_icp.cpp``), compiled and run afresh on this host; it is
null where no ``g++`` is installed. A failure of the K-stream kernel is an
error: there is no single-stream fallback.

  python -m srrg2_laser_slam_2d_tpu_torch.bench.headline [--device cuda]

``--device cpu`` runs the same K-stream program through the plain PyTorch
version at 32 frames and 2 streams and reports ``"mode": "cpu_plain"``; that
figure says nothing about a card.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
from pathlib import Path

from .._device import resolve_device
from . import stream_bench

NUM_BEAMS = 721
FRAMES = 256
STREAMS = 32
CPU_FRAMES = 32
CPU_STREAMS = 2
_ROOT = Path(__file__).resolve().parent.parent.parent


def cpp_baseline() -> float | None:
    """Scans per second of the single-core C++ baseline, built into
    ``build/native`` and run now; None where there is no ``g++``."""
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    exe = _ROOT / "build" / "native" / "baseline_icp"
    exe.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([gxx, "-O3", "-march=native", "-std=c++17",
                    str(_ROOT / "native" / "baseline_icp.cpp"), "-o", str(exe)],
                   check=True, capture_output=True, timeout=600)
    out = subprocess.run([str(exe)], check=True, capture_output=True, timeout=600)
    return float(json.loads(out.stdout.decode().strip())["scans_per_sec"])


def headline(device=None, reps: int = 5) -> dict:
    """Measure and return the headline object."""
    device = resolve_device(device)
    on_card = device.type == "cuda"
    frames, streams = (FRAMES, STREAMS) if on_card else (CPU_FRAMES, CPU_STREAMS)
    spec, state0, measC, odoms = stream_bench.build_inputs(frames, NUM_BEAMS, device)
    r = stream_bench.measure_streams(spec, state0, measC, odoms, streams,
                                     chain=stream_bench.CHAIN if on_card else 1, reps=reps)
    value = r["aggregate_scans_per_sec"]
    base = cpp_baseline()
    return {"metric": "tracking_throughput", "value": round(value, 2),
            "unit": "scans/sec/chip",
            "vs_baseline": round(value / base, 2) if base else None,
            "mode": "k_stream" if on_card else "cpu_plain", "streams": streams}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs the plain "
                         "version at a small size)")
    args = ap.parse_args()
    print(json.dumps(headline(args.device)))


if __name__ == "__main__":
    main()
