"""Scaling harness of the parallel layer (counterpart of
``srrg2_laser_slam_2d_tpu/parallel/scaling.py``): distributed PGO, sharded
batch alignment, the sharded Schur solve and K-stream tracking, each at the
group sizes 1, 2, 4 and the whole world that the process group offers.

Every rank runs the measurement functions in the same order (they create
subgroups and call collectives); ranks outside a subgroup wait at a
barrier. Rank 0's times are the result, shared with every rank.

Usage: python -m srrg2_laser_slam_2d_tpu_torch.parallel.scaling
           [--what pgo|align|schur|streams|all] [--side 32] [--world N]
           [--out results.json] [--device cpu]

``--world N`` starts N ranks (``multihost.spawn_ranks``; on the CPU under
gloo, on CUDA cards under NCCL, one card a rank). With one rank, as on a
one-card machine, every measurement has one row (``devices: 1``): a
correctness run of the collective path that measures no scaling. On the CPU
the numbers validate the harness; they are not device numbers.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from .._device import resolve_device
from . import mesh


def _counts(device_counts) -> list[int]:
    world = dist.get_world_size()
    return sorted({c for c in (device_counts or [1, 2, 4, world]) if c <= world})


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn, reps: int, device: torch.device) -> tuple[float, object]:
    """Seconds per call of ``fn`` over ``reps`` calls after one warm-up, one
    synchronisation at the end; and the last call's result."""
    out = fn()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    _sync(device)
    return (time.perf_counter() - t0) / reps, out


def _at_each_count(device_counts, run) -> list[dict]:
    """``run(n, group)`` on the first n ranks for every group size n; rank
    0's rows, shared with every rank."""
    rows = []
    for n in _counts(device_counts):
        group = mesh.make_group(n)
        row = run(n, group) if dist.get_rank() < n else None
        dist.barrier()
        rows.append(row)
    shared = [rows]
    dist.broadcast_object_list(shared, src=0)
    return shared[0]


def _speedups(results: list[dict], rate_key: str | None = None) -> list[dict]:
    base = results[0]
    for r in results:
        if rate_key is None:
            r["speedup"] = base["seconds"] / r["seconds"]
        else:
            r["speedup"] = r[rate_key] / base[rate_key]
        r["efficiency"] = r["speedup"] / r["devices"]
    return results


def measure_pgo_scaling(side: int = 32, device_counts=None, reps: int = 3,
                        device=None) -> list[dict]:
    """Distributed dense Gauss-Newton (3 iterations) on the ``side`` x
    ``side`` lattice of ``bench/pgo_bench``."""
    from ..bench import pgo_bench
    from ..solver import pgo
    from . import dist_pgo

    device = resolve_device(device)
    graph = pgo_bench.make_grid_graph(side, device=device)
    cfg = pgo.PGOConfig(max_iterations=3)

    def run(n, group):
        g = dist_pgo.shard_edges(graph, group)
        dt, (_, chi, _) = _timed(lambda: dist_pgo.optimize_sharded(cfg, g, group), reps, device)
        return {"devices": n, "seconds": dt, "chi": float(chi)}

    return _speedups(_at_each_count(device_counts, run))


def measure_batch_align_scaling(k_per_device: int = 4, n_points: int = 512,
                                device_counts=None, reps: int = 3, device=None) -> list[dict]:
    """Loop-closure candidate alignment with a fixed batch PER RANK (weak
    scaling of the detector's batched ICP)."""
    from ..ops import icp
    from ..ops.projector import PolarProjection
    from ..utils import cloud as cloud_op
    from .batch_align import batch_align_sharded

    device = resolve_device(device)
    rng = np.random.default_rng(0)
    a = (np.arange(n_points) + 0.4) * (2 * np.pi / n_points) - np.pi
    xy = np.stack([3.0 * np.cos(a), 2.0 * np.sin(a)], 1).astype(np.float32)
    nrm = -np.stack([np.cos(a) / 3.0, np.sin(a) / 2.0], 1).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    base = cloud_op.from_numpy(xy, nrm, device=device)
    proj = PolarProjection.make(cols=n_points, angle_min=-np.pi, angle_max=np.pi,
                                range_min=0.1, range_max=10.0)
    acfg = icp.AlignerConfig(max_iterations=10, odom_weight=0.0)
    draws = {n: rng.normal(scale=0.05, size=(k_per_device * n, 3)).astype(np.float32)
             for n in _counts(device_counts)}

    def run(n, group):
        k = k_per_device * n
        fixed = base.map(lambda x: torch.stack([x] * k))
        initials = torch.from_numpy(draws[n]).to(device)
        dt, _ = _timed(lambda: batch_align_sharded(acfg, proj, group, fixed, fixed, initials),
                       reps, device)
        return {"devices": n, "candidates": k, "seconds": dt, "rate": k / dt}

    return _speedups(_at_each_count(device_counts, run), "rate")


def measure_schur_scaling(side: int = 24, device_counts=None, reps: int = 3,
                          device=None) -> list[dict]:
    """The Schur-partitioned solve (2 Gauss-Newton iterations), one
    partition per rank (strong scaling of the separator-reduced solve)."""
    from ..bench import pgo_bench
    from ..solver import pgo, schur

    device = resolve_device(device)
    graph = pgo_bench.make_grid_graph(side, device=device)
    cfg = pgo.PGOConfig(max_iterations=2)

    def run(n, group):
        part = schur.partition_graph(graph, n_parts=n, n_vars=side * side)
        dt, (_, chi, _) = _timed(lambda: schur.optimize_schur_sharded(cfg, graph, part, group),
                                 reps, device)
        return {"devices": n, "seconds": dt, "chi": float(chi)}

    return _speedups(_at_each_count(device_counts, run))


def measure_stream_scaling(k_per_device: int = 4, frames: int = 16, num_beams: int = 181,
                           device_counts=None, reps: int = 3, device=None) -> list[dict]:
    """Tracking frames/s with a fixed number of streams PER RANK through the
    K-stream frame kernel (``ops/stream_kernel.track_streams_grid``: one
    launch of ``k_per_device`` streams a call on each rank). Chained:
    ``max(reps, 5)`` calls feeding the state back, one synchronisation; the
    slowest rank's time counts. On the CPU the kernel's plain version runs."""
    from ..bench import pipeline, synthetic
    from ..models import fast_tracker as ft
    from ..models.preprocessor import PreprocessorConfig
    from ..ops import stream_kernel as sk
    from ..ops.frame_kernel import FrameSpec
    from ..ops.projector import PolarProjection

    device = resolve_device(device)
    proj = PolarProjection.make(cols=num_beams, angle_min=-np.pi, angle_max=np.pi,
                                range_min=0.3, range_max=20.0)
    spec = FrameSpec(scene_capacity=512, projection=proj, iterations=5, odom_weight=1.0,
                     meas_as_canvas=True)
    pcfg = PreprocessorConfig(voxelize_resolution=0.02, normal_window=8)
    ds = synthetic.simulate(synthetic.SyntheticConfig(steps=frames, num_beams=num_beams),
                            device)
    stack = pipeline.preprocess_batch(ds.projection, pcfg,
                                      torch.from_numpy(ds.ranges).to(device))
    od = torch.from_numpy(ds.robot_poses).to(device)
    st = ft.seed(spec, pipeline.tree_index(stack, 0),
                 np.array(ds.config.sensor_in_robot, np.float32), odom=ds.robot_poses[0])
    measC = ft.pack_measurement_canvas_batch(spec, stack.map(lambda x: x[1:]))
    k = k_per_device
    cacheB, poseB = sk.pack_stream_state(st.cacheT.expand((k,) + st.cacheT.shape),
                                         st.pose.expand((k,) + st.pose.shape))
    measC_stack, odom_stack = sk.pack_stream_measurements(
        measC.expand((k,) + measC.shape).contiguous(), od[1:].expand((k,) + od[1:].shape))
    t_frames = measC_stack.shape[0]
    chain = max(reps, 5)

    def chained():
        cB, pB = cacheB, poseB
        for _ in range(chain):
            cB, pB, _ = sk.track_streams_grid(spec, cB, pB, measC_stack, odom_stack)
        return pB

    def run(n, group):
        chained()
        _sync(device)
        t0 = time.perf_counter()
        chained()
        _sync(device)
        dt = torch.tensor((time.perf_counter() - t0) / chain, dtype=torch.float64,
                          device=device)
        dist.all_reduce(dt, op=dist.ReduceOp.MAX, group=group)
        dt = float(dt)
        return {"devices": n, "streams": k * n, "seconds": dt, "chained_calls": chain,
                "aggregate_scans_per_sec": k * n * t_frames / dt}

    return _speedups(_at_each_count(device_counts, run), "aggregate_scans_per_sec")


JOBS = {
    "pgo": lambda a, dev: measure_pgo_scaling(a.side, device=dev),
    "align": lambda a, dev: measure_batch_align_scaling(device=dev),
    "schur": lambda a, dev: measure_schur_scaling(min(a.side, 24), device=dev),
    "streams": lambda a, dev: measure_stream_scaling(device=dev),
}


def _measure(device, args) -> dict:
    """Every job of ``args.what`` on this rank (run on every rank)."""
    from .._device import card_description

    names = list(JOBS) if args.what == "all" else [args.what]
    world = dist.get_world_size()
    out = {"backend": dist.get_backend(), "device": card_description(device),
           "world_size": world,
           "note": ("world size 1: a correctness run of the collective path; it measures "
                    "no scaling" if world == 1 else
                    f"{world} ranks, one device each")
           + ("; CPU ranks (gloo): harness validation, not device numbers"
              if device.type == "cpu" else "")}
    for name in names:
        out[name] = JOBS[name](args, device)
    return out


def main(argv=None) -> dict:
    from . import multihost

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--side", type=int, default=32)
    ap.add_argument("--what", choices=["pgo", "align", "schur", "streams", "all"],
                    default="pgo")
    ap.add_argument("--world", type=int, default=1, help="ranks to start")
    ap.add_argument("--out", default=None, help="write the results JSON here")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' uses gloo)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if args.world > 1:
        out = multihost.spawn_ranks(args.world, _measure, args, device=device.type)[0]
    elif dist.is_initialized():
        out = _measure(device, args)
    else:
        with tempfile.TemporaryDirectory() as tmp:
            dev = multihost.init_multiprocess(0, 1, "file://" + os.path.join(tmp, "rdv"),
                                              device=device)
            try:
                out = _measure(dev, args)
            finally:
                dist.destroy_process_group()
    for name in JOBS:
        for r in out.get(name, []):
            extra = "".join(f" {k}={r[k]}" for k in ("candidates", "streams") if k in r)
            print(f"{name} devices={r['devices']}: {r['seconds'] * 1000:.1f} ms "
                  f"speedup={r['speedup']:.2f} efficiency={r['efficiency']:.2f}{extra}")
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
