"""``dryrun_multichip(n)``: the whole parallel layer once at n ranks (the
twin of the JAX package's ``__graft_entry__.py:dryrun_multichip``).

Distributed PGO on a 16-node ring with its edges sharded over the ranks,
the Schur solve with one partition a rank, ``batch_align_sharded`` over 2n
candidates, and the K-stream frame kernel with one stream a rank; prints the
JAX version's summary line. On the CPU it starts n gloo ranks; on a CUDA
card it runs under NCCL, in this process where n = 1 (a correctness run of
the collective path, which measures no scaling).

Usage: python -m srrg2_laser_slam_2d_tpu_torch.parallel.dryrun [N] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from .._device import resolve_device


def ring_truth(v: int) -> torch.Tensor:
    """The v poses of a noiseless ring: unit steps turning 2 pi / v from the
    origin (float32)."""
    from ..utils import geometry

    step = torch.tensor([1.0, 0.0, 2 * np.pi / v], dtype=torch.float32)
    poses, p = [], torch.zeros(3)
    for _ in range(v):
        poses.append(p)
        p = geometry.compose(p, step)
    return torch.stack(poses)


def ring_graph(v: int, edge_capacity: int, rng, device):
    """A v-node ring (``ring_truth``), its poses perturbed by N(0, 0.05)
    from ``rng``, its v edges the perturbed relative poses, node 0 fixed."""
    from ..solver import pgo
    from ..utils import geometry

    poses = ring_truth(v) + torch.from_numpy(
        rng.normal(scale=0.05, size=(v, 3)).astype(np.float32))
    meas = torch.stack([geometry.relative(poses[k], poses[(k + 1) % v]) for k in range(v)])
    g = pgo.empty_graph(v, edge_capacity)
    ar = torch.arange(v)
    g.poses[:v] = poses
    g.var_valid[:v] = True
    g.var_fixed[0] = True
    g.edge_i[:v] = ar
    g.edge_j[:v] = (ar + 1) % v
    g.edge_meas[:v] = meas
    g.edge_valid[:v] = True
    return pgo.PoseGraph(*(x.to(device) for x in g))


def dryrun_rank(device) -> dict:
    """One rank's part of the dry run in the current process group; every
    rank returns the same summary values."""
    from ..bench import pipeline, synthetic
    from ..models import fast_tracker as ft
    from ..models.preprocessor import PreprocessorConfig
    from ..ops import icp
    from ..ops import stream_kernel as sk
    from ..ops.frame_kernel import FrameSpec
    from ..ops.projector import PolarProjection
    from ..solver import pgo, schur
    from ..utils import cloud as cloud_op
    from .batch_align import batch_align_sharded
    from .dist_pgo import optimize_sharded, shard_edges
    from .mesh import all_gather_cat

    n = dist.get_world_size()
    rng = np.random.default_rng(0)

    # distributed PGO: the ring's edges sharded over the ranks
    v = 16
    graph = ring_graph(v, max(n * 4, 32), rng, device)
    _, chi, iters = optimize_sharded(pgo.PGOConfig(max_iterations=3), shard_edges(graph), None)

    # the Schur-partitioned solve, one partition a rank
    part = schur.partition_graph(graph, n_parts=n, n_vars=v)
    _, schur_chi, _ = schur.optimize_schur_sharded(pgo.PGOConfig(max_iterations=2), graph, part)

    # candidate alignment sharded over the ranks
    k_batch, n_pts = n * 2, 128
    angles = (np.arange(n_pts) + 0.27) * (2 * np.pi / n_pts) - np.pi
    xy = np.stack([2.0 * np.cos(angles), 2.0 * np.sin(angles)], 1).astype(np.float32)
    nrm = (-xy / np.linalg.norm(xy, axis=1, keepdims=True)).astype(np.float32)
    fixed = cloud_op.from_numpy(xy, nrm, device=device).map(lambda x: torch.stack([x] * k_batch))
    initials = torch.from_numpy(rng.normal(scale=0.05, size=(k_batch, 3)).astype(np.float32))
    proj = PolarProjection.make(cols=128, angle_min=-np.pi, angle_max=np.pi, range_min=0.1,
                                range_max=10.0)
    res = batch_align_sharded(icp.AlignerConfig(max_iterations=5), proj, None, fixed, fixed,
                              initials.to(device))

    # K-stream tracking, one stream a rank (the throughput path's program)
    nb, t_frames = 128, 2
    sproj = PolarProjection.make(cols=nb, angle_min=-np.pi, angle_max=np.pi, range_min=0.3,
                                 range_max=20.0)
    spec = FrameSpec(scene_capacity=256, projection=sproj, iterations=2, odom_weight=1.0,
                     meas_as_canvas=True)
    ds = synthetic.simulate(synthetic.SyntheticConfig(steps=t_frames, num_beams=nb), device)
    stack = pipeline.preprocess_batch(
        ds.projection, PreprocessorConfig(voxelize_resolution=0.02, normal_window=4),
        torch.from_numpy(ds.ranges).to(device))
    od = torch.from_numpy(ds.robot_poses).to(device)
    st = ft.seed(spec, pipeline.tree_index(stack, 0),
                 np.array(ds.config.sensor_in_robot, np.float32), odom=ds.robot_poses[0])
    measC = ft.pack_measurement_canvas_batch(spec, stack.map(lambda x: x[1:]))
    cacheB, poseB = sk.pack_stream_state(st.cacheT[None], st.pose[None])
    measC_stack, odom_stack = sk.pack_stream_measurements(measC[None].contiguous(),
                                                          od[1:][None].contiguous())
    _, pB, _ = sk.track_streams_grid(spec, cacheB, poseB, measC_stack, odom_stack)
    pB = all_gather_cat(pB)
    return {"n": n, "pgo_chi": float(chi), "pgo_iters": int(iters),
            "schur_chi": float(schur_chi),
            "batch_align_max_abs_est": float(res.estimate.abs().max()),
            "stream_max_abs_pose": float(pB[:, 0:3].abs().max()),
            "backend": dist.get_backend()}


def summary_line(r: dict) -> str:
    return (f"dryrun_multichip({r['n']}): pgo chi={r['pgo_chi']:.4f} iters={r['pgo_iters']}; "
            f"schur chi={r['schur_chi']:.4f}; "
            f"batch_align max |est|={r['batch_align_max_abs_est']:.4f}; "
            f"stream poses max |x|={r['stream_max_abs_pose']:.4f}")


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """The dry run at ``n_devices`` ranks: in this process's group where it
    has one of that size; else on the CPU n gloo processes, on CUDA cards n
    NCCL ranks (one card each; in this process where n = 1). Prints the
    summary line; returns rank 0's values."""
    from .multihost import init_multiprocess, spawn_ranks

    device = resolve_device(device)
    if device.type == "cuda" and n_devices > torch.cuda.device_count():
        raise ValueError(f"{n_devices} ranks need {n_devices} cards, "
                         f"{torch.cuda.device_count()} visible")
    if dist.is_initialized():
        if dist.get_world_size() != n_devices:
            raise ValueError(f"this process is in a group of {dist.get_world_size()} ranks, "
                             f"not {n_devices}")
        out = dryrun_rank(device)
    elif device.type == "cuda" and n_devices == 1:
        with tempfile.TemporaryDirectory() as tmp:
            dev = init_multiprocess(0, 1, "file://" + os.path.join(tmp, "rdv"), device=device)
            try:
                out = dryrun_rank(dev)
            finally:
                dist.destroy_process_group()
    else:
        out = spawn_ranks(n_devices, dryrun_rank, device=device.type)[0]
    print(summary_line(out), flush=True)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("n", type=int, nargs="?", default=None,
                    help="ranks (default: the visible cards, or 2 on the CPU)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' uses gloo)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    n = args.n or (torch.cuda.device_count() if device.type == "cuda" else 2)
    return dryrun_multichip(n, device)


if __name__ == "__main__":
    main()
