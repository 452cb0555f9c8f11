"""Synthetic message logs with ground truth. Counterpart of
``srrg2_laser_slam_2d_tpu/apps/synthetic_scene_generator.py``: a single-laser
log (``dataset_to_messages``: the world cloud, then per step /tf, /scan and
/odom) and a dual-laser log (``dual_dataset_to_messages``: per step /tf with
both lasers' frames, /scan_0, /scan_1 and /odom), optionally with integrated
odometry noise and one laser blanked over a stretch of steps. One seed gives
the same messages as the JAX package's generator. ``--world corridors``
writes the Killian-scale corridor drive (``bench/synthetic.simulate_corridors``:
2,871 frames, noisy odometry) in place of the random walk.

Usage: python -m srrg2_laser_slam_2d_tpu_torch.apps.synthetic_scene_generator \\
           -m laser_messages.jsonl [--gt gt.tum] [--steps 100] \\
           [--world random|corridors] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from ..bench import synthetic
from ..io import logfile, tum
from ..io.messages import (LaserMessage, OdometryMessage, PointCloud2Message, TransformEvent,
                           TransformEventsMessage)

TIMESTEP = 0.001


def noisy_odometry(gt: np.ndarray, trans_noise: float, rot_noise: float, seed: int):
    """Integrated noisy relative motions: an odometry stream whose drift
    grows with the path length (the ground truth stays separate)."""
    rng = np.random.default_rng(seed)
    odom = [gt[0].astype(np.float32).copy()]
    for t in range(1, len(gt)):
        c, s = np.cos(gt[t - 1][2]), np.sin(gt[t - 1][2])
        Rm = np.array([[c, s], [-s, c]], np.float32)
        rel = np.concatenate([Rm @ (gt[t][:2] - gt[t - 1][:2]),
                              [np.arctan2(np.sin(gt[t][2] - gt[t - 1][2]),
                                          np.cos(gt[t][2] - gt[t - 1][2]))]])
        rel[:2] += rng.normal(scale=trans_noise, size=2)
        rel[2] += rng.normal(scale=rot_noise)
        c, s = np.cos(odom[-1][2]), np.sin(odom[-1][2])
        R = np.array([[c, -s], [s, c]], np.float32)
        odom.append(np.concatenate([odom[-1][:2] + R @ rel[:2],
                                    [odom[-1][2] + rel[2]]]).astype(np.float32))
    return np.stack(odom)


def _laser(cfg, topic: str, frame: str, seq: int, timestamp: float, ranges) -> LaserMessage:
    return LaserMessage(topic=topic, frame_id=frame, seq=seq, timestamp=timestamp,
                        angle_min=cfg.angle_min, angle_max=cfg.angle_max,
                        angle_increment=(cfg.angle_max - cfg.angle_min) / cfg.num_beams,
                        range_min=cfg.range_min, range_max=cfg.range_max, ranges=ranges)


def _odometry(seq: int, timestamp: float, pose) -> OdometryMessage:
    return OdometryMessage(topic="/odom", frame_id="odom", seq=seq, timestamp=timestamp,
                           child_frame="base_frame", pose=pose)


def dataset_to_messages(ds: synthetic.SyntheticDataset, odom_poses=None) -> list:
    """The single-laser log: the world cloud, then (/tf, /scan, /odom) per
    step, TIMESTEP apart."""
    cfg = ds.config
    odometry = ds.robot_poses if odom_poses is None else odom_poses
    scene = ds.scene.to("cpu")
    msgs = [PointCloud2Message(topic="/point_cloud", frame_id="world", seq=0, timestamp=0.0,
                               points=scene.xy.numpy()[scene.valid.numpy()])]
    seq, timestamp = 1, TIMESTEP
    for t in range(len(ds.ranges)):
        msgs.append(TransformEventsMessage(
            topic="/tf", seq=seq, timestamp=timestamp,
            events=[TransformEvent(timestamp=timestamp, child_frame="scan",
                                   parent_frame="base_frame",
                                   pose=np.asarray(cfg.sensor_in_robot, np.float32))]))
        timestamp += TIMESTEP          # one step per message, as the JAX package counts
        msgs.append(_laser(cfg, "/scan", "scan", seq + 1, timestamp, ds.ranges[t]))
        timestamp += TIMESTEP
        msgs.append(_odometry(seq + 2, timestamp, odometry[t]))
        timestamp += TIMESTEP
        seq += 3
    return msgs


def dual_dataset_to_messages(ds_front: synthetic.SyntheticDataset,
                             ds_rear: synthetic.SyntheticDataset,
                             topics=("/scan_0", "/scan_1"),
                             frames=("laser_frame_0", "laser_frame_1"),
                             odom_noise: float = 0.0, occlude: tuple | None = None,
                             seed: int = 0) -> list:
    """The dual-laser log of the MULTI assembly: per step one /tf message
    with both lasers' frames, one laser message per topic and /odom. Both
    datasets share the trajectory (same steps, seed and drift; only
    ``sensor_in_robot`` differs). ``odom_noise`` integrates Gaussian noise
    on each relative motion; ``occlude = (cue, start, end)`` blanks that
    laser (every range beyond its maximum) over steps [start, end)."""
    rng = np.random.default_rng(seed)
    if len(ds_front.ranges) != len(ds_rear.ranges):
        raise ValueError("the two datasets must have the same number of steps")
    gt = ds_front.robot_poses
    odom = [gt[0].copy()]
    for t in range(1, len(gt)):
        c, s = np.cos(gt[t - 1][2]), np.sin(gt[t - 1][2])
        Rm = np.array([[c, s], [-s, c]], np.float32)
        rel = np.concatenate([Rm @ (gt[t][:2] - gt[t - 1][:2]), [gt[t][2] - gt[t - 1][2]]])
        rel = rel + rng.normal(scale=odom_noise, size=3).astype(np.float32)
        c, s = np.cos(odom[-1][2]), np.sin(odom[-1][2])
        R = np.array([[c, -s], [s, c]], np.float32)
        odom.append(np.concatenate([odom[-1][:2] + R @ rel[:2],
                                    [odom[-1][2] + rel[2]]]).astype(np.float32))

    msgs, seq, timestamp = [], 0, 0.0
    datasets = (ds_front, ds_rear)
    for t in range(len(gt)):
        events = [TransformEvent(timestamp=timestamp, child_frame=frames[c],
                                 parent_frame="base_frame",
                                 pose=np.asarray(datasets[c].config.sensor_in_robot,
                                                 np.float32))
                  for c in range(2)]
        msgs.append(TransformEventsMessage(topic="/tf", seq=seq, timestamp=timestamp,
                                           events=events))
        seq += 1
        timestamp += TIMESTEP
        for c in range(2):
            cfg = datasets[c].config
            ranges = datasets[c].ranges[t]
            if occlude is not None and occlude[0] == c and occlude[1] <= t < occlude[2]:
                ranges = np.full_like(ranges, 2.0 * cfg.range_max)
            msgs.append(_laser(cfg, topics[c], frames[c], seq, timestamp, ranges))
            seq += 1
            timestamp += TIMESTEP
        msgs.append(_odometry(seq, timestamp, odom[t]))
        seq += 1
        timestamp += TIMESTEP
    return msgs


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-m", "--message", default="laser_messages.jsonl")
    ap.add_argument("--gt", default=None, help="ground-truth TUM output")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--beams", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--drift", type=float, nargs=3, default=(0.0, 0.0, 0.0))
    ap.add_argument("--world", choices=["random", "corridors"], default="random",
                    help="'corridors': the Killian-scale three-loop corridor world")
    ap.add_argument("--odom-noise", type=float, default=None,
                    help="integrated odometry noise sigma per step [m]")
    ap.add_argument("--device", default=None,
                    help="where the scans are simulated (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.world == "corridors":
        ccfg = synthetic.CorridorConfig(num_beams=args.beams, seed=args.seed)
        ds = synthetic.simulate_corridors(ccfg, device=args.device)
        trans_noise = args.odom_noise if args.odom_noise is not None else ccfg.odom_trans_noise
        odom = noisy_odometry(ds.robot_poses, trans_noise, ccfg.odom_rot_noise, args.seed + 7)
    else:
        ds = synthetic.simulate(synthetic.SyntheticConfig(
            steps=args.steps, num_beams=args.beams, seed=args.seed, drift=tuple(args.drift)),
            device=args.device)
        odom = None
        if args.odom_noise:
            odom = noisy_odometry(ds.robot_poses, args.odom_noise, args.odom_noise / 4,
                                  args.seed + 7)
    logfile.write_jsonl(args.message, dataset_to_messages(ds, odom_poses=odom))
    print(f"wrote {args.message} ({len(ds.ranges)} scans)")
    if args.gt:
        # laser timestamps: the world cloud at 0, then (tf, laser, odom) per step
        tum.write_tum(args.gt, [0.002 + 0.003 * t for t in range(len(ds.ranges))],
                      ds.robot_poses)
        print(f"wrote {args.gt}")


if __name__ == "__main__":
    main()
