"""Checkpoint and resume of the per-message loop: the pose graph, the scene
of every local map, the tracker's state and the trajectory. Counterpart of
``srrg2_laser_slam_2d_tpu/utils/checkpoint.py``, in the same format, so
that each package reads the other's files: one ``.npz`` of host arrays and
a ``.meta.json`` sidecar of scalars.

The graph is written in the JAX package's layout: ``graph.*`` at the
configuration's static capacities (doubled as the JAX package grows them),
int32 edge ends, float32 poses, bool flags. ``load`` rebuilds the port's
host lists from ``var_valid``, ``edge_valid`` and ``n_edges``. As in the
JAX package, the file leaves out the validator's pending closures and the
``LaserTracker``'s clip cache (the first frame after a resume clips from
the scene), and ``save`` folds the ``FastTracker``'s pending payloads into
its scene first.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from .cloud import Cloud


def _base(path: str) -> str:
    return path[:-4] if path.endswith(".npz") else path


def exists(path: str) -> bool:
    """Whether a checkpoint was saved at ``path`` (with or without .npz)."""
    return os.path.exists(_base(path) + ".npz")


def _capacity(configured: int, n: int) -> int:
    """The JAX package's capacity after its doublings for ``n`` entries."""
    cap = configured
    while cap < n:
        cap *= 2
    return cap


def _graph_arrays(slam) -> dict[str, np.ndarray]:
    """The pose graph as the JAX package's ``PoseGraph`` fields."""
    nv, ne = slam.n_maps, slam.n_edges
    vc = _capacity(slam.cfg.var_capacity, nv)
    ec = _capacity(slam.cfg.edge_capacity, ne)
    poses = np.zeros((vc, 3), np.float32)
    poses[:nv] = slam._poses_host
    var_fixed = np.zeros(vc, bool)
    var_fixed[:nv] = slam._fixed_host
    ei, ej = np.zeros(ec, np.int32), np.zeros(ec, np.int32)
    meas = np.zeros((ec, 3), np.float32)
    info = np.ones((ec, 3), np.float32)
    for k, (i, j, m, w) in enumerate(slam._edges_host):
        ei[k], ej[k], meas[k], info[k] = i, j, m, w
    return {"poses": poses, "var_valid": np.arange(vc) < nv, "var_fixed": var_fixed,
            "edge_i": ei, "edge_j": ej, "edge_meas": meas, "edge_info": info,
            "edge_valid": np.arange(ec) < ne}


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def _put_cloud(arrays: dict, key: str, cloud: Cloud) -> None:
    arrays[f"{key}.xy"] = _np(cloud.xy)
    arrays[f"{key}.normal"] = _np(cloud.normal)
    arrays[f"{key}.valid"] = _np(cloud.valid)


def _get_cloud(data, key: str, device) -> Cloud:
    return Cloud(*(torch.from_numpy(np.asarray(data[f"{key}.{f}"])).to(device)
                   for f in ("xy", "normal", "valid")))


def save(path: str, slam, trajectory=None) -> None:
    """Write a ``models.slam.GraphSLAM2D`` to ``path`` (.npz) and its
    ``.meta.json``; ``trajectory`` is the runner's (timestamp, pose, ...)
    list."""
    arrays = {f"graph.{k}": v for k, v in _graph_arrays(slam).items()}
    for m, scene in enumerate(slam.scenes):
        if scene is not None:
            _put_cloud(arrays, f"scene.{m}", scene)
    meta = {"n_maps": slam.n_maps, "n_edges": slam.n_edges,
            "current_map": slam.current_map, "num_closures": slam.num_closures,
            "relocalizations": slam.relocalizations,
            "adjacency": [sorted(s) for s in slam.adjacency]}
    tracker = slam.tracker
    if hasattr(tracker, "spec"):
        # the fast tracker: pending payloads fold into the scene; the cache
        # and the pose block carry everything else
        meta["tracker.kind"] = "fast"
        tracker.flush()
        fs = tracker.state
        meta["tracker.seeded"] = fs is not None
        if fs is not None:
            _put_cloud(arrays, "tracker.scene", fs.scene)
            arrays["fast.cacheT"] = _np(fs.cacheT)
            arrays["fast.pose"] = _np(fs.pose)
    else:
        meta["tracker.kind"] = "xla"
        ts = tracker.state
        _put_cloud(arrays, "tracker.scene", ts.scene)
        arrays["tracker.robot_in_local_map"] = _np(ts.robot_in_local_map)
        arrays["tracker.last_odom"] = _np(ts.last_odom)
        arrays["tracker.sensor_in_robot"] = _np(ts.sensor_in_robot)
        meta["tracker.has_odom"] = bool(ts.has_odom)
        meta["tracker.seeded"] = tracker._seeded
    if trajectory:
        arrays["trajectory.t"] = np.asarray([t for t, _, _ in trajectory])
        arrays["trajectory.pose"] = np.stack([np.asarray(p) for _, p, _ in trajectory])
    base = _base(path)
    np.savez_compressed(base + ".npz", **arrays)
    with open(base + ".meta.json", "w") as f:
        json.dump(meta, f)


def load(path: str, slam) -> None:
    """Restore what ``save`` wrote (in either package) into a freshly made
    ``GraphSLAM2D`` of the same configuration."""
    base = _base(path)
    data = np.load(base + ".npz")
    with open(base + ".meta.json") as f:
        meta = json.load(f)
    dev = slam.device
    valid = np.asarray(data["graph.var_valid"], bool)
    nv = int(valid.sum())
    slam._poses_host = np.asarray(data["graph.poses"], np.float32)[valid].copy()
    slam._fixed_host = [bool(x) for x in np.asarray(data["graph.var_fixed"])[valid]]
    live = np.flatnonzero(np.asarray(data["graph.edge_valid"], bool))[: meta["n_edges"]]
    ei, ej = data["graph.edge_i"], data["graph.edge_j"]
    meas, info = data["graph.edge_meas"], data["graph.edge_info"]
    slam._edges_host = [(int(ei[k]), int(ej[k]), np.asarray(meas[k], np.float32),
                         np.asarray(info[k], np.float32)) for k in live]
    slam.n_maps = meta["n_maps"]
    slam.n_edges = meta["n_edges"]
    if nv != slam.n_maps or len(slam._edges_host) != slam.n_edges:
        raise ValueError(f"{path}: the graph's flags disagree with its counts")
    slam.current_map = meta["current_map"]
    slam.num_closures = meta["num_closures"]
    slam.relocalizations = meta["relocalizations"]
    slam.adjacency = [set(s) for s in meta["adjacency"]]
    slam.scenes = [_get_cloud(data, f"scene.{m}", dev) if f"scene.{m}.xy" in data else None
                   for m in range(slam.n_maps)]
    tracker = slam.tracker
    if meta.get("tracker.kind", "xla") == "fast":
        from ..models.fast_tracker import FastState

        tracker._pending = []
        tracker.state = None
        if meta["tracker.seeded"]:
            tracker.state = FastState(
                cacheT=torch.from_numpy(data["fast.cacheT"]).to(dev),
                pose=torch.from_numpy(data["fast.pose"]).to(dev),
                scene=_get_cloud(data, "tracker.scene", dev))
        return
    tracker.state = tracker.state._replace(
        scene=_get_cloud(data, "tracker.scene", dev),
        robot_in_local_map=torch.from_numpy(data["tracker.robot_in_local_map"]).to(dev),
        last_odom=torch.from_numpy(data["tracker.last_odom"]).to(dev),
        sensor_in_robot=torch.from_numpy(data["tracker.sensor_in_robot"]).to(dev),
        has_odom=torch.tensor(bool(meta["tracker.has_odom"]), device=dev))
    tracker._seeded = meta["tracker.seeded"]


def trajectory_from(path: str) -> list:
    """The (timestamp, pose) list a checkpoint holds ([] if none)."""
    data = np.load(_base(path) + ".npz")
    if "trajectory.t" not in data:
        return []
    return list(zip(data["trajectory.t"], data["trajectory.pose"]))
