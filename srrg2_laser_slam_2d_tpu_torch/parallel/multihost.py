"""Multi-process distribution over ``torch.distributed`` (counterpart of
``srrg2_laser_slam_2d_tpu/parallel/multihost.py``).

N processes, one device each, in one process group: host-sharded storage
(each process holds only ITS block of the edge arrays), the same
``all_reduce`` Gauss-Newton as ``parallel/dist_pgo.py``, and local-map
scenes stored on one process each and broadcast from their owner on
demand. The backend follows the device: ``gloo`` for the CPU, ``nccl`` for
a CUDA card; there is no fallback from one to the other. The rendezvous is
an ``init_method`` URL given by the caller (``file://`` under a temporary
directory, so that concurrent groups never collide on a port).

Worker (one process of an N-process run; ``spawn_ranks`` or a test starts
them):

    python -m srrg2_laser_slam_2d_tpu_torch.parallel.multihost --worker \\
        PID NPROC INIT_METHOD OUT.npz [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import queue
import tempfile
import traceback

import numpy as np
import torch
import torch.distributed as dist

from .._device import resolve_device


def init_multiprocess(process_id: int, num_processes: int, init_method: str,
                      backend: str | None = None, device=None) -> torch.device:
    """Join the process group as rank ``process_id`` of ``num_processes``.
    ``device`` (the CUDA card by default) picks the backend: ``nccl`` for
    CUDA, each rank on card ``process_id`` modulo the visible cards; ``gloo``
    for the CPU. A ``backend`` that disagrees with the device is refused.
    Returns this rank's device."""
    device = resolve_device(device)
    want = "nccl" if device.type == "cuda" else "gloo"
    if backend not in (None, want):
        raise ValueError(f"backend {backend!r} on a {device.type} device; the port uses {want}")
    if device.type == "cuda":
        device = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(device)
    dist.init_process_group(want, init_method=init_method, rank=process_id,
                            world_size=num_processes)
    return device


def global_group():
    """The group of every process."""
    return dist.group.WORLD


def edges_from_host_local(local, device) -> torch.Tensor:
    """This process's LOCAL block of an edge array as a tensor on its
    device. No process ever holds the whole edge set: the collectives of
    ``dist_pgo.optimize_sharded`` combine the blocks."""
    return torch.as_tensor(np.ascontiguousarray(local), device=device)


def replicate(x, device, group=None) -> torch.Tensor:
    """A host value made equal on every process (rank 0's copy wins)."""
    t = torch.as_tensor(np.ascontiguousarray(x), device=device)
    _broadcast(t, 0, group)
    return t


def to_host(x: torch.Tensor) -> np.ndarray:
    """A replicated tensor back on this host."""
    return x.detach().cpu().numpy()


def _broadcast(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """In-place broadcast; bool tensors travel as uint8."""
    if t.dtype == torch.bool:
        u = t.to(torch.uint8)
        dist.broadcast(u, src, group=group)
        t.copy_(u.to(torch.bool))
    else:
        dist.broadcast(t, src, group=group)
    return t


def optimize_pgo_multihost(cfg, poses, var_valid, var_fixed, local_edges, device, group=None):
    """Distributed PGO across processes: each process holds only its block
    of the edges, the variables are replicated, the normal system is summed
    across processes. ``local_edges`` = (ei, ej, meas, info, valid) host
    arrays. Returns (solved poses [V, 3] on the host, chi, iterations)."""
    from ..solver.pgo import PoseGraph
    from . import dist_pgo

    ei, ej, em, einfo, ev = local_edges
    graph = PoseGraph(
        poses=replicate(np.asarray(poses, np.float32), device, group),
        var_valid=replicate(np.asarray(var_valid, bool), device, group),
        var_fixed=replicate(np.asarray(var_fixed, bool), device, group),
        edge_i=edges_from_host_local(np.asarray(ei, np.int64), device),
        edge_j=edges_from_host_local(np.asarray(ej, np.int64), device),
        edge_meas=edges_from_host_local(np.asarray(em, np.float32), device),
        edge_info=edges_from_host_local(np.asarray(einfo, np.float32), device),
        edge_valid=edges_from_host_local(np.asarray(ev, bool), device))
    out, chi, it = dist_pgo.optimize_sharded(cfg, graph, group)
    return to_host(out.poses), float(chi), int(it)


class HostShardedSceneStore:
    """Local-map scenes sharded across processes: map ``m`` lives on process
    ``m % num_processes`` only. ``get`` broadcasts a map's scene from its
    owner to every process when the SLAM layer needs it (loop detection
    against remote maps)."""

    def __init__(self, process_id: int, num_processes: int, device="cpu", group=None):
        self.pid = process_id
        self.n = num_processes
        self.device = torch.device(device)
        self.group = group
        self._scenes: dict[int, tuple] = {}

    def owner(self, map_id: int) -> int:
        return map_id % self.n

    def put(self, map_id: int, scene) -> None:
        if self.owner(map_id) == self.pid:
            self._scenes[map_id] = tuple(np.asarray(x) for x in scene)

    def local_ids(self) -> list[int]:
        return sorted(self._scenes)

    def get(self, map_id: int, template) -> tuple:
        """The scene of ``map_id`` on every process; ``template`` gives the
        shapes and dtypes on the other processes.

        COLLECTIVE: every process calls ``get`` with the same ``map_id`` in
        the same order. One ``dist.broadcast`` from the owner a field:
        O(scene) traffic, one copy of the owner's arrays."""
        is_owner = self.owner(map_id) == self.pid
        src = self._scenes[map_id] if is_owner else template
        out = []
        for x in src:
            t = torch.as_tensor(np.array(x), device=self.device)
            if not is_owner:
                t.zero_()
            out.append(to_host(_broadcast(t, self.owner(map_id), self.group)))
        return tuple(out)


# ---------------------------------------------------------------- launcher

def _rank_main(rank: int, n: int, init_method: str, device, fn, args, results) -> None:
    try:
        dev = init_multiprocess(rank, n, init_method, device=device)
        results.put((rank, "ok", fn(dev, *args)))
    except Exception:  # reported to the parent, which raises
        results.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(n: int, fn, *args, device=None, timeout: float = 600.0) -> list:
    """Run ``fn(rank_device, *args)`` in ``n`` new processes (``spawn``
    start method), ranks 0..n-1 of one process group with a ``file://``
    rendezvous under a temporary directory, each rank on ``device`` (the
    CUDA card by default, so NCCL). ``fn`` must be importable by
    name (a module-level function). Returns the ranks' results in rank
    order; raises with a rank's traceback if one failed."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init_method = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main,
                             args=(r, n, init_method, device, fn, args, results))
                 for r in range(n)]
        for p in procs:
            p.start()
        got = {}
        try:
            # drain the queue before joining: a child blocks until its result is read
            for _ in range(n):
                rank, status, value = results.get(timeout=timeout)
                if status != "ok":
                    raise RuntimeError(f"rank {rank} failed:\n{value}")
                got[rank] = value
        except queue.Empty:
            raise RuntimeError(f"{n - len(got)} of {n} ranks gave no result in {timeout} s")
        finally:
            for p in procs:
                p.join(timeout=60)
                if p.is_alive():
                    p.kill()
                    p.join()
    return [got[r] for r in range(n)]


# ------------------------------------------------------------------ worker

def build_ring(v: int = 16, noise: float = 0.05, seed: int = 0):
    """A noisy ring pose graph: (initial estimate [v, 3], edge_i, edge_j,
    measurements [v, 3], ground truth [v, 3]); v - 1 odometry edges from a
    seeded draw on ``dryrun.ring_truth`` plus an exact closure from the last
    pose to the first."""
    from ..utils import geometry
    from .dryrun import ring_truth

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32))

    rng = np.random.default_rng(seed)
    gt = ring_truth(v).numpy()
    meas, est = [], [gt[0]]
    for k in range(1, v):
        z = geometry.relative(t(gt[k - 1]), t(gt[k])).numpy()
        z = z + rng.normal(scale=noise, size=3).astype(np.float32)
        meas.append(z)
        est.append(geometry.compose(t(est[-1]), t(z)).numpy())
    meas.append(geometry.relative(t(gt[-1]), t(gt[0])).numpy())
    ei = np.concatenate([np.arange(v - 1), [v - 1]]).astype(np.int64)
    ej = np.concatenate([np.arange(1, v), [0]]).astype(np.int64)
    return np.stack(est), ei, ej, np.stack(meas).astype(np.float32), gt


def _padded(x: np.ndarray, n: int) -> np.ndarray:
    """``x`` with zero rows appended to ``n`` rows."""
    return np.concatenate([x, np.zeros((n - len(x),) + x.shape[1:], x.dtype)])


def worker(pid: int, nproc: int, init_method: str, out_path: str, device=None) -> None:
    """One process of an N-process run: the ring graph with only THIS
    process's block of edges, the distributed PGO, then the scene store
    (this process owns every nproc-th map) fetching map 1, remote for every
    process but its owner. Writes its results to ``out_path`` (.npz)."""
    from ..solver import pgo
    from .mesh import pad_to_multiple, rank_slice

    device = init_multiprocess(pid, nproc, init_method, device=device)
    try:
        est, ei, ej, meas, gt = build_ring()
        v, ne = len(est), len(ei)
        # pad the edge set with invalid edges to a multiple of the process
        # count, keep this process's block only
        ec = pad_to_multiple(ne, nproc)
        sl = rank_slice(ec)
        edges = (ei, ej, meas, np.ones((ne, 3), np.float32), np.ones(ne, bool))
        var_fixed = np.zeros(v, bool)
        var_fixed[0] = True
        poses, chi, it = optimize_pgo_multihost(
            pgo.PGOConfig(max_iterations=10), est, np.ones(v, bool), var_fixed,
            tuple(_padded(x, ec)[sl] for x in edges), device)

        store = HostShardedSceneStore(pid, nproc, device)
        for m in range(4):
            store.put(m, (np.full((8, 2), float(m), np.float32), np.ones(8, bool)))
        assert store.local_ids() == [m for m in range(4) if m % nproc == pid]
        remote_id = 1  # owned by process 1: remote for process 0
        fetched = store.get(remote_id, (np.zeros((8, 2), np.float32), np.zeros(8, bool)))
        np.savez(out_path, poses=poses[:v], chi=chi, iters=it, est=est, ei=ei, ej=ej,
                 meas=meas, fetched=fetched[0], fetched_valid=fetched[1], remote_id=remote_id,
                 world_size=dist.get_world_size(), backend=dist.get_backend())
        print(f"worker {pid}: OK chi={chi:.5f} world={dist.get_world_size()}", flush=True)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--worker", nargs=4, metavar=("PID", "NPROC", "INIT_METHOD", "OUT"),
                    required=True)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' uses gloo)")
    args = ap.parse_args(argv)
    pid, nproc, init_method, out = args.worker
    worker(int(pid), int(nproc), init_method, out, args.device)


if __name__ == "__main__":
    main()
