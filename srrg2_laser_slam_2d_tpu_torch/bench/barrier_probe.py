"""What a barrier costs on the card: a block barrier (``__syncthreads``)
against a thread-block-cluster barrier (``cluster.sync()``, two blocks on
two SMs), and the exchange a frame kernel split over a cluster would need
for each reduction (every warp writes 13 partial sums into both blocks'
shared memory, one cluster barrier, every warp adds all partials).

    python -m srrg2_laser_slam_2d_tpu_torch.bench.barrier_probe [--out FILE]

It decides whether a stream's beams could be spread over a cluster of SMs:
the frame kernels meet at 14 barriers a frame, so a cluster barrier that
costs more than the half of a Gauss-Newton pass it saves rules that out.
Prints SM cycles per barrier (thread 0 of block 0, ``clock64``, mean of
10,000) for 192, 256 and 384 threads a block, with 2 blocks and with 64.
"""

from __future__ import annotations

import argparse
import ctypes
import json
from pathlib import Path

import torch

from .._device import card_description, resolve_device
from ..ops import _cuda

SOURCE = r"""
#include <cooperative_groups.h>
namespace cg = cooperative_groups;

__global__ void __cluster_dims__(2, 1, 1) probe_kernel(long long* out, int iters) {
  cg::cluster_group cl = cg::this_cluster();
  __shared__ float part[2][32][16];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, rank = cl.block_rank();
  const int nw = blockDim.x >> 5;
  float acc = threadIdx.x;
  long long t0 = clock64();
  for (int i = 0; i < iters; ++i) cl.sync();
  long long t1 = clock64();
  for (int i = 0; i < iters; ++i) {
    if (lane < 13) {
      float* remote = cl.map_shared_rank(&part[i & 1][0][0], rank ^ 1);
      part[i & 1][rank * nw + warp][lane] = acc;
      remote[(rank * nw + warp) * 16 + lane] = acc;
    }
    cl.sync();
    float s = 0.f;
    if ((lane & 15) < 13)
      for (int w = lane >> 4; w < 2 * nw; w += 2) s += part[i & 1][w][lane & 15];
    acc = acc * 0.5f + s * 1e-6f;
  }
  long long t2 = clock64();
  for (int i = 0; i < iters; ++i) __syncthreads();
  long long t3 = clock64();
  if (threadIdx.x == 0 && blockIdx.x == 0) {
    out[0] = (t1 - t0) / iters;
    out[1] = (t2 - t1) / iters;
    out[2] = (t3 - t2) / iters;
    out[3] = (long long)acc;   // keeps the exchange
  }
}

extern "C" int barrier_probe(long long* out, int blocks, int threads, int iters) {
  probe_kernel<<<blocks, threads>>>(out, iters);
  return (int)cudaGetLastError();
}
"""


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    device = resolve_device(None)
    src = _cuda.BUILD_DIR / "probe" / "barrier_probe.cu"
    lib_path = src.with_suffix(".so")
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(SOURCE)
    _cuda.compile_all([("barrier_probe", src, lib_path, ())])
    lib = ctypes.CDLL(str(lib_path))
    lib.barrier_probe.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.barrier_probe.restype = ctypes.c_int
    out = torch.zeros(4, dtype=torch.int64, device=device)
    rows = []
    for threads in (192, 256, 384):
        for blocks in (2, 64):
            err = lib.barrier_probe(out.data_ptr(), blocks, threads, 10000)
            torch.cuda.synchronize()
            if err != 0:
                raise RuntimeError(f"probe launch failed: {_cuda.error_string(err)}")
            c = out.cpu().tolist()
            rows.append({"threads": threads, "blocks": blocks, "cluster_sync_cycles": c[0],
                         "exchange_and_cluster_sync_cycles": c[1],
                         "syncthreads_cycles": c[2]})
            print(json.dumps(rows[-1]), flush=True)
    result = {"card": card_description(device), "rows": rows}
    print(json.dumps(result))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
