"""Which atomics on distributed shared memory give exact results on the
card: every thread of a cluster of 8 blocks of 1,024 threads applies one
operation to one of 768 slots in the LEADER block's shared memory (the
layout of kernels 7 and 8), then the leader's slots are read back and held
against numpy.

    python -m srrg2_laser_slam_2d_tpu_torch.bench.dsmem_probe [--out FILE]

Operations, each through the pointer of ``cluster.map_shared_rank``:
``atomicMin`` on 64-bit keys (depth bits << 32 | row), a 64-bit min built
from ``atomicCAS``, ``atomicMin`` and ``atomicAdd`` on 32-bit words and
``atomicAdd`` on floats (small integers, so any order sums exactly); and
64-bit ``atomicMin`` into each block's OWN shared memory followed by a
cross-block min of the 8 blocks' slots read through DSMEM. Prints one line
per operation: slots that differ from numpy (0 = exact).
"""

from __future__ import annotations

import argparse
import ctypes
import json
from pathlib import Path

import numpy as np
import torch

from .._device import card_description, resolve_device
from ..ops import _cuda

SOURCE = r"""
#include <cooperative_groups.h>
namespace cg = cooperative_groups;

constexpr int kSlots = 768;

__device__ __forceinline__ unsigned long long value_of(int g) {
  // a pseudo-random 32-bit depth word and the thread's global index
  unsigned h = (unsigned)g * 2654435761u;
  h ^= h >> 13;
  return ((unsigned long long)(h & 0x7fffffffu) << 32) | (unsigned)g;
}

__global__ void __cluster_dims__(8, 1, 1) probe_kernel(int op, unsigned long long* out) {
  cg::cluster_group cl = cg::this_cluster();
  __shared__ unsigned long long s64[kSlots];
  __shared__ unsigned int s32[kSlots];
  __shared__ float sf[kSlots];
  const int rank = cl.block_rank();
  const int g = rank * blockDim.x + threadIdx.x;
  const int slot = (g * 7) % kSlots;
  for (int b = threadIdx.x; b < kSlots; b += blockDim.x) {
    s64[b] = ~0ull;
    s32[b] = op == 3 ? 0xffffffffu : 0u;
    sf[b] = 0.0f;
  }
  cl.sync();
  unsigned long long* r64 = cl.map_shared_rank(s64, 0);
  unsigned int* r32 = cl.map_shared_rank(s32, 0);
  float* rf = cl.map_shared_rank(sf, 0);
  const unsigned long long v = value_of(g);
  if (op == 0) {
    atomicMin(&r64[slot], v);
  } else if (op == 1) {
    unsigned long long old = r64[slot];
    while (v < old) {
      const unsigned long long prev = atomicCAS(&r64[slot], old, v);
      if (prev == old) break;
      old = prev;
    }
  } else if (op == 2) {
    atomicAdd(&r32[slot], 1u);
  } else if (op == 3) {
    atomicMin(&r32[slot], (unsigned)(v >> 32));
  } else if (op == 4) {
    atomicAdd(&rf[slot], (float)(g & 7));
  } else if (op == 5) {
    atomicMin(&s64[slot], v);   // this block's own slots
  }
  cl.sync();
  if (op == 5) {
    // cross-block min through DSMEM reads, by the leader
    if (rank == 0)
      for (int b = threadIdx.x; b < kSlots; b += blockDim.x) {
        unsigned long long m = ~0ull;
        for (int r = 0; r < 8; ++r) {
          const unsigned long long k = cl.map_shared_rank(s64, r)[b];
          m = k < m ? k : m;
        }
        out[b] = m;
      }
    cl.sync();   // the other blocks keep their slots until the leader has read them
    return;
  }
  if (rank == 0)
    for (int b = threadIdx.x; b < kSlots; b += blockDim.x)
      out[b] = op <= 1 ? s64[b] : op <= 3 ? (unsigned long long)s32[b]
                                          : (unsigned long long)__float_as_uint(sf[b]);
}

extern "C" int dsmem_probe(int op, unsigned long long* out) {
  probe_kernel<<<8, 1024>>>(op, out);
  return (int)cudaGetLastError();
}
"""

OPS = ("u64 atomicMin", "u64 min by atomicCAS", "u32 atomicAdd", "u32 atomicMin",
       "f32 atomicAdd", "u64 atomicMin local + DSMEM reads")


def expected(op: int) -> np.ndarray:
    g = np.arange(8 * 1024, dtype=np.uint64)
    h = (g * np.uint64(2654435761)) & np.uint64(0xFFFFFFFF)
    h ^= h >> np.uint64(13)
    v = ((h & np.uint64(0x7FFFFFFF)) << np.uint64(32)) | g
    slot = (g * np.uint64(7)) % np.uint64(768)
    out = np.full(768, np.iinfo(np.uint64).max, np.uint64)
    if op in (0, 1, 5):
        np.minimum.at(out, slot, v)
    elif op == 2:
        out = np.bincount(slot.astype(np.int64), minlength=768).astype(np.uint64)
    elif op == 3:
        out = np.full(768, 0xFFFFFFFF, np.uint64)
        np.minimum.at(out, slot, v >> np.uint64(32))
    else:
        f = np.zeros(768, np.float32)
        np.add.at(f, slot.astype(np.int64), (g & np.uint64(7)).astype(np.float32))
        out = f.view(np.uint32).astype(np.uint64)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    device = resolve_device(None)
    src = _cuda.BUILD_DIR / "probe" / "dsmem_probe.cu"
    lib_path = src.with_suffix(".so")
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(SOURCE)
    _cuda.compile_all([("dsmem_probe", src, lib_path, ())])
    lib = ctypes.CDLL(str(lib_path))
    lib.dsmem_probe.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.dsmem_probe.restype = ctypes.c_int
    out = torch.zeros(768, dtype=torch.int64, device=device)
    rows = []
    for op, name in enumerate(OPS):
        wrong = []
        for _ in range(20):
            err = lib.dsmem_probe(op, out.data_ptr())
            torch.cuda.synchronize()
            if err != 0:
                raise RuntimeError(f"probe launch failed: {_cuda.error_string(err)}")
            got = out.cpu().numpy().view(np.uint64)
            wrong.append(int((got != expected(op)).sum()))
        rows.append({"op": name, "slots_wrong_per_run": wrong})
        print(json.dumps(rows[-1]), flush=True)
    result = {"card": card_description(device), "rows": rows}
    print(json.dumps(result))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
