// Z-buffered polar projection of sensor-frame clouds: per beam the closest
// depth and the index of the point that holds it, for a batch of clouds in
// one launch.
//
// Replaces srrg2_laser_slam_2d_tpu/ops/pallas_projector.py:project_local_pallas
// (pallas_call at :131; the JAX package vmaps it over a batch). The TPU kernel
// compares a [chunk, beams] tile per chunk of points and keeps the first
// argmin; here every point goes straight to its beam with ONE 64-bit
// atomicMin on the key (depth bits << 32 | point index): the bits of a
// non-negative float order as integers, so the closest depth wins and, among
// equal depths, the lowest index, which is the reference's tie rule. The
// minimum does not depend on the order of the atomics, so the result is
// bit-equal to the plain version whatever the layout below.
//
// What bounds it: not bytes (9 per point) nor operations (~37 per point), but
// the latency of one chain per point: a global load, the polynomial
// arctangent, an atomic. Design, for that chain:
//   * one launch for the whole batch: cloud j takes blocks
//     [j * cluster, (j + 1) * cluster) of a 1-D grid;
//   * a cloud of more than 1,024 points takes a thread-block cluster of up to
//     8 blocks on 8 SMs (cluster_blocks in ops/projector_kernel.py), so a
//     thread holds one or two points (KPPT a round; longer clouds take more
//     rounds); a cloud of at most 1,024 points takes one block, no cluster;
//   * every thread issues its loads before any atomic;
//   * each block takes the minimum into its OWN shared keys (8 KB for
//     B <= 1,024 beams; zb_key_min in frame_common.cuh: a 64-bit atomicMin
//     through distributed shared memory is not atomic on the card);
//   * then every block sends its keys to each beam's owner (block
//     b % cluster) by stores through distributed shared memory, once every
//     block of the cluster has started (a relaxed cluster arrive at entry,
//     its wait before the stores), ONE cluster barrier, and each owner takes
//     its beams' minimum from its own shared memory and writes them as the
//     callers take them (cols-long depth with 3.0e38 where empty, int64
//     index with -1, bool valid): no PyTorch op follows, and no block reads
//     another's shared memory.
// Beam assignment uses the kernels' polynomial arctangent, not atan2f: a
// point on a beam-bin edge would move otherwise.

#include "frame_common.cuh"

namespace cg = cooperative_groups;

// Mirror of ops/projector_kernel.py:_ProjectorParams. The first seven fields
// are those of the one-cloud kernel that came before (bench/compare_csrc.py
// still drives such sources); clouds and cluster came with the batch.
struct ProjectorParams {
  int n, B, cols;
  float f, c, range_min, range_max;
  int clouds, cluster;
};

constexpr int kThreads = 1024;
constexpr int KPPT = 2;                      // points a thread holds a round
constexpr float kEmptyDepth = 3.0e38f;       // ops/projector.py:Canvas

// Key of point i (kZbEmptyKey and column -1 when it misses the canvas).
__device__ __forceinline__ unsigned long long point_key(const float* __restrict__ xy,
                                                        const unsigned char* __restrict__ valid,
                                                        int i, const ProjectorParams& p,
                                                        int* col) {
  *col = -1;
  if (i >= p.n) return kZbEmptyKey;
  const float x = xy[2 * i], y = xy[2 * i + 1];
  const bool v = valid[i];
  const float d = sqrtf(x * x + y * y);
  const float colf = floorf(atan2_poly(y, x) * p.f + p.c);
  const bool ok = v && (colf >= 0.0f) && (colf < (float)p.cols) && (d >= p.range_min) &&
                  (d <= p.range_max);
  if (!ok) return kZbEmptyKey;
  *col = (int)colf;
  return ((unsigned long long)__float_as_uint(d) << 32) | (unsigned int)i;
}

template <bool kCluster>
__global__ void __launch_bounds__(kThreads, 1)
project_local_kernel(const float* __restrict__ xy, const unsigned char* __restrict__ valid,
                     float* __restrict__ depth, long long* __restrict__ idx,
                     bool* __restrict__ has, ProjectorParams p) {
  __shared__ unsigned long long s_key[1024];            // this block's minimum per beam
  __shared__ unsigned long long s_stage[kZbStage];      // the blocks' keys of my beams
  PHASE_BEGIN;
  int rank = 0;
  if constexpr (kCluster) {
    zb_cluster_arrive();
    rank = (int)cg::this_cluster().block_rank();
  }
  const int cloud = blockIdx.x / p.cluster;
  xy += (size_t)cloud * p.n * 2;
  valid += (size_t)cloud * p.n;
  for (int b = threadIdx.x; b < p.cols; b += kThreads) s_key[b] = kZbEmptyKey;
  __syncthreads();
  PHASE(0);

  const int stride = p.cluster * kThreads;
  const int t = rank * kThreads + threadIdx.x;
  const int step = KPPT * stride;
  for (int base = 0; base == 0 || base < p.n; base += step) {
    unsigned long long key[KPPT];
    int col[KPPT];
#pragma unroll
    for (int s = 0; s < KPPT; ++s)
      key[s] = point_key(xy, valid, base + s * stride + t, p, &col[s]);
    PHASE(1);
#pragma unroll
    for (int s = 0; s < KPPT; ++s) zb_key_min(s_key, col[s], key[s]);
    PHASE(2);
  }
  __syncthreads();
  if constexpr (kCluster) {
    zb_cluster_wait();
    zb_push_keys(s_key, s_stage, p.cols, p.cluster, rank);
    cg::this_cluster().sync();
  }
  PHASE(3);
  // block `rank` owns beams rank, rank + cluster, ...: their minimum over
  // the blocks' keys, written as the callers take it
  const size_t o = (size_t)cloud * p.cols;
  for (int j = threadIdx.x, b = rank + p.cluster * j; b < p.cols;
       j += kThreads, b = rank + p.cluster * j) {
    const unsigned long long k = kCluster ? zb_owned_min(s_stage, j, p.cols, p.cluster)
                                          : s_key[b];
    const bool hit = k != kZbEmptyKey;
    depth[o + b] = hit ? __uint_as_float((unsigned int)(k >> 32)) : kEmptyDepth;
    idx[o + b] = hit ? (long long)(k & 0xffffffffull) : -1ll;
    has[o + b] = hit;
  }
  PHASE(4);
  PHASE_END;
}

PHASE_EXPORT

extern "C" int project_local(const float* xy, const unsigned char* valid, float* depth,
                             long long* idx, bool* has, const ProjectorParams* params,
                             void* stream) {
  const ProjectorParams p = *params;
  if (p.B > 1024 || p.n < 0 || p.clouds < 1 || p.cluster < 1 || p.cluster > kZbMaxCluster ||
      (p.cluster > 1 && p.n <= kThreads))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (p.cluster == 1) {
    project_local_kernel<false><<<p.clouds, kThreads, 0, st>>>(xy, valid, depth, idx, has, p);
    return (int)cudaGetLastError();
  }
  return (int)zb_launch_clusters(project_local_kernel<true>, p.clouds * p.cluster, kThreads,
                                 p.cluster, st, xy, valid, depth, idx, has, p);
}
