// Z-buffer canvas of a whole scene seen from a camera pose: per beam the
// closest depth, the winner's point and normal in the camera frame, and the
// winner's row in the scene.
//
// Replaces srrg2_laser_slam_2d_tpu/ops/pallas_scene.py:canvas_pallas
// (pallas_call at :159, body _chunked_zbuffer at :69), the kernel behind
// clip_projective_pallas and merge_projective_pallas.
//
// The TPU kernel walks the scene in chunks of `chunk` rows and carries the
// per-beam winner: inside a chunk the points tied at the minimum depth are
// averaged (a normalised one-hot product) and the winner row is the lowest
// index; a later chunk takes a beam only with a strictly smaller depth. So
// over the whole scene the winner ROW is the lowest index among the points
// at the beam's minimum depth, and the winner FIELDS are the mean over the
// points at that depth that share the winner row's chunk. Here:
//   pass 1  one 64-bit atomicMin per row on (depth bits << 32 | row):
//           minimum depth and, among equals, the lowest row;
//   pass 2  rows at the minimum depth in the winner's chunk add one to the
//           beam's count and their fields to its sums;
//   then    each beam's fields are its sums times 1 / count (exact for one
//           or two tied points, as the reference's mean: a sum of two and a
//           halving round once; three or more bitwise-equal depths on one
//           beam add in no fixed order and may differ in the last bit).
//
// What bounds it: not bytes (17 per row) nor operations (~60 per row) but
// the latency of each row's chain (loads, camera transform, arctangent,
// atomics) and of the passes' barriers. Design, for that chain:
//   * a scene of more than 1,024 rows takes a thread-block cluster of up to 8
//     blocks on 8 SMs (cluster_blocks in ops/projector_kernel.py), so a
//     thread holds one or two rows; a scene of at most 1,024 rows takes one
//     block, no cluster;
//   * each thread computes its rows' camera-frame point, normal, depth and
//     column ONCE and keeps them in registers over both passes (past KPPT
//     rows a thread, i.e. more than 16,384 rows, the later rounds are
//     computed again in pass 2, with the same arithmetic and bits);
//   * pass 1 takes the minimum into each block's OWN shared keys (zb_key_min
//     in frame_common.cuh: a 64-bit atomicMin through distributed shared
//     memory is not atomic on the card);
//   * beam b is owned by block b % cluster: every block sends its keys to
//     the owners by stores through distributed shared memory, once every
//     block of the cluster has started (a relaxed cluster arrive at entry,
//     its wait before the stores), a cluster barrier, and each owner takes
//     its beams' minimum from its own shared memory and writes their depth,
//     row and has-point (and zero fields);
//   * after a second barrier only a row at its own block's minimum depth
//     can be tied: it reads its beam's minimum from the owner (one load
//     through distributed shared memory) and, if tied, adds one to the
//     owner's count (a 32-bit atomicAdd through distributed shared memory is
//     exact) and its fields straight into the output (global float
//     atomicAdd, zeroed by the owner);
//   * after a third barrier each owner divides the fields of its beams with
//     two or more tied rows by the count (one tied row: the sum is the
//     field); no block reads another's shared memory after it.
// The cosine and sine of the camera angle are computed once per thread, as
// the plain version computes them once per call.

#include "frame_common.cuh"

namespace cg = cooperative_groups;

// Mirror of ops/scene_kernel.py:_SceneParams. The first eight fields are
// those of the single-block kernel that came before (bench/compare_csrc.py
// still drives such sources); cluster came with the cluster.
struct SceneParams {
  int n, B, cols, chunk;
  float f, c, range_min, range_max;
  int cluster;
};

constexpr int kThreads = 1024;
constexpr int KPPT = 2;                      // rows a thread keeps in registers

struct CamPoint {
  float x, y, nx, ny, d;
  int col;   // -1: not on the canvas (or past the scene)
};

__device__ __forceinline__ CamPoint cam_point(const float* xy, const float* nm,
                                              const unsigned char* valid, int i, float cx,
                                              float cy, float cc, float cs,
                                              const SceneParams& p) {
  CamPoint r;
  r.col = -1;
  r.x = r.y = r.nx = r.ny = r.d = 0.0f;
  if (i >= p.n) return r;
  const float wx = xy[2 * i] - cx, wy = xy[2 * i + 1] - cy;
  const float mx = nm[2 * i], my = nm[2 * i + 1];
  const bool v = valid[i];
  r.x = cc * wx + cs * wy;
  r.y = -cs * wx + cc * wy;
  r.nx = cc * mx + cs * my;
  r.ny = -cs * mx + cc * my;
  r.d = sqrtf(r.x * r.x + r.y * r.y);
  const float colf = floorf(atan2_poly(r.y, r.x) * p.f + p.c);
  const bool ok = v && (colf >= 0.0f) && (colf < (float)p.cols) && (r.d >= p.range_min) &&
                  (r.d <= p.range_max);
  r.col = ok ? (int)colf : -1;
  return r;
}

__device__ __forceinline__ unsigned long long key_of(const CamPoint& q, int i) {
  return ((unsigned long long)__float_as_uint(q.d) << 32) | (unsigned int)i;
}

// pass 2: whether row i is tied at its beam's minimum inside the winner's
// chunk. Only a row at its own block's minimum depth (keys) can be: it
// alone reads the beam's minimum over the cluster (fin, kept by the owner).
template <bool kCluster>
__device__ __forceinline__ bool tied(const unsigned long long* keys, unsigned long long* fin,
                                     const CamPoint& q, int i, const SceneParams& p) {
  if (q.col < 0 || (unsigned int)(keys[q.col] >> 32) != __float_as_uint(q.d)) return false;
  unsigned long long key = keys[q.col];
  if constexpr (kCluster)
    key = cg::this_cluster().map_shared_rank(fin, q.col % p.cluster)[q.col];
  const int win = (int)(key & 0xffffffffull);
  return q.d <= __uint_as_float((unsigned int)(key >> 32)) && i / p.chunk == win / p.chunk;
}

// pass 2: a tied row adds one to the owner's count of its beam (this
// block's when there is no cluster) and its fields to the output
template <bool kCluster>
__device__ __forceinline__ void add_tied(unsigned int* cnt, float* out, int B,
                                         const CamPoint& q, int cluster) {
  if constexpr (kCluster) cnt = cg::this_cluster().map_shared_rank(cnt, q.col % cluster);
  atomicAdd(cnt + q.col, 1u);
  atomicAdd(out + B + q.col, q.x);
  atomicAdd(out + 2 * B + q.col, q.y);
  atomicAdd(out + 3 * B + q.col, q.nx);
  atomicAdd(out + 4 * B + q.col, q.ny);
}

template <bool kCluster>
__global__ void __launch_bounds__(kThreads, 1)
scene_canvas_kernel(const float* __restrict__ xy, const float* __restrict__ nm,
                    const unsigned char* __restrict__ valid, const float* __restrict__ cam,
                    float* __restrict__ out, long long* __restrict__ rows, SceneParams p) {
  __shared__ unsigned long long s_key[1024];         // this block's minimum per beam
  __shared__ unsigned long long s_stage[kZbStage];   // the blocks' keys of my beams
  __shared__ unsigned long long s_fin[1024];         // the cluster's minimum of my beams
  __shared__ unsigned int s_cnt[1024];               // tied rows of my beams
  PHASE_BEGIN;
  const int B = p.B;
  int rank = 0;
  if constexpr (kCluster) {
    zb_cluster_arrive();
    rank = (int)cg::this_cluster().block_rank();
  }
  for (int b = threadIdx.x; b < B; b += kThreads) {
    s_key[b] = kZbEmptyKey;
    s_cnt[b] = 0u;
  }
  const float cx = cam[0], cy = cam[1];
  const float cc = cosf(cam[2]), cs = sinf(cam[2]);
  __syncthreads();
  PHASE(0);

  const int stride = p.cluster * kThreads;
  const int t = rank * kThreads + threadIdx.x;
  const int step = KPPT * stride;
  // the rows of the first round, computed once and kept over both passes
  CamPoint q0[KPPT];
#pragma unroll
  for (int s = 0; s < KPPT; ++s)
    q0[s] = cam_point(xy, nm, valid, s * stride + t, cx, cy, cc, cs, p);
  // the rows of the later rounds (more than KPPT rows a thread), computed
  // again in pass 2
  auto later_rounds = [&](auto&& fn) {
    for (int base = step; base < p.n; base += step) {
#pragma unroll
      for (int s = 0; s < KPPT; ++s) {
        const int i = base + s * stride + t;
        fn(cam_point(xy, nm, valid, i, cx, cy, cc, cs, p), i);
      }
    }
  };
  PHASE(1);
#pragma unroll
  for (int s = 0; s < KPPT; ++s) zb_key_min(s_key, q0[s].col, key_of(q0[s], s * stride + t));
  later_rounds([&](const CamPoint& q, int i) { zb_key_min(s_key, q.col, key_of(q, i)); });
  PHASE(2);
  __syncthreads();
  if constexpr (kCluster) {
    zb_cluster_wait();
    zb_push_keys(s_key, s_stage, B, p.cluster, rank);
    cg::this_cluster().sync();
  }
  PHASE(3);
  // block `rank` owns beams rank, rank + cluster, ...: their key over the
  // cluster is final, so are their depth, row and has-point
  for (int j = threadIdx.x, b = rank + p.cluster * j; b < B;
       j += kThreads, b = rank + p.cluster * j) {
    const unsigned long long key = kCluster ? zb_owned_min(s_stage, j, B, p.cluster) : s_key[b];
    s_fin[b] = key;
    const bool has = key != kZbEmptyKey;
    out[b] = has ? __uint_as_float((unsigned int)(key >> 32)) : kBig;
#pragma unroll
    for (int k = 1; k <= 4; ++k) out[k * B + b] = 0.0f;
    out[5 * B + b] = has ? 1.0f : 0.0f;
    rows[b] = has ? (long long)(key & 0xffffffffull) : -1ll;
  }
  PHASE(4);
  if constexpr (kCluster) cg::this_cluster().sync(); else __syncthreads();
  PHASE(5);
#pragma unroll
  for (int s = 0; s < KPPT; ++s)
    if (tied<kCluster>(s_key, s_fin, q0[s], s * stride + t, p))
      add_tied<kCluster>(s_cnt, out, B, q0[s], p.cluster);
  later_rounds([&](const CamPoint& q, int i) {
    if (tied<kCluster>(s_key, s_fin, q, i, p)) add_tied<kCluster>(s_cnt, out, B, q, p.cluster);
  });
  PHASE(6);
  if constexpr (kCluster) cg::this_cluster().sync(); else __syncthreads();
  // the owners' fields: the mean of two or more tied rows
  for (int j = threadIdx.x, b = rank + p.cluster * j; b < B;
       j += kThreads, b = rank + p.cluster * j) {
    const unsigned int c = s_cnt[b];
    if (c < 2u) continue;
    const float inv = 1.0f / (float)c;
#pragma unroll
    for (int k = 1; k <= 4; ++k) out[k * B + b] = out[k * B + b] * inv;
  }
  PHASE(7);
  PHASE_END;
}

PHASE_EXPORT

extern "C" int scene_canvas(const float* xy, const float* nm, const unsigned char* valid,
                            const float* cam, float* out, long long* rows,
                            const SceneParams* params, void* stream) {
  const SceneParams p = *params;
  if (p.B > 1024 || p.chunk <= 0 || p.n < 0 || p.cluster < 1 || p.cluster > kZbMaxCluster ||
      (p.cluster > 1 && p.n <= kThreads))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (p.cluster == 1) {
    scene_canvas_kernel<false><<<1, kThreads, 0, st>>>(xy, nm, valid, cam, out, rows, p);
    return (int)cudaGetLastError();
  }
  return (int)zb_launch_clusters(scene_canvas_kernel<true>, p.cluster, kThreads, p.cluster, st,
                                 xy, nm, valid, cam, out, rows, p);
}
