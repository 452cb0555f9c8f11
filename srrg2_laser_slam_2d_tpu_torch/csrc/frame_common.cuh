// Device functions shared by the beam-space kernels: the fused
// tracking-frame kernels frame_kernel.cu (one stream, with the local-map
// split) and stream_kernel.cu (K independent streams, gather backends and
// correspondence refresh), which share the whole frame step (frame_loop),
// and the aligners banded_align_kernel.cu, projective_align_kernel.cu
// (which share the compute-once z-buffer zb_* and the end of a pass,
// aligner_update, at the end of this file) and multicue_align_kernel.cu.
// The arithmetic
// follows the Pallas bodies (ops/pallas_frame.py:_frame_body,
// ops/pallas_stream.py:_frame_body_b, ops/pallas_banded_align.py,
// ops/pallas_projective_align.py) operation by operation; every source is
// built with --fmad=false.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#define F32(x) ((float)(x))

// Phase timing, compiled only with -DFRAME_PHASE_TIMING (bench/frame_phases.py
// builds that variant; the default build carries none of it). Thread 0 of
// block 0 stamps clock64() at the phase boundaries of the frame step and adds
// each phase's cycles up over the launch. With -DFRAME_COUNT_BARRIERS as well,
// FRAME_SYNC() also counts the block's barriers (a separate, untimed build).
#define FRAME_PHASES 8
#ifdef FRAME_PHASE_TIMING
__device__ unsigned long long g_phase_cycles[FRAME_PHASES + 1];
#define PHASE_BEGIN long long ph_last_ = clock64(); long long ph_acc_[FRAME_PHASES] = {};
#define PHASE(i) do { if (threadIdx.x == 0 && blockIdx.x == 0) { \
    const long long ph_now_ = clock64(); \
    ph_acc_[i] += ph_now_ - ph_last_; ph_last_ = ph_now_; } } while (0)
#define PHASE_END do { if (threadIdx.x == 0 && blockIdx.x == 0) \
    for (int i_ = 0; i_ < FRAME_PHASES; ++i_) g_phase_cycles[i_] = ph_acc_[i_]; } while (0)
// cycles of each phase over the last launch, then the barriers counted
#define PHASE_EXPORT \
  extern "C" int frame_phase_cycles(unsigned long long* out) { \
    return (int)cudaMemcpyFromSymbol(out, g_phase_cycles, sizeof(g_phase_cycles)); }
#ifdef FRAME_COUNT_BARRIERS
#define FRAME_SYNC() do { __syncthreads(); \
    if (threadIdx.x == 0 && blockIdx.x == 0) ++g_phase_cycles[FRAME_PHASES]; } while (0)
#endif
#else
#define PHASE_BEGIN
#define PHASE(i)
#define PHASE_END
#define PHASE_EXPORT
#endif
#ifndef FRAME_SYNC
#define FRAME_SYNC() __syncthreads()
#endif

// Mirror of ops/frame_kernel.py:_FrameParams. K, gather_roll, band_shift and
// corr_refresh are read by the K-stream kernel only; meas_rows (the rows F of
// the raw [T, F, 8] measurement layout, 0 for the canvas layout) by the
// single-stream kernel only.
struct FrameParams {
  int T, B, cols, iterations, merge_shift, window, use_prior, use_split;
  int K, gather_roll, band_shift, corr_refresh;
  float f, c, range_min, range_max, merge_range, cap, point_distance,
      normal_cos, chi_threshold, min_inliers, odom_weight, merge_threshold,
      split_distance;
  int meas_rows;
};

static __device__ const float kBig = 1.0e30f;

__device__ __forceinline__ float atan2_poly(float y, float x) {
  float ax = fabsf(x), ay = fabsf(y);
  float hi = fmaxf(ax, ay), lo = fminf(ax, ay);
  float t = lo / fmaxf(hi, F32(1e-30));
  float s = t * t;
  float r = t * (F32(0.9999993329) + s * (F32(-0.3332985605) + s * (F32(0.1994653599) +
                 s * (F32(-0.1390853351) + s * (F32(0.0964200441) + s * (F32(-0.0559098861) +
                 s * (F32(0.0218612288) + s * F32(-0.0040454090))))))));
  if (ay > ax) r = F32(1.5707963267948966) - r;
  if (x < 0.0f) r = F32(3.141592653589793) - r;
  return (y < 0.0f) ? -r : r;
}

// unwrapped SE(2) helpers (ops/_beam_kernels.py compose_s / inverse_s)
__device__ __forceinline__ void compose_s(const float* a, const float* b, float* o) {
  float ca = cosf(a[2]), sa = sinf(a[2]);
  float o0 = a[0] + ca * b[0] - sa * b[1];
  float o1 = a[1] + sa * b[0] + ca * b[1];
  float o2 = a[2] + b[2];
  o[0] = o0; o[1] = o1; o[2] = o2;
}

__device__ __forceinline__ void inverse_s(const float* a, float* o) {
  float c = cosf(a[2]), s = sinf(a[2]);
  float o0 = -(c * a[0] + s * a[1]);
  float o1 = -(-s * a[0] + c * a[1]);
  o[0] = o0; o[1] = o1; o[2] = -a[2];
}

// ------------------------------------------------------------------------
// Z-buffer helpers of projector_kernel.cu and scene_kernel.cu (kernels 8 and
// 7): a key is (depth bits << 32 | row), so its minimum is the closest depth
// and, among equal depths, the lowest row. A cloud of more than 1,024 points
// is spread over a thread-block cluster of at most kZbMaxCluster blocks.
constexpr int kZbMaxCluster = 8;              // the portable cluster size
// entries of an owner's stage: cluster * zb_owned(B, cluster) for B <= 1,024
constexpr int kZbStage = 1024 + kZbMaxCluster;
constexpr unsigned long long kZbEmptyKey = ~0ull;

// Key into THIS block's shared keys. A 64-bit atomicMin through distributed
// shared memory is not atomic on the card (PERF.md §6), a
// CTA-local one is; the blocks' keys then meet at each beam's owner.
__device__ __forceinline__ void zb_key_min(unsigned long long* keys, int col,
                                           unsigned long long key) {
  if (col >= 0) atomicMin(&keys[col], key);
}

// A block may touch another block's shared memory only once every block of
// the cluster has started. Each thread arrives (relaxed: no memory order) at
// the kernel's entry and waits just before its first access through
// distributed shared memory, so the wait finds the others long arrived; the
// cluster barriers after it (cluster.sync()) take the next phases.
__device__ __forceinline__ void zb_cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void zb_cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Beam b is owned by block b % cluster; the owner holds `per` beams.
__host__ __device__ __forceinline__ int zb_owned(int B, int cluster) {
  return (B + cluster - 1) / cluster;
}

// Once this block's keys are final (after a __syncthreads) and every block
// of the cluster has started (zb_cluster_wait): send the key of
// each of the first B beams to its owner, into the owner's
// stage[rank * per + b / cluster], by stores through distributed shared
// memory (no load waits; the next cluster barrier completes them).
__device__ __forceinline__ void zb_push_keys(const unsigned long long* keys,
                                             unsigned long long* stage, int B, int cluster,
                                             int rank) {
  cooperative_groups::cluster_group cl = cooperative_groups::this_cluster();
  const int per = zb_owned(B, cluster);
  for (int b = threadIdx.x; b < B; b += blockDim.x)
    cl.map_shared_rank(stage, b % cluster)[rank * per + b / cluster] = keys[b];
}

// The owner's minimum over the cluster's blocks of its j-th beam (beam
// rank + j * cluster), from its own stage.
__device__ __forceinline__ unsigned long long zb_owned_min(const unsigned long long* stage,
                                                           int j, int B, int cluster) {
  const int per = zb_owned(B, cluster);
  unsigned long long k[kZbMaxCluster];
#pragma unroll
  for (int r = 0; r < kZbMaxCluster; ++r) k[r] = r < cluster ? stage[r * per + j] : kZbEmptyKey;
  unsigned long long m = k[0];
#pragma unroll
  for (int r = 1; r < kZbMaxCluster; ++r) m = k[r] < m ? k[r] : m;
  return m;
}

// Launch `kernel` on `blocks` blocks in clusters of `cluster` blocks (the
// cluster size is a launch attribute here, not a property of the kernel).
// A cluster the card refuses returns its error.
template <typename... Params, typename... Args>
static cudaError_t zb_launch_clusters(void (*kernel)(Params...), int blocks, int threads,
                                      int cluster, cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

struct Fields {
  float px, py, nx, ny, d;
  int col;
  bool okp;
};

// A moving lane moved by the pose T, whose cosine and sine are c and s.
__device__ __forceinline__ Fields fields_at(float mx, float my, float mnx, float mny, float mv,
                                            const float* T, float c, float s,
                                            const FrameParams& p) {
  Fields r;
  r.px = c * mx - s * my + T[0];
  r.py = s * mx + c * my + T[1];
  r.nx = c * mnx - s * mny;
  r.ny = s * mnx + c * mny;
  r.d = sqrtf(r.px * r.px + r.py * r.py);
  float colf = floorf(atan2_poly(r.py, r.px) * p.f + p.c);
  r.okp = (mv > 0.0f) && (colf >= 0.0f) && (colf < (float)p.cols) &&
          (r.d >= p.range_min) && (r.d <= p.range_max);
  r.col = r.okp ? (int)colf : -1;
  return r;
}

__device__ __forceinline__ Fields moving_fields(float mx, float my, float mnx, float mny,
                                                float mv, const float* T, const FrameParams& p) {
  return fields_at(mx, my, mnx, mny, mv, T, cosf(T[2]), sinf(T[2]), p);
}

// Dense z-buffer of a cloud of n rows, at the identity camera, into canvas
// rows [6][B] in shared memory (ops/_beam_kernels.py build_canvasT): per
// beam the closest depth (kBig where empty), the mean of x, y, nx, ny over
// the points tied at that depth (each added as v * (1 / count), as the
// TPU's normalised one-hot product does; exact for one or two tied points,
// order-dependent in the last bit for three or more) and has-point. s_zmin
// [B] and s_cnt [B] are shared scratch; all threads call. The rows are
// RawRows (the frame kernel's raw measurement layout); canvas_point gives
// a row's fields, of those or of a PackedCloud (the aligners' clouds).
struct PackedCloud {   // xy, normal: [n][2]; valid: bytes
  const float* xy;
  const float* nm;
  const unsigned char* valid;
  __device__ void get(int i, float& x, float& y, float& nx, float& ny, float& mv) const {
    x = xy[2 * i]; y = xy[2 * i + 1]; nx = nm[2 * i]; ny = nm[2 * i + 1];
    mv = valid[i] ? 1.0f : 0.0f;
  }
};

struct RawRows {       // [n][8]: x, y, nx, ny, valid, ...
  const float* r;
  __device__ void get(int i, float& x, float& y, float& nx, float& ny, float& mv) const {
    x = r[8 * i]; y = r[8 * i + 1]; nx = r[8 * i + 2]; ny = r[8 * i + 3]; mv = r[8 * i + 4];
  }
};

template <class Rows>
__device__ __forceinline__ Fields canvas_point(const Rows& rows, int i, const FrameParams& p) {
  float x, y, nx, ny, mv;
  rows.get(i, x, y, nx, ny, mv);
  Fields r;
  r.px = x; r.py = y; r.nx = nx; r.ny = ny;
  r.d = sqrtf(r.px * r.px + r.py * r.py);
  float colf = floorf(atan2_poly(r.py, r.px) * p.f + p.c);
  r.okp = (mv > 0.0f) && (colf >= 0.0f) && (colf < (float)p.cols) &&
          (r.d >= p.range_min) && (r.d <= p.range_max);
  r.col = r.okp ? (int)colf : -1;
  return r;
}

template <class Rows>
__device__ __forceinline__ void build_canvas_rows(const Rows& rows, int n, float* s_canvas,
                                                  int* s_zmin, float* s_cnt, int B,
                                                  const FrameParams& p) {
  for (int b = threadIdx.x; b < B; b += blockDim.x) {
    s_zmin[b] = __float_as_int(kBig);
    s_cnt[b] = 0.0f;
    s_canvas[B + b] = 0.0f; s_canvas[2 * B + b] = 0.0f;
    s_canvas[3 * B + b] = 0.0f; s_canvas[4 * B + b] = 0.0f;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const Fields fl = canvas_point(rows, i, p);
    if (fl.okp) atomicMin(&s_zmin[fl.col], __float_as_int(fl.d));   // d >= 0
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const Fields fl = canvas_point(rows, i, p);
    if (fl.okp && fl.d <= __int_as_float(s_zmin[fl.col])) atomicAdd(&s_cnt[fl.col], 1.0f);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const Fields fl = canvas_point(rows, i, p);
    if (fl.okp && fl.d <= __int_as_float(s_zmin[fl.col])) {
      const float inv = 1.0f / s_cnt[fl.col];
      atomicAdd(&s_canvas[B + fl.col], fl.px * inv);
      atomicAdd(&s_canvas[2 * B + fl.col], fl.py * inv);
      atomicAdd(&s_canvas[3 * B + fl.col], fl.nx * inv);
      atomicAdd(&s_canvas[4 * B + fl.col], fl.ny * inv);
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < B; b += blockDim.x) {
    s_canvas[b] = __int_as_float(s_zmin[b]);
    s_canvas[5 * B + b] = (s_cnt[b] > 0.0f) ? 1.0f : 0.0f;
  }
  __syncthreads();
}

// A moving lane's matched canvas cell: depth, point, normal, has-point.
// All zero where the lane found nothing in its band (as the TPU gathers).
struct Gathered {
  float bmin, bfx, bfy, bfnx, bfny, bhas;
};

// canvas: [6][B] rows in shared memory; hot: the lane's beam lies in its band.
__device__ __forceinline__ Gathered gather_canvas(const float* canvas, int B, int col, bool hot) {
  Gathered g = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (hot) {
    g.bmin = canvas[col];
    g.bfx = canvas[B + col];
    g.bfy = canvas[2 * B + col];
    g.bfnx = canvas[3 * B + col];
    g.bfny = canvas[4 * B + col];
    g.bhas = canvas[5 * B + col];
  }
  return g;
}

// The single-stream band: the beam must lie in the window of the lane's
// 128-beam block (window start w0), where the one-hot gather looks.
__device__ __forceinline__ bool in_block_window(const Fields& fl, int w0, int window) {
  const int local = fl.col - w0;
  return fl.okp && local >= 0 && local < window;
}

// The 13 per-lane terms of banded_stats (ops/_beam_kernels.py) from a
// gathered cell and the lane's moving fields.
__device__ __forceinline__ void match_terms(const Fields& fl, const Gathered& g,
                                            const FrameParams& p, float* t) {
  const float bmin = g.bmin, bfx = g.bfx, bfy = g.bfy, bfnx = g.bfnx, bfny = g.bfny,
              bhas = g.bhas;
  bool close = fabsf(bmin - fl.d) <= p.point_distance;
  float ndot = bfnx * fl.nx + bfny * fl.ny;
  bool ok = (bhas > 0.5f) && close && (ndot >= p.normal_cos);
  float e1 = bfnx * (fl.px - bfx) + bfny * (fl.py - bfy);
  float e2 = fl.nx - bfnx;
  float e3 = fl.ny - bfny;
  float chi = e1 * e1 + e2 * e2 + e3 * e3;
  float w = 1.0f;
  if (p.chi_threshold > 0.0f)
    w = (chi < p.chi_threshold) ? 1.0f : p.chi_threshold / fmaxf(chi, F32(1e-20));
  if (!ok) w = 0.0f;
  float okf = ok ? 1.0f : 0.0f;
  float j1c = bfnx * (-fl.py) + bfny * fl.px;
  float sn2 = fl.nx * fl.nx + fl.ny * fl.ny;
  float thr = p.chi_threshold > 0.0f ? p.chi_threshold : kBig;
  float inl = okf * ((chi < thr) ? 1.0f : 0.0f);
  t[0] = w * bfnx * bfnx;
  t[1] = w * bfnx * bfny;
  t[2] = w * bfnx * j1c;
  t[3] = w * bfny * bfny;
  t[4] = w * bfny * j1c;
  t[5] = w * (j1c * j1c + sn2);
  t[6] = w * bfnx * e1;
  t[7] = w * bfny * e1;
  t[8] = w * (j1c * e1 - fl.ny * e2 + fl.nx * e3);
  t[9] = okf;
  t[10] = okf * chi;
  t[11] = inl * chi;
  t[12] = inl;
}

// The odometry prior (bk.add_odom_prior) at prior P and estimate T, weight
// w, added to the normal equations h = [h00 h01 h02 h11 h12 h22 b0 b1 b2].
// What depends on P and w alone is taken once (prior_terms), the rest at
// each estimate (prior_increments).
struct PriorTerms {
  float P2, ca, sa, atx, aty, hdiag;
};

__device__ __forceinline__ PriorTerms prior_terms(const float* P, float w) {
  PriorTerms c;
  c.P2 = P[2];
  c.ca = cosf(-P[2]);
  c.sa = sinf(-P[2]);
  const float cp = cosf(P[2]), sp = sinf(P[2]);
  c.atx = -(cp * P[0] + sp * P[1]);
  c.aty = -(-sp * P[0] + cp * P[1]);
  c.hdiag = w * (c.ca * c.ca + c.sa * c.sa);
  return c;
}

// What the prior adds to each of h[0..8] at the estimate T (nothing to h[1]);
// it needs T and not the sums, so the frame step takes it before its
// reduction ends.
__device__ __forceinline__ void prior_increments(const PriorTerms& c, const float* T, float w,
                                                 float* inc) {
  const float ca = c.ca, sa = c.sa;
  float ex = c.atx + ca * T[0] - sa * T[1];
  float ey = c.aty + sa * T[0] + ca * T[1];
  float et = T[2] - c.P2;
  float jx2 = ca * -T[1] - sa * T[0];
  float jy2 = sa * -T[1] + ca * T[0];
  inc[0] = c.hdiag;
  inc[1] = 0.0f;
  inc[2] = w * (ca * jx2 + sa * jy2);
  inc[3] = c.hdiag;
  inc[4] = w * (-sa * jx2 + ca * jy2);
  inc[5] = w * (jx2 * jx2 + jy2 * jy2 + 1.0f);
  inc[6] = w * (ca * ex + sa * ey);
  inc[7] = w * (-sa * ex + ca * ey);
  inc[8] = w * (jx2 * ex + jy2 * ey + et);
}

__device__ __forceinline__ void add_increments(float* h, const float* inc) {
  h[0] = h[0] + inc[0];
#pragma unroll
  for (int i = 2; i < 9; ++i) h[i] = h[i] + inc[i];
}

// Cramer solve of H dx = -b (|det| <= 1e-20 gives 0) from the normal
// equations h as above; dx is 0 where `guard` fails.
__device__ __forceinline__ void cramer_dx(const float* h, bool guard, float* dx) {
  float a00 = h[0], a01 = h[1], a02 = h[2], a11 = h[3], a12 = h[4], a22 = h[5];
  float a10 = a01, a20 = a02, a21 = a12;
  float r0 = -h[6], r1 = -h[7], r2 = -h[8];
  float det = a00 * (a11 * a22 - a12 * a21) - a01 * (a10 * a22 - a12 * a20) +
              a02 * (a10 * a21 - a11 * a20);
  float inv_det = (fabsf(det) > F32(1e-20)) ? 1.0f / det : 0.0f;
  float x0 = ((a11 * a22 - a12 * a21) * r0 + (a02 * a21 - a01 * a22) * r1 +
              (a01 * a12 - a02 * a11) * r2) * inv_det;
  float x1 = ((a12 * a20 - a10 * a22) * r0 + (a00 * a22 - a02 * a20) * r1 +
              (a02 * a10 - a00 * a12) * r2) * inv_det;
  float x2 = ((a10 * a21 - a11 * a20) * r0 + (a01 * a20 - a00 * a21) * r1 +
              (a00 * a11 - a01 * a10) * r2) * inv_det;
  dx[0] = guard ? x0 : 0.0f;
  dx[1] = guard ? x1 : 0.0f;
  dx[2] = guard ? x2 : 0.0f;
}

// cramer_dx, then T <- dx * T (unwrapped).
__device__ __forceinline__ void cramer_step(const float* h, bool guard, float* T) {
  float dx[3], Tn[3];
  cramer_dx(h, guard, dx);
  compose_s(dx, T, Tn);
  T[0] = Tn[0]; T[1] = Tn[1]; T[2] = Tn[2];
}


// The one-hot band of lane b (the window of its 128-beam block) or, with
// `roll`, the beam within +-band_shift of the lane (K-stream kernel only).
__device__ __forceinline__ bool in_band(const Fields& fl, int b, bool roll, const FrameParams& p) {
  if (roll) return fl.okp && abs(fl.col - b) <= p.band_shift;
  const int w0 = min(max((b >> 7) * 128 - (p.window - 128) / 2, 0), p.B - p.window);
  return in_block_window(fl, w0, p.window);
}

// ===========================================================================
// The tracking-frame step of kernels 1 and 3 (frame_kernel.cu,
// stream_kernel.cu): one persistent block per stream walks its T frames, the
// stream's cache lanes and pose in registers, the frame's canvas rows and the
// merge z-buffer in shared memory. A frame is latency on one SM: 11
// Gauss-Newton passes, each a block reduction of 13 sums and a 3x3 solve that
// every thread repeats (so the new pose needs no broadcast), then the merge.
// With one block per SM the four schedulers issue every instruction of the
// block, so the design spends as few instructions, and as few barriers, per
// pass as it can:
//  - FRAME_BPT beams a thread (beam b = thread + j * threads): fewer warps
//    repeat the solve and meet at each barrier;
//  - the passes walk only the cache lanes that hold a cell (about 40 % of the
//    beams on the benchmark's and the corridor's scans), packed to the front
//    at the frame's start; a lane without a cell adds exact zeros and is
//    never merged;
//  - ONE barrier per reduction (block_sum13): a transposed butterfly in each
//    warp (16 shuffles for the 13 sums), the warp partials into one half of
//    a double-buffered shared array, then every warp adds all partials
//    itself in one fixed order, so all threads hold bit-identical totals;
//  - what the frame fixes is taken once a frame (prior_terms), the prior's
//    share of a pass before its reduction ends (prior_increments), a sine
//    and cosine of one angle side by side (fields_at takes them); the next
//    frame's initial guess (odometry alone) overlaps this frame's merge, and
//    the payload's pose chain this frame's final pass;
//  - the next frame's canvas rows are copied (cp.async) into the other half
//    of a double buffer while this frame runs, so a frame starts with no
//    load;
//  - the merge's z-buffer writes share the final reduction's barrier, and
//    the append scan takes one barrier (block_scan_beams, ballots in a warp).
// That is 16 barriers a frame (2 to pack the lanes, 10 + 1 reductions at 10
// iterations, 2 in the merge z-buffer, 1 in the scan); the raw measurement
// layout z-buffers the rows at the frame's start (build_canvas_rows: 6 more).
// ===========================================================================

#ifndef FRAME_BPT
#define FRAME_BPT 2
#endif
constexpr int kTerms = 13;
constexpr unsigned kFull = 0xffffffffu;

// Threads of a frame block for B beams at bpt beams a thread (whole warps).
__host__ __device__ constexpr int frame_threads(int B, int bpt) {
  return ((B + bpt - 1) / bpt + 31) / 32 * 32;
}

// Shared memory of frame_loop, bytes (the layout is at its top).
__host__ __device__ constexpr size_t frame_smem_bytes(int B) {
  return sizeof(float) * (23 * (size_t)B + 2 * 32 * 16) +
         sizeof(int) * (2 * (size_t)B + 2 * 4 * 32);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

// Start copying one frame's canvas rows 0-5 (B floats each, `row` floats
// apart) into shared memory; all threads call. Every address is 16-byte
// aligned (B is a multiple of 128; the wrappers check the tensors).
__device__ __forceinline__ void prefetch_rows(float* s_rows, const float* rows, size_t row,
                                              int B) {
#pragma unroll
  for (int r = 0; r < 6; ++r)
    for (int c = 4 * threadIdx.x; c < B; c += 4 * blockDim.x)
      cp_async16(s_rows + r * B + c, rows + r * row + c);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void wait_rows() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// The odometry-predicted initial guess and prior of a frame, T0 = (D o S)^-1
// with D the odometry step since the last valid reading; it depends on the
// odometry alone, so the frame loop takes it one frame ahead.
struct Guess {
  float T0[3];
  PriorTerms prior;
};

__device__ __forceinline__ Guess initial_guess(const float* last_odom, float has_odom,
                                               const float* odom, float ov, const float* S,
                                               const FrameParams& p) {
  Guess g;
  float D[3] = {0.f, 0.f, 0.f};
  if (has_odom > 0.0f && ov > 0.0f) {
    float inv_lo[3];
    inverse_s(last_odom, inv_lo);
    compose_s(inv_lo, odom, D);
  }
  float DS[3];
  compose_s(D, S, DS);
  inverse_s(DS, g.T0);
  g.prior = {};
  if (p.use_prior) g.prior = prior_terms(g.T0, p.odom_weight);
  return g;
}

// One level of the transposed butterfly: lanes that differ in bit `o` each
// send the half of their first 2N values that the other keeps, and keep the
// pair's sums of their own half.
template <int N>
__device__ __forceinline__ void butterfly_level(float* x, int lane, int o) {
  const bool up = lane & o;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float send = up ? x[i] : x[i + N];
    const float keep = up ? x[i + N] : x[i];
    x[i] = keep + __shfl_xor_sync(kFull, send, o);
  }
}

// The warp's sums of the 13 terms v by a transposed butterfly (16
// shuffles): lanes 2k and 2k + 1 return the warp's sum k.
__device__ __forceinline__ float warp_sums13(const float* v, int lane) {
  float x[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) x[k] = k < kTerms ? v[k] : 0.0f;
  butterfly_level<8>(x, lane, 16);
  butterfly_level<4>(x, lane, 8);
  butterfly_level<2>(x, lane, 4);
  butterfly_level<1>(x, lane, 2);
  return x[0] + __shfl_xor_sync(kFull, x[0], 1);
}

// Block sums of the 13 terms with ONE barrier; every thread gets the totals.
// part: shared [2][32][16]; `buf` alternates between consecutive calls, so a
// warp that runs ahead writes the other half while slower warps still read
// this one. Every warp adds all warp partials itself in the same order, so
// all threads hold the same totals bit for bit.
__device__ __forceinline__ void block_sum13(const float* v, float* part, int buf, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const float x0 = warp_sums13(v, lane);
  float* pb = part + buf * 32 * 16;
  if (!(lane & 1) && (lane >> 1) < kTerms) pb[warp * 16 + (lane >> 1)] = x0;
  FRAME_SYNC();
  const int k = lane & 15;
  float acc = 0.0f;
  if (k < kTerms)
    for (int w = lane >> 4; w < nw; w += 2) acc += pb[w * 16 + k];
  acc = acc + __shfl_xor_sync(kFull, acc, 16);
#pragma unroll
  for (int t = 0; t < kTerms; ++t) out[t] = __shfl_sync(kFull, acc, t);
}

// Ballot scan over rows [0, n) in order: visit(i, pos, flagged) is called
// for every row i, pos being the number of flagged rows before it (where a
// packed copy of a flagged row goes). Returns the number of flagged rows.
// All threads call; two barriers per blockDim.x rows; s_scan: shared [32].
template <class Flag, class Visit>
__device__ int block_pack(int n, Flag flag, Visit visit, int* s_scan) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  int base = 0;
  for (int c0 = 0; c0 < n; c0 += blockDim.x) {
    const int i = c0 + threadIdx.x;
    const bool f = i < n && flag(i);
    const unsigned ball = __ballot_sync(kFull, f);
    if (lane == 0) s_scan[warp] = __popc(ball);
    __syncthreads();
    int before = base, total = 0;
    for (int w = 0; w < nw; ++w) {
      const int cnt = s_scan[w];
      if (w < warp) before += cnt;
      total += cnt;
    }
    if (i < n) visit(i, before + __popc(ball & ((1u << lane) - 1u)), f);
    base += total;
    __syncthreads();   // s_scan is rewritten by the next rows
  }
  return base;
}

// Inclusive scan over the beams in beam order (beam b = thread + j * threads)
// of each thread's BPT pairs of flags q[j] (bits 0 and 16), with ONE
// barrier: q[j] becomes the two inclusive counts (at most 1,024 each, in the
// low and high 16 bits) and `total` gets both totals. Within a warp the
// counts come from ballots; s_scan: shared [4][32].
template <int BPT>
__device__ __forceinline__ void block_scan_beams(int* q, int* s_scan, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const unsigned upto = kFull >> (31 - lane);   // lanes 0..lane
#pragma unroll
  for (int j = 0; j < BPT; ++j) {
    const unsigned a = __ballot_sync(kFull, q[j] & 1), m = __ballot_sync(kFull, q[j] >> 16);
    q[j] = __popc(a & upto) | (__popc(m & upto) << 16);
    if (lane == 0) s_scan[j * 32 + warp] = __popc(a) | (__popc(m) << 16);
  }
  FRAME_SYNC();
  int before = 0;   // every beam of the earlier j
#pragma unroll
  for (int j = 0; j < BPT; ++j) {
    int w = lane < nw ? s_scan[j * 32 + lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += u;
    }
    const int earlier = __shfl_sync(kFull, w, warp > 0 ? warp - 1 : 0);
    q[j] += before + (warp > 0 ? earlier : 0);
    before += __shfl_sync(kFull, w, nw - 1);
  }
  total = before;
}

// The lean beam-window merge of beam b (after the shift z-buffer of the
// transformed cache lanes): the measurement cell against the cache cell
// that landed on the beam. merge_flags is the decision alone (what the
// append scan needs), merge_decide the cells as well.
struct MergeFlags {
  bool m_ok, s_ok, do_merge, modify, do_append;
};

struct MergeLane : MergeFlags {
  float upd_px, upd_py, upd_nx, upd_ny;   // the cell the scene receives (sensor frame)
  float spx, spy, snx, sny, srow;          // the cache cell seen on this beam
};

__device__ __forceinline__ MergeFlags merge_flags(int b, const float* s_canvas,
                                                  const int* s_zmin, int B,
                                                  const FrameParams& p) {
  MergeFlags m;
  const float smin = __int_as_float(s_zmin[b]);
  m.s_ok = smin < kBig;
  const float fmin = s_canvas[b], fhas = s_canvas[5 * B + b];
  m.m_ok = (fhas > 0.5f) && (fmin <= p.merge_range);
  const float dr = fmin - smin;
  const bool both = m.m_ok && m.s_ok;
  m.do_merge = both && (fabsf(dr) < p.merge_threshold);
  const bool do_replace = both && !m.do_merge && (dr > 0.0f);
  m.do_append = (m.m_ok && !m.s_ok) || (both && !m.do_merge && !do_replace);
  m.modify = m.do_merge || do_replace;
  return m;
}

__device__ __forceinline__ MergeLane merge_decide(int b, const float* s_canvas,
                                                  const float* s_src, const int* s_zmin,
                                                  const int* s_win, int B,
                                                  const FrameParams& p) {
  MergeLane m;
  static_cast<MergeFlags&>(m) = merge_flags(b, s_canvas, s_zmin, B, p);
  const int wl = s_win[b];
  m.spx = 0.f; m.spy = 0.f; m.snx = 0.f; m.sny = 0.f; m.srow = 0.f;
  if (m.s_ok) {
    m.spx = s_src[wl]; m.spy = s_src[B + wl]; m.snx = s_src[2 * B + wl];
    m.sny = s_src[3 * B + wl]; m.srow = s_src[4 * B + wl];
  }
  const float bfx = s_canvas[B + b], bfy = s_canvas[2 * B + b];
  const float bfnx = s_canvas[3 * B + b], bfny = s_canvas[4 * B + b];

  float avg_px = 0.5f * (m.spx + bfx), avg_py = 0.5f * (m.spy + bfy);
  float avg_nx = 0.5f * (m.snx + bfnx), avg_ny = 0.5f * (m.sny + bfny);
  const float nrm = fmaxf(sqrtf(avg_nx * avg_nx + avg_ny * avg_ny), F32(1e-12));
  avg_nx = avg_nx / nrm;
  avg_ny = avg_ny / nrm;
  m.upd_px = m.do_merge ? avg_px : bfx;
  m.upd_py = m.do_merge ? avg_py : bfy;
  m.upd_nx = m.do_merge ? avg_nx : bfnx;
  m.upd_ny = m.do_merge ? avg_ny : bfny;
  return m;
}

// The frame loop of both kernels. kStreams = false: kernel 1 (one stream,
// pose [2][8], odometry in canvas row 6 or raw column 5, the local-map split,
// stats lanes 0-11, the one-hot band, one gather per update). kStreams =
// true: kernel 3, this block's stream blockIdx.x of K (field rows K * B
// floats apart, pose [K][16], odometry [T][K][8], stats lanes 0-6, both
// bands, corr_refresh). Arithmetic follows the Pallas bodies operation by
// operation.
template <int BPT, bool kStreams>
__device__ __forceinline__ void frame_loop(float* smem, const float* __restrict__ meas,
                                           const float* __restrict__ odoms,
                                           const float* __restrict__ cache0,
                                           const float* __restrict__ pose0,
                                           float* __restrict__ out_cache,
                                           float* __restrict__ out_pose,
                                           float* __restrict__ payloads, const FrameParams& p) {
  const int B = p.B, nt = blockDim.x;
  const int k = kStreams ? blockIdx.x : 0;
  const int K = kStreams ? p.K : 1;
  const size_t row = (size_t)K * B;         // floats between two field rows
  const size_t lane0 = (size_t)k * B;       // this stream's lanes within a row
  const bool raw = !kStreams && p.meas_rows > 0;
  const bool roll = kStreams && p.gather_roll;
  const int refresh = kStreams ? max(p.corr_refresh, 1) : 1;

  float* s_canvas = smem;                         // [2][6][B] canvas rows, two frames
  float* s_src = s_canvas + 12 * B;               // [5][B] z-buffer source values
  float* s_lanes = s_src + 5 * B;                 // [6][B] the frame's valid lanes, packed
  float* s_part = s_lanes + 6 * B;                // [2][32][16] warp partial sums
  int* s_zmin = (int*)(s_part + 2 * 32 * 16);     // [B] min depth (float bits)
  int* s_win = s_zmin + B;                        // [B] winning source lane
  int* s_scan = s_win + B;                        // [4][32] warp scan totals (merge)
  int* s_pack = s_scan + 4 * 32;                  // [4][32] warp scan totals (packing)

  // this thread's beams and their carried cache lanes (registers); a beam
  // past B holds an invalid cell
  int bj[BPT];
  bool on[BPT];
  float cx[BPT], cy[BPT], cnx[BPT], cny[BPT], cval[BPT], crow[BPT];
  const float* c0 = cache0 + lane0;
#pragma unroll
  for (int j = 0; j < BPT; ++j) {
    const int b = threadIdx.x + j * nt;
    bj[j] = b;
    on[j] = b < B;
    cx[j] = on[j] ? c0[b] : 0.f;
    cy[j] = on[j] ? c0[row + b] : 0.f;
    cnx[j] = on[j] ? c0[2 * row + b] : 0.f;
    cny[j] = on[j] ? c0[3 * row + b] : 0.f;
    cval[j] = on[j] ? c0[4 * row + b] : 0.f;
    crow[j] = on[j] ? c0[5 * row + b] : -1.f;
  }
  // carried pose (every thread holds the same copy)
  const float* ps0 = pose0 + (size_t)k * 16;
  float X[3] = {ps0[0], ps0[1], ps0[2]};
  float last_odom[3] = {ps0[3], ps0[4], ps0[5]};
  float has_odom = ps0[6], count = ps0[7];
  const float S[3] = {ps0[8], ps0[9], ps0[10]};
  const float cS = cosf(S[2]), sS = sinf(S[2]);

  // frame t's canvas rows (canvas layout) and odometry lanes x, y, theta, valid
  const float* rows0 = meas + lane0;
  auto rows_of = [&](int t) { return rows0 + (size_t)t * 8 * row; };
  auto load_odom = [&](int t, float* o) {
    if (kStreams) {
      const float* od = odoms + ((size_t)t * K + k) * 8;
      o[0] = od[0]; o[1] = od[1]; o[2] = od[2]; o[3] = od[3];
    } else if (raw) {   // column 5 of rows 0-3
      const float* mF = meas + (size_t)t * p.meas_rows * 8;
      o[0] = mF[5]; o[1] = mF[13]; o[2] = mF[21]; o[3] = mF[29];
    } else {            // row 6, lanes 0-3
      const float* od = rows_of(t) + 6 * row;
      o[0] = od[0]; o[1] = od[1]; o[2] = od[2]; o[3] = od[3];
    }
  };
  if (!raw) {
    prefetch_rows(s_canvas, rows_of(0), row, B);
    wait_rows();
    FRAME_SYNC();
  }
  Guess guess;
  {
    float odom[4];
    load_odom(0, odom);
    guess = initial_guess(last_odom, has_odom, odom, odom[3], S, p);
  }
  int pbuf = 0;
  PHASE_BEGIN

  for (int t = 0; t < p.T; ++t) {
    float* cv = s_canvas + (t & 1) * 6 * B;
    if (raw) {
      FRAME_SYNC();   // the last frame's merge is done with the shared scratch
      build_canvas_rows(RawRows{meas + (size_t)t * p.meas_rows * 8}, p.meas_rows, cv, s_zmin,
                        s_src, B, p);
    }
    float T[3] = {guess.T0[0], guess.T0[1], guess.T0[2]};
    const PriorTerms prior = guess.prior;

    // The moving lanes are the valid cache cells, re-framed prev-sensor ->
    // prev-robot. A lane without a cell (most beams) adds exact zeros to
    // every sum and is never merged, so the valid ones are packed to the
    // front (rank by a ballot scan) and the passes walk only those: lane
    // slot threadIdx.x + j * threads holds moving point, scene row, beam.
    int qv[BPT], nv;
#pragma unroll
    for (int j = 0; j < BPT; ++j) qv[j] = cval[j] > 0.0f ? 1 : 0;
    block_scan_beams<BPT>(qv, s_pack, nv);
#pragma unroll
    for (int j = 0; j < BPT; ++j) {
      if (!(cval[j] > 0.0f)) continue;
      const int sl = (qv[j] & 0xffff) - 1;
      s_lanes[sl] = cS * cx[j] - sS * cy[j] + S[0];
      s_lanes[B + sl] = sS * cx[j] + cS * cy[j] + S[1];
      s_lanes[2 * B + sl] = cS * cnx[j] - sS * cny[j];
      s_lanes[3 * B + sl] = sS * cnx[j] + cS * cny[j];
      s_lanes[4 * B + sl] = crow[j];
      s_lanes[5 * B + sl] = __int_as_float(bj[j]);
    }
    FRAME_SYNC();
    // this thread's lanes stay in shared memory (read at each pass: fewer
    // live registers than copies would take)
    bool lon[BPT];
#pragma unroll
    for (int j = 0; j < BPT; ++j) lon[j] = (int)threadIdx.x + j * nt < nv;
    auto lane = [&](int j) { return s_lanes + threadIdx.x + j * nt; };
    auto lane_fields = [&](int j, const float* T, float c, float s) {
      const float* L = lane(j);
      return fields_at(L[0], L[B], L[2 * B], L[3 * B], 1.0f, T, c, s, p);
    };
    auto lane_beam = [&](int j) { return __float_as_int(lane(j)[5 * B]); };
    // every thread is done with the last frame: its half of the canvas
    // buffer takes the next frame's rows (waited for before the final pass's
    // barrier)
    if (!raw && t + 1 < p.T)
      prefetch_rows(s_canvas + ((t + 1) & 1) * 6 * B, rows_of(t + 1), row, B);
    PHASE(0);

    // Gauss-Newton: one gather per outer step, up to `refresh` updates on it
    // payload row 7: chi (lanes 0..its-1) and inliers (64..63+its) of each
    // update, written by those beams as they come
    float* iter_row = payloads + (size_t)t * 8 * row + lane0 + 7 * row;
    float sums[kTerms];
    Fields fl[BPT];
    for (int it = 0; it < p.iterations;) {
      Gathered g[BPT];
      {
        const float c = cosf(T[2]), s = sinf(T[2]);
#pragma unroll
        for (int j = 0; j < BPT; ++j) {
          if (!lon[j]) continue;
          fl[j] = lane_fields(j, T, c, s);
          g[j] = gather_canvas(cv, B, fl[j].col, in_band(fl[j], lane_beam(j), roll, p));
        }
      }
      for (int sub = 0; sub < refresh && it < p.iterations; ++sub, ++it) {
        if (sub > 0) {
          const float c = cosf(T[2]), s = sinf(T[2]);
#pragma unroll
          for (int j = 0; j < BPT; ++j)
            if (lon[j]) fl[j] = lane_fields(j, T, c, s);
        }
        float acc[kTerms] = {};
#pragma unroll
        for (int j = 0; j < BPT; ++j) {
          if (!lon[j]) continue;
          float tm[kTerms];
          match_terms(fl[j], g[j], p, tm);
#pragma unroll
          for (int q = 0; q < kTerms; ++q) acc[q] += tm[q];
        }
        float inc[9];
        if (p.use_prior) prior_increments(prior, T, p.odom_weight, inc);
        PHASE(1);
        block_sum13(acc, s_part, pbuf, sums);
        pbuf ^= 1;
        PHASE(2);
#pragma unroll
        for (int j = 0; j < BPT; ++j) {
          if (bj[j] == it) iter_row[it] = sums[10];
          if (bj[j] == 64 + it) iter_row[64 + it] = sums[12];
        }
        float h[9] = {sums[0], sums[1], sums[2], sums[3], sums[4],
                      sums[5], sums[6], sums[7], sums[8]};
        if (p.use_prior) add_increments(h, inc);
        cramer_step(h, sums[9] >= p.min_inliers, T);
        PHASE(3);
      }
    }

    // the new robot pose and the payload's frame, M = X' o S (before the
    // final pass, whose per-beam work hides this chain's latency)
    float inv_ST[3], ST[3], Xn[3], M[3];
    compose_s(S, T, ST);
    inverse_s(ST, inv_ST);
    compose_s(X, inv_ST, Xn);
    compose_s(Xn, S, M);
    const float cM = cosf(M[2]), sM = sinf(M[2]);

    // final pass (a fresh gather), with the merge's z-buffer inputs written
    // before the reduction's barrier
    float fs[kTerms];
    {
      const float c = cosf(T[2]), s = sinf(T[2]);
      float acc[kTerms] = {};
#pragma unroll
      for (int j = 0; j < BPT; ++j) {
        if (on[j]) {
          s_zmin[bj[j]] = __float_as_int(kBig);
          s_win[bj[j]] = -1;
        }
        if (!lon[j]) continue;
        const int b = lane_beam(j);
        fl[j] = lane_fields(j, T, c, s);
        float tm[kTerms];
        match_terms(fl[j], gather_canvas(cv, B, fl[j].col, in_band(fl[j], b, roll, p)),
                    p, tm);
#pragma unroll
        for (int q = 0; q < kTerms; ++q) acc[q] += tm[q];
        s_src[b] = fl[j].px;
        s_src[B + b] = fl[j].py;
        s_src[2 * B + b] = fl[j].nx;
        s_src[3 * B + b] = fl[j].ny;
        s_src[4 * B + b] = lane(j)[4 * B];   // scene row
      }
      if (!raw) wait_rows();   // the next frame's rows: visible to all after this barrier
      block_sum13(acc, s_part, pbuf, fs);
      pbuf ^= 1;
    }
    PHASE(4);

    // this frame's and the next frame's odometry, for the next initial guess
    // (loaded here, used after the merge's atomics)
    float odom[4], odom_next[4] = {0.f, 0.f, 0.f, 0.f};
    load_odom(t, odom);
    if (t + 1 < p.T) load_odom(t + 1, odom_next);

    // ---- merge: shift z-buffer of the transformed cache lanes (the closest
    // depth, then the highest source lane among the depth winners: the order
    // in which the TPU's roll enumeration -shift..+shift resolves ties) ----
    bool elig[BPT];
#pragma unroll
    for (int j = 0; j < BPT; ++j) {
      elig[j] = lon[j] && fl[j].okp && lane(j)[4 * B] >= 0.0f &&
                abs(fl[j].col - lane_beam(j)) <= p.merge_shift;
      if (elig[j]) atomicMin(&s_zmin[fl[j].col], __float_as_int(fl[j].d));   // d >= 0
    }
    FRAME_SYNC();
#pragma unroll
    for (int j = 0; j < BPT; ++j)
      if (elig[j] && fl[j].d <= __int_as_float(s_zmin[fl[j].col]))
        atomicMax(&s_win[fl[j].col], lane_beam(j));
    FRAME_SYNC();
    // each beam's decision now, its cells after the scan (fewer live values)
    int q[BPT];
#pragma unroll
    for (int j = 0; j < BPT; ++j) {
      const MergeFlags f = on[j] ? merge_flags(bj[j], cv, s_zmin, B, p) : MergeFlags{};
      q[j] = (f.do_append ? 1 : 0) | (f.m_ok ? 1 << 16 : 0);
    }
    // the next frame's initial guess, from the odometry alone
    if (odom[3] > 0.0f) { last_odom[0] = odom[0]; last_odom[1] = odom[1]; last_odom[2] = odom[2]; }
    has_odom = fmaxf(has_odom, odom[3]);
    if (t + 1 < p.T) guess = initial_guess(last_odom, has_odom, odom_next, odom_next[3], S, p);
    PHASE(5);

    // append slots (inclusive beam prefix sums) and split seed slots
    int totals;
    block_scan_beams<BPT>(q, s_scan, totals);
    const float n_app = (float)(totals & 0xffff);
    PHASE(6);

    // slots rise with the prefix sum, so app_ok holds for the first cap - count
    const float n_app_ok = fminf(n_app, fmaxf(p.cap - count, 0.0f));
    float count_new = fminf(count + n_app, p.cap);
    float do_split = 0.0f;
    if (!kStreams && p.use_split) {
      do_split = (sqrtf(Xn[0] * Xn[0] + Xn[1] * Xn[1]) >= p.split_distance) ? 1.0f : 0.0f;
      if (do_split > 0.0f) count_new = fminf((float)(totals >> 16), p.cap);
    }

    float* pay = payloads + (size_t)t * 8 * row + lane0;
#pragma unroll
    for (int j = 0; j < BPT; ++j) {
      if (!on[j]) continue;
      const int b = bj[j];
      const MergeLane m = merge_decide(b, cv, s_src, s_zmin, s_win, B, p);
      const float slot = count + (float)(q[j] & 0xffff) - 1.0f;
      const bool app_ok = m.do_append && (slot < p.cap);
      float target = m.modify ? m.srow : (app_ok ? slot : -1.0f);
      float kind = m.modify ? 1.0f : (app_ok ? 2.0f : 0.0f);
      float pay_x = cM * m.upd_px - sM * m.upd_py + M[0];
      float pay_y = sM * m.upd_px + cM * m.upd_py + M[1];
      float pay_nx = cM * m.upd_nx - sM * m.upd_ny;
      float pay_ny = sM * m.upd_nx + cM * m.upd_ny;
      // carry: the post-merge visible cell per beam, current sensor frame
      float ncx = m.m_ok ? m.upd_px : m.spx, ncy = m.m_ok ? m.upd_py : m.spy;
      float nnx = m.m_ok ? m.upd_nx : m.snx, nny = m.m_ok ? m.upd_ny : m.sny;
      float nrow = m.modify ? m.srow : (app_ok ? slot : ((m.s_ok && !m.m_ok) ? m.srow : -1.0f));
      float nvalid = ((m.m_ok || m.s_ok) && nrow >= 0.0f) ? 1.0f : 0.0f;
      if (do_split > 0.0f) {
        // the new local map is seeded from the measurement
        const float bfx = cv[B + b], bfy = cv[2 * B + b];
        const float bfnx = cv[3 * B + b], bfny = cv[4 * B + b];
        const float seed_slot = (float)(q[j] >> 16) - 1.0f;   // not capped (as in Pallas)
        pay_x = cS * bfx - sS * bfy + S[0];
        pay_y = sS * bfx + cS * bfy + S[1];
        pay_nx = cS * bfnx - sS * bfny;
        pay_ny = sS * bfnx + cS * bfny;
        target = m.m_ok ? seed_slot : -1.0f;
        kind = m.m_ok ? 2.0f : 0.0f;
        ncx = bfx; ncy = bfy; nnx = bfnx; nny = bfny;
        nrow = m.m_ok ? seed_slot : -1.0f;
        nvalid = m.m_ok ? 1.0f : 0.0f;
      }
      pay[b] = pay_x;
      pay[row + b] = pay_y;
      pay[2 * row + b] = pay_nx;
      pay[3 * row + b] = pay_ny;
      pay[4 * row + b] = target;
      pay[5 * row + b] = kind;
      float st = 0.0f;
      switch (b) {
        case 0: st = T[0]; break;
        case 1: st = T[1]; break;
        case 2: st = T[2]; break;
        case 3: st = fs[10]; break;
        case 4: st = fs[9]; break;
        case 5: st = fs[12]; break;
        case 6: st = n_app_ok; break;
        case 7: st = kStreams ? 0.0f : do_split; break;
        case 8: st = kStreams ? 0.0f : Xn[0]; break;
        case 9: st = kStreams ? 0.0f : Xn[1]; break;
        case 10: st = kStreams ? 0.0f : Xn[2]; break;
        case 11: st = kStreams ? 0.0f : count_new; break;
        default: break;
      }
      pay[6 * row + b] = st;
      const int its = p.iterations;
      if (!(b < its || (b >= 64 && b < 64 + its))) pay[7 * row + b] = 0.0f;
      cx[j] = ncx; cy[j] = ncy; cnx[j] = nnx; cny[j] = nny; cval[j] = nvalid; crow[j] = nrow;
    }

    // carry the pose to the next frame
    if (do_split > 0.0f) { X[0] = 0.0f; X[1] = 0.0f; X[2] = 0.0f; }
    else { X[0] = Xn[0]; X[1] = Xn[1]; X[2] = Xn[2]; }
    count = count_new;
    PHASE(7);
  }
  PHASE_END;

  float* oc = out_cache + lane0;
#pragma unroll
  for (int j = 0; j < BPT; ++j) {
    if (!on[j]) continue;
    const int b = bj[j];
    oc[b] = cx[j];
    oc[row + b] = cy[j];
    oc[2 * row + b] = cnx[j];
    oc[3 * row + b] = cny[j];
    oc[4 * row + b] = cval[j];
    oc[5 * row + b] = crow[j];
    oc[6 * row + b] = 0.0f;
    oc[7 * row + b] = 0.0f;
  }
  if (threadIdx.x < 16) {
    // lanes 0-7: X, last_odom, has_odom, count; 8-15: the pose block's second
    // row as it came (kernel 1) or S and zeros (kernel 3)
    const int i = threadIdx.x;
    const float lanes[8] = {X[0], X[1], X[2], last_odom[0], last_odom[1], last_odom[2],
                            has_odom, count};
    out_pose[(size_t)k * 16 + i] =
        i < 8 ? lanes[i] : (!kStreams ? ps0[i] : (i < 11 ? ps0[i] : 0.0f));
  }
}

// ===========================================================================
// The compute-once block z-buffer of the aligners (kernels 5 and 4:
// banded_align_kernel.cu, projective_align_kernel.cu): per beam the closest
// depth, the mean of x, y, nx, ny over the rows tied at it, and has-point,
// as build_canvas_rows gives them, but each row's fields are computed ONCE
// (zb_rows, kept in registers: rows threadIdx.x + k * blockDim.x, k < R;
// rows past R * blockDim.x, none at the routes' shapes, are computed again
// in each sweep) and the z-buffer takes two barriers and no float atomics
// (a float atomicAdd on shared memory is a compare-and-swap loop):
//  1. zb_min: every row takes a 32-bit atomicMin on its depth bits (d >= 0,
//     so the bits order as the depths) in its beam's slot; barrier;
//  2. zb_add: every row at its beam's minimum adds one to the beam's count
//     (an integer atomicAdd); the first to arrive stores its four fields,
//     any later one (a tie, rare) adds its fields to the beam's tie sums;
//     barrier;
// then the beam's owner reads the cell (zb_cell): the first row's fields,
// or where rows tie (first + tie sums) * (1 / count). Against the
// reference's sum of field * (1 / count) (the TPU's normalised one-hot
// product) this is exact for one or two tied rows (x * 0.5 + y * 0.5 ==
// (x + y) * 0.5) and may differ in the last bit for three or more rows at
// bitwise-equal depths on one beam.
// Slots s_zb [10][B]: row 0 the depth bits (kBig where empty; read as
// floats the row is the canvas depth row), rows 1-4 the first row's
// fields, row 5 the count (int), rows 6-9 the tie sums. zb_clear empties a
// slot (rows 1-4 need no clearing: they are read only where the count is
// at least 1, so this pass wrote them); zb_reset empties one after use.
// ===========================================================================
constexpr int kZbRows = 10;

__device__ __forceinline__ void zb_clear(float* s_zb, int B, int b) {
  ((int*)s_zb)[b] = __float_as_int(kBig);
  ((int*)s_zb)[5 * B + b] = 0;
#pragma unroll
  for (int r = 6; r < 10; ++r) s_zb[r * B + b] = 0.0f;
}

__device__ __forceinline__ int zb_count(const float* s_zb, int B, int b) {
  return ((const int*)s_zb)[5 * B + b];
}

// Empty beam b's slot, whose count was `cnt` (the tie sums only where used).
__device__ __forceinline__ void zb_reset(float* s_zb, int B, int b, int cnt) {
  ((int*)s_zb)[b] = __float_as_int(kBig);
  ((int*)s_zb)[5 * B + b] = 0;
  if (cnt > 1) {
#pragma unroll
    for (int r = 6; r < 10; ++r) s_zb[r * B + b] = 0.0f;
  }
}

// row_at(i) -> the Fields of row i, for this thread's first R rows.
template <int R, class RowAt>
__device__ __forceinline__ void zb_rows(RowAt row_at, int n, Fields* f) {
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (i < n) f[k] = row_at(i);
    else f[k].okp = false;
  }
}

// After zb_rows, with every slot empty; all threads call, then a barrier.
template <int R, class RowAt>
__device__ __forceinline__ void zb_min(RowAt row_at, int n, const Fields* f, float* s_zb) {
  int* zmin = (int*)s_zb;
#pragma unroll
  for (int k = 0; k < R; ++k)
    if (f[k].okp) atomicMin(&zmin[f[k].col], __float_as_int(f[k].d));
  for (int i = threadIdx.x + R * blockDim.x; i < n; i += blockDim.x) {
    const Fields g = row_at(i);
    if (g.okp) atomicMin(&zmin[g.col], __float_as_int(g.d));
  }
}

// After zb_min's barrier; all threads call, then a barrier.
template <int R, class RowAt>
__device__ __forceinline__ void zb_add(RowAt row_at, int n, const Fields* f, float* s_zb,
                                       int B) {
  const int* zmin = (const int*)s_zb;
  auto add = [&](const Fields& g) {
    if (g.okp && g.d <= __int_as_float(zmin[g.col])) {
      const int c = g.col;
      if (atomicAdd(&((int*)s_zb)[5 * B + c], 1) == 0) {
        s_zb[B + c] = g.px;
        s_zb[2 * B + c] = g.py;
        s_zb[3 * B + c] = g.nx;
        s_zb[4 * B + c] = g.ny;
      } else {
        atomicAdd(&s_zb[6 * B + c], g.px);
        atomicAdd(&s_zb[7 * B + c], g.py);
        atomicAdd(&s_zb[8 * B + c], g.nx);
        atomicAdd(&s_zb[9 * B + c], g.ny);
      }
    }
  };
#pragma unroll
  for (int k = 0; k < R; ++k) add(f[k]);
  for (int i = threadIdx.x + R * blockDim.x; i < n; i += blockDim.x) add(row_at(i));
}

// Beam b's cell after zb_add's barrier: depth (kBig where empty), the mean
// point and normal (zeros where empty), has-point.
__device__ __forceinline__ Gathered zb_cell(const float* s_zb, int B, int b) {
  const int cnt = zb_count(s_zb, B, b);
  Gathered g = {s_zb[b], 0.0f, 0.0f, 0.0f, 0.0f, cnt > 0 ? 1.0f : 0.0f};
  if (cnt > 0) {
    g.bfx = s_zb[B + b];
    g.bfy = s_zb[2 * B + b];
    g.bfnx = s_zb[3 * B + b];
    g.bfny = s_zb[4 * B + b];
  }
  if (cnt > 1) {
    const float inv = 1.0f / (float)cnt;
    g.bfx = (g.bfx + s_zb[6 * B + b]) * inv;
    g.bfy = (g.bfy + s_zb[7 * B + b]) * inv;
    g.bfnx = (g.bfnx + s_zb[8 * B + b]) * inv;
    g.bfny = (g.bfny + s_zb[9 * B + b]) * inv;
  }
  return g;
}

// The end of an aligner pass (kernels 5 and 4), from each thread's terms
// `acc`: the 13 sums of the pass, its record, and (but for the final pass)
// the Gauss-Newton update of T; every thread returns with the new T and
// its cosine c and sine s. Each warp sums its terms (warp_sums13) into
// s_part [32][16]; after a barrier warp 0 ALONE adds the warp partials (in
// block_sum13's order), records the
// pass (chi, correspondences, inliers, inlier chi), adds the prior's
// increments `inc` (taken before the barrier), solves, and writes T, cos T2
// and sin T2 to s_pose [5]; a second barrier hands them to every warp. The
// other warps skip the scalar chain that kernels 1 and 3 have every warp
// repeat: with one block on the SM it costs them issue slots that the
// second barrier does not. The update's four sines and cosines (of dx2 for
// the compose, of the new T2 for the next pass) are taken side by side,
// lanes 0-3 one each (compose_s's arithmetic otherwise), not one after
// another.
__device__ __forceinline__ void aligner_update(const float* acc, const float* inc, int it,
                                               const FrameParams& p, float* T, float& c,
                                               float& s, float* s_part, float* s_pose,
                                               float* out_t, float* out_stats,
                                               float* out_iters) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const float x0 = warp_sums13(acc, lane);
  if (!(lane & 1) && (lane >> 1) < kTerms) s_part[warp * 16 + (lane >> 1)] = x0;
  FRAME_SYNC();
  if (warp == 0) {
    const int k = lane & 15;
    float a = 0.0f;
    if (k < kTerms) {
#pragma unroll 4
      for (int w = lane >> 4; w < nw; w += 2) a += s_part[w * 16 + k];
    }
    a = a + __shfl_xor_sync(kFull, a, 16);
    float sums[kTerms];
#pragma unroll
    for (int t = 0; t < kTerms; ++t) sums[t] = __shfl_sync(kFull, a, t);
    const float rec[4] = {sums[10], sums[9], sums[12], sums[11]};
    if (it == p.iterations) {
      if (lane < 3) out_t[lane] = T[lane];
      if (lane < 4) out_stats[lane] = rec[lane];
    } else {
      if (lane < 4) out_iters[lane * 128 + it] = rec[lane];
      float h[9] = {sums[0], sums[1], sums[2], sums[3], sums[4],
                    sums[5], sums[6], sums[7], sums[8]};
      if (p.use_prior) add_increments(h, inc);
      float dx[3];
      cramer_dx(h, sums[9] >= p.min_inliers, dx);
      const float t2 = dx[2] + T[2];
      const float arg = lane < 2 ? dx[2] : t2;
      const float v = (lane & 1) ? sinf(arg) : cosf(arg);
      const float ca = __shfl_sync(kFull, v, 0), sa = __shfl_sync(kFull, v, 1);
      const float o0 = dx[0] + ca * T[0] - sa * T[1];
      const float o1 = dx[1] + sa * T[0] + ca * T[1];
      if (lane == 2) s_pose[3] = v;
      if (lane == 3) s_pose[4] = v;
      T[0] = o0; T[1] = o1; T[2] = t2;
    }
    if (lane == 0) {
      s_pose[0] = T[0];
      s_pose[1] = T[1];
      s_pose[2] = T[2];
    }
  }
  FRAME_SYNC();
  T[0] = s_pose[0];
  T[1] = s_pose[1];
  T[2] = s_pose[2];
  c = s_pose[3];
  s = s_pose[4];
}

// The aligners' launch constants, in warp 0 (which alone solves): the
// prior's constants (prior_terms' arithmetic) and, in s_pose[3..4], the
// cosine and sine of the initial angle T2 for the first pass; the six
// sines and cosines are taken side by side, lanes 0-5 one each.
__device__ __forceinline__ PriorTerms aligner_constants(const float* P, float T2,
                                                        const FrameParams& p, float* s_pose) {
  const int lane = threadIdx.x & 31;
  const float arg = lane < 2 ? -P[2] : (lane < 4 ? P[2] : T2);
  const float v = (lane & 1) ? sinf(arg) : cosf(arg);
  if (lane == 4) s_pose[3] = v;
  if (lane == 5) s_pose[4] = v;
  PriorTerms c = {};
  const float ca = __shfl_sync(kFull, v, 0), sa = __shfl_sync(kFull, v, 1);
  const float cp = __shfl_sync(kFull, v, 2), sp = __shfl_sync(kFull, v, 3);
  if (!p.use_prior) return c;
  const float w = p.odom_weight;
  c.P2 = P[2];
  c.ca = ca;
  c.sa = sa;
  c.atx = -(cp * P[0] + sp * P[1]);
  c.aty = -(-sp * P[0] + cp * P[1]);
  c.hdiag = w * (c.ca * c.ca + c.sa * c.sa);
  return c;
}

// The aligners' shared memory is more than the 48 KB a launch gets without
// asking: raise the kernel's limit to `bytes` once per device and process
// (`done`: a bit per device).
template <class Kernel>
static cudaError_t smem_limit_once(Kernel kernel, size_t bytes, unsigned long long& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && ((done >> dev) & 1ull)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && dev < 64) done |= 1ull << dev;
  return err;
}
