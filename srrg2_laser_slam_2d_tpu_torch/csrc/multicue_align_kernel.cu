// Multi-cue projective alignment: the dual-rangefinder tracker's whole
// Gauss-Newton loop in one launch.
//
// Replaces srrg2_laser_slam_2d_tpu/ops/pallas_multicue_align.py:
// fused_projective_align_multi (pallas_call at :224).
//
// Every cue c (a rangefinder at sensor-in-robot pose e_c) has its
// measurement z-buffered once, at identity in its own sensor frame, into a
// canvas (closest depth per beam, ties averaged). Every pass moves the
// shared moving cloud (the concatenated per-cue clips, robot frame) by
// T_c = inverse(e_c) * T for each cue and matches EVERY moving row against
// that cue's canvas at the row's beam (dense: no band). The 13 sums of each
// cue are normal equations in the cue-frame increment; they are remapped to
// the robot frame by A_c (H -> A_c^T H A_c, b -> A_c^T b, A_c the constant
// linear map of the conjugation, columns from inverse(e_c) and (a02, a12)
// computed on the host) and added over the cues. Then the odometry prior
// (robot frame, only with odom_weight > 0), the damping on the diagonal,
// the Cramer solve (|det| <= 1e-20 gives 0) and the pre-multiplied update
// T <- dx * T under the guard inliers >= min_inliers AND correspondences >=
// max(min_corr, 1). `iterations` updates, then one pass for the final
// statistics; the record of pass i is [chi, n_ok, inliers, inlier chi].
// The cue constants (inverse(e_c) and the translation column of A_c) are
// computed at the start of the launch from the extrinsics, with the
// operations of the plain version's cue_constants, so that a call costs the
// host one launch.
//
// Bound: about 110 operations per moving row, cue and pass (3.7 MFLOP at
// C = 2, M = 1,442, 11 passes) over some 49 KB in and out; a microsecond
// or less at the card's rates. What bounds this single-block kernel is one
// SM's issue rate and its serial chain: a row and cue take some 180
// instructions (the square root, the arctangent's division and polynomial,
// the Cauchy weight's division), 15k warp instructions a pass at C = 2, and
// each of the 11 passes ends in a reduction and a 3x3 solve whose
// dependent chain (the remap, the division, the sines and cosines of the
// update and of the next cue poses) every warp waits for.
//
// Design: one block of kThreads (512) threads. At the start a ballot scan
// packs the valid moving rows (an invalid row adds exact zeros) into shared
// memory, where every pass reads them (thread r takes packed rows r, r +
// 512, ...; at most 4,096 rows), instead of re-reading device memory per
// cue. The C canvases [6][B] live in shared memory, z-buffered all at once
// at the start (one set of barriers for all cues; a thread keeps the fields
// of its first 4 fixed points in registers across the three sweeps). What
// the launch fixes is taken once: each cue's inverse(e_c) with the cosine
// and sine of its angle (the compose by inverse(e_c) and the remap by A_c
// both need them), the translation column of A_c, the odometry prior's
// constants. The 13 sums of each cue are summed within each warp by a
// transposed butterfly (warp_sums13) into shared memory; after a barrier
// warp 0 alone adds the warp partials in one fixed order
// (multicue_totals), remaps, solves, and writes the new pose and its cue
// poses' cosines and sines (lane c taking cue c) to shared memory, and a
// second barrier hands them to every warp. With one SM issuing everything,
// every warp repeating the ~650 instructions of that scalar work (as
// kernels 1 and 3 do) cost more issue slots than the second barrier:
// 66.4 us against 60.5 us a launch, timed in turns in one process on an
// NVIDIA H100 80GB HBM3 at 700 W. Where it differs from the
// kernels sharing frame_common.cuh: their update guards on
// correspondences (s[9]) and knows neither damping nor min_corr, and their
// prior enters the cue-frame system; here the guard counts inliers and
// correspondences, the damping is added, and the prior enters after the
// remap. So the update is this file's own (multicue_update); it shares only
// the prior terms and the Cramer step (prior_terms, prior_increments,
// cramer_step) with theirs. Angles are not wrapped (compose_s);
// inverse(e_c) is the unwrapped inverse, so the rear cue at theta = pi has
// -pi there, as in the TPU kernel. Built with --fmad=false; beams come from
// the polynomial atan2 of fields_at.

#include "frame_common.cuh"

constexpr int kMaxCues = 4;
constexpr int kMaxMoving = 4096;    // moving rows the block packs in shared memory
constexpr int kThreads = 512;
constexpr int kSlots = 16;          // a cue's 13 sums padded to 16 slots

// H -> A^T H A, b -> A^T b for A = [[a00, a01, a02], [a10, a11, a12], [0, 0, 1]]
// (pallas_multicue_align.py:_remap_sums9, operation by operation).
__device__ __forceinline__ void remap_sums9(const float* s, float a00, float a01, float a02,
                                            float a10, float a11, float a12, float* r) {
  const float h00 = s[0], h01 = s[1], h02 = s[2], h11 = s[3], h12 = s[4], h22 = s[5];
  const float b0 = s[6], b1 = s[7], b2 = s[8];
  const float m00 = h00 * a00 + h01 * a10;
  const float m01 = h00 * a01 + h01 * a11;
  const float m02 = h00 * a02 + h01 * a12 + h02;
  const float m10 = h01 * a00 + h11 * a10;
  const float m11 = h01 * a01 + h11 * a11;
  const float m12 = h01 * a02 + h11 * a12 + h12;
  const float m22 = h02 * a02 + h12 * a12 + h22;
  r[0] = a00 * m00 + a10 * m10;
  r[1] = a00 * m01 + a10 * m11;
  r[2] = a00 * m02 + a10 * m12;
  r[3] = a01 * m01 + a11 * m11;
  r[4] = a01 * m02 + a11 * m12;
  r[5] = a02 * m02 + a12 * m12 + m22;
  r[6] = a00 * b0 + a10 * b1;
  r[7] = a01 * b0 + a11 * b1;
  r[8] = a02 * b0 + a12 * b1 + b2;
}

// One update from the robot-frame sums h[9] and the counts: odometry prior
// (bk.add_odom_prior), damping, then frame_common.cuh's Cramer step under
// the inlier and correspondence guard.
// The prior's constants (prior_terms) are taken once a launch, so this is
// add_odom_prior's arithmetic.
__device__ __forceinline__ void multicue_update(float* h, float n_ok, float inl_cnt,
                                                const PriorTerms& prior, float* T,
                                                const FrameParams& p, float damping,
                                                float min_corr) {
  if (p.use_prior) {
    float inc[9];
    prior_increments(prior, T, p.odom_weight, inc);
    add_increments(h, inc);
  }
  h[0] = h[0] + damping;
  h[3] = h[3] + damping;
  h[5] = h[5] + damping;
  cramer_step(h, (inl_cnt >= p.min_inliers) && (n_ok >= min_corr), T);
}

// The block sums of each cue's 13 terms, after the barrier that follows
// their writing: the warp partials of cue c (warp_sums13) are in slots
// 16 c .. 16 c + 12 of each warp's row of `pb` ([32][16 C]); lane s adds
// slot s (and s + 32) of all warps in warp order, so every warp that calls
// this returns the same totals: tot0 for slots 0-31, tot1 for slots 32-63.
__device__ __forceinline__ void multicue_totals(const float* pb, int C, float& tot0,
                                                float& tot1) {
  const int lane = threadIdx.x & 31, nw = blockDim.x >> 5, row = kSlots * C;
  tot0 = 0.0f;
  tot1 = 0.0f;
  if (lane < row && (lane & 15) < kTerms) {
#pragma unroll 8
    for (int w = 0; w < nw; ++w) tot0 += pb[w * row + lane];
  }
  if (lane + 32 < row && (lane & 15) < kTerms) {
#pragma unroll 8
    for (int w = 0; w < nw; ++w) tot1 += pb[w * row + lane + 32];
  }
}

// Cue c's total k from a lane's (tot0, tot1).
__device__ __forceinline__ float cue_total(float tot0, float tot1, int c, int k) {
  const int slot = kSlots * c + k;
  return __shfl_sync(kFull, slot < 32 ? tot0 : tot1, slot & 31);
}

// Dense z-buffer of the C cue clouds (n rows each, at identity in their
// sensor frames) into C canvases [6][B] in shared memory at once: per cue
// and beam the closest depth, the mean of x, y, nx, ny over the points tied
// at it (each added as v * (1 / count)) and has-point; build_canvas_rows's
// operations, with one set of barriers for all cues. A thread keeps the
// fields of its first kCanvasRegs points in registers across the three
// sweeps (read and computed once), the rest it reads again. s_zmin, s_cnt:
// [C][B].
constexpr int kCanvasRegs = 4;

__device__ void build_cue_canvases(const float* xy, const float* nm,
                                   const unsigned char* valid, int C, int n, float* s_canvas,
                                   int* s_zmin, float* s_cnt, int B, const FrameParams& p) {
  const PackedCloud rows{xy, nm, valid};
  const int total = C * n;
  Fields kept[kCanvasRegs];
#pragma unroll
  for (int k = 0; k < kCanvasRegs; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (i < total) kept[k] = canvas_point(rows, i, p);
    else kept[k].okp = false;
  }
  const int rest = threadIdx.x + kCanvasRegs * blockDim.x;
  for (int b = threadIdx.x; b < C * B; b += blockDim.x) {
    const int c = b / B, k = b % B;
    float* cv = s_canvas + 6 * c * B;
    s_zmin[b] = __float_as_int(kBig);
    s_cnt[b] = 0.0f;
    cv[B + k] = 0.0f; cv[2 * B + k] = 0.0f; cv[3 * B + k] = 0.0f; cv[4 * B + k] = 0.0f;
  }
  __syncthreads();
  auto zmin = [&](const Fields& fl, int i) {
    if (fl.okp) atomicMin(&s_zmin[(i / n) * B + fl.col], __float_as_int(fl.d));   // d >= 0
  };
  auto count = [&](const Fields& fl, int i) {
    if (!fl.okp) return;
    const int cell = (i / n) * B + fl.col;
    if (fl.d <= __int_as_float(s_zmin[cell])) atomicAdd(&s_cnt[cell], 1.0f);
  };
  auto add = [&](const Fields& fl, int i) {
    if (!fl.okp) return;
    const int c = i / n, cell = c * B + fl.col;
    if (fl.d <= __int_as_float(s_zmin[cell])) {
      float* cv = s_canvas + 6 * c * B;
      const float inv = 1.0f / s_cnt[cell];
      atomicAdd(&cv[B + fl.col], fl.px * inv);
      atomicAdd(&cv[2 * B + fl.col], fl.py * inv);
      atomicAdd(&cv[3 * B + fl.col], fl.nx * inv);
      atomicAdd(&cv[4 * B + fl.col], fl.ny * inv);
    }
  };
#pragma unroll
  for (int k = 0; k < kCanvasRegs; ++k) zmin(kept[k], threadIdx.x + k * blockDim.x);
  for (int i = rest; i < total; i += blockDim.x) zmin(canvas_point(rows, i, p), i);
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kCanvasRegs; ++k) count(kept[k], threadIdx.x + k * blockDim.x);
  for (int i = rest; i < total; i += blockDim.x) count(canvas_point(rows, i, p), i);
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kCanvasRegs; ++k) add(kept[k], threadIdx.x + k * blockDim.x);
  for (int i = rest; i < total; i += blockDim.x) add(canvas_point(rows, i, p), i);
  __syncthreads();
  for (int b = threadIdx.x; b < C * B; b += blockDim.x) {
    const int c = b / B, k = b % B;
    float* cv = s_canvas + 6 * c * B;
    cv[k] = __int_as_float(s_zmin[b]);
    cv[5 * B + k] = (s_cnt[b] > 0.0f) ? 1.0f : 0.0f;
  }
  __syncthreads();
}

// fixed: C clouds of N rows ([C][N][2] xy and normal, [C][N] valid);
// moving: M rows; extr: [C][3] sensor-in-robot poses.
__global__ void __launch_bounds__(kThreads, 1)
multicue_align_kernel(const float* __restrict__ fxy, const float* __restrict__ fnm,
                      const unsigned char* __restrict__ fvalid, int C, int N,
                      const float* __restrict__ mxy, const float* __restrict__ mnm,
                      const unsigned char* __restrict__ mvalid, int M,
                      const float* __restrict__ t0, const float* __restrict__ prior,
                      const float* __restrict__ extr, float* __restrict__ out_t,
                      float* __restrict__ out_stats, float* __restrict__ out_iters,
                      FrameParams p, float damping, float min_corr) {
  extern __shared__ float4 smem4[];
  __shared__ float cue[kMaxCues * 8];   // per cue: inverse(e_c) (3), a02, a12, cos, sin
  __shared__ int s_scan[32];
  __shared__ float s_pose[4 + 2 * kMaxCues];   // the pose, then each cue pose's cos, sin
  const int B = p.B;
  float4* s_rows = smem4;                          // [M] packed valid moving rows
  float* s_canvas = (float*)(s_rows + M);          // [C][6][B]
  int* s_zmin = (int*)(s_canvas + 6 * C * B);     // [C][B]
  float* s_cnt = (float*)(s_zmin + C * B);         // [C][B]
  float* s_part = s_cnt + C * B;                   // [32][16 C] warp partials
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  PHASE_BEGIN;

  for (int k = tid; k < 512; k += blockDim.x) out_iters[k] = 0.0f;
  if (tid < C) {
    // cue_constants: geometry.inverse(e), then a02 = cos * (-t_y) + sin * t_x
    // and a12 = -sin * (-t_y) + cos * t_x, operation by operation; the
    // cosine and sine of inverse(e)'s angle, which compose_s and the remap take
    const float x = extr[3 * tid], y = extr[3 * tid + 1], t = extr[3 * tid + 2];
    const float ce = cosf(t), se = sinf(t);
    cue[8 * tid] = -(ce * x + se * y);
    cue[8 * tid + 1] = -(-se * x + ce * y);
    cue[8 * tid + 2] = -t;
    cue[8 * tid + 3] = ce * (-y) + se * x;
    cue[8 * tid + 4] = -se * (-y) + ce * x;
    cue[8 * tid + 5] = cosf(-t);
    cue[8 * tid + 6] = sinf(-t);
  }
  // the valid moving rows (x, y, nx, ny) packed in order: an invalid row
  // adds exact zeros to every sum
  const int Mv = block_pack(
      M, [&](int r) { return mvalid[r] != 0; },
      [&](int r, int pos, bool v) {
        if (v) s_rows[pos] = make_float4(mxy[2 * r], mxy[2 * r + 1], mnm[2 * r], mnm[2 * r + 1]);
      },
      s_scan);
  build_cue_canvases(fxy, fnm, fvalid, C, N, s_canvas, s_zmin, s_cnt, B, p);

  float T[3] = {t0[0], t0[1], t0[2]};
  const float P[3] = {prior[0], prior[1], prior[2]};
  PriorTerms prior_c = {};
  if (p.use_prior) prior_c = prior_terms(P, p.odom_weight);
  // the cosine and sine of every cue pose's angle at the initial guess,
  // lane c taking cue c
  if (warp == 0 && lane < C) {
    const float ang = cue[8 * lane + 2] + T[2];
    s_pose[4 + 2 * lane] = cosf(ang);
    s_pose[5 + 2 * lane] = sinf(ang);
  }
  __syncthreads();
  PHASE(0);
  for (int it = 0; it <= p.iterations; ++it) {
    float* pb = s_part;
    PHASE(1);
    for (int c = 0; c < C; ++c) {
      // compose_s(inverse(e_c), T) with the cue's cosine and sine
      const float ci = cue[8 * c + 5], si = cue[8 * c + 6];
      const float Tc[3] = {cue[8 * c] + ci * T[0] - si * T[1],
                           cue[8 * c + 1] + si * T[0] + ci * T[1], cue[8 * c + 2] + T[2]};
      const float cc = s_pose[4 + 2 * c], sc = s_pose[5 + 2 * c];
      const float* canvas = s_canvas + 6 * c * B;
      float acc[kTerms];
#pragma unroll
      for (int k = 0; k < kTerms; ++k) acc[k] = 0.0f;
#pragma unroll 2
      for (int r = tid; r < Mv; r += kThreads) {
        const float4 q = s_rows[r];
        const Fields fl = fields_at(q.x, q.y, q.z, q.w, 1.0f, Tc, cc, sc, p);
        const Gathered g = gather_canvas(canvas, B, fl.col, fl.okp);
        float t[kTerms];
        match_terms(fl, g, p, t);
#pragma unroll
        for (int m = 0; m < kTerms; ++m) acc[m] += t[m];
      }
      PHASE(2);
      const float x0 = warp_sums13(acc, lane);
      if (!(lane & 1) && (lane >> 1) < kTerms) pb[warp * kSlots * C + kSlots * c + (lane >> 1)] = x0;
      PHASE(3);
    }
    float tot0, tot1;
    __syncthreads();
    if (warp == 0) {
      multicue_totals(pb, C, tot0, tot1);
      PHASE(4);
      float h[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      float n_ok = 0.0f, chi_sum = 0.0f, inl_chi = 0.0f, inl_cnt = 0.0f;
      for (int c = 0; c < C; ++c) {
        float s[kTerms];
#pragma unroll
        for (int k = 0; k < kTerms; ++k) s[k] = cue_total(tot0, tot1, c, k);
        const float ci = cue[8 * c + 5], si = cue[8 * c + 6];
        float r9[9];
        remap_sums9(s, ci, -si, cue[8 * c + 3], si, ci, cue[8 * c + 4], r9);
#pragma unroll
        for (int k = 0; k < 9; ++k) h[k] = h[k] + r9[k];
        n_ok = n_ok + s[9];
        chi_sum = chi_sum + s[10];
        inl_chi = inl_chi + s[11];
        inl_cnt = inl_cnt + s[12];
      }
      const float rec[4] = {chi_sum, n_ok, inl_cnt, inl_chi};
      if (it == p.iterations) {
        if (tid < 3) out_t[tid] = T[tid];
        if (tid < 4) out_stats[tid] = rec[tid];
      } else {
        if (tid < 4) out_iters[tid * 128 + it] = rec[tid];
        multicue_update(h, n_ok, inl_cnt, prior_c, T, p, damping, min_corr);
      }
      // the new pose and its cue poses' cosines and sines, for every warp
      if (lane < C) {
        const float ang = cue[8 * lane + 2] + T[2];
        s_pose[4 + 2 * lane] = cosf(ang);
        s_pose[5 + 2 * lane] = sinf(ang);
      }
      if (lane < 3) s_pose[lane] = T[lane];
    }
    __syncthreads();
    T[0] = s_pose[0]; T[1] = s_pose[1]; T[2] = s_pose[2];
    PHASE(5);
  }
  PHASE_END;
}

PHASE_EXPORT

// The block reduction alone, for the tests: `terms` [threads][C][13]; every
// warp takes the totals (as warp 0 does in the kernel) and every thread
// writes the 13 C totals it holds, after two calls (the second on twice the
// terms, in the other half of the scratch), to out[call][thread][C][13].
__global__ void multicue_block_sums_kernel(const float* __restrict__ terms, int C,
                                           float* __restrict__ out) {
  __shared__ float s_part[2 * 32 * kSlots * kMaxCues];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, n = 13 * C;
  for (int call = 0; call < 2; ++call) {
    float* pb = s_part + call * 32 * kSlots * C;
    for (int c = 0; c < C; ++c) {
      float v[kTerms];
      for (int k = 0; k < kTerms; ++k) v[k] = (call + 1.0f) * terms[tid * n + 13 * c + k];
      const float x0 = warp_sums13(v, lane);
      if (!(lane & 1) && (lane >> 1) < kTerms) pb[warp * kSlots * C + kSlots * c + (lane >> 1)] = x0;
    }
    float tot0, tot1;
    FRAME_SYNC();
    multicue_totals(pb, C, tot0, tot1);
    for (int c = 0; c < C; ++c)
      for (int k = 0; k < kTerms; ++k)
        out[((size_t)call * blockDim.x + tid) * n + 13 * c + k] = cue_total(tot0, tot1, c, k);
  }
}

extern "C" int multicue_block_sums_test(const float* terms, int C, float* out, int threads,
                                        void* stream) {
  if (C < 1 || C > kMaxCues || threads % 32 || threads > 1024) return (int)cudaErrorInvalidValue;
  multicue_block_sums_kernel<<<1, threads, 0, (cudaStream_t)stream>>>(terms, C, out);
  return (int)cudaGetLastError();
}

extern "C" int multicue_align(const float* fxy, const float* fnm, const unsigned char* fvalid,
                              int C, int N, const float* mxy, const float* mnm,
                              const unsigned char* mvalid, int M, const float* t0,
                              const float* prior, const float* extr, float* out_t,
                              float* out_stats, float* out_iters, const FrameParams* params,
                              float damping, float min_corr, void* stream) {
  const FrameParams p = *params;
  if (C < 1 || C > kMaxCues || N < 0 || M < 0 || M > kMaxMoving || p.B > 1024 || p.B % 128 ||
      p.iterations > 128)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float4) * (size_t)M +
                      sizeof(float) * ((6 * (size_t)C + 2 * C) * p.B + 32 * kSlots * C);
  cudaError_t err = cudaFuncSetAttribute(
      multicue_align_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  multicue_align_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(
      fxy, fnm, fvalid, C, N, mxy, mnm, mvalid, M, t0, prior, extr, out_t, out_stats,
      out_iters, p, damping, min_corr);
  return (int)cudaGetLastError();
}
