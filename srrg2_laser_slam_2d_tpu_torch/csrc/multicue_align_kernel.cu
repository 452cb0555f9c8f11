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
// or less at the card's rates. What bounds this single-block design is
// latency: three barriers per pass and one SM at work.
//
// Design: one block of 512 threads; thread r takes moving rows r, r + 512,
// ... (M = 1,442 rows at full width, more than one thread per lane can
// hold). The C canvases [6][B] live in shared memory; the z-buffer scratch
// (zmin, count) of build_canvasT is reused across cues, so the block needs
// (6 C + 2) B floats plus the partial sums: 46 KB at C = 2, B = 768, set
// with cudaFuncSetAttribute. Per pass each thread keeps 13 accumulators for
// one cue at a time, warp-sums them and parks them in shared memory; one
// reduction over the warps then yields all C x 13 totals, and every thread
// remaps and solves the same system. Where it differs from the kernels
// sharing frame_common.cuh: their gn_update guards on correspondences
// (s[9]) and knows neither damping nor min_corr, and their prior enters
// the cue-frame system; here the guard counts inliers and correspondences,
// the damping is added, and the prior enters after the remap. So the update
// is this file's own (multicue_update); it shares only the prior terms and
// the Cramer step (add_odom_prior, cramer_step) with gn_update.
// Angles are not wrapped (compose_s); inverse(e_c) is the unwrapped
// inverse, so the rear cue at theta = pi has -pi there, as in the TPU
// kernel. Built with --fmad=false; beams come from the
// polynomial atan2 of moving_fields.

#include "frame_common.cuh"

constexpr int kMaxCues = 4;
constexpr int kThreads = 512;

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
__device__ __forceinline__ void multicue_update(float* h, float n_ok, float inl_cnt,
                                                const float* P, float* T, const FrameParams& p,
                                                float damping, float min_corr) {
  if (p.use_prior) add_odom_prior(h, P, T, p.odom_weight);
  h[0] = h[0] + damping;
  h[3] = h[3] + damping;
  h[5] = h[5] + damping;
  cramer_step(h, (inl_cnt >= p.min_inliers) && (n_ok >= min_corr), T);
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
  extern __shared__ float smem[];
  __shared__ float cue[kMaxCues * 8];   // per cue: inverse(e_c) (3), a02, a12
  const int B = p.B;
  const int NV = 13 * C;
  float* s_canvas = smem;                          // [C][6][B]
  int* s_zmin = (int*)(s_canvas + 6 * C * B);     // [B]
  float* s_cnt = (float*)(s_zmin + B);             // [B]
  float* s_part = s_cnt + B;                       // [32][13 C]
  float* s_tot = s_part + 32 * NV;                 // [13 C]
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;

  for (int k = tid; k < 512; k += blockDim.x) out_iters[k] = 0.0f;
  if (tid < C) {
    // cue_constants: geometry.inverse(e), then a02 = cos * (-t_y) + sin * t_x
    // and a12 = -sin * (-t_y) + cos * t_x, operation by operation
    const float x = extr[3 * tid], y = extr[3 * tid + 1], t = extr[3 * tid + 2];
    const float ce = cosf(t), se = sinf(t);
    cue[8 * tid] = -(ce * x + se * y);
    cue[8 * tid + 1] = -(-se * x + ce * y);
    cue[8 * tid + 2] = -t;
    cue[8 * tid + 3] = ce * (-y) + se * x;
    cue[8 * tid + 4] = -se * (-y) + ce * x;
  }
  __syncthreads();
  for (int c = 0; c < C; ++c)
    build_canvasT(fxy + 2 * c * N, fnm + 2 * c * N, fvalid + c * N, N, nullptr,
                  s_canvas + 6 * c * B, s_zmin, s_cnt, B, p);

  float T[3] = {t0[0], t0[1], t0[2]};
  const float P[3] = {prior[0], prior[1], prior[2]};
  for (int it = 0; it <= p.iterations; ++it) {
    for (int c = 0; c < C; ++c) {
      const float inv_e[3] = {cue[8 * c], cue[8 * c + 1], cue[8 * c + 2]};
      float Tc[3];
      compose_s(inv_e, T, Tc);
      const float* canvas = s_canvas + 6 * c * B;
      float acc[13];
#pragma unroll
      for (int k = 0; k < 13; ++k) acc[k] = 0.0f;
      for (int r = tid; r < M; r += blockDim.x) {
        const Fields fl = moving_fields(mxy[2 * r], mxy[2 * r + 1], mnm[2 * r],
                                        mnm[2 * r + 1], mvalid[r] ? 1.0f : 0.0f, Tc, p);
        const Gathered g = gather_canvas(canvas, B, fl.col, fl.okp);
        float t[13];
        match_terms(fl, g, p, t);
#pragma unroll
        for (int k = 0; k < 13; ++k) acc[k] += t[k];
      }
#pragma unroll
      for (int k = 0; k < 13; ++k) acc[k] = warp_sum(acc[k]);
      if (lane == 0) {
#pragma unroll
        for (int k = 0; k < 13; ++k) s_part[warp * NV + 13 * c + k] = acc[k];
      }
    }
    __syncthreads();
    if (tid < NV) {
      float a = 0.0f;
      for (int w = 0; w < nwarps; ++w) a += s_part[w * NV + tid];
      s_tot[tid] = a;
    }
    __syncthreads();

    float h[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    float n_ok = 0.0f, chi_sum = 0.0f, inl_chi = 0.0f, inl_cnt = 0.0f;
    for (int c = 0; c < C; ++c) {
      const float* s = s_tot + 13 * c;
      const float ci = cosf(cue[8 * c + 2]), si = sinf(cue[8 * c + 2]);
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
      multicue_update(h, n_ok, inl_cnt, P, T, p, damping, min_corr);
    }
  }
}

extern "C" int multicue_align(const float* fxy, const float* fnm, const unsigned char* fvalid,
                              int C, int N, const float* mxy, const float* mnm,
                              const unsigned char* mvalid, int M, const float* t0,
                              const float* prior, const float* extr, float* out_t,
                              float* out_stats, float* out_iters, const FrameParams* params,
                              float damping, float min_corr, void* stream) {
  const FrameParams p = *params;
  if (C < 1 || C > kMaxCues || N < 0 || M < 0 || p.B > 1024 || p.B % 128 ||
      p.iterations > 128)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((6 * (size_t)C + 2) * p.B + 33 * 13 * (size_t)C);
  cudaError_t err = cudaFuncSetAttribute(
      multicue_align_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  multicue_align_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(
      fxy, fnm, fvalid, C, N, mxy, mnm, mvalid, M, t0, prior, extr, out_t, out_stats,
      out_iters, p, damping, min_corr);
  return (int)cudaGetLastError();
}
