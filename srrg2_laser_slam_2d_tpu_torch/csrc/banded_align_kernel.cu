// Banded projective alignment of a beam-indexed moving cloud against a fixed
// cloud: the tracker's whole Gauss-Newton loop in one launch.
//
// Replaces srrg2_laser_slam_2d_tpu/ops/pallas_banded_align.py:
// fused_projective_align_banded (pallas_call at :162).
//
// The fixed cloud (the measurement, not beam-indexed) is z-buffered once
// into a canvas (build_canvasT: closest depth per beam, ties averaged). The
// moving cloud has one row per beam (row r is the scene cell last seen on
// beam r), so each Gauss-Newton pass moves lane r by the current estimate,
// finds its beam, and matches it against that canvas cell while the beam
// lies in the 256-beam window of the lane's 128-beam block; two lanes on one
// beam both match (there is no moving-side z-buffer). The 13 sums, the
// odometry prior, the Cramer solve and the pre-multiplied update are the
// frame kernel's (frame_common.cuh).
//
// Design: one block, one thread per padded beam (B <= 1024), the canvas in
// shared memory, the moving lane and the pose in registers; per pass one
// block-wide sum of 13 terms, then every thread solves the same 3x3 system.
// Latency-bound like the frame kernel: `iterations` + 1 dependent passes.

#include "frame_common.cuh"

__global__ void __launch_bounds__(1024, 1)
banded_align_kernel(const float* __restrict__ fxy, const float* __restrict__ fnm,
                    const unsigned char* __restrict__ fvalid, int F,
                    const float* __restrict__ mxy, const float* __restrict__ mnm,
                    const unsigned char* __restrict__ mvalid, int M,
                    const float* __restrict__ t0, const float* __restrict__ prior,
                    float* __restrict__ out_t, float* __restrict__ out_stats,
                    float* __restrict__ out_iters, FrameParams p) {
  extern __shared__ float smem[];
  const int B = p.B;
  float* s_canvas = smem;                    // [6][B]
  int* s_zmin = (int*)(s_canvas + 6 * B);    // [B]
  float* s_cnt = (float*)(s_zmin + B);       // [B]
  float* s_part = s_cnt + B;                 // [32 * 13]
  float* s_tot = s_part + 32 * 13;           // [16]
  const int b = threadIdx.x;

  for (int k = b; k < 512; k += blockDim.x) out_iters[k] = 0.0f;
  build_canvasT(fxy, fnm, fvalid, F, nullptr, s_canvas, s_zmin, s_cnt, B, p);

  const bool in = b < M;
  const float mx = in ? mxy[2 * b] : 0.0f, my = in ? mxy[2 * b + 1] : 0.0f;
  const float mnx = in ? mnm[2 * b] : 0.0f, mny = in ? mnm[2 * b + 1] : 0.0f;
  const float mv = (in && mvalid[b]) ? 1.0f : 0.0f;
  float T[3] = {t0[0], t0[1], t0[2]};
  const float P[3] = {prior[0], prior[1], prior[2]};
  const int w0 = min(max((b >> 7) * 128 - (p.window - 128) / 2, 0), B - p.window);

  float terms[13], sums[13];
  for (int it = 0; it <= p.iterations; ++it) {
    const Fields fl = moving_fields(mx, my, mnx, mny, mv, T, p);
    match_terms(fl, gather_canvas(s_canvas, B, fl.col, in_block_window(fl, w0, p.window)),
                p, terms);
    block_sum<13>(terms, s_part, s_tot, sums);
    // record at this linearisation point: chi, correspondences, inliers,
    // chi over the inliers
    const float rec[4] = {sums[10], sums[9], sums[12], sums[11]};
    if (it == p.iterations) {
      if (b < 3) out_t[b] = T[b];
      if (b < 4) out_stats[b] = rec[b];
    } else {
      if (b < 4) out_iters[b * 128 + it] = rec[b];
      gn_update(sums, P, T, p);
    }
  }
}

extern "C" int banded_align(const float* fxy, const float* fnm, const unsigned char* fvalid,
                            int F, const float* mxy, const float* mnm,
                            const unsigned char* mvalid, int M, const float* t0,
                            const float* prior, float* out_t, float* out_stats,
                            float* out_iters, const FrameParams* params, void* stream) {
  const FrameParams p = *params;
  if (p.B > 1024 || p.B % 128 || p.iterations > 128 || M > p.B)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (8 * (size_t)p.B + 32 * 13 + 16);
  banded_align_kernel<<<1, p.B, smem, (cudaStream_t)stream>>>(
      fxy, fnm, fvalid, F, mxy, mnm, mvalid, M, t0, prior, out_t, out_stats, out_iters, p);
  return (int)cudaGetLastError();
}
