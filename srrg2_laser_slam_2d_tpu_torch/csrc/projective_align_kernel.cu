// Dense beam-space projective alignment of two clouds: the large-motion
// aligner's whole Gauss-Newton loop in one launch.
//
// Replaces srrg2_laser_slam_2d_tpu/ops/pallas_projective_align.py:
// fused_projective_align (pallas_call at :303).
//
// The fixed cloud is z-buffered once into a canvas (closest depth per beam,
// ties averaged). Every pass moves the whole moving cloud by the current
// estimate and z-buffers it too, so each beam holds at most one moving
// point (the closest, ties averaged); beams where both sides hold a point
// are matched under the depth and normal gates, and the nine sums, the
// odometry prior, the Cramer solve and the pre-multiplied update follow.
// `iterations` updates, then one more pass for the final statistics.
//
// Design: one block, one thread per padded beam (B <= 1024). Both canvases
// live in shared memory; the moving one is rebuilt in every pass by
// build_canvasT with the estimate as its pose: a 32-bit atomicMin on the
// depth bits, a count of the points tied at the minimum, then field * (1 /
// count) added per beam, which is what the TPU's [M, B] masked minimum and
// normalised one-hot product compute. Then thread b matches beam b with the
// frame kernel's match_terms: a beam without a moving point holds depth
// 1e30 and fails the depth gate, as in the TPU kernel. Per pass: five
// barriers for the z-buffer, one block sum of 13 terms, and every thread
// solves the same 3x3 system.

#include "frame_common.cuh"

__global__ void __launch_bounds__(1024, 1)
projective_align_kernel(const float* __restrict__ fxy, const float* __restrict__ fnm,
                        const unsigned char* __restrict__ fvalid, int F,
                        const float* __restrict__ mxy, const float* __restrict__ mnm,
                        const unsigned char* __restrict__ mvalid, int M,
                        const float* __restrict__ t0, const float* __restrict__ prior,
                        float* __restrict__ out_t, float* __restrict__ out_stats,
                        float* __restrict__ out_iters, FrameParams p) {
  extern __shared__ float smem[];
  const int B = p.B;
  float* s_fixed = smem;                     // [6][B]
  float* s_mov = s_fixed + 6 * B;            // [6][B]
  int* s_zmin = (int*)(s_mov + 6 * B);       // [B]
  float* s_cnt = (float*)(s_zmin + B);       // [B]
  float* s_part = s_cnt + B;                 // [32 * 13]
  float* s_tot = s_part + 32 * 13;           // [16]
  const int b = threadIdx.x;

  for (int k = b; k < 512; k += blockDim.x) out_iters[k] = 0.0f;
  build_canvasT(fxy, fnm, fvalid, F, nullptr, s_fixed, s_zmin, s_cnt, B, p);
  const Gathered g = gather_canvas(s_fixed, B, b, true);

  float T[3] = {t0[0], t0[1], t0[2]};
  const float P[3] = {prior[0], prior[1], prior[2]};
  float terms[13], sums[13];
  for (int it = 0; it <= p.iterations; ++it) {
    build_canvasT(mxy, mnm, mvalid, M, T, s_mov, s_zmin, s_cnt, B, p);
    Fields fl;
    fl.d = s_mov[b];
    fl.px = s_mov[B + b]; fl.py = s_mov[2 * B + b];
    fl.nx = s_mov[3 * B + b]; fl.ny = s_mov[4 * B + b];
    fl.col = b; fl.okp = true;
    match_terms(fl, g, p, terms);
    block_sum<13>(terms, s_part, s_tot, sums);
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

extern "C" int projective_align(const float* fxy, const float* fnm,
                                const unsigned char* fvalid, int F, const float* mxy,
                                const float* mnm, const unsigned char* mvalid, int M,
                                const float* t0, const float* prior, float* out_t,
                                float* out_stats, float* out_iters,
                                const FrameParams* params, void* stream) {
  const FrameParams p = *params;
  if (p.B > 1024 || p.B % 128 || p.iterations > 128)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (14 * (size_t)p.B + 32 * 13 + 16);
  cudaError_t err = cudaFuncSetAttribute(
      projective_align_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  projective_align_kernel<<<1, p.B, smem, (cudaStream_t)stream>>>(
      fxy, fnm, fvalid, F, mxy, mnm, mvalid, M, t0, prior, out_t, out_stats, out_iters, p);
  return (int)cudaGetLastError();
}
