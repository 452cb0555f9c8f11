// Fused tracking frame: a whole chunk of T frames in ONE launch.
//
// Replaces srrg2_laser_slam_2d_tpu/ops/pallas_frame.py:track_frames_grid
// (pallas_call at :489, body _frame_body at :142; frame_step is the same
// kernel with T = 1), in both measurement layouts: the pre-z-buffered
// canvases [T, 8, B] (meas_as_canvas, what the SLAM loops use) and the raw
// rows [T, F, 8] (meas_as_canvas=False, the JAX package's parity oracle),
// whose z-buffer the kernel builds itself each frame (build_canvas_rows).
//
// What bounds it on an H100: latency, not bytes or FLOPs. The frames form a
// sequential chain (frame t+1 starts from frame t's pose and cache), and
// each frame is 11 banded Gauss-Newton passes over B = 768 beams, each
// ending in a block-wide reduction and a 3x3 solve, then the merge and the
// append scan: 16 block barriers per frame on one SM, and every instruction
// of the block issued by that SM's four schedulers. A 1024-frame chunk
// moves 50 MB and does 1.0 GFLOP, 15 us at the card's peaks; PERF.md has
// the time (chip_smoke.py) and where a frame's cycles go
// (bench/frame_phases.py).
//
// Design: one persistent block looping over the T frames inside the kernel,
// as the TPU grid iterated sequentially with the state in VMEM; the frame
// step is frame_loop of frame_common.cuh, shared with the K-stream kernel
// (stream_kernel.cu), whose header describes it: FRAME_BPT beams a thread,
// the passes over the valid cache lanes only, one barrier per reduction with
// bit-identical totals in every thread, the prior's constants once a frame,
// the next frame's canvas rows copied in (cp.async) while this one runs.
// The banded one-hot MXU gather of the TPU kernel becomes a direct
// shared-memory load of canvas[col_i], taken only while col_i lies in the
// 128-beam block's window (the TPU gather finds nothing outside it). The shift z-buffer becomes two shared-memory atomics
// (min depth, then max source lane among the depth winners: the TPU
// enumerates shifts -32..+32 with roll, so the highest source lane wins
// ties). Arithmetic follows the Pallas body operation by operation (built
// with --fmad=false), including the polynomial atan2, the 1e-20 determinant
// guard of pallas_projective_align._solve3_sym, the unwrapped SE(2) helpers
// and the uncapped seed slot on a split.

#include "frame_common.cuh"

__global__ void __launch_bounds__(frame_threads(1024, FRAME_BPT), 1)
frame_track_kernel(const float* __restrict__ meas, const float* __restrict__ cache0,
                   const float* __restrict__ pose0, float* __restrict__ out_cache,
                   float* __restrict__ out_pose, float* __restrict__ payloads,
                   FrameParams p) {
  extern __shared__ float smem[];
  frame_loop<FRAME_BPT, false>(smem, meas, nullptr, cache0, pose0, out_cache, out_pose,
                               payloads, p);
}

extern "C" int frame_track_grid(const float* meas, const float* cache0, const float* pose0,
                                float* out_cache, float* out_pose, float* payloads,
                                const FrameParams* params, void* stream) {
  const FrameParams p = *params;
  if (p.B > 1024 || p.B % 128 || p.window > p.B) return (int)cudaErrorInvalidValue;
  const size_t smem = frame_smem_bytes(p.B);
  cudaError_t err = cudaFuncSetAttribute(
      frame_track_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  frame_track_kernel<<<1, frame_threads(p.B, FRAME_BPT), smem, (cudaStream_t)stream>>>(
      meas, cache0, pose0, out_cache, out_pose, payloads, p);
  return (int)cudaGetLastError();
}

// The reduction of the frame step alone, for the card tests: each of
// `threads` threads contributes terms[thread][13]; two consecutive calls (both
// halves of the double buffer) write every thread's totals to
// out[call][thread][13], which must agree bit for bit across the block.
__global__ void block_sum13_kernel(const float* __restrict__ terms, float* __restrict__ out) {
  __shared__ float s_part[2 * 32 * 16];
  const int n = blockDim.x, i = threadIdx.x;
  float v[kTerms], tot[kTerms];
  for (int c = 0; c < 2; ++c) {
    for (int q = 0; q < kTerms; ++q) v[q] = terms[i * kTerms + q] * (c + 1);
    block_sum13(v, s_part, c, tot);
    for (int q = 0; q < kTerms; ++q) out[(c * n + i) * kTerms + q] = tot[q];
  }
}

extern "C" int frame_block_sum13(const float* terms, float* out, int threads, void* stream) {
  if (threads < 32 || threads > 1024 || threads % 32) return (int)cudaErrorInvalidValue;
  block_sum13_kernel<<<1, threads, 0, (cudaStream_t)stream>>>(terms, out);
  return (int)cudaGetLastError();
}

PHASE_EXPORT
