// K-stream fused tracking frame: K independent streams, T frames each, in
// ONE launch.
//
// Replaces srrg2_laser_slam_2d_tpu/ops/pallas_stream.py:track_streams_grid
// (pallas_call at :732, body _frame_body_b at :384; stream_step at :622 is
// the same kernel with T = 1).
//
// What bounds it on an H100: latency per stream, as for the single-stream
// kernel (frame_kernel.cu): a stream's frames form a sequential chain, each
// frame a chain of block-wide reductions and 3x3 solves (16 barriers a frame
// on one SM). For K = 32 streams over 255 frames the float32 operations come
// to about 0.118 ms and the bytes (canvas rows 0-5 in, payloads out, once
// each) to about 0.105 ms at the card's peaks; PERF.md has the time
// (chip_smoke.py) and where a frame's cycles go (bench/frame_phases.py).
//
// Design: the TPU packs K streams onto the eight sublanes of a vector
// register, because one 768-beam stream fills an eighth of it, and carries
// all K states through a sequential grid. Here the streams are simply
// independent blocks: grid (K), one persistent block per stream, no
// synchronisation between blocks; K above the card's 132 SMs runs in waves.
// Inside a block everything is the single-stream kernel's frame step
// (frame_loop of frame_common.cuh, whose header describes it): FRAME_BPT
// beams a thread, the passes over the valid cache lanes only, one barrier
// per reduction, the next frame's rows copied in while this one runs. A
// block finds its stream by strides in the TPU layouts: field rows of
// [.., 8, K, B] arrays lie K * B floats apart, so each of the 6 canvas rows
// is its own contiguous copy. Differences from the single-stream body, as
// in _frame_body_b:
//   - no local-map split; the stats row holds lanes 0-6 only; the pose block
//     is one row of 16 and odometry arrives in its own [T, K, 8] array;
//   - two gather bands: "onehot" matches a beam only inside the window of the
//     lane's 128-beam block (bk.window_start), "roll" while the beam lies
//     within +-band_shift of the lane, with no block window;
//   - corr_refresh r: the canvas cell gathered at an outer step stays frozen
//     for up to r Gauss-Newton updates, while the moving side and every gate
//     are re-evaluated at each new pose. Updates past `iterations` do not run
//     (the TPU masks them). The final pass always gathers afresh.
// The TPU's stream-major copy of the canvases (measCk_stack) only feeds its
// batched matrix unit and has no counterpart here.

#include "frame_common.cuh"

__global__ void __launch_bounds__(frame_threads(1024, FRAME_BPT), 1)
stream_track_kernel(const float* __restrict__ measC, const float* __restrict__ odoms,
                    const float* __restrict__ cache0, const float* __restrict__ pose0,
                    float* __restrict__ out_cache, float* __restrict__ out_pose,
                    float* __restrict__ payloads, FrameParams p) {
  extern __shared__ float smem[];
  frame_loop<FRAME_BPT, true>(smem, measC, odoms, cache0, pose0, out_cache, out_pose,
                              payloads, p);
}

extern "C" int stream_track_grid(const float* measC, const float* odoms, const float* cache0,
                                 const float* pose0, float* out_cache, float* out_pose,
                                 float* payloads, const FrameParams* params, void* stream) {
  const FrameParams p = *params;
  if (p.B > 1024 || p.B % 128 || p.window > p.B) return (int)cudaErrorInvalidValue;
  const size_t smem = frame_smem_bytes(p.B);
  cudaError_t err = cudaFuncSetAttribute(
      stream_track_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  stream_track_kernel<<<p.K, frame_threads(p.B, FRAME_BPT), smem, (cudaStream_t)stream>>>(
      measC, odoms, cache0, pose0, out_cache, out_pose, payloads, p);
  return (int)cudaGetLastError();
}

PHASE_EXPORT
