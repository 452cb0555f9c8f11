// The banded lane-gather probe: out[f][k][b] = sum over `iters` passes of
// canvas[f][k][idx[k][b]], where idx[k][b] lies within +-S lanes of b.
//
// Replaces the probe kernels of bench/exp_gather.py:61 (the pallas_call
// around body_take, body_take2d and body_roll: three Mosaic forms of one
// gather). The CUDA forms:
//   form 0, "direct": each thread reads its cell straight from global
//     memory in every pass (the take forms);
//   form 1, "roll": the block stages its row's 8 fields in shared memory
//     and each pass selects among the 2S + 1 shifted lanes the one whose
//     shift equals idx - lane (the roll form's select over shifts).
// Both add the same values in the same order, so they agree bit for bit
// with each other and with the plain version.
//
// Bound: 8 K B x 4 bytes in, as much out, K B x 4 of indices; 8 K B
// iters additions. Bytes bound it (under a microsecond at K = 32, B = 768
// on the card's memory). Design: one block per row k, one thread per lane
// (B <= 1024); the loads are volatile so that every pass gathers anew, as
// the probe intends, instead of the compiler hoisting them out of the loop.

#include <cuda_runtime.h>

__global__ void __launch_bounds__(1024)
gather_probe_kernel(const float* __restrict__ canvas, const int* __restrict__ idx,
                    float* __restrict__ out, int K, int B, int S, int iters, int form) {
  extern __shared__ float s_row[];   // [8][B], roll form only
  const int k = blockIdx.x, b = threadIdx.x;
  const int i = idx[k * B + b];
  float acc[8];
#pragma unroll
  for (int f = 0; f < 8; ++f) acc[f] = 0.0f;
  if (form == 0) {
    const volatile float* c = canvas;
    for (int t = 0; t < iters; ++t) {
#pragma unroll
      for (int f = 0; f < 8; ++f) acc[f] += c[((size_t)f * K + k) * B + i];
    }
  } else {
    for (int f = 0; f < 8; ++f) s_row[f * B + b] = canvas[((size_t)f * K + k) * B + b];
    __syncthreads();
    const volatile float* row = s_row;
    const int d = i - b;
    for (int t = 0; t < iters; ++t) {
      float g[8];
#pragma unroll
      for (int f = 0; f < 8; ++f) g[f] = 0.0f;
      for (int s = -S; s <= S; ++s) {
        const int j = ((b + s) % B + B) % B;     // the rolled lane, wrapping as a roll does
        const bool sel = d == s;
#pragma unroll
        for (int f = 0; f < 8; ++f) {
          const float v = row[f * B + j];
          g[f] = sel ? v : g[f];
        }
      }
#pragma unroll
      for (int f = 0; f < 8; ++f) acc[f] += g[f];
    }
  }
#pragma unroll
  for (int f = 0; f < 8; ++f) out[((size_t)f * K + k) * B + b] = acc[f];
}

extern "C" int gather_probe(const float* canvas, const int* idx, float* out, int K, int B,
                            int S, int iters, int form, void* stream) {
  if (K < 1 || B < 1 || B > 1024 || S < 0 || iters < 0 || (form != 0 && form != 1))
    return (int)cudaErrorInvalidValue;
  const size_t smem = form == 1 ? 8 * (size_t)B * sizeof(float) : 0;
  gather_probe_kernel<<<K, B, smem, (cudaStream_t)stream>>>(canvas, idx, out, K, B, S, iters,
                                                            form);
  return (int)cudaGetLastError();
}
