// The banded lane-gather probe: out[f][k][b] = sum over `iters` passes of
// canvas[f][k][idx[k][b]], where idx[k][b] lies within +-S lanes of b.
//
// Replaces the probe kernels of bench/exp_gather.py:61 (the pallas_call
// around body_take, body_take2d and body_roll: three Mosaic forms of one
// gather over a canvas held in VMEM). The CUDA forms:
//   form 0, "direct": each pass gathers the lane's cell from the row held
//     in shared memory (the take forms' take_along_axis on VMEM);
//   form 1, "roll": each pass reads all 2S + 1 shifted lanes of the row and
//     keeps the one whose shift equals idx - lane (the roll form's select
//     over shifts).
// Both add the same values in the same order, so they agree bit for bit
// with each other and with the plain version.
//
// Bound: 8 K B x 4 bytes in, as much out, K B x 4 of indices; 8 K B iters
// additions. Bytes bound the function (0.5 us at K = 32, B = 768 on the
// card's memory), so the direct form's time is the launch and one memory
// round trip. The roll form's own work is the shared-memory traffic of its
// shifts: 8 K B (2S + 1) iters loads of 4 bytes, at one 128-byte wavefront a
// cycle on each of the 132 SMs (0.030 ms at K = 32 and the 1,980 MHz
// maximum clock).
//
// Design: one block per canvas row (f, k), one thread per lane (B <= 1024):
// 8 K blocks, 256 at K = 32, two to an SM, so the grid fills the card in
// one wave. Thread 0 stages the row (B x 4 bytes) into shared memory with
// one bulk copy of Hopper's Tensor Memory Accelerator (cp.async.bulk,
// completed on an mbarrier in shared memory): one instruction where 16-byte
// cp.async would take B / 4 threads' addresses (measured slower), and the
// whole block waits on the barrier. Each thread loads its own lane's index
// straight into a register while the copy is in flight (no other thread
// reads it). The passes read shared memory through a volatile pointer, so
// every pass gathers anew, as the probe intends, instead of the compiler
// hoisting the load out of the loop. The roll form
// stages S lanes of halo on either side of the row (the lanes a roll wraps
// round), so a shift is a constant offset from the lane's own address: no
// wrap, no modulo in the loop.

#include "frame_common.cuh"   // PHASE_* (the -DFRAME_PHASE_TIMING build)

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// Thread 0 alone: initialise `bar` for one arrival and start copying `bytes`
// (a multiple of 16; both addresses 16-byte aligned) from `src` to `dst`.
// Phase 0 of `bar` completes when every byte has landed; a __syncthreads()
// then makes the barrier visible to the block before anyone waits on it.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
  const unsigned b = smem_u32(bar);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(b) : "memory");
  // the init, a generic-proxy write, visible to the copy engine's async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(b) : "memory");
}

// Wait until phase 0 of `bar` has completed (the copy has landed).
__device__ __forceinline__ void bulk_wait(unsigned long long* bar) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "BULK_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], 0;\n"
      "@p bra.uni BULK_DONE;\n"
      "bra.uni BULK_WAIT;\n"
      "BULK_DONE:\n"
      "}\n" ::"r"(smem_u32(bar)) : "memory");
}

// Halo lanes before the row: S rounded up to a multiple of 4, so that the
// row starts on a 16-byte boundary for the bulk copy.
static __host__ __device__ int gather_halo(int S, int form) {
  return form == 1 ? (S + 3) & ~3 : 0;
}

static size_t gather_smem_bytes(int B, int S, int form) {
  return sizeof(float) * ((size_t)gather_halo(S, form) + B + (form == 1 ? S : 0));
}

__global__ void __launch_bounds__(1024, 2)
gather_probe_kernel(const float* __restrict__ canvas, const int* __restrict__ idx,
                    float* __restrict__ out, int K, int B, int S, int iters, int form) {
  extern __shared__ __align__(16) float s_ext[];   // [H halo][B row][S halo]
  __shared__ unsigned long long s_bar;
  PHASE_BEGIN;
  const int r = blockIdx.x, k = r % K, b = threadIdx.x;   // row r = f * K + k
  const int H = gather_halo(S, form);
  const float* row = canvas + (size_t)r * B;
  if (b == 0) bulk_load(s_ext + H, row, B * sizeof(float), &s_bar);
  const int i = idx[(size_t)k * B + b];
  if (form == 1) {
    // the halo: lane j < 0 or j >= B holds row[j mod B], as a roll wraps
    for (int t = b; t < 2 * S; t += blockDim.x) {
      const int j = t < S ? t - S : B + t - S;
      s_ext[H + j] = row[((j % B) + B) % B];
    }
  }
  __syncthreads();   // the barrier's init and the halo, visible to every thread
  bulk_wait(&s_bar);
  PHASE(0);
  float acc = 0.0f;
  if (form == 0) {
    const volatile float* v = s_ext + H;
    for (int t = 0; t < iters; ++t) acc += v[i];
  } else {
    const volatile float* v = s_ext + H + b;   // v[s]: the lane rolled by s
    const int d = i - b;
    for (int t = 0; t < iters; ++t) {
      float g = 0.0f;
#pragma unroll 8
      for (int s = -S; s <= S; ++s) {
        const float x = v[s];
        g = d == s ? x : g;
      }
      acc += g;
    }
  }
  PHASE(1);
  out[(size_t)r * B + b] = acc;
  PHASE(2);
  PHASE_END;
}

// An empty kernel, launched at the probe's grid, block and shared memory:
// the launch's own device time, the floor under the probe's.
__global__ void __launch_bounds__(1024, 2) gather_probe_empty() {}

PHASE_EXPORT

static bool gather_args_ok(int K, int B, int S, int form) {
  return K >= 1 && B >= 4 && B <= 1024 && B % 4 == 0 && S >= 0 && (form == 0 || form == 1) &&
         gather_smem_bytes(B, S, form) <= 48 * 1024;
}

extern "C" int gather_probe(const float* canvas, const int* idx, float* out, int K, int B,
                            int S, int iters, int form, void* stream) {
  if (!gather_args_ok(K, B, S, form) || iters < 0) return (int)cudaErrorInvalidValue;
  gather_probe_kernel<<<8 * K, B, gather_smem_bytes(B, S, form), (cudaStream_t)stream>>>(
      canvas, idx, out, K, B, S, iters, form);
  return (int)cudaGetLastError();
}

extern "C" int gather_probe_floor(int K, int B, int S, int form, void* stream) {
  if (!gather_args_ok(K, B, S, form)) return (int)cudaErrorInvalidValue;
  gather_probe_empty<<<8 * K, B, gather_smem_bytes(B, S, form), (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
