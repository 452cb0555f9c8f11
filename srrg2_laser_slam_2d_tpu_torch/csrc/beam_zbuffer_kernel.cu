// The shift z-buffer probe: beam-indexed cells moved to their beams and
// z-buffered within a band of +-max_shift beams.
//
// Replaces the probe kernel of tests/test_fast_tracker.py:81
// (test_shift_zbuffer_matches_projector, kernel body :62-72).
//
// Input geoT [8][B]: rows x, y, nx, ny, valid, payload (the cell's home
// row), 0, 0; lane r is the cell last seen on beam r. Each lane is taken
// through moving_fields at the identity pose (depth, beam by the
// polynomial atan2, the projection gate) and counts for its beam only while
// |beam - r| <= max_shift. Per beam the closest depth wins; among lanes at
// that depth the HIGHEST lane wins (the order in which the TPU's roll
// enumeration -max_shift..+max_shift resolves ties). Output [8][B]: the
// winning depth (1e30 where no lane landed), the winner's x, y and payload
// (0 where none), has-winner, 0, 0, 0.
//
// Bound: a few hundred operations per lane over 14 x B floats (rows 0-5
// read, 8 rows written), far below a microsecond at the card's rates; a
// launch is latency: the launch itself, then one chain of dependent steps.
// Design: one block, one thread per lane (B <= 1024), the chain cut to
//   the zero rows 5-7 stored first and each lane's six inputs loaded
//     straight into registers (coalesced, all in flight at once) while the
//     block clears its slots;
//   the frame kernel's lean-merge z-buffer (frame_common.cuh merge_lane):
//     atomicMin on the depth bits, a barrier, atomicMax on the lane among
//     the lanes at the minimum, a barrier;
//   the winner's moved x, y and its payload read from shared memory, where
//     each lane left its own: no dependent load from global memory at the
//     end.
// Measured against the alternatives in turns on the card (bench/compare_csrc.py,
// PERF.md): one 64-bit atomicMin on (depth bits << 32 | 0xFFFFFFFF - lane),
// the same tie rule in one atomic phase and one barrier fewer, compiles to
// a compare-and-swap loop (ATOMS.CAST.SPIN.64) and is slower than the two
// native 32-bit phases; a bulk copy of rows 0-5 into shared memory
// (cp.async.bulk on an mbarrier) is slower than the loads into registers;
// so are vector stores of rows 0-4 through shared memory, and 2 or 4 lanes
// a thread with vector loads and stores.

#include "frame_common.cuh"

static size_t zbuffer_smem_bytes(int B) { return 5 * (size_t)B * sizeof(float); }

__global__ void __launch_bounds__(1024, 1)
beam_zbuffer_kernel(const float* __restrict__ geoT, float* __restrict__ out, FrameParams p) {
  extern __shared__ float s_f[];
  const int B = p.B, b = threadIdx.x;
  float* s_px = s_f;                          // [B] each lane's moved point
  float* s_py = s_f + B;                      // [B]
  float* s_pay = s_f + 2 * B;                 // [B] each lane's payload
  int* s_zmin = (int*)(s_f + 3 * B);          // [B]
  int* s_win = s_zmin + B;                    // [B]
  PHASE_BEGIN;
  out[5 * B + b] = 0.0f;
  out[6 * B + b] = 0.0f;
  out[7 * B + b] = 0.0f;
  const float x = geoT[b], y = geoT[B + b], nx = geoT[2 * B + b], ny = geoT[3 * B + b],
              v = geoT[4 * B + b], pay = geoT[5 * B + b];
  s_zmin[b] = __float_as_int(kBig);
  s_win[b] = -1;
  __syncthreads();
  PHASE(0);
  const float T[3] = {0.0f, 0.0f, 0.0f};
  const Fields fl = moving_fields(x, y, nx, ny, v, T, p);
  s_px[b] = fl.px;
  s_py[b] = fl.py;
  s_pay[b] = pay;
  const bool elig = fl.okp && abs(fl.col - b) <= p.merge_shift;
  if (elig) atomicMin(&s_zmin[fl.col], __float_as_int(fl.d));   // d >= 0
  PHASE(1);
  __syncthreads();
  if (elig && fl.d <= __int_as_float(s_zmin[fl.col])) atomicMax(&s_win[fl.col], b);
  PHASE(2);
  __syncthreads();
  PHASE(3);
  const float smin = __int_as_float(s_zmin[b]);
  const bool s_ok = smin < kBig;
  const int w = s_win[b];
  float px = 0.0f, py = 0.0f, wpay = 0.0f;
  if (s_ok) {
    px = s_px[w];
    py = s_py[w];
    wpay = s_pay[w];
  }
  out[b] = smin;
  out[B + b] = px;
  out[2 * B + b] = py;
  out[3 * B + b] = wpay;
  out[4 * B + b] = s_ok ? 1.0f : 0.0f;
  PHASE(4);
  PHASE_END;
}

// An empty kernel at the probe's launch shape (one block of B threads, the
// same shared memory): the launch's own device time, the floor under it.
__global__ void __launch_bounds__(1024, 1) beam_zbuffer_empty() {}

PHASE_EXPORT

extern "C" int beam_zbuffer(const float* geoT, float* out, int B, int cols, float f, float c,
                            float range_min, float range_max, int max_shift, void* stream) {
  if (B > 1024 || B % 128 || cols > B || max_shift < 0) return (int)cudaErrorInvalidValue;
  FrameParams p = {};
  p.B = B;
  p.cols = cols;
  p.f = f;
  p.c = c;
  p.range_min = range_min;
  p.range_max = range_max;
  p.merge_shift = max_shift;
  beam_zbuffer_kernel<<<1, B, zbuffer_smem_bytes(B), (cudaStream_t)stream>>>(geoT, out, p);
  return (int)cudaGetLastError();
}

extern "C" int beam_zbuffer_floor(int B, void* stream) {
  if (B > 1024 || B % 128) return (int)cudaErrorInvalidValue;
  beam_zbuffer_empty<<<1, B, zbuffer_smem_bytes(B), (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
