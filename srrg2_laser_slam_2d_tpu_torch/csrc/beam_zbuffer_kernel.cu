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
// launch is latency.
// Design: one block, one thread per lane (B <= 1024), the two shared-memory
// atomics of the frame kernel's lean merge (csrc/frame_common.cuh
// merge_lane): atomicMin on the depth bits, then atomicMax on the lane
// among the lanes at the minimum.

#include "frame_common.cuh"

__global__ void __launch_bounds__(1024, 1)
beam_zbuffer_kernel(const float* __restrict__ geoT, float* __restrict__ out, FrameParams p) {
  extern __shared__ int s_int[];
  const int B = p.B;
  int* s_zmin = s_int;                       // [B]
  int* s_win = s_int + B;                    // [B]
  float* s_px = (float*)(s_int + 2 * B);     // [B] each lane's moved point
  float* s_py = s_px + B;                    // [B]
  const int b = threadIdx.x;
  const float T[3] = {0.0f, 0.0f, 0.0f};
  const Fields fl = moving_fields(geoT[b], geoT[B + b], geoT[2 * B + b], geoT[3 * B + b],
                                  geoT[4 * B + b], T, p);
  s_zmin[b] = __float_as_int(kBig);
  s_win[b] = -1;
  s_px[b] = fl.px;
  s_py[b] = fl.py;
  __syncthreads();
  const bool elig = fl.okp && abs(fl.col - b) <= p.merge_shift;
  if (elig) atomicMin(&s_zmin[fl.col], __float_as_int(fl.d));   // d >= 0
  __syncthreads();
  if (elig && fl.d <= __int_as_float(s_zmin[fl.col])) atomicMax(&s_win[fl.col], b);
  __syncthreads();
  const float smin = __int_as_float(s_zmin[b]);
  const bool s_ok = smin < kBig;
  const int w = s_win[b];
  float px = 0.0f, py = 0.0f, pay = 0.0f;
  if (s_ok) {
    px = s_px[w];
    py = s_py[w];
    pay = geoT[5 * B + w];
  }
  out[b] = smin;
  out[B + b] = px;
  out[2 * B + b] = py;
  out[3 * B + b] = pay;
  out[4 * B + b] = s_ok ? 1.0f : 0.0f;
  out[5 * B + b] = 0.0f;
  out[6 * B + b] = 0.0f;
  out[7 * B + b] = 0.0f;
}

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
  beam_zbuffer_kernel<<<1, B, 4 * B * sizeof(int), (cudaStream_t)stream>>>(geoT, out, p);
  return (int)cudaGetLastError();
}
