// Z-buffered polar projection of a sensor-frame cloud: per beam the closest
// depth and the index of the point that holds it.
//
// Replaces srrg2_laser_slam_2d_tpu/ops/pallas_projector.py:project_local_pallas
// (pallas_call at :131). The TPU kernel compares a [chunk, beams] tile per
// chunk of points and keeps the first argmin; here every point goes straight
// to its beam with ONE 64-bit atomicMin on the key (depth bits << 32 | point
// index): the bits of a non-negative float order as integers, so the closest
// depth wins and, among equal depths, the lowest index, which is the
// reference's tie rule.
//
// Design: one block of 1024 threads, the keys of all beams in shared memory
// (B <= 1024 beams, 8 KB), each thread striding over the points. A scene of
// 8,192 points is 8 points per thread; the work is far too small to gain
// from more blocks, which would need a second launch to decode the keys.
// Beam assignment uses the kernels' polynomial arctangent, not atan2f: a
// point on a beam-bin edge would move otherwise.

#include "frame_common.cuh"

// Mirror of ops/projector_kernel.py:_ProjectorParams.
struct ProjectorParams {
  int n, B, cols;
  float f, c, range_min, range_max;
};

__global__ void __launch_bounds__(1024, 1)
project_local_kernel(const float* __restrict__ xy, const unsigned char* __restrict__ valid,
                     float* __restrict__ depth, int* __restrict__ idx, ProjectorParams p) {
  __shared__ unsigned long long s_key[1024];
  for (int b = threadIdx.x; b < p.B; b += blockDim.x) s_key[b] = ~0ull;
  __syncthreads();
  for (int i = threadIdx.x; i < p.n; i += blockDim.x) {
    const float x = xy[2 * i], y = xy[2 * i + 1];
    const float d = sqrtf(x * x + y * y);
    const float colf = floorf(atan2_poly(y, x) * p.f + p.c);
    const bool ok = valid[i] && (colf >= 0.0f) && (colf < (float)p.cols) &&
                    (d >= p.range_min) && (d <= p.range_max);
    if (ok) {
      const unsigned long long key =
          ((unsigned long long)__float_as_uint(d) << 32) | (unsigned int)i;
      atomicMin(&s_key[(int)colf], key);
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < p.B; b += blockDim.x) {
    const unsigned long long key = s_key[b];
    const bool has = key != ~0ull;
    depth[b] = has ? __uint_as_float((unsigned int)(key >> 32)) : kBig;
    idx[b] = has ? (int)(key & 0xffffffffull) : -1;
  }
}

extern "C" int project_local(const float* xy, const unsigned char* valid, float* depth,
                             int* idx, const ProjectorParams* params, void* stream) {
  const ProjectorParams p = *params;
  if (p.B > 1024) return (int)cudaErrorInvalidValue;
  project_local_kernel<<<1, 1024, 0, (cudaStream_t)stream>>>(xy, valid, depth, idx, p);
  return (int)cudaGetLastError();
}
