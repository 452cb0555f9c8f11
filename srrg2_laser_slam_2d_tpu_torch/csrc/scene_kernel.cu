// Z-buffer canvas of a whole scene seen from a camera pose: per beam the
// closest depth, the winner's point and normal in the camera frame, and the
// winner's row in the scene.
//
// Replaces srrg2_laser_slam_2d_tpu/ops/pallas_scene.py:canvas_pallas
// (pallas_call at :159, body _chunked_zbuffer at :69), the kernel behind
// clip_projective_pallas and merge_projective_pallas.
//
// The TPU kernel walks the scene in chunks of `chunk` rows and carries the
// per-beam winner: inside a chunk the points tied at the minimum depth are
// averaged (a normalised one-hot product) and the winner row is the lowest
// index; a later chunk takes a beam only with a strictly smaller depth. So
// over the whole scene the winner ROW is the lowest index among the points
// at the beam's minimum depth, and the winner FIELDS are the mean over the
// points at that depth that share the winner row's chunk. Here:
//   pass 1  one 64-bit atomicMin per point on (depth bits << 32 | row):
//           minimum depth and, among equals, the lowest row;
//   pass 2  points at the minimum depth in the winner's chunk count
//           themselves;
//   pass 3  those points add field * (1 / count) to the beam (exact for one
//           or two tied points; three or more bitwise-equal depths on one
//           beam add in no fixed order and may differ in the last bit).
// Each pass recomputes the camera-frame point (the same arithmetic gives
// the same bits), so nothing is kept per point.
//
// Design: one block of 1024 threads, all per-beam state in shared memory
// (keys, counts and four field sums for B <= 1024 beams: 28 KB), each thread
// striding over the scene rows. 8,192 rows are 8 rows per thread and pass;
// the cosine and sine of the camera angle are computed once per thread, as
// the plain version computes them once per call.

#include "frame_common.cuh"

// Mirror of ops/scene_kernel.py:_SceneParams.
struct SceneParams {
  int n, B, cols, chunk;
  float f, c, range_min, range_max;
};

struct CamPoint {
  float x, y, nx, ny, d;
  int col;   // -1: not on the canvas
};

__device__ __forceinline__ CamPoint cam_point(const float* xy, const float* nm,
                                              const unsigned char* valid, int i, float cx,
                                              float cy, float cc, float cs,
                                              const SceneParams& p) {
  CamPoint r;
  const float wx = xy[2 * i] - cx, wy = xy[2 * i + 1] - cy;
  r.x = cc * wx + cs * wy;
  r.y = -cs * wx + cc * wy;
  r.nx = cc * nm[2 * i] + cs * nm[2 * i + 1];
  r.ny = -cs * nm[2 * i] + cc * nm[2 * i + 1];
  r.d = sqrtf(r.x * r.x + r.y * r.y);
  const float colf = floorf(atan2_poly(r.y, r.x) * p.f + p.c);
  const bool ok = valid[i] && (colf >= 0.0f) && (colf < (float)p.cols) &&
                  (r.d >= p.range_min) && (r.d <= p.range_max);
  r.col = ok ? (int)colf : -1;
  return r;
}

__global__ void __launch_bounds__(1024, 1)
scene_canvas_kernel(const float* __restrict__ xy, const float* __restrict__ nm,
                    const unsigned char* __restrict__ valid, const float* __restrict__ cam,
                    float* __restrict__ out, int* __restrict__ rows, SceneParams p) {
  __shared__ unsigned long long s_key[1024];
  __shared__ float s_cnt[1024];
  __shared__ float s_sum[4 * 1024];
  const int B = p.B;
  const float cx = cam[0], cy = cam[1];
  const float cc = cosf(cam[2]), cs = sinf(cam[2]);
  for (int b = threadIdx.x; b < B; b += blockDim.x) {
    s_key[b] = ~0ull;
    s_cnt[b] = 0.0f;
    s_sum[b] = 0.0f; s_sum[B + b] = 0.0f; s_sum[2 * B + b] = 0.0f; s_sum[3 * B + b] = 0.0f;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < p.n; i += blockDim.x) {
    const CamPoint q = cam_point(xy, nm, valid, i, cx, cy, cc, cs, p);
    if (q.col >= 0)
      atomicMin(&s_key[q.col],
                ((unsigned long long)__float_as_uint(q.d) << 32) | (unsigned int)i);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < p.n; i += blockDim.x) {
    const CamPoint q = cam_point(xy, nm, valid, i, cx, cy, cc, cs, p);
    if (q.col < 0) continue;
    const unsigned long long key = s_key[q.col];
    const int win = (int)(key & 0xffffffffull);
    if (q.d <= __uint_as_float((unsigned int)(key >> 32)) && i / p.chunk == win / p.chunk)
      atomicAdd(&s_cnt[q.col], 1.0f);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < p.n; i += blockDim.x) {
    const CamPoint q = cam_point(xy, nm, valid, i, cx, cy, cc, cs, p);
    if (q.col < 0) continue;
    const unsigned long long key = s_key[q.col];
    const int win = (int)(key & 0xffffffffull);
    if (q.d <= __uint_as_float((unsigned int)(key >> 32)) && i / p.chunk == win / p.chunk) {
      const float inv = 1.0f / s_cnt[q.col];
      atomicAdd(&s_sum[q.col], q.x * inv);
      atomicAdd(&s_sum[B + q.col], q.y * inv);
      atomicAdd(&s_sum[2 * B + q.col], q.nx * inv);
      atomicAdd(&s_sum[3 * B + q.col], q.ny * inv);
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < B; b += blockDim.x) {
    const unsigned long long key = s_key[b];
    const bool has = key != ~0ull;
    out[b] = has ? __uint_as_float((unsigned int)(key >> 32)) : kBig;
    out[B + b] = s_sum[b];
    out[2 * B + b] = s_sum[B + b];
    out[3 * B + b] = s_sum[2 * B + b];
    out[4 * B + b] = s_sum[3 * B + b];
    out[5 * B + b] = has ? 1.0f : 0.0f;
    rows[b] = has ? (int)(key & 0xffffffffull) : -1;
  }
}

extern "C" int scene_canvas(const float* xy, const float* nm, const unsigned char* valid,
                            const float* cam, float* out, int* rows,
                            const SceneParams* params, void* stream) {
  const SceneParams p = *params;
  if (p.B > 1024 || p.chunk <= 0) return (int)cudaErrorInvalidValue;
  scene_canvas_kernel<<<1, 1024, 0, (cudaStream_t)stream>>>(xy, nm, valid, cam, out, rows, p);
  return (int)cudaGetLastError();
}
