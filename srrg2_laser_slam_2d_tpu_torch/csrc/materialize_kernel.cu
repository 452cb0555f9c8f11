// Fold a batch of frame payloads into their scenes: for each scene row the
// last write wins (the live lane with the highest flat index t * B + b), the
// other rows keep the old scene, and the first `final_count` rows are valid.
//
// Replaces no Pallas kernel: the JAX package's fast_tracker.materialize is
// XLA code (two sorts and one scatter). The port's plain version
// (ops/materialize_kernel.py:materialize_plain) is generic PyTorch: int64
// copies of payload rows 4 and 5, an int64 scatter_reduce("amax") over every
// lane, a permuted copy of rows 0-3 and a gather, some ten launches that
// move the payload several times.
//
// What bounds it: bytes. Rows 4 (target row) and 5 (kind) of every lane are
// read once (8 bytes a lane), then rows 0-3 of each scene row's winner only
// (16 bytes), the old scene where there is none, and the new scene written
// (17 bytes a row). At the fleet's K = 128, T = 255, B = 768, cap 4,096 that
// is some 227 MB, 0.068 ms at 3.35 TB/s. Design, for that:
//   * the payload is read through its strides, so the fleet's [T, 8, K, B]
//     kernel layout handed in as a movedim view is never copied; rows 4 and
//     5 are loaded with streaming loads, UNROLL lanes a thread in flight;
//   * the winner key t * B + b fits in 32 bits (the wrapper refuses
//     T * B >= 2^31), so one 32-bit atomicMax on an int table of `cap`
//     entries in shared memory picks it (16 KB at cap 4,096, 32 KB at 8,192);
//     the row's float is truncated with __float2ll_rz, the instruction
//     PyTorch's .to(torch.int64) compiles to on the card, so NaN, negative,
//     too large and non-integer rows are live or dead as in the plain version;
//   * nothing is summed, only chosen: the scene's floats are the plain
//     version's bit for bit;
//   * the grid follows the number of scenes S (blocks_per_scene in the
//     wrapper): with S at least half the SMs one block a scene does it all
//     in one launch (lanes into its shared table, then its rows); with few
//     scenes each scene's lanes are split over G blocks, each writes its
//     whole shared table to a [S, G, cap] partial table in device memory
//     (every entry, so nothing needs clearing), and a second launch takes
//     each row's maximum over the G partials and writes the row. Both paths
//     share scan_lanes and write_row: one winner rule, one index arithmetic.
// Inputs are never written; the outputs are fresh tensors.

#include <cuda_runtime.h>

// Mirror of ops/materialize_kernel.py:_MaterializeParams.
struct MaterializeParams {
  long long pay_stride[4];   // payload [S, T, 8, B]: scene, frame, row, lane (elements)
  long long xy_stride[3];    // old scene xy [S, cap, 2]: scene, row, coordinate
  long long nm_stride[3];    // old scene normals, the same
  long long count_stride;    // final_count [S]
  int S, T, B, cap;
  int blocks_per_scene;      // G: 1 = one launch, one block a scene
  int count_dtype;           // 0 float32, 1 int64
};

constexpr int kThreads = 1024;
constexpr int kRowThreads = 256;
constexpr int UNROLL = 8;

__device__ __forceinline__ long long read_count(const void* counts, const MaterializeParams& p,
                                                int s) {
  const long long off = (long long)s * p.count_stride;
  return p.count_dtype == 0 ? __float2ll_rz(static_cast<const float*>(counts)[off])
                            : static_cast<const long long*>(counts)[off];
}

// Lanes [begin, end) of scene s (flat index t * B + b) into the shared table:
// tab[row] = the highest live flat index that targets row.
// (Loop indices are 64-bit so that they never wrap near 2^31; a lane's own
// index is below T * B < 2^31 and is taken as an int.)
__device__ __forceinline__ void scan_lanes(const float* __restrict__ pay,
                                           const MaterializeParams& p, int s, long long begin,
                                           long long end, int* tab) {
  const float* ps = pay + (long long)s * p.pay_stride[0];
  const long long sT = p.pay_stride[1], sC = p.pay_stride[2], sB = p.pay_stride[3];
  const long long step = (long long)UNROLL * blockDim.x;
  for (long long base = begin + threadIdx.x; base < end; base += step) {
    float row[UNROLL], kind[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long i = base + (long long)u * blockDim.x;
      row[u] = -1.0f;
      kind[u] = 0.0f;
      if (i < end) {
        const int t = (int)i / p.B, b = (int)i - t * p.B;
        const float* q = ps + (long long)t * sT + (long long)b * sB;
        row[u] = __ldcs(q + 4 * sC);
        kind[u] = __ldcs(q + 5 * sC);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long i = base + (long long)u * blockDim.x;
      const long long r = __float2ll_rz(row[u]);
      if (i < end && kind[u] > 0.0f && r >= 0 && r < p.cap) atomicMax(tab + (int)r, (int)i);
    }
  }
}

// Row r of scene s: the winner's payload rows 0-3, else the old scene.
__device__ __forceinline__ void write_row(const float* __restrict__ pay,
                                          const float* __restrict__ xy,
                                          const float* __restrict__ nm,
                                          const MaterializeParams& p, int s, int r, int w,
                                          long long count, float2* xy_out, float2* nm_out,
                                          bool* valid_out) {
  float2 a, n;
  if (w >= 0) {
    const int t = w / p.B, b = w - t * p.B;
    const long long sC = p.pay_stride[2];
    const float* q = pay + (long long)s * p.pay_stride[0] + (long long)t * p.pay_stride[1] +
                     (long long)b * p.pay_stride[3];
    a = make_float2(q[0], q[sC]);
    n = make_float2(q[2 * sC], q[3 * sC]);
  } else {
    const float* qa = xy + (long long)s * p.xy_stride[0] + (long long)r * p.xy_stride[1];
    const float* qn = nm + (long long)s * p.nm_stride[0] + (long long)r * p.nm_stride[1];
    a = make_float2(qa[0], qa[p.xy_stride[2]]);
    n = make_float2(qn[0], qn[p.nm_stride[2]]);
  }
  const long long o = (long long)s * p.cap + r;
  xy_out[o] = a;
  nm_out[o] = n;
  valid_out[o] = r < count;
}

__device__ __forceinline__ void clear_table(int* tab, int cap) {
  for (int r = threadIdx.x; r < cap; r += blockDim.x) tab[r] = -1;
  __syncthreads();
}

// One block a scene: all its lanes, then all its rows.
__global__ void __launch_bounds__(kThreads)
materialize_scene_kernel(const float* __restrict__ pay, const float* __restrict__ xy,
                         const float* __restrict__ nm, const void* __restrict__ counts,
                         float2* xy_out, float2* nm_out, bool* valid_out,
                         const MaterializeParams p) {
  extern __shared__ int tab[];
  const int s = blockIdx.x;
  clear_table(tab, p.cap);
  scan_lanes(pay, p, s, 0, (long long)p.T * p.B, tab);
  __syncthreads();
  const long long count = read_count(counts, p, s);
  for (int r = threadIdx.x; r < p.cap; r += blockDim.x)
    write_row(pay, xy, nm, p, s, r, tab[r], count, xy_out, nm_out, valid_out);
}

// G blocks a scene (grid G x S): block g takes lanes [L g / G, L (g + 1) / G)
// and writes its whole table to partial[s, g, :].
__global__ void __launch_bounds__(kThreads)
materialize_lanes_kernel(const float* __restrict__ pay, int* __restrict__ partial,
                         const MaterializeParams p) {
  extern __shared__ int tab[];
  const int s = blockIdx.y, g = blockIdx.x, G = p.blocks_per_scene;
  const long long L = (long long)p.T * p.B;
  clear_table(tab, p.cap);
  scan_lanes(pay, p, s, L * g / G, L * (g + 1) / G, tab);
  __syncthreads();
  int* out = partial + ((long long)s * G + g) * p.cap;
  for (int r = threadIdx.x; r < p.cap; r += blockDim.x) out[r] = tab[r];
}

// One thread a scene row: the maximum over the G partial tables, then the row.
__global__ void __launch_bounds__(kRowThreads)
materialize_rows_kernel(const float* __restrict__ pay, const float* __restrict__ xy,
                        const float* __restrict__ nm, const void* __restrict__ counts,
                        const int* __restrict__ partial, float2* xy_out, float2* nm_out,
                        bool* valid_out, const MaterializeParams p) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)p.S * p.cap) return;
  const int s = (int)(idx / p.cap), r = (int)(idx - (long long)s * p.cap);
  const int G = p.blocks_per_scene;
  const int* col = partial + (long long)s * G * p.cap + r;
  int w = -1;
  for (int g = 0; g < G; ++g) w = max(w, col[(long long)g * p.cap]);
  write_row(pay, xy, nm, p, s, r, w, read_count(counts, p, s), xy_out, nm_out, valid_out);
}

template <typename K>
static cudaError_t allow_shared(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

extern "C" int materialize_scenes(const float* pay, const float* xy, const float* nm,
                                  const void* counts, float* xy_out, float* nm_out,
                                  bool* valid_out, int* partial,
                                  const MaterializeParams* params, void* stream) {
  const MaterializeParams p = *params;
  const int G = p.blocks_per_scene;
  if (p.S < 1 || p.T < 0 || p.B < 1 || p.cap < 0 || G < 1 || (G > 1 && p.S > 65535) ||
      (long long)p.T * p.B >= (1LL << 31) || p.count_dtype < 0 || p.count_dtype > 1 ||
      (G > 1 && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = (size_t)p.cap * sizeof(int);
  float2* xo = reinterpret_cast<float2*>(xy_out);
  float2* no = reinterpret_cast<float2*>(nm_out);
  cudaError_t err;
  if (G == 1) {
    if ((err = allow_shared(materialize_scene_kernel, smem)) != cudaSuccess) return (int)err;
    materialize_scene_kernel<<<p.S, kThreads, smem, st>>>(pay, xy, nm, counts, xo, no,
                                                          valid_out, p);
    return (int)cudaGetLastError();
  }
  if ((err = allow_shared(materialize_lanes_kernel, smem)) != cudaSuccess) return (int)err;
  materialize_lanes_kernel<<<dim3(G, p.S), kThreads, smem, st>>>(pay, partial, p);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long rows = (long long)p.S * p.cap;
  if (rows == 0) return (int)cudaSuccess;
  materialize_rows_kernel<<<(unsigned)((rows + kRowThreads - 1) / kRowThreads), kRowThreads, 0,
                            st>>>(pay, xy, nm, counts, partial, xo, no, valid_out, p);
  return (int)cudaGetLastError();
}
