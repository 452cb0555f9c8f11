// Device functions shared by the beam-space kernels: the fused
// tracking-frame kernels frame_kernel.cu (one stream, with the local-map
// split) and stream_kernel.cu (K independent streams, gather backends and
// correspondence refresh), and the two aligners banded_align_kernel.cu and
// projective_align_kernel.cu. The arithmetic follows the Pallas bodies
// (ops/pallas_frame.py:_frame_body, ops/pallas_stream.py:_frame_body_b,
// ops/pallas_banded_align.py, ops/pallas_projective_align.py) operation by
// operation; every source is built with --fmad=false.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#define F32(x) ((float)(x))

// Mirror of ops/frame_kernel.py:_FrameParams. K, gather_roll, band_shift and
// corr_refresh are read by the K-stream kernel only.
struct FrameParams {
  int T, B, cols, iterations, merge_shift, window, use_prior, use_split;
  int K, gather_roll, band_shift, corr_refresh;
  float f, c, range_min, range_max, merge_range, cap, point_distance,
      normal_cos, chi_threshold, min_inliers, odom_weight, merge_threshold,
      split_distance;
};

static __device__ const float kBig = 1.0e30f;

__device__ __forceinline__ float atan2_poly(float y, float x) {
  float ax = fabsf(x), ay = fabsf(y);
  float hi = fmaxf(ax, ay), lo = fminf(ax, ay);
  float t = lo / fmaxf(hi, F32(1e-30));
  float s = t * t;
  float r = t * (F32(0.9999993329) + s * (F32(-0.3332985605) + s * (F32(0.1994653599) +
                 s * (F32(-0.1390853351) + s * (F32(0.0964200441) + s * (F32(-0.0559098861) +
                 s * (F32(0.0218612288) + s * F32(-0.0040454090))))))));
  if (ay > ax) r = F32(1.5707963267948966) - r;
  if (x < 0.0f) r = F32(3.141592653589793) - r;
  return (y < 0.0f) ? -r : r;
}

// unwrapped SE(2) helpers (ops/_beam_kernels.py compose_s / inverse_s)
__device__ __forceinline__ void compose_s(const float* a, const float* b, float* o) {
  float ca = cosf(a[2]), sa = sinf(a[2]);
  float o0 = a[0] + ca * b[0] - sa * b[1];
  float o1 = a[1] + sa * b[0] + ca * b[1];
  float o2 = a[2] + b[2];
  o[0] = o0; o[1] = o1; o[2] = o2;
}

__device__ __forceinline__ void inverse_s(const float* a, float* o) {
  float c = cosf(a[2]), s = sinf(a[2]);
  float o0 = -(c * a[0] + s * a[1]);
  float o1 = -(-s * a[0] + c * a[1]);
  o[0] = o0; o[1] = o1; o[2] = -a[2];
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Block sum of NV values; every thread gets the totals in out[].
// part: [32 * NV] shared scratch, tot: [NV] shared.
template <int NV>
__device__ void block_sum(float* v, float* part, float* tot, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int k = 0; k < NV; ++k) v[k] = warp_sum(v[k]);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < NV; ++k) part[warp * NV + k] = v[k];
  }
  __syncthreads();
  if (threadIdx.x < NV) {
    float acc = 0.0f;
    for (int w = 0; w < nwarps; ++w) acc += part[w * NV + threadIdx.x];
    tot[threadIdx.x] = acc;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < NV; ++k) out[k] = tot[k];
}

// Inclusive block scan of two integer lanes; returns the totals.
__device__ void block_scan2(int& a, int& b, int* wsum, int& tot_a, int& tot_b) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    int ua = __shfl_up_sync(0xffffffffu, a, o);
    int ub = __shfl_up_sync(0xffffffffu, b, o);
    if (lane >= o) { a += ua; b += ub; }
  }
  if (lane == 31) { wsum[warp] = a; wsum[32 + warp] = b; }
  __syncthreads();
  int off_a = 0, off_b = 0;
  tot_a = 0; tot_b = 0;
  for (int w = 0; w < nwarps; ++w) {
    if (w < warp) { off_a += wsum[w]; off_b += wsum[32 + w]; }
    tot_a += wsum[w]; tot_b += wsum[32 + w];
  }
  a += off_a; b += off_b;
  __syncthreads();
}

struct Fields {
  float px, py, nx, ny, d;
  int col;
  bool okp;
};

__device__ __forceinline__ Fields moving_fields(float mx, float my, float mnx, float mny,
                                                float mv, const float* T, const FrameParams& p) {
  Fields r;
  float c = cosf(T[2]), s = sinf(T[2]);
  r.px = c * mx - s * my + T[0];
  r.py = s * mx + c * my + T[1];
  r.nx = c * mnx - s * mny;
  r.ny = s * mnx + c * mny;
  r.d = sqrtf(r.px * r.px + r.py * r.py);
  float colf = floorf(atan2_poly(r.py, r.px) * p.f + p.c);
  r.okp = (mv > 0.0f) && (colf >= 0.0f) && (colf < (float)p.cols) &&
          (r.d >= p.range_min) && (r.d <= p.range_max);
  r.col = r.okp ? (int)colf : -1;
  return r;
}

// Dense z-buffer of a cloud of n rows (xy, normal: [n][2]; valid: bytes)
// into canvas rows [6][B] in shared memory (ops/_beam_kernels.py
// build_canvasT): per beam the closest depth (kBig where empty), the mean of
// x, y, nx, ny over the points tied at that depth (each added as v * (1 /
// count), as the TPU's normalised one-hot product does; exact for one or two
// tied points, order-dependent in the last bit for three or more) and
// has-point. With T != nullptr the rows are first moved by the pose T
// (moving_fields), else they are taken as they are (the identity camera).
// s_zmin [B] and s_cnt [B] are shared scratch; all threads call.
__device__ __forceinline__ Fields canvas_point(const float* xy, const float* nm,
                                               const unsigned char* valid, int i,
                                               const float* T, const FrameParams& p) {
  const float mv = valid[i] ? 1.0f : 0.0f;
  if (T != nullptr)
    return moving_fields(xy[2 * i], xy[2 * i + 1], nm[2 * i], nm[2 * i + 1], mv, T, p);
  Fields r;
  r.px = xy[2 * i]; r.py = xy[2 * i + 1]; r.nx = nm[2 * i]; r.ny = nm[2 * i + 1];
  r.d = sqrtf(r.px * r.px + r.py * r.py);
  float colf = floorf(atan2_poly(r.py, r.px) * p.f + p.c);
  r.okp = (mv > 0.0f) && (colf >= 0.0f) && (colf < (float)p.cols) &&
          (r.d >= p.range_min) && (r.d <= p.range_max);
  r.col = r.okp ? (int)colf : -1;
  return r;
}

__device__ __forceinline__ void build_canvasT(const float* xy, const float* nm,
                                              const unsigned char* valid, int n,
                                              const float* T, float* s_canvas, int* s_zmin,
                                              float* s_cnt, int B, const FrameParams& p) {
  for (int b = threadIdx.x; b < B; b += blockDim.x) {
    s_zmin[b] = __float_as_int(kBig);
    s_cnt[b] = 0.0f;
    s_canvas[B + b] = 0.0f; s_canvas[2 * B + b] = 0.0f;
    s_canvas[3 * B + b] = 0.0f; s_canvas[4 * B + b] = 0.0f;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const Fields fl = canvas_point(xy, nm, valid, i, T, p);
    if (fl.okp) atomicMin(&s_zmin[fl.col], __float_as_int(fl.d));   // d >= 0
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const Fields fl = canvas_point(xy, nm, valid, i, T, p);
    if (fl.okp && fl.d <= __int_as_float(s_zmin[fl.col])) atomicAdd(&s_cnt[fl.col], 1.0f);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const Fields fl = canvas_point(xy, nm, valid, i, T, p);
    if (fl.okp && fl.d <= __int_as_float(s_zmin[fl.col])) {
      const float inv = 1.0f / s_cnt[fl.col];
      atomicAdd(&s_canvas[B + fl.col], fl.px * inv);
      atomicAdd(&s_canvas[2 * B + fl.col], fl.py * inv);
      atomicAdd(&s_canvas[3 * B + fl.col], fl.nx * inv);
      atomicAdd(&s_canvas[4 * B + fl.col], fl.ny * inv);
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < B; b += blockDim.x) {
    s_canvas[b] = __int_as_float(s_zmin[b]);
    s_canvas[5 * B + b] = (s_cnt[b] > 0.0f) ? 1.0f : 0.0f;
  }
  __syncthreads();
}

// A moving lane's matched canvas cell: depth, point, normal, has-point.
// All zero where the lane found nothing in its band (as the TPU gathers).
struct Gathered {
  float bmin, bfx, bfy, bfnx, bfny, bhas;
};

// canvas: [6][B] rows in shared memory; hot: the lane's beam lies in its band.
__device__ __forceinline__ Gathered gather_canvas(const float* canvas, int B, int col, bool hot) {
  Gathered g = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (hot) {
    g.bmin = canvas[col];
    g.bfx = canvas[B + col];
    g.bfy = canvas[2 * B + col];
    g.bfnx = canvas[3 * B + col];
    g.bfny = canvas[4 * B + col];
    g.bhas = canvas[5 * B + col];
  }
  return g;
}

// The single-stream band: the beam must lie in the window of the lane's
// 128-beam block (window start w0), where the one-hot gather looks.
__device__ __forceinline__ bool in_block_window(const Fields& fl, int w0, int window) {
  const int local = fl.col - w0;
  return fl.okp && local >= 0 && local < window;
}

// The 13 per-lane terms of banded_stats (ops/_beam_kernels.py) from a
// gathered cell and the lane's moving fields.
__device__ __forceinline__ void match_terms(const Fields& fl, const Gathered& g,
                                            const FrameParams& p, float* t) {
  const float bmin = g.bmin, bfx = g.bfx, bfy = g.bfy, bfnx = g.bfnx, bfny = g.bfny,
              bhas = g.bhas;
  bool close = fabsf(bmin - fl.d) <= p.point_distance;
  float ndot = bfnx * fl.nx + bfny * fl.ny;
  bool ok = (bhas > 0.5f) && close && (ndot >= p.normal_cos);
  float e1 = bfnx * (fl.px - bfx) + bfny * (fl.py - bfy);
  float e2 = fl.nx - bfnx;
  float e3 = fl.ny - bfny;
  float chi = e1 * e1 + e2 * e2 + e3 * e3;
  float w = 1.0f;
  if (p.chi_threshold > 0.0f)
    w = (chi < p.chi_threshold) ? 1.0f : p.chi_threshold / fmaxf(chi, F32(1e-20));
  if (!ok) w = 0.0f;
  float okf = ok ? 1.0f : 0.0f;
  float j1c = bfnx * (-fl.py) + bfny * fl.px;
  float sn2 = fl.nx * fl.nx + fl.ny * fl.ny;
  float thr = p.chi_threshold > 0.0f ? p.chi_threshold : kBig;
  float inl = okf * ((chi < thr) ? 1.0f : 0.0f);
  t[0] = w * bfnx * bfnx;
  t[1] = w * bfnx * bfny;
  t[2] = w * bfnx * j1c;
  t[3] = w * bfny * bfny;
  t[4] = w * bfny * j1c;
  t[5] = w * (j1c * j1c + sn2);
  t[6] = w * bfnx * e1;
  t[7] = w * bfny * e1;
  t[8] = w * (j1c * e1 - fl.ny * e2 + fl.nx * e3);
  t[9] = okf;
  t[10] = okf * chi;
  t[11] = inl * chi;
  t[12] = inl;
}

// The odometry prior (bk.add_odom_prior) at prior P and estimate T, weight
// w, added to the normal equations h = [h00 h01 h02 h11 h12 h22 b0 b1 b2].
__device__ __forceinline__ void add_odom_prior(float* h, const float* P, const float* T,
                                               float w) {
  float ca = cosf(-P[2]), sa = sinf(-P[2]);
  float atx = -(cosf(P[2]) * P[0] + sinf(P[2]) * P[1]);
  float aty = -(-sinf(P[2]) * P[0] + cosf(P[2]) * P[1]);
  float ex = atx + ca * T[0] - sa * T[1];
  float ey = aty + sa * T[0] + ca * T[1];
  float et = T[2] - P[2];
  float jx2 = ca * -T[1] - sa * T[0];
  float jy2 = sa * -T[1] + ca * T[0];
  h[0] = h[0] + w * (ca * ca + sa * sa);
  h[2] = h[2] + w * (ca * jx2 + sa * jy2);
  h[3] = h[3] + w * (ca * ca + sa * sa);
  h[4] = h[4] + w * (-sa * jx2 + ca * jy2);
  h[5] = h[5] + w * (jx2 * jx2 + jy2 * jy2 + 1.0f);
  h[6] = h[6] + w * (ca * ex + sa * ey);
  h[7] = h[7] + w * (-sa * ex + ca * ey);
  h[8] = h[8] + w * (jx2 * ex + jy2 * ey + et);
}

// Cramer solve of H dx = -b (|det| <= 1e-20 gives 0) from the normal
// equations h as above, then T <- dx * T (unwrapped) where `guard` holds.
__device__ __forceinline__ void cramer_step(const float* h, bool guard, float* T) {
  float a00 = h[0], a01 = h[1], a02 = h[2], a11 = h[3], a12 = h[4], a22 = h[5];
  float a10 = a01, a20 = a02, a21 = a12;
  float r0 = -h[6], r1 = -h[7], r2 = -h[8];
  float det = a00 * (a11 * a22 - a12 * a21) - a01 * (a10 * a22 - a12 * a20) +
              a02 * (a10 * a21 - a11 * a20);
  float inv_det = (fabsf(det) > F32(1e-20)) ? 1.0f / det : 0.0f;
  float x0 = ((a11 * a22 - a12 * a21) * r0 + (a02 * a21 - a01 * a22) * r1 +
              (a01 * a12 - a02 * a11) * r2) * inv_det;
  float x1 = ((a12 * a20 - a10 * a22) * r0 + (a00 * a22 - a02 * a20) * r1 +
              (a02 * a10 - a00 * a12) * r2) * inv_det;
  float x2 = ((a10 * a21 - a11 * a20) * r0 + (a01 * a20 - a00 * a21) * r1 +
              (a00 * a11 - a01 * a10) * r2) * inv_det;
  float dx[3] = {guard ? x0 : 0.0f, guard ? x1 : 0.0f, guard ? x2 : 0.0f};
  float Tn[3];
  compose_s(dx, T, Tn);
  T[0] = Tn[0]; T[1] = Tn[1]; T[2] = Tn[2];
}

// One GN update from the 13 sums: odometry prior, Cramer solve, inlier
// guard, pre-multiplied compose (unwrapped).
__device__ __forceinline__ void gn_update(const float* s, const float* T0, float* T,
                                          const FrameParams& p) {
  float h[9] = {s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8]};
  if (p.use_prior) add_odom_prior(h, T0, T, p.odom_weight);
  cramer_step(h, s[9] >= p.min_inliers, T);
}

// The lean beam-window merge of one beam, shared by both kernels: the
// measurement cell against the z-buffered cache cell that landed on it.
struct MergeLane {
  bool m_ok, s_ok, do_merge, modify, do_append;
  float upd_px, upd_py, upd_nx, upd_ny;   // the cell the scene receives (sensor frame)
  float spx, spy, snx, sny, srow;          // the cache cell seen on this beam
};

// Shift z-buffer of the transformed cache lanes (two shared-memory atomics:
// min depth, then the highest source lane among the depth winners, which is
// the order the TPU's roll enumeration -shift..+shift resolves ties in),
// then the per-beam merge decision against the measurement canvas.
// s_src [5][B], s_zmin [B], s_win [B] are shared scratch; all threads call.
__device__ __forceinline__ MergeLane merge_lane(const Fields& fl, float crow,
                                                const float* s_canvas, float* s_src,
                                                int* s_zmin, int* s_win, int B,
                                                const FrameParams& p) {
  const int b = threadIdx.x;
  s_zmin[b] = __float_as_int(kBig);
  s_win[b] = -1;
  s_src[b] = fl.px;
  s_src[B + b] = fl.py;
  s_src[2 * B + b] = fl.nx;
  s_src[3 * B + b] = fl.ny;
  s_src[4 * B + b] = crow;
  __syncthreads();
  const bool elig = fl.okp && crow >= 0.0f && abs(fl.col - b) <= p.merge_shift;
  if (elig) atomicMin(&s_zmin[fl.col], __float_as_int(fl.d));   // d >= 0
  __syncthreads();
  if (elig && fl.d <= __int_as_float(s_zmin[fl.col])) atomicMax(&s_win[fl.col], b);
  __syncthreads();
  MergeLane m;
  const float smin = __int_as_float(s_zmin[b]);
  m.s_ok = smin < kBig;
  const int wl = s_win[b];
  m.spx = 0.f; m.spy = 0.f; m.snx = 0.f; m.sny = 0.f; m.srow = 0.f;
  if (m.s_ok) {
    m.spx = s_src[wl]; m.spy = s_src[B + wl]; m.snx = s_src[2 * B + wl];
    m.sny = s_src[3 * B + wl]; m.srow = s_src[4 * B + wl];
  }

  const float fmin = s_canvas[b], bfx = s_canvas[B + b], bfy = s_canvas[2 * B + b];
  const float bfnx = s_canvas[3 * B + b], bfny = s_canvas[4 * B + b];
  const float fhas = s_canvas[5 * B + b];
  m.m_ok = (fhas > 0.5f) && (fmin <= p.merge_range);
  const float dr = fmin - smin;
  const bool both = m.m_ok && m.s_ok;
  m.do_merge = both && (fabsf(dr) < p.merge_threshold);
  const bool do_replace = both && !m.do_merge && (dr > 0.0f);
  m.do_append = (m.m_ok && !m.s_ok) || (both && !m.do_merge && !do_replace);
  m.modify = m.do_merge || do_replace;

  float avg_px = 0.5f * (m.spx + bfx), avg_py = 0.5f * (m.spy + bfy);
  float avg_nx = 0.5f * (m.snx + bfnx), avg_ny = 0.5f * (m.sny + bfny);
  const float nrm = fmaxf(sqrtf(avg_nx * avg_nx + avg_ny * avg_ny), F32(1e-12));
  avg_nx = avg_nx / nrm;
  avg_ny = avg_ny / nrm;
  m.upd_px = m.do_merge ? avg_px : bfx;
  m.upd_py = m.do_merge ? avg_py : bfy;
  m.upd_nx = m.do_merge ? avg_nx : bfnx;
  m.upd_ny = m.do_merge ? avg_ny : bfny;
  return m;
}
