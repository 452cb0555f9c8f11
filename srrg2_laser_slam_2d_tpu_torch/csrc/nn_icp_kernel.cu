// Bounded-NN point-to-plane ICP for J independent (fixed, moving) pairs in
// ONE launch.
//
// Replaces srrg2_laser_slam_2d_tpu/ops/pallas_icp.py:fused_align_nn
// (pallas_call at :323, kernel _make_kernel at :78), mapped over pairs by
// fused_align_pairs (:371).
//
// What bounds it on an H100: operations. Each nearest-neighbour pass
// compares every valid moving point with every valid fixed point (8
// operations a distance); with 30 iterations and a refresh period of 3 that
// is 11 passes per pair, 11 GFLOP for 128 pairs at F = M = 1024, against
// 5.6 MB of inputs: 0.17 ms at the card's float32 peak. The sources are
// built with --fmad=false (each operation rounded as the plain version
// rounds it), so no multiply-add fuses and half of that peak is the most
// this kernel can reach. Tensor cores are no lever: the cross term is a
// product of depth 3 ([mx, my, 1] . [rx, ry, t.f]), far below an mma's
// depth of 8, and TF32's 10-bit mantissa would move argmins at the
// max_distance gate, where the expanded distance already cancels.
//
// Design: one block of 1,024 threads per pair, so each SM holds
// 32 warps of one pair.
//  - At the start of the launch a ballot scan packs the VALID fixed points
//    to the front, tile by tile (the 512-point tiles of the reference keep
//    their membership: s_tile holds where each tile starts in the packed
//    order), and the valid moving points likewise. Invalid points are never
//    compared: an invalid fixed point carries |f|^2 + 1e30 in the reference
//    and never wins; an invalid moving point is gated out and adds zeros.
//  - Each pass lays the per-fixed-point constants out as one float4 a point
//    in shared memory: 2 (R^T f).x, 2 (R^T f).y, 2 t.f, |f|^2. A thread
//    holds kPPT (4) moving points in registers, so one 16-byte broadcast
//    load serves four independent distance chains. The distance is the
//    Pallas expansion (|m|^2 + 2 (R^T t).m + |t|^2 + |f|^2) - 2 (m.(R^T f) +
//    t.f) in the same order of operations; the factor 2 rides on the
//    constants, which scales every rounding by a power of two exactly.
//  - The moving points are split over the threads of a group and the packed
//    fixed points over G groups (G = 1024 / ceil(Mv / 4) threads). Each
//    group keeps per point and tile the running minimum and the first and
//    the last index at it (five compare-and-select operations a distance,
//    on the pipe that bounds the scan; the two indices differ exactly when
//    the minimum is tied): within a tile equal minima tie, across tiles only
//    a strictly smaller distance replaces. The groups' partials are combined in fixed-point order by
//    the same rule (equal minima in one tile tie, in a later tile lose), so
//    the match is the reference's. The tied fixed points of a match are
//    averaged after the pass, only where a tie was seen: the warp rescans
//    the winning tile for each tied lane together, 32 points a lane. (The
//    expanded distance cancels, |m|^2 + |f|^2 ~ 1e2 against an ulp of
//    ~1e-5, so exact ties are common; one lane rescanning 512 points alone
//    stalled its warp and, at the next barrier, the block.)
//  - One thread per moving point then holds its match for the corr_refresh
//    sub-steps; the Cauchy-weighted normal equations are summed by
//    block_sum13 of frame_common.cuh (one barrier, the same totals bit for
//    bit in every warp), and every thread solves the same 3x3 system
//    (Cramer, determinant guard 1e-12) and composes the step (unwrapped).

#include "frame_common.cuh"

struct NNParams {
  int J, F, M, iterations, refresh, tile_f;
  float max_distance2, normal_cos, chi_threshold, min_inliers;
};

constexpr int kThreads = 1024;       // one moving point a thread in the solve
constexpr int kPPT = 4;              // moving points of a thread in a pass
constexpr int kMaxMoving = kThreads;
constexpr int kMaxTiles = 8;         // fixed capacity 4096 in 512-point tiles
constexpr int kNoMatch = 0x7fffffff;
constexpr unsigned kTieBit = 0x80000000u;

// Entries of the partial arrays: the groups' partials of a pass (at most
// kThreads * kPPT) and, at the start, the packing's index lists (F, M).
__host__ __device__ constexpr int nn_part_cap(int F) {
  return F > kThreads * kPPT ? F : kThreads * kPPT;
}

// Shared memory of a block, bytes (the layout is at the top of the kernel).
static size_t nn_smem_bytes(int F, int M) {
  return sizeof(float4) * (2 * (size_t)F + M) + sizeof(float) * ((size_t)F + M) +
         (sizeof(float) + sizeof(int)) * (size_t)nn_part_cap(F) +
         sizeof(float) * 2 * 32 * 16 + sizeof(int) * (kMaxTiles + 1 + 32);
}

// A group's (or the combined) match of one moving point: the smallest
// distance, the packed index of the first fixed point at it (kNoMatch:
// none) and whether another fixed point of the same tile ties with it.
struct Match {
  float d;
  int idx;
  bool tie;
};

__device__ __forceinline__ int tile_of(const int* s_tile, int ntiles, int idx) {
  int t = 0;
  while (t + 1 < ntiles && s_tile[t + 1] <= idx) ++t;
  return t;
}

__global__ void __launch_bounds__(kThreads, 1)
nn_icp_kernel(const float* __restrict__ fixedP, const float* __restrict__ movingP,
              const float* __restrict__ initials, float* __restrict__ out_est,
              float* __restrict__ out_stats, NNParams p) {
  extern __shared__ float4 smem4[];
  const int F = p.F, M = p.M, j = blockIdx.x, tid = threadIdx.x;
  const int ntiles = (F + p.tile_f - 1) / p.tile_f;
  float4* s_fix = smem4;                    // [F] packed valid fixed: x, y, nx, ny
  float4* s_q = s_fix + F;                  // [F] per pass: 2 (R^T f).x, 2 (R^T f).y, 2 t.f, |f|^2
  float4* s_mov = s_q + F;                  // [M] packed valid moving: x, y, nx, ny
  float* s_f2 = (float*)(s_mov + M);        // [F] |f|^2 of the packed fixed points
  float* s_m2 = s_f2 + F;                   // [M] |m|^2
  float* s_pd = s_m2 + M;                   // [groups * Mv] partial distances
  const int part_cap = nn_part_cap(F);
  int* s_pi = (int*)(s_pd + part_cap);      // [groups * Mv] partial index | tie bit
  float* s_part = (float*)(s_pi + part_cap);  // [2][32][16] block_sum13
  int* s_tile = (int*)(s_part + 2 * 32 * 16);  // [kMaxTiles + 1]
  int* s_scan = s_tile + kMaxTiles + 1;        // [32]
  PHASE_BEGIN;

  // ---- pack the valid points (the index lists go through s_pi) ----------
  const float* fj = fixedP + (size_t)j * 6 * F;
  const float* mj = movingP + (size_t)j * 5 * M;
  int* src = s_pi;
  const int Fv = block_pack(
      F, [&](int i) { return fj[4 * F + i] > 0.0f; },
      [&](int i, int pos, bool f) {
        if (f) src[pos] = i;
        if (i % p.tile_f == 0) s_tile[i / p.tile_f] = pos;
      },
      s_scan);
  for (int k = tid; k < Fv; k += blockDim.x) {
    const int i = src[k];
    s_fix[k] = make_float4(fj[i], fj[F + i], fj[2 * F + i], fj[3 * F + i]);
    s_f2[k] = fj[5 * F + i];   // |f|^2 + 0 for a valid point
  }
  if (tid == 0) s_tile[ntiles] = Fv;
  __syncthreads();
  const int Mv = block_pack(
      M, [&](int i) { return mj[4 * M + i] > 0.0f; },
      [&](int i, int pos, bool f) { if (f) src[pos] = i; }, s_scan);
  for (int k = tid; k < Mv; k += blockDim.x) {
    const int i = src[k];
    const float x = mj[i], y = mj[M + i];
    s_mov[k] = make_float4(x, y, mj[2 * M + i], mj[3 * M + i]);
    s_m2[k] = x * x + y * y;
  }
  __syncthreads();

  // the pass's split: G groups of TG threads, kPPT moving points a thread
  const int TG = max(32, (Mv + kPPT - 1) / kPPT + 31) / 32 * 32;
  const int G = kThreads / TG;
  const int g = tid / TG, gl = tid % TG;
  const int r0 = (int)(((long long)Fv * g) / G), r1 = (int)(((long long)Fv * (g + 1)) / G);

  // this thread's moving point in the solve (tid < Mv)
  const bool own = tid < Mv;
  float4 mv = own ? s_mov[tid] : make_float4(0.f, 0.f, 0.f, 0.f);
  float pfx = 0.f, pfy = 0.f, nfx = 0.f, nfy = 0.f, px = 0.f, py = 0.f, nx = 0.f, ny = 0.f;
  bool ok = false;
  float T[3] = {initials[3 * j], initials[3 * j + 1], initials[3 * j + 2]};
  int pbuf = 0;
  PHASE(0);

  auto transform = [&](float c, float s) {
    px = c * mv.x - s * mv.y + T[0];
    py = s * mv.x + c * mv.y + T[1];
    nx = c * mv.z - s * mv.w;
    ny = s * mv.z + c * mv.w;
  };

  // Nearest-neighbour pass at pose T: every thread leaves with its moving
  // point's match (pf, nf, ok) and the point moved by T (px .. ny).
  auto nn_pass = [&]() {
    const float c = cosf(T[2]), s = sinf(T[2]);
    const float tx = T[0], ty = T[1];
    __syncthreads();   // the previous pass's readers of s_q and the partials are done
    for (int i = tid; i < Fv; i += blockDim.x) {
      const float4 f = s_fix[i];
      s_q[i] = make_float4(2.0f * (c * f.x + s * f.y), 2.0f * (-s * f.x + c * f.y),
                           2.0f * (tx * f.x + ty * f.y), s_f2[i]);
    }
    const float a = c * tx + s * ty;
    const float b = -s * tx + c * ty;
    const float tt = tx * tx + ty * ty;
    __syncthreads();
    PHASE(1);
    if (g < G) {
      float mx[kPPT], my[kPPT], p2[kPPT], gd[kPPT];
      int gi[kPPT];
#pragma unroll
      for (int k = 0; k < kPPT; ++k) {
        const int m = min(gl + TG * k, max(Mv - 1, 0));
        const float4 q = s_mov[m];
        mx[k] = q.x; my[k] = q.y;
        p2[k] = s_m2[m] + 2.0f * (a * q.x + b * q.y) + tt;
        gd[k] = kBig; gi[k] = kNoMatch;
      }
      for (int t = 0; t < ntiles; ++t) {
        const int lo = max(r0, s_tile[t]), hi = min(r1, s_tile[t + 1]);
        if (lo >= hi) continue;
        // the first and the last index at the running minimum: they differ
        // exactly when the segment's minimum is tied
        float cur[kPPT];
        int first[kPPT], last[kPPT];
#pragma unroll
        for (int k = 0; k < kPPT; ++k) { cur[k] = INFINITY; first[k] = lo; last[k] = lo; }
#pragma unroll 8
        for (int i = lo; i < hi; ++i) {
          const float4 q = s_q[i];
#pragma unroll
          for (int k = 0; k < kPPT; ++k) {
            const float cross2 = mx[k] * q.x + my[k] * q.y + q.z;
            const float d2 = p2[k] + q.w - cross2;
            const bool lt = d2 < cur[k];
            last[k] = d2 <= cur[k] ? i : last[k];
            first[k] = lt ? i : first[k];
            cur[k] = lt ? d2 : cur[k];
          }
        }
#pragma unroll
        for (int k = 0; k < kPPT; ++k) {
          if (cur[k] < gd[k]) {
            gd[k] = cur[k];
            gi[k] = first[k] | (first[k] != last[k] ? (int)kTieBit : 0);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kPPT; ++k) {
        const int m = gl + TG * k;
        if (m < Mv) { s_pd[g * Mv + m] = gd[k]; s_pi[g * Mv + m] = gi[k]; }
      }
    }
    __syncthreads();
    PHASE(2);
    // combine the groups' partials in fixed-point order, then the match
    transform(c, s);
    Match mt = {kBig, kNoMatch, false};
    int mtile = -1;
    if (own) {
      for (int h = 0; h < G; ++h) {
        const float d = s_pd[h * Mv + tid];
        const int raw = s_pi[h * Mv + tid];
        const int i = raw & kNoMatch;
        if (d < mt.d) {
          mt = {d, i, (raw & (int)kTieBit) != 0};
          mtile = tile_of(s_tile, ntiles, i);
        } else if (d == mt.d && i != kNoMatch && tile_of(s_tile, ntiles, i) == mtile) {
          mt.tie = true;   // a later group's point of the same tile at the minimum
        }
      }
    }
    pfx = 0.f; pfy = 0.f; nfx = 0.f; nfy = 0.f;
    if (mt.idx != kNoMatch && !mt.tie) {
      const float4 f = s_fix[mt.idx];
      pfx = f.x; pfy = f.y; nfx = f.z; nfy = f.w;
    }
    // a tied match averages every fixed point of its tile at the minimum;
    // the whole warp rescans the tile for each tied lane in turn (32 points
    // a lane), and a butterfly adds up the lanes' shares
    const unsigned tied = __ballot_sync(kFull, mt.idx != kNoMatch && mt.tie);
    if (tied) {
      const int lane = tid & 31;
      const float p2 = s_m2[min(tid, max(Mv - 1, 0))] + 2.0f * (a * mv.x + b * mv.y) + tt;
      for (unsigned left = tied; left; left &= left - 1) {
        const int src = __ffs(left) - 1;
        const float bx = __shfl_sync(kFull, mv.x, src), by = __shfl_sync(kFull, mv.y, src);
        const float bp2 = __shfl_sync(kFull, p2, src), bd = __shfl_sync(kFull, mt.d, src);
        const int t = __shfl_sync(kFull, mtile, src);
        float sum[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
        for (int i = s_tile[t] + lane; i < s_tile[t + 1]; i += 32) {
          const float4 q = s_q[i];
          const float d2 = bp2 + q.w - (bx * q.x + by * q.y + q.z);
          if (d2 == bd) {
            const float4 f = s_fix[i];
            sum[0] += f.x; sum[1] += f.y; sum[2] += f.z; sum[3] += f.w; sum[4] += 1.0f;
          }
        }
#pragma unroll
        for (int k = 0; k < 5; ++k)
          for (int o = 16; o > 0; o >>= 1) sum[k] += __shfl_xor_sync(kFull, sum[k], o);
        if (lane == src) {
          const float dn = fmaxf(sum[4], 1.0f);
          pfx = sum[0] / dn; pfy = sum[1] / dn; nfx = sum[2] / dn; nfy = sum[3] / dn;
        }
      }
    }
    const float ndot = nfx * nx + nfy * ny;
    ok = own && (mt.d <= p.max_distance2) && (ndot >= p.normal_cos);
    PHASE(3);
  };

  // One Gauss-Newton step on the current matches.
  auto solve_step = [&]() {
    float acc[kTerms];
#pragma unroll
    for (int k = 0; k < kTerms; ++k) acc[k] = 0.0f;
    if (ok) {
      const float e1 = nfx * (px - pfx) + nfy * (py - pfy);
      const float e2 = nx - nfx;
      const float e3 = ny - nfy;
      const float chi = e1 * e1 + e2 * e2 + e3 * e3;
      float w = 1.0f;
      if (p.chi_threshold > 0.0f)
        w = (chi < p.chi_threshold) ? 1.0f : p.chi_threshold / fmaxf(chi, F32(1e-20));
      const float j1c = nfx * (-py) + nfy * px;
      const float sn2 = nx * nx + ny * ny;
      acc[0] = w * nfx * nfx;
      acc[1] = w * nfx * nfy;
      acc[2] = w * nfx * j1c;
      acc[3] = w * nfy * nfy;
      acc[4] = w * nfy * j1c;
      acc[5] = w * (j1c * j1c + sn2);
      acc[6] = w * nfx * e1;
      acc[7] = w * nfy * e1;
      acc[8] = w * (j1c * e1 + (-ny) * e2 + nx * e3);
      acc[9] = 1.0f;
    }
    PHASE(4);
    float h[kTerms];
    block_sum13(acc, s_part, pbuf, h);
    pbuf ^= 1;
    PHASE(5);
    const float a00 = h[0], a01 = h[1], a02 = h[2], a11 = h[3], a12 = h[4], a22 = h[5];
    const float a10 = a01, a20 = a02, a21 = a12;
    const float r0_ = -h[6], r1_ = -h[7], r2_ = -h[8];
    const float det = a00 * (a11 * a22 - a12 * a21) - a01 * (a10 * a22 - a12 * a20) +
                      a02 * (a10 * a21 - a11 * a20);
    const float inv_det = (fabsf(det) > F32(1e-12)) ? 1.0f / det : 0.0f;
    float x0 = ((a11 * a22 - a12 * a21) * r0_ + (a02 * a21 - a01 * a22) * r1_ +
                (a01 * a12 - a02 * a11) * r2_) * inv_det;
    float x1 = ((a12 * a20 - a10 * a22) * r0_ + (a00 * a22 - a02 * a20) * r1_ +
                (a02 * a10 - a00 * a12) * r2_) * inv_det;
    float x2 = ((a10 * a21 - a11 * a20) * r0_ + (a01 * a20 - a00 * a21) * r1_ +
                (a00 * a11 - a01 * a10) * r2_) * inv_det;
    if (!(h[9] >= p.min_inliers)) { x0 = 0.0f; x1 = 0.0f; x2 = 0.0f; }
    // pre-multiplied compose (unwrapped angle)
    const float ca = cosf(x2), sa = sinf(x2);
    const float n0 = x0 + ca * T[0] - sa * T[1];
    const float n1 = x1 + sa * T[0] + ca * T[1];
    const float n2 = x2 + T[2];
    T[0] = n0; T[1] = n1; T[2] = n2;
    PHASE(6);
  };

  const int refresh = p.refresh;
  const int outer = (p.iterations + refresh - 1) / refresh;
  for (int i = 0; i < outer; ++i) {
    nn_pass();
    for (int sub = 0; sub < refresh && i * refresh + sub < p.iterations; ++sub) {
      if (sub > 0) transform(cosf(T[2]), sinf(T[2]));
      solve_step();
    }
  }

  // final stats at the solution
  nn_pass();
  float acc[kTerms];
#pragma unroll
  for (int k = 0; k < kTerms; ++k) acc[k] = 0.0f;
  if (ok) {
    const float e1 = nfx * (px - pfx) + nfy * (py - pfy);
    const float e2 = nx - nfx;
    const float e3 = ny - nfy;
    const float chi_pt = e1 * e1 + e2 * e2 + e3 * e3;
    const bool inl = chi_pt < p.chi_threshold;
    acc[0] = chi_pt;
    acc[1] = inl ? 1.0f : 0.0f;
    acc[2] = 1.0f;
    acc[3] = inl ? chi_pt : 0.0f;
  }
  float st[kTerms];
  block_sum13(acc, s_part, pbuf, st);
  if (tid == 0) {
    out_est[3 * j] = T[0];
    out_est[3 * j + 1] = T[1];
    out_est[3 * j + 2] = T[2];
    for (int k = 0; k < 4; ++k) out_stats[4 * j + k] = st[k];
  }
  PHASE(7);
  PHASE_END;
}

PHASE_EXPORT

extern "C" int nn_icp_align_pairs(const float* fixedP, const float* movingP,
                                  const float* initials, float* out_est, float* out_stats,
                                  const NNParams* params, void* stream) {
  const NNParams p = *params;
  if (p.J == 0) return 0;
  if (p.M > kMaxMoving || p.F > kMaxTiles * p.tile_f || p.tile_f <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = nn_smem_bytes(p.F, p.M);
  cudaError_t err = cudaFuncSetAttribute(
      nn_icp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  nn_icp_kernel<<<p.J, kThreads, smem, (cudaStream_t)stream>>>(
      fixedP, movingP, initials, out_est, out_stats, p);
  return (int)cudaGetLastError();
}
