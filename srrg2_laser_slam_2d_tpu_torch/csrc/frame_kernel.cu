// Fused tracking frame: a whole chunk of T frames in ONE launch.
//
// Replaces srrg2_laser_slam_2d_tpu/ops/pallas_frame.py:track_frames_grid
// (pallas_call at :489, body _frame_body at :142; frame_step is the same
// kernel with T = 1), meas_as_canvas layout.
//
// What bounds it on an H100: latency, not bytes or FLOPs. The frames form a
// sequential chain (frame t+1 starts from frame t's pose and cache), and
// each frame is 11 banded Gauss-Newton passes over B = 768 beams, each
// ending in a block-wide reduction and a 3x3 solve: about 30 block barriers
// per frame on one SM. A 1024-frame chunk moves 50 MB and does 1.0 GFLOP,
// 15 us at the card's peaks; it takes 37.8 ms on an NVIDIA H100 80GB HBM3 at
// 700 W (chip_smoke.py).
//
// Design: one persistent block, one thread per beam (B <= 1024 threads),
// looping over the T frames inside the kernel, as the TPU grid iterated
// sequentially with the state in VMEM. The carried state never leaves the
// SM: each thread keeps its own cache lane (x, y, nx, ny, valid, row) and a
// copy of the pose scalars in registers; the frame's measurement canvas
// (6 x B floats) and the merge z-buffer live in shared memory. The banded
// one-hot MXU gather of the TPU kernel becomes a direct shared-memory load
// of canvas[col_i], taken only while col_i lies in the 128-beam block's
// window (the TPU gather finds nothing outside it). The shift z-buffer
// becomes two shared-memory atomics (min depth, then max source lane among
// the depth winners: the TPU enumerates shifts -32..+32 with roll, so the
// highest source lane wins ties). Reductions are warp shuffles plus one
// shared-memory pass; every thread then solves the same 3x3 system, so the
// new pose needs no broadcast. Arithmetic follows the Pallas body operation
// by operation (built with --fmad=false), including the polynomial atan2,
// the 1e-20 determinant guard of pallas_projective_align._solve3_sym, the
// unwrapped SE(2) helpers and the uncapped seed slot on a split.

#include "frame_common.cuh"

__global__ void __launch_bounds__(1024, 1)
frame_track_kernel(const float* __restrict__ measC, const float* __restrict__ cache0,
                   const float* __restrict__ pose0, float* __restrict__ out_cache,
                   float* __restrict__ out_pose, float* __restrict__ payloads,
                   FrameParams p) {
  extern __shared__ float smem[];
  const int B = p.B;
  float* s_canvas = smem;                   // [6][B]
  float* s_src = s_canvas + 6 * B;          // [5][B] z-buffer source values
  int* s_zmin = (int*)(s_src + 5 * B);      // [B] min depth (float bits)
  int* s_win = s_zmin + B;                  // [B] winning source lane
  float* s_part = (float*)(s_win + B);      // [32 * 13]
  float* s_tot = s_part + 32 * 13;          // [16]
  int* s_wsum = (int*)(s_tot + 16);         // [64]

  const int b = threadIdx.x;
  // carried cache lane (registers)
  float cx = cache0[b], cy = cache0[B + b], cnx = cache0[2 * B + b],
        cny = cache0[3 * B + b], cval = cache0[4 * B + b], crow = cache0[5 * B + b];
  // carried pose (every thread holds the same copy)
  float X[3] = {pose0[0], pose0[1], pose0[2]};
  float last_odom[3] = {pose0[3], pose0[4], pose0[5]};
  float has_odom = pose0[6], count = pose0[7];
  float S[3] = {pose0[8], pose0[9], pose0[10]};

  const int w0 = min(max((b >> 7) * 128 - (p.window - 128) / 2, 0), B - p.window);
  const float cS = cosf(S[2]), sS = sinf(S[2]);

  for (int t = 0; t < p.T; ++t) {
    const float* mC = measC + (size_t)t * 8 * B;
    for (int r = 0; r < 6; ++r) s_canvas[r * B + b] = mC[r * B + b];
    const float odom[3] = {mC[6 * B + 0], mC[6 * B + 1], mC[6 * B + 2]};
    const float ov = mC[6 * B + 3];
    __syncthreads();

    // odometry-predicted initial guess / prior: T0 = (D o S)^-1
    float D[3] = {0.f, 0.f, 0.f};
    if (has_odom > 0.0f && ov > 0.0f) {
      float inv_lo[3];
      inverse_s(last_odom, inv_lo);
      compose_s(inv_lo, odom, D);
    }
    float DS[3], T0[3], T[3];
    compose_s(D, S, DS);
    inverse_s(DS, T0);
    T[0] = T0[0]; T[1] = T0[1]; T[2] = T0[2];

    // moving lane = cache cell re-framed prev-sensor -> prev-robot
    const float mx = cS * cx - sS * cy + S[0];
    const float my = sS * cx + cS * cy + S[1];
    const float mnx = cS * cnx - sS * cny;
    const float mny = sS * cnx + cS * cny;

    float iter_val = 0.0f, terms[13], sums[13];
    for (int it = 0; it < p.iterations; ++it) {
      Fields fl = moving_fields(mx, my, mnx, mny, cval, T, p);
      match_terms(fl, gather_canvas(s_canvas, B, fl.col, in_block_window(fl, w0, p.window)),
                  p, terms);
      block_sum<13>(terms, s_part, s_tot, sums);
      if (b == it) iter_val = sums[10];
      if (b == 64 + it) iter_val = sums[12];
      gn_update(sums, T0, T, p);
    }
    const Fields fl = moving_fields(mx, my, mnx, mny, cval, T, p);
    match_terms(fl, gather_canvas(s_canvas, B, fl.col, in_block_window(fl, w0, p.window)),
                p, terms);
    float fs[13];
    block_sum<13>(terms, s_part, s_tot, fs);

    // ---- merge: shift z-buffer of the transformed cache lanes ----
    const MergeLane mg = merge_lane(fl, crow, s_canvas, s_src, s_zmin, s_win, B, p);
    const bool m_ok = mg.m_ok, s_ok = mg.s_ok, modify = mg.modify, do_append = mg.do_append;
    const float spx = mg.spx, spy = mg.spy, snx = mg.snx, sny = mg.sny, srow = mg.srow;
    const float upd_px = mg.upd_px, upd_py = mg.upd_py, upd_nx = mg.upd_nx, upd_ny = mg.upd_ny;
    const float bfx = s_canvas[B + b], bfy = s_canvas[2 * B + b];
    const float bfnx = s_canvas[3 * B + b], bfny = s_canvas[4 * B + b];

    // append slots (inclusive lane prefix sums) and split seed slots
    int pa = do_append ? 1 : 0, ps = m_ok ? 1 : 0, tot_a, tot_s;
    block_scan2(pa, ps, s_wsum, tot_a, tot_s);
    const float slot = count + (float)pa - 1.0f;
    const bool app_ok = do_append && (slot < p.cap);
    const float n_app = (float)tot_a;
    // slots rise with the prefix sum, so app_ok holds for the first cap - count
    const float n_app_ok = fminf(n_app, fmaxf(p.cap - count, 0.0f));
    float target = modify ? srow : (app_ok ? slot : -1.0f);
    float kind = modify ? 1.0f : (app_ok ? 2.0f : 0.0f);

    float inv_ST[3], ST[3], Xn[3], M[3];
    compose_s(S, T, ST);
    inverse_s(ST, inv_ST);
    compose_s(X, inv_ST, Xn);
    compose_s(Xn, S, M);
    const float cM = cosf(M[2]), sM = sinf(M[2]);
    float pay_x = cM * upd_px - sM * upd_py + M[0];
    float pay_y = sM * upd_px + cM * upd_py + M[1];
    float pay_nx = cM * upd_nx - sM * upd_ny;
    float pay_ny = sM * upd_nx + cM * upd_ny;

    float ncx = m_ok ? upd_px : spx, ncy = m_ok ? upd_py : spy;
    float nnx = m_ok ? upd_nx : snx, nny = m_ok ? upd_ny : sny;
    float nrow = modify ? srow : (app_ok ? slot : ((s_ok && !m_ok) ? srow : -1.0f));
    float nvalid = ((m_ok || s_ok) && nrow >= 0.0f) ? 1.0f : 0.0f;
    float count_new = fminf(count + n_app, p.cap);

    float do_split = 0.0f;
    if (p.use_split) {
      do_split = (sqrtf(Xn[0] * Xn[0] + Xn[1] * Xn[1]) >= p.split_distance) ? 1.0f : 0.0f;
      if (do_split > 0.0f) {
        const float seed_slot = (float)ps - 1.0f;   // not capped (as in Pallas)
        pay_x = cS * bfx - sS * bfy + S[0];
        pay_y = sS * bfx + cS * bfy + S[1];
        pay_nx = cS * bfnx - sS * bfny;
        pay_ny = sS * bfnx + cS * bfny;
        target = m_ok ? seed_slot : -1.0f;
        kind = m_ok ? 2.0f : 0.0f;
        ncx = bfx; ncy = bfy; nnx = bfnx; nny = bfny;
        nrow = m_ok ? seed_slot : -1.0f;
        nvalid = m_ok ? 1.0f : 0.0f;
        count_new = fminf((float)tot_s, p.cap);
      }
    }

    float* pay = payloads + (size_t)t * 8 * B;
    pay[b] = pay_x;
    pay[B + b] = pay_y;
    pay[2 * B + b] = pay_nx;
    pay[3 * B + b] = pay_ny;
    pay[4 * B + b] = target;
    pay[5 * B + b] = kind;
    float st = 0.0f;
    switch (b) {
      case 0: st = T[0]; break;
      case 1: st = T[1]; break;
      case 2: st = T[2]; break;
      case 3: st = fs[10]; break;
      case 4: st = fs[9]; break;
      case 5: st = fs[12]; break;
      case 6: st = n_app_ok; break;
      case 7: st = do_split; break;
      case 8: st = Xn[0]; break;
      case 9: st = Xn[1]; break;
      case 10: st = Xn[2]; break;
      case 11: st = count_new; break;
      default: break;
    }
    pay[6 * B + b] = st;
    pay[7 * B + b] = iter_val;

    // carry the state to the next frame
    cx = ncx; cy = ncy; cnx = nnx; cny = nny; cval = nvalid; crow = nrow;
    if (do_split > 0.0f) { X[0] = 0.0f; X[1] = 0.0f; X[2] = 0.0f; }
    else { X[0] = Xn[0]; X[1] = Xn[1]; X[2] = Xn[2]; }
    if (ov > 0.0f) { last_odom[0] = odom[0]; last_odom[1] = odom[1]; last_odom[2] = odom[2]; }
    has_odom = fmaxf(has_odom, ov);
    count = count_new;
    __syncthreads();   // the next frame overwrites the shared canvas
  }

  out_cache[b] = cx;
  out_cache[B + b] = cy;
  out_cache[2 * B + b] = cnx;
  out_cache[3 * B + b] = cny;
  out_cache[4 * B + b] = cval;
  out_cache[5 * B + b] = crow;
  out_cache[6 * B + b] = 0.0f;
  out_cache[7 * B + b] = 0.0f;
  if (b < 8) {
    const float row0[8] = {X[0], X[1], X[2], last_odom[0], last_odom[1], last_odom[2],
                           has_odom, count};
    out_pose[b] = row0[b];
    out_pose[8 + b] = pose0[8 + b];
  }
}

extern "C" int frame_track_grid(const float* measC, const float* cache0, const float* pose0,
                                float* out_cache, float* out_pose, float* payloads,
                                const FrameParams* params, void* stream) {
  const FrameParams p = *params;
  const size_t smem = sizeof(float) * (11 * (size_t)p.B + 32 * 13 + 16) +
                      sizeof(int) * (2 * (size_t)p.B + 64);
  cudaError_t err = cudaFuncSetAttribute(
      frame_track_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  frame_track_kernel<<<1, p.B, smem, (cudaStream_t)stream>>>(
      measC, cache0, pose0, out_cache, out_pose, payloads, p);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
