// K-stream fused tracking frame: K independent streams, T frames each, in
// ONE launch.
//
// Replaces srrg2_laser_slam_2d_tpu/ops/pallas_stream.py:track_streams_grid
// (pallas_call at :732, body _frame_body_b at :384; stream_step at :622 is
// the same kernel with T = 1).
//
// What bounds it on an H100: latency per stream, as for the single-stream
// kernel (frame_kernel.cu): a stream's frames form a sequential chain, each
// frame a chain of block-wide reductions and 3x3 solves. For K = 32 streams
// over 255 frames the float32 operations come to about 0.118 ms and the
// bytes (canvas rows 0-5 in, payloads out, once each) to about 0.105 ms at
// the card's peaks; what the launch takes beside that is in PERF.md
// (chip_smoke.py measures both).
//
// Design: the TPU packs K streams onto the eight sublanes of a vector
// register, because one 768-beam stream fills an eighth of it, and carries
// all K states through a sequential grid. Here the streams are simply
// independent blocks: grid (K), one persistent block per stream, one thread
// per beam, no synchronisation between blocks; K above the card's 132 SMs
// runs in waves. Inside a block everything is the single-stream kernel's:
// the stream's cache lane and pose live in registers across the T loop, the
// frame's canvas rows and the merge z-buffer in shared memory. A block finds
// its stream by strides in the TPU layouts: field rows of [.., 8, K, B]
// arrays lie K * B floats apart. Differences from the single-stream body,
// as in _frame_body_b:
//   - no local-map split; the stats row holds lanes 0-6 only; the pose block
//     is one row of 16 and odometry arrives in its own [T, K, 8] array;
//   - two gather bands: "onehot" matches a beam only inside the window of the
//     lane's 128-beam block (bk.window_start), "roll" while the beam lies
//     within +-band_shift of the lane, with no block window;
//   - corr_refresh r: the canvas cell gathered at an outer step stays frozen
//     for up to r Gauss-Newton updates, while the moving side and every gate
//     are re-evaluated at each new pose. Updates past `iterations` do not run
//     (the TPU masks them). The final pass always gathers afresh.
// The TPU's stream-major copy of the canvases (measCk_stack) only feeds its
// batched matrix unit and has no counterpart here.

#include "frame_common.cuh"

__device__ __forceinline__ bool in_band(const Fields& fl, int b, int w0, const FrameParams& p) {
  if (p.gather_roll) return fl.okp && abs(fl.col - b) <= p.band_shift;
  return in_block_window(fl, w0, p.window);
}

__global__ void __launch_bounds__(1024, 1)
stream_track_kernel(const float* __restrict__ measC, const float* __restrict__ odoms,
                    const float* __restrict__ cache0, const float* __restrict__ pose0,
                    float* __restrict__ out_cache, float* __restrict__ out_pose,
                    float* __restrict__ payloads, FrameParams p) {
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
  const int k = blockIdx.x;                 // this block's stream
  const size_t row = (size_t)p.K * B;       // floats between two field rows
  const size_t lane0 = (size_t)k * B;       // this stream's lanes within a row

  // carried cache lane (registers)
  const float* c0 = cache0 + lane0;
  float cx = c0[b], cy = c0[row + b], cnx = c0[2 * row + b], cny = c0[3 * row + b],
        cval = c0[4 * row + b], crow = c0[5 * row + b];
  // carried pose (every thread holds the same copy)
  const float* ps0 = pose0 + (size_t)k * 16;
  float X[3] = {ps0[0], ps0[1], ps0[2]};
  float last_odom[3] = {ps0[3], ps0[4], ps0[5]};
  float has_odom = ps0[6], count = ps0[7];
  const float S[3] = {ps0[8], ps0[9], ps0[10]};

  const int w0 = min(max((b >> 7) * 128 - (p.window - 128) / 2, 0), B - p.window);
  const float cS = cosf(S[2]), sS = sinf(S[2]);
  const int refresh = max(p.corr_refresh, 1);

  for (int t = 0; t < p.T; ++t) {
    const float* mC = measC + (size_t)t * 8 * row + lane0;
    for (int r = 0; r < 6; ++r) s_canvas[r * B + b] = mC[r * row + b];
    const float* od = odoms + ((size_t)t * p.K + k) * 8;
    const float odom[3] = {od[0], od[1], od[2]};
    const float ov = od[3];
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

    // Gauss-Newton: one gather per outer step, up to `refresh` updates on it
    float iter_val = 0.0f, terms[13], sums[13];
    for (int it = 0; it < p.iterations;) {
      Fields fl = moving_fields(mx, my, mnx, mny, cval, T, p);
      const Gathered g = gather_canvas(s_canvas, B, fl.col, in_band(fl, b, w0, p));
      for (int sub = 0; sub < refresh && it < p.iterations; ++sub, ++it) {
        if (sub > 0) fl = moving_fields(mx, my, mnx, mny, cval, T, p);
        match_terms(fl, g, p, terms);
        block_sum<13>(terms, s_part, s_tot, sums);
        if (b == it) iter_val = sums[10];
        if (b == 64 + it) iter_val = sums[12];
        gn_update(sums, T0, T, p);
      }
    }
    const Fields fl = moving_fields(mx, my, mnx, mny, cval, T, p);
    match_terms(fl, gather_canvas(s_canvas, B, fl.col, in_band(fl, b, w0, p)), p, terms);
    float fs[13];
    block_sum<13>(terms, s_part, s_tot, fs);

    // ---- merge: shift z-buffer of the transformed cache lanes ----
    const MergeLane mg = merge_lane(fl, crow, s_canvas, s_src, s_zmin, s_win, B, p);

    // append slots from the carried scene count (inclusive lane prefix sum)
    int pa = mg.do_append ? 1 : 0, unused = 0, tot_a, tot_unused;
    block_scan2(pa, unused, s_wsum, tot_a, tot_unused);
    const float slot = count + (float)pa - 1.0f;
    const bool app_ok = mg.do_append && (slot < p.cap);
    const float n_app = (float)tot_a;
    // slots rise with the prefix sum, so app_ok holds for the first cap - count
    const float n_app_ok = fminf(n_app, fmaxf(p.cap - count, 0.0f));
    const float target = mg.modify ? mg.srow : (app_ok ? slot : -1.0f);
    const float kind = mg.modify ? 1.0f : (app_ok ? 2.0f : 0.0f);

    // new robot pose, payload in the scene (local-map) frame
    float inv_ST[3], ST[3], Xn[3], M[3];
    compose_s(S, T, ST);
    inverse_s(ST, inv_ST);
    compose_s(X, inv_ST, Xn);
    compose_s(Xn, S, M);
    const float cM = cosf(M[2]), sM = sinf(M[2]);

    float* pay = payloads + (size_t)t * 8 * row + lane0;
    pay[b] = cM * mg.upd_px - sM * mg.upd_py + M[0];
    pay[row + b] = sM * mg.upd_px + cM * mg.upd_py + M[1];
    pay[2 * row + b] = cM * mg.upd_nx - sM * mg.upd_ny;
    pay[3 * row + b] = sM * mg.upd_nx + cM * mg.upd_ny;
    pay[4 * row + b] = target;
    pay[5 * row + b] = kind;
    float st = 0.0f;
    switch (b) {
      case 0: st = T[0]; break;
      case 1: st = T[1]; break;
      case 2: st = T[2]; break;
      case 3: st = fs[10]; break;
      case 4: st = fs[9]; break;
      case 5: st = fs[12]; break;
      case 6: st = n_app_ok; break;
      default: break;
    }
    pay[6 * row + b] = st;
    pay[7 * row + b] = iter_val;

    // carry the state to the next frame: the post-merge visible cell per beam
    const float nrow = mg.modify ? mg.srow
                                 : (app_ok ? slot : ((mg.s_ok && !mg.m_ok) ? mg.srow : -1.0f));
    cx = mg.m_ok ? mg.upd_px : mg.spx;
    cy = mg.m_ok ? mg.upd_py : mg.spy;
    cnx = mg.m_ok ? mg.upd_nx : mg.snx;
    cny = mg.m_ok ? mg.upd_ny : mg.sny;
    cval = ((mg.m_ok || mg.s_ok) && nrow >= 0.0f) ? 1.0f : 0.0f;
    crow = nrow;
    X[0] = Xn[0]; X[1] = Xn[1]; X[2] = Xn[2];
    if (ov > 0.0f) { last_odom[0] = odom[0]; last_odom[1] = odom[1]; last_odom[2] = odom[2]; }
    has_odom = fmaxf(has_odom, ov);
    count = fminf(count + n_app, p.cap);
    __syncthreads();   // the next frame overwrites the shared canvas
  }

  float* oc = out_cache + lane0;
  oc[b] = cx;
  oc[row + b] = cy;
  oc[2 * row + b] = cnx;
  oc[3 * row + b] = cny;
  oc[4 * row + b] = cval;
  oc[5 * row + b] = crow;
  oc[6 * row + b] = 0.0f;
  oc[7 * row + b] = 0.0f;
  if (b < 16) {
    const float lanes[16] = {X[0], X[1], X[2], last_odom[0], last_odom[1], last_odom[2],
                             has_odom, count, S[0], S[1], S[2], 0.f, 0.f, 0.f, 0.f, 0.f};
    out_pose[(size_t)k * 16 + b] = lanes[b];
  }
}

extern "C" int stream_track_grid(const float* measC, const float* odoms, const float* cache0,
                                 const float* pose0, float* out_cache, float* out_pose,
                                 float* payloads, const FrameParams* params, void* stream) {
  const FrameParams p = *params;
  const size_t smem = sizeof(float) * (11 * (size_t)p.B + 32 * 13 + 16) +
                      sizeof(int) * (2 * (size_t)p.B + 64);
  cudaError_t err = cudaFuncSetAttribute(
      stream_track_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  stream_track_kernel<<<p.K, p.B, smem, (cudaStream_t)stream>>>(
      measC, odoms, cache0, pose0, out_cache, out_pose, payloads, p);
  return (int)cudaGetLastError();
}
