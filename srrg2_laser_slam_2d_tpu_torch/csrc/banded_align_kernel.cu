// Banded projective alignment of a beam-indexed moving cloud against a fixed
// cloud: the tracker's whole Gauss-Newton loop in one launch.
//
// Replaces srrg2_laser_slam_2d_tpu/ops/pallas_banded_align.py:
// fused_projective_align_banded (pallas_call at :162).
//
// The fixed cloud (the measurement, not beam-indexed) is z-buffered once
// into a canvas (closest depth per beam, ties averaged). The moving cloud
// has one row per beam (row r is the scene cell last seen on beam r), so
// each Gauss-Newton pass moves lane r by the current estimate, finds its
// beam, and matches it against that canvas cell while the beam lies in the
// 256-beam window of the lane's 128-beam block; two lanes on one beam both
// match (there is no moving-side z-buffer). The 13 sums, the odometry
// prior, the Cramer solve and the pre-multiplied update are the frame
// kernel's (frame_common.cuh). `iterations` updates, then one pass for the
// final statistics.
//
// Bound: about 110 operations a lane and pass (0.93 MFLOP at B = 768, 11
// passes) over some 30 KB in and out: well under a microsecond at the
// card's rates. What bounds this single block is its chain of 11 dependent
// passes, each a block reduction and a 3x3 solve, and one SM's issue rate
// for the lanes (some 200 instructions a lane and pass). The design is
// kernel 1's Gauss-Newton pass (frame_loop) at T = 1 with a given canvas,
// spending as few instructions and barriers a pass as it can:
//  - one lane a thread (B threads; one measured faster than 2, 3 and 4
//    once one warp solves, PERF.md);
//  - the lanes that hold a cell are packed at launch (block_scan_beams, one
//    barrier), each keeping its block's window for the band test, and each
//    thread keeps its packed lane in registers; a lane without a cell adds
//    exact zeros, so a pass walks only the packed ones;
//  - one cosine and sine of the estimate a pass, from warp 0 (fields_at
//    takes them);
//  - the end of a pass is aligner_update (frame_common.cuh): the warps'
//    partial sums, a barrier, warp 0 alone sums, records, solves (the
//    prior's constants taken once, its share of a pass before the barrier)
//    and takes the new angle's cosine and sine, a second barrier hands
//    them to every warp. Two barriers a pass;
//  - the fixed canvas by the compute-once z-buffer (zb_rows / zb_min /
//    zb_add: each row's fields computed once, two barriers, no float
//    atomics but for tied rows), finished in place by each beam's owner;
//    the lanes and the fixed rows are loaded before the first barrier, so
//    their latencies overlap.

#include "frame_common.cuh"

constexpr int kFixedRegs = 4;    // fixed rows a thread keeps in registers while z-buffering

__host__ __device__ constexpr size_t banded_smem_bytes(int B) {
  return sizeof(float) * ((kZbRows + 5) * (size_t)B + 32 * 16 + 8) + sizeof(int) * 4 * 32;
}

__global__ void __launch_bounds__(1024, 1)
banded_align_kernel(const float* __restrict__ fxy, const float* __restrict__ fnm,
                    const unsigned char* __restrict__ fvalid, int F,
                    const float* __restrict__ mxy, const float* __restrict__ mnm,
                    const unsigned char* __restrict__ mvalid, int M,
                    const float* __restrict__ t0, const float* __restrict__ prior,
                    float* __restrict__ out_t, float* __restrict__ out_stats,
                    float* __restrict__ out_iters, FrameParams p) {
  extern __shared__ float smem[];
  const int B = p.B, tid = threadIdx.x;        // B threads: thread b owns beam b
  float* s_canvas = smem;                      // [10][B] z-buffer slots, rows 0-5 then the canvas
  float* s_lanes = s_canvas + kZbRows * B;     // [5][B] packed lanes: x, y, nx, ny, window
  float* s_part = s_lanes + 5 * B;             // [32][16] warp partial sums
  float* s_pose = s_part + 32 * 16;            // [8] the pose, its cos and sin (aligner_update)
  int* s_scan = (int*)(s_pose + 8);            // [4][32] warp scan totals
  PHASE_BEGIN;

  // this thread's lane (beam tid) and the fixed rows' fields first: their
  // loads overlap
  int qv = (tid < M && mvalid[tid]) ? 1 : 0;
  float lx = qv ? mxy[2 * tid] : 0.0f;
  float ly = qv ? mxy[2 * tid + 1] : 0.0f;
  float lnx = qv ? mnm[2 * tid] : 0.0f;
  float lny = qv ? mnm[2 * tid + 1] : 0.0f;
  float T[3] = {t0[0], t0[1], t0[2]};
  const float P[3] = {prior[0], prior[1], prior[2]};
  const PackedCloud rows{fxy, fnm, fvalid};
  auto row_at = [&](int i) { return canvas_point(rows, i, p); };
  Fields f[kFixedRegs];
  zb_rows<kFixedRegs>(row_at, F, f);
  PriorTerms prior_c = {};
  if (tid < 32) prior_c = aligner_constants(P, T[2], p, s_pose);   // warp 0 solves
  zb_clear(s_canvas, B, tid);
  FRAME_SYNC();
  PHASE(0);
  zb_min<kFixedRegs>(row_at, F, f, s_canvas);
  FRAME_SYNC();
  zb_add<kFixedRegs>(row_at, F, f, s_canvas, B);
  FRAME_SYNC();
  PHASE(1);
  // each beam's owner finishes its cell in place: the mean of tied rows,
  // has-point in row 5
  {
    const Gathered g = zb_cell(s_canvas, B, tid);
    s_canvas[B + tid] = g.bfx;
    s_canvas[2 * B + tid] = g.bfy;
    s_canvas[3 * B + tid] = g.bfnx;
    s_canvas[4 * B + tid] = g.bfny;
    s_canvas[5 * B + tid] = g.bhas;
  }
  // the lanes that hold a cell, packed in beam order (a lane without one
  // adds exact zeros), each keeping the start of its block's window (the
  // one-hot band, in_band); then each thread takes packed slot tid into
  // registers
  int nv;
  const bool in = qv;
  block_scan_beams<1>(&qv, s_scan, nv);
  if (in) {
    const int sl = (qv & 0xffff) - 1;
    s_lanes[sl] = lx;
    s_lanes[B + sl] = ly;
    s_lanes[2 * B + sl] = lnx;
    s_lanes[3 * B + sl] = lny;
    s_lanes[4 * B + sl] = __int_as_float(min(max((tid >> 7) * 128 - (p.window - 128) / 2, 0),
                                             B - p.window));
  }
  FRAME_SYNC();   // the canvas and the packed lanes, for every thread
  const bool lon = tid < nv;   // the slot holds a lane
  int w0 = 0;
  if (lon) {
    lx = s_lanes[tid];
    ly = s_lanes[B + tid];
    lnx = s_lanes[2 * B + tid];
    lny = s_lanes[3 * B + tid];
    w0 = __float_as_int(s_lanes[4 * B + tid]);
  }

  PHASE(2);
  float c = s_pose[3], s = s_pose[4];
  for (int it = 0; it <= p.iterations; ++it) {
    float acc[kTerms] = {};
    if (lon) {   // the warps past the packed lanes skip the pass
      const Fields fl = fields_at(lx, ly, lnx, lny, 1.0f, T, c, s, p);
      match_terms(fl, gather_canvas(s_canvas, B, fl.col, in_block_window(fl, w0, p.window)),
                  p, acc);
    }
    float inc[9];
    if (p.use_prior && tid < 32) prior_increments(prior_c, T, p.odom_weight, inc);
    PHASE(3);
    aligner_update(acc, inc, it, p, T, c, s, s_part, s_pose, out_t, out_stats, out_iters);
    PHASE(4);
  }
  PHASE_END;
}

PHASE_EXPORT

static unsigned long long g_smem_set = 0;

extern "C" int banded_align(const float* fxy, const float* fnm, const unsigned char* fvalid,
                            int F, const float* mxy, const float* mnm,
                            const unsigned char* mvalid, int M, const float* t0,
                            const float* prior, float* out_t, float* out_stats,
                            float* out_iters, const FrameParams* params, void* stream) {
  const FrameParams p = *params;
  if (p.B > 1024 || p.B <= 0 || p.B % 128 || p.iterations > 128 || M > p.B || F < 0 ||
      M < 0 || p.window > p.B)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = smem_limit_once(banded_align_kernel, banded_smem_bytes(1024), g_smem_set);
  if (err != cudaSuccess) return (int)err;
  banded_align_kernel<<<1, p.B, banded_smem_bytes(p.B), (cudaStream_t)stream>>>(
      fxy, fnm, fvalid, F, mxy, mnm, mvalid, M, t0, prior, out_t, out_stats, out_iters, p);
  return (int)cudaGetLastError();
}
