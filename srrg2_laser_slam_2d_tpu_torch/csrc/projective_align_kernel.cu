// Dense beam-space projective alignment of two clouds: the large-motion
// aligner's whole Gauss-Newton loop in one launch.
//
// Replaces srrg2_laser_slam_2d_tpu/ops/pallas_projective_align.py:
// fused_projective_align (pallas_call at :303).
//
// The fixed cloud is z-buffered once into a canvas (closest depth per beam,
// ties averaged). Every pass moves the whole moving cloud by the current
// estimate and z-buffers it too, so each beam holds at most one moving
// point (the closest, ties averaged); beams where both sides hold a point
// are matched under the depth and normal gates, and the nine sums, the
// odometry prior, the Cramer solve and the pre-multiplied update follow.
// `iterations` updates, then one more pass for the final statistics.
//
// Bound: about 52 operations a moving row and 67 a beam each pass (1.0
// MFLOP at M = B = 768, 11 passes) over some 30 KB in and out: well under
// a microsecond at the card's rates. What bounds this single block is its
// chain of 11 dependent passes, each a z-buffer, a block reduction and a
// 3x3 solve, and one SM's issue rate. So a pass spends as few instructions
// and barriers as it can, four barriers in all:
//  - one thread a beam and a moving row (B threads; one row a thread
//    measured faster than 2, 3 and 4, PERF.md);
//  - the valid moving rows are packed once at launch (a ballot scan, one
//    barrier at the routes' shapes; an invalid row adds nothing), and each
//    thread keeps its packed row in registers. Only the first kSharedRows
//    rows are packed; rows past them (a ball clip hands the kernel the
//    whole scene) are read from global memory at each pass, by a second
//    instance of the kernel (kGlobalRows): that path costs the routes'
//    instance 5 % even where it never runs (PERF.md);
//  - each pass z-buffers them with the compute-once z-buffer of
//    frame_common.cuh (zb_min, barrier, zb_add, barrier): each row's fields
//    (transform, depth, polynomial arctangent) ONCE, kept in registers, a
//    32-bit atomicMin on the depth bits, then each row at the minimum adds
//    one to its beam's count and the first stores its fields (a tied row
//    adds them to the beam's tie sums). Three or more rows at bitwise-equal
//    depths on one beam may differ from the reference's field * (1 / count)
//    in the last bit; one or two are exact;
//  - beam b is owned by thread b, which holds its fixed cell in registers
//    from launch, reads its moving cell (dividing only where rows tie),
//    matches the two where both hold a point (elsewhere match_terms gives
//    exact zeros: an empty moving beam holds depth 1e30, which enters only
//    the depth gate's difference, and an empty fixed beam has has-point 0
//    and zero fields), and empties its slot for the next pass; the next
//    barrier orders that before the next pass's atomics;
//  - the end of a pass is aligner_update (frame_common.cuh): the warps'
//    partial sums, a barrier, warp 0 alone sums, records, solves (the
//    prior's constants taken once, its share of a pass before the barrier)
//    and takes the new angle's cosine and sine, a second barrier hands
//    them to every warp;
//  - the fixed canvas by the same z-buffer, once; the first chunk of
//    moving rows and the fixed rows are loaded before the first barrier,
//    so their latencies overlap.

#include "frame_common.cuh"

constexpr int kSharedRows = 4096;   // moving rows the block packs in shared memory
constexpr int kFixedRegs = 4;       // fixed rows a thread keeps in registers while z-buffering

// ms: the moving rows packed in shared memory, min(M, kSharedRows).
__host__ __device__ constexpr size_t dense_smem_bytes(int B, int ms) {
  return sizeof(float4) * (size_t)ms + sizeof(float) * (kZbRows * (size_t)B + 32 * 16 + 8) +
         sizeof(int) * 4 * 32;
}

template <bool kGlobalRows>
__global__ void __launch_bounds__(1024, 1)
projective_align_kernel(const float* __restrict__ fxy, const float* __restrict__ fnm,
                        const unsigned char* __restrict__ fvalid, int F,
                        const float* __restrict__ mxy, const float* __restrict__ mnm,
                        const unsigned char* __restrict__ mvalid, int M,
                        const float* __restrict__ t0, const float* __restrict__ prior,
                        float* __restrict__ out_t, float* __restrict__ out_stats,
                        float* __restrict__ out_iters, FrameParams p) {
  extern __shared__ float4 smem4[];
  const int B = p.B, nt = blockDim.x, tid = threadIdx.x;   // nt == B: thread b owns beam b
  const int ms = min(M, kSharedRows);          // rows ms.. stay in global memory
  float4* s_rows = smem4;                      // [ms] packed valid moving rows
  float* s_zb = (float*)(s_rows + ms);         // [10][B] z-buffer slots
  float* s_part = s_zb + kZbRows * B;          // [32][16] warp partial sums
  float* s_pose = s_part + 32 * 16;            // [8] the pose, its cos and sin (aligner_update)
  int* s_scan = (int*)(s_pose + 8);            // [4][32] warp scan totals
  PHASE_BEGIN;

  // this thread's moving row c0 + tid of a chunk of nt rows; the first
  // chunk and the fixed rows' fields are loaded before the first barrier,
  // so their latencies overlap
  float4 q;
  int qv;
  auto load_row = [&](int c0) {
    const int r = c0 + tid;
    qv = (r < ms && mvalid[r]) ? 1 : 0;
    q = qv ? make_float4(mxy[2 * r], mxy[2 * r + 1], mnm[2 * r], mnm[2 * r + 1])
           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  };
  load_row(0);
  float T[3] = {t0[0], t0[1], t0[2]};
  const float P[3] = {prior[0], prior[1], prior[2]};
  PriorTerms prior_c = {};
  {
    const PackedCloud rows{fxy, fnm, fvalid};
    auto row_at = [&](int i) { return canvas_point(rows, i, p); };
    Fields f[kFixedRegs];
    zb_rows<kFixedRegs>(row_at, F, f);
    if (tid < 32) prior_c = aligner_constants(P, T[2], p, s_pose);   // warp 0 solves
    zb_clear(s_zb, B, tid);
    FRAME_SYNC();
    PHASE(0);
    zb_min<kFixedRegs>(row_at, F, f, s_zb);
    FRAME_SYNC();
    zb_add<kFixedRegs>(row_at, F, f, s_zb, B);
    FRAME_SYNC();
    PHASE(1);
  }
  // each owner keeps its beam's fixed cell in registers and empties the slot
  const Gathered fixed = zb_cell(s_zb, B, tid);
  zb_reset(s_zb, B, tid, zb_count(s_zb, B, tid));
  // the valid moving rows among the first ms packed in order (an invalid
  // row adds nothing), one ballot scan a chunk
  int nv = 0;
  for (int c0 = 0;;) {
    const bool in = qv;
    int total;
    block_scan_beams<1>(&qv, s_scan, total);
    if (in) s_rows[nv + (qv & 0xffff) - 1] = q;
    nv += total & 0xffff;
    c0 += nt;
    if (c0 >= ms) break;
    FRAME_SYNC();   // s_scan is rewritten by the next chunk
    load_row(c0);
  }
  FRAME_SYNC();   // the packed rows and the emptied slots, for every thread
  const bool ron = tid < nv;   // the thread holds a packed row
  if (ron) q = s_rows[tid];

  PHASE(2);
  float c = s_pose[3], s = s_pose[4];
  for (int it = 0; it <= p.iterations; ++it) {
    auto row_at = [&](int i) {
      const float4 r = s_rows[i];
      return fields_at(r.x, r.y, r.z, r.w, 1.0f, T, c, s, p);
    };
    auto global_at = [&](int i) {   // rows ms.., computed in each sweep
      const int r = ms + i;
      return fields_at(mxy[2 * r], mxy[2 * r + 1], mnm[2 * r], mnm[2 * r + 1],
                       mvalid[r] ? 1.0f : 0.0f, T, c, s, p);
    };
    Fields f;
    f.okp = false;   // the warps past the packed rows skip the fields
    if (ron) f = fields_at(q.x, q.y, q.z, q.w, 1.0f, T, c, s, p);
    zb_min<1>(row_at, nv, &f, s_zb);
    if constexpr (kGlobalRows) zb_min<0>(global_at, M - ms, &f, s_zb);
    FRAME_SYNC();
    PHASE(3);
    zb_add<1>(row_at, nv, &f, s_zb, B);
    if constexpr (kGlobalRows) zb_add<0>(global_at, M - ms, &f, s_zb, B);
    FRAME_SYNC();
    PHASE(4);
    float acc[kTerms] = {};
    const int cnt = zb_count(s_zb, B, tid);
    if (cnt > 0) {
      if (fixed.bhas > 0.5f) {
        const Gathered m = zb_cell(s_zb, B, tid);
        Fields fl;
        fl.d = m.bmin;
        fl.px = m.bfx; fl.py = m.bfy;
        fl.nx = m.bfnx; fl.ny = m.bfny;
        fl.col = tid; fl.okp = true;
        match_terms(fl, fixed, p, acc);
      }
      zb_reset(s_zb, B, tid, cnt);
    }
    float inc[9];
    if (p.use_prior && tid < 32) prior_increments(prior_c, T, p.odom_weight, inc);
    PHASE(5);
    aligner_update(acc, inc, it, p, T, c, s, s_part, s_pose, out_t, out_stats, out_iters);
    PHASE(6);
  }
  PHASE_END;
}

PHASE_EXPORT

static unsigned long long g_smem_set[2] = {0, 0};   // per instance

extern "C" int projective_align(const float* fxy, const float* fnm,
                                const unsigned char* fvalid, int F, const float* mxy,
                                const float* mnm, const unsigned char* mvalid, int M,
                                const float* t0, const float* prior, float* out_t,
                                float* out_stats, float* out_iters,
                                const FrameParams* params, void* stream) {
  const FrameParams p = *params;
  if (p.B > 1024 || p.B <= 0 || p.B % 128 || p.iterations > 128 || F < 0 || M < 0)
    return (int)cudaErrorInvalidValue;
  const bool global_rows = M > kSharedRows;
  auto kernel = global_rows ? projective_align_kernel<true> : projective_align_kernel<false>;
  cudaError_t err = smem_limit_once(kernel, dense_smem_bytes(1024, kSharedRows),
                                    g_smem_set[global_rows]);
  if (err != cudaSuccess) return (int)err;
  kernel<<<1, p.B, dense_smem_bytes(p.B, global_rows ? kSharedRows : M),
           (cudaStream_t)stream>>>(fxy, fnm, fvalid, F, mxy, mnm, mvalid, M, t0, prior, out_t,
                                   out_stats, out_iters, p);
  return (int)cudaGetLastError();
}
