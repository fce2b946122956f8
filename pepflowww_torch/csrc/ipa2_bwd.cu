// Fused IPA interior (v2), backward, for Hopper, sm_90a (K8).
//
// Replaces: pepflowww_tpu/models/pallas_ipa2.py::fused_ipa2_bwd (body
// `_bwd_kernel` :189, pallas_call :373), the backward half of
// `fused_ipa2_vjp` (:398).
//
// For the cotangents go, goptl, gnorm, gopair of the forward's outputs
// (ipa2.cu), with a the recomputed softmax weights of one (b, h):
//   goptl' = goptl + optl * gnorm / norm;  goptg = R goptl'  (per query row)
//   g_a[i, j] = bf16(go_i).v_j + goptg_i.vg_j + gopair_i.pz_ij
//   gs = a * (g_a - sum_j a g_a);  gbias = gs / sqrt(3)
//   gq = bf16(gs) k / sqrt(3C), gk = bf16(gs)^T q / sqrt(3C), gv = bf16(a)^T bf16(go)
//   gvg = a^T goptg, gqg = -rowsum(gs) qg + gs kg, gkg = -colsum(gs) kg + gs^T qg
//   gpz[i, j] = sum_h a_h[i, j] gopair_h[i]
// then the frame-transform backward of the q, k and v points (gqp, gkvp and
// the rows' gr9, gt), and the point-weight partials
// gsw[b, h] = (sum gqg.qg + sum gkg.kg) / sw_h. The rounding points are the
// JAX kernel's: bf16(a) only in gv, bf16(go) in g_a's scalar term and in
// gv, bf16(gs) in gq and gk; the fp32 a and gs everywhere else.
//
// What bounds it on this card: the bytes of the function (~78 MB at B=32,
// L=64 with the fp32 gradients of the (B, H, L, L) bias and the
// (B, L, L, 16) pair features: ~23 us at 3.35 TB/s). Its five 128-deep bf16
// products (q.k^T, bf16(go).v^T, gq, gk, gv: ~0.67 G MACs at B=32, L=64,
// H=8) take ~1.4 us on the tensor cores, its fp32 work (point and pair
// terms, softmax backward) a few us on the fp32 units.
//
// Design for L <= 64 (training's L = 64, and every shorter L): two
// launches, no (B, H, L, L) scratch.
// The tile kernel: one block of one warpgroup per (b, h) owns the whole
// 64 x 64 (i, j) tile (rows and keys past L are zero-filled and get a = 0).
// A block:
//   1. copies Q, K, V by 16-byte cp.async into 128-byte swizzled panels
//      (ipa2_tile.cuh); the points and frames are fetched first and moved to
//      the global frame: qg of the thread's two accumulator rows in
//      registers, kg and vg in shared memory. go, the pair features and the
//      bias go to L2 meanwhile (bulk prefetches).
//   2. S = Q.K^T on wgmma (both K-major), the point term, bias, mask and
//      scales added in the accumulator layout, the softmax in registers
//      over the one tile (K7's steps 2-3); the fp32 a to shared memory.
//   3. optg = a.vg on the CUDA cores (a thread per row and half of its 36
//      columns), then optl, norm, goptl', goptg (to shared memory) and the
//      row's inverse-transform d R (registers; its d t, -goptg, is added
//      with the value points' in step 7).
//   4. go, rounded to bf16, staged as a tile; g_a = bf16(go).V^T on wgmma
//      (both K-major), plus goptg.vg and gopair.pz in fp32 in the
//      accumulator layout: each pair's 16 channels are read by the one
//      thread that holds the pair (two 16-byte loads in training's layout).
//      D_i = sum_j a g_a by quad shuffles, gs = a (g_a - D).
//   5. gq = bf16(gs).K: bf16(gs) is the A operand straight from registers (a
//      bf16 pair of accumulator blocks 2s, 2s+1 is the A fragment of depth
//      step s), K the MN-major B read with the transpose-B immediate. Before
//      it, bf16(gs) and bf16(a) go into V's space as [i][64 j] swizzled
//      panels; after it, the fp32 gs into K's.
//   6. gk = bf16(gs)^T.Q and gv = bf16(a)^T.bf16(go): the panels read as
//      MN-major A (transpose-A, wgmma.cuh desc_sw128_mn), Q and bf16(go) as
//      MN-major B; C = 128 as two n64 products each. gbias = gs / sqrt(3)
//      goes out from the fp32 copy, coalesced, while gk runs.
//   7. The fp32 point gradients from the fp32 gs and a in shared memory
//      (gqg by rows, gkg and gvg by columns, with the row and column sums),
//      the three frame-transform backwards (gqp, gkvp, staged and written
//      out coalesced), gsw[b, h] written directly, and each residue's d R,
//      d t of this head to a (B, H, L, 12) partial.
// The pair kernel: one block per (b, 8 query rows) sums over heads in order
// gpz[b, i, j] = sum_h a_h[i, j] gopair_h[i], recomputing each head's
// weights of its rows as the tile kernel does (q.k of the bf16 values with
// fp32 sums on mma.sync, the same point term, bias, mask and softmax in
// fp32; K of the next head copied during this one's), and gr9, gt of its
// rows from the partials. gpz needs every head's a at once. Summing it
// inside a thread-block cluster of a batch row's 8 head blocks (through
// distributed shared memory) fits only 30 such clusters on an H100 at once
// (the GPCs hold 4 clusters of 4 SMs, one holds 2): 240 of B=32's 256
// blocks, then a second wave of the whole tile kernel's length. Recomputing
// a costs less. 114,192 bytes of shared memory and at most 255 registers a
// thread in the tile kernel: two blocks an SM, the 256 blocks of B=32 in
// one wave. It reads a pair's 16 channels as 32 contiguous, 16-byte aligned
// bytes, as training's down_z lays them out (the wrapper copies any other
// layout).
//
// L > 64 (training's buckets 96 ... 256; the card checks' L = 65, 100):
// three launches, the flash-attention backward with this kernel's point and
// pair terms, on the tile kernel's parts: 64-row tiles in 128-byte swizzled
// panels, the five 128-deep products on wgmma, no (B, H, L, L) scratch (the
// only (B, H, L, L) and (B, L, L, 16) writes are the gbias and gpz outputs).
// The row statistics go through an O(L) fp32 scratch: STAT (B, H, L, 4) holds
// each query row's maximum logit m, 1 / l (l its sum of exp) and D; GOPTG
// (B, H, L, 40) its goptg, 36 columns as halves of 18 at 0 and 20 (copied
// as they lie by the key kernel). A row's running fp32 sums over the tiles
// (p.vg, gs.kg, a.goptg, gs.qg, the row and column sums of gs) wait between
// tiles in its thread's slots of SUMS (B, H, 64 ceil(L / 64), 64: a block's
// 64 rows each, the ragged tile's too), not in registers: held across a
// tile's products and pair terms they made the kernels spill.
//   1. The query kernel, one block of one warpgroup per (b, h, 64 query
//      rows), sweeps the 64-key tiles twice. Each tile's K and V go by
//      cp.async into swizzled panels, its key points to the global frame
//      and its frames over the weights' space; the logits are the tile
//      kernel's (S = Q.K^T on wgmma, the point term, bias, mask and scales
//      in the accumulator layout), the rows' query points taken again each
//      tile.
//      Sweep 1, online (the flash-attention forward's recurrence): each
//      row's running max m and sum of exp l; p = exp(s - m); the point sums
//      p.vg (row ar, its half of the 36 columns, through p in shared memory)
//      and D's scalar and pair parts sum_j p (bf16(go).v_j + gopair.pz_ij)
//      (g' = bf16(go).V^T on wgmma, the pair term in the accumulator
//      layout), each shrunk by exp(m_old - m_new) when a row's max grows and
//      divided by l at the end: optg and D'. Then per row optl, norm,
//      goptl', goptg (to GOPTG and shared memory), the inverse transform's
//      d R, d t (to the row partials GRQ), and D = D' + goptg.optg: in real
//      arithmetic sum_j a_ij goptg_i.vg_j = goptg_i.optg_i, so D is the JAX
//      kernel's sum_j a g_a with its fp32 terms in another order, and the
//      sweep does not wait for goptg. The weights a of the products stay at
//      the JAX kernel's rounding point: exp(s - m) / l with the final m, l.
//      Sweep 2: a from the saved m, 1/l; g_a = bf16(go).V^T + goptg.vg +
//      gopair.pz, gs = a (g_a - D); gq += bf16(gs).K on wgmma (bf16(gs) the
//      A fragment from registers, K read MN-major), summed over the key
//      tiles in order in the gq output itself (each block owns its rows; the
//      scale 1/sqrt(3C) goes on with the last tile), so that no accumulator
//      stays live across tiles; gbias = gs / sqrt(3) written coalesced from
//      the fp32 gs in shared memory; row ar's gs.kg and row sum. Then gqg,
//      the query points' frame-transform backward (gqp staged and written
//      coalesced, the rows' d R, d t added to GRQ) and the block's gsw
//      partial.
//   2. The key kernel, one block per (b, h, 64 key rows), sweeps the 64-row
//      query tiles once, in the transposed orientation: S^T = K.Q^T and
//      g_a^T = V.bf16(go)^T on wgmma with the keys as the M rows, the same
//      point, bias, mask and pair terms, a and gs from the saved m, 1/l, D
//      and goptg; gk += bf16(gs)^T.Q and gv += bf16(a)^T.bf16(go) with the
//      accumulators packed as the A fragments and Q, bf16(go) read MN-major,
//      summed over the query tiles in order in the gkv output; key row ar's
//      gvg = a^T.goptg, gs^T.qg and column sum through the fp32 a and gs in
//      shared memory. Then gkg, the key and value points' frame backwards
//      (gkvp staged and written coalesced; GRK) and the block's gsw partial.
//   3. The pair kernel, one block per (b, 16 query rows), walks the keys in
//      chunks of 32: for the heads in order 0 .. H-1, two a step, it
//      recomputes the rows' weights of the chunk in one pass from the saved
//      m, 1/l (q.k on mma.sync m16n8k16, the block's 16 rows its M rows, the
//      same point term, bias and mask in fp32; the next step's K and q
//      copied during this one's) and sums gpz = sum_h a_h gopair_h. Then gr9,
//      gt of its rows from GRQ, GRK (for each head the query side, then the
//      key side) and, in the blocks of query rows 0 .. 15, gsw[b, :] from the
//      blocks' partials, each in a fixed order.
// What the card showed (ipa2_stages.py's stage clocks, ptxas -v): code size
// and registers, not the tensor cores, set the time. Fully unrolled loops
// over a tile's 16 columns made a sweep's code larger than the instruction
// cache, so the logits and pair terms loop over 8-column blocks
// (rotate_block), and the compiler's hoisting of loads and addresses spilled
// registers (mem_fence_compiler, opaque_int). 114,960 and 115,216 bytes of
// shared memory in the query and key kernels: two blocks an SM.
// Nothing is summed across blocks except through partials added in a fixed
// order (no atomics): two calls give bit-identical gradients.

#include "ipa2_tile.cuh"

namespace {

using namespace ipa2;

struct BwdArgs {
  const bf16 *q, *kv, *qp, *kvp, *bias, *pz;
  const float *r9, *t, *maskb, *sw;
  const float *go, *goptl, *gnorm, *gopair;
  float *STAT, *GOPTG, *GRQ, *GRK, *GSWQ, *GSWK, *SUMS;                 // scratch
  float *gq, *gkv, *gqp, *gkvp, *gr9, *gt, *gbias, *gpz, *gsw;          // outputs
#ifdef IPA2_STAMPS
  long long* stamps;
#endif
  Layout st;
  int B, L, H, nT;
  bool qp_vec, kvp_vec;
  float eps, s1, s2;
};

// ================================================================ L <= 64: the tile kernel
constexpr int PK = PQ + PV;      // key | value points a head
constexpr int LDK1 = 28;         // fp32 row stride of kg, qg, gqg, gkg
constexpr int LDV1 = 44;         // fp32 row stride of vg: halves of 18 at 0, 20
constexpr int LDO1 = 40;         // fp32 row stride of goptg (halves at 0, 20) and gvg

constexpr int O_Q = 0;                          // bf16 panels of Q
constexpr int O_K = O_Q + TILE_BYTES;           // K
constexpr int O_V = O_K + TILE_BYTES;           // V
constexpr int O_GO = O_V + TILE_BYTES;          // bf16(go)
constexpr int O_A = O_GO + TILE_BYTES;          // fp32 a, [64][64] swizzled (sw64)
constexpr int O_KG = O_A + TQ * TQ * 4;         // fp32 [64][LDK1]
constexpr int O_KSQ = O_KG + TQ * LDK1 * 4;     // fp32 [64]
constexpr int O_VG = O_KSQ + TQ * 4;            // fp32 [64][LDV1]
constexpr int O_OG = O_VG + TQ * LDV1 * 4;      // fp32 [64][LDO1]: goptg
constexpr int O_RT = O_OG + TQ * LDO1 * 4;      // fp32 [64][12]: R, t of the rows
constexpr int O_MB = O_RT + TQ * 12 * 4;        // fp32 [64]: key masks
constexpr int O_RED = O_MB + TQ * 4;            // fp32 [4]
constexpr int SMEM1 = O_RED + 16;
// Over tiles that are no longer read: after g_a, V's space holds the bf16
// gs and a panels; after gq, K's the fp32 gs; after gk and gv, Q's,
// bf16(go)'s and V's the point gradients; after those, K's and V's the
// staged gqp, gkvp.
constexpr int O_GSB = O_V;                      // bf16 gs, [64 i][64 j] swizzled panel
constexpr int O_AB = O_V + PANEL;               // bf16 a, the same
constexpr int O_GS = O_K;                       // fp32 gs, [64][64] swizzled (sw64)
constexpr int O_QG = O_Q;                       // fp32 [64][LDK1]
constexpr int O_GQG = O_Q + TQ * LDK1 * 4;      // fp32 [64][LDK1]
constexpr int O_GKG = O_GO;                     // fp32 [64][LDK1]
constexpr int O_GVG = O_V;                      // fp32 [64][LDO1]
constexpr int O_GQP = O_V + TQ * LDO1 * 4;      // fp32 [3][L][PQ]: gqp of this head
constexpr int O_GKVP = O_K;                     // fp32 [3][L][PK]: gkvp of this head (after gs)
static_assert(O_K % 1024 == 0 && O_V % 1024 == 0 && O_GO % 1024 == 0, "panels on 1024 bytes");
static_assert(2 * TQ * LDK1 * 4 <= TILE_BYTES && TQ * LDO1 * 4 <= TILE_BYTES, "overlays fit");
static_assert(O_GQP - O_V + 3 * TQ * PQ * 4 <= TILE_BYTES && 3 * TQ * PK * 4 <= TILE_BYTES,
              "the point gradients' staging fits");
static_assert(2 * (SMEM1 + 1024) <= 233472, "two blocks an SM");
#ifdef IPA2_STAMPS
constexpr int N_STAMPS = 12;
#endif

// Element (r, c) of a [64][64] fp32 tile whose 16-byte groups are permuted
// by row: conflict-free for a row's float4 reads and a column's reads.
__device__ __forceinline__ int sw64(int r, int c) {
  return r * TQ + ((((c >> 2) ^ (r & 15)) << 2) | (c & 3));
}

// Column x (< 36) of a row split into halves of 18 at 0 and 20.
__device__ __forceinline__ int half20(int x) { return x < 18 ? x : x + 2; }

// The 16 pair channels pz[b, i, j, :] (contiguous, 16-byte aligned) as fp32.
__device__ __forceinline__ void pair_row(float (&z)[CZ4], const bf16* pz_b, const long long* st,
                                         int i, int j) {
  const uint4* p = reinterpret_cast<const uint4*>(pz_b + i * st[1] + j * st[2]);
  float lo[8], hi[8];
  unpack8(p[0], lo);
  unpack8(p[1], hi);
#pragma unroll
  for (int d = 0; d < 8; ++d) z[d] = lo[d], z[8 + d] = hi[d];
}

// Frame-transform backward of one residue's P points for u = (R x + t) *
// scale: gx[d][p] = sum_c R[c][d] gu[c][p] * scale to the output planes
// (`plane` apart), and the residue's d R[c][d] += sum_p x[d][p] gu[c][p]
// * scale, d t[c] += sum_p (gu[c][p] * scale - sub[c][p]) into acc, with
// sub (if given) a row split into halves of 18 at 0 and 20.
template <int P>
__device__ __forceinline__ void frame_bwd(const RawRow& r, const float* gu, const float* rt,
                                          float scale, float* gx, long long plane,
                                          float (&acc)[12], const float* sub = nullptr) {
#pragma unroll
  for (int u = 0; u < P / 2; ++u) {
    float x[3][2];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.w[d][u]));
      x[d][0] = f.x;
      x[d][1] = f.y;
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int p = 2 * u + e;
      const float g0 = gu[p] * scale, g1 = gu[P + p] * scale, g2 = gu[2 * P + p] * scale;
#pragma unroll
      for (int d = 0; d < 3; ++d) gx[d * plane + p] = rt[d] * g0 + rt[3 + d] * g1 + rt[6 + d] * g2;
      const float gc[3] = {g0, g1, g2};
#pragma unroll
      for (int c = 0; c < 3; ++c) {
#pragma unroll
        for (int d = 0; d < 3; ++d) acc[3 * c + d] = fmaf(x[d][e], gc[c], acc[3 * c + d]);
        acc[9 + c] += sub ? gc[c] - sub[half20(c * P + p)] : gc[c];
      }
    }
  }
}

__global__ void __launch_bounds__(NTH, 2) ipa2_bwd_tile_kernel(const __grid_constant__ BwdArgs a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  if (base & 1023) __trap();   // the swizzle is taken from the address bits
  const uint32_t q_s = base + O_Q, k_s = base + O_K, v_s = base + O_V, go_s = base + O_GO;
  float* a_s = reinterpret_cast<float*>(smem + O_A);
  float* kg_s = reinterpret_cast<float*>(smem + O_KG);
  float* ksq_s = reinterpret_cast<float*>(smem + O_KSQ);
  float* vg_s = reinterpret_cast<float*>(smem + O_VG);
  float* og_s = reinterpret_cast<float*>(smem + O_OG);
  float* rt_s = reinterpret_cast<float*>(smem + O_RT);
  float* mb_s = reinterpret_cast<float*>(smem + O_MB);
  float* red_s = reinterpret_cast<float*>(smem + O_RED);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int ra = 16 * warp + g, rb = ra + 8;   // this thread's rows of the accumulators
  const int ar = tid >> 1, ah = tid & 1;       // its row and half in the row-wise stages
  const int h = blockIdx.x, b = blockIdx.y;
  const int L = a.L, H = a.H;
  const float sw = a.sw[h], s1 = a.s1, s2 = a.s2;
  const long long HC = (long long)H * C;
  const long long row0 = (long long)b * L;     // the residue row of (b, 0)
  const long long bh = (long long)b * H + h;
  const bf16* kv_b = a.kv + row0 * 2 * HC + 2LL * h * C;
  // Stamp k of this block (thread 0; a diagnostic build's stamped call).
#ifdef IPA2_STAMPS
  auto mark = [&](int k) {
    if (a.stamps && tid == 0) a.stamps[N_STAMPS * bh + k] = global_ns();
  };
#else
  auto mark = [](int) {};
#endif
  mark(0);

  // 1. The points' and frames' loads first, then the tile copies: Q and K
  // (one group), V (a second); go rounded to bf16 into its panels.
  RawRow rqa, rqb, rk;
  fetch_row<PQ>(rqa, a.qp, a.st.qp, b, h, 0, ra, a.qp_vec, ra < L);
  fetch_row<PQ>(rqb, a.qp, a.st.qp, b, h, 0, rb, a.qp_vec, rb < L);
  if (ah == 0)
    fetch_row<PQ>(rk, a.kvp, a.st.kvp, b, h, 0, ar, a.kvp_vec, ar < L);
  else
    fetch_row<PV>(rk, a.kvp, a.st.kvp, b, h, PQ, ar, a.kvp_vec, ar < L);
  Frames fr;
  fetch_frames(fr, a.r9, a.t, a.maskb, row0, L, tid);
  // The pair features of batch row b into L2 for step 4, the head blocks
  // taking its rows in turn (a row's pairs are contiguous in
  // training's layout; otherwise they are left to the loads).
  if (a.st.pz[2] == CZ4 && tid < L && tid % H == h)
    prefetch_l2(a.pz + b * a.st.pz[0] + tid * a.st.pz[1], L * CZ4 * 2);
  // The same for the bias in training's layout, all heads of a row i
  // contiguous ((B, L, L, H) permuted): each block fetches its share.
  if (a.st.bias[1] == 1 && a.st.bias[3] == H && a.st.bias[2] == (long long)L * H &&
      (L * H) % 8 == 0 && tid < L && tid % H == h)
    prefetch_l2(a.bias + b * a.st.bias[0] + tid * a.st.bias[2], L * H * 2);
  load_tile(q_s, a.q + row0 * HC + h * C, HC, 0, L, tid);
  load_tile(k_s, kv_b, 2 * HC, 0, L, tid);
  cp_async_commit();
  load_tile(v_s, kv_b + C, 2 * HC, 0, L, tid);
  cp_async_commit();
  // go goes to L2 now; it is staged, rounded to bf16, before step 4.
  if (tid < L) prefetch_l2(a.go + (row0 + tid) * HC + h * C, C * 4);
  store_frames(fr, rt_s, mb_s, tid);
  __syncthreads();
  mark(1);

  // The query points of rows ra, rb in registers; row ar's key points (half
  // 0) or value points (half 1) in the global frame into shared memory.
  float qga[P3Q], qgb[P3Q];
  to_global<PQ>(rqa, rt_s + ra * 12, qga, sw);
  to_global<PQ>(rqb, rt_s + rb * 12, qgb, sw);
  float qsqa = 0.f, qsqb = 0.f;
#pragma unroll
  for (int x = 0; x < P3Q; ++x) {
    qsqa = fmaf(qga[x], qga[x], qsqa);
    qsqb = fmaf(qgb[x], qgb[x], qsqb);
  }
  if (ah == 0) {
    float kg[P3Q];
    to_global<PQ>(rk, rt_s + ar * 12, kg, sw);
    float sq = 0.f;
#pragma unroll
    for (int x = 0; x < P3Q; ++x) sq = fmaf(kg[x], kg[x], sq);
    float4* dst = reinterpret_cast<float4*>(kg_s + ar * LDK1);
#pragma unroll
    for (int u = 0; u < P3Q / 4; ++u)
      dst[u] = make_float4(kg[4 * u], kg[4 * u + 1], kg[4 * u + 2], kg[4 * u + 3]);
    ksq_s[ar] = sq;
  } else {
    float vg[P3V];
    to_global<PV>(rk, rt_s + ar * 12, vg, 1.f);
    float2* dst = reinterpret_cast<float2*>(vg_s + ar * LDV1);
#pragma unroll
    for (int u = 0; u < 9; ++u) {
      dst[u] = make_float2(vg[2 * u], vg[2 * u + 1]);
      dst[10 + u] = make_float2(vg[18 + 2 * u], vg[19 + 2 * u]);
    }
  }

  // 2. S = Q.K^T; the bias of rows ra, rb through its strides while it runs.
  cp_async_wait_group<1>();   // Q and K (V may still fly)
  fence_proxy_async();        // this thread's copies, for wgmma
  __syncthreads();            // ... and everyone's, the points and the frames
  float s[32];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < C / 16; ++kk)
    mma_ss_n64(s, desc_sw128(q_s + (kk >> 2) * PANEL + (kk & 3) * 32),
               desc_sw128(k_s + (kk >> 2) * PANEL + (kk & 3) * 32), kk > 0);
  wgmma_commit();
  const long long* stb = a.st.bias;
  const bf16* bias_bh = a.bias + b * stb[0] + h * stb[1];
  const bf16* bias_a = bias_bh + (ra < L ? ra : 0) * stb[2];
  const bf16* bias_b = bias_bh + (rb < L ? rb : 0) * stb[2];
  float bia[16], bib[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int c = 8 * (k >> 1) + 2 * q + (k & 1), cc = c < L ? c : 0;
    bia[k] = bf2f(bias_a[cc * stb[3]]);
    bib[k] = bf2f(bias_b[cc * stb[3]]);
  }
  wgmma_wait_all();
  fence_regs(s);
  // Logits in the accumulator layout (entry 4j + e, e < 2: row ra, key
  // 8j + 2q + e; 4j + 2 + e: row rb), -inf past L in either direction.
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 8 * j + 2 * q + e;
      if (c < L) {
        const float4* kr = reinterpret_cast<const float4*>(kg_s + c * LDK1);
        float pa = 0.f, pb = 0.f, pa2 = 0.f, pb2 = 0.f;   // two chains a row
#pragma unroll
        for (int u = 0; u < P3Q / 4; ++u) {
          const float4 k4 = kr[u];
          pa = fmaf(qga[4 * u], k4.x, pa);
          pa2 = fmaf(qga[4 * u + 1], k4.y, pa2);
          pa = fmaf(qga[4 * u + 2], k4.z, pa);
          pa2 = fmaf(qga[4 * u + 3], k4.w, pa2);
          pb = fmaf(qgb[4 * u], k4.x, pb);
          pb2 = fmaf(qgb[4 * u + 1], k4.y, pb2);
          pb = fmaf(qgb[4 * u + 2], k4.z, pb);
          pb2 = fmaf(qgb[4 * u + 3], k4.w, pb2);
        }
        pa += pa2;
        pb += pb2;
        const float ksq = ksq_s[c], mb = mb_s[c];
        s[4 * j + e] = ra < L ? s[4 * j + e] * s1 + bia[2 * j + e] * s2 -
                                    0.5f * (qsqa + ksq - 2.f * pa) + mb
                              : -INFINITY;
        s[4 * j + 2 + e] = rb < L ? s[4 * j + 2 + e] * s1 + bib[2 * j + e] * s2 -
                                        0.5f * (qsqb + ksq - 2.f * pb) + mb
                                  : -INFINITY;
      } else {
        s[4 * j + e] = -INFINITY;
        s[4 * j + 2 + e] = -INFINITY;
      }
    }
  }
  // The softmax of each row over its one tile (a row's 64 logits lie on a
  // quad); a row wholly at -inf (past L) gets a = 0.
  {
    float ma = -INFINITY, mb = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      ma = fmaxf(ma, fmaxf(s[4 * j], s[4 * j + 1]));
      mb = fmaxf(mb, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    ma = fmaxf(ma, __shfl_xor_sync(FULL, ma, 1));
    ma = fmaxf(ma, __shfl_xor_sync(FULL, ma, 2));
    mb = fmaxf(mb, __shfl_xor_sync(FULL, mb, 1));
    mb = fmaxf(mb, __shfl_xor_sync(FULL, mb, 2));
    float la = 0.f, lb = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[4 * j + e] = ma == -INFINITY ? 0.f : expf(s[4 * j + e] - ma);
        s[4 * j + 2 + e] = mb == -INFINITY ? 0.f : expf(s[4 * j + 2 + e] - mb);
        la += s[4 * j + e];
        lb += s[4 * j + 2 + e];
      }
    }
    la += __shfl_xor_sync(FULL, la, 1);
    la += __shfl_xor_sync(FULL, la, 2);
    lb += __shfl_xor_sync(FULL, lb, 1);
    lb += __shfl_xor_sync(FULL, lb, 2);
    const float inva = la > 0.f ? 1.f / la : 0.f, invb = lb > 0.f ? 1.f / lb : 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[4 * j + e] *= inva;
        s[4 * j + 2 + e] *= invb;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 8 * j + 2 * q;
    *reinterpret_cast<float2*>(a_s + sw64(ra, c)) = make_float2(s[4 * j], s[4 * j + 1]);
    *reinterpret_cast<float2*>(a_s + sw64(rb, c)) = make_float2(s[4 * j + 2], s[4 * j + 3]);
  }
  __syncthreads();
  mark(2);

  // 3. optg = a.vg for row ar, columns 18 ah .. 18 ah + 17; the halves trade
  // six sums so that each holds the three coordinates of its six points.
  float rowc[12];   // row ar's d R (9), d t (3) of this head, this thread's share
#pragma unroll
  for (int k = 0; k < 12; ++k) rowc[k] = 0.f;
  {
    // The cotangents of row ar's six points, loaded before the sums.
    const long long row = row0 + (ar < L ? ar : 0);
    float gn[6], glc[6][3];
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const int p = 6 * ah + k;
      gn[k] = a.gnorm[row * H * PV + h * PV + p];
#pragma unroll
      for (int c = 0; c < 3; ++c) glc[k][c] = a.goptl[row * 3 * H * PV + c * H * PV + h * PV + p];
    }
    float pacc[18];
#pragma unroll
    for (int x = 0; x < 18; ++x) pacc[x] = 0.f;
    for (int u = 0; u < TQ / 4; ++u) {
      const float4 a4 = *reinterpret_cast<const float4*>(a_s + ar * TQ + ((u ^ (ar & 15)) << 2));
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* vr = vg_s + (4 * u + e) * LDV1 + 20 * ah;
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const float4 v = reinterpret_cast<const float4*>(vr)[x];
          pacc[4 * x] = fmaf(av[e], v.x, pacc[4 * x]);
          pacc[4 * x + 1] = fmaf(av[e], v.y, pacc[4 * x + 1]);
          pacc[4 * x + 2] = fmaf(av[e], v.z, pacc[4 * x + 2]);
          pacc[4 * x + 3] = fmaf(av[e], v.w, pacc[4 * x + 3]);
        }
        const float2 v = reinterpret_cast<const float2*>(vr)[8];
        pacc[16] = fmaf(av[e], v.x, pacc[16]);
        pacc[17] = fmaf(av[e], v.y, pacc[17]);
      }
    }
    float oth[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) oth[k] = __shfl_xor_sync(FULL, pacc[6 + k], 1);
    const float* Rr = rt_s + ar * 12;
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const int p = 6 * ah + k;
      float gg[3] = {0.f, 0.f, 0.f};
      if (ar < L) {
        const float dif[3] = {(ah ? oth[k] : pacc[k]) - Rr[9],
                              (ah ? pacc[k] : pacc[12 + k]) - Rr[10],
                              (ah ? pacc[12 + k] : oth[k]) - Rr[11]};
        float loc[3], nsq = a.eps;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          loc[c] = Rr[c] * dif[0] + Rr[3 + c] * dif[1] + Rr[6 + c] * dif[2];
          nsq += loc[c] * loc[c];
        }
        const float nrm = sqrtf(nsq);
        float gl[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) gl[c] = glc[k][c] + loc[c] * gn[k] / nrm;
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          gg[d] = Rr[3 * d] * gl[0] + Rr[3 * d + 1] * gl[1] + Rr[3 * d + 2] * gl[2];
#pragma unroll
          for (int c = 0; c < 3; ++c) rowc[3 * d + c] = fmaf(dif[d], gl[c], rowc[3 * d + c]);
        }
      }
#pragma unroll
      for (int d = 0; d < 3; ++d) og_s[ar * LDO1 + half20(d * PV + p)] = gg[d];
    }
  }

  // 4. g_a = bf16(go).V^T; gopair of rows ra, rb while it runs; then the
  // point and pair terms, D and gs.
  mark(3);
  {
    // go rounded to bf16 into its panels, as load_tile places a tile (rows
    // past L zero).
    const float* go_b = a.go + row0 * HC + h * C;
    float4 x[8][2];
#pragma unroll
    for (int k = 0; k < 8; ++k) {   // all loads first; rows past L read row 0
      const int idx = tid + NTH * k, r = idx >> 4, c = idx & 15;
      const float4* src = reinterpret_cast<const float4*>(go_b + (r < L ? r : 0) * HC + 8 * c);
      x[k][0] = src[0];
      x[k][1] = src[1];
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int idx = tid + NTH * k, r = idx >> 4, c = idx & 15;
      uint4 w = make_uint4(0u, 0u, 0u, 0u);
      if (r < L)
        w = make_uint4(pack_bf16(x[k][0].x, x[k][0].y), pack_bf16(x[k][0].z, x[k][0].w),
                       pack_bf16(x[k][1].x, x[k][1].y), pack_bf16(x[k][1].z, x[k][1].w));
      *reinterpret_cast<uint4*>(smem + O_GO + (c >> 3) * PANEL + sw128_offset(r, c & 7)) = w;
    }
  }
  cp_async_wait_all();
  fence_proxy_async();
  __syncthreads();   // V has landed, bf16(go) is stored, goptg is complete
  float ga[32];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < C / 16; ++kk)
    mma_ss_n64(ga, desc_sw128(go_s + (kk >> 2) * PANEL + (kk & 3) * 32),
               desc_sw128(v_s + (kk >> 2) * PANEL + (kk & 3) * 32), kk > 0);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(ga);
  mark(4);
  {
    // goptg_i.vg_j over the 36 columns, in chunks of 4 (and 2 at each half's end).
    const float* oa = og_s + ra * LDO1;
    const float* ob = og_s + rb * LDO1;
#pragma unroll
    for (int k = 0; k < 10; ++k) {
      const int off = k < 5 ? 4 * k : 20 + 4 * (k - 5);
      const bool two = k == 4 || k == 9;
      float xa[4], xb[4];
      if (two) {
        const float2 u = *reinterpret_cast<const float2*>(oa + off);
        const float2 w = *reinterpret_cast<const float2*>(ob + off);
        xa[0] = u.x, xa[1] = u.y, xa[2] = 0.f, xa[3] = 0.f;
        xb[0] = w.x, xb[1] = w.y, xb[2] = 0.f, xb[3] = 0.f;
      } else {
        const float4 u = *reinterpret_cast<const float4*>(oa + off);
        const float4 w = *reinterpret_cast<const float4*>(ob + off);
        xa[0] = u.x, xa[1] = u.y, xa[2] = u.z, xa[3] = u.w;
        xb[0] = w.x, xb[1] = w.y, xb[2] = w.z, xb[3] = w.w;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float* vr = vg_s + (8 * j + 2 * q + e) * LDV1 + off;
          float v[4];
          if (two) {
            const float2 t2 = *reinterpret_cast<const float2*>(vr);
            v[0] = t2.x, v[1] = t2.y, v[2] = 0.f, v[3] = 0.f;
          } else {
            const float4 t4 = *reinterpret_cast<const float4*>(vr);
            v[0] = t4.x, v[1] = t4.y, v[2] = t4.z, v[3] = t4.w;
          }
#pragma unroll
          for (int x = 0; x < (two ? 2 : 4); ++x) {
            ga[4 * j + e] = fmaf(xa[x], v[x], ga[4 * j + e]);
            ga[4 * j + 2 + e] = fmaf(xb[x], v[x], ga[4 * j + 2 + e]);
          }
        }
      }
    }
  }
  mark(5);
  {
    // gopair_i.pz_ij: each pair's 16 channels, read by the thread that holds
    // it; two key blocks' loads (16 of 16 bytes) are issued before their sums.
    const int ia = ra < L ? ra : 0, ib = rb < L ? rb : 0;   // rows past L read row 0
    const float* gop_h = a.gopair + row0 * H * CZ4 + h * CZ4;   // row 0 of this head's gopair
    const float4* gop_a = reinterpret_cast<const float4*>(gop_h + ia * H * CZ4);
    const float4* gop_b = reinterpret_cast<const float4*>(gop_h + ib * H * CZ4);
    float gpa[CZ4], gpb[CZ4];
#pragma unroll
    for (int u = 0; u < CZ4 / 4; ++u) {
      const float4 x = gop_a[u], y = gop_b[u];
      gpa[4 * u] = x.x, gpa[4 * u + 1] = x.y, gpa[4 * u + 2] = x.z, gpa[4 * u + 3] = x.w;
      gpb[4 * u] = y.x, gpb[4 * u + 1] = y.y, gpb[4 * u + 2] = y.z, gpb[4 * u + 3] = y.w;
    }
    const bf16* pz_b = a.pz + b * a.st.pz[0];
#pragma unroll
    for (int j2 = 0; j2 < 8; j2 += 2) {
      float z[2][2][2][CZ4];   // [key block][e][row ra, rb][channel]
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * (j2 + u) + 2 * q + e, cc = c < L ? c : 0;
          pair_row(z[u][e][0], pz_b, a.st.pz, ia, cc);
          pair_row(z[u][e][1], pz_b, a.st.pz, ib, cc);
        }
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int d = 0; d < CZ4; ++d) {
            ga[4 * (j2 + u) + e] = fmaf(gpa[d], z[u][e][0][d], ga[4 * (j2 + u) + e]);
            ga[4 * (j2 + u) + 2 + e] = fmaf(gpb[d], z[u][e][1][d], ga[4 * (j2 + u) + 2 + e]);
          }
    }
  }
  // D_i = sum_j a g_a over the row's quad; gs = a (g_a - D) in place of
  // g_a. a comes back from shared memory in the accumulator layout (no
  // register holds it across steps 3 and 4).
  float av[32];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 8 * j + 2 * q;
    const float2 x = *reinterpret_cast<const float2*>(a_s + sw64(ra, c));
    const float2 y = *reinterpret_cast<const float2*>(a_s + sw64(rb, c));
    av[4 * j] = x.x, av[4 * j + 1] = x.y, av[4 * j + 2] = y.x, av[4 * j + 3] = y.y;
  }
  {
    float da = 0.f, db = 0.f;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int i = 4 * (k >> 1) + (k & 1);
      da = fmaf(av[i], ga[i], da);
      db = fmaf(av[i + 2], ga[i + 2], db);
    }
    da += __shfl_xor_sync(FULL, da, 1);
    da += __shfl_xor_sync(FULL, da, 2);
    db += __shfl_xor_sync(FULL, db, 1);
    db += __shfl_xor_sync(FULL, db, 2);
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int i = 4 * (k >> 1) + (k & 1);
      ga[i] = av[i] * (ga[i] - da);
      ga[i + 2] = av[i + 2] * (ga[i + 2] - db);
    }
  }
  // From here on ga holds gs.

  mark(6);

  // 5. The bf16 gs and a panels into V's space (no product reads V once
  // every warp is here); gq = bf16(gs).K, K read MN-major.
  uint32_t hs[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) hs[k] = pack_bf16(ga[2 * k], ga[2 * k + 1]);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint32_t oa = sw128_offset(ra, j) + 4 * q, ob = sw128_offset(rb, j) + 4 * q;
    *reinterpret_cast<uint32_t*>(smem + O_GSB + oa) = hs[2 * j];
    *reinterpret_cast<uint32_t*>(smem + O_GSB + ob) = hs[2 * j + 1];
    *reinterpret_cast<uint32_t*>(smem + O_AB + oa) = pack_bf16(av[4 * j], av[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(smem + O_AB + ob) = pack_bf16(av[4 * j + 2], av[4 * j + 3]);
  }
  fence_proxy_async();
  float c0[32], c1[32];
  wgmma_fence();
#pragma unroll
  for (int st = 0; st < TQ / 16; ++st)
    mma_rs_n64<1>(c0, &hs[4 * st], desc_sw128(k_s + st * 2048), st > 0);
#pragma unroll
  for (int st = 0; st < TQ / 16; ++st)
    mma_rs_n64<1>(c1, &hs[4 * st], desc_sw128(k_s + PANEL + st * 2048), st > 0);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(c0);
  fence_regs(c1);
  fence_regs(hs);
  // Rows ra, rb of a product's two 64-column halves x0, x1, times `scale`,
  // to rows `stride` apart from `out` (rows past L are not written).
  auto store_rows = [&](const float (&x0)[32], const float (&x1)[32], float* out,
                        long long stride, float scale) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 8 * j + 2 * q;
      if (ra < L) {
        float* o = out + ra * stride + c;
        *reinterpret_cast<float2*>(o) = make_float2(x0[4 * j] * scale, x0[4 * j + 1] * scale);
        *reinterpret_cast<float2*>(o + 64) = make_float2(x1[4 * j] * scale, x1[4 * j + 1] * scale);
      }
      if (rb < L) {
        float* o = out + rb * stride + c;
        *reinterpret_cast<float2*>(o) =
            make_float2(x0[4 * j + 2] * scale, x0[4 * j + 3] * scale);
        *reinterpret_cast<float2*>(o + 64) =
            make_float2(x1[4 * j + 2] * scale, x1[4 * j + 3] * scale);
      }
    }
  };
  store_rows(c0, c1, a.gq + row0 * HC + h * C, HC, s1);
  mark(7);
  // The points of row ar for the frame backward (half 0: query and key
  // points, half 1: value points), fetched now so that they land during
  // the products.
  RawRow x0, x1;
  if (ah == 0) {
    fetch_row<PQ>(x0, a.qp, a.st.qp, b, h, 0, ar, a.qp_vec, ar < L);
    fetch_row<PQ>(x1, a.kvp, a.st.kvp, b, h, 0, ar, a.kvp_vec, ar < L);
  } else {
    fetch_row<PV>(x0, a.kvp, a.st.kvp, b, h, PQ, ar, a.kvp_vec, ar < L);
  }
  __syncthreads();   // every warp's gq product has read K
  float* gs_s = reinterpret_cast<float*>(smem + O_GS);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 8 * j + 2 * q;
    *reinterpret_cast<float2*>(gs_s + sw64(ra, c)) = make_float2(ga[4 * j], ga[4 * j + 1]);
    *reinterpret_cast<float2*>(gs_s + sw64(rb, c)) = make_float2(ga[4 * j + 2], ga[4 * j + 3]);
  }
  __syncthreads();   // the bf16 panels (fenced above) and the fp32 gs are complete

  // 6. gk = bf16(gs)^T.Q and gv = bf16(a)^T.bf16(go): A and B both
  // MN-major. While gk runs, gbias = gs / sqrt(3) goes out from gs's fp32
  // copy: this head's L x L block is contiguous, so consecutive threads
  // store consecutive elements.
  wgmma_fence();
#pragma unroll
  for (int st = 0; st < TQ / 16; ++st) {
    const uint64_t da = desc_sw128_mn(base + O_GSB + st * 2048, PANEL);
    mma_ss_n64<1, 1>(c0, da, desc_sw128_mn(q_s + st * 2048, PANEL), st > 0);
    mma_ss_n64<1, 1>(c1, da, desc_sw128_mn(q_s + PANEL + st * 2048, PANEL), st > 0);
  }
  wgmma_commit();
  {
    float* gb = a.gbias + bh * L * L;
    for (int r = warp; r < L; r += NTH / 32)
      for (int c = lane; c < L; c += 32) gb[r * L + c] = gs_s[sw64(r, c)] * s2;
  }
  wgmma_wait_all();
  fence_regs(c0);
  fence_regs(c1);
  float* gkv_h = a.gkv + row0 * 2 * HC + 2LL * h * C;
  store_rows(c0, c1, gkv_h, 2 * HC, s1);
  wgmma_fence();
#pragma unroll
  for (int st = 0; st < TQ / 16; ++st) {
    const uint64_t da = desc_sw128_mn(base + O_AB + st * 2048, PANEL);
    mma_ss_n64<1, 1>(c0, da, desc_sw128_mn(go_s + st * 2048, PANEL), st > 0);
    mma_ss_n64<1, 1>(c1, da, desc_sw128_mn(go_s + PANEL + st * 2048, PANEL), st > 0);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(c0);
  fence_regs(c1);
  store_rows(c0, c1, gkv_h + C, 2 * HC, 1.f);
  __syncthreads();   // every product has read Q, bf16(go) and the panels
  mark(8);

  // 7. The point gradients, in fp32 from gs and a.
  float* qg_s = reinterpret_cast<float*>(smem + O_QG);
  float* gqg_s = reinterpret_cast<float*>(smem + O_GQG);
  float* gkg_s = reinterpret_cast<float*>(smem + O_GKG);
  float* gvg_s = reinterpret_cast<float*>(smem + O_GVG);
  if (ah == 0) {
    float qg[P3Q];
    to_global<PQ>(x0, rt_s + ar * 12, qg, sw);
    float4* dst = reinterpret_cast<float4*>(qg_s + ar * LDK1);
#pragma unroll
    for (int u = 0; u < P3Q / 4; ++u)
      dst[u] = make_float4(qg[4 * u], qg[4 * u + 1], qg[4 * u + 2], qg[4 * u + 3]);
  }
  __syncthreads();
  float gswp = 0.f;
  {
    // gqg of query row ar, columns 12 ah .. 12 ah + 11, and its row sum of gs.
    float acc[12], rs = 0.f;
#pragma unroll
    for (int x = 0; x < 12; ++x) acc[x] = 0.f;
    for (int u = 0; u < TQ / 4; ++u) {
      const float4 g4 = *reinterpret_cast<const float4*>(gs_s + ar * TQ + ((u ^ (ar & 15)) << 2));
      const float gv[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        rs += gv[e];
        const float4* kr = reinterpret_cast<const float4*>(kg_s + (4 * u + e) * LDK1 + 12 * ah);
#pragma unroll
        for (int x = 0; x < 3; ++x) {
          const float4 k4 = kr[x];
          acc[4 * x] = fmaf(gv[e], k4.x, acc[4 * x]);
          acc[4 * x + 1] = fmaf(gv[e], k4.y, acc[4 * x + 1]);
          acc[4 * x + 2] = fmaf(gv[e], k4.z, acc[4 * x + 2]);
          acc[4 * x + 3] = fmaf(gv[e], k4.w, acc[4 * x + 3]);
        }
      }
    }
    const float* qr = qg_s + ar * LDK1 + 12 * ah;
#pragma unroll
    for (int x = 0; x < 12; ++x) {
      const float gx = -rs * qr[x] + acc[x];
      gswp = fmaf(gx, qr[x], gswp);
      gqg_s[ar * LDK1 + 12 * ah + x] = gx;
    }
  }
  {
    // gkg of key row ar, columns 12 ah .. 12 ah + 11, and its column sum of gs.
    float acc[12], cs = 0.f;
#pragma unroll
    for (int x = 0; x < 12; ++x) acc[x] = 0.f;
    for (int i = 0; i < TQ; ++i) {
      const float gv = gs_s[sw64(i, ar)];
      cs += gv;
      const float4* qr = reinterpret_cast<const float4*>(qg_s + i * LDK1 + 12 * ah);
#pragma unroll
      for (int x = 0; x < 3; ++x) {
        const float4 q4 = qr[x];
        acc[4 * x] = fmaf(gv, q4.x, acc[4 * x]);
        acc[4 * x + 1] = fmaf(gv, q4.y, acc[4 * x + 1]);
        acc[4 * x + 2] = fmaf(gv, q4.z, acc[4 * x + 2]);
        acc[4 * x + 3] = fmaf(gv, q4.w, acc[4 * x + 3]);
      }
    }
    const float* kr = kg_s + ar * LDK1 + 12 * ah;
#pragma unroll
    for (int x = 0; x < 12; ++x) {
      const float gx = -cs * kr[x] + acc[x];
      gswp = fmaf(gx, kr[x], gswp);
      gkg_s[ar * LDK1 + 12 * ah + x] = gx;
    }
  }
  {
    // gvg of key row ar, columns 18 ah .. 18 ah + 17.
    float acc[18];
#pragma unroll
    for (int x = 0; x < 18; ++x) acc[x] = 0.f;
    for (int i = 0; i < TQ; ++i) {
      const float av = a_s[sw64(i, ar)];
      const float* orow = og_s + i * LDO1 + 20 * ah;
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const float4 o4 = reinterpret_cast<const float4*>(orow)[x];
        acc[4 * x] = fmaf(av, o4.x, acc[4 * x]);
        acc[4 * x + 1] = fmaf(av, o4.y, acc[4 * x + 1]);
        acc[4 * x + 2] = fmaf(av, o4.z, acc[4 * x + 2]);
        acc[4 * x + 3] = fmaf(av, o4.w, acc[4 * x + 3]);
      }
      const float2 o2 = reinterpret_cast<const float2*>(orow)[8];
      acc[16] = fmaf(av, o2.x, acc[16]);
      acc[17] = fmaf(av, o2.y, acc[17]);
    }
#pragma unroll
    for (int x = 0; x < 18; ++x) gvg_s[ar * LDO1 + 18 * ah + x] = acc[x];
  }
  // gsw[b, h]: the block's sum in a fixed order (warps, then their sums).
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) gswp += __shfl_xor_sync(FULL, gswp, off);
  if (lane == 0) red_s[warp] = gswp;
  __syncthreads();   // the point gradients and the warp sums are complete
  if (tid == 0) a.gsw[bh] = (red_s[0] + red_s[1] + red_s[2] + red_s[3]) / sw;
  mark(9);

  // The frame-transform backwards of row ar: half 0 its query and key
  // points (scale sw), half 1 its value points, the point gradients staged
  // as the outputs' [3][L][P] planes; the halves' d R, d t (with step 3's)
  // to this head's row partials, which the pair kernel sums over heads.
  float* gqp_s = reinterpret_cast<float*>(smem + O_GQP);
  float* gkvp_s = reinterpret_cast<float*>(smem + O_GKVP);
  if (ar < L) {
    const float* Rr = rt_s + ar * 12;
    if (ah == 0) {
      frame_bwd<PQ>(x0, gqg_s + ar * LDK1, Rr, sw, gqp_s + ar * PQ, L * PQ, rowc);
      frame_bwd<PQ>(x1, gkg_s + ar * LDK1, Rr, sw, gkvp_s + ar * PK, L * PK, rowc);
    } else {
      // The inverse transform's d t, -goptg, goes in point by point with the
      // value points' (so that they cancel exactly where gvg = goptg, at L = 1).
      frame_bwd<PV>(x0, gvg_s + ar * LDO1, Rr, 1.f, gkvp_s + ar * PK + PQ, L * PK, rowc,
                    og_s + ar * LDO1);
    }
  }
#pragma unroll
  for (int k = 0; k < 12; ++k) rowc[k] += __shfl_xor_sync(FULL, rowc[k], 1);
  if (ah == 0 && ar < L) {
    float4* dst = reinterpret_cast<float4*>(a.GRQ + (bh * L + ar) * 12);
#pragma unroll
    for (int k = 0; k < 3; ++k)
      dst[k] = make_float4(rowc[4 * k], rowc[4 * k + 1], rowc[4 * k + 2], rowc[4 * k + 3]);
  }
  mark(10);
  __syncthreads();   // the staged point gradients are complete
  {
    // Each coordinate plane of this head's gqp and gkvp is L * P contiguous floats.
    float4* dq = reinterpret_cast<float4*>(a.gqp + bh * 3 * L * PQ);
    float4* dk = reinterpret_cast<float4*>(a.gkvp + bh * 3 * L * PK);
    for (int idx = tid; idx < 3 * L * PQ / 4; idx += NTH)
      dq[idx] = reinterpret_cast<const float4*>(gqp_s)[idx];
    for (int idx = tid; idx < 3 * L * PK / 4; idx += NTH)
      dk[idx] = reinterpret_cast<const float4*>(gkvp_s)[idx];
  }
  mark(11);
}

// ---------------------------------------------------------------- L <= 64: gpz, gr9, gt
// gpz[b, i, j, :] = sum_h a_h[i, j] gopair_h[i, :] for RB query rows a
// block, heads in order, with each head's weights recomputed as the tile
// kernel computes them (the same logits and softmax in fp32); gr9, gt of
// the rows from the tile kernel's per-head partials, heads in order. Warp
// w takes keys 16w .. 16w + 15 of every row.
constexpr int RB = 8;             // query rows a block
constexpr int LDR = C + 8;        // bf16 row stride of K and q: 8 rows' words on distinct banks
constexpr int G_K = 0;                           // bf16 [2][64][LDR]: K of two heads
constexpr int G_Q = G_K + 2 * TQ * LDR * 2;      // bf16 [2][RB][LDR]: the rows' q of two heads
constexpr int G_KG = G_Q + 2 * RB * LDR * 2;     // fp32 [64][LDK1]: kg of this head
constexpr int G_KSQ = G_KG + TQ * LDK1 * 4;      // fp32 [64]
constexpr int G_QG = G_KSQ + TQ * 4;             // fp32 [RB][LDK1]
constexpr int G_RT = G_QG + RB * LDK1 * 4;       // fp32 [64][12]: R, t of the rows
constexpr int G_MB = G_RT + TQ * 12 * 4;         // fp32 [64]: key masks
constexpr int G_RED = G_MB + TQ * 4;             // fp32 [2][RB][4]: the rows' max and sum partials
constexpr int G_BIAS = G_RED + 2 * RB * 4 * 4;   // bf16 [RB][H][64]: the rows' bias, every head
// ... then fp32 [RB][H][CZ4]: the rows' gopair, every head.
int pairs_smem(int H) { return G_BIAS + RB * H * TQ * 2 + RB * H * CZ4 * 4; }

__global__ void __launch_bounds__(NTH, 3) ipa2_bwd_pairs_kernel(const __grid_constant__ BwdArgs a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  float* kg_s = reinterpret_cast<float*>(smem + G_KG);
  float* ksq_s = reinterpret_cast<float*>(smem + G_KSQ);
  float* qg_s = reinterpret_cast<float*>(smem + G_QG);
  float* rt_s = reinterpret_cast<float*>(smem + G_RT);
  float* mb_s = reinterpret_cast<float*>(smem + G_MB);
  float* red_s = reinterpret_cast<float*>(smem + G_RED);   // [2][RB][4]: the rows' max, sum
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int r = tid >> 4, jl = tid & 15;                     // for the copies
  const int b = blockIdx.y, i0 = blockIdx.x * RB, i = i0 + g;   // this thread's row: g
  const int L = a.L, H = a.H;
  const bool row_ok = i < L;
  const long long HC = (long long)H * C;
  const long long row0 = (long long)b * L;
  const long long* stb = a.st.bias;

  // K of head hh (L rows) and the block's q rows into buffer `buf`, one group.
  auto copy = [&](int hh, int buf) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int idx = tid + NTH * k, rr = idx >> 4, c = idx & 15;
      const bool valid = rr < L;
      cp_async16(base + G_K + (buf * TQ + rr) * LDR * 2 + c * 16,
                 a.kv + (row0 + (valid ? rr : 0)) * 2 * HC + 2LL * hh * C + 8 * c, valid);
    }
    const bool valid = i0 + r < L;
    cp_async16(base + G_Q + (buf * RB + r) * LDR * 2 + jl * 16,
               a.q + (row0 + (valid ? i0 + r : 0)) * HC + hh * C + 8 * jl, valid);
    cp_async_commit();
  };
  // Head hh's key points of row tid (tid < 64) or query points of row
  // i0 + tid - 64 (64 <= tid < 72).
  auto fetch_points = [&](RawRow& rw, int hh) {
    if (tid < TQ)
      fetch_row<PQ>(rw, a.kvp, a.st.kvp, b, hh, 0, tid, a.kvp_vec, tid < L);
    else if (tid < TQ + RB)
      fetch_row<PQ>(rw, a.qp, a.st.qp, b, hh, 0, i0 + tid - TQ, a.qp_vec, i0 + tid - TQ < L);
  };

  RawRow pts;
  fetch_points(pts, 0);
  Frames fr;
  fetch_frames(fr, a.r9, a.t, a.maskb, row0, L, tid);
  copy(0, 0);
  // The rows' bias and gopair, every head's (heads fastest: contiguous in
  // training's bias layout and in gopair's); rows and keys past L zero.
  bf16* bias_s = reinterpret_cast<bf16*>(smem + G_BIAS);
  float* gop_s = reinterpret_cast<float*>(smem + G_BIAS + RB * H * TQ * 2);
#pragma unroll 8
  for (int idx = tid; idx < RB * TQ * H; idx += NTH) {
    const int hh = idx % H, j = (idx / H) % TQ, rr = idx / (H * TQ);
    const bool ok = i0 + rr < L && j < L;
    bias_s[(rr * H + hh) * TQ + j] =
        ok ? a.bias[b * stb[0] + hh * stb[1] + (i0 + rr) * stb[2] + j * stb[3]]
           : __float2bfloat16(0.f);
  }
  for (int idx = tid; idx < RB * H * CZ4; idx += NTH)
    gop_s[idx] = i0 + idx / (H * CZ4) < L ? a.gopair[(row0 + i0) * H * CZ4 + idx] : 0.f;
  store_frames(fr, rt_s, mb_s, tid);
  __syncthreads();
  float acc[4][CZ4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int d = 0; d < CZ4; ++d) acc[u][d] = 0.f;
  for (int hh = 0; hh < H; ++hh) {
    const int buf = hh & 1;
    const float swh = a.sw[hh];
    if (tid < TQ) {
      float kg[P3Q];
      to_global<PQ>(pts, rt_s + tid * 12, kg, swh);
      float sq = 0.f;
#pragma unroll
      for (int x = 0; x < P3Q; ++x) sq = fmaf(kg[x], kg[x], sq);
      float4* dst = reinterpret_cast<float4*>(kg_s + tid * LDK1);
#pragma unroll
      for (int u = 0; u < P3Q / 4; ++u)
        dst[u] = make_float4(kg[4 * u], kg[4 * u + 1], kg[4 * u + 2], kg[4 * u + 3]);
      ksq_s[tid] = sq;
    } else if (tid < TQ + RB) {
      const int rr = tid - TQ, ii = i0 + rr < L ? i0 + rr : 0;
      float qg[P3Q];
      to_global<PQ>(pts, rt_s + ii * 12, qg, swh);
      float4* dst = reinterpret_cast<float4*>(qg_s + rr * LDK1);
#pragma unroll
      for (int u = 0; u < P3Q / 4; ++u)
        dst[u] = make_float4(qg[4 * u], qg[4 * u + 1], qg[4 * u + 2], qg[4 * u + 3]);
    }
    if (hh + 1 < H) {   // the next head's copies and points fly during this head
      copy(hh + 1, buf ^ 1);
      fetch_points(pts, hh + 1);
      cp_async_wait_group<1>();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();   // this head's K, q, kg and qg

    // The logits of row g against keys 16 warp + 8t + 2q + e (t, e < 2), as
    // the tile kernel forms them: q.k^T on mma.sync (m16n8k16 with rows 8-15
    // zero, the block's 8 rows the M rows), the point term, bias and mask
    // in fp32.
    const uint32_t* kw = reinterpret_cast<const uint32_t*>(smem + G_K) + buf * TQ * LDR / 2;
    const uint32_t* qw = reinterpret_cast<const uint32_t*>(smem + G_Q) + (buf * RB + g) * LDR / 2;
    float sacc[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < C / 16; ++kk) {
      const uint32_t af[4] = {qw[8 * kk + q], 0u, qw[8 * kk + 4 + q], 0u};
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const uint32_t* kr = kw + (16 * warp + 8 * t + g) * LDR / 2 + 8 * kk;
        mma_m16n8k16(sacc[t], af, kr[q], kr[4 + q]);
      }
    }
    const float* qr = qg_s + g * LDK1;
    float qsq = 0.f;
#pragma unroll
    for (int x = 0; x < P3Q; ++x) qsq = fmaf(qr[x], qr[x], qsq);
    const bf16* bias_row = bias_s + (g * H + hh) * TQ;
    float sv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = 16 * warp + 8 * (u >> 1) + 2 * q + (u & 1);
      sv[u] = -INFINITY;
      if (row_ok && j < L) {
        const float* kr = kg_s + j * LDK1;
        float pt = 0.f;
#pragma unroll
        for (int x = 0; x < P3Q; ++x) pt = fmaf(qr[x], kr[x], pt);
        sv[u] = sacc[u >> 1][u & 1] * a.s1 + bf2f(bias_row[j]) * a.s2 -
                0.5f * (qsq + ksq_s[j] - 2.f * pt) + mb_s[j];
      }
    }
    // The softmax over the row's 64 keys: four lanes of each of the four
    // warps, their partials met in shared memory in warp order.
    float m = fmaxf(fmaxf(sv[0], sv[1]), fmaxf(sv[2], sv[3]));
    m = fmaxf(m, __shfl_xor_sync(FULL, m, 1));
    m = fmaxf(m, __shfl_xor_sync(FULL, m, 2));
    if (q == 0) red_s[g * 4 + warp] = m;
    __syncthreads();
    m = fmaxf(fmaxf(red_s[g * 4], red_s[g * 4 + 1]), fmaxf(red_s[g * 4 + 2], red_s[g * 4 + 3]));
    float l = 0.f;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      sv[u] = m == -INFINITY ? 0.f : expf(sv[u] - m);
      l += sv[u];
    }
    l += __shfl_xor_sync(FULL, l, 1);
    l += __shfl_xor_sync(FULL, l, 2);
    if (q == 0) red_s[RB * 4 + g * 4 + warp] = l;
    __syncthreads();
    l = red_s[RB * 4 + g * 4] + red_s[RB * 4 + g * 4 + 1] + red_s[RB * 4 + g * 4 + 2] +
        red_s[RB * 4 + g * 4 + 3];
    const float inv = l > 0.f ? 1.f / l : 0.f;
    const float4* gp = reinterpret_cast<const float4*>(gop_s + (g * H + hh) * CZ4);
#pragma unroll
    for (int v = 0; v < CZ4 / 4; ++v) {
      const float4 g4 = gp[v];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float w = sv[u] * inv;
        acc[u][4 * v] = fmaf(w, g4.x, acc[u][4 * v]);
        acc[u][4 * v + 1] = fmaf(w, g4.y, acc[u][4 * v + 1]);
        acc[u][4 * v + 2] = fmaf(w, g4.z, acc[u][4 * v + 2]);
        acc[u][4 * v + 3] = fmaf(w, g4.w, acc[u][4 * v + 3]);
      }
    }
    __syncthreads();   // before the next head's points and copies land over this head's
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int j = 16 * warp + 8 * (u >> 1) + 2 * q + (u & 1);
    if (row_ok && j < L) {
      float4* out = reinterpret_cast<float4*>(a.gpz + ((row0 + i) * L + j) * CZ4);
#pragma unroll
      for (int v = 0; v < CZ4 / 4; ++v)
        out[v] =
            make_float4(acc[u][4 * v], acc[u][4 * v + 1], acc[u][4 * v + 2], acc[u][4 * v + 3]);
    }
  }
  // gr9 (9) and gt (3) of the block's rows: the heads' partials in order.
  if (tid < RB * 12) {
    const int rr = tid / 12, k = tid % 12, ii = i0 + rr;
    if (ii < L) {
      float sum = 0.f;
      for (int hh = 0; hh < H; ++hh) sum += a.GRQ[(((long long)b * H + hh) * L + ii) * 12 + k];
      if (k < 9)
        a.gr9[(row0 + ii) * 9 + k] = sum;
      else
        a.gt[(row0 + ii) * 3 + k - 9] = sum;
    }
  }
}

constexpr int MAX_DEVICES = 64;

// L <= 64 takes the tile and pair kernels.
bool tile_path(int L) { return L <= TQ; }

int launch_tiles(const BwdArgs& a, cudaStream_t s) {
  static int opt_in[MAX_DEVICES];   // the pair kernel's shared memory opted in so far
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  const int smem2 = pairs_smem(a.H);
  if (opt_in[dev] < smem2) {
    err = cudaFuncSetAttribute(ipa2_bwd_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM1);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(ipa2_bwd_pairs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem2);
    if (err != cudaSuccess) return (int)err;
    opt_in[dev] = smem2;
  }
  ipa2_bwd_tile_kernel<<<dim3(a.H, a.B), NTH, SMEM1, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ipa2_bwd_pairs_kernel<<<dim3((a.L + RB - 1) / RB, a.B), NTH, smem2, s>>>(a);
  return (int)cudaGetLastError();
}

// ================================================================ L > 64
// Keeps the compiler from moving memory accesses across this point: in a
// long unrolled loop it would otherwise hoist every iteration's loads to its
// start and spill what they fill.
__device__ __forceinline__ void mem_fence_compiler() { asm volatile("" ::: "memory"); }

// v, hidden from the compiler at this point of the program: what is derived
// from it (e.g. shared-memory addresses of a copy) is computed here and not
// hoisted to the kernel's start, where it would be held in registers (and
// spilled) for a whole tile.
__device__ __forceinline__ int opaque_int(int v) {
  asm volatile("" : "+r"(v));
  return v;
}

// go rows [r0, r0 + n) of one head (fp32, rows HC apart from go_h), rounded
// to bf16 into two swizzled panels at dst as load_tile places a tile; rows
// >= n zero. Each batch of a thread's BATCH 32-byte loads goes out before
// its stores (8: all at once; fewer where registers are scarce).
template <int BATCH = 8>
__device__ __forceinline__ void stage_go(unsigned char* dst, const float* go_h, long long HC,
                                         int r0, int n, int tid) {
#pragma unroll
  for (int k0 = 0; k0 < 8; k0 += BATCH) {
    float4 x[BATCH][2];
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {   // rows past n read row r0
      const int idx = tid + NTH * (k0 + k), r = idx >> 4, c = idx & 15;
      const float4* src =
          reinterpret_cast<const float4*>(go_h + (long long)(r0 + (r < n ? r : 0)) * HC + 8 * c);
      x[k][0] = src[0];
      x[k][1] = src[1];
    }
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int idx = tid + NTH * (k0 + k), r = idx >> 4, c = idx & 15;
      uint4 w = make_uint4(0u, 0u, 0u, 0u);
      if (r < n)
        w = make_uint4(pack_bf16(x[k][0].x, x[k][0].y), pack_bf16(x[k][0].z, x[k][0].w),
                       pack_bf16(x[k][1].x, x[k][1].y), pack_bf16(x[k][1].z, x[k][1].w));
      *reinterpret_cast<uint4*>(dst + (c >> 3) * PANEL + sw128_offset(r, c & 7)) = w;
    }
    mem_fence_compiler();
  }
}

// Rows ra, rb of a product's two 64-column halves x0, x1, times `scale`, to
// rows `stride` apart from `out` (rows >= n are not written).
__device__ __forceinline__ void store_halves(const float (&x0)[32], const float (&x1)[32],
                                             float* out, long long stride, int ra, int rb, int n,
                                             int q, float scale) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 8 * j + 2 * q;
    if (ra < n) {
      float* o = out + ra * stride + c;
      *reinterpret_cast<float2*>(o) = make_float2(x0[4 * j] * scale, x0[4 * j + 1] * scale);
      *reinterpret_cast<float2*>(o + 64) = make_float2(x1[4 * j] * scale, x1[4 * j + 1] * scale);
    }
    if (rb < n) {
      float* o = out + rb * stride + c;
      *reinterpret_cast<float2*>(o) = make_float2(x0[4 * j + 2] * scale, x0[4 * j + 3] * scale);
      *reinterpret_cast<float2*>(o + 64) =
          make_float2(x1[4 * j + 2] * scale, x1[4 * j + 3] * scale);
    }
  }
}

// The same rows back into the accumulator layout (zero for rows >= n):
// this thread's own stores of the tile before.
__device__ __forceinline__ void load_halves(float (&x0)[32], float (&x1)[32], const float* out,
                                            long long stride, int ra, int rb, int n, int q) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 8 * j + 2 * q;
    const float2 z = make_float2(0.f, 0.f);
    const float2 u0 = ra < n ? *reinterpret_cast<const float2*>(out + ra * stride + c) : z;
    const float2 u1 = ra < n ? *reinterpret_cast<const float2*>(out + ra * stride + c + 64) : z;
    const float2 w0 = rb < n ? *reinterpret_cast<const float2*>(out + rb * stride + c) : z;
    const float2 w1 = rb < n ? *reinterpret_cast<const float2*>(out + rb * stride + c + 64) : z;
    x0[4 * j] = u0.x, x0[4 * j + 1] = u0.y, x0[4 * j + 2] = w0.x, x0[4 * j + 3] = w0.y;
    x1[4 * j] = u1.x, x1[4 * j + 1] = u1.y, x1[4 * j + 2] = w1.x, x1[4 * j + 3] = w1.y;
  }
}

// a = exp(s - m) / l for the accumulator's rows ra (m, 1/l = ma, inva) and
// rb, in place; a row with m = -inf (past L) gets 0.
__device__ __forceinline__ void to_weights(float (&s)[32], float ma, float inva, float mb,
                                           float invb) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[4 * j + e] = ma == -INFINITY ? 0.f : expf(s[4 * j + e] - ma) * inva;
      s[4 * j + 2 + e] = mb == -INFINITY ? 0.f : expf(s[4 * j + 2 + e] - mb) * invb;
    }
  }
}

// One accumulator row's logits (HALF 0: the upper row, entries 4j + 0..1;
// 1: the lower) of a key tile, online: the row's running max m (the quad's
// max of the tile's 16 x 4 logits taken in) and sum of exp l updated, s
// replaced by p = exp(s - m) with the new m (0 for a row with m = -inf), and
// the factor exp(m_old - m) by which sums over earlier tiles shrink returned.
template <int HALF>
__device__ __forceinline__ float online_row(float (&s)[32], float& m, float& l) {
  float tm = -INFINITY;
#pragma unroll
  for (int j = 0; j < 8; ++j) tm = fmaxf(tm, fmaxf(s[4 * j + 2 * HALF], s[4 * j + 2 * HALF + 1]));
  tm = fmaxf(tm, __shfl_xor_sync(FULL, tm, 1));
  tm = fmaxf(tm, __shfl_xor_sync(FULL, tm, 2));
  const float mn = fmaxf(m, tm);
  const float alpha = m == -INFINITY ? 0.f : expf(m - mn);
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float& x = s[4 * j + 2 * HALF + e];
      x = mn == -INFINITY ? 0.f : expf(x - mn);
      sum += x;
    }
  }
  sum += __shfl_xor_sync(FULL, sum, 1);
  sum += __shfl_xor_sync(FULL, sum, 2);
  l = l * alpha + sum;
  m = mn;
  return alpha;
}

// The accumulator layout's values of rows ra, rb back from a [64][64] fp32
// tile (sw64) that this thread wrote.
__device__ __forceinline__ void load_acc(float (&x)[32], const float* t, int ra, int rb, int q) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 8 * j + 2 * q;
    const float2 u = *reinterpret_cast<const float2*>(t + sw64(ra, c));
    const float2 w = *reinterpret_cast<const float2*>(t + sw64(rb, c));
    x[4 * j] = u.x, x[4 * j + 1] = u.y, x[4 * j + 2] = w.x, x[4 * j + 3] = w.y;
  }
}

__device__ __forceinline__ void store_acc(const float (&x)[32], float* t, int ra, int rb, int q) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 8 * j + 2 * q;
    *reinterpret_cast<float2*>(t + sw64(ra, c)) = make_float2(x[4 * j], x[4 * j + 1]);
    *reinterpret_cast<float2*>(t + sw64(rb, c)) = make_float2(x[4 * j + 2], x[4 * j + 3]);
  }
}

// The point term of g_a between the rows of x (ra's at xa, rb's at xb) and
// the 64 rows of y (`ldy` apart), both in the halves-at-0-and-20 layout of
// 36 columns: out[4j + e] += x_ra . y_(8j + 2q + e), out[4j + 2 + e] the
// same for rb; in chunks of 4 columns (2 at each half's end), one chunk an
// iteration of a loop that is not unrolled (the code stays small).
__device__ __forceinline__ void dot36(float (&out)[32], const float* xa, const float* xb,
                                      const float* y, int ldy, int q) {
#pragma unroll 1
  for (int k = 0; k < 10; ++k) {
    const int off = k < 5 ? 4 * k : 20 + 4 * (k - 5);
    const bool two = k == 4 || k == 9;
    float va[4], vb[4];
    if (two) {
      const float2 u = *reinterpret_cast<const float2*>(xa + off);
      const float2 w = *reinterpret_cast<const float2*>(xb + off);
      va[0] = u.x, va[1] = u.y, va[2] = 0.f, va[3] = 0.f;
      vb[0] = w.x, vb[1] = w.y, vb[2] = 0.f, vb[3] = 0.f;
    } else {
      const float4 u = *reinterpret_cast<const float4*>(xa + off);
      const float4 w = *reinterpret_cast<const float4*>(xb + off);
      va[0] = u.x, va[1] = u.y, va[2] = u.z, va[3] = u.w;
      vb[0] = w.x, vb[1] = w.y, vb[2] = w.z, vb[3] = w.w;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float* yr = y + (8 * j + 2 * q + e) * ldy + off;
        float v[4];
        if (two) {
          const float2 t2 = *reinterpret_cast<const float2*>(yr);
          v[0] = t2.x, v[1] = t2.y, v[2] = 0.f, v[3] = 0.f;
        } else {
          const float4 t4 = *reinterpret_cast<const float4*>(yr);
          v[0] = t4.x, v[1] = t4.y, v[2] = t4.z, v[3] = t4.w;
        }
#pragma unroll
        for (int x = 0; x < 4; ++x) {   // at a half's end the last two add exact zeros
          out[4 * j + e] = fmaf(va[x], v[x], out[4 * j + e]);
          out[4 * j + 2 + e] = fmaf(vb[x], v[x], out[4 * j + 2 + e]);
        }
      }
      mem_fence_compiler();
    }
  }
}

// q_i.k_j of 24 point columns in two chains (x even, odd), as the tile
// kernel sums the point term.
__device__ __forceinline__ float dot24(const float (&x)[P3Q], const float* y) {
  const float4* y4 = reinterpret_cast<const float4*>(y);
  float p = 0.f, p2 = 0.f;
#pragma unroll
  for (int u = 0; u < P3Q / 4; ++u) {
    const float4 v = y4[u];
    p = fmaf(x[4 * u], v.x, p);
    p2 = fmaf(x[4 * u + 1], v.y, p2);
    p = fmaf(x[4 * u + 2], v.z, p);
    p2 = fmaf(x[4 * u + 3], v.w, p2);
  }
  return p + p2;
}

// The bias of an accumulator's rows ra, rb (at bias_a, bias_b) for the
// thread's 16 columns c = 8j + 2q + e, as bf16 pairs: bp[2j] columns c, c + 1
// of row ra (c in the low half), bp[2j + 1] of row rb; columns (c0 + c) *
// cs apart, columns past nc read column c0. All 32 loads go out at once
// (while a product runs), 16 registers hold them.
__device__ __forceinline__ void load_bias(uint32_t (&bp)[16], const bf16* bias_a,
                                          const bf16* bias_b, long long cs, int c0, int nc,
                                          int q) {
  const unsigned short* ba = reinterpret_cast<const unsigned short*>(bias_a);
  const unsigned short* bb = reinterpret_cast<const unsigned short*>(bias_b);
  unsigned short x[32];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 8 * j + 2 * q + e;
      const long long off = (long long)(c0 + (c < nc ? c : 0)) * cs;
      x[4 * j + e] = ba[off];
      x[4 * j + 2 + e] = bb[off];
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    bp[2 * j] = (uint32_t)x[4 * j] | ((uint32_t)x[4 * j + 1] << 16);
    bp[2 * j + 1] = (uint32_t)x[4 * j + 2] | ((uint32_t)x[4 * j + 3] << 16);
  }
}

// The accumulator layout's 32 entries (and with them the bias pairs) moved
// down by one 8-column block: after 8 moves all are back. A loop over the
// blocks that is not unrolled works on entries 0 .. 3 and this, so that its
// body is one block's code (the unrolled loop's 16 columns did not stay in
// the instruction cache between tiles) and every index stays a constant.
__device__ __forceinline__ void rotate_block(float (&s)[32]) {
  const float t0 = s[0], t1 = s[1], t2 = s[2], t3 = s[3];
#pragma unroll
  for (int k = 0; k < 28; ++k) s[k] = s[k + 4];
  s[28] = t0, s[29] = t1, s[30] = t2, s[31] = t3;
}
__device__ __forceinline__ void rotate_block(uint32_t (&bp)[16]) {
  const uint32_t t0 = bp[0], t1 = bp[1];
#pragma unroll
  for (int k = 0; k < 14; ++k) bp[k] = bp[k + 2];
  bp[14] = t0, bp[15] = t1;
}

// The logits of one accumulator row in place (the thread's entries 4j +
// E0 + e: E0 = 0 its upper row, 2 its lower), against the 64 rows of a
// tile as its columns c = 8j + 2q + e: s * s1 + bias * s2 - (|p|^2 + |x_c|^2
// - 2 p.x_c) / 2 + the mask (the column's cm[c], or the row's pm without
// cm), with p the row's points (psq their squared norm), x_c the columns'
// (cg, csq: [64][LDK1] and [64]) and the bias from load_bias; -inf where
// the row is not valid or c >= nc. One column block an iteration
// (rotate_block).
template <int E0>
__device__ __forceinline__ void logit_row(float (&s)[32], uint32_t (&bp)[16],
                                          const float (&pg)[P3Q], float psq, bool row_ok, int nc,
                                          const float* cg, const float* csq, const float* cm,
                                          float pm, int q, float s1, float s2) {
#pragma unroll 1
  for (int j = 0; j < 8; ++j) {
    const uint32_t w = bp[E0 / 2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 8 * j + 2 * q + e;
      const float bias = __uint_as_float(e ? w & 0xffff0000u : w << 16);
      float v = -INFINITY;
      if (row_ok && c < nc) {
        const float p = dot24(pg, cg + c * LDK1);
        v = s[E0 + e] * s1 + bias * s2 - 0.5f * (psq + csq[c] - 2.f * p) + (cm ? cm[c] : pm);
      }
      s[E0 + e] = v;
    }
    rotate_block(s);
    rotate_block(bp);
  }
}

// A row's points in the global frame (scale sw) and their squared norm.
__device__ __forceinline__ float points_sq(const RawRow& rw, const float* rt, float sw,
                                           float (&g)[P3Q]) {
  to_global<PQ>(rw, rt, g, sw);
  float sq = 0.f;
#pragma unroll
  for (int x = 0; x < P3Q; ++x) sq = fmaf(g[x], g[x], sq);
  return sq;
}

// A residue's key (or query) points to the global frame into row r of a
// [64][LDK1] tile, with their squared norm.
__device__ __forceinline__ void store_kg(const RawRow& rw, const float* rt, float sw, float* kg_s,
                                         float* ksq_s, int r) {
  float kg[P3Q];
  to_global<PQ>(rw, rt, kg, sw);
  float sq = 0.f;
#pragma unroll
  for (int x = 0; x < P3Q; ++x) sq = fmaf(kg[x], kg[x], sq);
  float4* dst = reinterpret_cast<float4*>(kg_s + r * LDK1);
#pragma unroll
  for (int u = 0; u < P3Q / 4; ++u)
    dst[u] = make_float4(kg[4 * u], kg[4 * u + 1], kg[4 * u + 2], kg[4 * u + 3]);
  if (ksq_s) ksq_s[r] = sq;
}

// A residue's value points to the global frame into row r of a [64][LDV1]
// tile (halves of 18 at 0 and 20).
__device__ __forceinline__ void store_vg(const RawRow& rw, const float* rt, float* vg_s, int r) {
  float vg[P3V];
  to_global<PV>(rw, rt, vg, 1.f);
  float2* dst = reinterpret_cast<float2*>(vg_s + r * LDV1);
#pragma unroll
  for (int u = 0; u < 9; ++u) {
    dst[u] = make_float2(vg[2 * u], vg[2 * u + 1]);
    dst[10 + u] = make_float2(vg[18 + 2 * u], vg[19 + 2 * u]);
  }
}

// A pair's 16 bf16 channels (two 16-byte words) as fp32.
__device__ __forceinline__ void unpack16(const uint4 lo, const uint4 hi, float (&z)[CZ4]) {
  float a[8], b[8];
  unpack8(lo, a);
  unpack8(hi, b);
#pragma unroll
  for (int d = 0; d < 8; ++d) z[d] = a[d], z[8 + d] = b[d];
}

// N (even) floats between registers and global memory, 8 bytes at a time:
// a thread's running sums parked between tiles in its own slots of a
// scratch, so that no register holds them across a tile's other stages.
template <int N>
__device__ __forceinline__ void load_vec(float (&x)[N], const float* p) {
#pragma unroll
  for (int u = 0; u < N / 2; ++u) {
    const float2 v = reinterpret_cast<const float2*>(p)[u];
    x[2 * u] = v.x, x[2 * u + 1] = v.y;
  }
}
template <int N>
__device__ __forceinline__ void store_vec(const float (&x)[N], float* p) {
#pragma unroll
  for (int u = 0; u < N / 2; ++u) reinterpret_cast<float2*>(p)[u] = make_float2(x[2 * u], x[2 * u + 1]);
}

// The point gradients of a tile's n rows, staged as [3][64][P] fp32, to the
// output's coordinate planes (rows r0 .. r0 + n - 1 of each contiguous: P
// floats a row, planes `plane` floats apart), 16 bytes a store.
template <int P>
__device__ __forceinline__ void write_planes(float* out, long long plane, const float* staged,
                                             int n, int tid) {
  for (int idx = tid; idx < 3 * n * P / 4; idx += NTH) {
    const int d = idx / (n * P / 4), k = idx - d * (n * P / 4);
    reinterpret_cast<float4*>(out + d * plane)[k] =
        reinterpret_cast<const float4*>(staged + d * TQ * P)[k];
  }
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(FULL, v, 1);
  return v + __shfl_xor_sync(FULL, v, 2);
}

// The sum of v over the block's four warps in a fixed order (each warp's
// butterfly, then the warps in turn), on every thread; `red` holds 4 floats.
__device__ __forceinline__ float block_sum4(float v, float* red, int tid) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  if ((tid & 31) == 0) red[tid >> 5] = v;
  __syncthreads();
  return red[0] + red[1] + red[2] + red[3];
}

#ifdef IPA2_STAMPS
// A block's SM clock cycles in each of N stages, as thread 0 sees them: the
// diagnostic build's record of the query and key kernels (their loops make
// one stamp a stage boundary too many).
template <int N>
struct StageClock {
  long long acc[N], last;
  __device__ void start() {
    for (int k = 0; k < N; ++k) acc[k] = 0;
    last = clock64();
  }
  __device__ void lap(int k) {
    const long long t = clock64();
    acc[k] += t - last;
    last = t;
  }
};
#endif
// Stages of the query kernel: setup; sweep 1's key loads, logits and p,
// g' (product and pair term), D's sums and p.vg; goptg and D; sweep 2's key
// loads, logits and a, g_a, gs with gq, gbias and gs.kg; the end. Of the key
// kernel: setup; the query tile's loads, logits and a, g_a^T's product and
// point term, its pair term, gs and a.goptg, gk and gv, gs.qg; the end.
constexpr int NQ_STAGES = 11, NK_STAGES = 9;

// ---------------------------------------------------------------- query kernel
constexpr int XQ_Q = 0;                            // bf16 panels: Q of the query tile
constexpr int XQ_K = XQ_Q + TILE_BYTES;            // K of the key tile
constexpr int XQ_V = XQ_K + TILE_BYTES;            // V of the key tile
constexpr int XQ_GO = XQ_V + TILE_BYTES;           // bf16(go) of the query tile
constexpr int XQ_A = XQ_GO + TILE_BYTES;           // fp32 [64][64] (sw64): a, then gs
constexpr int XQ_KG = XQ_A + TQ * TQ * 4;          // fp32 [64][LDK1]: kg of the key tile
constexpr int XQ_KSQ = XQ_KG + TQ * LDK1 * 4;      // fp32 [64]
constexpr int XQ_MB = XQ_KSQ + TQ * 4;             // fp32 [64]: key masks
constexpr int XQ_VG = XQ_MB + TQ * 4;              // fp32 [64][LDV1]: vg of the key tile
constexpr int XQ_OG = XQ_VG + TQ * LDV1 * 4;       // fp32 [64][LDO1]: goptg of the query rows
constexpr int XQ_RT = XQ_OG + TQ * LDO1 * 4;       // fp32 [64][12]: R, t of the query rows
constexpr int XQ_D = XQ_RT + TQ * 12 * 4;          // fp32 [64]: D of the query rows
constexpr int XQ_AL = XQ_D + TQ * 4;               // fp32 [64]: the rows' rescale factors, 1/l
constexpr int XQ_INV = XQ_AL + TQ * 4;             // fp32 [64]: the rows' 1/l
constexpr int XQ_RED = XQ_INV + TQ * 4;            // fp32 [4]
constexpr int XQ_SMEM = XQ_RED + 16;
// A key tile's frames go over a's space until its points are stored; at
// the end K's space holds the query rows' qg and gqg.
constexpr int XQ_QG = XQ_K;                        // fp32 [64][LDK1]
constexpr int XQ_GQG = XQ_K + TQ * LDK1 * 4;       // fp32 [64][LDK1]
static_assert(XQ_K % 1024 == 0 && XQ_V % 1024 == 0 && XQ_GO % 1024 == 0, "panels on 1024 bytes");
static_assert(2 * TQ * LDK1 * 4 <= TILE_BYTES, "qg and gqg fit over K");
static_assert(2 * (XQ_SMEM + 1024) <= 233472, "two blocks an SM");

__global__ void __launch_bounds__(NTH, 2) ipa2_bwd_query_kernel(const __grid_constant__ BwdArgs a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  if (base & 1023) __trap();   // the swizzle is taken from the address bits
  const uint32_t q_s = base + XQ_Q, k_s = base + XQ_K, v_s = base + XQ_V, go_s = base + XQ_GO;
  float* a_s = reinterpret_cast<float*>(smem + XQ_A);
  float* kg_s = reinterpret_cast<float*>(smem + XQ_KG);
  float* ksq_s = reinterpret_cast<float*>(smem + XQ_KSQ);
  float* mb_s = reinterpret_cast<float*>(smem + XQ_MB);
  float* vg_s = reinterpret_cast<float*>(smem + XQ_VG);
  float* og_s = reinterpret_cast<float*>(smem + XQ_OG);
  float* rt_s = reinterpret_cast<float*>(smem + XQ_RT);
  float* d_s = reinterpret_cast<float*>(smem + XQ_D);
  float* al_s = reinterpret_cast<float*>(smem + XQ_AL);
  float* inv_s = reinterpret_cast<float*>(smem + XQ_INV);
  float* red_s = reinterpret_cast<float*>(smem + XQ_RED);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int ra = 16 * warp + g, rb = ra + 8;   // this thread's rows of the accumulators
  const int ar = tid >> 1, ah = tid & 1;       // its row and half in the row-wise stages
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z, i0 = qt * TQ;
  const int L = a.L, H = a.H, nT = a.nT;
  const int nq = min(TQ, L - i0);
  const float sw = a.sw[h], s1 = a.s1, s2 = a.s2;
  const long long HC = (long long)H * C;
  const long long row0 = (long long)b * L;     // the residue row of (b, 0)
  const long long bh = (long long)b * H + h;
  const long long srow = bh * L + i0;          // row i0 of this head's (B, H, L, .) scratch
  const bf16* kv_b = a.kv + row0 * 2 * HC + 2LL * h * C;
  const long long* stb = a.st.bias;
  const bf16* bias_bh = a.bias + b * stb[0] + h * stb[1];

#ifdef IPA2_STAMPS
  StageClock<NQ_STAGES> clk;
  if (tid == 0) clk.start();
  auto lap = [&](int k) {
    if (tid == 0) clk.lap(k);
  };
#else
  auto lap = [](int) {};
#endif

  // The query tile: Q by cp.async, go rounded to bf16 into its panels, the
  // rows' frames.
  {
    Frames fq;
    fetch_frames(fq, a.r9, a.t, nullptr, row0 + i0, nq, tid);
    load_tile(q_s, a.q + row0 * HC + h * C, HC, i0, nq, tid);
    cp_async_commit();
    stage_go(smem + XQ_GO, a.go + row0 * HC + h * C, HC, i0, nq, tid);
    store_frames(fq, rt_s, nullptr, tid);
  }

  // Key tile j0 (nk rows): K (with `values` also V) by cp.async, the key
  // points in the global frame (kg, |kg|^2; with `values` vg) from the
  // tile's frames, stored over a's space first, and the key masks. Returns
  // with all of it landed and, for wgmma, fenced.
  auto load_keys = [&](int j0, int nk, bool values) {
    __syncthreads();   // the previous tile's readers are done
    const bf16* kvb = opaque(kv_b);
    load_tile(k_s, kvb, 2 * HC, j0, nk, tid);
    if (values) load_tile(v_s, kvb + C, 2 * HC, j0, nk, tid);
    cp_async_commit();
    {
      Frames fk;
      const int t2 = opaque_int(tid);
      fetch_frames(fk, a.r9, a.t, a.maskb, row0 + j0, nk, t2);
      store_frames(fk, a_s, mb_s, t2);
    }
    RawRow rk;
    if (ah == 0)
      fetch_row<PQ>(rk, a.kvp, a.st.kvp, b, h, 0, j0 + ar, a.kvp_vec, ar < nk);
    else if (values)
      fetch_row<PV>(rk, a.kvp, a.st.kvp, b, h, PQ, j0 + ar, a.kvp_vec, ar < nk);
    __syncthreads();
    if (ah == 0)
      store_kg(rk, a_s + ar * 12, sw, kg_s, ksq_s, ar);
    else if (values)
      store_vg(rk, a_s + ar * 12, vg_s, ar);
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();
  };

  // The logits of the query tile against the loaded key tile j0 in the
  // accumulator layout (entry 4j + e, e < 2: row ra, key 8j + 2q + e;
  // 4j + 2 + e: row rb), -inf past L in either direction. The rows' query
  // points are taken again for each tile (the loads hit L2), so that no
  // register holds them across the tile loops.
  auto logits = [&](float (&s)[32], int j0, int nk) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C / 16; ++kk)
      mma_ss_n64(s, desc_sw128(q_s + (kk >> 2) * PANEL + (kk & 3) * 32),
                 desc_sw128(k_s + (kk >> 2) * PANEL + (kk & 3) * 32), kk > 0);
    wgmma_commit();
    RawRow rqa, rqb;
    fetch_row<PQ>(rqa, a.qp, a.st.qp, b, h, 0, i0 + ra, a.qp_vec, ra < nq);
    fetch_row<PQ>(rqb, a.qp, a.st.qp, b, h, 0, i0 + rb, a.qp_vec, rb < nq);
    uint32_t bp[16];
    load_bias(bp, bias_bh + (long long)(i0 + (ra < nq ? ra : 0)) * stb[2],
              bias_bh + (long long)(i0 + (rb < nq ? rb : 0)) * stb[2], stb[3], j0, nk, q);
    wgmma_wait_all();
    fence_regs(s);
    {   // one row at a time, so that one row's points are live
      float qg[P3Q];
      const float qsq = points_sq(rqa, rt_s + ra * 12, sw, qg);
      logit_row<0>(s, bp, qg, qsq, ra < nq, nk, kg_s, ksq_s, mb_s, 0.f, q, s1, s2);
    }
    {
      float qg[P3Q];
      const float qsq = points_sq(rqb, rt_s + rb * 12, sw, qg);
      logit_row<2>(s, bp, qg, qsq, rb < nq, nk, kg_s, ksq_s, mb_s, 0.f, q, s1, s2);
    }
  };

  // g' = bf16(go).V^T, then gopair_i.pz_ij added: each pair's 16 channels
  // read by the thread that holds the pair.
  auto scalar_and_pair = [&](float (&ga)[32], int j0, int nk) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C / 16; ++kk)
      mma_ss_n64(ga, desc_sw128(go_s + (kk >> 2) * PANEL + (kk & 3) * 32),
                 desc_sw128(v_s + (kk >> 2) * PANEL + (kk & 3) * 32), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(ga);
    const float* gop_h = a.gopair + row0 * H * CZ4 + h * CZ4;
    const bf16* pz_b = a.pz + b * a.st.pz[0];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {   // rows ra, rb: one row's gopair live at a time
      const long long i = i0 + ((rr ? rb : ra) < nq ? (rr ? rb : ra) : 0);
      const float4* gop4 = reinterpret_cast<const float4*>(gop_h + i * H * CZ4);
      float gp[CZ4];
#pragma unroll
      for (int u = 0; u < CZ4 / 4; ++u) {
        const float4 x = gop4[u];
        gp[4 * u] = x.x, gp[4 * u + 1] = x.y, gp[4 * u + 2] = x.z, gp[4 * u + 3] = x.w;
      }
#pragma unroll 1
      for (int j = 0; j < 8; ++j) {   // key block j: keys 8j + 2q + e (rotate_block)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * q + e;
          const long long jc = j0 + (c < nk ? c : 0);
          const uint4* z4 = reinterpret_cast<const uint4*>(pz_b + i * a.st.pz[1] + jc * a.st.pz[2]);
          float z[CZ4];
          unpack16(z4[0], z4[1], z);
#pragma unroll
          for (int d = 0; d < CZ4; ++d) ga[2 * rr + e] = fmaf(gp[d], z[d], ga[2 * rr + e]);
        }
        rotate_block(ga);
      }
    }
  };

  // Sweep 1 over the key tiles, online (the flash-attention forward's
  // recurrence): each row's running max m and sum of exp l; the tile's
  // p = exp(s - m); the point sums p.vg of row ar (columns 18 ah .. 18 ah +
  // 17, through p in shared memory) and D's scalar and pair parts
  // sum_j p (bf16(go).v_j + gopair.pz_ij) of rows ra, rb, each shrunk by
  // exp(m_old - m_new) when the row's max grows, and divided by l at the
  // end. Row ar's point sums wait between tiles in this thread's 32 slots
  // of SUMS (in sweep 2 its gs.kg and row sum).
  float* sums = a.SUMS + ((bh * nT + qt) * TQ + ar) * 64 + 32 * ah;
  float m_a = -INFINITY, l_a = 0.f, m_b = -INFINITY, l_b = 0.f, da = 0.f, db = 0.f;
  for (int t = 0; t < nT; ++t) {
    const int j0 = t * TQ, nk = min(TQ, L - j0);
    lap(t == 0 ? 0 : 4);
    load_keys(j0, nk, true);
    lap(1);
    {
      float s[32];
      logits(s, j0, nk);
      const float al_a = online_row<0>(s, m_a, l_a), al_b = online_row<1>(s, m_b, l_b);
      da *= al_a;
      db *= al_b;
      if (q == 0) {
        al_s[ra] = al_a;
        al_s[rb] = al_b;
      }
      store_acc(s, a_s, ra, rb, q);
    }
    lap(2);
    float ga[32];
    scalar_and_pair(ga, j0, nk);
    lap(3);
    {
      float av[32];
      load_acc(av, a_s, ra, rb, q);
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int i = 4 * (k >> 1) + (k & 1);
        da = fmaf(av[i], ga[i], da);
        db = fmaf(av[i + 2], ga[i + 2], db);
      }
    }
    __syncthreads();   // p and the rows' rescale factors are complete
    float pacc[18];
    if (t > 0) {
      load_vec(pacc, sums);
      const float al = al_s[ar];
#pragma unroll
      for (int x = 0; x < 18; ++x) pacc[x] *= al;
    } else {
#pragma unroll
      for (int x = 0; x < 18; ++x) pacc[x] = 0.f;
    }
#pragma unroll 1
    for (int u = 0; u < TQ / 4; ++u) {
      const float4 a4 = *reinterpret_cast<const float4*>(a_s + ar * TQ + ((u ^ (ar & 15)) << 2));
      const float aw[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* vr = vg_s + (4 * u + e) * LDV1 + 20 * ah;
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const float4 v = reinterpret_cast<const float4*>(vr)[x];
          pacc[4 * x] = fmaf(aw[e], v.x, pacc[4 * x]);
          pacc[4 * x + 1] = fmaf(aw[e], v.y, pacc[4 * x + 1]);
          pacc[4 * x + 2] = fmaf(aw[e], v.z, pacc[4 * x + 2]);
          pacc[4 * x + 3] = fmaf(aw[e], v.w, pacc[4 * x + 3]);
        }
        const float2 v = reinterpret_cast<const float2*>(vr)[8];
        pacc[16] = fmaf(aw[e], v.x, pacc[16]);
        pacc[17] = fmaf(aw[e], v.y, pacc[17]);
      }
    }
    store_vec(pacc, sums);
  }
  lap(4);
  const float inva = l_a > 0.f ? 1.f / l_a : 0.f, invb = l_b > 0.f ? 1.f / l_b : 0.f;
  da = quad_sum(da) * inva;
  db = quad_sum(db) * invb;
  if (q == 0) {
    if (ra < nq) *reinterpret_cast<float2*>(a.STAT + (srow + ra) * 4) = make_float2(m_a, inva);
    if (rb < nq) *reinterpret_cast<float2*>(a.STAT + (srow + rb) * 4) = make_float2(m_b, invb);
    d_s[ra] = da;
    d_s[rb] = db;
    inv_s[ra] = inva;
    inv_s[rb] = invb;
  }
  __syncthreads();   // D's parts; every tile's readers are done

  // Row ar: optl, norm, goptl', goptg (to shared memory and GOPTG), the
  // inverse transform's d R, d t (to GRQ) and D = D' + goptg.optg. The
  // halves trade six point sums so that each holds the three coordinates of
  // its six points.
  {
    float pacc[18];   // optg
    load_vec(pacc, sums);
    {
      const float inv = inv_s[ar];
#pragma unroll
      for (int x = 0; x < 18; ++x) pacc[x] *= inv;
    }
    const long long row = row0 + i0 + (ar < nq ? ar : 0);
    float gn[6], glc[6][3];
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const int p = 6 * ah + k;
      gn[k] = a.gnorm[row * H * PV + h * PV + p];
#pragma unroll
      for (int c = 0; c < 3; ++c) glc[k][c] = a.goptl[row * 3 * H * PV + c * H * PV + h * PV + p];
    }
    float oth[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) oth[k] = __shfl_xor_sync(FULL, pacc[6 + k], 1);
    const float* Rr = rt_s + ar * 12;
    float rowc[12], dd = 0.f;
#pragma unroll
    for (int k = 0; k < 12; ++k) rowc[k] = 0.f;
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const int p = 6 * ah + k;
      float gg[3] = {0.f, 0.f, 0.f};
      if (ar < nq) {
        const float o[3] = {ah ? oth[k] : pacc[k], ah ? pacc[k] : pacc[12 + k],
                            ah ? pacc[12 + k] : oth[k]};
        const float dif[3] = {o[0] - Rr[9], o[1] - Rr[10], o[2] - Rr[11]};
        float loc[3], nsq = a.eps;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          loc[c] = Rr[c] * dif[0] + Rr[3 + c] * dif[1] + Rr[6 + c] * dif[2];
          nsq += loc[c] * loc[c];
        }
        const float nrm = sqrtf(nsq);
        float gl[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) gl[c] = glc[k][c] + loc[c] * gn[k] / nrm;
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          gg[d] = Rr[3 * d] * gl[0] + Rr[3 * d + 1] * gl[1] + Rr[3 * d + 2] * gl[2];
#pragma unroll
          for (int c = 0; c < 3; ++c) rowc[3 * d + c] = fmaf(dif[d], gl[c], rowc[3 * d + c]);
          rowc[9 + d] -= gg[d];
          dd = fmaf(gg[d], o[d], dd);
          a.GOPTG[(srow + ar) * LDO1 + half20(d * PV + p)] = gg[d];
        }
      }
#pragma unroll
      for (int d = 0; d < 3; ++d) og_s[ar * LDO1 + half20(d * PV + p)] = gg[d];
    }
    dd += __shfl_xor_sync(FULL, dd, 1);
#pragma unroll
    for (int k = 0; k < 12; ++k) rowc[k] += __shfl_xor_sync(FULL, rowc[k], 1);
    if (ah == 0) {
      const float D = d_s[ar] + dd;
      d_s[ar] = D;
      if (ar < nq) {
        a.STAT[(srow + ar) * 4 + 2] = D;
        float4* gr = reinterpret_cast<float4*>(a.GRQ + (srow + ar) * 12);
#pragma unroll
        for (int k = 0; k < 3; ++k)
          gr[k] = make_float4(rowc[4 * k], rowc[4 * k + 1], rowc[4 * k + 2], rowc[4 * k + 3]);
      }
    }
  }
  __syncthreads();   // goptg and D of every row
  lap(5);

  // Sweep 2: a from the saved m, 1/l; g_a, gs = a (g_a - D), gbias;
  // gq += bf16(gs).K in the output; row ar's gs.kg (columns 12 ah .. 12 ah +
  // 11) and row sum.
  float* gq_t = a.gq + (row0 + i0) * HC + h * C;   // row i0 of this head's gq
  float* gb_t = a.gbias + srow * L;                // row i0 of this head's gbias
  for (int t = 0; t < nT; ++t) {
    const int j0 = t * TQ, nk = min(TQ, L - j0);
    load_keys(j0, nk, true);
    lap(6);
    {
      float s[32];
      logits(s, j0, nk);
      to_weights(s, m_a, inva, m_b, invb);
      store_acc(s, a_s, ra, rb, q);
    }
    lap(7);
    float ga[32];
    scalar_and_pair(ga, j0, nk);
    dot36(ga, og_s + ra * LDO1, og_s + rb * LDO1, vg_s, LDV1, q);
    {
      mem_fence_compiler();   // D is read here, not held from before the tile
      const float Da = d_s[ra], Db = d_s[rb];
      float av[32];
      load_acc(av, a_s, ra, rb, q);
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int i = 4 * (k >> 1) + (k & 1);
        ga[i] = av[i] * (ga[i] - Da);
        ga[i + 2] = av[i + 2] * (ga[i + 2] - Db);
      }
    }
    lap(8);
    // From here on ga holds gs: its fp32 copy over a (this thread's own
    // entries), bf16(gs) the A fragments of gq's product.
    store_acc(ga, a_s, ra, rb, q);
    uint32_t hs[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) hs[k] = pack_bf16(ga[2 * k], ga[2 * k + 1]);
    float c0[32], c1[32];
    if (t > 0) load_halves(c0, c1, gq_t, HC, ra, rb, nq, q);
    wgmma_fence();
#pragma unroll
    for (int st = 0; st < TQ / 16; ++st)
      mma_rs_n64<1>(c0, &hs[4 * st], desc_sw128(k_s + st * 2048), st > 0 || t > 0);
#pragma unroll
    for (int st = 0; st < TQ / 16; ++st)
      mma_rs_n64<1>(c1, &hs[4 * st], desc_sw128(k_s + PANEL + st * 2048), st > 0 || t > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(c0);
    fence_regs(c1);
    fence_regs(hs);
    store_halves(c0, c1, gq_t, HC, ra, rb, nq, q, t == nT - 1 ? s1 : 1.f);
    __syncthreads();   // gs is complete
    for (int r = warp; r < nq; r += NTH / 32)
      for (int c = lane; c < nk; c += 32) gb_t[(long long)r * L + j0 + c] = a_s[sw64(r, c)] * s2;
    float gacc[14];   // gs.kg (12), the row sum, a pad
    if (t > 0) {
      load_vec(gacc, sums);
    } else {
#pragma unroll
      for (int x = 0; x < 14; ++x) gacc[x] = 0.f;
    }
#pragma unroll 1
    for (int u = 0; u < TQ / 4; ++u) {
      const float4 g4 = *reinterpret_cast<const float4*>(a_s + ar * TQ + ((u ^ (ar & 15)) << 2));
      const float gw[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        gacc[12] += gw[e];
        const float4* kr = reinterpret_cast<const float4*>(kg_s + (4 * u + e) * LDK1 + 12 * ah);
#pragma unroll
        for (int x = 0; x < 3; ++x) {
          const float4 k4 = kr[x];
          gacc[4 * x] = fmaf(gw[e], k4.x, gacc[4 * x]);
          gacc[4 * x + 1] = fmaf(gw[e], k4.y, gacc[4 * x + 1]);
          gacc[4 * x + 2] = fmaf(gw[e], k4.z, gacc[4 * x + 2]);
          gacc[4 * x + 3] = fmaf(gw[e], k4.w, gacc[4 * x + 3]);
        }
      }
      mem_fence_compiler();
    }
    store_vec(gacc, sums);
    lap(9);
  }

  // gqg of row ar, the block's gsw partial, and the query points' frame
  // backward (gqp; d R, d t added to GRQ).
  __syncthreads();   // K's space is free
  float* qg_s = reinterpret_cast<float*>(smem + XQ_QG);
  float* gqg_s = reinterpret_cast<float*>(smem + XQ_GQG);
  RawRow xq;
  fetch_row<PQ>(xq, a.qp, a.st.qp, b, h, 0, i0 + ar, a.qp_vec, ar < nq);
  if (ah == 0) store_kg(xq, rt_s + ar * 12, sw, qg_s, nullptr, ar);
  __syncthreads();
  float gswp = 0.f;
  {
    float gacc[14];
    load_vec(gacc, sums);
    const float rs = gacc[12];
    const float* qr = qg_s + ar * LDK1 + 12 * ah;
#pragma unroll
    for (int x = 0; x < 12; ++x) {
      const float gx = -rs * qr[x] + gacc[x];
      gswp = fmaf(gx, qr[x], gswp);
      gqg_s[ar * LDK1 + 12 * ah + x] = gx;
    }
  }
  const float gsw_blk = block_sum4(gswp, red_s, tid);   // its barrier publishes gqg_s
  if (tid == 0) a.GSWQ[bh * nT + qt] = gsw_blk;
  float* gqp_s = reinterpret_cast<float*>(smem + XQ_V);   // [3][64][PQ]: gqp of the rows
  if (ah == 0 && ar < nq) {
    float rowc[12];
#pragma unroll
    for (int k = 0; k < 12; ++k) rowc[k] = 0.f;
    frame_bwd<PQ>(xq, gqg_s + ar * LDK1, rt_s + ar * 12, sw, gqp_s + ar * PQ, TQ * PQ, rowc);
    float* gr = a.GRQ + (srow + ar) * 12;
#pragma unroll
    for (int k = 0; k < 12; ++k) gr[k] += rowc[k];
  }
  __syncthreads();   // the staged gqp is complete
  write_planes<PQ>(a.gqp + (bh * 3 * L + i0) * PQ, (long long)L * PQ, gqp_s, nq, tid);
  lap(10);
#ifdef IPA2_STAMPS
  if (a.stamps && tid == 0) {
    long long* out = a.stamps + (bh * nT + qt) * NQ_STAGES;
    for (int k = 0; k < NQ_STAGES; ++k) out[k] = clk.acc[k];
  }
#endif
}

// ---------------------------------------------------------------- key kernel
constexpr int XK_K = 0;                            // bf16 panels: K of the key tile
constexpr int XK_V = XK_K + TILE_BYTES;            // V of the key tile
constexpr int XK_Q = XK_V + TILE_BYTES;            // Q of the query tile
constexpr int XK_GO = XK_Q + TILE_BYTES;           // bf16(go) of the query tile
constexpr int XK_A = XK_GO + TILE_BYTES;           // fp32 [64 keys][64 queries] (sw64): a, then gs
constexpr int XK_VG = XK_A + TQ * TQ * 4;          // fp32 [64][LDV1]: vg of the key rows
constexpr int XK_OG = XK_VG + TQ * LDV1 * 4;       // fp32 [64][LDO1]: goptg of the query rows
constexpr int XK_QG = XK_OG + TQ * LDO1 * 4;       // fp32 [64][LDK1]: qg of the query rows
constexpr int XK_QSQ = XK_QG + TQ * LDK1 * 4;      // fp32 [64]
constexpr int XK_ST = XK_QSQ + TQ * 4;             // fp32 [64][4]: m, 1/l, D of the query rows
constexpr int XK_RT = XK_ST + TQ * 4 * 4;          // fp32 [64][12]: R, t of the key rows
constexpr int XK_MB = XK_RT + TQ * 12 * 4;         // fp32 [64]: key masks
constexpr int XK_RED = XK_MB + TQ * 4;             // fp32 [4]
constexpr int XK_SMEM = XK_RED + 16;
// A query tile's frames go over a's space until its points are stored; at
// the end Q's space holds the key rows' kg and gkg, bf16(go)'s their gvg.
constexpr int XK_KG = XK_Q;                        // fp32 [64][LDK1]
constexpr int XK_GKG = XK_Q + TQ * LDK1 * 4;       // fp32 [64][LDK1]
constexpr int XK_GVG = XK_GO;                      // fp32 [64][LDO1]
static_assert(XK_V % 1024 == 0 && XK_Q % 1024 == 0 && XK_GO % 1024 == 0, "panels on 1024 bytes");
static_assert(TQ * LDO1 * 4 <= TILE_BYTES, "gvg fits over bf16(go)");
static_assert(3 * TQ * PK * 4 <= TILE_BYTES && 3 * TQ * PQ * 4 <= TILE_BYTES,
              "the staged point gradients fit over V");
static_assert(2 * (XK_SMEM + 1024) <= 233472, "two blocks an SM");

__global__ void __launch_bounds__(NTH, 2) ipa2_bwd_key_kernel(const __grid_constant__ BwdArgs a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  if (base & 1023) __trap();   // the swizzle is taken from the address bits
  const uint32_t k_s = base + XK_K, v_s = base + XK_V, q_s = base + XK_Q, go_s = base + XK_GO;
  float* a_s = reinterpret_cast<float*>(smem + XK_A);
  float* vg_s = reinterpret_cast<float*>(smem + XK_VG);
  float* og_s = reinterpret_cast<float*>(smem + XK_OG);
  float* qg_s = reinterpret_cast<float*>(smem + XK_QG);
  float* qsq_s = reinterpret_cast<float*>(smem + XK_QSQ);
  float* st_s = reinterpret_cast<float*>(smem + XK_ST);
  float* rt_s = reinterpret_cast<float*>(smem + XK_RT);
  float* mb_s = reinterpret_cast<float*>(smem + XK_MB);
  float* red_s = reinterpret_cast<float*>(smem + XK_RED);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int ja = 16 * warp + g, jb = ja + 8;   // this thread's key rows of the accumulators
  const int ar = tid >> 1, ah = tid & 1;       // its key row and half in the row-wise stages
  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z, j0 = kt * TQ;
  const int L = a.L, H = a.H, nT = a.nT;
  const int nk = min(TQ, L - j0);
  const float sw = a.sw[h], s1 = a.s1, s2 = a.s2;
  const long long HC = (long long)H * C;
  const long long row0 = (long long)b * L;
  const long long bh = (long long)b * H + h;
  const bf16* kv_b = a.kv + row0 * 2 * HC + 2LL * h * C;
  const long long* stb = a.st.bias;
  const bf16* bias_bh = a.bias + b * stb[0] + h * stb[1];

#ifdef IPA2_STAMPS
  StageClock<NK_STAGES> clk;
  if (tid == 0) clk.start();
  auto lap = [&](int k) {
    if (tid == 0) clk.lap(k);
  };
#else
  auto lap = [](int) {};
#endif

  // The key tile: K and V by cp.async, the rows' frames and masks, vg.
  {
    RawRow rv;
    if (ah == 1) fetch_row<PV>(rv, a.kvp, a.st.kvp, b, h, PQ, j0 + ar, a.kvp_vec, ar < nk);
    Frames fk;
    fetch_frames(fk, a.r9, a.t, a.maskb, row0 + j0, nk, tid);
    load_tile(k_s, kv_b, 2 * HC, j0, nk, tid);
    load_tile(v_s, kv_b + C, 2 * HC, j0, nk, tid);
    cp_async_commit();
    store_frames(fk, rt_s, mb_s, tid);
    __syncthreads();
    if (ah == 1) store_vg(rv, rt_s + ar * 12, vg_s, ar);
  }

  // Key row ar's running sums wait between tiles in this thread's 32 slots
  // of SUMS: a.goptg (columns 18 ah .., at 0), gs.qg (columns 12 ah .., at
  // 18) and the column sum (at 30).
  float* sums = a.SUMS + ((bh * nT + kt) * TQ + ar) * 64 + 32 * ah;
  float* gk_t = a.gkv + (row0 + j0) * 2 * HC + 2LL * h * C;   // row j0 of this head's gk
  float* gv_t = gk_t + C;
  for (int it = 0; it < nT; ++it) {
    const int i0 = it * TQ, nq = min(TQ, L - i0);
    lap(it == 0 ? 0 : 7);
    // The query tile: Q by cp.async, bf16(go) staged, the rows' goptg and
    // statistics (m = -inf past L), their points in the global frame from
    // their frames, stored over a's space first.
    __syncthreads();   // the previous tile's readers are done
    load_tile(q_s, opaque(a.q) + row0 * HC + h * C, HC, i0, nq, tid);
    cp_async_commit();
    stage_go<2>(smem + XK_GO, a.go + row0 * HC + h * C, HC, i0, nq, tid);
    const float* goptg_t = a.GOPTG + (bh * L + i0) * LDO1;
#pragma unroll
    for (int k = 0; k < 5; ++k) {   // 64 rows of 10 16-byte chunks, rows past nq zero
      const int idx = tid + NTH * k, r = idx / 10, c = idx - 10 * r;
      cp_async16(smem_u32(og_s + r * LDO1 + 4 * c), goptg_t + (r < nq ? r : 0) * LDO1 + 4 * c,
                 r < nq);
    }
    if (tid < TQ) {
      float m = -INFINITY, inv = 0.f, D = 0.f;
      if (tid < nq) {
        const float* sp = a.STAT + (bh * L + i0 + tid) * 4;
        m = sp[0], inv = sp[1], D = sp[2];
      }
      reinterpret_cast<float4*>(st_s)[tid] = make_float4(m, inv, D, 0.f);
    }
    {
      Frames fq;
      const int t2 = opaque_int(tid);
      fetch_frames(fq, a.r9, a.t, nullptr, row0 + i0, nq, t2);
      store_frames(fq, a_s, nullptr, t2);
    }
    RawRow rq;
    if (ah == 0) fetch_row<PQ>(rq, a.qp, a.st.qp, b, h, 0, i0 + ar, a.qp_vec, ar < nq);
    __syncthreads();
    if (ah == 0) store_kg(rq, a_s + ar * 12, sw, qg_s, qsq_s, ar);
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();
    lap(1);

    // S^T = K.Q^T; the logits in the accumulator layout (entry 4j + e, e <
    // 2: key ja, query 8j + 2q + e; 4j + 2 + e: key jb), -inf past L; then
    // a from the queries' saved m, 1/l, to a's space.
    {
      float st[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C / 16; ++kk)
        mma_ss_n64(st, desc_sw128(k_s + (kk >> 2) * PANEL + (kk & 3) * 32),
                   desc_sw128(q_s + (kk >> 2) * PANEL + (kk & 3) * 32), kk > 0);
      wgmma_commit();
      RawRow rka, rkb;
      fetch_row<PQ>(rka, a.kvp, a.st.kvp, b, h, 0, j0 + ja, a.kvp_vec, ja < nk);
      fetch_row<PQ>(rkb, a.kvp, a.st.kvp, b, h, 0, j0 + jb, a.kvp_vec, jb < nk);
      uint32_t bp[16];   // bias[i][j] of key rows ja, jb: the columns are the queries
      load_bias(bp, bias_bh + (long long)(j0 + (ja < nk ? ja : 0)) * stb[3],
                bias_bh + (long long)(j0 + (jb < nk ? jb : 0)) * stb[3], stb[2], i0, nq, q);
      wgmma_wait_all();
      fence_regs(st);
      {   // one key row at a time, so that one row's points are live
        float kg[P3Q];
        const float ksq = points_sq(rka, rt_s + ja * 12, sw, kg);
        logit_row<0>(st, bp, kg, ksq, ja < nk, nq, qg_s, qsq_s, nullptr, mb_s[ja], q, s1, s2);
      }
      {
        float kg[P3Q];
        const float ksq = points_sq(rkb, rt_s + jb * 12, sw, kg);
        logit_row<2>(st, bp, kg, ksq, jb < nk, nq, qg_s, qsq_s, nullptr, mb_s[jb], q, s1, s2);
      }
      // a from the query columns' m, 1/l (m = -inf past L).
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float2 ml = *reinterpret_cast<const float2*>(st_s + 4 * (8 * j + 2 * q + e));
          st[4 * j + e] = ml.x == -INFINITY ? 0.f : expf(st[4 * j + e] - ml.x) * ml.y;
          st[4 * j + 2 + e] = ml.x == -INFINITY ? 0.f : expf(st[4 * j + 2 + e] - ml.x) * ml.y;
        }
      }
      store_acc(st, a_s, ja, jb, q);
    }

    lap(2);
    // g_a^T = V.bf16(go)^T, the point term goptg_i.vg_j and the pair term;
    // gs = a (g_a - D_i).
    float gt[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C / 16; ++kk)
      mma_ss_n64(gt, desc_sw128(v_s + (kk >> 2) * PANEL + (kk & 3) * 32),
                 desc_sw128(go_s + (kk >> 2) * PANEL + (kk & 3) * 32), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(gt);
    dot36(gt, vg_s + ja * LDV1, vg_s + jb * LDV1, og_s, LDO1, q);
    lap(3);
    {
      // Column c's gopair and the pair features of (c, ja), (c, jb).
      const long long ka = j0 + (ja < nk ? ja : 0), kb = j0 + (jb < nk ? jb : 0);
      const float* gop_h = a.gopair + row0 * H * CZ4 + h * CZ4;
      const bf16* pz_b = a.pz + b * a.st.pz[0];
#pragma unroll 1
      for (int j = 0; j < 8; ++j) {   // query block j (rotate_block)
#pragma unroll
        for (int e = 0; e < 2; ++e) {   // column 8j + 2q + e
          const int c = 8 * j + 2 * q + e;
          const long long ic = i0 + (c < nq ? c : 0);
          const float4* gp4 = reinterpret_cast<const float4*>(gop_h + ic * H * CZ4);
          const uint4* za = reinterpret_cast<const uint4*>(pz_b + ic * a.st.pz[1] + ka * a.st.pz[2]);
          const uint4* zb = reinterpret_cast<const uint4*>(pz_b + ic * a.st.pz[1] + kb * a.st.pz[2]);
          float gp[CZ4], x[CZ4], y[CZ4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float4 v = gp4[u];
            gp[4 * u] = v.x, gp[4 * u + 1] = v.y, gp[4 * u + 2] = v.z, gp[4 * u + 3] = v.w;
          }
          unpack16(za[0], za[1], x);
          unpack16(zb[0], zb[1], y);
#pragma unroll
          for (int d = 0; d < CZ4; ++d) {
            gt[e] = fmaf(gp[d], x[d], gt[e]);
            gt[2 + e] = fmaf(gp[d], y[d], gt[2 + e]);
          }
        }
        rotate_block(gt);
      }
    }
    lap(4);
    uint32_t ha[16];   // bf16(a)^T: the A fragments of gv's product
    {
      mem_fence_compiler();   // D is read here, not held from the logits
      float av[32];
      load_acc(av, a_s, ja, jb, q);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float D = st_s[4 * (8 * j + 2 * q + e) + 2];
          gt[4 * j + e] = av[4 * j + e] * (gt[4 * j + e] - D);
          gt[4 * j + 2 + e] = av[4 * j + 2 + e] * (gt[4 * j + 2 + e] - D);
        }
      }
#pragma unroll
      for (int k = 0; k < 16; ++k) ha[k] = pack_bf16(av[2 * k], av[2 * k + 1]);
    }
    // From here on gt holds gs^T.
    __syncthreads();   // a is complete
    // Key row ar's a.goptg over the tile's queries (a row of a's space).
    float gvacc[18];
    if (it > 0) {
      load_vec(gvacc, sums);
    } else {
#pragma unroll
      for (int x = 0; x < 18; ++x) gvacc[x] = 0.f;
    }
#pragma unroll 1
    for (int u = 0; u < TQ / 4; ++u) {
      const float4 a4 = *reinterpret_cast<const float4*>(a_s + ar * TQ + ((u ^ (ar & 15)) << 2));
      const float aw[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* orow = og_s + (4 * u + e) * LDO1 + 20 * ah;
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const float4 o4 = reinterpret_cast<const float4*>(orow)[x];
          gvacc[4 * x] = fmaf(aw[e], o4.x, gvacc[4 * x]);
          gvacc[4 * x + 1] = fmaf(aw[e], o4.y, gvacc[4 * x + 1]);
          gvacc[4 * x + 2] = fmaf(aw[e], o4.z, gvacc[4 * x + 2]);
          gvacc[4 * x + 3] = fmaf(aw[e], o4.w, gvacc[4 * x + 3]);
        }
        const float2 o2 = reinterpret_cast<const float2*>(orow)[8];
        gvacc[16] = fmaf(aw[e], o2.x, gvacc[16]);
        gvacc[17] = fmaf(aw[e], o2.y, gvacc[17]);
      }
      mem_fence_compiler();
    }
    store_vec(gvacc, sums);
    uint32_t hs[16];   // bf16(gs)^T: the A fragments of gk's product
#pragma unroll
    for (int k = 0; k < 16; ++k) hs[k] = pack_bf16(gt[2 * k], gt[2 * k + 1]);
    __syncthreads();   // every row's a.goptg has read a
    store_acc(gt, a_s, ja, jb, q);

    lap(5);
    // gk += bf16(gs)^T.Q and gv += bf16(a)^T.bf16(go), Q and bf16(go) read
    // MN-major, each summed over the query tiles in the gkv output.
    float c0[32], c1[32];
    if (it > 0) load_halves(c0, c1, gk_t, 2 * HC, ja, jb, nk, q);
    wgmma_fence();
#pragma unroll
    for (int st = 0; st < TQ / 16; ++st)
      mma_rs_n64<1>(c0, &hs[4 * st], desc_sw128(q_s + st * 2048), st > 0 || it > 0);
#pragma unroll
    for (int st = 0; st < TQ / 16; ++st)
      mma_rs_n64<1>(c1, &hs[4 * st], desc_sw128(q_s + PANEL + st * 2048), st > 0 || it > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(c0);
    fence_regs(c1);
    fence_regs(hs);
    store_halves(c0, c1, gk_t, 2 * HC, ja, jb, nk, q, it == nT - 1 ? s1 : 1.f);
    if (it > 0) load_halves(c0, c1, gv_t, 2 * HC, ja, jb, nk, q);
    wgmma_fence();
#pragma unroll
    for (int st = 0; st < TQ / 16; ++st)
      mma_rs_n64<1>(c0, &ha[4 * st], desc_sw128(go_s + st * 2048), st > 0 || it > 0);
#pragma unroll
    for (int st = 0; st < TQ / 16; ++st)
      mma_rs_n64<1>(c1, &ha[4 * st], desc_sw128(go_s + PANEL + st * 2048), st > 0 || it > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(c0);
    fence_regs(c1);
    fence_regs(ha);
    store_halves(c0, c1, gv_t, 2 * HC, ja, jb, nk, q, 1.f);
    lap(6);
    __syncthreads();   // gs is complete
    // Key row ar's gs.qg and column sum over the tile's queries.
    float gkacc[14];   // gs.qg (12), the column sum, a pad
    if (it > 0) {
      load_vec(gkacc, sums + 18);
    } else {
#pragma unroll
      for (int x = 0; x < 14; ++x) gkacc[x] = 0.f;
    }
#pragma unroll 1
    for (int u = 0; u < TQ / 4; ++u) {
      const float4 g4 = *reinterpret_cast<const float4*>(a_s + ar * TQ + ((u ^ (ar & 15)) << 2));
      const float gw[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        gkacc[12] += gw[e];
        const float4* qr = reinterpret_cast<const float4*>(qg_s + (4 * u + e) * LDK1 + 12 * ah);
#pragma unroll
        for (int x = 0; x < 3; ++x) {
          const float4 q4 = qr[x];
          gkacc[4 * x] = fmaf(gw[e], q4.x, gkacc[4 * x]);
          gkacc[4 * x + 1] = fmaf(gw[e], q4.y, gkacc[4 * x + 1]);
          gkacc[4 * x + 2] = fmaf(gw[e], q4.z, gkacc[4 * x + 2]);
          gkacc[4 * x + 3] = fmaf(gw[e], q4.w, gkacc[4 * x + 3]);
        }
      }
      mem_fence_compiler();
    }
    store_vec(gkacc, sums + 18);
  }

  lap(7);
  // gkg and gvg of key row ar, the block's gsw partial, and the key and
  // value points' frame backwards (gkvp; the rows' d R, d t to GRK).
  __syncthreads();   // Q's and bf16(go)'s spaces are free
  float* kg_s = reinterpret_cast<float*>(smem + XK_KG);
  float* gkg_s = reinterpret_cast<float*>(smem + XK_GKG);
  float* gvg_s = reinterpret_cast<float*>(smem + XK_GVG);
  RawRow xk;
  if (ah == 0) {
    fetch_row<PQ>(xk, a.kvp, a.st.kvp, b, h, 0, j0 + ar, a.kvp_vec, ar < nk);
    store_kg(xk, rt_s + ar * 12, sw, kg_s, nullptr, ar);
  } else {
    fetch_row<PV>(xk, a.kvp, a.st.kvp, b, h, PQ, j0 + ar, a.kvp_vec, ar < nk);
  }
  {
    float gvacc[18];
    load_vec(gvacc, sums);
#pragma unroll
    for (int x = 0; x < 18; ++x) gvg_s[ar * LDO1 + 18 * ah + x] = gvacc[x];
  }
  __syncthreads();
  float gswp = 0.f;
  {
    float gkacc[14];
    load_vec(gkacc, sums + 18);
    const float cs = gkacc[12];
    const float* kr = kg_s + ar * LDK1 + 12 * ah;
#pragma unroll
    for (int x = 0; x < 12; ++x) {
      const float gx = -cs * kr[x] + gkacc[x];
      gswp = fmaf(gx, kr[x], gswp);
      gkg_s[ar * LDK1 + 12 * ah + x] = gx;
    }
  }
  const float gsw_blk = block_sum4(gswp, red_s, tid);   // its barrier publishes gkg_s
  if (tid == 0) a.GSWK[bh * nT + kt] = gsw_blk;
  float rowc[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) rowc[k] = 0.f;
  float* gkvp_s = reinterpret_cast<float*>(smem + XK_V);   // [3][64][PK]: gkvp of the rows
  if (ar < nk) {
    float* gx = gkvp_s + ar * PK;
    if (ah == 0)
      frame_bwd<PQ>(xk, gkg_s + ar * LDK1, rt_s + ar * 12, sw, gx, TQ * PK, rowc);
    else
      frame_bwd<PV>(xk, gvg_s + ar * LDO1, rt_s + ar * 12, 1.f, gx + PQ, TQ * PK, rowc);
  }
#pragma unroll
  for (int k = 0; k < 12; ++k) rowc[k] += __shfl_xor_sync(FULL, rowc[k], 1);
  if (ah == 0 && ar < nk) {
    float4* gr = reinterpret_cast<float4*>(a.GRK + (bh * L + j0 + ar) * 12);
#pragma unroll
    for (int k = 0; k < 3; ++k)
      gr[k] = make_float4(rowc[4 * k], rowc[4 * k + 1], rowc[4 * k + 2], rowc[4 * k + 3]);
  }
  __syncthreads();   // the staged gkvp is complete
  write_planes<PK>(a.gkvp + (bh * 3 * L + j0) * PK, (long long)L * PK, gkvp_s, nk, tid);
  lap(8);
#ifdef IPA2_STAMPS
  if (a.stamps && tid == 0) {
    long long* out = a.stamps + (long long)a.B * H * nT * NQ_STAGES + (bh * nT + kt) * NK_STAGES;
    for (int k = 0; k < NK_STAGES; ++k) out[k] = clk.acc[k];
  }
#endif
}

// ---------------------------------------------------------------- pair kernel
// gpz[b, i, j, :] = sum_h a_h[i, j] gopair_h[i, :] for RB2 query rows a
// block, heads in order, over key chunks of KC: each head's weights
// recomputed in one pass from the saved m, 1/l (q.k of the bf16 values on
// mma.sync, the block's 16 rows its M rows: warp w takes keys 8w .. 8w + 7
// of a chunk; the point term, bias and mask in fp32), two heads a step (the
// next step's K, q and points copied during this one's). Then gr9, gt of the
// rows and gsw of the batch row from the partials.
constexpr int RB2 = 16;                               // query rows a block
constexpr int KC = 32;                                // keys a chunk
constexpr int NHS = 2;                                // heads a step
constexpr int Y_K = 0;                                // bf16 [2][NHS][KC][LDR]: K, two steps' heads
constexpr int Y_Q = Y_K + 2 * NHS * KC * LDR * 2;     // bf16 [2][NHS][RB2][LDR]: the rows' q
constexpr int Y_KG = Y_Q + 2 * NHS * RB2 * LDR * 2;   // fp32 [NHS][KC][LDK1]: kg of the step's heads
constexpr int Y_KSQ = Y_KG + NHS * KC * LDK1 * 4;     // fp32 [NHS][KC]
constexpr int Y_QG = Y_KSQ + NHS * KC * 4;            // fp32 [NHS][RB2][LDK1]: the rows' qg
constexpr int Y_QSQ = Y_QG + NHS * RB2 * LDK1 * 4;    // fp32 [NHS][RB2]
constexpr int Y_RK = Y_QSQ + NHS * RB2 * 4;           // fp32 [KC][12]: R, t of the chunk's keys
constexpr int Y_RQ = Y_RK + KC * 12 * 4;              // fp32 [RB2][12]: R, t of the rows
constexpr int Y_MB = Y_RQ + RB2 * 12 * 4;             // fp32 [KC]: key masks
constexpr int Y_ST = Y_MB + KC * 4;                   // fp32 [H][RB2][2]: the rows' m, 1/l
// ... then bf16 [RB2][KC][H]: the rows' bias of the chunk, every head; then
// fp32 [RB2][H][CZ4]: the rows' gopair, every head.
static_assert(Y_Q % 16 == 0 && Y_KG % 16 == 0 && Y_QG % 16 == 0 && Y_ST % 16 == 0,
              "16-byte aligned copies and rows");
int pair_smem(int H) { return Y_ST + H * RB2 * 8 + RB2 * H * KC * 2 + RB2 * H * CZ4 * 4; }

__global__ void __launch_bounds__(NTH, 2) ipa2_bwd_pair_kernel(const __grid_constant__ BwdArgs a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  float* kg_s = reinterpret_cast<float*>(smem + Y_KG);
  float* ksq_s = reinterpret_cast<float*>(smem + Y_KSQ);
  float* qg_s = reinterpret_cast<float*>(smem + Y_QG);
  float* qsq_s = reinterpret_cast<float*>(smem + Y_QSQ);
  float* rk_s = reinterpret_cast<float*>(smem + Y_RK);
  float* rq_s = reinterpret_cast<float*>(smem + Y_RQ);
  float* mb_s = reinterpret_cast<float*>(smem + Y_MB);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int b = blockIdx.y, i0 = blockIdx.x * RB2;
  const int L = a.L, H = a.H, nT = a.nT;
  const int nr = min(RB2, L - i0);
  const long long HC = (long long)H * C;
  const long long row0 = (long long)b * L;
  const long long* stb = a.st.bias;
  float* st_s = reinterpret_cast<float*>(smem + Y_ST);
  bf16* bias_s = reinterpret_cast<bf16*>(smem + Y_ST + H * RB2 * 8);
  float* gop_s = reinterpret_cast<float*>(smem + Y_ST + H * RB2 * 8 + RB2 * H * KC * 2);
  // Training's bias layout: a view of (B, L, L, H), 16-byte aligned.
  const bool bias_rows = stb[1] == 1 && stb[3] == H && H % 8 == 0 && stb[2] % 8 == 0 &&
                         stb[0] % 8 == 0 && reinterpret_cast<uintptr_t>(a.bias) % 16 == 0;

  // The rows' gopair, every head's (rows contiguous: by cp.async, a group
  // of its own), frames and m, 1/l (m = -inf past L).
  for (int idx = tid; idx < RB2 * H * CZ4 / 4; idx += NTH) {
    const bool ok = idx / (H * CZ4 / 4) < nr;
    cp_async16(smem_u32(gop_s + 4 * idx), a.gopair + (row0 + i0) * H * CZ4 + (ok ? 4 * idx : 0), ok);
  }
  cp_async_commit();
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int idx = tid + NTH * k, r = idx / 12, c = idx % 12;
    const long long row = row0 + i0 + r;
    if (idx < RB2 * 12) rq_s[idx] = r >= nr ? 0.f : c < 9 ? a.r9[row * 9 + c] : a.t[row * 3 + c - 9];
  }
  for (int idx = tid; idx < H * RB2; idx += NTH) {
    const int hh = idx / RB2, r = idx % RB2;
    float m = -INFINITY, inv = 0.f;
    if (r < nr) {
      const float* sp = a.STAT + (((long long)b * H + hh) * L + i0 + r) * 4;
      m = sp[0], inv = sp[1];
    }
    st_s[2 * idx] = m;
    st_s[2 * idx + 1] = inv;
  }

  // K (the chunk's rows) and the block's q rows of step hp's heads 2 hp,
  // 2 hp + 1 into buffer `buf`, one group.
  auto copy = [&](int hp, int buf, int j0, int nk) {
#pragma unroll
    for (int sl = 0; sl < NHS; ++sl) {
      const int hh = min(NHS * hp + sl, H - 1);   // a step past the last head copies it again
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int idx = tid + NTH * k, r = idx >> 4, c = idx & 15;
        const bool valid = r < nk;
        cp_async16(base + Y_K + ((buf * NHS + sl) * KC + r) * LDR * 2 + c * 16,
                   a.kv + (row0 + j0 + (valid ? r : 0)) * 2 * HC + 2LL * hh * C + 8 * c, valid);
      }
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int idx = tid + NTH * k, r = idx >> 4, c = idx & 15;
        const bool valid = r < nr;
        cp_async16(base + Y_Q + ((buf * NHS + sl) * RB2 + r) * LDR * 2 + c * 16,
                   a.q + (row0 + i0 + (valid ? r : 0)) * HC + hh * C + 8 * c, valid);
      }
    }
    cp_async_commit();
  };
  // Thread tid's points of step hp: of head 2 hp + tid / 64, the key points
  // of chunk row lt = tid % 64 (lt < KC) or the query points of row lt - KC
  // (KC <= lt < KC + RB2).
  const int sl_t = tid / 64, lt = tid % 64;
  auto fetch_points = [&](RawRow& rw, int hp, int j0, int nk) {
    const int hh = NHS * hp + sl_t;
    if (lt < KC)
      fetch_row<PQ>(rw, a.kvp, a.st.kvp, b, hh, 0, j0 + lt, a.kvp_vec, lt < nk && hh < H);
    else if (lt < KC + RB2)
      fetch_row<PQ>(rw, a.qp, a.st.qp, b, hh, 0, i0 + lt - KC, a.qp_vec, lt - KC < nr && hh < H);
  };
  const int n_steps = (H + NHS - 1) / NHS;

  for (int j0 = 0; j0 < L; j0 += KC) {
    const int nk = min(KC, L - j0);
    RawRow pts;
    fetch_points(pts, 0, j0, nk);
    // The rows' bias of the chunk, every head's: in training's layout (the
    // heads of a pair contiguous, 16-byte aligned) by cp.async with the
    // first step's copies, else element by element.
    if (bias_rows) {
      const int n16 = H / 8;   // 16-byte chunks of a pair's heads
      for (int idx = tid; idx < RB2 * KC * n16; idx += NTH) {
        const int u = idx % n16, j = (idx / n16) % KC, r = idx / (n16 * KC);
        const bool ok = r < nr && j < nk;
        cp_async16(smem_u32(bias_s + (r * KC + j) * H + 8 * u),
                   a.bias + b * stb[0] + (ok ? (i0 + r) * stb[2] + (j0 + j) * stb[3] : 0) + 8 * u,
                   ok);
      }
    } else {
      for (int idx = tid; idx < RB2 * KC * H; idx += NTH) {
        const int hh = idx % H, j = (idx / H) % KC, r = idx / (H * KC);
        const bool ok = r < nr && j < nk;
        bias_s[idx] = ok ? a.bias[b * stb[0] + hh * stb[1] + (i0 + r) * stb[2] + (j0 + j) * stb[3]]
                         : __float2bfloat16(0.f);
      }
    }
    copy(0, 0, j0, nk);
    // The chunk's frames and key masks.
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int idx = tid + NTH * k, r = idx / 12, c = idx % 12;
      const long long row = row0 + j0 + r;
      rk_s[idx] = r >= nk ? 0.f : c < 9 ? a.r9[row * 9 + c] : a.t[row * 3 + c - 9];
    }
    if (tid < KC) mb_s[tid] = tid < nk ? a.maskb[row0 + j0 + tid] : 0.f;
    __syncthreads();   // the chunk's frames (and, the first time, the rows')
    float acc[4][CZ4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int d = 0; d < CZ4; ++d) acc[u][d] = 0.f;
    for (int hp = 0; hp < n_steps; ++hp) {
      const int buf = hp & 1;
      {
        const int hh = min(NHS * hp + sl_t, H - 1);
        const float swh = a.sw[hh];
        if (lt < KC)
          store_kg(pts, rk_s + lt * 12, swh, kg_s + sl_t * KC * LDK1, ksq_s + sl_t * KC, lt);
        else if (lt < KC + RB2)
          store_kg(pts, rq_s + (lt - KC) * 12, swh, qg_s + sl_t * RB2 * LDK1, qsq_s + sl_t * RB2,
                   lt - KC);
      }
      if (hp + 1 < n_steps) {   // the next step's copies and points fly during this one
        copy(hp + 1, buf ^ 1, j0, nk);
        fetch_points(pts, hp + 1, j0, nk);
        cp_async_wait_group<1>();
      } else {
        cp_async_wait_all();
      }
      __syncthreads();   // this step's K, q, kg and qg

      for (int sl = 0; sl < NHS && NHS * hp + sl < H; ++sl) {   // the step's heads in order
        const int hh = NHS * hp + sl;
        const uint32_t* kr = reinterpret_cast<const uint32_t*>(smem + Y_K) +
                             ((buf * NHS + sl) * KC + 8 * warp + g) * LDR / 2;
        const uint32_t* q0 = reinterpret_cast<const uint32_t*>(smem + Y_Q) +
                             ((buf * NHS + sl) * RB2 + g) * LDR / 2;
        const uint32_t* q1 = q0 + 8 * LDR / 2;
        const float* kgh = kg_s + sl * KC * LDK1;
        const float* ksqh = ksq_s + sl * KC;
        float sacc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < C / 16; ++kk) {
          const uint32_t af[4] = {q0[8 * kk + q], q1[8 * kk + q], q0[8 * kk + 4 + q],
                                  q1[8 * kk + 4 + q]};
          mma_m16n8k16(sacc, af, kr[8 * kk + q], kr[8 * kk + 4 + q]);
        }
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {   // rows g, g + 8: one row's points live at a time
          const int r = g + 8 * rr;
          const float m = st_s[2 * (hh * RB2 + r)], inv = st_s[2 * (hh * RB2 + r) + 1];
          float qr[P3Q];
#pragma unroll
          for (int x = 0; x < P3Q; ++x) qr[x] = qg_s[(sl * RB2 + r) * LDK1 + x];
          const float qsq = qsq_s[sl * RB2 + r];
          const float4* gp = reinterpret_cast<const float4*>(gop_s + (r * H + hh) * CZ4);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int u = 2 * rr + e, j = 8 * warp + 2 * q + e;
            float w = 0.f;
            if (j < nk && m != -INFINITY) {
              const float pt = dot24(qr, kgh + j * LDK1);
              w = expf(sacc[u] * a.s1 + bf2f(bias_s[(r * KC + j) * H + hh]) * a.s2 -
                       0.5f * (qsq + ksqh[j] - 2.f * pt) + mb_s[j] - m) * inv;
            }
#pragma unroll
            for (int v = 0; v < CZ4 / 4; ++v) {
              const float4 g4 = gp[v];
              acc[u][4 * v] = fmaf(w, g4.x, acc[u][4 * v]);
              acc[u][4 * v + 1] = fmaf(w, g4.y, acc[u][4 * v + 1]);
              acc[u][4 * v + 2] = fmaf(w, g4.z, acc[u][4 * v + 2]);
              acc[u][4 * v + 3] = fmaf(w, g4.w, acc[u][4 * v + 3]);
            }
          }
        }
      }
      __syncthreads();   // before the next step's points and copies land over this one's
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int r = g + 8 * (u >> 1), j = 8 * warp + 2 * q + (u & 1);
      if (r < nr && j < nk) {
        float4* out = reinterpret_cast<float4*>(a.gpz + ((row0 + i0 + r) * L + j0 + j) * CZ4);
#pragma unroll
        for (int v = 0; v < CZ4 / 4; ++v)
          out[v] = make_float4(acc[u][4 * v], acc[u][4 * v + 1], acc[u][4 * v + 2], acc[u][4 * v + 3]);
      }
    }
  }
  // gr9 (9) and gt (3) of the block's rows: for each head in order its
  // query-side, then its key-side partial.
  for (int idx = tid; idx < RB2 * 12; idx += NTH) {
    const int r = idx / 12, k = idx % 12;
    if (r < nr) {
      float sum = 0.f;
      for (int hh = 0; hh < H; ++hh) {
        const long long off = (((long long)b * H + hh) * L + i0 + r) * 12 + k;
        sum += a.GRQ[off];
        sum += a.GRK[off];
      }
      if (k < 9)
        a.gr9[(row0 + i0 + r) * 9 + k] = sum;
      else
        a.gt[(row0 + i0 + r) * 3 + k - 9] = sum;
    }
  }
  // gsw[b, h]: the query blocks' partials, then the key blocks', in order.
  if (blockIdx.x == 0 && tid < H) {
    const long long bhh = (long long)b * H + tid;
    float sum = 0.f;
    for (int k = 0; k < nT; ++k) sum += a.GSWQ[bhh * nT + k];
    for (int k = 0; k < nT; ++k) sum += a.GSWK[bhh * nT + k];
    a.gsw[bhh] = sum / a.sw[tid];
  }
}

// The query, key and pair kernels (L > 64).
int launch_long(const BwdArgs& a, cudaStream_t s) {
  static int opt_in[MAX_DEVICES];   // the pair kernel's shared memory opted in so far
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  const int smem3 = pair_smem(a.H);
  if (opt_in[dev] < smem3) {
    err = cudaFuncSetAttribute(ipa2_bwd_query_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               XQ_SMEM);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(ipa2_bwd_key_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               XK_SMEM);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(ipa2_bwd_pair_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem3);
    if (err != cudaSuccess) return (int)err;
    opt_in[dev] = smem3;
  }
  const dim3 grid(a.nT, a.H, a.B);
  ipa2_bwd_query_kernel<<<grid, NTH, XQ_SMEM, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ipa2_bwd_key_kernel<<<grid, NTH, XK_SMEM, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ipa2_bwd_pair_kernel<<<dim3((a.L + RB2 - 1) / RB2, a.B), NTH, smem3, s>>>(a);
  return (int)cudaGetLastError();
}

BwdArgs make_args(const void* q, const void* kv, const void* qp, const void* kvp, const void* r9,
                  const void* t, const void* bias, const void* pz, const void* maskb,
                  const void* sw, const void* go, const void* goptl, const void* gnorm,
                  const void* gopair, void* STAT, void* GOPTG, void* GRQ, void* GRK,
                  void* GSWQ, void* GSWK, void* SUMS, void* gq, void* gkv, void* gqp, void* gkvp, void* gr9,
                  void* gt, void* gbias, void* gpz, void* gsw, const long long* strides, int B,
                  int L, int H, float eps) {
  BwdArgs a;
  a.q = static_cast<const bf16*>(q);
  a.kv = static_cast<const bf16*>(kv);
  a.qp = static_cast<const bf16*>(qp);
  a.kvp = static_cast<const bf16*>(kvp);
  a.bias = static_cast<const bf16*>(bias);
  a.pz = static_cast<const bf16*>(pz);
  a.r9 = static_cast<const float*>(r9);
  a.t = static_cast<const float*>(t);
  a.maskb = static_cast<const float*>(maskb);
  a.sw = static_cast<const float*>(sw);
  a.go = static_cast<const float*>(go);
  a.goptl = static_cast<const float*>(goptl);
  a.gnorm = static_cast<const float*>(gnorm);
  a.gopair = static_cast<const float*>(gopair);
  a.STAT = static_cast<float*>(STAT);
  a.SUMS = static_cast<float*>(SUMS);
  a.GOPTG = static_cast<float*>(GOPTG);
  a.GRQ = static_cast<float*>(GRQ);
  a.GRK = static_cast<float*>(GRK);
  a.GSWQ = static_cast<float*>(GSWQ);
  a.GSWK = static_cast<float*>(GSWK);
  a.gq = static_cast<float*>(gq);
  a.gkv = static_cast<float*>(gkv);
  a.gqp = static_cast<float*>(gqp);
  a.gkvp = static_cast<float*>(gkvp);
  a.gr9 = static_cast<float*>(gr9);
  a.gt = static_cast<float*>(gt);
  a.gbias = static_cast<float*>(gbias);
  a.gpz = static_cast<float*>(gpz);
  a.gsw = static_cast<float*>(gsw);
#ifdef IPA2_STAMPS
  a.stamps = nullptr;
#endif
  for (int k = 0; k < 5; ++k) a.st.qp[k] = strides[k], a.st.kvp[k] = strides[5 + k];
  for (int k = 0; k < 4; ++k) a.st.bias[k] = strides[10 + k], a.st.pz[k] = strides[14 + k];
  a.B = B;
  a.L = L;
  a.H = H;
  a.nT = (L + TQ - 1) / TQ;
  a.qp_vec = a.st.qp[4] == 1 && divisible(a.st.qp, 4, 4) && aligned(qp, 8);
  a.kvp_vec = a.st.kvp[4] == 1 && divisible(a.st.kvp, 4, 4) && aligned(kvp, 8);
  a.eps = eps;
  a.s1 = 1.f / sqrtf(3.f * C);
  a.s2 = 1.f / sqrtf(3.f);
  return a;
}

// The tile kernel takes pz with unit channel stride and 16-byte aligned pairs.
bool pairs_by_rows(const BwdArgs& a) {
  return a.st.pz[3] == 1 && divisible(a.st.pz, 3, 8) && aligned(a.pz, 16);
}

}  // namespace

#define IPA2_BWD_PARAMS                                                                       \
  const void *q, const void *kv, const void *qp, const void *kvp, const void *r9,            \
      const void *t, const void *bias, const void *pz, const void *maskb, const void *sw,    \
      const void *go, const void *goptl, const void *gnorm, const void *gopair, void *STAT,  \
      void *GOPTG, void *GRQ, void *GRK, void *GSWQ, void *GSWK, void *SUMS, void *gq,       \
      void *gkv, void *gqp, void *gkvp, void *gr9, void *gt, void *gbias, void *gpz,         \
      void *gsw, const long long *strides, int B, int L, int H, float eps
#define IPA2_BWD_ARGS                                                                          \
  q, kv, qp, kvp, r9, t, bias, pz, maskb, sw, go, goptl, gnorm, gopair, STAT, GOPTG, GRQ, GRK,  \
      GSWQ, GSWK, SUMS, gq, gkv, gqp, gkvp, gr9, gt, gbias, gpz, gsw, strides, B, L, H, eps

// Launches the backward on `stream`; returns the cudaError_t of the
// launches. `strides` as for ipa2_forward; pz must have unit channel stride
// and 16-byte aligned pairs. For L <= 64 the tile and pair kernels run, and
// of the seven scratch pointers (STAT ... SUMS) only GRQ, (B, H, L, 12)
// fp32, is used (the others may be null). Otherwise the query, key and pair
// kernels run with STAT (B, H, L, 4), GOPTG (B, H, L, 40), GRQ, GRK (B, H,
// L, 12), GSWQ, GSWK (B, H, ceil(L / 64)) and SUMS (B, H, 64 ceil(L / 64),
// 64), all fp32.
extern "C" int ipa2_backward(IPA2_BWD_PARAMS, void* stream) {
  if (B == 0 || L == 0) return 0;
  const BwdArgs a = make_args(IPA2_BWD_ARGS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!pairs_by_rows(a) || !GRQ) return (int)cudaErrorInvalidValue;
  if (tile_path(L)) return launch_tiles(a, s);
  if (!STAT || !GOPTG || !GRK || !GSWQ || !GSWK || !SUMS) return (int)cudaErrorInvalidValue;
  return launch_long(a, s);
}

#ifdef IPA2_STAMPS
// The call with `stamps` (int64). For L <= 64, 12 per tile-kernel block,
// block (h, b) at (b * H + h) * 12, receiving the global timer (ns) at: 0 the
// block's start, 1 the loads sent and the frames stored, 2 the logits,
// softmax and a stored, 3 optg and goptg, 4 the g_a product, 5 its point
// term, 6 its pair term and gs, 7 gq, 8 gk, gv and gbias, 9 the point
// gradients and gsw, 10 the frame backwards, 11 the end (the point gradients
// written). For L > 64, the SM clock cycles of each stage (NQ_STAGES,
// NK_STAGES above), summed over the tiles: NQ_STAGES per query-kernel block
// (b, h, t) at ((b * H + h) * nT + t) * NQ_STAGES, then NK_STAGES per
// key-kernel block likewise (nT = ceil(L / 64)).
extern "C" int ipa2_backward_stamps(IPA2_BWD_PARAMS, void* stamps, void* stream) {
  BwdArgs a = make_args(IPA2_BWD_ARGS);
  if (B == 0 || !pairs_by_rows(a) || !GRQ) return (int)cudaErrorInvalidValue;
  a.stamps = static_cast<long long*>(stamps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile_path(L)) return launch_tiles(a, s);
  if (!STAT || !GOPTG || !GRK || !GSWQ || !GSWK || !SUMS) return (int)cudaErrorInvalidValue;
  return launch_long(a, s);
}
#endif

// Kernels a call launches at length L: 2 for L <= 64, else 3.
extern "C" int ipa2_bwd_kernels_per_call(int L) { return tile_path(L) ? 2 : 3; }

// Dynamic shared memory a block takes at H heads (bytes): `kernel` 0 the
// tile kernel, 1 the pairs kernel (L <= 64), 2 the query, 3 the key, 4 the
// pair kernel (L > 64).
extern "C" int ipa2_bwd_smem_bytes(int kernel, int H) {
  const int bytes[5] = {SMEM1, pairs_smem(H), XQ_SMEM, XK_SMEM, pair_smem(H)};
  return kernel >= 0 && kernel < 5 ? bytes[kernel] : -1;
}
