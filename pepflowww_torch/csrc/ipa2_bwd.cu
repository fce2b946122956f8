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
// L > 64 (the card checks' L = 100 and 256): the first port's four
// kernels, chosen by shape in the launcher, fp32 on the CUDA cores from
// bf16 tiles, with a (B, H, L, L) scratch round trip:
//   1. query kernel, one block per (b, h, 32 query rows): four sweeps over
//      key tiles. The logits go once into a scratch (B, H, L, L) matrix A
//      with the row max and sum; A then becomes the weights a; the point
//      sums give goptg; the next sweep writes g_a into a second scratch GS
//      and sums D_i = sum_j a g_a; the last turns GS into gs, writes gbias
//      and sums gq, rowsum and gs.kg. The query rows' frame gradients go to
//      per-head partials.
//   2. key kernel, one block per (b, h, 32 key rows): reads columns of A
//      and GS back for every query tile and sums gk, gv, gvg, colsum and
//      gs^T.qg; the key rows' frame gradients go to per-head partials.
//   3. gpz, summed over heads in order from A; then gr9, gt and gsw from
//      the partials, in order.
// Nothing is summed across blocks except through partials added in a fixed
// order (no atomics): two calls give bit-identical gradients.

#include "ipa2_tile.cuh"

namespace {

using namespace ipa2;

struct BwdArgs {
  const bf16 *q, *kv, *qp, *kvp, *bias, *pz;
  const float *r9, *t, *maskb, *sw;
  const float *go, *goptl, *gnorm, *gopair;
  float *A, *GS, *GOPTG, *GRQ, *GRK, *GSWQ, *GSWK;                      // scratch
  float *gq, *gkv, *gqp, *gkvp, *gr9, *gt, *gbias, *gpz, *gsw;          // outputs
#ifdef IPA2_STAMPS
  long long* stamps;
#endif
  Layout st;
  int B, L, H, nT;
  bool qp_vec, kvp_vec;
  float eps, s1, s2;
};

// ================================================================ L > 64
// ---------------------------------------------------------------- query side
constexpr int QO_Q = 0;                          // bf16 [T][LDH]
constexpr int QO_K = QO_Q + T * LDH * 2;
constexpr int QO_V = QO_K + T * LDH * 2;
constexpr int QO_GO = QO_V + T * LDH * 2;        // bf16(go) [T][LDH]
constexpr int QO_QG = QO_GO + T * LDH * 2;       // f32 [T][LDG]
constexpr int QO_KG = QO_QG + T * LDG * 4;
constexpr int QO_GQG = QO_KG + T * LDG * 4;
constexpr int QO_VG = QO_GQG + T * LDG * 4;      // f32 [T][LDV]
constexpr int QO_GOPTG = QO_VG + T * LDV * 4;    // f32 [T][LDV]
constexpr int QO_QSQ = QO_GOPTG + T * LDV * 4;   // f32 [T]
constexpr int QO_KSQ = QO_QSQ + T * 4;
constexpr int QO_MB = QO_KSQ + T * 4;
constexpr int QO_P = QO_MB + T * 4;              // f32 [T][LDP]
constexpr int QO_GOP = QO_P + T * LDP * 4;       // f32 [T][CZ4]
constexpr int QO_GR = QO_GOP + T * CZ4 * 4;      // f32 [T][12]
constexpr int QO_RED = QO_GR + T * 12 * 4;       // f32 [16]
constexpr int QO_Z = QO_RED + 64;                // bf16 [T][LDZ]; also f32 [T][PV][12]
constexpr int Q_SMEM = QO_Z + T * LDZ * 2;
static_assert(T * LDZ * 2 >= T * PV * 12 * 4, "reduction scratch fits the pair tile");

__global__ void __launch_bounds__(NT) ipa2_bwd_query_kernel(const BwdArgs a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem + QO_Q);
  bf16* k_s = reinterpret_cast<bf16*>(smem + QO_K);
  bf16* v_s = reinterpret_cast<bf16*>(smem + QO_V);
  bf16* go_s = reinterpret_cast<bf16*>(smem + QO_GO);
  float* qg_s = reinterpret_cast<float*>(smem + QO_QG);
  float* kg_s = reinterpret_cast<float*>(smem + QO_KG);
  float* gqg_s = reinterpret_cast<float*>(smem + QO_GQG);
  float* vg_s = reinterpret_cast<float*>(smem + QO_VG);
  float* goptg_s = reinterpret_cast<float*>(smem + QO_GOPTG);
  float* qsq_s = reinterpret_cast<float*>(smem + QO_QSQ);
  float* ksq_s = reinterpret_cast<float*>(smem + QO_KSQ);
  float* mb_s = reinterpret_cast<float*>(smem + QO_MB);
  float* p_s = reinterpret_cast<float*>(smem + QO_P);
  float* gop_s = reinterpret_cast<float*>(smem + QO_GOP);
  float* gr_s = reinterpret_cast<float*>(smem + QO_GR);
  float* red8 = reinterpret_cast<float*>(smem + QO_RED);
  bf16* z_s = reinterpret_cast<bf16*>(smem + QO_Z);
  float* red_s = reinterpret_cast<float*>(smem + QO_Z);

  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const int rg = tid >> 4, cg = tid & 15;
  const int b = blockIdx.z, h = blockIdx.y, qt = blockIdx.x, i0 = qt * T;
  const int L = a.L, H = a.H;
  const int nq = min(T, L - i0);
  const bool row_ok = ty < nq;
  const int iq = i0 + (row_ok ? ty : 0);
  const float sw = a.sw[h];
  const long long HC = (long long)H * C;
  const long long bh = (long long)b * H + h;
  const bf16* kv_b = a.kv + (long long)b * L * 2 * HC + 2LL * h * C;
  const bf16* bias_row = a.bias + b * a.st.bias[0] + h * a.st.bias[1] + iq * a.st.bias[2];
  float* A_row = a.A + (bh * L + iq) * L;
  float* GS_row = a.GS + (bh * L + iq) * L;
  float* gbias_row = a.gbias + (bh * L + iq) * L;

  load_rows(q_s, a.q + (long long)b * L * HC + h * C, HC, i0, nq, tid);
  load_rows_round(go_s, a.go + (long long)b * L * HC + h * C, HC, i0, nq, tid);
  load_points<PQ>(qg_s, LDG, a.qp, a.st.qp, b, h, 0, a.r9, a.t, L, i0, nq, sw, tid);
  for (int idx = tid; idx < T * CZ4; idx += NT) {
    const int r = idx / CZ4, d = idx % CZ4;
    gop_s[idx] = r < nq ? a.gopair[((long long)b * L + i0 + r) * H * CZ4 + h * CZ4 + d] : 0.f;
  }
  __syncthreads();
  row_sq(qsq_s, qg_s, tid);

  // Sweep 1: logits into A, row max and sum.
  float m = -INFINITY, l = 0.f;
  for (int j0 = 0; j0 < L; j0 += T) {
    const int nk = min(T, L - j0);
    __syncthreads();
    load_rows(k_s, kv_b, 2 * HC, j0, nk, tid);
    load_points<PQ>(kg_s, LDG, a.kvp, a.st.kvp, b, h, 0, a.r9, a.t, L, j0, nk, sw, tid);
    if (tid < T) mb_s[tid] = tid < nk ? a.maskb[(long long)b * L + j0 + tid] : 0.f;
    __syncthreads();
    row_sq(ksq_s, kg_s, tid);
    __syncthreads();
    float s[4];
    tile_logits(s, q_s, qg_s, qsq_s, k_s, kg_s, ksq_s, mb_s, bias_row + j0 * a.st.bias[3],
                a.st.bias[3], nk, ty, tx, a.s1, a.s2);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (row_ok && s[u] != -INFINITY) A_row[j0 + tx + 8 * u] = s[u];
      online(m, l, s[u]);
    }
  }
  combine_stats(m, l);

  // Sweep 2: A becomes the weights; the point sums of the forward.
  float pacc[5] = {};
  for (int j0 = 0; j0 < L; j0 += T) {
    const int nk = min(T, L - j0);
    __syncthreads();
    load_points<PV>(vg_s, LDV, a.kvp, a.st.kvp, b, h, PQ, a.r9, a.t, L, j0, nk, 1.f, tid);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = tx + 8 * u;
      float p = 0.f;
      if (row_ok && j < nk) {
        p = expf(A_row[j0 + j] - m) / l;
        A_row[j0 + j] = p;
      }
      p_s[ty * LDP + j] = p;
    }
    __syncthreads();
    for (int j = 0; j < T; ++j) {
      const float pa = p_s[ty * LDP + j];
#pragma unroll
      for (int u = 0; u < 5; ++u) {
        const int x = tx + 8 * u;
        if (x < P3V) pacc[u] = fmaf(pa, vg_s[j * LDV + x], pacc[u]);
      }
    }
  }

  // Per query row: local points and norms, their cotangents, goptg, and the
  // inverse transform's d R and d t.
  __syncthreads();
#pragma unroll
  for (int u = 0; u < 5; ++u) {
    const int x = tx + 8 * u;
    if (x < P3V) goptg_s[ty * LDV + x] = pacc[u];
  }
  __syncthreads();
  for (int idx = tid; idx < T * PV; idx += NT) {
    const int r = idx / PV, p = idx % PV, i = i0 + r;
    float contrib[12] = {};
    float gg[3] = {0.f, 0.f, 0.f};
    if (r < nq) {
      const float* R = a.r9 + ((long long)b * L + i) * 9;
      const float* t3 = a.t + ((long long)b * L + i) * 3;
      float dif[3], loc[3], gl[3];
      for (int d = 0; d < 3; ++d) dif[d] = goptg_s[r * LDV + d * PV + p] - t3[d];
      float nsq = a.eps;
      for (int c = 0; c < 3; ++c) {
        loc[c] = R[c] * dif[0] + R[3 + c] * dif[1] + R[6 + c] * dif[2];
        nsq += loc[c] * loc[c];
      }
      const float nrm = sqrtf(nsq);
      const float gn = a.gnorm[((long long)b * L + i) * H * PV + h * PV + p];
      const float* glrow = a.goptl + ((long long)b * L + i) * 3 * H * PV + h * PV + p;
      for (int c = 0; c < 3; ++c) gl[c] = glrow[c * H * PV] + loc[c] * gn / nrm;
      float* gout = a.GOPTG + (bh * L + i) * P3V;
      for (int d = 0; d < 3; ++d) {
        gg[d] = R[3 * d] * gl[0] + R[3 * d + 1] * gl[1] + R[3 * d + 2] * gl[2];
        gout[d * PV + p] = gg[d];
        for (int c = 0; c < 3; ++c) contrib[3 * d + c] = dif[d] * gl[c];
        contrib[9 + d] = -gg[d];
      }
    }
    for (int d = 0; d < 3; ++d) goptg_s[r * LDV + d * PV + p] = gg[d];   // this item's own slots
    for (int k = 0; k < 12; ++k) red_s[(r * PV + p) * 12 + k] = contrib[k];
  }
  __syncthreads();
  for (int idx = tid; idx < T * 12; idx += NT) {
    const int r = idx / 12, k = idx % 12;
    float s = 0.f;
    for (int p = 0; p < PV; ++p) s += red_s[(r * PV + p) * 12 + k];
    gr_s[idx] = s;
  }

  // Sweep 3: g_a into GS and D_i = sum_j a g_a.
  float D = 0.f;
  for (int j0 = 0; j0 < L; j0 += T) {
    const int nk = min(T, L - j0);
    __syncthreads();
    load_rows(v_s, kv_b + C, 2 * HC, j0, nk, tid);
    load_points<PV>(vg_s, LDV, a.kvp, a.st.kvp, b, h, PQ, a.r9, a.t, L, j0, nk, 1.f, tid);
    load_pair(z_s, a.pz, a.st.pz, b, i0, nq, j0, nk, tid);
    __syncthreads();
    float ga[4] = {0.f, 0.f, 0.f, 0.f};
    const __nv_bfloat162* gr = reinterpret_cast<const __nv_bfloat162*>(go_s + ty * LDH);
#pragma unroll 4
    for (int c2 = 0; c2 < C / 2; ++c2) {
      const float2 gv2 = __bfloat1622float2(gr[c2]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float2 vv = __bfloat1622float2(
            reinterpret_cast<const __nv_bfloat162*>(v_s + (tx + 8 * u) * LDH)[c2]);
        ga[u] = fmaf(gv2.x, vv.x, ga[u]);
        ga[u] = fmaf(gv2.y, vv.y, ga[u]);
      }
    }
    for (int x = 0; x < P3V; ++x) {
      const float g = goptg_s[ty * LDV + x];
#pragma unroll
      for (int u = 0; u < 4; ++u) ga[u] = fmaf(g, vg_s[(tx + 8 * u) * LDV + x], ga[u]);
    }
    for (int d = 0; d < CZ4; ++d) {
      const float g = gop_s[ty * CZ4 + d];
#pragma unroll
      for (int u = 0; u < 4; ++u) ga[u] = fmaf(g, bf2f(z_s[ty * LDZ + (tx + 8 * u) * CZ4 + d]), ga[u]);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = tx + 8 * u;
      if (row_ok && j < nk) {
        D = fmaf(A_row[j0 + j], ga[u], D);
        GS_row[j0 + j] = ga[u];
      }
    }
  }
  D = sum8(D);

  // Sweep 4: gs = a (g_a - D) into GS, gbias, and the query-side sums.
  float gqa[2][8] = {};
  float gqga[3] = {};
  float rs = 0.f;
  for (int j0 = 0; j0 < L; j0 += T) {
    const int nk = min(T, L - j0);
    __syncthreads();
    load_rows(k_s, kv_b, 2 * HC, j0, nk, tid);
    load_points<PQ>(kg_s, LDG, a.kvp, a.st.kvp, b, h, 0, a.r9, a.t, L, j0, nk, sw, tid);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = tx + 8 * u;
      float g = 0.f;
      if (row_ok && j < nk) {
        g = A_row[j0 + j] * (GS_row[j0 + j] - D);
        GS_row[j0 + j] = g;
        gbias_row[j0 + j] = g * a.s2;
      }
      rs += g;
      p_s[ty * LDP + j] = g;
    }
    __syncthreads();
    for (int j = 0; j < T; ++j) {
      const float g0 = bfr(p_s[(2 * rg) * LDP + j]), g1 = bfr(p_s[(2 * rg + 1) * LDP + j]);
      const __nv_bfloat162* kr = reinterpret_cast<const __nv_bfloat162*>(k_s + j * LDH);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float2 kk = __bfloat1622float2(kr[cg + 16 * u]);
        gqa[0][2 * u] = fmaf(g0, kk.x, gqa[0][2 * u]);
        gqa[0][2 * u + 1] = fmaf(g0, kk.y, gqa[0][2 * u + 1]);
        gqa[1][2 * u] = fmaf(g1, kk.x, gqa[1][2 * u]);
        gqa[1][2 * u + 1] = fmaf(g1, kk.y, gqa[1][2 * u + 1]);
      }
      const float gf = p_s[ty * LDP + j];
#pragma unroll
      for (int u = 0; u < 3; ++u) gqga[u] = fmaf(gf, kg_s[j * LDG + tx + 8 * u], gqga[u]);
    }
  }
  rs = sum8(rs);

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int i = i0 + 2 * rg + rr;
    if (i < L) {
      float* grow = a.gq + ((long long)b * L + i) * HC + h * C;
#pragma unroll
      for (int u = 0; u < 4; ++u)
        *reinterpret_cast<float2*>(grow + 2 * (cg + 16 * u)) =
            make_float2(gqa[rr][2 * u] * a.s1, gqa[rr][2 * u + 1] * a.s1);
    }
  }
  float gswp = 0.f;
#pragma unroll
  for (int u = 0; u < 3; ++u) {
    const int x = tx + 8 * u;
    float g = 0.f;
    if (row_ok) {
      g = -rs * qg_s[ty * LDG + x] + gqga[u];
      gswp = fmaf(g, qg_s[ty * LDG + x], gswp);
    }
    gqg_s[ty * LDG + x] = g;
  }
  const float gsw_blk = block_sum(gswp, red8, tid);   // its barriers publish gqg_s
  if (tid == 0) a.GSWQ[bh * a.nT + qt] = gsw_blk;

  // Frame-transform backward of the query points: row ty, point tx.
  {
    float gu[3], contrib[12] = {};
    for (int c = 0; c < 3; ++c) gu[c] = gqg_s[ty * LDG + c * PQ + tx];
    if (row_ok) {
      const int i = i0 + ty;
      const float* R = a.r9 + ((long long)b * L + i) * 9;
      const bf16* xb = a.qp + b * a.st.qp[0] + h * a.st.qp[1] + i * a.st.qp[3] + tx * a.st.qp[4];
      for (int d = 0; d < 3; ++d) {
        const float gx = (R[d] * gu[0] + R[3 + d] * gu[1] + R[6 + d] * gu[2]) * sw;
        a.gqp[((bh * 3 + d) * L + i) * PQ + tx] = gx;
        const float xd = bf2f(xb[d * a.st.qp[2]]);
        for (int c = 0; c < 3; ++c) contrib[3 * c + d] = xd * gu[c];
      }
      for (int c = 0; c < 3; ++c) contrib[9 + c] = gu[c];
    }
#pragma unroll
    for (int k = 0; k < 12; ++k) {
      const float v = sum8(contrib[k]);
      if (tx == 0 && row_ok) gr_s[ty * 12 + k] += v * sw;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < T * 12; idx += NT) {
    const int r = idx / 12;
    if (r < nq) a.GRQ[(bh * L + i0 + r) * 12 + idx % 12] = gr_s[idx];
  }
}

// ---------------------------------------------------------------- key side
constexpr int KO_K = 0;                          // bf16 [T][LDH]
constexpr int KO_V = KO_K + T * LDH * 2;
constexpr int KO_Q = KO_V + T * LDH * 2;
constexpr int KO_GO = KO_Q + T * LDH * 2;
constexpr int KO_KG = KO_GO + T * LDH * 2;       // f32 [T][LDG]
constexpr int KO_QG = KO_KG + T * LDG * 4;
constexpr int KO_GKG = KO_QG + T * LDG * 4;
constexpr int KO_GOPTG = KO_GKG + T * LDG * 4;   // f32 [T][LDV]
constexpr int KO_GVG = KO_GOPTG + T * LDV * 4;
constexpr int KO_A = KO_GVG + T * LDV * 4;       // f32 [T][LDP] (query, key)
constexpr int KO_GS = KO_A + T * LDP * 4;
constexpr int KO_GR = KO_GS + T * LDP * 4;       // f32 [T][12]
constexpr int KO_RED = KO_GR + T * 12 * 4;       // f32 [16]
constexpr int KO_RS = KO_RED + 64;               // f32 [T][PV][12]
constexpr int K_SMEM = KO_RS + T * PV * 12 * 4;

__global__ void __launch_bounds__(NT) ipa2_bwd_key_kernel(const BwdArgs a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem + KO_K);
  bf16* v_s = reinterpret_cast<bf16*>(smem + KO_V);
  bf16* q_s = reinterpret_cast<bf16*>(smem + KO_Q);
  bf16* go_s = reinterpret_cast<bf16*>(smem + KO_GO);
  float* kg_s = reinterpret_cast<float*>(smem + KO_KG);
  float* qg_s = reinterpret_cast<float*>(smem + KO_QG);
  float* gkg_s = reinterpret_cast<float*>(smem + KO_GKG);
  float* goptg_s = reinterpret_cast<float*>(smem + KO_GOPTG);
  float* gvg_s = reinterpret_cast<float*>(smem + KO_GVG);
  float* a_s = reinterpret_cast<float*>(smem + KO_A);
  float* gs_s = reinterpret_cast<float*>(smem + KO_GS);
  float* gr_s = reinterpret_cast<float*>(smem + KO_GR);
  float* red8 = reinterpret_cast<float*>(smem + KO_RED);
  float* red_s = reinterpret_cast<float*>(smem + KO_RS);

  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const int rg = tid >> 4, cg = tid & 15;        // key rows 2rg, 2rg+1; column pairs cg + 16u
  const int b = blockIdx.z, h = blockIdx.y, kt = blockIdx.x, j0 = kt * T;
  const int L = a.L, H = a.H;
  const int nk = min(T, L - j0);
  const bool row_ok = ty < nk;
  const float sw = a.sw[h];
  const long long HC = (long long)H * C;
  const long long bh = (long long)b * H + h;
  const bf16* kv_b = a.kv + (long long)b * L * 2 * HC + 2LL * h * C;

  load_rows(k_s, kv_b, 2 * HC, j0, nk, tid);
  load_rows(v_s, kv_b + C, 2 * HC, j0, nk, tid);
  load_points<PQ>(kg_s, LDG, a.kvp, a.st.kvp, b, h, 0, a.r9, a.t, L, j0, nk, sw, tid);
  for (int idx = tid; idx < T * 12; idx += NT) gr_s[idx] = 0.f;

  float gka[2][8] = {}, gva[2][8] = {};
  float gvga[5] = {}, gkga[3] = {};
  float cs = 0.f;
  for (int i0 = 0; i0 < L; i0 += T) {
    const int nq = min(T, L - i0);
    __syncthreads();
    load_rows(q_s, a.q + (long long)b * L * HC + h * C, HC, i0, nq, tid);
    load_rows_round(go_s, a.go + (long long)b * L * HC + h * C, HC, i0, nq, tid);
    load_points<PQ>(qg_s, LDG, a.qp, a.st.qp, b, h, 0, a.r9, a.t, L, i0, nq, sw, tid);
    for (int idx = tid; idx < T * P3V; idx += NT) {
      const int r = idx / P3V, x = idx % P3V;
      goptg_s[r * LDV + x] = r < nq ? a.GOPTG[(bh * L + i0 + r) * P3V + x] : 0.f;
    }
    for (int idx = tid; idx < T * T; idx += NT) {
      const int r = idx / T, c = idx % T;
      const bool ok = r < nq && c < nk;
      const long long off = (bh * L + i0 + r) * L + j0 + c;
      a_s[r * LDP + c] = ok ? a.A[off] : 0.f;
      gs_s[r * LDP + c] = ok ? a.GS[off] : 0.f;
    }
    __syncthreads();
    for (int i = 0; i < T; ++i) {
      const float a0 = bfr(a_s[i * LDP + 2 * rg]), a1 = bfr(a_s[i * LDP + 2 * rg + 1]);
      const float g0 = bfr(gs_s[i * LDP + 2 * rg]), g1 = bfr(gs_s[i * LDP + 2 * rg + 1]);
      const __nv_bfloat162* gor = reinterpret_cast<const __nv_bfloat162*>(go_s + i * LDH);
      const __nv_bfloat162* qr = reinterpret_cast<const __nv_bfloat162*>(q_s + i * LDH);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float2 g2 = __bfloat1622float2(gor[cg + 16 * u]);
        const float2 q2 = __bfloat1622float2(qr[cg + 16 * u]);
        gva[0][2 * u] = fmaf(a0, g2.x, gva[0][2 * u]);
        gva[0][2 * u + 1] = fmaf(a0, g2.y, gva[0][2 * u + 1]);
        gva[1][2 * u] = fmaf(a1, g2.x, gva[1][2 * u]);
        gva[1][2 * u + 1] = fmaf(a1, g2.y, gva[1][2 * u + 1]);
        gka[0][2 * u] = fmaf(g0, q2.x, gka[0][2 * u]);
        gka[0][2 * u + 1] = fmaf(g0, q2.y, gka[0][2 * u + 1]);
        gka[1][2 * u] = fmaf(g1, q2.x, gka[1][2 * u]);
        gka[1][2 * u + 1] = fmaf(g1, q2.y, gka[1][2 * u + 1]);
      }
      const float af = a_s[i * LDP + ty], gf = gs_s[i * LDP + ty];
#pragma unroll
      for (int u = 0; u < 5; ++u) {
        const int x = tx + 8 * u;
        if (x < P3V) gvga[u] = fmaf(af, goptg_s[i * LDV + x], gvga[u]);
      }
#pragma unroll
      for (int u = 0; u < 3; ++u) gkga[u] = fmaf(gf, qg_s[i * LDG + tx + 8 * u], gkga[u]);
      cs += gf;
    }
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int j = j0 + 2 * rg + rr;
    if (j < L) {
      float* grow = a.gkv + ((long long)b * L + j) * 2 * HC + 2LL * h * C;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int c = 2 * (cg + 16 * u);
        *reinterpret_cast<float2*>(grow + c) =
            make_float2(gka[rr][2 * u] * a.s1, gka[rr][2 * u + 1] * a.s1);
        *reinterpret_cast<float2*>(grow + C + c) = make_float2(gva[rr][2 * u], gva[rr][2 * u + 1]);
      }
    }
  }
  float gswp = 0.f;
#pragma unroll
  for (int u = 0; u < 3; ++u) {
    const int x = tx + 8 * u;
    float g = 0.f;
    if (row_ok) {
      g = -cs * kg_s[ty * LDG + x] + gkga[u];
      gswp = fmaf(g, kg_s[ty * LDG + x], gswp);
    }
    gkg_s[ty * LDG + x] = g;
  }
#pragma unroll
  for (int u = 0; u < 5; ++u) {
    const int x = tx + 8 * u;
    if (x < P3V) gvg_s[ty * LDV + x] = row_ok ? gvga[u] : 0.f;
  }
  const float gsw_blk = block_sum(gswp, red8, tid);   // its barriers publish gkg_s, gvg_s
  if (tid == 0) a.GSWK[bh * a.nT + kt] = gsw_blk;

  const int PK = PQ + PV;
  // Key points: row ty, point tx, scale sw.
  {
    float gu[3], contrib[12] = {};
    for (int c = 0; c < 3; ++c) gu[c] = gkg_s[ty * LDG + c * PQ + tx];
    if (row_ok) {
      const int j = j0 + ty;
      const float* R = a.r9 + ((long long)b * L + j) * 9;
      const bf16* xb = a.kvp + b * a.st.kvp[0] + h * a.st.kvp[1] + j * a.st.kvp[3] + tx * a.st.kvp[4];
      for (int d = 0; d < 3; ++d) {
        a.gkvp[((bh * 3 + d) * L + j) * PK + tx] =
            (R[d] * gu[0] + R[3 + d] * gu[1] + R[6 + d] * gu[2]) * sw;
        const float xd = bf2f(xb[d * a.st.kvp[2]]);
        for (int c = 0; c < 3; ++c) contrib[3 * c + d] = xd * gu[c];
      }
      for (int c = 0; c < 3; ++c) contrib[9 + c] = gu[c];
    }
#pragma unroll
    for (int k = 0; k < 12; ++k) {
      const float v = sum8(contrib[k]);
      if (tx == 0 && row_ok) gr_s[ty * 12 + k] += v * sw;
    }
  }
  // Value points: scale 1, summed over points through shared memory.
  for (int idx = tid; idx < T * PV; idx += NT) {
    const int r = idx / PV, p = idx % PV;
    float contrib[12] = {};
    if (r < nk) {
      const int j = j0 + r;
      const float* R = a.r9 + ((long long)b * L + j) * 9;
      const bf16* xb = a.kvp + b * a.st.kvp[0] + h * a.st.kvp[1] + j * a.st.kvp[3] +
                       (PQ + p) * a.st.kvp[4];
      float gu[3];
      for (int c = 0; c < 3; ++c) gu[c] = gvg_s[r * LDV + c * PV + p];
      for (int d = 0; d < 3; ++d) {
        a.gkvp[((bh * 3 + d) * L + j) * PK + PQ + p] = R[d] * gu[0] + R[3 + d] * gu[1] + R[6 + d] * gu[2];
        const float xd = bf2f(xb[d * a.st.kvp[2]]);
        for (int c = 0; c < 3; ++c) contrib[3 * c + d] = xd * gu[c];
      }
      for (int c = 0; c < 3; ++c) contrib[9 + c] = gu[c];
    }
    for (int k = 0; k < 12; ++k) red_s[idx * 12 + k] = contrib[k];
  }
  __syncthreads();
  for (int idx = tid; idx < T * 12; idx += NT) {
    const int r = idx / 12, k = idx % 12;
    float s = 0.f;
    for (int p = 0; p < PV; ++p) s += red_s[(r * PV + p) * 12 + k];
    if (r < nk) a.GRK[(bh * L + j0 + r) * 12 + k] = gr_s[idx] + s;
  }
}

// ---------------------------------------------------------------- finish
// gpz[b, i, j, :] = sum_h A[b, h, i, j] gopair[b, i, h, :], heads in order.
__global__ void __launch_bounds__(NT) ipa2_bwd_pair_kernel(const BwdArgs a) {
  const long long idx = (long long)blockIdx.x * NT + threadIdx.x;
  const long long LL = (long long)a.L * a.L;
  if (idx >= (long long)a.B * LL) return;
  const long long b = idx / LL, i = (idx / a.L) % a.L;
  float acc[CZ4] = {};
  for (int h = 0; h < a.H; ++h) {
    const float w = a.A[(b * a.H + h) * LL + idx % LL];
    const float4* gp = reinterpret_cast<const float4*>(a.gopair + (b * a.L + i) * a.H * CZ4 + h * CZ4);
#pragma unroll
    for (int v = 0; v < CZ4 / 4; ++v) {
      const float4 g = gp[v];
      acc[4 * v] = fmaf(w, g.x, acc[4 * v]);
      acc[4 * v + 1] = fmaf(w, g.y, acc[4 * v + 1]);
      acc[4 * v + 2] = fmaf(w, g.z, acc[4 * v + 2]);
      acc[4 * v + 3] = fmaf(w, g.w, acc[4 * v + 3]);
    }
  }
  float4* out = reinterpret_cast<float4*>(a.gpz + idx * CZ4);
#pragma unroll
  for (int v = 0; v < CZ4 / 4; ++v)
    out[v] = make_float4(acc[4 * v], acc[4 * v + 1], acc[4 * v + 2], acc[4 * v + 3]);
}

// gr9, gt per residue from the heads' query- and key-side partials, and
// gsw per (b, h) from the blocks' partials, each in a fixed order.
__global__ void __launch_bounds__(NT) ipa2_bwd_rows_kernel(const BwdArgs a) {
  const int idx = blockIdx.x * NT + threadIdx.x;
  const int n_rows = a.B * a.L;
  if (idx < n_rows) {
    const int b = idx / a.L, l = idx % a.L;
    for (int k = 0; k < 12; ++k) {
      float s = 0.f;
      for (int h = 0; h < a.H; ++h) {
        const long long off = (((long long)b * a.H + h) * a.L + l) * 12 + k;
        s += a.GRQ[off];
        s += a.GRK[off];
      }
      if (k < 9)
        a.gr9[(long long)idx * 9 + k] = s;
      else
        a.gt[(long long)idx * 3 + k - 9] = s;
    }
  } else if (idx < n_rows + a.B * a.H) {
    const int bh = idx - n_rows;
    float s = 0.f;
    for (int k = 0; k < a.nT; ++k) s += a.GSWQ[(long long)bh * a.nT + k];
    for (int k = 0; k < a.nT; ++k) s += a.GSWK[(long long)bh * a.nT + k];
    a.gsw[bh] = s / a.sw[bh % a.H];
  }
}

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
bool g_smem_opt_in[MAX_DEVICES];

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

BwdArgs make_args(const void* q, const void* kv, const void* qp, const void* kvp, const void* r9,
                  const void* t, const void* bias, const void* pz, const void* maskb,
                  const void* sw, const void* go, const void* goptl, const void* gnorm,
                  const void* gopair, void* A, void* GS, void* GOPTG, void* GRQ, void* GRK,
                  void* GSWQ, void* GSWK, void* gq, void* gkv, void* gqp, void* gkvp, void* gr9,
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
  a.A = static_cast<float*>(A);
  a.GS = static_cast<float*>(GS);
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
  a.nT = (L + T - 1) / T;
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
      const void *go, const void *goptl, const void *gnorm, const void *gopair, void *A,     \
      void *GS, void *GOPTG, void *GRQ, void *GRK, void *GSWQ, void *GSWK, void *gq,         \
      void *gkv, void *gqp, void *gkvp, void *gr9, void *gt, void *gbias, void *gpz,         \
      void *gsw, const long long *strides, int B, int L, int H, float eps
#define IPA2_BWD_ARGS                                                                          \
  q, kv, qp, kvp, r9, t, bias, pz, maskb, sw, go, goptl, gnorm, gopair, A, GS, GOPTG, GRQ, GRK, \
      GSWQ, GSWK, gq, gkv, gqp, gkvp, gr9, gt, gbias, gpz, gsw, strides, B, L, H, eps

// Launches the backward on `stream`; returns the cudaError_t of the
// launches. `strides` as for ipa2_forward. For L <= 64 the tile and pair
// kernels run: pz must have unit channel stride and 16-byte aligned pairs,
// and of the seven scratch pointers (A ... GSWK) only GRQ, (B, H, L, 12)
// fp32, is used (the others may be null). Otherwise the four kernels of the
// first port run with A, GS (B, H, L, L), GOPTG (B, H, L, 36), GRQ, GRK (B,
// H, L, 12) and GSWQ, GSWK (B, H, ceil(L / 32)), all fp32.
extern "C" int ipa2_backward(IPA2_BWD_PARAMS, void* stream) {
  if (B == 0 || L == 0) return 0;
  const BwdArgs a = make_args(IPA2_BWD_ARGS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile_path(L))
    return pairs_by_rows(a) && GRQ ? launch_tiles(a, s) : (int)cudaErrorInvalidValue;
  if (!A || !GS || !GOPTG || !GRQ || !GRK || !GSWQ || !GSWK) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!g_smem_opt_in[dev]) {
    err = cudaFuncSetAttribute(ipa2_bwd_query_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Q_SMEM);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(ipa2_bwd_key_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               K_SMEM);
    if (err != cudaSuccess) return (int)err;
    g_smem_opt_in[dev] = true;
  }
  const dim3 grid(a.nT, H, B);
  ipa2_bwd_query_kernel<<<grid, NT, Q_SMEM, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ipa2_bwd_key_kernel<<<grid, NT, K_SMEM, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long pairs = (long long)B * L * L;
  ipa2_bwd_pair_kernel<<<(unsigned)((pairs + NT - 1) / NT), NT, 0, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = B * L + B * H;
  ipa2_bwd_rows_kernel<<<(n + NT - 1) / NT, NT, 0, s>>>(a);
  return (int)cudaGetLastError();
}

#ifdef IPA2_STAMPS
// The call for L <= 64 (anything else returns cudaErrorInvalidValue), with
// `stamps` (int64, 12 per tile-kernel block, block (h, b) at (b * H + h) *
// 12) receiving the global timer (ns) at: 0 the block's start, 1 the loads
// sent and the frames stored, 2 the logits, softmax and a stored, 3 optg and
// goptg, 4 the g_a product, 5 its point term, 6 its pair term and gs, 7 gq,
// 8 gk, gv and gbias, 9 the point gradients and gsw, 10 the frame
// backwards, 11 the end (the point gradients written).
extern "C" int ipa2_backward_stamps(IPA2_BWD_PARAMS, void* stamps, void* stream) {
  BwdArgs a = make_args(IPA2_BWD_ARGS);
  if (B == 0 || !tile_path(L) || !pairs_by_rows(a) || !GRQ) return (int)cudaErrorInvalidValue;
  a.stamps = static_cast<long long*>(stamps);
  return launch_tiles(a, static_cast<cudaStream_t>(stream));
}
#endif

// Kernels a call launches at length L: 2 for L <= 64, else 4.
extern "C" int ipa2_bwd_kernels_per_call(int L) { return tile_path(L) ? 2 : 4; }

// Dynamic shared memory a block of the tile kernel, or of the pair kernel at
// H heads, takes (bytes).
extern "C" int ipa2_bwd_smem_bytes(int pairs, int H) { return pairs ? pairs_smem(H) : SMEM1; }
