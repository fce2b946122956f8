// Fused IPA interior (v2), backward, for Hopper, sm_90a.
//
// Replaces: pepflowww_tpu/models/pallas_ipa2.py::fused_ipa2_bwd (body
// `_bwd_kernel`), the backward half of `fused_ipa2_vjp`.
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
// gsw[b, h] = (sum gqg.qg + sum gkg.kg) / sw_h.
//
// What bounds it on this card: the bytes of the function (~80 MB at B=32,
// L=64 with the fp32 gradients of the (B, H, L, L) bias and the
// (B, L, L, 16) pair features: ~24 us at 3.35 TB/s); its operations
// (~0.17 G bf16 MACs, ~0.1 G fp32 ones) take less. The TPU kernel ran one
// grid step per batch row and added gr9, gt and gpz across heads in place,
// relying on the grid running in order. Hopper's blocks run in parallel, so
// the design splits the work into passes with nothing summed across blocks
// except through partials added in a fixed order (no atomics: two calls
// give bit-identical gradients):
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
// The scratch round trip of A and GS (~4 MB each at B=32, L=64) is this
// design's cost, not the function's. Every L is taken; ragged tiles are
// masked here. fp32 on the CUDA cores from bf16 tiles, no tensor cores yet.

#include "ipa2_common.cuh"

namespace {

using namespace ipa2;

struct BwdArgs {
  const bf16 *q, *kv, *qp, *kvp, *bias, *pz;
  const float *r9, *t, *maskb, *sw;
  const float *go, *goptl, *gnorm, *gopair;
  float *A, *GS, *GOPTG, *GRQ, *GRK, *GSWQ, *GSWK;                      // scratch
  float *gq, *gkv, *gqp, *gkvp, *gr9, *gt, *gbias, *gpz, *gsw;          // outputs
  Layout st;
  int B, L, H, nT;
  float eps, s1, s2;
};

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
  extern __shared__ __align__(16) unsigned char smem[];
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
  extern __shared__ __align__(16) unsigned char smem[];
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

constexpr int MAX_DEVICES = 64;
bool g_smem_opt_in[MAX_DEVICES];

}  // namespace

// Launches the four kernels on `stream`; returns the cudaError_t of the
// launches. `strides` as for ipa2_forward.
extern "C" int ipa2_backward(const void* q, const void* kv, const void* qp, const void* kvp,
                             const void* r9, const void* t, const void* bias, const void* pz,
                             const void* maskb, const void* sw, const void* go, const void* goptl,
                             const void* gnorm, const void* gopair, void* A, void* GS, void* GOPTG,
                             void* GRQ, void* GRK, void* GSWQ, void* GSWK, void* gq, void* gkv,
                             void* gqp, void* gkvp, void* gr9, void* gt, void* gbias, void* gpz,
                             void* gsw, const long long* strides, int B, int L, int H, float eps,
                             void* stream) {
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
  for (int k = 0; k < 5; ++k) a.st.qp[k] = strides[k], a.st.kvp[k] = strides[5 + k];
  for (int k = 0; k < 4; ++k) a.st.bias[k] = strides[10 + k], a.st.pz[k] = strides[14 + k];
  a.B = B;
  a.L = L;
  a.H = H;
  a.nT = (L + T - 1) / T;
  a.eps = eps;
  a.s1 = 1.f / sqrtf(3.f * C);
  a.s2 = 1.f / sqrtf(3.f);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
