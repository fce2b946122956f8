// Fused IPA interior at the JAX package's 2x, 4x and 8x widths (C = 256,
// 512, 1024 scalar channels a head, CZ4 = 32, 64, 128 pair channels; H 8,
// Pq 8, Pv 12 at every width) for Hopper, sm_90a: K7 (forward) and K8
// (backward). The 1x kernels (ipa2.cu, ipa2_bwd.cu) keep their own design.
//
// Replaces: pepflowww_tpu/models/pallas_ipa2.py:126 fused_ipa2 (body
// `_fwd_kernel`) and :344 fused_ipa2_bwd (body `_bwd_kernel`, through
// fused_ipa2_vjp), at these widths.
//
// Why a second design. The 1x kernels keep one 64-query tile's q, its o
// accumulator and the keys' tiles in a block. At C = 1024 one tile's o
// accumulator alone is 64 x 1024 fp32 (256 KB: the whole register file) and
// its q tile 128 KB of bf16. So each C-wide product is a batched tiled GEMM
// of csrc/wide_gemm.cuh (mode BATCH, one (b, h) a blockIdx.y), and the
// (B, H, L, L) attention matrices live in device memory between launches:
//
//   forward (5 launches):
//     points:  qg, kg (scaled by sw), vg, |qg|^2, |kg|^2 a (b, h, l)  (ipaw_points_kernel)
//     S   = s1 q.k^T                                                  (GEMM NT, fp32)
//     a   = softmax(S + s2 bias - pt/2 + maskb), in place; bf16(a)^T;
//           o_pt = R^T (a.vg - t), norms                              (ipaw_row_kernel)
//     o_pair = sum_j a pz, all heads of a query row, pz read once     (ipaw_pair_kernel)
//     o   = bf16(a).v                                                 (GEMM TT)
//   backward (12 launches; the forward recomputed):
//     points; bf16(go); S = s1 q.k^T; G = bf16(go).v^T               (GEMMs NT)
//     a as above, bf16(a); goptg = R gl, the inverse transform's
//           frame-gradient row partials                               (ipaw_row_kernel)
//     G += gopair.pz^T, gpz = sum_h a gopair (heads in order)         (ipaw_pair_kernel)
//     g_a = G + goptg.vg^T; gs = a (g_a - sum_j a g_a): gbias = s2 gs,
//           bf16(gs), bf16(gs)^T; gqg, gqp, the query side's partials  (ipaw_grad_row_kernel)
//     gvg, gkg, gkvp, the key side's partials, a key column a lane    (ipaw_col_kernel)
//     gq = s1 bf16(gs).k; gk = s1 bf16(gs)^T.q; gv = bf16(a)^T.bf16(go) (GEMMs TT)
//     gr9, gt: heads' row partials in order; gsw: rows' partials      (ipaw_finish_kernel)
//
// Rounding points are the JAX kernels': q.k^T in fp32 from bf16, bf16(a).v,
// bf16(go).v^T, bf16(gs).k, bf16(gs)^T.q, bf16(a)^T.bf16(go); everything
// else fp32. Every sum across blocks, heads or rows is a partial added in a
// fixed order; no atomics: two calls give the same bits.
//
// What bounds it: the bytes (bounds.ipa2_bound_ms: 36.1 us at C 256, B=64,
// L=64; the backward 82.1 us). The (B, H, L, L) fp32 scratch (S, G: 8.4 MB
// at B=64, L=64) and its bf16 copies make several passes through device
// memory, and the pair readout re-reads a for all heads of a row: the price
// of the simple design, left to a later change.

#include "ipa2_common.cuh"
#include "wide_gemm.cuh"

namespace ipaw {

using ipa2::bf16;
using ipa2::Layout;

constexpr int H = 8, PQ = 8, PV = 12, P3Q = 3 * PQ, P3V = 3 * PV;
// A (b, h, l) point record of the points kernel: qg | kg | vg | |qg|^2 | |kg|^2.
constexpr int QG = 0, KG = P3Q, VG = 2 * P3Q, QSQ = VG + P3V, KSQ = QSQ + 1, PW = 88;
constexpr int ROWS = 8;        // row kernels: one query row a warp
constexpr int PAIR_T = 256;    // pair kernel: threads of a block
constexpr int COL_W = 8;       // column kernel: warps (over query rows) of a block
constexpr int NACC = P3V + P3Q + 1;   // column kernel: gvg | gkg | column sum
constexpr int RT = 12;         // frame-gradient row partial: gR (3 x 3) | gT (3)
constexpr int MAX_L = 4096;
constexpr int MAX_DEVICES = 16;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int m = 16; m; m >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, m));
  return v;
}

// What the kernels of one call read and write.
struct Args {
  const bf16 *q, *kv, *qp, *kvp, *bias, *pz;
  const float *r9, *t, *maskb, *sw;
  const float *go, *goptl, *gnorm, *gopair;   // backward: the cotangents
  Layout lay;
  float* P;          // [B H L][PW]
  float* S;          // [B H L][Lp]: logits, then a
  float* G;          // [B H L][Lp]: bf16(go).v^T, + the pair term, then gs
  bf16* ac;          // forward: bf16(a)^T [B H][Lp (j)][Lp (i)]; backward: bf16(a) [i][j]
  bf16 *gsc, *gsct;  // bf16(gs) [B H][i][j] and its transpose [j][i]
  float* GO;         // goptg [B H L][3 PV]
  float *RTq, *RTk;  // frame-gradient partials of the query and key sides [B H L][RT]
  float *SWq, *SWk;  // point-weight gradient partials [B H L]
  float *o_ptl, *o_norm, *o_pair;                 // forward outputs
  float *gbias, *gpz, *gqp, *gkvp, *gr9, *gt, *gsw;  // backward outputs
  int B, L, Lp, C, cz4;
  float eps;
};

// Point p of head h at row l of a (B, H, 3, L, n) strided tensor: coordinate d.
__device__ __forceinline__ float pt_at(const bf16* x, const long long (&s)[5], int b, int h, int d,
                                       int l, int p) {
  return __bfloat162float(x[b * s[0] + h * s[1] + d * s[2] + l * s[3] + p * s[4]]);
}

// One thread a (b, h, l): the global points u_c = (sum_d R[c][d] x_d + t_c)
// scale, scale sw_h for query and key points, 1 for value points, and the
// squared norms of the query and key points.
__global__ void __launch_bounds__(256) ipaw_points_kernel(const __grid_constant__ Args a) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)a.B * H * a.L) return;
  const int l = (int)(idx % a.L), bh = (int)(idx / a.L), h = bh % H, b = bh / H;
  const float* R = a.r9 + ((long long)b * a.L + l) * 9;
  const float* T = a.t + ((long long)b * a.L + l) * 3;
  float* out = a.P + idx * PW;
  // (source, its strides, first point, points, scale, record offset, squared norm slot)
  auto points = [&](const bf16* x, const long long (&st)[5], int p0, int n, float scale, int off,
                    int sq) {
    float s = 0.f;
    for (int p = 0; p < n; ++p) {
      float v[3];
#pragma unroll
      for (int d = 0; d < 3; ++d) v[d] = pt_at(x, st, b, h, d, l, p0 + p);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float u = (R[3 * c] * v[0] + R[3 * c + 1] * v[1] + R[3 * c + 2] * v[2] + T[c]) * scale;
        out[off + c * n + p] = u;
        s += u * u;
      }
    }
    if (sq >= 0) out[sq] = s;
  };
  const float sw = a.sw[h];
  points(a.qp, a.lay.qp, 0, PQ, sw, QG, QSQ);
  points(a.kvp, a.lay.kvp, 0, PQ, sw, KG, KSQ);
  points(a.kvp, a.lay.kvp, PQ, PV, 1.f, VG, -1);
}

// One warp a query row i of one (b, h): the logits completed in place
// (+ s2 bias, - pt / 2, + the key mask), the softmax a (fp32, in place),
// its bf16 copy, the point aggregation a.vg, and from it the forward's
// local points and norms or the backward's goptg and the inverse
// transform's frame-gradient row partial.
template <bool BWD>
__global__ void __launch_bounds__(ROWS * 32) ipaw_row_kernel(const __grid_constant__ Args a) {
  const int lane = threadIdx.x & 31, i = blockIdx.y * ROWS + (threadIdx.x >> 5);
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H, L = a.L, Lp = a.Lp;
  if (i >= L) return;
  const float s2 = 0.57735026918962573f;   // 1 / sqrt(3)
  const float* Pbh = a.P + (long long)bh * L * PW;
  const float* Pi = Pbh + (long long)i * PW;
  float* Srow = a.S + ((long long)bh * L + i) * Lp;
  const bf16* brow = a.bias + b * a.lay.bias[0] + h * a.lay.bias[1] + i * a.lay.bias[2];
  const long long bs = a.lay.bias[3];
  const float* mrow = a.maskb + (long long)b * L;
  float qg[P3Q];
#pragma unroll
  for (int k = 0; k < P3Q; ++k) qg[k] = Pi[QG + k];
  const float qsq = Pi[QSQ];
  float mx = -INFINITY;
  for (int j = lane; j < L; j += 32) {
    const float* Pj = Pbh + (long long)j * PW;
    float dot = 0.f;
#pragma unroll
    for (int k = 0; k < P3Q; ++k) dot += qg[k] * Pj[KG + k];
    const float pt = qsq + Pj[KSQ] - 2.f * dot;
    const float s = Srow[j] + __bfloat162float(brow[j * bs]) * s2 - 0.5f * pt + mrow[j];
    Srow[j] = s;
    mx = fmaxf(mx, s);
  }
  mx = warp_max(mx);
  float sum = 0.f;
  for (int j = lane; j < L; j += 32) {
    const float e = expf(Srow[j] - mx);
    Srow[j] = e;
    sum += e;
  }
  sum = wide::warp_sum(sum);
  bf16* ac = a.ac + (long long)bh * Lp * Lp;
  float ov[P3V];
#pragma unroll
  for (int k = 0; k < P3V; ++k) ov[k] = 0.f;
  for (int j = lane; j < L; j += 32) {
    const float w = Srow[j] / sum;
    Srow[j] = w;
    ac[BWD ? (long long)i * Lp + j : (long long)j * Lp + i] = __float2bfloat16(w);
    const float* Pj = Pbh + (long long)j * PW;
#pragma unroll
    for (int k = 0; k < P3V; ++k) ov[k] += w * Pj[VG + k];
  }
#pragma unroll
  for (int k = 0; k < P3V; ++k) ov[k] = wide::warp_sum(ov[k]);
  // Per point p: dif = a.vg - t, local = R^T dif, norm; every lane computes
  // them, lane 0 writes.
  const float* R = a.r9 + ((long long)b * L + i) * 9;   // R[d][c] = R[3 d + c]
  const float* T = a.t + ((long long)b * L + i) * 3;
  const long long orow = (long long)b * L + i;
  float rt[RT];
#pragma unroll
  for (int k = 0; k < RT; ++k) rt[k] = 0.f;
#pragma unroll
  for (int p = 0; p < PV; ++p) {
    float dif[3], loc[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) dif[d] = ov[d * PV + p] - T[d];
    float nsq = a.eps;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      loc[c] = R[c] * dif[0] + R[3 + c] * dif[1] + R[6 + c] * dif[2];
      nsq = nsq + loc[c] * loc[c];
    }
    const float nrm = sqrtf(nsq);
    if (!BWD) {
      if (lane == 0) {
#pragma unroll
        for (int c = 0; c < 3; ++c) a.o_ptl[orow * 3 * H * PV + c * H * PV + h * PV + p] = loc[c];
        a.o_norm[orow * H * PV + h * PV + p] = nrm;
      }
    } else {
      float gl[3];
      const float gn = a.gnorm[orow * H * PV + h * PV + p];
#pragma unroll
      for (int c = 0; c < 3; ++c)
        gl[c] = a.goptl[orow * 3 * H * PV + c * H * PV + h * PV + p] + loc[c] * gn / nrm;
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const float g = R[3 * d] * gl[0] + R[3 * d + 1] * gl[1] + R[3 * d + 2] * gl[2];
        if (lane == 0) a.GO[((long long)bh * L + i) * P3V + d * PV + p] = g;
        rt[9 + d] += g;
#pragma unroll
        for (int c = 0; c < 3; ++c) rt[3 * d + c] += dif[d] * gl[c];
      }
    }
  }
  if (BWD && lane == 0) {
    float* out = a.RTq + ((long long)bh * L + i) * RT;
#pragma unroll
    for (int k = 0; k < 9; ++k) out[k] = rt[k];
#pragma unroll
    for (int d = 0; d < 3; ++d) out[9 + d] = -rt[9 + d];
  }
}

// One block a query row (b, i), all heads: a of the row's H heads staged in
// shared memory. Forward: o_pair[h][d] = sum_j a[h][j] pz[j][d], thread t
// taking channel t % cz4 over keys t / cz4, t / cz4 + 256 / cz4, ...; their
// partials added in key-group order. Backward: the pair term of g_a,
// G[h][i][j] += sum_d gopair[h][d] pz[j][d] (a thread a key), and gpz[j][d]
// = sum_h a[h][j] gopair[h][d], heads in order.
template <bool BWD>
__global__ void __launch_bounds__(PAIR_T) ipaw_pair_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) float sm[];
  const int L = a.L, Lp = a.Lp, cz4 = a.cz4, t = threadIdx.x;
  const int b = blockIdx.x / L, i = blockIdx.x - b * L;
  float* ash = sm;                 // [H][L]
  float* tail = sm + H * L;        // forward: [256 / cz4][H][cz4]; backward: gopair [H][cz4]
  for (int e = t; e < H * L; e += PAIR_T) {
    const int h = e / L, j = e - h * L;
    ash[e] = a.S[(((long long)b * H + h) * L + i) * Lp + j];
  }
  const bf16* pzr = a.pz + b * a.lay.pz[0] + i * a.lay.pz[1];
  const long long ps = a.lay.pz[2], pd = a.lay.pz[3];
  const long long row = (long long)b * L + i;
  if (!BWD) {
    __syncthreads();
    const int d = t % cz4, jg = t / cz4, njg = PAIR_T / cz4;
    float acc[H];
#pragma unroll
    for (int h = 0; h < H; ++h) acc[h] = 0.f;
    for (int j = jg; j < L; j += njg) {
      const float v = __bfloat162float(pzr[j * ps + d * pd]);
#pragma unroll
      for (int h = 0; h < H; ++h) acc[h] += ash[h * L + j] * v;
    }
#pragma unroll
    for (int h = 0; h < H; ++h) tail[(jg * H + h) * cz4 + d] = acc[h];
    __syncthreads();
    for (int o = t; o < H * cz4; o += PAIR_T) {
      float s = 0.f;
      for (int g = 0; g < njg; ++g) s += tail[g * H * cz4 + o];
      a.o_pair[row * H * cz4 + o] = s;
    }
    return;
  }
  for (int o = t; o < H * cz4; o += PAIR_T) tail[o] = a.gopair[row * H * cz4 + o];
  __syncthreads();
  for (int j = t; j < L; j += PAIR_T) {
    float acc[H];
#pragma unroll
    for (int h = 0; h < H; ++h) acc[h] = 0.f;
    for (int d = 0; d < cz4; ++d) {
      const float v = __bfloat162float(pzr[j * ps + d * pd]);
#pragma unroll
      for (int h = 0; h < H; ++h) acc[h] += tail[h * cz4 + d] * v;
    }
#pragma unroll
    for (int h = 0; h < H; ++h) a.G[(((long long)b * H + h) * L + i) * Lp + j] += acc[h];
  }
  float* gpz = a.gpz + row * L * cz4;
  for (int e = t; e < L * cz4; e += PAIR_T) {
    const int j = e / cz4, d = e - j * cz4;
    float s = 0.f;
#pragma unroll
    for (int h = 0; h < H; ++h) s += ash[h * L + j] * tail[h * cz4 + d];
    gpz[e] = s;
  }
}

// One warp a query row i of one (b, h), after the pair kernel: g_a = G +
// goptg.vg^T, gs = a (g_a - sum_j a g_a); gbias = s2 gs, gs (fp32, in place
// of G) and its bf16 copies; gqg = -rowsum(gs) qg + gs.kg, the query
// points' gradient gqp, the query side's frame-gradient row partial (added
// to the inverse transform's) and its point-weight partial.
__global__ void __launch_bounds__(ROWS * 32) ipaw_grad_row_kernel(const __grid_constant__ Args a) {
  const int lane = threadIdx.x & 31, i = blockIdx.y * ROWS + (threadIdx.x >> 5);
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H, L = a.L, Lp = a.Lp;
  if (i >= L) return;
  const float s2 = 0.57735026918962573f;
  const float* Pbh = a.P + (long long)bh * L * PW;
  const float* Pi = Pbh + (long long)i * PW;
  const float* Arow = a.S + ((long long)bh * L + i) * Lp;
  float* Grow = a.G + ((long long)bh * L + i) * Lp;
  float go[P3V];
#pragma unroll
  for (int k = 0; k < P3V; ++k) go[k] = a.GO[((long long)bh * L + i) * P3V + k];
  float dsum = 0.f;
  for (int j = lane; j < L; j += 32) {
    const float* Pj = Pbh + (long long)j * PW;
    float pt = 0.f;
#pragma unroll
    for (int k = 0; k < P3V; ++k) pt += go[k] * Pj[VG + k];
    const float ga = Grow[j] + pt;
    Grow[j] = ga;
    dsum += Arow[j] * ga;
  }
  dsum = wide::warp_sum(dsum);
  float gq[P3Q], rs = 0.f;
#pragma unroll
  for (int k = 0; k < P3Q; ++k) gq[k] = 0.f;
  float* gb = a.gbias + ((long long)bh * L + i) * L;
  bf16* gsc = a.gsc + (long long)bh * Lp * Lp;
  bf16* gsct = a.gsct + (long long)bh * Lp * Lp;
  for (int j = lane; j < L; j += 32) {
    const float gs = Arow[j] * (Grow[j] - dsum);
    gb[j] = gs * s2;
    Grow[j] = gs;
    const bf16 g16 = __float2bfloat16(gs);
    gsc[(long long)i * Lp + j] = g16;
    gsct[(long long)j * Lp + i] = g16;
    rs += gs;
    const float* Pj = Pbh + (long long)j * PW;
#pragma unroll
    for (int k = 0; k < P3Q; ++k) gq[k] += gs * Pj[KG + k];
  }
  rs = wide::warp_sum(rs);
#pragma unroll
  for (int k = 0; k < P3Q; ++k) gq[k] = wide::warp_sum(gq[k]);
  // The query side of the frame transform's backward: every lane computes
  // it, lane 0 writes.
  const float* R = a.r9 + ((long long)b * L + i) * 9;
  const float sw = a.sw[h];
  float gr[9], gt[3], swp = 0.f;
#pragma unroll
  for (int k = 0; k < 9; ++k) gr[k] = 0.f;
#pragma unroll
  for (int c = 0; c < 3; ++c) gt[c] = 0.f;
#pragma unroll
  for (int p = 0; p < PQ; ++p) {
    float gu[3], x[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      gu[c] = -rs * Pi[QG + c * PQ + p] + gq[c * PQ + p];
      swp += gu[c] * Pi[QG + c * PQ + p];
      x[c] = pt_at(a.qp, a.lay.qp, b, h, c, i, p);
    }
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float gx = (R[d] * gu[0] + R[3 + d] * gu[1] + R[6 + d] * gu[2]) * sw;
      if (lane == 0) a.gqp[(((long long)b * H + h) * 3 + d) * L * PQ + (long long)i * PQ + p] = gx;
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      gt[c] += gu[c];
#pragma unroll
      for (int d = 0; d < 3; ++d) gr[3 * c + d] += x[d] * gu[c];
    }
  }
  if (lane == 0) {
    float* out = a.RTq + ((long long)bh * L + i) * RT;
#pragma unroll
    for (int k = 0; k < 9; ++k) out[k] += gr[k] * sw;
#pragma unroll
    for (int c = 0; c < 3; ++c) out[9 + c] += gt[c] * sw;
    a.SWq[(long long)bh * L + i] = swp;
  }
}

// One block 32 keys j (a lane each) of one (b, h), its warps over query
// rows i = w, w + 8, ...: gvg_j = sum_i a goptg_i, gkg_j = -colsum(gs) kg_j
// + sum_i gs qg_i; the warps' partials added in warp order; then a thread a
// key: the key and value points' gradient gkvp, the key side's
// frame-gradient row partial and its point-weight partial.
__global__ void __launch_bounds__(COL_W * 32) ipaw_col_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) float red[];   // [COL_W][NACC][32]
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H, L = a.L, Lp = a.Lp;
  const int j = blockIdx.y * 32 + lane;
  const float* Pbh = a.P + (long long)bh * L * PW;
  float acc[NACC];
#pragma unroll
  for (int k = 0; k < NACC; ++k) acc[k] = 0.f;
  if (j < L) {
    for (int i = w; i < L; i += COL_W) {
      const long long r = (long long)bh * L + i;
      const float av = a.S[r * Lp + j], gs = a.G[r * Lp + j];
      const float* go = a.GO + r * P3V;
      const float* qg = Pbh + (long long)i * PW + QG;
#pragma unroll
      for (int k = 0; k < P3V; ++k) acc[k] += av * go[k];
#pragma unroll
      for (int k = 0; k < P3Q; ++k) acc[P3V + k] += gs * qg[k];
      acc[NACC - 1] += gs;
    }
  }
#pragma unroll
  for (int k = 0; k < NACC; ++k) red[(w * NACC + k) * 32 + lane] = acc[k];
  __syncthreads();
  if (w != 0 || j >= L) return;
#pragma unroll
  for (int k = 0; k < NACC; ++k) {
    float s = 0.f;
#pragma unroll
    for (int v = 0; v < COL_W; ++v) s += red[(v * NACC + k) * 32 + lane];
    acc[k] = s;
  }
  const float* Pj = Pbh + (long long)j * PW;
  const float* R = a.r9 + ((long long)b * L + j) * 9;
  const float sw = a.sw[h], cs = acc[NACC - 1];
  float grk[9], gtk[3], grv[9], gtv[3], swp = 0.f;
#pragma unroll
  for (int k = 0; k < 9; ++k) grk[k] = grv[k] = 0.f;
#pragma unroll
  for (int c = 0; c < 3; ++c) gtk[c] = gtv[c] = 0.f;
  float* gkvp = a.gkvp + ((long long)b * H + h) * 3 * L * (PQ + PV) + (long long)j * (PQ + PV);
  const long long plane = (long long)L * (PQ + PV);
#pragma unroll
  for (int p = 0; p < PQ + PV; ++p) {
    const bool key = p < PQ;
    float gu[3], x[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      if (key) {
        const float kg = Pj[KG + c * PQ + p];
        gu[c] = -cs * kg + acc[P3V + c * PQ + p];
        swp += gu[c] * kg;
      } else {
        gu[c] = acc[c * PV + p - PQ];
      }
      x[c] = pt_at(a.kvp, a.lay.kvp, b, h, c, j, p);
    }
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float gx = R[d] * gu[0] + R[3 + d] * gu[1] + R[6 + d] * gu[2];
      gkvp[d * plane + p] = key ? gx * sw : gx;
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      (key ? gtk : gtv)[c] += gu[c];
#pragma unroll
      for (int d = 0; d < 3; ++d) (key ? grk : grv)[3 * c + d] += x[d] * gu[c];
    }
  }
  float* out = a.RTk + ((long long)bh * L + j) * RT;
#pragma unroll
  for (int k = 0; k < 9; ++k) out[k] = grk[k] * sw + grv[k];
#pragma unroll
  for (int c = 0; c < 3; ++c) out[9 + c] = gtk[c] * sw + gtv[c];
  a.SWk[(long long)bh * L + j] = swp;
}

// gr9, gt: each (b, l, k) the heads' query-side and key-side partials, in
// head order; gsw[b][h]: the rows' partials in row order, over sw_h.
__global__ void __launch_bounds__(256) ipaw_finish_kernel(const __grid_constant__ Args a) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nrt = (long long)a.B * a.L * RT;
  const int L = a.L;
  if (idx < nrt) {
    const int k = (int)(idx % RT);
    const long long bl = idx / RT;
    const int b = (int)(bl / L), l = (int)(bl - (long long)b * L);
    float s = 0.f;
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const long long r = (((long long)b * H + h) * L + l) * RT + k;
      s += a.RTq[r] + a.RTk[r];
    }
    if (k < 9) a.gr9[bl * 9 + k] = s;
    else a.gt[bl * 3 + k - 9] = s;
  } else if (idx < nrt + (long long)a.B * H) {
    const int bh = (int)(idx - nrt), h = bh % H;
    float s = 0.f;
    for (int l = 0; l < L; ++l) s += a.SWq[(long long)bh * L + l] + a.SWk[(long long)bh * L + l];
    a.gsw[bh] = s / a.sw[h];
  }
}

// bf16 copy of the fp32 cotangent go, four values a thread.
__global__ void __launch_bounds__(256) ipaw_bf16_kernel(const float4* __restrict__ x,
                                                        __nv_bfloat162* __restrict__ y,
                                                        long long n4) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n4) return;
  const float4 v = x[idx];
  y[2 * idx] = __floats2bfloat162_rn(v.x, v.y);
  y[2 * idx + 1] = __floats2bfloat162_rn(v.z, v.w);
}

inline int blocks_of(long long n) { return (int)((n + 255) / 256); }

// Dynamic shared memory of the pair kernel (forward or backward) and of the
// column kernel, bytes.
inline int pair_smem(int backward, int L, int cz4) {
  return 4 * (H * L + (backward ? H * cz4 : H * PAIR_T));
}
constexpr int COL_SMEM = 4 * COL_W * NACC * 32;

// Lets `kernel` take `bytes` of dynamic shared memory on this device (once).
template <typename K>
static int opt_in(K kernel, int bytes, bool (&done)[MAX_DEVICES]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    done[dev] = true;
  }
  return 0;
}

static int check_shape(int B, int L, int C, int cz4) {
  if (B <= 0 || L <= 0) return -1;
  if (L > MAX_L || (long long)B * H > 65535) return (int)cudaErrorInvalidValue;
  if (C != 256 && C != 512 && C != 1024) return (int)cudaErrorInvalidValue;
  if (cz4 != 32 && cz4 != 64 && cz4 != 128) return (int)cudaErrorInvalidValue;
  return 0;
}

// S = s1 q.k^T (NT over C) into a.S; with `gob`, G = bf16(go).v^T into a.G.
static int logits(const Args& a, const bf16* gob, cudaStream_t st) {
  using namespace wide;
  const int L = a.L, C = a.C;
  const long long hc = (long long)H * C;
  Epi e{};
  e.H = H;
  e.a_b = L * hc;
  e.a_h = C;
  e.b_b = 2 * L * hc;
  e.b_h = 2 * C;
  e.o_b = (long long)H * L * a.Lp;
  e.o_h = (long long)L * a.Lp;
  e.ld_f32 = a.Lp;
  e.f32 = a.S;
  e.alpha = (float)(1.0 / sqrt(3.0 * C));   // s1, as the JAX wrapper rounds it
  WIDE_TRY((gemm<64, 64, false, BATCH>(opd(seg(a.q, (int)hc)), opd(seg(a.kv, (int)(2 * hc))), L,
                                       L, C, 0, L, e, st, a.B * H)));
  if (gob == nullptr) return 0;
  e.f32 = a.G;
  e.alpha = 1.f;
  return gemm<64, 64, false, BATCH>(opd(seg(gob, (int)hc)), opd(seg(a.kv + C, (int)(2 * hc))), L,
                                    L, C, 0, L, e, st, a.B * H);
}

// out[b][i][h ldh + c] = alpha sum_k A_bh[k][i] B[b][k][h bh + c] (TT over
// the L keys or query rows): A a bf16 [B H][Lp][Lp] scratch, B rows of ldb
// elements.
static int aggregate(const Args& a, const bf16* A, const bf16* Bm, int ldb, int bh_stride,
                     float* out, int ldo, int oh_stride, float alpha, cudaStream_t st) {
  using namespace wide;
  const int L = a.L, Lp = a.Lp;
  Epi e{};
  e.H = H;
  e.a_b = (long long)H * Lp * Lp;
  e.a_h = (long long)Lp * Lp;
  e.b_b = (long long)L * ldb;
  e.b_h = bh_stride;
  e.f32 = out;
  e.ld_f32 = ldo;
  e.o_b = (long long)L * ldo;
  e.o_h = oh_stride;
  e.alpha = alpha;
  return gemm<64, 128, true, BATCH>(opd(seg(A, Lp)), opd(seg(Bm, ldb)), L, a.C, L, 0, L, e, st,
                                    a.B * H);
}

}  // namespace ipaw

using ipaw::Args;

// Device launches of one call: 5 forward, 12 backward.
extern "C" int ipa2_wide_kernels_per_call(int backward) { return backward ? 12 : 5; }

// Dynamic shared memory a block, bytes: kind 0 the forward pair kernel, 1
// the backward's, 2 the column kernel, at length L and cz4 pair channels.
extern "C" int ipa2_wide_smem_bytes(int kind, int L, int cz4) {
  return kind == 2 ? ipaw::COL_SMEM : ipaw::pair_smem(kind, L, cz4);
}

// Longest L the kernels take.
extern "C" int ipa2_wide_max_length() { return ipaw::MAX_L; }

// K7 at C = 256, 512, 1024, cz4 = 32, 64, 128 (H 8, Pq 8, Pv 12): q (B, L,
// H C) and kv (B, L, 2 H C) bf16 contiguous; qp, kvp, bias, pz bf16 read
// through the 18 element strides of `strides` (ipa2::Layout); r9, t, maskb,
// sw fp32 contiguous. Scratch: P [B H L][88] f32, S [B H L][Lp] f32, ac [B
// H][Lp][Lp] bf16 (Lp = L rounded up to 8). Outputs o, o_ptl, norm, o_pair
// fp32. Returns the first nonzero cudaError_t of its launches.
extern "C" int ipa2_wide_forward(const void* q, const void* kv, const void* qp, const void* kvp,
                                 const void* r9, const void* t, const void* bias, const void* pz,
                                 const void* maskb, const void* sw, void* P, void* S, void* ac,
                                 void* o, void* o_ptl, void* o_norm, void* o_pair,
                                 const long long* strides, int B, int L, int C, int cz4, float eps,
                                 void* stream) {
  using namespace ipaw;
  const int bad = check_shape(B, L, C, cz4);
  if (bad) return bad < 0 ? 0 : bad;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args a{};
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
  for (int k = 0; k < 5; ++k) a.lay.qp[k] = strides[k], a.lay.kvp[k] = strides[5 + k];
  for (int k = 0; k < 4; ++k) a.lay.bias[k] = strides[10 + k], a.lay.pz[k] = strides[14 + k];
  a.P = static_cast<float*>(P);
  a.S = static_cast<float*>(S);
  a.ac = static_cast<bf16*>(ac);
  a.o_ptl = static_cast<float*>(o_ptl);
  a.o_norm = static_cast<float*>(o_norm);
  a.o_pair = static_cast<float*>(o_pair);
  a.B = B;
  a.L = L;
  a.Lp = (L + 7) / 8 * 8;
  a.C = C;
  a.cz4 = cz4;
  a.eps = eps;
  static bool pair_done[MAX_DEVICES];
  WIDE_TRY(opt_in(ipaw_pair_kernel<false>, pair_smem(0, MAX_L, 128), pair_done));
  ipaw_points_kernel<<<blocks_of((long long)B * H * L), 256, 0, st>>>(a);
  WIDE_TRY(wide::launched());
  WIDE_TRY(logits(a, nullptr, st));
  const dim3 rows(B * H, (L + ROWS - 1) / ROWS);
  ipaw_row_kernel<false><<<rows, ROWS * 32, 0, st>>>(a);
  WIDE_TRY(wide::launched());
  ipaw_pair_kernel<false><<<B * L, PAIR_T, pair_smem(0, L, cz4), st>>>(a);
  WIDE_TRY(wide::launched());
  const int hc = H * C;
  return aggregate(a, a.ac, a.kv + C, 2 * hc, 2 * C, static_cast<float*>(o), hc, C, 1.f, st);
}

// K8 at the same widths: the forward's inputs (the same layouts) and the
// cotangents go (B, L, H C), goptl (B, L, 3 H Pv), gnorm (B, L, H Pv),
// gopair (B, L, H cz4), fp32 contiguous. Scratch: P, S, ac as the forward's
// (ac holds bf16(a) unmoved), G [B H L][Lp] f32, gob (B, L, H C) bf16, gsc
// and gsct [B H][Lp][Lp] bf16, GO [B H L][36] f32, RTq and RTk [B H L][12]
// f32, SWq and SWk [B H L] f32. Outputs: gq, gkv, gqp (B, H, 3, L, Pq), gkvp
// (B, H, 3, L, Pq + Pv), gr9, gt, gbias (B, H, L, L), gpz (B, L, L, cz4), gsw
// (B, H), fp32 contiguous. Returns the first nonzero cudaError_t.
extern "C" int ipa2_wide_backward(
    const void* q, const void* kv, const void* qp, const void* kvp, const void* r9, const void* t,
    const void* bias, const void* pz, const void* maskb, const void* sw, const void* go,
    const void* goptl, const void* gnorm, const void* gopair, void* P, void* S, void* G, void* gob,
    void* ac, void* gsc, void* gsct, void* GO, void* RTq, void* RTk, void* SWq, void* SWk, void* gq,
    void* gkv, void* gqp, void* gkvp, void* gr9, void* gt, void* gbias, void* gpz, void* gsw,
    const long long* strides, int B, int L, int C, int cz4, float eps, void* stream) {
  using namespace ipaw;
  const int bad = check_shape(B, L, C, cz4);
  if (bad) return bad < 0 ? 0 : bad;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args a{};
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
  for (int k = 0; k < 5; ++k) a.lay.qp[k] = strides[k], a.lay.kvp[k] = strides[5 + k];
  for (int k = 0; k < 4; ++k) a.lay.bias[k] = strides[10 + k], a.lay.pz[k] = strides[14 + k];
  a.P = static_cast<float*>(P);
  a.S = static_cast<float*>(S);
  a.G = static_cast<float*>(G);
  a.ac = static_cast<bf16*>(ac);
  a.gsc = static_cast<bf16*>(gsc);
  a.gsct = static_cast<bf16*>(gsct);
  a.GO = static_cast<float*>(GO);
  a.RTq = static_cast<float*>(RTq);
  a.RTk = static_cast<float*>(RTk);
  a.SWq = static_cast<float*>(SWq);
  a.SWk = static_cast<float*>(SWk);
  a.gbias = static_cast<float*>(gbias);
  a.gpz = static_cast<float*>(gpz);
  a.gqp = static_cast<float*>(gqp);
  a.gkvp = static_cast<float*>(gkvp);
  a.gr9 = static_cast<float*>(gr9);
  a.gt = static_cast<float*>(gt);
  a.gsw = static_cast<float*>(gsw);
  a.B = B;
  a.L = L;
  a.Lp = (L + 7) / 8 * 8;
  a.C = C;
  a.cz4 = cz4;
  a.eps = eps;
  static bool pair_done[MAX_DEVICES], col_done[MAX_DEVICES];
  WIDE_TRY(opt_in(ipaw_pair_kernel<true>, pair_smem(1, MAX_L, 128), pair_done));
  WIDE_TRY(opt_in(ipaw_col_kernel, COL_SMEM, col_done));
  const long long hc = (long long)H * C;
  const bf16* gb = static_cast<const bf16*>(gob);
  ipaw_points_kernel<<<blocks_of((long long)B * H * L), 256, 0, st>>>(a);
  WIDE_TRY(wide::launched());
  const long long n4 = (long long)B * L * hc / 4;
  ipaw_bf16_kernel<<<blocks_of(n4), 256, 0, st>>>(static_cast<const float4*>(go),
                                                  static_cast<__nv_bfloat162*>(gob), n4);
  WIDE_TRY(wide::launched());
  WIDE_TRY(logits(a, gb, st));
  const dim3 rows(B * H, (L + ROWS - 1) / ROWS);
  ipaw_row_kernel<true><<<rows, ROWS * 32, 0, st>>>(a);
  WIDE_TRY(wide::launched());
  ipaw_pair_kernel<true><<<B * L, PAIR_T, pair_smem(1, L, cz4), st>>>(a);
  WIDE_TRY(wide::launched());
  ipaw_grad_row_kernel<<<rows, ROWS * 32, 0, st>>>(a);
  WIDE_TRY(wide::launched());
  ipaw_col_kernel<<<dim3(B * H, (L + 31) / 32), COL_W * 32, COL_SMEM, st>>>(a);
  WIDE_TRY(wide::launched());
  const float s1 = (float)(1.0 / sqrt(3.0 * C));
  float* gkvf = static_cast<float*>(gkv);
  WIDE_TRY(aggregate(a, a.gsct, a.kv, (int)(2 * hc), 2 * C, static_cast<float*>(gq), (int)hc, C,
                     s1, st));
  WIDE_TRY(aggregate(a, a.gsc, a.q, (int)hc, C, gkvf, (int)(2 * hc), 2 * C, s1, st));
  WIDE_TRY(aggregate(a, a.ac, gb, (int)hc, C, gkvf + C, (int)(2 * hc), 2 * C, 1.f, st));
  ipaw_finish_kernel<<<blocks_of((long long)B * L * RT + (long long)B * H), 256, 0, st>>>(a);
  return wide::launched();
}

// Kernels launched on the wide paths since the library was loaded.
extern "C" int ipa2_wide_launches() { return wide::g_launches.load(); }
