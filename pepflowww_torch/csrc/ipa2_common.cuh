// Shared pieces of the fused IPA interior kernels: the widths and the input
// layout (ipa2.cu, ipa2_bwd.cu), and the tile shapes, tile loaders and the
// logits of one query tile against one key tile of the backward's
// four-kernel path for L > 64 (ipa2_bwd.cu). That path computes in fp32 on
// the CUDA cores from bf16 inputs: a product of two bf16 values is exact in
// fp32, so each dot product is the bf16-operand, fp32-accumulate product
// the JAX kernel asks for, summed in another order. The Hopper pieces of
// the forward and of the backward's L <= 64 path (64-row swizzled tiles,
// point fetches, frames) are in ipa2_tile.cuh.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace ipa2 {

typedef __nv_bfloat16 bf16;

constexpr int C = 128;          // scalar channels per head
constexpr int PQ = 8;           // query / key points per head
constexpr int PV = 12;          // value points per head
constexpr int CZ4 = 16;         // pair readout channels
constexpr int P3Q = 3 * PQ;
constexpr int P3V = 3 * PV;
constexpr int T = 32;           // query rows and key rows per tile
constexpr int NT = 256;         // threads per block (8 warps)
constexpr int LDH = C + 2;      // bf16 row stride of q/k/v/go tiles: 65 words, columns conflict-free
constexpr int LDG = P3Q + 1;    // fp32 row stride of q/k point tiles
constexpr int LDV = P3V + 1;    // fp32 row stride of value-point tiles
constexpr int LDP = T + 1;      // fp32 row stride of (query, key) tiles
constexpr int LDZ = T * CZ4 + 8;  // bf16 row stride of the pair tile [i][j][d]
constexpr unsigned FULL = 0xffffffffu;

// Element strides of the inputs that may arrive as permuted views:
// qp, kvp (b, h, coordinate, l, p), bias (b, h, i, j), pz (b, i, j, d).
struct Layout {
  long long qp[5], kvp[5], bias[4], pz[4];
};

__device__ __forceinline__ float bf2f(bf16 x) { return __bfloat162float(x); }
// x rounded to bf16 (nearest even), as jnp's astype(bfloat16) rounds.
__device__ __forceinline__ float bfr(float x) { return __bfloat162float(__float2bfloat16(x)); }

// Rows [r0, r0 + n) of one head's 128 bf16 channels (`src` points at row 0,
// channel 0 of the head; rows `row_stride` elements apart, 16-byte aligned)
// into a [T][LDH] tile; rows >= n are zero.
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, long long row_stride,
                                          int r0, int n, int tid) {
  for (int idx = tid; idx < T * (C / 8); idx += NT) {
    const int r = idx / (C / 8), v = idx % (C / 8);
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < n) val = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * row_stride + v * 8);
    uint32_t* d = reinterpret_cast<uint32_t*>(dst + r * LDH + v * 8);
    d[0] = val.x;
    d[1] = val.y;
    d[2] = val.z;
    d[3] = val.w;
  }
}

// The same for fp32 rows (the cotangent go), rounded to bf16 on the way:
// the JAX kernel rounds go to v's dtype before its products with v.
__device__ __forceinline__ void load_rows_round(bf16* dst, const float* src, long long row_stride,
                                                int r0, int n, int tid) {
  for (int idx = tid; idx < T * (C / 4); idx += NT) {
    const int r = idx / (C / 4), v = idx % (C / 4);
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n) val = *reinterpret_cast<const float4*>(src + (long long)(r0 + r) * row_stride + v * 4);
    __nv_bfloat162* d = reinterpret_cast<__nv_bfloat162*>(dst + r * LDH + v * 4);
    d[0] = __floats2bfloat162_rn(val.x, val.y);
    d[1] = __floats2bfloat162_rn(val.z, val.w);
  }
}

// Global points of rows [r0, r0 + n), points [p0, p0 + P) of head h:
// dst[r][c * P + p] = (sum_d R[c][d] x[d][p] + t[c]) * scale, with x read
// through the strides `st` (b, h, coordinate, l, p). Rows >= n are zero.
template <int P>
__device__ __forceinline__ void load_points(float* dst, int ld, const bf16* x, const long long* st,
                                            int b, int h, int p0, const float* r9, const float* tt,
                                            int L, int r0, int n, float scale, int tid) {
  for (int idx = tid; idx < T * P; idx += NT) {
    const int r = idx / P, p = idx % P;
    float g0 = 0.f, g1 = 0.f, g2 = 0.f;
    if (r < n) {
      const int l = r0 + r;
      const bf16* xb = x + b * st[0] + h * st[1] + l * st[3] + (p0 + p) * st[4];
      const float x0 = bf2f(xb[0]), x1 = bf2f(xb[st[2]]), x2 = bf2f(xb[2 * st[2]]);
      const float* R = r9 + ((long long)b * L + l) * 9;
      const float* t3 = tt + ((long long)b * L + l) * 3;
      g0 = (R[0] * x0 + R[1] * x1 + R[2] * x2 + t3[0]) * scale;
      g1 = (R[3] * x0 + R[4] * x1 + R[5] * x2 + t3[1]) * scale;
      g2 = (R[6] * x0 + R[7] * x1 + R[8] * x2 + t3[2]) * scale;
    }
    dst[r * ld + p] = g0;
    dst[r * ld + P + p] = g1;
    dst[r * ld + 2 * P + p] = g2;
  }
}

// Squared norms of the rows of a [T][LDG] point tile (threads < T).
__device__ __forceinline__ void row_sq(float* sq, const float* g, int tid) {
  if (tid < T) {
    float s = 0.f;
    for (int x = 0; x < P3Q; ++x) s = fmaf(g[tid * LDG + x], g[tid * LDG + x], s);
    sq[tid] = s;
  }
}

// The pair tile pz[b, i0 + r, j0 + j, :] into [T][LDZ] (zero outside
// nq x nk), iterating along whichever of d or j has unit stride.
__device__ __forceinline__ void load_pair(bf16* dst, const bf16* pz, const long long* st, int b,
                                          int i0, int nq, int j0, int nk, int tid) {
  const bf16* zb = pz + b * st[0];
  const bool d_fast = st[3] == 1;
  for (int idx = tid; idx < T * T * CZ4; idx += NT) {
    const int r = idx / (T * CZ4), rem = idx % (T * CZ4);
    const int j = d_fast ? rem / CZ4 : rem % T;
    const int d = d_fast ? rem % CZ4 : rem / T;
    bf16 v = __float2bfloat16(0.f);
    if (r < nq && j < nk) v = zb[(i0 + r) * st[1] + (j0 + j) * st[2] + d * st[3]];
    dst[r * LDZ + j * CZ4 + d] = v;
  }
}

// Logits of query row ty against key columns tx + 8u (u < 4) of the current
// tiles: q.k * s1 + bias * s2 - (|qg|^2 + |kg|^2 - 2 qg.kg) / 2 + maskb;
// -inf for columns past the ragged edge nk.
__device__ __forceinline__ void tile_logits(float (&s)[4], const bf16* q_s, const float* qg_s,
                                            const float* qsq_s, const bf16* k_s, const float* kg_s,
                                            const float* ksq_s, const float* mb_s,
                                            const bf16* bias_row, long long bias_js, int nk,
                                            int ty, int tx, float s1, float s2) {
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  const __nv_bfloat162* qr = reinterpret_cast<const __nv_bfloat162*>(q_s + ty * LDH);
#pragma unroll 4
  for (int c2 = 0; c2 < C / 2; ++c2) {
    const float2 qv = __bfloat1622float2(qr[c2]);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float2 kv = __bfloat1622float2(
          reinterpret_cast<const __nv_bfloat162*>(k_s + (tx + 8 * u) * LDH)[c2]);
      acc[u] = fmaf(qv.x, kv.x, acc[u]);
      acc[u] = fmaf(qv.y, kv.y, acc[u]);
    }
  }
  float pt[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
  for (int x = 0; x < P3Q; ++x) {
    const float qx = qg_s[ty * LDG + x];
#pragma unroll
    for (int u = 0; u < 4; ++u) pt[u] = fmaf(qx, kg_s[(tx + 8 * u) * LDG + x], pt[u]);
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int j = tx + 8 * u;
    s[u] = -INFINITY;
    if (j < nk) {
      const float bias = bf2f(bias_row[j * bias_js]);
      s[u] = acc[u] * s1 + bias * s2 - 0.5f * (qsq_s[ty] + ksq_s[j] - 2.f * pt[u]) + mb_s[j];
    }
  }
}

// Row max and sum of exp over a row's logits, held by its 8 lanes
// (tx = lane & 7) as running (m, l) pairs: combined by a butterfly, which
// leaves every lane with the same values.
__device__ __forceinline__ void combine_stats(float& m, float& l) {
#pragma unroll
  for (int off = 1; off < 8; off <<= 1) {
    const float m2 = __shfl_xor_sync(FULL, m, off), l2 = __shfl_xor_sync(FULL, l, off);
    const float mn = fmaxf(m, m2);
    const float a = m == -INFINITY ? 0.f : l * expf(m - mn);
    const float c = m2 == -INFINITY ? 0.f : l2 * expf(m2 - mn);
    l = a + c;
    m = mn;
  }
}

__device__ __forceinline__ void online(float& m, float& l, float s) {
  if (s == -INFINITY) return;
  const float mn = fmaxf(m, s);
  l = (m == -INFINITY ? 0.f : l * expf(m - mn)) + expf(s - mn);
  m = mn;
}

// Sum of v over the 8 lanes of a row group (butterfly: same value on each).
__device__ __forceinline__ float sum8(float v) {
#pragma unroll
  for (int off = 1; off < 8; off <<= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// Block-wide sum in a fixed order: warp butterflies, then thread 0 adds
// the 8 warp sums in order. `red` holds 8 floats. Returns the sum on thread 0.
__device__ __forceinline__ float block_sum(float v, float* red, int tid) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  __syncthreads();
  if ((tid & 31) == 0) red[tid >> 5] = v;
  __syncthreads();
  float s = 0.f;
  if (tid == 0)
    for (int w = 0; w < NT / 32; ++w) s += red[w];
  return s;
}

}  // namespace ipa2
