// Tile pieces shared by the fused IPA interior kernels for Hopper, forward
// (ipa2.cu, K7) and backward (ipa2_bwd.cu, K8): blocks of one warpgroup,
// 64-row tiles of one head's 128 bf16 channels copied by cp.async into
// 128-byte swizzled panels (wgmma.cuh), a residue's local points fetched as
// packed bf16 pairs and moved to the global frame, and the frames R, t (and
// key masks) of 64 rows. The forward's attention core (namespace ipa2::fwd)
// is shared with the v1 attention core (ipa1.cu, K9).

#pragma once

#include "ipa2_common.cuh"
#include "wgmma.cuh"

namespace ipa2 {

using namespace hopper;

constexpr int TQ = 64;                   // query rows of a block, keys of a tile
constexpr int NTH = 128;                 // one warpgroup
constexpr int PANEL = TQ * 128;          // a 64-row panel of 64 bf16 channels
constexpr int TILE_BYTES = 2 * PANEL;    // a 64 x 128 bf16 tile

// p, hidden from the compiler: addresses derived from it inside a key-tile
// loop are computed there, not hoisted out and held in registers for the
// whole loop (which would spill).
template <typename P>
__device__ __forceinline__ P* opaque(P* p) {
  asm volatile("" : "+l"(p));
  return p;
}

// 64 rows of one head's 128 bf16 channels (row r at src + (r0 + r) *
// row_stride) into two swizzled panels at dst, rows >= n zero-filled. A
// warp's copy reads two whole 256-byte rows.
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src, long long row_stride,
                                          int r0, int n, int tid) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int idx = tid + NTH * k, r = idx >> 4, c = idx & 15;
    const bool valid = r < n;
    cp_async16(dst + (c >> 3) * PANEL + sw128_offset(r, c & 7),
               src + (valid ? (long long)(r0 + r) * row_stride : 0) + c * 8, valid);
  }
}

// One residue's local points [p0, p0 + P) of head h, as packed bf16 pairs
// w[c][p / 2] (the lower point in the low half), read through the strides
// st (b, h, coordinate, l, p), as 4-wide vectors when `vec` (unit point
// stride, 8-byte aligned); zero when !valid.
struct RawRow {
  uint32_t w[3][PV / 2];
};

template <int P>
__device__ __forceinline__ void fetch_row(RawRow& r, const bf16* x, const long long* st, int b,
                                          int h, int p0, int l, bool vec, bool valid) {
  // All loads first, with no branch between them (an invalid row reads
  // element 0's planes), so that they are in flight together.
  const bf16* xb = x + (valid ? b * st[0] + h * st[1] + (long long)l * st[3] + p0 * st[4] : 0);
  if (vec) {
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int u = 0; u < P / 4; ++u) {
        const uint2 v = *reinterpret_cast<const uint2*>(xb + c * st[2] + 4 * u);
        r.w[c][2 * u] = v.x;
        r.w[c][2 * u + 1] = v.y;
      }
  } else {
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int u = 0; u < P / 2; ++u) {
        const __nv_bfloat162 v = __halves2bfloat162(xb[c * st[2] + 2 * u * st[4]],
                                                    xb[c * st[2] + (2 * u + 1) * st[4]]);
        r.w[c][u] = *reinterpret_cast<const uint32_t*>(&v);
      }
  }
  if (!valid) {
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int u = 0; u < P / 2; ++u) r.w[c][u] = 0u;
  }
}

// g[c * P + p] = (sum_d R[c][d] x[d][p] + t[c]) * scale, in the JAX kernel's
// order, with the residue's frame at rt (R row-major, then t).
template <int P>
__device__ __forceinline__ void to_global(const RawRow& r, const float* rt, float (&g)[3 * P],
                                          float scale) {
  float x[3][P];
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int u = 0; u < P / 2; ++u) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.w[c][u]));
      x[c][2 * u] = f.x;
      x[c][2 * u + 1] = f.y;
    }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float r0 = rt[3 * c], r1 = rt[3 * c + 1], r2 = rt[3 * c + 2], tc = rt[9 + c];
#pragma unroll
    for (int p = 0; p < P; ++p)
      g[c * P + p] = (r0 * x[0][p] + r1 * x[1][p] + r2 * x[2][p] + tc) * scale;
  }
}

// The frames R (9), t (3) of rows [l0, l0 + n) of batch row b, and with
// `mask` their key masks, loaded by the whole block as contiguous spans
// (coalesced), held in registers while the tile copies start, then
// stored as [row][12] (and the masks into mb).
struct Frames {
  float r[5], t[2], m;
};

__device__ __forceinline__ void fetch_frames(Frames& f, const float* r9, const float* tt,
                                             const float* maskb, long long row0, int n,
                                             int tid) {
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const int idx = tid + NTH * k;
    f.r[k] = idx < 9 * n ? r9[row0 * 9 + idx] : 0.f;
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int idx = tid + NTH * k;
    f.t[k] = idx < 3 * n ? tt[row0 * 3 + idx] : 0.f;
  }
  f.m = maskb && tid < n ? maskb[row0 + tid] : 0.f;
}

__device__ __forceinline__ void store_frames(const Frames& f, float* rt, float* mb, int tid) {
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const int idx = tid + NTH * k;
    if (idx < 9 * TQ) rt[(idx / 9) * 12 + idx % 9] = f.r[k];
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int idx = tid + NTH * k;
    if (idx < 3 * TQ) rt[(idx / 3) * 12 + 9 + idx % 3] = f.t[k];
  }
  if (mb && tid < TQ) mb[tid] = f.m;
}

#ifdef IPA2_STAMPS
// The device's global nanosecond clock (comparable across SMs).
__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#endif

// Eight bf16 values (16 bytes, the lowest first) as fp32.
__device__ __forceinline__ void unpack8(const uint4 w, float (&v)[8]) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u[k]));
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}

// Host side: whether the first n strides are multiples of `by`, and whether
// p is aligned to `bytes` (the conditions of a variant's vector loads).
inline bool divisible(const long long* st, int n, int by) {
  for (int k = 0; k < n; ++k)
    if (st[k] % by) return false;
  return true;
}

inline bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// The attention core of the two forward kernels, K7 (ipa2.cu) and K9
// (ipa1.cu): one block of one warpgroup per (b, h, 64 query rows), keys in
// tiles of 64. The layout of shared memory up to each kernel's own arrays,
// S = Q.K^T on wgmma and its fp32 epilogue, the softmax in registers,
// o += bf16(a).V on wgmma, and the pair ring with the point and pair sums.
// In the accumulator layout a thread holds rows ra = 16 warp + g and rb =
// ra + 8, keys 8j + 2q + 0..1; in the sums it owns row ar = tid / 2 and
// half ah = tid % 2 (value-point columns 18ah.., pair channels 8ah..).
namespace fwd {

constexpr int LDB = TQ + 8;              // bf16 row stride of the bias tile
constexpr int LDA = TQ + 8;              // fp32 row stride of the weights
constexpr int LDK = 28;                  // fp32 row stride of the key points
constexpr int LDV = 40;                  // fp32 row stride of the value points: halves at 0, 20
constexpr int CHUNK = 8;                 // keys of a pair chunk
constexpr int NCHUNK = TQ / CHUNK;
constexpr int SLOT = 8 * NTH * 16;       // one chunk: eight 16-byte items a thread

enum PairMode { PZ_J = 0, PZ_D = 1, PZ_ANY = 2 };

constexpr int OFF_Q = 0;                           // bf16 panels [2][64][128 B]
constexpr int OFF_V = OFF_Q + TILE_BYTES;          // bf16 panels [2][64][128 B]
constexpr int OFF_K = OFF_V + TILE_BYTES;          // bf16 panels [2][64][128 B]
constexpr int OFF_BIAS = OFF_K + TILE_BYTES;       // bf16 [64][LDB]
constexpr int OFF_A = OFF_K;                       // f32 [64][LDA], over K and the bias
constexpr int OFF_KG = OFF_BIAS + TQ * LDB * 2;    // f32 [64][LDK]
constexpr int OFF_VG = OFF_KG + TQ * LDK * 4;      // f32 [64][LDV]; at the end the point sums
constexpr int OFF_KSQ = OFF_VG + TQ * LDV * 4;     // f32 [64]
constexpr int OFF_MB = OFF_KSQ + TQ * 4;           // f32 [64]
constexpr int OFF_OWN = OFF_MB + TQ * 4;           // the kernel's own arrays, then the pair ring
static_assert(TQ * LDA * 4 <= OFF_KG - OFF_A, "the weights fit over K and the bias tile");
static_assert(OFF_V % 1024 == 0 && OFF_K % 1024 == 0, "swizzled panels on 1024-byte boundaries");

// One row's running max and sum of exp (m, l) updated with its 16 logits
// in this thread (accumulator entries 4j + 2 half + 0..1) and the other
// three of its quad.
__device__ __forceinline__ void row_update(const float (&s)[32], int half, float& m, float& l) {
  float tm = -INFINITY;
#pragma unroll
  for (int j = 0; j < 8; ++j) tm = fmaxf(tm, fmaxf(s[4 * j + 2 * half], s[4 * j + 2 * half + 1]));
  tm = fmaxf(tm, __shfl_xor_sync(FULL, tm, 1));
  tm = fmaxf(tm, __shfl_xor_sync(FULL, tm, 2));
  const float mn = fmaxf(m, tm);
  float sum = 0.f;
  if (mn != -INFINITY) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      sum += expf(s[4 * j + 2 * half] - mn) + expf(s[4 * j + 2 * half + 1] - mn);
  }
  sum += __shfl_xor_sync(FULL, sum, 1);
  sum += __shfl_xor_sync(FULL, sum, 2);
  l = (m == -INFINITY ? 0.f : l * expf(m - mn)) + sum;
  m = mn;
}

// Key row r's global points into kg_s ([64][LDK]) with their squared norm (ksq_s).
__device__ __forceinline__ void store_key_points(float* kg_s, float* ksq_s, int r,
                                                 const float* kg) {
  float sq = 0.f;
#pragma unroll
  for (int x = 0; x < P3Q; ++x) sq = fmaf(kg[x], kg[x], sq);
  float4* dst = reinterpret_cast<float4*>(kg_s + r * LDK);
#pragma unroll
  for (int u = 0; u < P3Q / 4; ++u)
    dst[u] = make_float4(kg[4 * u], kg[4 * u + 1], kg[4 * u + 2], kg[4 * u + 3]);
  ksq_s[r] = sq;
}

// Key row r's global value points into vg_s ([64][LDV]): columns 0..17 at
// 0, 18..35 at 20 (each half 16-byte aligned for consume's vector reads).
__device__ __forceinline__ void store_value_points(float* vg_s, int r, const float* vg) {
  float2* dst = reinterpret_cast<float2*>(vg_s + r * LDV);
#pragma unroll
  for (int u = 0; u < 9; ++u) {
    dst[u] = make_float2(vg[2 * u], vg[2 * u + 1]);
    dst[10 + u] = make_float2(vg[18 + 2 * u], vg[19 + 2 * u]);
  }
}

// S = Q.K^T of the query tile's panels at q_s and the key tile's at k_s
// (m64n64k16 x 8, both operands K-major), waited for.
__device__ __forceinline__ void qk_product(float (&s)[32], uint32_t q_s, uint32_t k_s) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < C / 16; ++kk)
    mma_ss_n64(s, desc_sw128(q_s + (kk >> 2) * PANEL + (kk & 3) * 32),
               desc_sw128(k_s + (kk >> 2) * PANEL + (kk & 3) * 32), kk > 0);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(s);
}

// The logits of key tile j0 from S in the accumulator layout: entry 4j + e
// (e < 2) is row ra, key 8j + 2q + e; 4j + 2 + e row rb. Adds the point
// term (the rows' global query points qga, qgb and their squared norms
// against the key points at kg_s, ksq_s), the bias (with BIAS_ROWS from the
// tile at bias_s, else read at bias_a, bias_b with key stride sb), the mask
// and the scales, in fp32; keys past the ragged edge nk get -inf.
template <bool BIAS_ROWS>
__device__ __forceinline__ void logit_terms(float (&s)[32], int j0, int nk, int q, int ra, int rb,
                                            const bf16* bias_s, const bf16* bias_a,
                                            const bf16* bias_b, long long sb, const float* kg_s,
                                            const float* ksq_s, const float* mb_s,
                                            const float (&qga)[P3Q], const float (&qgb)[P3Q],
                                            float qsqa, float qsqb, float s1, float s2) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c0 = 8 * j + 2 * q;
    float2 ba = make_float2(0.f, 0.f), bb = make_float2(0.f, 0.f);
    if (BIAS_ROWS) {
      ba = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias_s + ra * LDB + c0));
      bb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias_s + rb * LDB + c0));
    } else {
      if (c0 < nk) {
        ba.x = bf2f(bias_a[(long long)(j0 + c0) * sb]);
        bb.x = bf2f(bias_b[(long long)(j0 + c0) * sb]);
      }
      if (c0 + 1 < nk) {
        ba.y = bf2f(bias_a[(long long)(j0 + c0 + 1) * sb]);
        bb.y = bf2f(bias_b[(long long)(j0 + c0 + 1) * sb]);
      }
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = c0 + e;
      if (c < nk) {
        const float4* kr = reinterpret_cast<const float4*>(kg_s + c * LDK);
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
        s[4 * j + e] = s[4 * j + e] * s1 + (e ? ba.y : ba.x) * s2 -
                       0.5f * (qsqa + ksq - 2.f * pa) + mb;
        s[4 * j + 2 + e] = s[4 * j + 2 + e] * s1 + (e ? bb.y : bb.x) * s2 -
                           0.5f * (qsqb + ksq - 2.f * pb) + mb;
      } else {
        s[4 * j + e] = -INFINITY;
        s[4 * j + 2 + e] = -INFINITY;
      }
    }
  }
}

// The weights of a row that one key tile holds whole (L <= 64): rows ra,
// rb's max (ma, mb) and sum of exp (la, lb) from the tile, a quad's four
// threads by shuffles, then s = exp(s - m) / l, 0 where the row is empty.
__device__ __forceinline__ void softmax_tile(float (&s)[32], float& ma, float& la, float& mb,
                                             float& lb) {
  ma = mb = -INFINITY;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    ma = fmaxf(ma, fmaxf(s[4 * j], s[4 * j + 1]));
    mb = fmaxf(mb, fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  ma = fmaxf(ma, __shfl_xor_sync(FULL, ma, 1));
  ma = fmaxf(ma, __shfl_xor_sync(FULL, ma, 2));
  mb = fmaxf(mb, __shfl_xor_sync(FULL, mb, 1));
  mb = fmaxf(mb, __shfl_xor_sync(FULL, mb, 2));
  la = lb = 0.f;
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

// The weights of one of several key tiles: s = exp(s - m) / l with the
// rows' max and sum over all keys (pass 1's row_update).
__device__ __forceinline__ void softmax_from(float (&s)[32], float ma, float la, float mb,
                                             float lb) {
  const float inva = la > 0.f ? 1.f / la : 0.f, invb = lb > 0.f ? 1.f / lb : 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[4 * j + e] = ma == -INFINITY ? 0.f : expf(s[4 * j + e] - ma) * inva;
      s[4 * j + 2 + e] = mb == -INFINITY ? 0.f : expf(s[4 * j + 2 + e] - mb) * invb;
    }
  }
}

// o += bf16(a).V, issued and committed (av_wait waits): m64n64k16 x 4 for
// each half of C, the packed bf16 pairs ha[k] = (s[2k], s[2k + 1]) of the
// weights' accumulator blocks 2st, 2st + 1 as the A fragment of depth step
// st, and V at v_s (rows j with channels contiguous) as the MN-major B
// operand read with the transpose-B immediate. Without `acc` the product
// overwrites o0 (channels 0..63) and o1 (64..127).
__device__ __forceinline__ void av_issue(float (&o0)[32], float (&o1)[32], uint32_t (&ha)[16],
                                         const float (&s)[32], uint32_t v_s, bool acc) {
#pragma unroll
  for (int k = 0; k < 16; ++k) ha[k] = pack_bf16(s[2 * k], s[2 * k + 1]);
  wgmma_fence();
#pragma unroll
  for (int st = 0; st < TQ / 16; ++st)
    mma_rs_n64<1>(o0, &ha[4 * st], desc_sw128(v_s + st * 2048), st > 0 || acc);
#pragma unroll
  for (int st = 0; st < TQ / 16; ++st)
    mma_rs_n64<1>(o1, &ha[4 * st], desc_sw128(v_s + PANEL + st * 2048), st > 0 || acc);
  wgmma_commit();
}

__device__ __forceinline__ void av_wait(float (&o0)[32], float (&o1)[32], uint32_t (&ha)[16]) {
  wgmma_wait_all();
  fence_regs(o0);
  fence_regs(o1);
  fence_regs(ha);
}

// The fp32 weights of rows ra, rb into a_s ([64][LDA]) for the point and pair sums.
__device__ __forceinline__ void store_weights(float* a_s, const float (&s)[32], int q, int ra,
                                              int rb) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 8 * j + 2 * q;
    *reinterpret_cast<float2*>(a_s + ra * LDA + c) = make_float2(s[4 * j], s[4 * j + 1]);
    *reinterpret_cast<float2*>(a_s + rb * LDA + c) = make_float2(s[4 * j + 2], s[4 * j + 3]);
  }
}

// o of rows ra, rb (o0 channels 0..63, o1 64..127, accumulator layout) to
// the output rows at o_rows + i * stride, i = i0 + row (rows >= L not
// written): lanes q, q ^ 1 trade a pair so that each stores four contiguous
// channels of one row (even q row ra, odd q row rb).
__device__ __forceinline__ void store_o(const float (&o0)[32], const float (&o1)[32],
                                        float* o_rows, long long stride, int i0, int L, int q,
                                        int ra, int rb) {
  const bool odd = q & 1;
  const int i = i0 + (odd ? rb : ra);
  float* orow = o_rows + (long long)(i < L ? i : 0) * stride + 2 * (q & 2);
  auto put = [&](const float (&o)[32], float* dst) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float y0 = __shfl_xor_sync(FULL, odd ? o[4 * j] : o[4 * j + 2], 1);
      const float y1 = __shfl_xor_sync(FULL, odd ? o[4 * j + 1] : o[4 * j + 3], 1);
      const float4 v = odd ? make_float4(y0, y1, o[4 * j + 2], o[4 * j + 3])
                           : make_float4(o[4 * j], o[4 * j + 1], y0, y1);
      if (i < L) *reinterpret_cast<float4*>(dst + 8 * j) = v;
    }
  };
  put(o0, orow);
  put(o1, orow + 64);
}

// The partial o of rows ra, rb back from the output rows (as store_o
// places them; rows past the edge nq read row i0), in the accumulator layout.
__device__ __forceinline__ void load_o(float (&o0)[32], float (&o1)[32], const float* o_rows,
                                       long long stride, int i0, int nq, int q, int ra, int rb) {
  const float* pa = o_rows + (long long)(i0 + (ra < nq ? ra : 0)) * stride + 2 * q;
  const float* pb = o_rows + (long long)(i0 + (rb < nq ? rb : 0)) * stride + 2 * q;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 x0 = *reinterpret_cast<const float2*>(pa + 8 * j);
    const float2 x1 = *reinterpret_cast<const float2*>(pb + 8 * j);
    const float2 y0 = *reinterpret_cast<const float2*>(pa + 64 + 8 * j);
    const float2 y1 = *reinterpret_cast<const float2*>(pb + 64 + 8 * j);
    o0[4 * j] = x0.x, o0[4 * j + 1] = x0.y, o0[4 * j + 2] = x1.x, o0[4 * j + 3] = x1.y;
    o1[4 * j] = y0.x, o1[4 * j + 1] = y0.y, o1[4 * j + 2] = y1.x, o1[4 * j + 3] = y1.y;
  }
}

// The pair ring's slots (byte offsets): two of their own at off_pz, then,
// once the tile's products have read them, Q's panels (`single`, L <= 64
// only: the query tile stays for later key tiles otherwise) and V's.
__device__ __forceinline__ int slot_at(int k, bool single, int off_pz) {
  return k < 2 ? off_pz + k * SLOT : (k == 2 && single ? OFF_Q : OFF_V);
}

// The pair chunk kc of key tile j0 into the slot at byte `off` of the
// shared memory at `base`, copied by the thread that reads it: its eight
// 16-byte items (PZ_J: keys 8kc..8kc+7 of channel plane 8ah + u; PZ_D:
// channels 8ah..8ah+7 of key 8kc + u) of row ar, at pz_row with pz's
// strides stz. Keys past nk and rows past nq are zero-filled (their copies
// read pz); a chunk wholly past nk is not copied; PZ_ANY copies nothing.
template <int PZ>
__device__ __forceinline__ void copy_pair(uint32_t base, int kc, int off, int j0, int nk, int nq,
                                          int tid, int ar, int ah, const bf16* pz_row,
                                          const long long* stz, const bf16* pz) {
  if (PZ == PZ_ANY || CHUNK * kc >= nk) return;
  const uint32_t dst = base + off + tid * 16;
  const int jc = j0 + CHUNK * kc;
  const bf16* zrow = opaque(pz_row);
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    bool valid = ar < nq;
    const bf16* src;
    if (PZ == PZ_J) {
      src = zrow + jc + (long long)(8 * ah + u) * stz[3];
    } else {
      valid = valid && CHUNK * kc + u < nk;
      src = zrow + (long long)(jc + u) * stz[2] + 8 * ah;
    }
    cp_async16(dst + u * NTH * 16, valid ? src : pz, valid);
  }
}

// Row ar's weights of chunk kc (a_s) against the value points (vg_s,
// columns 18ah .. 18ah + 17) and the pair channels 8ah .. 8ah + 7, from the
// slot at byte `off` of `smem` (PZ_ANY: read at pz_row through stz).
template <int PZ>
__device__ __forceinline__ void consume(const unsigned char* smem, int kc, int off, int j0, int nk,
                                        int nq, int tid, int ar, int ah, const float* a_s,
                                        const float* vg_s, const bf16* pz_row,
                                        const long long* stz, float (&pacc)[18],
                                        float (&zacc)[8]) {
  const uint4* zs = reinterpret_cast<const uint4*>(smem + off) + tid;
  const float4 a0 = *reinterpret_cast<const float4*>(a_s + ar * LDA + CHUNK * kc);
  const float4 a1 = *reinterpret_cast<const float4*>(a_s + ar * LDA + CHUNK * kc + 4);
  const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const float* vr = vg_s + (CHUNK * kc + u) * LDV + 20 * ah;
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const float4 v = reinterpret_cast<const float4*>(vr)[x];
      pacc[4 * x] = fmaf(av[u], v.x, pacc[4 * x]);
      pacc[4 * x + 1] = fmaf(av[u], v.y, pacc[4 * x + 1]);
      pacc[4 * x + 2] = fmaf(av[u], v.z, pacc[4 * x + 2]);
      pacc[4 * x + 3] = fmaf(av[u], v.w, pacc[4 * x + 3]);
    }
    const float2 v = reinterpret_cast<const float2*>(vr)[8];
    pacc[16] = fmaf(av[u], v.x, pacc[16]);
    pacc[17] = fmaf(av[u], v.y, pacc[17]);
  }
  if (PZ == PZ_J) {
#pragma unroll
    for (int d = 0; d < 8; ++d) {
      float z[8];
      unpack8(zs[d * NTH], z);
#pragma unroll
      for (int u = 0; u < 8; ++u) zacc[d] = fmaf(av[u], z[u], zacc[d]);
    }
  } else if (PZ == PZ_D) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      float z[8];
      unpack8(zs[u * NTH], z);
#pragma unroll
      for (int d = 0; d < 8; ++d) zacc[d] = fmaf(av[u], z[d], zacc[d]);
    }
  } else if (ar < nq) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int j = CHUNK * kc + u;
      if (j < nk) {
        const bf16* zr = pz_row + (long long)(j0 + j) * stz[2] + (long long)(8 * ah) * stz[3];
#pragma unroll
        for (int d = 0; d < 8; ++d) zacc[d] = fmaf(av[u], bf2f(zr[d * stz[3]]), zacc[d]);
      }
    }
  }
}

// The aggregation of one key tile over its pair chunks: the ring holds
// nslot slots (4 for L <= 64, `single`; else 3), the first nslot - 1
// chunks already sent (each its own cp.async group); chunk kc is summed
// once it has landed, and its slot takes chunk kc + nslot.
template <int PZ>
__device__ __forceinline__ void pair_sums(uint32_t base, const unsigned char* smem, int off_pz,
                                          bool single, int j0, int nk, int nq, int tid, int ar,
                                          int ah, const float* a_s, const float* vg_s,
                                          const bf16* pz_row, const long long* stz,
                                          const bf16* pz, float (&pacc)[18], float (&zacc)[8]) {
  const int nslot = single ? 4 : 3;
  for (int kc = 0; kc < NCHUNK; ++kc) {
    // Chunk kc has landed; the nslot - 1 chunks after it may still fly.
    if (single) cp_async_wait_group<3>(); else cp_async_wait_group<2>();
    const int off = slot_at(kc % nslot, single, off_pz);
    if (CHUNK * kc < nk)
      consume<PZ>(smem, kc, off, j0, nk, nq, tid, ar, ah, a_s, vg_s, pz_row, stz, pacc, zacc);
    if (kc + nslot < NCHUNK)
      copy_pair<PZ>(base, kc + nslot, off, j0, nk, nq, tid, ar, ah, pz_row, stz, pz);
    cp_async_commit();
  }
}

}  // namespace fwd

}  // namespace ipa2
