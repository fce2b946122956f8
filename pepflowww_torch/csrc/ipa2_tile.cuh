// Tile pieces shared by the fused IPA interior kernels for Hopper, forward
// (ipa2.cu, K7) and backward (ipa2_bwd.cu, K8): blocks of one warpgroup,
// 64-row tiles of one head's 128 bf16 channels copied by cp.async into
// 128-byte swizzled panels (wgmma.cuh), a residue's local points fetched as
// packed bf16 pairs and moved to the global frame, and the frames R, t (and
// key masks) of 64 rows.

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

}  // namespace ipa2
