// The EdgeTransition forward's tile loop for Hopper, sm_90a, shared by the
// bf16 kernel (edge_transition.cu: K1 without, K2 with the readout) and the
// int8 kernel (edge_transition_int8.cu: K6, both variants). The two differ
// only in the hidden layers (step 3 below); everything else is this code.
//
// Per pair (i, j) of a batch row, with the concat row x = [e | n_i | n_j]
// (e = edge[b,i,j,:], n = node_bias[b,:,:], 192 bf16), h1 = relu(x.W1 + b1)
// (192 wide), then the hidden layers give o (64 wide, x.W3 + b3 included),
// out = (LayerNorm(o) * scale + bias) * mask_i * mask_j -> bf16, and, with
// READOUT, from bf16(out) while it is still on chip:
//   b[b,h,i,j]  = out.kb  + bb   (h < n_b)
//   pz[b,d,i,j] = out.kdz + bdz  (d < n_pz)
// Products of bf16 operands accumulate in fp32; the LayerNorm statistics are
// fp32 (eps passed in, 1e-5). The first layer and the residual projection
// run on the concatenated row: the same bf16 x bf16 terms as the JAX
// kernel's factorized form (e.W1e + n_i.W1i + n_j.W1j), summed in fp32 in
// another order, with no node pre-pass and no scratch: one launch a call.
//
// Design: a persistent grid of one block per SM (at most), two consumer
// warpgroups per block, each walking its own 64-pair tiles of the flattened
// (b, i, j) rows, so any L runs and a tile may cross batch rows; the ragged
// last tile is zero-filled and its stores masked. All weights live in
// shared memory for the block's life, transposed to [out][in] (K-major) in
// the 128-byte swizzled layout the wgmma descriptors name (wgmma.cuh). Per
// tile, a warpgroup:
//   1. gathers C = [e | n_i | n_j] (64 x 192 bf16) itself with cp.async
//      16-byte copies into the swizzled layout, a warp's copy reading four
//      whole 128-byte rows; each row's (b*L+i, b*L+j) is computed once a
//      part, by the eight threads that copy it;
//   2. runs C.W1 (m64n192k16 x 12) and C.W3 (m64n64k16 x 12) from shared
//      memory, loading the pair masks of its rows meanwhile. C is then
//      free, and the NEXT tile's gather is issued into it: it lands while
//      this tile's remaining products run (each warpgroup's buffer is the
//      other's second stage);
//   3. the hidden layers, from registers (hidden_bf16 / hidden_int8 below),
//      leaving o = C.W3 + (h2's product) in the m64n64 accumulator;
//   4. adds b3 and takes the LayerNorm of each row across the four threads
//      that hold it (quad shuffles), applies scale, bias and the pair mask,
//      rounds to bf16 and stores out;
//   5. with READOUT, bf16(out) is again the A operand from registers of
//      out.[kb | kdz | 0] (m64n32k16 x 4); the readouts pass through each
//      warp's channel-major staging buffer, 16 channels at a time, so each
//      channel's 16 pairs of a warp leave as one whole 32-byte sector along
//      the contiguous (i, j), with no barrier beyond the warp.
// No accumulator passes through shared memory; h1, h2 and out never do.
// Pair rows are 32-bit: the launcher refuses B*L*L > INT_MAX.

#pragma once

#include <climits>

#include "wgmma.cuh"

namespace edge {

using namespace hopper;
typedef __nv_bfloat16 bf16;

constexpr int CZ = 64;     // pair channels in and out
constexpr int HID = 192;   // hidden width = CZ + 2 * 64 (the concat row)
constexpr int RO = 32;     // readout lanes (n_b + n_pz <= 32), zero-padded
constexpr int TM = 64;     // pair rows per tile: one warpgroup product

constexpr int N_WG = 2;                              // consumer warpgroups a block
constexpr int NTHREADS = 128 * N_WG;
constexpr int TILE_C = TM * HID * 2;                 // one C tile: 3 panels of 64 rows
constexpr int PANEL_C = TM * 128;
constexpr int RO_CH = 16;                            // readout channels staged at a time
constexpr int RO_WARP = RO_CH * 16;                  // a warp's staging: [16 ch][16 rows] bf16

// Shared memory of a block (bytes). Both kernels: W1^T bf16 [3][192][128 B],
// W3^T bf16 [3][64][128 B], the readout's Wr^T [1][32][128 B], two C tiles
// [2][3][64][128 B], the readout staging [8 warps][RO_WARP] bf16 and the
// fp32 vectors b1 b2 b3 ln_s ln_b bro. The bf16 kernel adds W2^T bf16
// [3][192][128 B]; the int8 kernel W2q^T and W3q^T int8, 192 bytes a row in
// two panels ([2][192][128 B], [2][64][128 B]: the second panel's rows hold
// 64 bytes each, spread by the swizzle over all 128), and the column scales
// w2s, w3s. bf16: 231,808 bytes; int8: 224,640; a block may use 232,448.
template <bool INT8>
struct Smem {
  static constexpr int W1 = 0;
  static constexpr int W3 = W1 + HID * HID * 2;
  static constexpr int W2 = W3 + CZ * HID * 2;
  static constexpr int W3Q = W2 + (INT8 ? 2 * HID * 128 : HID * HID * 2);
  static constexpr int WR = W3Q + (INT8 ? 2 * CZ * 128 : 0);
  static constexpr int C = WR + RO * CZ * 2;
  static constexpr int STAGE = C + N_WG * TILE_C;
  static constexpr int V = STAGE + N_WG * 4 * RO_WARP * 2;
  static constexpr int N_VEC = 2 * HID + 3 * CZ + RO + (INT8 ? HID + CZ : 0);
  static constexpr int BYTES = V + N_VEC * 4;
  static_assert(W3 % 1024 == 0 && W2 % 1024 == 0 && W3Q % 1024 == 0 && WR % 1024 == 0 &&
                    C % 1024 == 0 && TILE_C % 1024 == 0,
                "swizzled panels start on 1024-byte boundaries");
  static_assert(BYTES <= 232448, "more shared memory than a block may use");
};

// What a kernel reads and writes. w2t is W2^T bf16 for the bf16 kernel and
// W2q^T int8 for the int8 kernel; w2s, w3qt and w3s are the int8 kernel's
// only (null otherwise); wrt, bro, b_out and pz_out are null without the
// readout.
struct Args {
  const bf16* edge;
  const bf16* node;
  const float* mask;
  const bf16* w1t;
  const float* b1;
  const void* w2t;
  const float* w2s;
  const float* b2;
  const bf16* w3t;
  const int8_t* w3qt;
  const float* w3s;
  const float* b3;
  const float* ln_s;
  const float* ln_b;
  const bf16* wrt;
  const float* bro;
  bf16* out;
  bf16* b_out;
  bf16* pz_out;
  int L, total, n_b, n_pz;
  float eps;
};

// N rows of `row_bytes` bytes, K-major in global, into swizzled panels at
// `dst` (panel p holds bytes 128p..128p+127 of every row).
__device__ __forceinline__ void stage_kmajor(uint32_t dst, const void* __restrict__ src, int N,
                                             int row_bytes) {
  const int chunks = row_bytes / 16;
  const char* s = static_cast<const char*>(src);
  for (int v = threadIdx.x; v < N * chunks; v += NTHREADS) {
    const int n = v / chunks, c = v % chunks;
    cp_async16(dst + (c >> 3) * (N * 128) + sw128_offset(n, c & 7),
               s + (size_t)n * row_bytes + c * 16, true);
  }
}

// The tile's concat rows C = [e | n_i | n_j] into the swizzled panels at
// `dst`. Thread wt (0..127 of the warpgroup) copies 16-byte chunk wt % 8 of
// rows wt / 8 + 16k (k = 0..3) of each of the three parts, so each copy of a
// warp reads four whole 128-byte rows. Rows past `total` are zero-filled.
__device__ __forceinline__ void gather(uint32_t dst, const bf16* __restrict__ edge,
                                       const bf16* __restrict__ node, int row0, int total, int L,
                                       int LL, int wt) {
  const int c = wt & 7;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int r = (wt >> 3) + 16 * k, row = row0 + r;
    const bool valid = row < total;
    int bi = 0, bj = 0;
    if (valid) {
      const int b = row / LL, rem = row - b * LL, i = rem / L;
      bi = b * L + i;
      bj = b * L + (rem - i * L);
    }
    const uint32_t d = dst + sw128_offset(r, c);
    cp_async16(d, edge + (size_t)(valid ? row : 0) * CZ + c * 8, valid);
    cp_async16(d + PANEL_C, node + (size_t)bi * CZ + c * 8, valid);
    cp_async16(d + 2 * PANEL_C, node + (size_t)bj * CZ + c * 8, valid);
  }
}

// (mask_i, mask_j) of flattened pair `row` (zeros past `total`).
__device__ __forceinline__ float2 pair_mask(const float* __restrict__ mask, int row, int total,
                                            int L, int LL) {
  if (row >= total) return make_float2(0.f, 0.f);
  const int b = row / LL, rem = row - b * LL, i = rem / L;
  return make_float2(mask[b * L + i], mask[b * L + (rem - i * L)]);
}

// Eight staged readout values of channel `cc` of `dst` (b or pz, `nch`
// channels), pairs row0 .. row0 + 7: one 16-byte store when they lie in one
// batch row and are aligned, else one store each.
__device__ __forceinline__ void store_readout(bf16* __restrict__ dst, int nch, int cc, uint4 v,
                                              int row0, int total, int LL) {
  if (row0 >= total) return;
  const int b = row0 / LL, p = row0 - b * LL;
  bf16* d = dst + ((size_t)b * nch + cc) * LL + p;
  if (row0 + 7 < total && p + 7 < LL && (reinterpret_cast<uintptr_t>(d) & 15) == 0) {
    *reinterpret_cast<uint4*>(d) = v;
    return;
  }
  const bf16* x = reinterpret_cast<const bf16*>(&v);
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int row = row0 + u;
    if (row < total) {
      const int bu = row / LL;
      dst[((size_t)bu * nch + cc) * LL + (row - bu * LL)] = x[u];
    }
  }
}

// Step 3 of the bf16 kernel: h = bf16(relu(acc + b1)) as A fragments (the
// fp32 accumulator layout is the bf16 A-fragment layout); acc = h.W2
// (m64n192k16 x 12); h = bf16(relu(acc + b2)); o += h.W3 (m64n64k16 x 12).
__device__ __forceinline__ void hidden_bf16(float (&acc)[96], float (&o)[32], uint32_t base,
                                            const float* b1_s, const float* b2_s, int q) {
  using S = Smem<false>;
  uint32_t h[48];
#pragma unroll
  for (int j = 0; j < 24; ++j) {
    const float2 bb = *reinterpret_cast<const float2*>(b1_s + 8 * j + 2 * q);
    h[2 * j] = pack_bf16_relu(acc[4 * j] + bb.x, acc[4 * j + 1] + bb.y);
    h[2 * j + 1] = pack_bf16_relu(acc[4 * j + 2] + bb.x, acc[4 * j + 3] + bb.y);
  }
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < 12; ++s)
    mma_rs_n192(acc, &h[4 * s], desc_sw128(base + S::W2 + (s >> 2) * (HID * 128) + (s & 3) * 32),
                s > 0);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(acc);
  fence_regs(h);

#pragma unroll
  for (int j = 0; j < 24; ++j) {
    const float2 bb = *reinterpret_cast<const float2*>(b2_s + 8 * j + 2 * q);
    h[2 * j] = pack_bf16_relu(acc[4 * j] + bb.x, acc[4 * j + 1] + bb.y);
    h[2 * j + 1] = pack_bf16_relu(acc[4 * j + 2] + bb.x, acc[4 * j + 3] + bb.y);
  }
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < 12; ++s)
    mma_rs_n64(o, &h[4 * s], desc_sw128(base + S::W3 + (s >> 2) * (CZ * 128) + (s & 3) * 32), 1);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(o);
  fence_regs(h);
}

// Exact conversions without the conversion units (which run at a quarter of
// the fp32 rate): x + 1.5 * 2^23 rounds x to an integer, ties to even, as
// __float2int_rn does, for |x| < 2^22, and the integer's two's-complement
// low byte is the sum's low byte; an int32 n with |n| < 2^22 is the float
// whose bits are 1.5 * 2^23's plus n, less 1.5 * 2^23.
constexpr float MAGIC = 12582912.f;
constexpr int MAGIC_BITS = 0x4B400000;
__device__ __forceinline__ int round_low_byte(float x) {
  return __float_as_int(__fadd_rn(x, MAGIC));
}
__device__ __forceinline__ float exact_float(int n) {
  return __fsub_rn(__int_as_float(n + MAGIC_BITS), MAGIC);
}
// float(n) * s * w, the JAX kernel's dequantization, with no FMA contraction.
__device__ __forceinline__ float dequant(int n, float s, float w) {
  return __fmul_rn(__fmul_rn(exact_float(n), s), w);
}

// The JAX kernel's `_quant_rows` of the 64 x 192 fp32 tile `v`, held as an
// m64n192 accumulator: a row's 192 lanes lie across the four threads of a
// quad (48 each), so its amax takes two shuffles. inv = amax > 0 ?
// 127/amax : 0 as an IEEE division, q = round-half-even(v * inv) (|v * inv|
// <= 127.5: round_low_byte), the row
// scale amax/127 (sa for row g, sb for row g + 8). The int8 values are
// packed as they lie into the A fragments of the next int8 product: step s,
// register 2u + r holds row g + 8r, accumulator blocks 4s + 2u and 4s + 2u +
// 1 (columns 32s + 16u + 2q, +1, +8, +9), at the fragment's columns 32s +
// 16u + 4q .. +3. That is the permutation the wrapper applies to the K axis
// of W2q^T and W3q^T (cuda_edge.INT8_K_PERM); the integer sums are the same.
__device__ __forceinline__ void quant_rows(const float (&v)[96], uint32_t (&qf)[24], float& sa,
                                           float& sb) {
  float ma = 0.f, mb = 0.f;
#pragma unroll
  for (int j = 0; j < 24; ++j) {
    ma = fmaxf(ma, fmaxf(fabsf(v[4 * j]), fabsf(v[4 * j + 1])));
    mb = fmaxf(mb, fmaxf(fabsf(v[4 * j + 2]), fabsf(v[4 * j + 3])));
  }
  ma = fmaxf(ma, __shfl_xor_sync(0xffffffffu, ma, 1));
  ma = fmaxf(ma, __shfl_xor_sync(0xffffffffu, ma, 2));
  mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, 1));
  mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, 2));
  const float ia = ma > 0.f ? __fdiv_rn(127.f, ma) : 0.f;
  const float ib = mb > 0.f ? __fdiv_rn(127.f, mb) : 0.f;
  sa = __fdiv_rn(ma, 127.f);
  sb = __fdiv_rn(mb, 127.f);
  auto qa = [&](int i) { return round_low_byte(__fmul_rn(v[i], ia)); };
  auto qb = [&](int i) { return round_low_byte(__fmul_rn(v[i], ib)); };
#pragma unroll
  for (int k = 0; k < 12; ++k) {   // k = 2s + u: accumulator blocks 2k, 2k + 1
    const int i = 8 * k;
    qf[2 * k] = pack_s8(qa(i), qa(i + 1), qa(i + 4), qa(i + 5));
    qf[2 * k + 1] = pack_s8(qb(i + 2), qb(i + 3), qb(i + 6), qb(i + 7));
  }
}

// Step 3 of the int8 kernel (the JAX kernel with quant_int8, int8_w3):
// h1 = relu(acc + b1) stays fp32 and is quantized per row (quant_rows);
// acc2 = q1.W2q (m64n192k32 x 6, int32); h2 = relu(float(acc2) * s1 * w2s +
// b2), quantized again; o += float(q2.W3q) * s2 * w3s (m64n64k32 x 6). The
// dequantization keeps the JAX order with no contraction into an FMA; the
// int32 sums are below 192 * 127 * 127 < 2^22 (dequant).
__device__ __forceinline__ void hidden_int8(float (&acc)[96], float (&o)[32], uint32_t base,
                                            const float* b1_s, const float* b2_s,
                                            const float* w2s_s, const float* w3s_s, int q) {
  using S = Smem<true>;
#pragma unroll
  for (int j = 0; j < 24; ++j) {
    const float2 bb = *reinterpret_cast<const float2*>(b1_s + 8 * j + 2 * q);
    acc[4 * j] = fmaxf(acc[4 * j] + bb.x, 0.f);
    acc[4 * j + 1] = fmaxf(acc[4 * j + 1] + bb.y, 0.f);
    acc[4 * j + 2] = fmaxf(acc[4 * j + 2] + bb.x, 0.f);
    acc[4 * j + 3] = fmaxf(acc[4 * j + 3] + bb.y, 0.f);
  }
  uint32_t qf[24];
  float sa, sb;
  quant_rows(acc, qf, sa, sb);
  int ia[96];
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < 6; ++s)
    mma_rs_s8_n192(ia, &qf[4 * s],
                   desc_sw128(base + S::W2 + (s >> 2) * (HID * 128) + (s & 3) * 32), s > 0);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(ia);
  fence_regs(qf);

#pragma unroll
  for (int j = 0; j < 24; ++j) {
    const float2 ws = *reinterpret_cast<const float2*>(w2s_s + 8 * j + 2 * q);
    const float2 bb = *reinterpret_cast<const float2*>(b2_s + 8 * j + 2 * q);
    acc[4 * j] = fmaxf(__fadd_rn(dequant(ia[4 * j], sa, ws.x), bb.x), 0.f);
    acc[4 * j + 1] = fmaxf(__fadd_rn(dequant(ia[4 * j + 1], sa, ws.y), bb.y), 0.f);
    acc[4 * j + 2] = fmaxf(__fadd_rn(dequant(ia[4 * j + 2], sb, ws.x), bb.x), 0.f);
    acc[4 * j + 3] = fmaxf(__fadd_rn(dequant(ia[4 * j + 3], sb, ws.y), bb.y), 0.f);
  }
  quant_rows(acc, qf, sa, sb);
  int i3[32];
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < 6; ++s)
    mma_rs_s8_n64(i3, &qf[4 * s],
                  desc_sw128(base + S::W3Q + (s >> 2) * (CZ * 128) + (s & 3) * 32), s > 0);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(i3);
  fence_regs(qf);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 ws = *reinterpret_cast<const float2*>(w3s_s + 8 * j + 2 * q);
    o[4 * j] = __fadd_rn(dequant(i3[4 * j], sa, ws.x), o[4 * j]);
    o[4 * j + 1] = __fadd_rn(dequant(i3[4 * j + 1], sa, ws.y), o[4 * j + 1]);
    o[4 * j + 2] = __fadd_rn(dequant(i3[4 * j + 2], sb, ws.x), o[4 * j + 2]);
    o[4 * j + 3] = __fadd_rn(dequant(i3[4 * j + 3], sb, ws.y), o[4 * j + 3]);
  }
}

// The whole tile loop of a block (see the top of this file).
template <bool READOUT, bool INT8>
__device__ __forceinline__ void tile_loop(const Args& a) {
  using S = Smem<INT8>;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  if (base & 1023) __trap();   // the swizzle is taken from the address bits
  float* b1_s = reinterpret_cast<float*>(smem + S::V);
  float* b2_s = b1_s + HID;
  float* b3_s = b2_s + HID;
  float* lns_s = b3_s + CZ;
  float* lnb_s = lns_s + CZ;
  float* bro_s = lnb_s + CZ;
  float* w2s_s = bro_s + RO;     // int8 only
  float* w3s_s = w2s_s + HID;    // int8 only
  const bf16* __restrict__ edge = a.edge;
  const bf16* __restrict__ node = a.node;
  const float* __restrict__ mask = a.mask;
  bf16* __restrict__ out = a.out;
  const int L = a.L, total = a.total, n_b = a.n_b, n_pz = a.n_pz;
  const float eps = a.eps;

  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127;
  const int warp = wt >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int LL = L * L;
  const int ntiles = (total + TM - 1) / TM;
  const int stride = gridDim.x * N_WG;
  const uint32_t c_s = base + S::C + wg * TILE_C;
  int tile = blockIdx.x * N_WG + wg;

  stage_kmajor(base + S::W1, a.w1t, HID, HID * 2);
  stage_kmajor(base + S::W3, a.w3t, CZ, HID * 2);
  if (INT8) {
    stage_kmajor(base + S::W2, a.w2t, HID, HID);
    stage_kmajor(base + S::W3Q, a.w3qt, CZ, HID);
  } else {
    stage_kmajor(base + S::W2, a.w2t, HID, HID * 2);
  }
  if (READOUT) stage_kmajor(base + S::WR, a.wrt, RO, CZ * 2);
  for (int c = tid; c < HID; c += NTHREADS) {
    b1_s[c] = a.b1[c];
    b2_s[c] = a.b2[c];
    if (INT8) w2s_s[c] = a.w2s[c];
  }
  for (int c = tid; c < CZ; c += NTHREADS) {
    b3_s[c] = a.b3[c];
    lns_s[c] = a.ln_s[c];
    lnb_s[c] = a.ln_b[c];
    if (INT8) w3s_s[c] = a.w3s[c];
  }
  if (READOUT)
    for (int c = tid; c < RO; c += NTHREADS) bro_s[c] = a.bro[c];
  if (tile < ntiles) gather(c_s, edge, node, tile * TM, total, L, LL, wt);
  cp_async_commit();
  cp_async_wait_all();
  fence_proxy_async();
  __syncthreads();

  const int bar = 1 + wg;   // this warpgroup's named barrier
  for (; tile < ntiles; tile += stride) {
    const int row0 = tile * TM;
    cp_async_wait_all();
    fence_proxy_async();
    named_bar(bar, 128);

    // 2. acc = C.W1, o = C.W3, both from shared memory.
    float acc[96], o[32];
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 12; ++s)
      mma_ss_n192(acc, desc_sw128(c_s + (s >> 2) * PANEL_C + (s & 3) * 32),
                  desc_sw128(base + S::W1 + (s >> 2) * (HID * 128) + (s & 3) * 32), s > 0);
#pragma unroll
    for (int s = 0; s < 12; ++s)
      mma_ss_n64(o, desc_sw128(c_s + (s >> 2) * PANEL_C + (s & 3) * 32),
                 desc_sw128(base + S::W3 + (s >> 2) * (CZ * 128) + (s & 3) * 32), s > 0);
    wgmma_commit();
    // While they run: the masks of this thread's two rows (used by step 4).
    const int ra = row0 + 16 * warp + g, rb = ra + 8;
    const float2 ma = pair_mask(mask, ra, total, L, LL), mb = pair_mask(mask, rb, total, L, LL);
    wgmma_wait_all();
    fence_regs(acc);
    fence_regs(o);
    named_bar(bar, 128);   // every warp's products have read C: gather the next tile
    if (tile + stride < ntiles) gather(c_s, edge, node, (tile + stride) * TM, total, L, LL, wt);
    cp_async_commit();

    // 3. The hidden layers; o += h2's product.
    if constexpr (INT8)
      hidden_int8(acc, o, base, b1_s, b2_s, w2s_s, w3s_s, q);
    else
      hidden_bf16(acc, o, base, b1_s, b2_s, q);

    // 4. + b3, LayerNorm over each row's 64 lanes (16 here, the rest in the
    // quad), affine, pair mask, bf16; y holds bf16(out) as A fragments.
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 bb = *reinterpret_cast<const float2*>(b3_s + 8 * j + 2 * q);
      o[4 * j] += bb.x;
      o[4 * j + 1] += bb.y;
      o[4 * j + 2] += bb.x;
      o[4 * j + 3] += bb.y;
      sa += o[4 * j] + o[4 * j + 1];
      sb += o[4 * j + 2] + o[4 * j + 3];
    }
    sa += __shfl_xor_sync(0xffffffffu, sa, 1);
    sa += __shfl_xor_sync(0xffffffffu, sa, 2);
    sb += __shfl_xor_sync(0xffffffffu, sb, 1);
    sb += __shfl_xor_sync(0xffffffffu, sb, 2);
    const float mua = sa * (1.f / CZ), mub = sb * (1.f / CZ);
    float qa = 0.f, qb = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      o[4 * j] -= mua;
      o[4 * j + 1] -= mua;
      o[4 * j + 2] -= mub;
      o[4 * j + 3] -= mub;
      qa += o[4 * j] * o[4 * j] + o[4 * j + 1] * o[4 * j + 1];
      qb += o[4 * j + 2] * o[4 * j + 2] + o[4 * j + 3] * o[4 * j + 3];
    }
    qa += __shfl_xor_sync(0xffffffffu, qa, 1);
    qa += __shfl_xor_sync(0xffffffffu, qa, 2);
    qb += __shfl_xor_sync(0xffffffffu, qb, 1);
    qb += __shfl_xor_sync(0xffffffffu, qb, 2);
    const float rsa = rsqrtf(qa * (1.f / CZ) + eps), rsb = rsqrtf(qb * (1.f / CZ) + eps);
    const float pma = ma.x * ma.y, pmb = mb.x * mb.y;
    uint32_t y[16];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 8 * j + 2 * q;
      const float2 ls = *reinterpret_cast<const float2*>(lns_s + c);
      const float2 lb = *reinterpret_cast<const float2*>(lnb_s + c);
      y[2 * j] = pack_bf16((o[4 * j] * rsa * ls.x + lb.x) * pma,
                           (o[4 * j + 1] * rsa * ls.y + lb.y) * pma);
      y[2 * j + 1] = pack_bf16((o[4 * j + 2] * rsb * ls.x + lb.x) * pmb,
                               (o[4 * j + 3] * rsb * ls.y + lb.y) * pmb);
      if (ra < total) *reinterpret_cast<uint32_t*>(out + (size_t)ra * CZ + c) = y[2 * j];
      if (rb < total) *reinterpret_cast<uint32_t*>(out + (size_t)rb * CZ + c) = y[2 * j + 1];
    }

    if (READOUT) {
      // 5. r = bf16(out).Wr, y being the A operand (m64n32k16 x 4).
      float r[16];
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < CZ / 16; ++s)
        mma_rs_n32(r, &y[4 * s], desc_sw128(base + S::WR + s * 32), s > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(r);
      fence_regs(y);
      // + bro, bf16, out through this warp's staging [16 channels][16 rows],
      // 16 channels at a time: each lane stores 8 consecutive pairs of one
      // channel, so a channel's 16 pairs leave as one whole 32-byte sector.
      bf16* st = reinterpret_cast<bf16*>(smem + S::STAGE) + (wg * 4 + warp) * RO_WARP;
      const int nro = n_b + n_pz;
#pragma unroll
      for (int part = 0; part < RO / RO_CH; ++part) {
        if (part * RO_CH >= nro) break;
#pragma unroll
        for (int jj = 0; jj < RO_CH / 8; ++jj) {
          const int j = part * (RO_CH / 8) + jj, cl = 8 * jj + 2 * q;
          const float2 bo = *reinterpret_cast<const float2*>(bro_s + 8 * j + 2 * q);
          st[cl * 16 + g] = __float2bfloat16(r[4 * j] + bo.x);
          st[(cl + 1) * 16 + g] = __float2bfloat16(r[4 * j + 1] + bo.y);
          st[cl * 16 + g + 8] = __float2bfloat16(r[4 * j + 2] + bo.x);
          st[(cl + 1) * 16 + g + 8] = __float2bfloat16(r[4 * j + 3] + bo.y);
        }
        __syncwarp();
        const int cl = lane >> 1, h8 = (lane & 1) * 8, c = part * RO_CH + cl;
        if (c < nro) {
          const uint4 v = *reinterpret_cast<const uint4*>(st + cl * 16 + h8);
          const int p0 = row0 + 16 * warp + h8;
          if (c < n_b) store_readout(a.b_out, n_b, c, v, p0, total, LL);
          else store_readout(a.pz_out, n_pz, c - n_b, v, p0, total, LL);
        }
        __syncwarp();
      }
    }
  }
}

// Launches kernel (the variant of `readout`: 0 off, 1 on) on `stream` with
// `smem_bytes` of dynamic shared memory: a persistent grid of at most one
// block per SM, each walking pairs of 64-pair tiles. Returns the launch's
// cudaError_t (0 on success). The SM count and each variant's shared-memory
// opt-in are set once per device (racing first calls write the same values);
// `static`, so each kernel library keeps its own.
constexpr int MAX_DEVICES = 64;
static inline int launch(void (*kernel)(Args), int readout, Args a, int B, int L,
                         int smem_bytes, void* stream) {
  static int sms[MAX_DEVICES];
  static bool opt_in[2][MAX_DEVICES];
  const long long total = (long long)B * L * L;
  if (total == 0) return 0;
  if (total > INT_MAX) return (int)cudaErrorInvalidValue;   // pair rows are 32-bit
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!opt_in[readout][dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
    opt_in[readout][dev] = true;
  }
  if (sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  a.L = L;
  a.total = (int)total;
  const long long pairs_of_tiles = ((total + TM - 1) / TM + N_WG - 1) / N_WG;
  const int grid = (int)(pairs_of_tiles < sms[dev] ? pairs_of_tiles : sms[dev]);
  kernel<<<grid, NTHREADS, smem_bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace edge
