// Fused EdgeTransition backward for Hopper, sm_90a (K4).
//
// Replaces: pepflowww_tpu/models/pallas_edge_bwd.py:148 edge_transition_bwd
// (body `_bwd_kernel` :26, pallas_call :221), the backward half of
// fused_edge_transition_vjp (:255).
//
// For the cotangent g of out = LN(o) * mask_i * mask_j (see
// edge_transition.cu for the forward), per pair with x = [e | n_i | n_j]:
//   recompute  a1 = x.W1 + b1, h1 = relu(a1), a2 = bf16(h1).W2 + b2,
//              r = relu(a2) + x, o = bf16(r).W3 + b3, y = (o - mu) * inv
//   LayerNorm  g' = g * mask_i * mask_j, dy = g' * ln_scale,
//              do = (dy - mean(dy) - y * mean(dy * y)) * inv
//   products   dr = bf16(do).W3^T, da2 = dr * (a2 > 0),
//              dh1 = bf16(da2).W2^T, da1 = dh1 * (a1 > 0),
//              dx = bf16(da1).W1^T + dr
//   outputs    d_edge = dx[:64]; d_node[b,k] = sum_j dx_(k,j)[64:128]
//              + sum_i dx_(i,k)[128:192]; dW1 = x^T.bf16(da1),
//              dW2 = bf16(h1)^T.bf16(da2), dW3 = bf16(r)^T.bf16(do),
//              db = column sums of the fp32 da1, da2, do,
//              d_ln_scale = sum g'*y, d_ln_bias = sum g'.
// GEMM operands are bf16 with fp32 accumulation, at the JAX kernel's
// rounding points; LayerNorm statistics and every sum are fp32.
//
// What bounds it on this card: per pair ~61k MAC of recompute and ~123k
// MAC of backward products, all bf16 on the tensor cores: operations
// (~49 us at B=32, L=64 at 989 TFLOP/s). This design does ~184k MAC a pair
// in the chain (x.W1 and dx on the concatenated row, dr twice) and ~86k in
// the weight gradients (dW1 on the whole row), and moves ~4.4 KB a pair
// through device memory (~172 us at B=32, L=64 at 3.35 TB/s): mostly the
// weight gradients' bf16 operands (1.66 KB), written once by the chain and
// read once by the weight kernel.
//
// Design: three launches a call, every cross-block sum through partials
// added in a fixed order (no float atomics: two calls give bit-identical
// results).
//  1. edge_bwd_chain_kernel: a persistent grid, two warpgroups a block,
//     each walking its own tiles of 64 pairs: an 8 x 8 block (i0..i0+7,
//     j0..j0+7) of one batch row, so any L runs (pairs past L are
//     zero-filled and their g' is 0, so they add nothing). W1^T, W2^T, W3^T
//     stay in shared memory, K-major in the 128-byte swizzle as the forward
//     holds them (edge_transition.cuh); the backward products read the same
//     copies MN-major (transpose-B, wgmma.cuh desc_sw128_mn). Per tile a
//     warpgroup gathers C = [e | n_i | n_j] with cp.async and runs C.W1,
//     then, by 64-column thirds, h1.W2, r.W3, do.W3^T, da2.W2^T and
//     do.W3^T + da1.W1^T, each third's accumulator turned into the next
//     product's A operand: h1, do and da1 as bf16 fragments in registers,
//     r and da2 written in place over C and read from there. LayerNorm
//     forward and backward run in registers with quad shuffles. It writes
//     d_edge, and the bf16 h1, r, do, da2, da1 as the tile's 128-byte
//     swizzled panel images (so the weight kernel copies them as they
//     lie). A tile's column sums (biases and LayerNorm parameters) are
//     summed over each quad column's eight lanes by a butterfly and kept a
//     lane; the node terms leave as partials: a tile row's sum of dx[64:128]
//     over its 8 j (one slot per j block) and a warp's sum of dx[128:192]
//     over its 2 i (one slot per i block and warp).
//  2. edge_bwd_weight_kernel: dW1 = C^T.bf16(da1) (C gathered again),
//     dW2 = bf16(h1)^T.bf16(da2), dW3 = bf16(r)^T.bf16(do), split over
//     chunks of tiles; both operands MN-major from shared memory
//     (transpose-A and -B), a 4-stage cp.async ring; one fp32 partial per
//     chunk. Each operand is read once.
//  3. edge_bwd_reduce_kernel: every partial summed in a fixed order.
// Pair rows are 32-bit: the launcher refuses B*L*L > INT_MAX.

#include <climits>

#include "wgmma.cuh"
#include "wide_gemm.cuh"

namespace {

using namespace hopper;
typedef __nv_bfloat16 bf16;

constexpr int CZ = 64;     // pair channels in and out; node-bias width
constexpr int HID = 192;   // hidden width = the concat row's
constexpr int TM = 64;     // pairs a tile: one warpgroup product
constexpr int TI = 8;      // a tile is TI x TI pairs of one batch row
constexpr int PANEL = TM * 128;            // 64 rows of 128 bytes
constexpr int TILE_H = 3 * PANEL;          // a tile's 192-wide bf16 image
constexpr int TILE_Z = PANEL;              // a tile's 64-wide bf16 image
constexpr int VEC = 2 * HID + 3 * CZ;      // d_b1 | d_b2 | d_b3 | d_ln_scale | d_ln_bias
constexpr int NW12 = HID * HID;            // dW1, dW2
constexpr int NW3 = HID * CZ;              // dW3
constexpr int COL_SLOTS = 4;               // column partials a tile writes per column
constexpr unsigned FULL = 0xffffffffu;

constexpr int N_WG = 2;                    // chain kernel: consumer warpgroups a block
constexpr int NT_C = 128 * N_WG;
constexpr int WG_W = 3;                    // weight kernel: warpgroups a block
constexpr int NT_W = 128 * WG_W;
constexpr int NST = 4;                     // weight kernel: stages of its ring
constexpr int STAGE_W = 2 * TILE_H;

// Chain kernel shared memory (bytes): W1^T, W2^T [3][192][128 B], W3^T
// [3][64][128 B], one C tile a warpgroup [3][64][128 B], the fp32 vectors
// b1 b2 b3 ln_s, and each thread's (a1 > 0), (a2 > 0) bits [6][256] u32:
// 229,376 of the 232,448 a block may use.
struct ChainSmem {
  static constexpr int W1 = 0;
  static constexpr int W2 = W1 + HID * HID * 2;
  static constexpr int W3 = W2 + HID * HID * 2;
  static constexpr int C = W3 + CZ * HID * 2;
  static constexpr int V = C + N_WG * TILE_H;
  static constexpr int MASK = V + (2 * HID + 2 * CZ) * 4;
  static constexpr int BYTES = MASK + 6 * NT_C * 4;
  static_assert(W2 % 1024 == 0 && W3 % 1024 == 0 && C % 1024 == 0, "panels on 1024 bytes");
  static_assert(BYTES <= 232448, "more shared memory than a block may use");
  static_assert(8 * VEC * 4 <= N_WG * TILE_H, "the block's vector reduction fits in C");
};
constexpr int WEIGHT_SMEM = NST * STAGE_W;
static_assert(WEIGHT_SMEM <= 232448, "more shared memory than a block may use");

struct Tile {
  int b, ib, jb;
};
__device__ __forceinline__ Tile tile_at(int t, int nbi) {
  const int per_b = nbi * nbi, b = t / per_b, rem = t - b * per_b, ib = rem / nbi;
  return {b, ib, rem - ib * nbi};
}

// The tile's concat rows C = [e | n_i | n_j] into the swizzled panels at
// `dst`; row r is pair (b, 8 ib + r / 8, 8 jb + r % 8), zero past L. Copies
// the 16-byte chunks first, first + step, ... of 3 parts x 64 rows x 8: eight
// threads in a row read one 128-byte row, and a row's 8 pairs are
// consecutive in `edge`.
__device__ __forceinline__ void gather(uint32_t dst, const bf16* __restrict__ edge,
                                       const bf16* __restrict__ node, Tile t, int L, int first,
                                       int step) {
  for (int v = first; v < 3 * TM * 8; v += step) {
    const int part = v >> 9, r = (v >> 3) & (TM - 1), c = v & 7;
    const int i = t.ib * TI + (r >> 3), j = t.jb * TI + (r & 7);
    const bool valid = i < L && j < L;
    const bf16* src = edge;
    if (valid)
      src = part == 0 ? edge + ((size_t)(t.b * L + i) * L + j) * CZ + c * 8
                      : node + (size_t)(t.b * L + (part == 1 ? i : j)) * CZ + c * 8;
    cp_async16(dst + part * PANEL + sw128_offset(r, c), src, valid);
  }
}

// `bytes` of a tile image from global to shared memory as they lie.
__device__ __forceinline__ void copy_image(uint32_t dst, const bf16* __restrict__ src, int bytes,
                                           int first, int step) {
  const char* s = reinterpret_cast<const char*>(src);
  for (int v = first; v < bytes / 16; v += step) cp_async16(dst + v * 16, s + v * 16, true);
}

// The thread's A fragments of n 8-column blocks (pairs of columns 8j + 2q,
// j < n, of rows ra = 16 warp + g and ra + 8; v[2j] row ra, v[2j + 1] row
// ra + 8) into a tile image in global memory starting at panel `img`, at
// the places its swizzled panels hold them.
__device__ __forceinline__ void store_image(bf16* __restrict__ img, const uint32_t* v, int n,
                                            int ra, int g, int q) {
  char* base = reinterpret_cast<char*>(img) + ra * 128 + 4 * q;
#pragma unroll
  for (int j = 0; j < n; ++j) {
    uint32_t* d = reinterpret_cast<uint32_t*>(base + (j >> 3) * PANEL + (((j & 7) ^ g) << 4));
    d[0] = v[2 * j];
    d[8 * 128 / 4] = v[2 * j + 1];
  }
}

// The sum of entry g = lane / 4 of v over the eight lanes of a quad column
// (the lanes with the same lane % 4), in a fixed butterfly order: a step
// over lane bit m halves the n entries still held, the lane with that bit
// set keeping the upper half. Eight entries are the pairs of columns 2q,
// 2q + 1 of four 8-column blocks, so lane g is left with column
// 8 (g / 2) + 2q + g % 2 of them.
template <int n, int m, int N>
__device__ __forceinline__ void butterfly_step(float (&v)[N], int lane) {
  const bool up = lane & m;
#pragma unroll
  for (int k = 0; k < n / 2; ++k) {
    const float send = up ? v[k] : v[k + n / 2];
    const float keep = up ? v[k + n / 2] : v[k];
    v[k] = keep + __shfl_xor_sync(FULL, send, m);
  }
}
__device__ __forceinline__ float quad_column_sum(float (&v)[8], int lane) {
  butterfly_step<8, 16>(v, lane);
  butterfly_step<4, 8>(v, lane);
  butterfly_step<2, 4>(v, lane);
  return v[0];
}

// 0 at run time (zero is a kernel argument that is 0), but computed from
// x: a product whose first scale-d operand is it cannot be issued before x
// exists. The compiler would otherwise start each product as soon as its
// operands are ready, put off the previous third's epilogue, and hold
// several thirds' values at once: more registers than a thread has.
__device__ __forceinline__ int after(uint32_t x, uint32_t zero) { return (int)(x & zero); }
__device__ __forceinline__ uint32_t bits_of(float x) { return __float_as_uint(x); }
// The bits of n words folded into one, for after(): the product then waits
// for every one of them.
__device__ __forceinline__ uint32_t fold(const uint32_t* v, int n) {
  uint32_t x = 0u;
#pragma unroll
  for (int k = 0; k < n; ++k) x ^= v[k];
  return x;
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}
__device__ __forceinline__ bool bit(uint32_t m, int i) { return (m >> i) & 1u; }

struct ChainArgs {
  const bf16* edge;
  const bf16* node;
  const float* mask;
  const bf16* g;
  const bf16* w1t;
  const float* b1;
  const bf16* w2t;
  const float* b2;
  const bf16* w3t;
  const float* b3;
  const float* ln_s;
  bf16* h1s;   // scratch tile images: [ntiles][3 panels], r, da2, da1 alike
  bf16* rs;
  bf16* dos;   // [ntiles][1 panel]
  bf16* da2s;
  bf16* da1s;
  float* vpart;     // [gridDim.x][VEC]
  float* rowpart;   // [B*L][nbi][64]: tile row sums of dx[64:128], slot jb
  float* colpart;   // [B*L][4 nbi][64]: warp sums of dx[128:192], slot 4 ib + warp
  void* d_edge;
  int d_edge_f32, L, nbi, ntiles;
  float eps;
  uint32_t zero;   // 0: see after()
};

__global__ void __launch_bounds__(NT_C, 1)
edge_bwd_chain_kernel(const __grid_constant__ ChainArgs a) {
  using S = ChainSmem;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  if (base & 1023) __trap();   // the swizzle is taken from the address bits
  float* b1_s = reinterpret_cast<float*>(smem + S::V);
  float* b2_s = b1_s + HID;
  float* b3_s = b2_s + HID;
  float* lns_s = b3_s + CZ;
  uint32_t* mask_s = reinterpret_cast<uint32_t*>(smem + S::MASK) + threadIdx.x;   // [6][NT_C]
  const int L = a.L, nbi = a.nbi, ntiles = a.ntiles;
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127;
  const int warp = wt >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int ra = 16 * warp + g;   // this thread's rows: ra and ra + 8 of each tile
  const int stride = gridDim.x * N_WG;
  const uint32_t c_s = base + S::C + wg * TILE_H;
  unsigned char* c_p = smem + S::C + wg * TILE_H;
  // Word (columns 8u + 2q, 8u + 2q + 1) of row ra in panel p of C; row ra + 8 is 256 words on.
  auto c_word = [&](int p, int u) {
    return reinterpret_cast<uint32_t*>(c_p + p * PANEL + ra * 128 + ((u ^ g) << 4) + 4 * q);
  };
  int tile = blockIdx.x * N_WG + wg;

  for (int v = tid; v < HID * 24; v += NT_C) {   // W1^T, W2^T: 192 rows of 24 chunks
    const int n = v / 24, c = v % 24;
    const uint32_t off = (c >> 3) * (HID * 128) + sw128_offset(n, c & 7);
    cp_async16(base + S::W1 + off, a.w1t + n * HID + c * 8, true);
    cp_async16(base + S::W2 + off, a.w2t + n * HID + c * 8, true);
  }
  for (int v = tid; v < CZ * 24; v += NT_C) {    // W3^T: 64 rows of 24 chunks
    const int n = v / 24, c = v % 24;
    cp_async16(base + S::W3 + (c >> 3) * (CZ * 128) + sw128_offset(n, c & 7),
               a.w3t + n * HID + c * 8, true);
  }
  for (int c = tid; c < HID; c += NT_C) {
    b1_s[c] = a.b1[c];
    b2_s[c] = a.b2[c];
  }
  for (int c = tid; c < CZ; c += NT_C) {
    b3_s[c] = a.b3[c];
    lns_s[c] = a.ln_s[c];
  }
  if (tile < ntiles) gather(c_s, a.edge, a.node, tile_at(tile, nbi), L, wt, 128);
  cp_async_commit();
  cp_async_wait_all();
  fence_proxy_async();
  __syncthreads();

  // Column sums of this lane over its tiles (quad_column_sum of each tile's
  // rows): entry c is column 32c + 8 (g / 2) + 2q + g % 2 of d_b1, d_b2
  // (c < 6) and of d_b3, d_ln_scale, d_ln_bias (c < 2).
  float s_b1[6] = {}, s_b2[6] = {}, s_b3[2] = {}, s_sc[2] = {}, s_bi[2] = {};

  const int bar = 1 + wg;   // this warpgroup's named barrier
  for (; tile < ntiles; tile += stride) {
    const Tile t = tile_at(tile, nbi);
    cp_async_wait_all();
    fence_proxy_async();
    named_bar(bar, 128);

    // The products after the first run as three 64-column thirds
    // (m64n64k16), each third turned into its successor's A operand and
    // column sums before the next: 32 accumulators are live, not 96. r and
    // da2 go to the warpgroup's C tile in place, each element where this
    // thread read it, and the next products read them from there; so no
    // thread holds two 48-register A operands at once.
    const int i_a = t.ib * TI + 2 * warp, j = t.jb * TI + g;
    const bool va = i_a < L && j < L, vb = i_a + 1 < L && j < L;
    const int pa = va ? (t.b * L + i_a) * L + j : 0, pb = vb ? pa + L : 0;
    uint32_t h[48];   // A fragments: h1, then da1
    float acc[32];
    int first = 0;   // scale-d of a third's first product: 0, after the last epilogue

    // 1. a1 = C.W1 from shared memory; meanwhile the rows' g is fetched to
    // L2 (it is read in step 4). h1 = bf16(relu(a1 + b1)) into h.
    {
      float a1[96];
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < 12; ++s)
        mma_ss_n192(a1, desc_sw128(c_s + (s >> 2) * PANEL + (s & 3) * 32),
                    desc_sw128(base + S::W1 + (s >> 2) * (HID * 128) + (s & 3) * 32), s > 0);
      wgmma_commit();
      if (va) prefetch_l2(a.g + (size_t)pa * CZ);
      if (vb) prefetch_l2(a.g + (size_t)pb * CZ);
      wgmma_wait_all();
      fence_regs(a1);
      uint32_t m1[3] = {0u, 0u, 0u};
#pragma unroll
      for (int jb = 0; jb < 24; ++jb) {
        const float2 bb = *reinterpret_cast<const float2*>(b1_s + 8 * jb + 2 * q);
        const float v0 = a1[4 * jb] + bb.x, v1 = a1[4 * jb + 1] + bb.y;
        const float v2 = a1[4 * jb + 2] + bb.x, v3 = a1[4 * jb + 3] + bb.y;
        h[2 * jb] = pack_bf16_relu(v0, v1);
        h[2 * jb + 1] = pack_bf16_relu(v2, v3);
        const uint32_t bits = (v0 > 0.f) | (v1 > 0.f) << 1 | (v2 > 0.f) << 2 | (v3 > 0.f) << 3;
        m1[jb >> 3] |= bits << (4 * (jb & 7));
      }
      // The bits go to shared memory before the barrier, so the compiler
      // cannot put off computing them and keep a1 live until step 6.
#pragma unroll
      for (int k = 0; k < 3; ++k) mask_s[k * NT_C] = m1[k];
    }
    store_image(a.h1s + (size_t)tile * (TILE_H / 2), h, 24, ra, g, q);
    named_bar(bar, 128);   // every warp's C.W1 has read C: r may overwrite x

    // 2. By thirds p: a2 = bf16(h1).W2 (W2^T rows 64p.., K-major);
    // r = bf16(relu(a2 + b2) + x) over x in C, and to the scratch.
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < 12; ++s)
        mma_rs_n64(acc, &h[4 * s],
                   desc_sw128(base + S::W2 + (s >> 2) * (HID * 128) + p * PANEL + (s & 3) * 32),
                   s > 0 ? 1 : first);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      uint32_t r[16], m2 = 0u;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const float2 bb = *reinterpret_cast<const float2*>(b2_s + 64 * p + 8 * u + 2 * q);
        const float v0 = acc[4 * u] + bb.x, v1 = acc[4 * u + 1] + bb.y;
        const float v2 = acc[4 * u + 2] + bb.x, v3 = acc[4 * u + 3] + bb.y;
        uint32_t* xp = c_word(p, u);
        const float2 xa = unpack_bf16(xp[0]), xb = unpack_bf16(xp[8 * 128 / 4]);
        r[2 * u] = pack_bf16(fmaxf(v0, 0.f) + xa.x, fmaxf(v1, 0.f) + xa.y);
        r[2 * u + 1] = pack_bf16(fmaxf(v2, 0.f) + xb.x, fmaxf(v3, 0.f) + xb.y);
        xp[0] = r[2 * u];
        xp[8 * 128 / 4] = r[2 * u + 1];
        const uint32_t bits = (v0 > 0.f) | (v1 > 0.f) << 1 | (v2 > 0.f) << 2 | (v3 > 0.f) << 3;
        m2 |= bits << (4 * u);
      }
      mask_s[(3 + p) * NT_C] = m2;
      store_image(a.rs + (size_t)tile * (TILE_H / 2) + p * (PANEL / 2), r, 8, ra, g, q);
      first = after(fold(r, 16) ^ m2, a.zero);
    }
    fence_regs(h);
    fence_proxy_async();
    named_bar(bar, 128);   // r is in C for every warp

    // 3. o = bf16(r).W3 (m64n64k16 x 12), r from C; then C may take da2.
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 12; ++s)
      mma_ss_n64(acc, desc_sw128(c_s + (s >> 2) * PANEL + (s & 3) * 32),
                 desc_sw128(base + S::W3 + (s >> 2) * (CZ * 128) + (s & 3) * 32), s > 0);
    wgmma_commit();
    // While it runs: the rows' pair masks and g.
    const float pma = va ? a.mask[t.b * L + i_a] * a.mask[t.b * L + j] : 0.f;
    const float pmb = vb ? a.mask[t.b * L + i_a + 1] * a.mask[t.b * L + j] : 0.f;
    const uint32_t* ga = reinterpret_cast<const uint32_t*>(a.g + (size_t)pa * CZ + 2 * q);
    const uint32_t* gb = reinterpret_cast<const uint32_t*>(a.g + (size_t)pb * CZ + 2 * q);
    uint32_t gr[16];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      gr[2 * jj] = va ? ga[4 * jj] : 0u;
      gr[2 * jj + 1] = vb ? gb[4 * jj] : 0u;
    }
    wgmma_wait_all();
    fence_regs(acc);
    named_bar(bar, 128);   // every warp's product has read r

    // 5. + b3, LayerNorm forward over each row's 64 lanes (16 here, the
    // rest in the quad), then its backward: bf16(do) as A
    // fragments in dp; the tile's column sums of do, g'y and g'.
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int jb = 0; jb < 8; ++jb) {
      const float2 bb = *reinterpret_cast<const float2*>(b3_s + 8 * jb + 2 * q);
      acc[4 * jb] += bb.x;
      acc[4 * jb + 1] += bb.y;
      acc[4 * jb + 2] += bb.x;
      acc[4 * jb + 3] += bb.y;
      sa += acc[4 * jb] + acc[4 * jb + 1];
      sb += acc[4 * jb + 2] + acc[4 * jb + 3];
    }
    sa += __shfl_xor_sync(FULL, sa, 1);
    sa += __shfl_xor_sync(FULL, sa, 2);
    sb += __shfl_xor_sync(FULL, sb, 1);
    sb += __shfl_xor_sync(FULL, sb, 2);
    const float mua = sa * (1.f / CZ), mub = sb * (1.f / CZ);
    float qa = 0.f, qb = 0.f;
#pragma unroll
    for (int jb = 0; jb < 8; ++jb) {
      acc[4 * jb] -= mua;
      acc[4 * jb + 1] -= mua;
      acc[4 * jb + 2] -= mub;
      acc[4 * jb + 3] -= mub;
      qa += acc[4 * jb] * acc[4 * jb] + acc[4 * jb + 1] * acc[4 * jb + 1];
      qb += acc[4 * jb + 2] * acc[4 * jb + 2] + acc[4 * jb + 3] * acc[4 * jb + 3];
    }
    qa += __shfl_xor_sync(FULL, qa, 1);
    qa += __shfl_xor_sync(FULL, qa, 2);
    qb += __shfl_xor_sync(FULL, qb, 1);
    qb += __shfl_xor_sync(FULL, qb, 2);
    const float rsa = rsqrtf(qa * (1.f / CZ) + a.eps), rsb = rsqrtf(qb * (1.f / CZ) + a.eps);
    float v_sc[16], v_bi[16], n1a = 0.f, n2a = 0.f, n1b = 0.f, n2b = 0.f;
#pragma unroll
    for (int jb = 0; jb < 8; ++jb) {
      const float2 ls = *reinterpret_cast<const float2*>(lns_s + 8 * jb + 2 * q);
      const float2 ga = unpack_bf16(gr[2 * jb]), gb = unpack_bf16(gr[2 * jb + 1]);
      const float g0 = ga.x * pma, g1 = ga.y * pma, g2 = gb.x * pmb, g3 = gb.y * pmb;
      acc[4 * jb] *= rsa;   // acc now holds y
      acc[4 * jb + 1] *= rsa;
      acc[4 * jb + 2] *= rsb;
      acc[4 * jb + 3] *= rsb;
      v_sc[2 * jb] = g0 * acc[4 * jb] + g2 * acc[4 * jb + 2];
      v_sc[2 * jb + 1] = g1 * acc[4 * jb + 1] + g3 * acc[4 * jb + 3];
      v_bi[2 * jb] = g0 + g2;
      v_bi[2 * jb + 1] = g1 + g3;
      const float d0 = g0 * ls.x, d1 = g1 * ls.y, d2 = g2 * ls.x, d3 = g3 * ls.y;
      n1a += d0 + d1;
      n2a += d0 * acc[4 * jb] + d1 * acc[4 * jb + 1];
      n1b += d2 + d3;
      n2b += d2 * acc[4 * jb + 2] + d3 * acc[4 * jb + 3];
    }
#pragma unroll
    for (int m = 1; m <= 2; m <<= 1) {
      n1a += __shfl_xor_sync(FULL, n1a, m);
      n2a += __shfl_xor_sync(FULL, n2a, m);
      n1b += __shfl_xor_sync(FULL, n1b, m);
      n2b += __shfl_xor_sync(FULL, n2b, m);
    }
    n1a *= 1.f / CZ;
    n2a *= 1.f / CZ;
    n1b *= 1.f / CZ;
    n2b *= 1.f / CZ;
    float v_b3[16];
    uint32_t dp[16];
#pragma unroll
    for (int jb = 0; jb < 8; ++jb) {
      const float2 ls = *reinterpret_cast<const float2*>(lns_s + 8 * jb + 2 * q);
      const float2 ga = unpack_bf16(gr[2 * jb]), gb = unpack_bf16(gr[2 * jb + 1]);
      const float d0 = (ga.x * pma * ls.x - n1a - acc[4 * jb] * n2a) * rsa;
      const float d1 = (ga.y * pma * ls.y - n1a - acc[4 * jb + 1] * n2a) * rsa;
      const float d2 = (gb.x * pmb * ls.x - n1b - acc[4 * jb + 2] * n2b) * rsb;
      const float d3 = (gb.y * pmb * ls.y - n1b - acc[4 * jb + 3] * n2b) * rsb;
      v_b3[2 * jb] = d0 + d2;
      v_b3[2 * jb + 1] = d1 + d3;
      dp[2 * jb] = pack_bf16(d0, d1);
      dp[2 * jb + 1] = pack_bf16(d2, d3);
    }
    store_image(a.dos + (size_t)tile * (TILE_Z / 2), dp, 8, ra, g, q);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float t3[8], tc[8], tb[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        t3[k] = v_b3[8 * c + k];
        tc[k] = v_sc[8 * c + k];
        tb[k] = v_bi[8 * c + k];
      }
      s_b3[c] += quad_column_sum(t3, lane);
      s_sc[c] += quad_column_sum(tc, lane);
      s_bi[c] += quad_column_sum(tb, lane);
    }
    first = after(fold(dp, 16) ^ bits_of(s_b3[1]) ^ bits_of(s_sc[1]) ^ bits_of(s_bi[1]), a.zero);

    // 5. By thirds p: dr = bf16(do).W3^T (W3^T read MN-major: K = its 64
    // rows, N = panel p); da2 = dr * (a2 > 0): its column sums, then
    // bf16(da2) into C over r, and to the scratch.
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      const uint32_t m2 = mask_s[(3 + p) * NT_C];
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < 4; ++s)
        mma_rs_n64<1>(acc, &dp[4 * s], desc_sw128_mn(base + S::W3 + p * PANEL + s * 2048, PANEL),
                      s > 0 ? 1 : first);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
#pragma unroll
      for (int c = 0; c < 2; ++c) {   // blocks 4c .. 4c + 3 of the third
        float v[8];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int k = 4 * (4 * c + u);
          v[2 * u] = (bit(m2, k) ? acc[k] : 0.f) + (bit(m2, k + 2) ? acc[k + 2] : 0.f);
          v[2 * u + 1] = (bit(m2, k + 1) ? acc[k + 1] : 0.f) + (bit(m2, k + 3) ? acc[k + 3] : 0.f);
        }
        s_b2[2 * p + c] += quad_column_sum(v, lane);
      }
      uint32_t d[16];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int k = 4 * u;
        d[2 * u] = pack_bf16(bit(m2, k) ? acc[k] : 0.f, bit(m2, k + 1) ? acc[k + 1] : 0.f);
        d[2 * u + 1] =
            pack_bf16(bit(m2, k + 2) ? acc[k + 2] : 0.f, bit(m2, k + 3) ? acc[k + 3] : 0.f);
        uint32_t* cp = c_word(p, u);
        cp[0] = d[2 * u];
        cp[8 * 128 / 4] = d[2 * u + 1];
      }
      store_image(a.da2s + (size_t)tile * (TILE_H / 2) + p * (PANEL / 2), d, 8, ra, g, q);
      first = after(fold(d, 16) ^ bits_of(s_b2[2 * p + 1]), a.zero);
    }
    fence_regs(dp);
    fence_proxy_async();
    named_bar(bar, 128);   // da2 is in C for every warp

    // 6. By thirds p: dh1 = bf16(da2).W2^T, da2 from C (K-major), W2^T
    // MN-major (N = panel p); da1 = dh1 * (a1 > 0): its column sums, then
    // bf16(da1) into h. After the last third C is free: the next tile's
    // gather goes into it.
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      const uint32_t m1 = mask_s[p * NT_C];
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < 12; ++s)
        mma_ss_n64<0, 1>(acc, desc_sw128(c_s + (s >> 2) * PANEL + (s & 3) * 32),
                         desc_sw128_mn(base + S::W2 + p * (HID * 128) + s * 2048, HID * 128),
                         s > 0 ? 1 : first);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      if (p == 2) {
        named_bar(bar, 128);   // every warp's products have read da2
        if (tile + stride < ntiles)
          gather(c_s, a.edge, a.node, tile_at(tile + stride, nbi), L, wt, 128);
        cp_async_commit();
      }
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float v[8];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int k = 4 * (4 * c + u);
          v[2 * u] = (bit(m1, k) ? acc[k] : 0.f) + (bit(m1, k + 2) ? acc[k + 2] : 0.f);
          v[2 * u + 1] = (bit(m1, k + 1) ? acc[k + 1] : 0.f) + (bit(m1, k + 3) ? acc[k + 3] : 0.f);
        }
        s_b1[2 * p + c] += quad_column_sum(v, lane);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int k = 4 * u, jb = 8 * p + u;
        h[2 * jb] = pack_bf16(bit(m1, k) ? acc[k] : 0.f, bit(m1, k + 1) ? acc[k + 1] : 0.f);
        h[2 * jb + 1] =
            pack_bf16(bit(m1, k + 2) ? acc[k + 2] : 0.f, bit(m1, k + 3) ? acc[k + 3] : 0.f);
      }
      first = after(fold(&h[16 * p], 16) ^ bits_of(s_b1[2 * p + 1]), a.zero);
    }
    store_image(a.da1s + (size_t)tile * (TILE_H / 2), h, 24, ra, g, q);

    // 7. By thirds p: dx = bf16(do).W3^T + bf16(da1).W1^T (dr again, in the
    // same accumulator; both MN-major, N = panel p). Third 0 is d_edge;
    // third 1 leaves as this tile's row partial of dx[64:128] (its 8 j of a
    // row, slot jb), third 2 as this warp's column partial of dx[128:192]
    // (its 2 i of a column, slot 4 ib + warp).
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < 4; ++s)
        mma_rs_n64<1>(acc, &dp[4 * s], desc_sw128_mn(base + S::W3 + p * PANEL + s * 2048, PANEL),
                      s > 0 ? 1 : first);
#pragma unroll
      for (int s = 0; s < 12; ++s)
        mma_rs_n64<1>(acc, &h[4 * s],
                      desc_sw128_mn(base + S::W1 + p * (HID * 128) + s * 2048, HID * 128), 1);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      if (p == 0) {
        if (a.d_edge_f32) {
          float* da = static_cast<float*>(a.d_edge) + (size_t)pa * CZ + 2 * q;
          float* db = static_cast<float*>(a.d_edge) + (size_t)pb * CZ + 2 * q;
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            if (va) *reinterpret_cast<float2*>(da + 8 * u) = make_float2(acc[4 * u], acc[4 * u + 1]);
            if (vb)
              *reinterpret_cast<float2*>(db + 8 * u) = make_float2(acc[4 * u + 2], acc[4 * u + 3]);
          }
        } else {
          bf16* da = static_cast<bf16*>(a.d_edge) + (size_t)pa * CZ + 2 * q;
          bf16* db = static_cast<bf16*>(a.d_edge) + (size_t)pb * CZ + 2 * q;
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            if (va) *reinterpret_cast<uint32_t*>(da + 8 * u) = pack_bf16(acc[4 * u], acc[4 * u + 1]);
            if (vb)
              *reinterpret_cast<uint32_t*>(db + 8 * u) = pack_bf16(acc[4 * u + 2], acc[4 * u + 3]);
          }
        }
        first = after(bits_of(acc[31]), a.zero);
      } else if (p == 1) {   // rows i_a (h = 0) and i_a + 1 (h = 1)
        float* d = a.rowpart + ((size_t)(t.b * L + i_a) * nbi + t.jb) * CZ + 8 * (g >> 1) + 2 * q +
                   (g & 1);
#pragma unroll
        for (int c = 0; c < 4; ++c) {   // row h = c / 2, blocks 4 (c % 2) + u
          float v[8];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int k = 4 * (4 * (c & 1) + u) + 2 * (c >> 1);
            v[2 * u] = acc[k];
            v[2 * u + 1] = acc[k + 1];
          }
          const float sum = quad_column_sum(v, lane);
          if (i_a + (c >> 1) < L) d[(size_t)(c >> 1) * nbi * CZ + 32 * (c & 1)] = sum;
          first = after(bits_of(sum), a.zero);
        }
      } else if (j < L) {
        const size_t slot = (size_t)(t.b * L + j) * (COL_SLOTS * nbi) + COL_SLOTS * t.ib + warp;
        float* d = a.colpart + slot * CZ + 2 * q;
#pragma unroll
        for (int u = 0; u < 8; ++u)
          *reinterpret_cast<float2*>(d + 8 * u) =
              make_float2(acc[4 * u] + acc[4 * u + 2], acc[4 * u + 1] + acc[4 * u + 3]);
      }
    }
    fence_regs(h);
    fence_regs(dp);
  }

  // This block's partial of the vectors: the eight warps' lanes summed in order.
  cp_async_wait_all();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem + S::C);   // [8 warps][VEC]
  float* mine = red + (wg * 4 + warp) * VEC;
  const int col = 8 * (g >> 1) + 2 * q + (g & 1);
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    mine[32 * c + col] = s_b1[c];
    mine[HID + 32 * c + col] = s_b2[c];
  }
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    mine[2 * HID + 32 * c + col] = s_b3[c];
    mine[2 * HID + CZ + 32 * c + col] = s_sc[c];
    mine[2 * HID + 2 * CZ + 32 * c + col] = s_bi[c];
  }
  __syncthreads();
  for (int c = tid; c < VEC; c += NT_C) {
    float s = 0.f;
    for (int w = 0; w < 8; ++w) s += red[w * VEC + c];
    a.vpart[(size_t)blockIdx.x * VEC + c] = s;
  }
}

struct WeightArgs {
  const bf16* edge;
  const bf16* node;
  const bf16* h1s;
  const bf16* rs;
  const bf16* dos;
  const bf16* da2s;
  const bf16* da1s;
  float* wpart;   // [n1][192 * 192] dW1 | [n2][192 * 192] dW2 | [n3][192 * 64] dW3
  int n1, n2, n3, L, nbi, ntiles;
};

// One chunk of tiles of one weight gradient: D[m][n] = sum over the pairs
// of A[p][m] B[p][n], A the 192-wide image (C gathered for dW1), B the N-wide
// one; warpgroup w computes rows 64w .. 64w + 63. NB is N / 64.
template <int NB>
__device__ __forceinline__ void weight_chunk(const WeightArgs& a, int kind, int z, int nch,
                                             float* __restrict__ out) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  const int tid = threadIdx.x, w = tid >> 7, wt = tid & 127;
  const int warp = wt >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int t0 = (int)((long long)a.ntiles * z / nch);
  const int t1 = (int)((long long)a.ntiles * (z + 1) / nch);
  const int n = t1 - t0;
  const bf16* A = kind == 1 ? a.h1s : a.rs;
  const bf16* Bm = kind == 0 ? a.da1s : kind == 1 ? a.da2s : a.dos;
  auto load = [&](int it) {   // tile t0 + it into stage it % NST
    const uint32_t st = base + (it % NST) * STAGE_W;
    const int t = t0 + it;
    if (kind == 0) gather(st, a.edge, a.node, tile_at(t, a.nbi), a.L, tid, NT_W);
    else copy_image(st, A + (size_t)t * (TILE_H / 2), TILE_H, tid, NT_W);
    copy_image(st + TILE_H, Bm + (size_t)t * (NB * PANEL / 2), NB * PANEL, tid, NT_W);
  };
#pragma unroll
  for (int it = 0; it < NST - 1; ++it) {
    if (it < n) load(it);
    cp_async_commit();
  }
  float acc[32 * NB];
#pragma unroll
  for (int k = 0; k < 32 * NB; ++k) acc[k] = 0.f;
  for (int it = 0; it < n; ++it) {
    cp_async_wait_group<NST - 2>();
    fence_proxy_async();
    __syncthreads();   // tile it has landed; every product of tile it - 1 has been waited for
    if (it + NST - 1 < n) load(it + NST - 1);
    cp_async_commit();
    const uint32_t st = base + (it % NST) * STAGE_W;
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < TM / 16; ++s) {
      const uint64_t da = desc_sw128_mn(st + w * PANEL + s * 2048, PANEL);
      const uint64_t db = desc_sw128_mn(st + TILE_H + s * 2048, PANEL);
      if constexpr (NB == 3) mma_ss_n192<1, 1>(acc, da, db, 1);
      else mma_ss_n64<1, 1>(acc, da, db, 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
  }
  cp_async_wait_all();
  constexpr int N = 64 * NB;
  float* o = out + (size_t)z * HID * N + (size_t)(64 * w + 16 * warp + g) * N + 2 * q;
#pragma unroll
  for (int jb = 0; jb < 8 * NB; ++jb) {
    *reinterpret_cast<float2*>(o + 8 * jb) = make_float2(acc[4 * jb], acc[4 * jb + 1]);
    *reinterpret_cast<float2*>(o + 8 * N + 8 * jb) = make_float2(acc[4 * jb + 2], acc[4 * jb + 3]);
  }
}

__global__ void __launch_bounds__(NT_W, 1)
edge_bwd_weight_kernel(const __grid_constant__ WeightArgs a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  if (smem_u32(smem) & 1023) __trap();
  const int z = blockIdx.x;
  if (z < a.n1) weight_chunk<3>(a, 0, z, a.n1, a.wpart);
  else if (z < a.n1 + a.n2) weight_chunk<3>(a, 1, z - a.n1, a.n2, a.wpart + (size_t)a.n1 * NW12);
  else weight_chunk<1>(a, 2, z - a.n1 - a.n2, a.n3, a.wpart + (size_t)(a.n1 + a.n2) * NW12);
}

// Every partial summed in a fixed order: dW1, dW2, dW3 over their chunks,
// the vectors over the chain kernel's blocks, d_node over its row slots
// then its column slots.
__global__ void edge_bwd_reduce_kernel(const float* __restrict__ wpart, int n1, int n2, int n3,
                                       const float* __restrict__ vpart, int nblocks,
                                       const float* __restrict__ rowpart,
                                       const float* __restrict__ colpart, int BL, int nbi,
                                       float* __restrict__ dw1, float* __restrict__ dw2,
                                       float* __restrict__ dw3, float* __restrict__ db1,
                                       float* __restrict__ db2, float* __restrict__ db3,
                                       float* __restrict__ dsc, float* __restrict__ dbi,
                                       float* __restrict__ d_node) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  constexpr int NW = 2 * NW12 + NW3;
  float s = 0.f;
  if (i < NW12) {
    for (int z = 0; z < n1; ++z) s += wpart[(size_t)z * NW12 + i];
    dw1[i] = s;
  } else if (i < 2 * NW12) {
    const float* p = wpart + (size_t)n1 * NW12 + (i - NW12);
    for (int z = 0; z < n2; ++z) s += p[(size_t)z * NW12];
    dw2[i - NW12] = s;
  } else if (i < NW) {
    const float* p = wpart + (size_t)(n1 + n2) * NW12 + (i - 2 * NW12);
    for (int z = 0; z < n3; ++z) s += p[(size_t)z * NW3];
    dw3[i - 2 * NW12] = s;
  } else if (i < NW + VEC) {
    const int v = (int)(i - NW);
    for (int b = 0; b < nblocks; ++b) s += vpart[(size_t)b * VEC + v];
    if (v < HID) db1[v] = s;
    else if (v < 2 * HID) db2[v - HID] = s;
    else if (v < 2 * HID + CZ) db3[v - 2 * HID] = s;
    else if (v < 2 * HID + 2 * CZ) dsc[v - 2 * HID - CZ] = s;
    else dbi[v - 2 * HID - 2 * CZ] = s;
  } else if (i < NW + VEC + (long long)BL * CZ) {
    const long long e = i - NW - VEC;
    const long long r = e / CZ;
    const int c = (int)(e - r * CZ);
    const float* rp = rowpart + (size_t)r * nbi * CZ + c;
    for (int k = 0; k < nbi; ++k) s += rp[(size_t)k * CZ];
    const float* cp = colpart + (size_t)r * COL_SLOTS * nbi * CZ + c;
    float sc = 0.f;
    for (int k = 0; k < COL_SLOTS * nbi; ++k) sc += cp[(size_t)k * CZ];
    d_node[e] = s + sc;
  }
}

constexpr int MAX_DEVICES = 64;
bool g_smem_opt_in[MAX_DEVICES];

}  // namespace

// Launches the three kernels on `stream`; returns the first non-zero
// cudaError_t (0 on success). Scratch and outputs come from the caller:
// the tile images h1s, rs, da2s, da1s (64 x 192 bf16 a tile) and dos (64 x
// 64) for ntiles = B * nbi^2 tiles (nbi = ceil(L/8)), vpart [grid][576]
// f32, wpart [n1 + n2][192*192] + [n3][192*64] f32, rowpart [B*L][nbi][64]
// and colpart [B*L][4 nbi][64] f32. w1t, w2t, w3t are the forward kernels'
// bf16 weights transposed to [out][in].
extern "C" int edge_transition_backward(
    const void* edge, const void* node, const void* mask, const void* g, const void* w1t,
    const void* b1, const void* w2t, const void* b2, const void* w3t, const void* b3,
    const void* ln_s, void* h1s, void* rs, void* dos, void* da2s, void* da1s, void* vpart,
    void* wpart, void* rowpart, void* colpart, void* d_edge, void* d_node, void* dw1, void* db1,
    void* dw2, void* db2, void* dw3, void* db3, void* dsc, void* dbi, int B, int L, int grid,
    int n1, int n2, int n3, int d_edge_f32, float eps, void* stream) {
  const long long total = (long long)B * L * L;
  if (total > INT_MAX) return (int)cudaErrorInvalidValue;   // pair rows are 32-bit
  if (total == 0 || grid < 1 || n1 < 1 || n2 < 1 || n3 < 1) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!g_smem_opt_in[dev]) {
    err = cudaFuncSetAttribute(edge_bwd_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               ChainSmem::BYTES);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(edge_bwd_weight_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               WEIGHT_SMEM);
    if (err != cudaSuccess) return (int)err;
    g_smem_opt_in[dev] = true;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nbi = (L + TI - 1) / TI, ntiles = B * nbi * nbi;
  const bf16* e = static_cast<const bf16*>(edge);
  const bf16* n = static_cast<const bf16*>(node);

  ChainArgs ca{e, n, static_cast<const float*>(mask), static_cast<const bf16*>(g),
               static_cast<const bf16*>(w1t), static_cast<const float*>(b1),
               static_cast<const bf16*>(w2t), static_cast<const float*>(b2),
               static_cast<const bf16*>(w3t), static_cast<const float*>(b3),
               static_cast<const float*>(ln_s), static_cast<bf16*>(h1s), static_cast<bf16*>(rs),
               static_cast<bf16*>(dos), static_cast<bf16*>(da2s), static_cast<bf16*>(da1s),
               static_cast<float*>(vpart), static_cast<float*>(rowpart),
               static_cast<float*>(colpart), d_edge, d_edge_f32, L, nbi, ntiles, eps, 0u};
  edge_bwd_chain_kernel<<<grid, NT_C, ChainSmem::BYTES, s>>>(ca);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  WeightArgs wa{e, n, static_cast<const bf16*>(h1s), static_cast<const bf16*>(rs),
                static_cast<const bf16*>(dos), static_cast<const bf16*>(da2s),
                static_cast<const bf16*>(da1s), static_cast<float*>(wpart), n1, n2, n3, L, nbi,
                ntiles};
  edge_bwd_weight_kernel<<<n1 + n2 + n3, NT_W, WEIGHT_SMEM, s>>>(wa);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const long long nout = 2LL * NW12 + NW3 + VEC + (long long)B * L * CZ;
  edge_bwd_reduce_kernel<<<(unsigned)((nout + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(wpart), n1, n2, n3, static_cast<const float*>(vpart), grid,
      static_cast<const float*>(rowpart), static_cast<const float*>(colpart), B * L, nbi,
      static_cast<float*>(dw1), static_cast<float*>(dw2), static_cast<float*>(dw3),
      static_cast<float*>(db1), static_cast<float*>(db2), static_cast<float*>(db3),
      static_cast<float*>(dsc), static_cast<float*>(dbi), static_cast<float*>(d_node));
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- 2x, 4x, 8x
// K4 at c_z = 128, 256, 512 (hidden 3 c_z): the recomputing backward of
// the same function as the kernels above, as launches of csrc/wide_gemm.cuh's
// tiled GEMM, two row kernels and fixed-order reductions, since neither
// the weights nor a tile's hidden rows fit a block any more. With x = [e |
// n_i | n_j] read in place by the GEMMs:
//   a1 = e.W1e + Y_i + Y_j + b1 (Y = node.[W1i | W1j], once a residue);
//   h1 = bf16(relu(a1))                                   (scratch h1c)
//   a2 = h1.W2 + b2; r = bf16(relu(a2) + x), a2 > 0 kept as bytes
//   o = r.W3 + b3 (fp32); LayerNorm backward a pair row: do = bf16(...),
//       with one partial row a block of sum(do), sum(g y), sum(g)
//   da2 = (do.W3^T) [a2 > 0] -> bf16, its column sums a block row (db2)
//   da1 = (da2.W2^T) [h1 > 0] -> bf16, its column sums (db1)
//   dx = [da1 | do].[W1 ; W3]^T: d_edge its first c_z columns, the node
//       columns to a fp32 scratch summed over j and i (d_node)
//   dW1 = x^T.da1, dW2 = h1^T.da2, dW3 = r^T.do over the pairs, split in
//       K slices (ks1..ks3 pairs each) whose fp32 partial slots are added
//       in slot order.
// Every cross-block sum goes through partials added in a fixed order, so
// two calls give the same bits, as the 1x kernels' do. What bounds it: the
// tensor cores (bounds.py); this design also does dx and dW1 over the whole
// 3 c_z-wide x (the bound counts their node rows once a residue).

namespace wide {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

constexpr int LN_WARPS = 4, LN_ROWS = 32;   // rows of a warp; a block's rows: 128

// LayerNorm backward, one warp a pair row: do = bf16((dy - mean(dy) - y
// mean(dy y)) / sigma) with dy = g s_i s_j ln_scale; each block writes one
// partial row [sum do | sum g_out y | sum g_out] of its 128 rows, rows in
// order within a warp and warps in order.
template <int NQ>
__global__ void __launch_bounds__(LN_WARPS * 32)
wide_ln_bwd_kernel(const float* __restrict__ o, const bf16* __restrict__ g,
                   const float* __restrict__ mask, const float* __restrict__ ln_s,
                   bf16* __restrict__ doc, float* __restrict__ part, int M, int L, float eps) {
  constexpr int CZ = NQ * 32;
  __shared__ float red[LN_WARPS][3 * CZ];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  float s_do[NQ], s_gy[NQ], s_g[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) s_do[q] = s_gy[q] = s_g[q] = 0.f;
  const int r0 = (blockIdx.x * LN_WARPS + w) * LN_ROWS;
  for (int rr = 0; rr < LN_ROWS; ++rr) {
    const int r = r0 + rr;
    if (r >= M) break;
    const float* row = o + (long long)r * CZ;
    float y[NQ], s = 0.f;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      y[q] = row[lane + 32 * q];
      s += y[q];
    }
    const float mu = warp_sum(s) / CZ;
    float ss = 0.f;
#pragma unroll
    for (int q = 0; q < NQ; ++q) ss += (y[q] - mu) * (y[q] - mu);
    const float inv = rsqrtf(warp_sum(ss) / CZ + eps);
    const float m = mask[src_row(NODE_I, r, L)] * mask[src_row(NODE_J, r, L)];
    float go[NQ], dy[NQ], sdy = 0.f, sdyy = 0.f;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int c = lane + 32 * q;
      y[q] = (y[q] - mu) * inv;
      go[q] = __bfloat162float(g[(long long)r * CZ + c]) * m;
      dy[q] = go[q] * ln_s[c];
      sdy += dy[q];
      sdyy += dy[q] * y[q];
    }
    const float mdy = warp_sum(sdy) / CZ, mdyy = warp_sum(sdyy) / CZ;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int c = lane + 32 * q;
      const float d = (dy[q] - mdy - y[q] * mdyy) * inv;
      doc[(long long)r * CZ + c] = __float2bfloat16(d);
      s_do[q] += d;
      s_gy[q] += go[q] * y[q];
      s_g[q] += go[q];
    }
  }
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const int c = lane + 32 * q;
    red[w][c] = s_do[q];
    red[w][CZ + c] = s_gy[q];
    red[w][2 * CZ + c] = s_g[q];
  }
  __syncthreads();
  for (int t = threadIdx.x; t < 3 * CZ; t += LN_WARPS * 32) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < LN_WARPS; ++k) s += red[k][t];
    part[(long long)blockIdx.x * 3 * CZ + t] = s;
  }
}

// d_node[b L + n][c] = sum_j dxn[(b L + n) L + j][c] + sum_i dxn[(b L + i) L + n][cz + c],
// each sum in order of j (i).
__global__ void __launch_bounds__(256)
wide_node_reduce_kernel(const float* __restrict__ dxn, float* __restrict__ d_node, int B, int L,
                        int cz) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)B * L * cz) return;
  const int c = (int)(t % cz), n = (int)(t / cz), b = n / L, i = n % L;
  const long long ld = 2LL * cz;
  float s = 0.f, s2 = 0.f;
  for (int j = 0; j < L; ++j) s += dxn[((long long)n * L + j) * ld + c];
  for (int j = 0; j < L; ++j) s2 += dxn[((long long)(b * L + j) * L + i) * ld + cz + c];
  d_node[t] = s + s2;
}

static int edge_backward(const void* edge, const void* node, const void* mask, const void* g,
                         const void* wn, const void* w1t, const void* b1, const void* w2t,
                         const void* b2, const void* w3t, const void* b3, const void* ln_s,
                         const void* k1b, const void* k2b, const void* k3b, void* y, void* h1c,
                         void* rc, void* m2, void* o, void* doc, void* da2c, void* da1c,
                         void* dxn, void* lnpart, void* colpart1, void* colpart2, void* wpart1,
                         void* wpart2, void* wpart3, void* d_edge, void* d_node, void* dk1,
                         void* db1, void* dk2, void* db2, void* dk3, void* db3, void* dln_s,
                         void* dln_b, int B, int L, int cz, int ks1, int ks2, int ks3,
                         int d_edge_f32, float eps, cudaStream_t st) {
  const long long total = (long long)B * L * L;
  if (total > INT_MAX) return (int)cudaErrorInvalidValue;   // pair rows are 32-bit
  if (cz != 128 && cz != 256 && cz != 512) return (int)cudaErrorInvalidValue;
  if (total == 0 || ks1 < 1 || ks2 < 1 || ks3 < 1) return (int)cudaErrorInvalidValue;
  const int M = (int)total, hid = 3 * cz, ny = 2 * hid;
  float* Y = static_cast<float*>(y);
  const Opd x = opd(seg(edge, cz), seg(node, cz, cz, NODE_I), seg(node, cz, 2 * cz, NODE_J));
  // Recompute: Y, h1, r (and a2 > 0), o.
  Epi e{};
  e.f32 = Y;
  e.ld_f32 = ny;
  WIDE_TRY((gemm<128, 128, false, F32>(opd(seg(node, cz)), opd(seg(wn, cz)), B * L, ny, cz, 0, L,
                                       e, st)));
  e = Epi{};
  e.out = static_cast<bf16*>(h1c);
  e.ld_out = hid;
  e.bias = static_cast<const float*>(b1);
  e.yi = Y;
  e.yj = Y + hid;
  e.ld_y = ny;
  WIDE_TRY((gemm<128, 128, false, RELU>(opd(seg(edge, cz)), opd(seg(w1t, hid)), M, hid, cz, 0, L,
                                        e, st)));
  e = Epi{};
  e.out = static_cast<bf16*>(rc);
  e.ld_out = hid;
  e.bias = static_cast<const float*>(b2);
  e.mask_out = static_cast<uint8_t*>(m2);
  e.x = x;
  WIDE_TRY((gemm<128, 128, false, RC>(opd(seg(h1c, hid)), opd(seg(w2t, hid)), M, hid, hid, 0, L,
                                      e, st)));
  e = Epi{};
  e.f32 = static_cast<float*>(o);
  e.ld_f32 = cz;
  e.bias = static_cast<const float*>(b3);
  WIDE_TRY((gemm<128, 128, false, F32>(opd(seg(rc, hid)), opd(seg(w3t, hid)), M, cz, hid, 0, L,
                                       e, st)));
  // LayerNorm backward.
  const int nln = (M + LN_WARPS * LN_ROWS - 1) / (LN_WARPS * LN_ROWS);
  const float* of = static_cast<const float*>(o);
  const bf16* gb = static_cast<const bf16*>(g);
  const float* mk = static_cast<const float*>(mask);
  const float* sc = static_cast<const float*>(ln_s);
  bf16* dob = static_cast<bf16*>(doc);
  float* lp = static_cast<float*>(lnpart);
  if (cz == 128) wide_ln_bwd_kernel<4><<<nln, LN_WARPS * 32, 0, st>>>(of, gb, mk, sc, dob, lp, M, L, eps);
  else if (cz == 256) wide_ln_bwd_kernel<8><<<nln, LN_WARPS * 32, 0, st>>>(of, gb, mk, sc, dob, lp, M, L, eps);
  else wide_ln_bwd_kernel<16><<<nln, LN_WARPS * 32, 0, st>>>(of, gb, mk, sc, dob, lp, M, L, eps);
  WIDE_TRY(launched());
  // da2 = (do.W3^T)[a2 > 0], da1 = (da2.W2^T)[h1 > 0], with their column sums.
  e = Epi{};
  e.out = static_cast<bf16*>(da2c);
  e.ld_out = hid;
  e.mask_in = static_cast<const uint8_t*>(m2);
  e.colpart = static_cast<float*>(colpart2);
  WIDE_TRY((gemm<128, 128, false, DA>(opd(seg(doc, cz)), opd(seg(k3b, cz)), M, hid, cz, 0, L, e,
                                      st)));
  e = Epi{};
  e.out = static_cast<bf16*>(da1c);
  e.ld_out = hid;
  e.hmask = static_cast<const bf16*>(h1c);
  e.colpart = static_cast<float*>(colpart1);
  WIDE_TRY((gemm<128, 128, false, DA>(opd(seg(da2c, hid)), opd(seg(k2b, hid)), M, hid, hid, 0, L,
                                      e, st)));
  // dx = da1.W1^T + do.W3^T: d_edge and the node columns.
  e = Epi{};
  e.d_edge = d_edge;
  e.d_edge_f32 = d_edge_f32;
  e.cz = cz;
  e.f32 = static_cast<float*>(dxn);
  WIDE_TRY((gemm<128, 128, false, DX>(opd(seg(da1c, hid), seg(doc, cz, hid)),
                                      opd(seg(k1b, hid), seg(k3b, cz, hid)), M, hid, hid + cz, 0,
                                      L, e, st)));
  const long long nn = (long long)B * L * cz;
  wide_node_reduce_kernel<<<(unsigned)((nn + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(dxn), static_cast<float*>(d_node), B, L, cz);
  WIDE_TRY(launched());
  // Weight gradients over the pairs, in K slices, then the slots in order.
  e = Epi{};
  e.f32 = static_cast<float*>(wpart1);
  WIDE_TRY((gemm<128, 128, true, PART>(x, opd(seg(da1c, hid)), hid, hid, M, ks1, L, e, st)));
  e.f32 = static_cast<float*>(wpart2);
  WIDE_TRY((gemm<128, 128, true, PART>(opd(seg(h1c, hid)), opd(seg(da2c, hid)), hid, hid, M, ks2,
                                       L, e, st)));
  e.f32 = static_cast<float*>(wpart3);
  WIDE_TRY((gemm<128, 128, true, PART>(opd(seg(rc, hid)), opd(seg(doc, cz)), hid, cz, M, ks3, L,
                                       e, st)));
  const int nblk = (M + 127) / 128;
  WIDE_TRY(reduce(static_cast<const float*>(wpart1), static_cast<float*>(dk1), (M + ks1 - 1) / ks1,
                  (long long)hid * hid, hid * hid, st));
  WIDE_TRY(reduce(static_cast<const float*>(wpart2), static_cast<float*>(dk2), (M + ks2 - 1) / ks2,
                  (long long)hid * hid, hid * hid, st));
  WIDE_TRY(reduce(static_cast<const float*>(wpart3), static_cast<float*>(dk3), (M + ks3 - 1) / ks3,
                  (long long)hid * cz, hid * cz, st));
  WIDE_TRY(reduce(static_cast<const float*>(colpart1), static_cast<float*>(db1), nblk, hid, hid,
                  st));
  WIDE_TRY(reduce(static_cast<const float*>(colpart2), static_cast<float*>(db2), nblk, hid, hid,
                  st));
  WIDE_TRY(reduce(lp, static_cast<float*>(db3), nln, 3 * cz, cz, st));
  WIDE_TRY(reduce(lp + cz, static_cast<float*>(dln_s), nln, 3 * cz, cz, st));
  return reduce(lp + 2 * cz, static_cast<float*>(dln_b), nln, 3 * cz, cz, st);
}

}  // namespace wide

// Device launches of one call of edge_transition_wide_backward.
extern "C" int edge_transition_wide_bwd_kernels_per_call() { return 20; }

// K4 at c_z = cz in {128, 256, 512}. Weights: wn [2 hid][cz] (the node rows
// of k1 transposed, [W1i | W1j]^T), w1t, w2t, w3t as for the forward, k1b
// [hid][hid], k2b [hid][hid], k3b [hid][cz] the bf16 weights as stored
// ([in][out]). Scratch, for M = B L L pairs: y [B L][2 hid] f32; h1c, rc,
// da2c, da1c [M][hid] bf16; m2 [M][hid] bytes; o [M][cz] f32; doc [M][cz]
// bf16; dxn [M][2 cz] f32; lnpart [ceil(M / 128)][3 cz], colpart1,
// colpart2 [ceil(M / 128)][hid] f32; wpart1, wpart2 [ceil(M / ks)][hid][hid]
// and wpart3 [ceil(M / ks3)][hid][cz] f32, ks1..ks3 multiples of 64. Returns
// the first nonzero cudaError_t of its launches.
extern "C" int edge_transition_wide_backward(
    const void* edge, const void* node, const void* mask, const void* g, const void* wn,
    const void* w1t, const void* b1, const void* w2t, const void* b2, const void* w3t,
    const void* b3, const void* ln_s, const void* k1b, const void* k2b, const void* k3b, void* y,
    void* h1c, void* rc, void* m2, void* o, void* doc, void* da2c, void* da1c, void* dxn,
    void* lnpart, void* colpart1, void* colpart2, void* wpart1, void* wpart2, void* wpart3,
    void* d_edge, void* d_node, void* dk1, void* db1, void* dk2, void* db2, void* dk3, void* db3,
    void* dln_s, void* dln_b, int B, int L, int cz, int ks1, int ks2, int ks3, int d_edge_f32,
    float eps, void* stream) {
  return wide::edge_backward(edge, node, mask, g, wn, w1t, b1, w2t, b2, w3t, b3, ln_s, k1b, k2b,
                             k3b, y, h1c, rc, m2, o, doc, da2c, da1c, dxn, lnpart, colpart1,
                             colpart2, wpart1, wpart2, wpart3, d_edge, d_node, dk1, db1, dk2, db2,
                             dk3, db3, dln_s, dln_b, B, L, cz, ks1, ks2, ks3, d_edge_f32, eps,
                             static_cast<cudaStream_t>(stream));
}

// Kernels launched on the wide paths since the library was loaded.
extern "C" int edge_transition_bwd_wide_launches() { return wide::g_launches.load(); }
