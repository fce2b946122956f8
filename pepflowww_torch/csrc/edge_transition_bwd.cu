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

#ifdef EDGE_BWD_STAMPS
#define TILE_STAMPS   // the wide chain kernel's ring sums its waits (hopper_tile.cuh)
#endif

#include "edge_wide.cuh"   // with wgmma.cuh, wide_gemm.cuh and hopper_tile.cuh

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
// K4 at c_z = CZ = 128, 256, 512 (hidden HID = 3 CZ): the same function as
// the kernels above (pepflowww_tpu/models/pallas_edge_bwd.py:148 at those
// widths), redesigned on the forward's tile core (edge_wide.cuh,
// hopper_tile.cuh), since neither the weights nor a tile's hidden rows fit
// one block any more. Four device kernels a call:
//  1. the node pre-pass Y = node.[W1i | W1j] (wide_gemm.cuh, fp32, under 1%
//     of the work), as the forward has it;
//  2. ebwd_chain_kernel: hopper_tile.cuh's block (a producer warpgroup
//     copying 16 KB weight stages into an mbarrier ring, two consumer
//     warpgroups on wgmma, a persistent grid), both consumers on the same
//     64 pair rows, each on half of every product's columns. A tile:
//       a1 = e.W1e + Y1_i + Y1_j + b1, h1 = bf16(relu(a1)), a1 > 0 as bits;
//       a2 = h1.W2 + b2, r = bf16(relu(a2) + [e | n_i | n_j]), a2 > 0 as
//         bits, a 128-column chunk at a time; o = b3 + r.W3;
//       the LayerNorm backward on o parked in the tile's da1 image and g
//         gathered into shared memory (row statistics through shared
//         memory): do, and the column sums of do, g_out y, g_out;
//       dr = bf16(do).W3^T and da2 = dr [a2 > 0] a chunk at a time, its
//         column sums; dh1 = bf16(da2).W2^T and da1 = dh1 [a1 > 0], its
//         column sums; d_edge = bf16(do).W3e^T + bf16(da1).W1e^T, written
//         straight to its output.
//     h1 and da2 stay in shared memory at 2x and 4x, and r and da1 a chunk
//     at a time, each followed by the products that read it. At 8x (64 rows
//     of a hidden row are 196 KB) h1, r, da2 and da1 round-trip: the
//     producer copies the tile's own image back as the A operand of the next
//     product, as the forward does with h1, and o and d_edge are a 64-column
//     block at a time after every chunk, so that no thread holds them whole
//     (held whole, ptxas serialized every wgmma of the kernel). No fp32 o,
//     dx or byte mask reaches device memory: only bf16 images of what the
//     weight pass reads (h1, r, da2, da1, do, each a tile's 128-byte swizzled
//     panels; bulk copies of the shared-memory panels below 8x) and
//     fixed-order partials;
//  3. ebwd_weight_kernel: dW1e = e^T.da1, dW2 = h1^T.da2 and dW3 = r^T.do
//     over the pairs on wgmma, both operands MN-major from shared memory
//     (a ring of cp.async stages, the images copied as they lie), the pairs
//     cut in K slices with one fp32 partial slot each; and, in other
//     blocks, the per-residue sums S = sum_j da1, sum_i da1, T = sum_j do,
//     sum_i do from the images (each in a fixed order);
//  4. ebwd_reduce_kernel: the slots, the chain's column sums and, in fp32,
//     the node gradients from the per-residue sums, which the linearity of
//     dx = da1.W1^T + do.W3^T gives: d_node_i = S_i.W1i^T + T_i.W3i^T (the
//     j side alike), and dW1's node rows node^T.S_i, node^T.S_j (B L rows of
//     work, not B L^2).
// Every cross-block sum goes through partials added in a fixed order (no
// float atomics): two calls give the same bits. What bounds it: the tensor
// cores (bounds.py: 393.8 / 787.7 / 787.7 us at B = 64 / 32 / 8, L = 64);
// the design moves the images twice (written, read), ~2.0 GB a call at 2x.

namespace ebwd {

using namespace hopper;
using tile::PIECE;
typedef __nv_bfloat16 bf16;
using ewide::bf16_at;
using ewide::tid_x;
// A tile's 64 pair rows, the shared memory a block may use, the ring's most
// stages and the consumers' named barrier (256 threads; 2, 3 a warpgroup's
// own): the forward's.
using ewide::BAR_ID;
using ewide::MAX_STAGES;
using ewide::SMEM_LIMIT;
using ewide::TM;

// Built with -DEDGE_BWD_STAMPS (a diagnostic build: pepflowww_torch.edge_stages),
// consumer thread 0 of each chain block sums the SM clock cycles of
// each step of its tiles and the cycles it waited for full ring slots into
// g_stamps[block][N_STAMPS], and the entry point records an event around
// each of its four kernels (edge_bwd_read_stamps, edge_bwd_read_event_ms).
#ifdef EDGE_BWD_STAMPS
constexpr int N_STAMPS = 10;   // e gather, h1, a2/r/o, LayerNorm, dr/da2, d_edge init,
                               // dh1/da1/d_edge, d_edge out, waits, tiles
constexpr int MAX_BLOCKS = 1024;
__device__ long long g_stamps[MAX_BLOCKS * N_STAMPS];
#define BSTAMP(k)                         \
  do {                                    \
    const long long now_ = clock64();     \
    stamps[k] += now_ - last_;            \
    last_ = now_;                         \
  } while (0)
#else
#define BSTAMP(k) \
  do {            \
  } while (0)
#endif

struct Args {
  const bf16* edge;          // [M][CZ]
  const bf16* node;          // [B L][CZ]
  const float* mask;         // [B L]
  const bf16* g;             // [M][CZ]
  const float* y;            // [B L][2 HID]: Y1_i | Y1_j
  const unsigned char* wb;   // the stages (cuda_edge.wide_bwd_stages)
  const float* b1;
  const float* b2;
  const float* b3;
  const float* ln_s;
  // The tiles' bf16 images, tile t at t (W / 64) PIECE bytes, W its width:
  // h1, r, da2, da1 (HID), do (CZ).
  unsigned char* h1i;
  unsigned char* ri;
  unsigned char* da2i;
  unsigned char* da1i;
  unsigned char* doi;
  float* vpart;              // [grid][VW]: d_b1 | d_b2 | d_b3 | d_ln_scale | d_ln_bias
  int* tickets;              // the reduction's tickets, zeroed here (block 0)
  int ntickets;
  void* d_edge;              // [M][CZ], fp32 (d_edge_f32) or bf16
  int d_edge_f32, L, total;
  float eps;
};

template <int CZ>
struct Cfg {
  static constexpr int HID = 3 * CZ, NY = 2 * HID;
  static constexpr int NJ = CZ / 128;   // 64-column blocks of o (d_edge) a consumer warpgroup owns
  static constexpr int KE = CZ / 64;    // K panels of e and do
  static constexpr int NC = HID / 128;  // hidden chunks of 128 columns
  static constexpr int KH = HID / 64;   // K panels of a hidden row
  static constexpr int VW = 2 * HID + 3 * CZ;
  // At 8x h1, r, da2 and da1 round-trip through their images (64 rows of
  // each are 196 KB): the producer copies them back panel by panel as the A
  // operands of a2 = h1.W2, o = r.W3 and d_edge += da1.W1e^T (o and d_edge
  // a 64-column block at a time, after every chunk of r, da1) and dh1 =
  // da2.W2^T.
  static constexpr bool STREAM = CZ == 512;
  static constexpr int NCB = CZ == 256 ? 1 : 2;   // chunk buffers (one at 4x: ring room)
  static constexpr int A_BYTES = STREAM ? PIECE : 0;
  static constexpr int STAGE = A_BYTES + 2 * PIECE;
  // Per-tile stages: a1; per chunk of a2 KH of W2 and 2 NJ of W3 (at 8x
  // every chunk's W2, then o's blocks' W3 over KH); dr; the d_edge init; per
  // chunk of dh1 KH of W2^T and 2 NJ of W1e^T (at 8x every chunk's W2^T,
  // then for each block of d_edge its init's KE and its W1e^T over KH).
  static constexpr int N_A1 = NC * KE, N_HID = NC * (KH + 2 * NJ), N_DR = NC * KE,
                       N_DE = NJ * KE;
  static constexpr int N_MAIN = N_A1 + N_HID + N_DR + N_DE + N_HID;
  // Shared memory (bytes): e (then do) panels, the hidden panels (h1, then
  // da2; not at 8x), the chunk buffers (r, then da1), the a1 > 0 and a2 > 0
  // bits [2][NC][256] u32, the LayerNorm's exchanges [4][2][64] f32, the
  // ring and its barriers. The column sums' exchange (16 KB) takes the chunk
  // buffers in steps 3 and 4 and the e panels in step 6.
  static constexpr int E = 0;
  static constexpr int H = E + KE * PIECE;
  static constexpr int H_BYTES = STREAM ? 0 : KH * PIECE;
  static constexpr int CB = H + H_BYTES;
  static constexpr int MASK = CB + NCB * 2 * PIECE;
  static constexpr int XRED = MASK + 2 * NC * 256 * 4;
  static constexpr int RING = XRED + 4 * 2 * TM * 4;
  static constexpr int NSTAGE = (SMEM_LIMIT - RING - 256) / STAGE < MAX_STAGES
                                    ? (SMEM_LIMIT - RING - 256) / STAGE
                                    : MAX_STAGES;
  static constexpr int BAR = RING + NSTAGE * STAGE;
  static constexpr int BYTES = BAR + 256;
  static_assert(H % 1024 == 0 && CB % 1024 == 0 && RING % 1024 == 0 && STAGE % 1024 == 0,
                "swizzled panels start on 1024-byte boundaries");
  static_assert(NSTAGE >= 3, "a ring of at least three stages");
  static_assert(NCB * 2 * PIECE >= 2 * 32 * 64 * 4 && KE * PIECE >= 2 * 32 * 64 * 4,
                "room for the column sums' exchange");
  static_assert(BYTES <= SMEM_LIMIT, "more shared memory than a block may use");
};

__device__ __forceinline__ uint32_t ld_shared_u32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

// Below 8x the images of h1, r, do, da2 and da1 leave from the shared-memory
// panels that hold them (a tile's image is those panels as they lie), by
// one bulk copy a buffer that one consumer thread issues once the panels
// are complete (after the barrier and proxy fence that precede their
// products); before a buffer is written again that thread waits until the
// copies have read it (a barrier follows).
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               "cp.async.bulk.commit_group;\n" ::"l"(dst),
               "r"(src), "r"(bytes)
               : "memory");
}
// Waits until all but the N most recent bulk copies have read their source.
template <int N = 0>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Column sums of a consumer warpgroup's 64 columns over the tile's 64
// rows, through `x` ([32 row groups][64] f32 in shared memory, this
// warpgroup's, in a buffer free at that point): colsum_put stores this
// thread's columns 8 jj + 2q, + 1 (its two rows added) at its row group 8
// warp + g, a column pair at a time so that two values are live;
// colsum_flush then adds, for each column, the 32 row groups in order to
// vp[0, 64) (the block's running sums), by the first 64 threads of the
// warpgroup, which alone read and write those entries, between two barriers
// of the warpgroup (the second frees x for the next sums).
__device__ __forceinline__ void colsum_put(float* x, int jj, float v0, float v1) {
  const int t = tid_x();
  *reinterpret_cast<float2*>(x + (((t >> 5) & 3) * 8 + ((t & 31) >> 2)) * 64 + 8 * jj +
                             2 * (t & 3)) = make_float2(v0, v1);
}
__device__ __forceinline__ void colsum_flush(const float* x, float* vp) {
  const int bar = 2 + ((tid_x() - 128) >> 7), wt = tid_x() & 127;
  named_bar(bar, 128);
  if (wt < 64) {
    float s = x[wt];
#pragma unroll 8
    for (int k = 1; k < 32; ++k) s += x[64 * k + wt];
    vp[wt] += s;
  }
  named_bar(bar, 128);
}

template <int CZ>
struct Chain {
  using C = Cfg<CZ>;
  using Ring = tile::Ring<C::NSTAGE, C::STAGE, C::RING, C::BAR>;
  // Layer 1's node terms loaded ahead of its products where registers allow.
  static constexpr bool PREFETCH = C::NJ <= 2;

  template <int NK, class AAddr>
  static __device__ __forceinline__ void product(float (&acc)[32], Ring& ring, int cw,
                                                 AAddr a_addr, bool accumulate) {
    ewide::ring_product<false, NK, C::A_BYTES>(acc, ring, cw, a_addr, accumulate);
  }

  // The producer's one thread: every tile's stages, in the consumers'
  // order; at 8x the stages of a2, o and dh1 also carry the tile's h1, r and
  // da2 images panel by panel as their A pieces, each once the consumers
  // have written it (the ready barrier, three phases a tile).
  static __device__ __forceinline__ void produce(const Args& a, Ring& ring, int ntiles) {
    uint32_t phase = 0;   // the ready barrier's phases so far
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      const unsigned char* w = a.wb;
      auto copy_b = [&](int n) {
        for (int i = 0; i < n; ++i) {
          const int s = ring.claim(2 * PIECE);
          tile::bulk_copy(ring.stage(s) + C::A_BYTES, w, 2 * PIECE, ring.full(s));
          w += 2 * PIECE;
        }
      };
      // KH stages with the tile's image `img` as their A pieces, once written.
      auto copy_a = [&](const unsigned char* img) {
        const unsigned char* src = img + (size_t)t * C::KH * PIECE;
        for (int k = 0; k < C::KH; ++k) {
          const int s = ring.claim(C::STAGE);
          tile::bulk_copy(ring.stage(s), src + k * PIECE, PIECE, ring.full(s));
          tile::bulk_copy(ring.stage(s) + PIECE, w, 2 * PIECE, ring.full(s));
          w += 2 * PIECE;
        }
      };
      const auto ready = [&] { tile::mbar_wait(ring.ready(), phase++ & 1u); };
      copy_b(C::N_A1);
      if constexpr (C::STREAM) {
        ready();   // h1
        for (int c = 0; c < C::NC; ++c) copy_a(a.h1i);
        ready();   // r
        for (int j = 0; j < C::NJ; ++j) copy_a(a.ri);
        copy_b(C::N_DR);
        ready();   // da2
        for (int c = 0; c < C::NC; ++c) copy_a(a.da2i);
        ready();   // da1
        for (int j = 0; j < C::NJ; ++j) {
          copy_b(C::KE);
          copy_a(a.da1i);
        }
      } else {
        copy_b(C::N_HID + C::N_DR + C::N_DE + C::N_HID);
      }
    }
  }

  // The two consumer warpgroups (cw = 0, 1): every tile of this block.
  static __device__ __forceinline__ void consume(const Args& a, Ring& ring, unsigned char* smem,
                                                 uint32_t base) {
    // The thread's indices, read afresh where they are used (tid_x), as in
    // the forward: the consumer thread (0..255), its warpgroup, its quad
    // lane and its two tile rows 16 w + g and + 8.
    const auto ct = [] { return tid_x() - 128; };
    const auto cw = [] { return (tid_x() - 128) >> 7; };
    const auto q = [] { return tid_x() & 3; };
    const auto ra = [] { return 16 * ((tid_x() >> 5) & 3) + ((tid_x() & 31) >> 2); };
    const auto rb = [] { return 16 * ((tid_x() >> 5) & 3) + ((tid_x() & 31) >> 2) + 8; };
    // Addresses are formed where used (a few integer operations), so that
    // no register holds them through a tile's products.
    const uint32_t E = base + C::E, H = base + C::H, CB = base + C::CB;
    // This thread's a1 > 0 (a2 > 0) bits of chunk c: [NC][256] u32.
    const auto mask1 = [=](int c) { return reinterpret_cast<uint32_t*>(smem + C::MASK) + c * 256; };
    const auto mask2 = [=](int c) { return mask1(C::NC + c); };
    const auto xred = [=](int k) { return reinterpret_cast<float*>(smem + C::XRED) + k * 2 * TM; };
    // This warpgroup's column-sum exchange in the chunk buffers, in the e panels.
    const auto xcb = [=] { return reinterpret_cast<float*>(smem + C::CB) + cw() * 2048; };
    const auto xe = [=] { return reinterpret_cast<float*>(smem + C::E) + cw() * 2048; };
    const auto vp = [&] { return a.vpart + (size_t)blockIdx.x * C::VW; };
    for (int i = ct(); i < C::VW; i += 256) vp()[i] = 0.f;
    if (blockIdx.x == 0)
      for (int i = ct(); i < a.ntickets; i += 256) a.tickets[i] = 0;
#ifdef EDGE_BWD_STAMPS
    long long stamps[N_STAMPS] = {}, last_ = clock64();
#endif
    const int ntiles = (a.total + TM - 1) / TM;
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      const int row0 = t * TM;
      if (ct() == 0) bulk_wait_read();   // the last tile's image copies have read their panels
      named_bar(BAR_ID, 256);   // the last tile's readers of every buffer are done
      ewide::gather_e<CZ>(E, a.edge, row0, a.total, ct());
      cp_async_commit();
      const auto na = [&] { return ewide::residues(row0 + ra(), a.total, a.L); };
      const auto nb = [&] { return ewide::residues(row0 + rb(), a.total, a.L); };
      const auto yi = [&](int n, int c) { return a.y + (size_t)n * C::NY + c; };
      // This tile's panel p of an image of `panels` panels a tile.
      const auto img = [&](unsigned char* im, int panels, int p) {
        return im + ((size_t)t * panels + p) * PIECE;
      };
      const auto e_panel = [&](int k, int) { return E + k * PIECE; };
      // Whether this thread issues the tile's bulk image copies.
      const auto issuer = [&] { return ct() == 0; };
      const auto store2 = [&](unsigned char* im, uint32_t sm, int jj, uint32_t va, uint32_t vb,
                              bool to_smem) {
        if (!to_smem) {   // the image from registers; else by a bulk copy of the panels
          *reinterpret_cast<uint32_t*>(im + bf16_at(ra(), jj, q())) = va;
          *reinterpret_cast<uint32_t*>(im + bf16_at(rb(), jj, q())) = vb;
        } else {
          ewide::st_shared_u32(sm + bf16_at(ra(), jj, q()), va);
          ewide::st_shared_u32(sm + bf16_at(rb(), jj, q()), vb);
        }
      };
      cp_async_wait_all();
      fence_proxy_async();
      named_bar(BAR_ID, 256);
      BSTAMP(0);

      // 1. a1 = ((e.W1e + Y1_i) + Y1_j) + b1 (the forward's order), a chunk of
      // 128 hidden columns at a time, 64 a warpgroup: h1 = bf16(relu(a1))
      // into the h1 panels (not at 8x) and the tile's h1 image; a1 > 0 as
      // this thread's bits of the chunk (bit i: accumulator entry i).
#pragma unroll 1
      for (int c1 = 0; c1 < C::NC; ++c1) {
        const int cb = c1 * 128 + cw() * 64 + 2 * q();
        ewide::Terms tm;
        const auto load = [&] {
          const int2 ia = na(), ib = nb();
          tm.load(yi(ia.x, cb), yi(ia.y, C::HID + cb), yi(ib.x, cb), yi(ib.y, C::HID + cb),
                  a.b1 + cb);
        };
        if (PREFETCH) load();
        float acc[32];
        product<C::KE>(acc, ring, cw(), e_panel, false);
        if (!PREFETCH) load();
        unsigned char* im = img(a.h1i, C::KH, 2 * c1 + cw());
        const uint32_t sm = H + (2 * c1 + cw()) * PIECE;
        uint32_t bits = 0u;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const float2 ha = tm.sum(acc[4 * jj], acc[4 * jj + 1], jj, 0);
          const float2 hb = tm.sum(acc[4 * jj + 2], acc[4 * jj + 3], jj, 1);
          bits |= (uint32_t)((ha.x > 0.f) | (ha.y > 0.f) << 1 | (hb.x > 0.f) << 2 |
                             (hb.y > 0.f) << 3)
                  << (4 * jj);
          store2(im, sm, jj, pack_bf16_relu(ha.x, ha.y), pack_bf16_relu(hb.x, hb.y),
                 !C::STREAM);
        }
        mask1(c1)[ct()] = bits;
      }
      if constexpr (C::STREAM) {
        tile::fence_proxy_async_global();
        tile::mbar_arrive(ring.ready());   // the producer copies h1 back as a2's A
      } else {
        fence_proxy_async();
        named_bar(BAR_ID, 256);   // both halves of h1 are in place
        if (issuer()) bulk_store(img(a.h1i, C::KH, 0), H, C::KH * PIECE);
      }
      BSTAMP(1);

      // 2. a2 = h1.W2 + b2, r = bf16(relu(a2) + x) with x = [e | n_i | n_j]
      // (chunk c2 lies in one of the three), a2 > 0 as bits, a chunk of 128
      // columns at a time; r into the tile's r image and o = b3 + r.W3 (the
      // bias first), this warpgroup's NJ blocks of o. Below 8x r goes to a
      // chunk buffer (its image a bulk copy of it) and each chunk's o
      // products follow it (r is never whole in shared memory); o starts as
      // b3, loaded behind a compiler fence so that its registers are not
      // taken before this step. At 8x
      // o is a block at a time after every chunk (r streamed back), parked
      // for the LayerNorm as it is done: o's 128 registers a thread are then
      // never live at once.
      const auto ob = [&] { return cw() * (CZ / 2) + 2 * q(); };   // o's column of block 0, jj 0
      const auto park = [&] { return reinterpret_cast<float4*>(img(a.da1i, C::KH, 0)); };
      const auto o_bias = [&](int j, float (&v)[32]) {
        ewide::fence_compiler();
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const float2 bb = *reinterpret_cast<const float2*>(a.b3 + ob() + 64 * j + 8 * jj);
          v[4 * jj] = v[4 * jj + 2] = bb.x;
          v[4 * jj + 1] = v[4 * jj + 3] = bb.y;
        }
      };
      float o[C::STREAM ? 1 : C::NJ][32];
      if constexpr (!C::STREAM) {
#pragma unroll
        for (int j = 0; j < C::NJ; ++j) o_bias(j, o[j]);
      }
#pragma unroll 1
      for (int c2 = 0; c2 < C::NC; ++c2) {
        const int cb = c2 * 128 + cw() * 64 + 2 * q();
        float acc[32];
        if constexpr (C::STREAM)
          product<C::KH>(acc, ring, cw(), [&](int, int s) { return ring.stage(s); }, false);
        else
          product<C::KH>(acc, ring, cw(), [&](int k, int) { return H + k * PIECE; }, false);
        if constexpr (C::NCB == 1) {   // the last chunk's readers are done
          if (issuer()) bulk_wait_read();
          named_bar(BAR_ID, 256);
        }
        const uint32_t buf = CB + (c2 % C::NCB) * 2 * PIECE;
        unsigned char* im = img(a.ri, C::KH, 2 * c2 + cw());
        const int seg = c2 * 128 / CZ;   // x: 0 e, 1 n_i, 2 n_j
        uint32_t bits = 0u;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          ewide::fence_compiler();
          const float2 bb = __ldg(reinterpret_cast<const float2*>(a.b2 + cb + 8 * jj));
          const float v0 = acc[4 * jj] + bb.x, v1 = acc[4 * jj + 1] + bb.y;
          const float v2 = acc[4 * jj + 2] + bb.x, v3 = acc[4 * jj + 3] + bb.y;
          bits |= (uint32_t)((v0 > 0.f) | (v1 > 0.f) << 1 | (v2 > 0.f) << 2 | (v3 > 0.f) << 3)
                  << (4 * jj);
          uint32_t xa, xb;
          if (seg == 0) {
            const uint32_t p = E + (2 * c2 + cw()) * PIECE;
            xa = ld_shared_u32(p + bf16_at(ra(), jj, q()));
            xb = ld_shared_u32(p + bf16_at(rb(), jj, q()));
          } else {
            const int2 ia = na(), ib = nb();
            const int c = cb + 8 * jj - seg * CZ;
            xa = __ldg(reinterpret_cast<const unsigned int*>(a.node) +
                       ((size_t)(seg == 1 ? ia.x : ia.y) * CZ + c) / 2);
            xb = __ldg(reinterpret_cast<const unsigned int*>(a.node) +
                       ((size_t)(seg == 1 ? ib.x : ib.y) * CZ + c) / 2);
          }
          const float2 fa = unpack_bf16(xa), fb = unpack_bf16(xb);
          store2(im, buf + cw() * PIECE, jj,
                 pack_bf16(fmaxf(v0, 0.f) + fa.x, fmaxf(v1, 0.f) + fa.y),
                 pack_bf16(fmaxf(v2, 0.f) + fb.x, fmaxf(v3, 0.f) + fb.y), !C::STREAM);
        }
        mask2(c2)[ct()] = bits;
        if constexpr (!C::STREAM) {
          fence_proxy_async();
          if (issuer()) bulk_wait_read<C::NCB - 1>();   // this buffer's last copy is done
          named_bar(BAR_ID, 256);   // the chunk's two halves are in place
          if (issuer()) bulk_store(img(a.ri, C::KH, 2 * c2), buf, 2 * PIECE);
#pragma unroll
          for (int j = 0; j < C::NJ; ++j)
            product<2>(o[j], ring, cw(), [&](int k, int) { return buf + k * PIECE; }, true);
        }
      }
      if constexpr (C::STREAM) {
        tile::fence_proxy_async_global();
        tile::mbar_arrive(ring.ready());   // the producer copies r back as o's A
#pragma unroll 1
        for (int j = 0; j < C::NJ; ++j) {
          o_bias(j, o[0]);
          product<C::KH>(o[0], ring, cw(), [&](int, int s) { return ring.stage(s); }, true);
          ewide::park_store(park(), j, ct(), o[0]);
        }
      }
      BSTAMP(2);

      // 3. The LayerNorm backward over each row's CZ columns (each
      // warpgroup's half summed by quad shuffles, the halves added in a
      // fixed order through shared memory): y of o, g_out = g s_i s_j,
      // dy = g_out ln_scale, do = (dy - mean dy - y mean(dy y)) / sigma;
      // the column sums of g_out y, g_out and do; bf16(do) into the tile's do
      // image and into the e panels, over the tile's g rows, which are
      // gathered there (e is no longer read) while o is parked: in this
      // tile's da1 image (written in step 6), read back a block at a time by
      // each pass, each thread its own values, as the forward's LayerNorm
      // does at 8x (held in registers through the passes, o and the passes'
      // g loads would take more registers than the consumers have).
      ewide::gather_e<CZ>(E, a.g, row0, a.total, ct());
      cp_async_commit();
      if constexpr (!C::STREAM) {
#pragma unroll
        for (int j = 0; j < C::NJ; ++j) ewide::park_store(park(), j, ct(), o[j]);
      }
      cp_async_wait_all();
      if (issuer()) bulk_wait_read();   // h1's and r's copies: the buffers take new values
      named_bar(BAR_ID, 256);           // g is in the e panels
      float sa = 0.f, sb = 0.f;
#pragma unroll 1
      for (int j = 0; j < C::NJ; ++j) {
        float v[32];
        ewide::fence_compiler();
        ewide::park_load(park(), j, ct(), v);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          sa += v[4 * jj] + v[4 * jj + 1];
          sb += v[4 * jj + 2] + v[4 * jj + 3];
        }
      }
      const float2 mu = ewide::exchange<false>(xred(0), cw(), ra(), q(), ewide::quad_sum(sa),
                                               ewide::quad_sum(sb));
      const float mua = mu.x * (1.f / CZ), mub = mu.y * (1.f / CZ);
      float qa = 0.f, qb = 0.f;
#pragma unroll 1
      for (int j = 0; j < C::NJ; ++j) {
        float v[32];
        ewide::fence_compiler();
        ewide::park_load(park(), j, ct(), v);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const float d0 = v[4 * jj] - mua, d1 = v[4 * jj + 1] - mua;
          const float d2 = v[4 * jj + 2] - mub, d3 = v[4 * jj + 3] - mub;
          qa += d0 * d0 + d1 * d1;
          qb += d2 * d2 + d3 * d3;
        }
      }
      const float2 var = ewide::exchange<false>(xred(1), cw(), ra(), q(),
                                                ewide::quad_sum(qa), ewide::quad_sum(qb));
      const float rsa = rsqrtf(var.x * (1.f / CZ) + a.eps);
      const float rsb = rsqrtf(var.y * (1.f / CZ) + a.eps);
      // y of o's block j, a thread's values.
      const auto y_block = [&](int j, float (&v)[32]) {
        ewide::fence_compiler();
        ewide::park_load(park(), j, ct(), v);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          v[4 * jj] = (v[4 * jj] - mua) * rsa;
          v[4 * jj + 1] = (v[4 * jj + 1] - mua) * rsa;
          v[4 * jj + 2] = (v[4 * jj + 2] - mub) * rsb;
          v[4 * jj + 3] = (v[4 * jj + 3] - mub) * rsb;
        }
      };
      float pma, pmb;
      {
        const int2 ia = na(), ib = nb();
        pma = row0 + ra() < a.total ? a.mask[ia.x] * a.mask[ia.y] : 0.f;
        pmb = row0 + rb() < a.total ? a.mask[ib.x] * a.mask[ib.y] : 0.f;
      }
      // g_out of this thread's columns 8 jj + 2q, + 1 of o's block j in row r
      // (0 past the pairs: their rows were gathered as zeros).
      const auto g_out = [&](int r, int j, int jj, float pm) {
        const float2 v = unpack_bf16(
            ld_shared_u32(E + (cw() * C::NJ + j) * PIECE + bf16_at(r, jj, q())));
        return make_float2(v.x * pm, v.y * pm);
      };
      float n1a = 0.f, n2a = 0.f, n1b = 0.f, n2b = 0.f;
#pragma unroll 1
      for (int j = 0; j < C::NJ; ++j) {
        float y[32];
        y_block(j, y);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          ewide::fence_compiler();
          const int c = ob() + 64 * j + 8 * jj;
          const float2 ls = __ldg(reinterpret_cast<const float2*>(a.ln_s + c));
          const float2 ga = g_out(ra(), j, jj, pma), gb = g_out(rb(), j, jj, pmb);
          const float d0 = ga.x * ls.x, d1 = ga.y * ls.y, d2 = gb.x * ls.x, d3 = gb.y * ls.y;
          n1a += d0 + d1;
          n2a += d0 * y[4 * jj] + d1 * y[4 * jj + 1];
          n1b += d2 + d3;
          n2b += d2 * y[4 * jj + 2] + d3 * y[4 * jj + 3];
        }
      }
      const float2 n1 = ewide::exchange<false>(xred(2), cw(), ra(), q(),
                                               ewide::quad_sum(n1a), ewide::quad_sum(n1b));
      const float2 n2 = ewide::exchange<false>(xred(3), cw(), ra(), q(),
                                               ewide::quad_sum(n2a), ewide::quad_sum(n2b));
      const float m1a = n1.x * (1.f / CZ), m1b = n1.y * (1.f / CZ);
      const float m2a = n2.x * (1.f / CZ), m2b = n2.y * (1.f / CZ);
#pragma unroll 1
      for (int j = 0; j < C::NJ; ++j) {
        unsigned char* im = img(a.doi, C::KE, cw() * C::NJ + j);
        const uint32_t sm = E + (cw() * C::NJ + j) * PIECE;
        const auto vj = [&] { return vp() + 2 * C::HID + cw() * (CZ / 2) + 64 * j; };
        float y[32];
        y_block(j, y);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {   // g_out y
          ewide::fence_compiler();
          const float2 ga = g_out(ra(), j, jj, pma), gb = g_out(rb(), j, jj, pmb);
          colsum_put(xcb(), jj, ga.x * y[4 * jj] + gb.x * y[4 * jj + 2],
                     ga.y * y[4 * jj + 1] + gb.y * y[4 * jj + 3]);
        }
        colsum_flush(xcb(), vj() + CZ);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {   // g_out
          ewide::fence_compiler();
          const float2 ga = g_out(ra(), j, jj, pma), gb = g_out(rb(), j, jj, pmb);
          colsum_put(xcb(), jj, ga.x + gb.x, ga.y + gb.y);
        }
        colsum_flush(xcb(), vj() + 2 * CZ);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {   // do (stored as bf16)
          ewide::fence_compiler();
          const int c = ob() + 64 * j + 8 * jj;
          const float2 ls = __ldg(reinterpret_cast<const float2*>(a.ln_s + c));
          const float2 ga = g_out(ra(), j, jj, pma), gb = g_out(rb(), j, jj, pmb);
          const float d0 = (ga.x * ls.x - m1a - y[4 * jj] * m2a) * rsa;
          const float d1 = (ga.y * ls.y - m1a - y[4 * jj + 1] * m2a) * rsa;
          const float d2 = (gb.x * ls.x - m1b - y[4 * jj + 2] * m2b) * rsb;
          const float d3 = (gb.y * ls.y - m1b - y[4 * jj + 3] * m2b) * rsb;
          store2(im, sm, jj, pack_bf16(d0, d1), pack_bf16(d2, d3), true);
          colsum_put(xcb(), jj, d0 + d2, d1 + d3);
        }
        colsum_flush(xcb(), vj());
      }
      fence_proxy_async();
      tile::fence_proxy_async_global();   // the parked o before da1's image copies land there
      named_bar(BAR_ID, 256);             // both halves of do are in place
      if (issuer()) bulk_store(img(a.doi, C::KE, 0), E, C::KE * PIECE);
      BSTAMP(3);

      // 4. dr = bf16(do).W3^T a chunk of 128 columns at a time; da2 = dr [a2
      // > 0]: its column sums, bf16(da2) into the hidden panels (over h1,
      // read by step 2; not at 8x) and the tile's da2 image.
#pragma unroll 1
      for (int c3 = 0; c3 < C::NC; ++c3) {
        float acc[32];
        product<C::KE>(acc, ring, cw(), e_panel, false);
        const uint32_t m2 = mask2(c3)[ct()];
        unsigned char* im = img(a.da2i, C::KH, 2 * c3 + cw());
        const uint32_t sm = H + (2 * c3 + cw()) * PIECE;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          ewide::fence_compiler();
          float d[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) d[k] = (m2 >> (4 * jj + k)) & 1u ? acc[4 * jj + k] : 0.f;
          store2(im, sm, jj, pack_bf16(d[0], d[1]), pack_bf16(d[2], d[3]), !C::STREAM);
          colsum_put(xcb(), jj, d[0] + d[2], d[1] + d[3]);
        }
        colsum_flush(xcb(), vp() + C::HID + c3 * 128 + cw() * 64);
      }
      if constexpr (C::STREAM) {
        tile::fence_proxy_async_global();
        tile::mbar_arrive(ring.ready());   // the producer copies da2 back as dh1's A
      } else {
        fence_proxy_async();
        named_bar(BAR_ID, 256);   // both halves of da2 are in place
        if (issuer()) bulk_store(img(a.da2i, C::KH, 0), H, C::KH * PIECE);
      }
      BSTAMP(4);

      // d_edge's block j (64 columns a warpgroup) out, this thread's columns of
      // its two rows.
      const auto d_out = [&](int j, const float (&d)[32]) {
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int c = ob() + 64 * j + 8 * jj;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = row0 + (h ? rb() : ra());
            if (row >= a.total) continue;
            const float v0 = d[4 * jj + 2 * h], v1 = d[4 * jj + 2 * h + 1];
            if (a.d_edge_f32)
              *reinterpret_cast<float2*>(static_cast<float*>(a.d_edge) + (size_t)row * CZ + c) =
                  make_float2(v0, v1);
            else
              *reinterpret_cast<uint32_t*>(static_cast<bf16*>(a.d_edge) + (size_t)row * CZ + c) =
                  pack_bf16(v0, v1);
          }
        }
      };
      // dh1 = bf16(da2).W2^T's chunk c4 (K = HID), then da1 = dh1 [a1 > 0]:
      // its column sums (through x), bf16(da1) into the tile's da1 image and,
      // below 8x, into a chunk buffer.
      const auto dh1_chunk = [&](int c4, float* x) {
        float acc[32];
        if constexpr (C::STREAM)
          product<C::KH>(acc, ring, cw(), [&](int, int s) { return ring.stage(s); }, false);
        else
          product<C::KH>(acc, ring, cw(), [&](int k, int) { return H + k * PIECE; }, false);
        if constexpr (C::NCB == 1) {   // the last chunk's readers are done
          if (issuer()) bulk_wait_read();
          named_bar(BAR_ID, 256);
        }
        const uint32_t m1 = mask1(c4)[ct()];
        const uint32_t buf = CB + (c4 % C::NCB) * 2 * PIECE;
        unsigned char* im = img(a.da1i, C::KH, 2 * c4 + cw());
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          ewide::fence_compiler();
          float d1[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) d1[k] = (m1 >> (4 * jj + k)) & 1u ? acc[4 * jj + k] : 0.f;
          store2(im, buf + cw() * PIECE, jj, pack_bf16(d1[0], d1[1]), pack_bf16(d1[2], d1[3]),
                 !C::STREAM);
          colsum_put(x, jj, d1[0] + d1[2], d1[1] + d1[3]);
        }
        colsum_flush(x, vp() + c4 * 128 + cw() * 64);
      };
      if constexpr (C::STREAM) {
        // 5, 6 at 8x. Every chunk of dh1 and da1 (the column sums through the
        // chunk buffers: the e panels hold do), then d_edge a block at a time:
        // bf16(do).W3e^T (mma.sync, its first step's products start d), then
        // + bf16(da1).W1e^T over KH, da1 streamed back, and out.
#pragma unroll 1
        for (int c4 = 0; c4 < C::NC; ++c4) dh1_chunk(c4, xcb());
        tile::fence_proxy_async_global();
        tile::mbar_arrive(ring.ready());   // the producer copies da1 back as d_edge's A
        BSTAMP(5);
#pragma unroll 1
        for (int j = 0; j < C::NJ; ++j) {
          float d[32];
          ewide::ring_product_sync<C::KE, C::A_BYTES, true>(d, ring, cw(), e_panel);
          product<C::KH>(d, ring, cw(), [&](int, int s) { return ring.stage(s); }, true);
          d_out(j, d);
        }
        BSTAMP(6);
      } else {
        // 5. d_edge = bf16(do).W3e^T, this warpgroup's NJ blocks (mma.sync:
        // a small product, as the forward's o = e.W3e; its first step's
        // products start d).
        float d[C::NJ][32];
#pragma unroll
        for (int j = 0; j < C::NJ; ++j)
          ewide::ring_product_sync<C::KE, C::A_BYTES, true>(d[j], ring, cw(), e_panel);
        if (issuer()) bulk_wait_read();
        named_bar(BAR_ID, 256);   // do's last readers are done: the e panels take the column sums
        BSTAMP(5);

        // 6. A chunk of dh1 and da1 at a time (the column sums through the e
        // panels), then d_edge += da1_chunk.W1e^T over the chunk's two panels.
#pragma unroll 1
        for (int c4 = 0; c4 < C::NC; ++c4) {
          dh1_chunk(c4, xe());
          fence_proxy_async();
          if (issuer()) bulk_wait_read<C::NCB - 1>();   // this buffer's last copy is done
          named_bar(BAR_ID, 256);   // the chunk's two halves are in place
          const uint32_t buf = CB + (c4 % C::NCB) * 2 * PIECE;
          if (issuer()) bulk_store(img(a.da1i, C::KH, 2 * c4), buf, 2 * PIECE);
#pragma unroll
          for (int j = 0; j < C::NJ; ++j)
            product<2>(d[j], ring, cw(), [&](int k, int) { return buf + k * PIECE; }, true);
        }
        BSTAMP(6);

        // 7. d_edge out.
#pragma unroll
        for (int j = 0; j < C::NJ; ++j) d_out(j, d[j]);
      }
      BSTAMP(7);
#ifdef EDGE_BWD_STAMPS
      stamps[9] += 1;
#endif
    }
    if (ct() == 0) bulk_wait();   // the image copies are complete before the block exits
#ifdef EDGE_BWD_STAMPS
    stamps[8] = ring.waited;
    if (ct() == 0 && blockIdx.x < MAX_BLOCKS)
      for (int k = 0; k < N_STAMPS; ++k) g_stamps[blockIdx.x * N_STAMPS + k] = stamps[k];
#endif
  }
};

template <int CZ>
__global__ void __launch_bounds__(tile::NTHREADS, 1)
ebwd_chain_kernel(const __grid_constant__ Args a) {
  using K = Chain<CZ>;
  using C = typename K::C;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  typename K::Ring ring{base};
  if (threadIdx.x == 0) {
    if (base & 1023) __trap();   // the swizzle is taken from the address bits
    for (int s = 0; s < C::NSTAGE; ++s) {
      tile::mbar_init(ring.full(s), 1);
      tile::mbar_init(ring.empty(s), tile::EMPTY_ARRIVALS);
    }
    tile::mbar_init(ring.ready(), 256);
    tile::mbar_fence_init();
  }
  __syncthreads();
  const int ntiles = (a.total + TM - 1) / TM;
  if (tile::warpgroup_index() == 0) {   // the producer warpgroup: one thread copies
    tile::setmaxnreg_dec<tile::PRODUCER_REGS>();
    if (threadIdx.x == 0) K::produce(a, ring, ntiles);
  } else {
    tile::setmaxnreg_inc<tile::CONSUMER_REGS>();
    K::consume(a, ring, smem, base);
  }
}

// ---- The weight-gradient kernel.
// A block is one unit: either a 128 x 192 tile of one weight gradient over
// one K slice of pairs (dW1e = e^T.da1, dW2 = h1^T.da2, dW3^T = do^T.r,
// written transposed), two warpgroups of m64n192 wgmma, both operands
// MN-major from a W_NST-stage cp.async ring (A: two 64-column panels, B:
// three, copied from the images as they lie; e gathered into the same
// layout); or the per-residue sums of one 64-column panel of da1 or do
// over one batch row: S_i[b L + i] = sum_j, S_j[b L + j] = sum_i, each in
// order (the j side a 512-residue chunk of j at a time in shared memory, 8
// rows i a step).
constexpr int W_NT = 256;
constexpr int W_NST = 5;
constexpr int W_STAGE = 5 * PIECE;   // A 2 panels, B 3
constexpr int W_SMEM = W_NST * W_STAGE;
constexpr int SJ_ROWS = 512, NODE_ROWS = 8;
static_assert(SJ_ROWS * 64 * 4 + NODE_ROWS * 8 * 64 * 4 <= W_SMEM,
              "the node sums fit the ring's room");

struct WeightArgs {
  const bf16* edge;
  const unsigned char* h1i;
  const unsigned char* ri;
  const unsigned char* da2i;
  const unsigned char* da1i;
  const unsigned char* doi;
  float* wpart;   // [nslices][NW]: dW1e [cz][hid] | dW2 [hid][hid] | dW3 [hid][cz]
  float* st;      // [B L][2 (hid + cz)]: S_i | S_j | T_i | T_j
  int cz, L, total, ntiles, nslices;
};

// Weight tiles of one K slice: dW1e, dW2, dW3^T in 128 x 192 tiles.
__host__ __device__ __forceinline__ int weight_tiles(int cz, int* na, int* nb) {
  const int hid = 3 * cz;
  *na = (cz / 128) * (hid / 192);
  *nb = (hid / 128) * (hid / 192);
  return 2 * *na + *nb;
}

__device__ __forceinline__ void weight_unit(const WeightArgs& a, int kind, int mb, int nb, int z,
                                            uint32_t base) {
  const int hid = 3 * a.cz, tid = threadIdx.x, w = tid >> 7;
  const int t0 = (int)((long long)a.ntiles * z / a.nslices);
  const int n = (int)((long long)a.ntiles * (z + 1) / a.nslices) - t0;
  const unsigned char* aimg = kind == 1 ? a.h1i : a.doi;
  const int apanels = (kind == 1 ? hid : a.cz) / 64;
  const unsigned char* bimg = kind == 0 ? a.da1i : kind == 1 ? a.da2i : a.ri;
  auto load = [&](int it) {   // K tile t0 + it (its 64 pairs) into stage it % W_NST
    const uint32_t st = base + (it % W_NST) * W_STAGE;
    const size_t t = (size_t)(t0 + it);
    if (kind == 0) {
      for (int v = tid; v < TM * 16; v += W_NT) {
        const int r = v >> 4, c = v & 15, row = (int)t * TM + r;
        const bool ok = row < a.total;
        cp_async16(st + (c >> 3) * PIECE + sw128_offset(r, c & 7),
                   a.edge + (size_t)(ok ? row : 0) * a.cz + 128 * mb + 8 * c, ok);
      }
    } else {
      const unsigned char* src = aimg + (t * apanels + 2 * mb) * PIECE;
      for (int v = tid; v < 2 * PIECE / 16; v += W_NT) cp_async16(st + 16 * v, src + 16 * v, true);
    }
    const unsigned char* src = bimg + (t * (hid / 64) + 3 * nb) * PIECE;
    for (int v = tid; v < 3 * PIECE / 16; v += W_NT)
      cp_async16(st + 2 * PIECE + 16 * v, src + 16 * v, true);
  };
#pragma unroll
  for (int it = 0; it < W_NST - 2; ++it) {
    if (it < n) load(it);
    cp_async_commit();
  }
  float acc[96];
#pragma unroll
  for (int k = 0; k < 96; ++k) acc[k] = 0.f;
  for (int it = 0; it < n; ++it) {
    cp_async_wait_group<W_NST - 3>();
    fence_proxy_async();
    // K tile it has landed everywhere; every warpgroup's products of K tile
    // it - 2 are done (each waited for them a step ago), so its stage is free.
    __syncthreads();
    if (it + W_NST - 2 < n) load(it + W_NST - 2);
    cp_async_commit();
    const uint32_t st = base + (it % W_NST) * W_STAGE;
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < TM / 16; ++s)
      mma_ss_n192<1, 1>(acc, desc_sw128_mn(st + w * PIECE + s * 2048, PIECE),
                        desc_sw128_mn(st + 2 * PIECE + s * 2048, PIECE), 1);
    wgmma_commit();
    tile::wgmma_wait<1>();
  }
  tile::wgmma_wait<0>();
  fence_regs(acc);
  cp_async_wait_all();
  const long long nw = (long long)a.cz * hid * 2 + (long long)hid * hid;
  float* slot = a.wpart + z * nw;
  const int warp = (tid >> 5) & 3, g = (tid & 31) >> 2, q = tid & 3;
  const int m = 128 * mb + 64 * w + 16 * warp + g;
#pragma unroll
  for (int jb = 0; jb < 24; ++jb) {
    const int c = 192 * nb + 8 * jb + 2 * q;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float v0 = acc[4 * jb + 2 * h], v1 = acc[4 * jb + 2 * h + 1];
      const int mm = m + 8 * h;
      if (kind == 2) {   // dW3[c][mm], [hid][cz]
        float* o = slot + (long long)a.cz * hid + (long long)hid * hid;
        o[(long long)c * a.cz + mm] = v0;
        o[(long long)(c + 1) * a.cz + mm] = v1;
      } else {
        float* o = slot + (kind == 1 ? (long long)a.cz * hid : 0) + (long long)mm * hid + c;
        *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
      }
    }
  }
}

__device__ __forceinline__ void node_unit(const WeightArgs& a, int b, int p, unsigned char* smem) {
  const int hid = 3 * a.cz, L = a.L, ld = 2 * (hid + a.cz);
  const bool is_da1 = p < hid / 64;
  const unsigned char* im = is_da1 ? a.da1i : a.doi;
  const int panels = (is_da1 ? hid : a.cz) / 64, pp = is_da1 ? p : p - hid / 64;
  float* sj = reinterpret_cast<float*>(smem);   // [SJ_ROWS][64]
  float* red = sj + SJ_ROWS * 64;               // [NODE_ROWS rows i][8 warps][64]
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31, s = lane >> 3, c = lane & 7;
  // The columns of S_i and S_j (da1's panels) or T_i and T_j (do's) of this panel.
  float* sti = a.st + (is_da1 ? 64 * pp : 2 * hid + 64 * pp);
  float* stj = sti + (is_da1 ? hid : a.cz);
  for (int j0 = 0; j0 < L; j0 += SJ_ROWS) {
    const int jn = min(SJ_ROWS, L - j0);
    for (int v = tid; v < jn * 64; v += W_NT) sj[v] = 0.f;
    __syncthreads();
    // NODE_ROWS rows i at a time, their loads in flight together; each
    // lane adds them to its S_j columns in order of i.
    for (int i0 = 0; i0 < L; i0 += NODE_ROWS) {
      const int ni = min(NODE_ROWS, L - i0);
      float si[NODE_ROWS][8] = {};
      for (int jj = 4 * w + s; jj < jn; jj += 32) {
        uint4 v[NODE_ROWS];
#pragma unroll
        for (int ii = 0; ii < NODE_ROWS; ++ii) {
          v[ii] = make_uint4(0u, 0u, 0u, 0u);
          if (ii < ni) {
            const long long row = (long long)(b * L + i0 + ii) * L + j0 + jj;
            const int rr = (int)(row & 63);
            v[ii] = *reinterpret_cast<const uint4*>(
                im + ((row >> 6) * panels + pp) * PIECE + rr * 128 + ((c ^ (rr & 7)) << 4));
          }
        }
        float* dst = sj + jj * 64 + 8 * c;
#pragma unroll
        for (int ii = 0; ii < NODE_ROWS; ++ii) {
          if (ii >= ni) break;
          const float2 f0 = unpack_bf16(v[ii].x), f1 = unpack_bf16(v[ii].y),
                       f2 = unpack_bf16(v[ii].z), f3 = unpack_bf16(v[ii].w);
          const float f[8] = {f0.x, f0.y, f1.x, f1.y, f2.x, f2.y, f3.x, f3.y};
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            si[ii][k] += f[k];
            dst[k] += f[k];
          }
        }
      }
#pragma unroll
      for (int ii = 0; ii < NODE_ROWS; ++ii) {
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          si[ii][k] += __shfl_xor_sync(FULL, si[ii][k], 8);
          si[ii][k] += __shfl_xor_sync(FULL, si[ii][k], 16);
        }
        if (s == 0) {
          float* rd = red + ii * 512 + w * 64 + 8 * c;
#pragma unroll
          for (int k = 0; k < 8; ++k) rd[k] = si[ii][k];
        }
      }
      __syncthreads();
      for (int v = tid; v < ni * 64; v += W_NT) {
        const float* rr = red + (v >> 6) * 512 + (v & 63);
        float sum = rr[0];
#pragma unroll
        for (int k = 1; k < 8; ++k) sum += rr[64 * k];
        float* dst = sti + (size_t)(b * L + i0 + (v >> 6)) * ld + (v & 63);
        *dst = j0 == 0 ? sum : *dst + sum;
      }
      __syncthreads();
    }
    for (int v = tid; v < jn * 64; v += W_NT)
      stj[(size_t)(b * L + j0 + (v >> 6)) * ld + (v & 63)] = sj[v];
    __syncthreads();
  }
}

__global__ void __launch_bounds__(W_NT, 1)
ebwd_weight_kernel(const __grid_constant__ WeightArgs a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  if (base & 1023) __trap();
  int na, nb;
  const int per = weight_tiles(a.cz, &na, &nb);
  const int u = blockIdx.x, hid = 3 * a.cz;
  if (u < per * a.nslices) {
    const int z = u / per, tt = u % per;
    const int nn = hid / 192;   // N tiles of each kind
    if (tt < na) weight_unit(a, 0, tt / nn, tt % nn, z, base);
    else if (tt < na + nb) weight_unit(a, 1, (tt - na) / nn, (tt - na) % nn, z, base);
    else weight_unit(a, 2, (tt - na - nb) / nn, (tt - na - nb) % nn, z, base);
  } else {
    const int v = u - per * a.nslices, np = (hid + a.cz) / 64;
    node_unit(a, v / np, v % np, smem);
  }
}

// ---- The reduction kernel: a block is one of (in this order, the long
// ones first)
//  - one K chunk (RK_CHUNK) of a 64 x 64 tile of d_node = [S_i | S_j | T_i |
//    T_j].[W1i | W1j | W3i | W3j]^T (wn: the node rows of k1 and k3
//    transposed, [2 hid + 2 cz][cz]), K = 2 (hid + cz), or of dW1's node rows
//    node^T.S_i (rows cz .. 2 cz) or node^T.S_j (2 cz .. 3 cz), K = B L:
//    fp32 FMA, 4 x 4 outputs a thread, K in steps of RK_STEP through shared
//    memory, in order. A tile cut in P > 1 chunks writes
//    P partial tiles; the block that takes a tile's last ticket (an integer
//    atomic, after a fence) adds them in chunk order, so the sums do not
//    depend on which block finishes last;
//  - 256 entries of the chain's column sums, over its blocks in order;
//  - a share of the weight gradients' slots (RK_SUM_BLOCKS blocks walk
//    them), each entry summed over the slices in order (dW1's e rows, dW2,
//    dW3).
constexpr int RK_CHUNK = 512, RK_STEP = 16, RK_SUM_BLOCKS = 264;

struct ReduceArgs {
  const float* wpart;
  const float* vpart;
  const float* st;
  const bf16* node;
  const bf16* wn;    // [2 hid + 2 cz][cz]: [W1i | W1j | W3i | W3j]^T
  float* rpart;      // the split tiles' partials: d_node's, then dW1's node rows'
  int* tickets;      // a tile each: d_node's, then dW1's node rows'
  float* dk1;
  float* db1;
  float* dk2;
  float* db2;
  float* dk3;
  float* db3;
  float* dln_s;
  float* dln_b;
  float* d_node;
  int cz, BL, nslices, nblocks;
};

// The reduction's layout for c_z = cz over B L residues: its blocks, the
// split tiles' partial floats and tickets.
struct ReduceLayout {
  long long nw;
  int n_w, n_v, t_dn, p_dn, t_dw, p_dw;
  __host__ __device__ ReduceLayout(int cz, int BL) {
    const int hid = 3 * cz;
    nw = 2LL * cz * hid + (long long)hid * hid;
    n_w = (int)((nw + 255) / 256) < RK_SUM_BLOCKS ? (int)((nw + 255) / 256) : RK_SUM_BLOCKS;
    n_v = (2 * hid + 3 * cz + 255) / 256;
    t_dn = ((BL + 63) / 64) * (cz / 64);
    p_dn = (8 * cz + RK_CHUNK - 1) / RK_CHUNK;
    t_dw = 2 * (cz / 64) * (hid / 64);
    p_dw = (BL + RK_CHUNK - 1) / RK_CHUNK;
  }
  __host__ __device__ int blocks() const { return n_w + n_v + t_dn * p_dn + t_dw * p_dw; }
  __host__ __device__ long long part_dn() const {
    return p_dn > 1 ? (long long)t_dn * p_dn * 4096 : 0;
  }
  __host__ __device__ long long partials() const {
    return part_dn() + (p_dw > 1 ? (long long)t_dw * p_dw * 4096 : 0);
  }
};

// acc = A[64][k0, k1) . B[k0, k1)[64], fa(m, k), fb(k, n) (0 where outside),
// 256 threads of 4 x 4 outputs (rows 4 (t / 16), columns 4 (t % 16)); the A
// tile's loads run along k (A_ALONG_K) or along m.
constexpr int RK_LDA = 68;   // the A tile's rows, padded: its stores along k do not share banks

template <bool A_ALONG_K, class FA, class FB>
__device__ __forceinline__ void sgemm_tile(FA fa, FB fb, int k0, int k1, float (&acc)[4][4],
                                           float* as, float* bs) {
  constexpr int KS = RK_STEP, PER = 64 * KS / 256;
  const int tid = threadIdx.x, tm = tid >> 4, tn = tid & 15;
  // The next step's elements, fetched while this step's products run.
  float na[PER], nb[PER];
  const auto fetch = [&](int k) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int v = tid + 256 * i;
      const int m = A_ALONG_K ? v / KS : v % 64, kk = A_ALONG_K ? v % KS : v / 64;
      na[i] = k + kk < k1 ? fa(m, k + kk) : 0.f;
      nb[i] = k + v / 64 < k1 ? fb(k + v / 64, v % 64) : 0.f;
    }
  };
  fetch(k0);
  for (; k0 < k1; k0 += KS) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int v = tid + 256 * i;
      const int m = A_ALONG_K ? v / KS : v % 64, kk = A_ALONG_K ? v % KS : v / 64;
      as[kk * RK_LDA + m] = na[i];
      bs[v] = nb[i];
    }
    __syncthreads();
    if (k0 + KS < k1) fetch(k0 + KS);
#pragma unroll 8
    for (int kk = 0; kk < KS; ++kk) {
      const float4 x = *reinterpret_cast<const float4*>(as + kk * RK_LDA + 4 * tm);
      const float4 y = *reinterpret_cast<const float4*>(bs + kk * 64 + 4 * tn);
      const float xa[4] = {x.x, x.y, x.z, x.w}, ya[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jx = 0; jx < 4; ++jx) acc[i][jx] += xa[i] * ya[jx];
    }
    __syncthreads();
  }
}

// A split tile's end: with P chunks, this block's partial (R x C floats a
// thread) into part[p], and whether it took the tile's last ticket (then
// every partial is visible and acc becomes their sum in chunk order). One
// chunk: acc as it is.
template <int R, int C>
__device__ __forceinline__ bool combine(float (&acc)[R][C], float* part, int p, int P,
                                        int* ticket) {
  if (P == 1) return true;
  __shared__ int last;
  constexpr int N = R * C;
  float* mine = part + (size_t)p * 256 * N + threadIdx.x * N;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) mine[i * C + j] = acc[i][j];
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1) == P - 1;
  __syncthreads();
  if (!last) return false;
  __threadfence();
  for (int q = 0; q < P; ++q) {
    const float* src = part + (size_t)q * 256 * N + threadIdx.x * N;
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < C; ++j)
        acc[i][j] = q ? acc[i][j] + __ldcg(src + i * C + j) : __ldcg(src + i * C + j);
  }
  return true;
}

__global__ void __launch_bounds__(256, 2)
ebwd_reduce_kernel(const __grid_constant__ ReduceArgs a) {
  __shared__ __align__(16) float as[RK_STEP * RK_LDA];
  __shared__ __align__(16) float bs[RK_STEP * 64];
  const int cz = a.cz, hid = 3 * cz, tid = threadIdx.x;
  const ReduceLayout lay(cz, a.BL);
  const long long nw = lay.nw;
  const int vw = 2 * hid + 3 * cz, ldst = 2 * (hid + cz);
  int u = blockIdx.x;
  const int tm = tid >> 4, tn = tid & 15;
  if (u < lay.t_dn * lay.p_dn) {
    const int t = u / lay.p_dn, p = u % lay.p_dn;
    const int m0 = (t / (cz / 64)) * 64, n0 = (t % (cz / 64)) * 64;
    const auto fa = [&](int m, int k) {
      return m0 + m < a.BL ? a.st[(size_t)(m0 + m) * ldst + k] : 0.f;
    };
    const auto fb = [&](int k, int n) {
      return __bfloat162float(a.wn[(size_t)k * cz + n0 + n]);
    };
    float acc[4][4] = {};
    sgemm_tile<true>(fa, fb, p * RK_CHUNK, min(ldst, (p + 1) * RK_CHUNK), acc, as, bs);
    if (!combine(acc, a.rpart + (size_t)t * lay.p_dn * 4096, p, lay.p_dn, a.tickets + t))
      return;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + 4 * tm + i;
      if (m < a.BL)
        *reinterpret_cast<float4*>(a.d_node + (size_t)m * cz + n0 + 4 * tn) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
    return;
  }
  u -= lay.t_dn * lay.p_dn;
  if (u >= lay.t_dw * lay.p_dw) {
    u -= lay.t_dw * lay.p_dw;
    if (u < lay.n_v) {
      const int e = u * 256 + tid;
      if (e >= vw) return;
      float s = 0.f;
#pragma unroll 8
      for (int b = 0; b < a.nblocks; ++b) s += a.vpart[(size_t)b * vw + e];
      if (e < hid) a.db1[e] = s;
      else if (e < 2 * hid) a.db2[e - hid] = s;
      else if (e < 2 * hid + cz) a.db3[e - 2 * hid] = s;
      else if (e < 2 * hid + 2 * cz) a.dln_s[e - 2 * hid - cz] = s;
      else a.dln_b[e - 2 * hid - 2 * cz] = s;
      return;
    }
    u -= lay.n_v;
    const long long n1 = (long long)cz * hid, n2 = n1 + (long long)hid * hid;
    for (long long e = (long long)u * 256 + tid; e < nw; e += (long long)lay.n_w * 256) {
      float s = 0.f;
#pragma unroll 8
      for (int z = 0; z < a.nslices; ++z) s += a.wpart[z * nw + e];
      if (e < n1) a.dk1[e] = s;
      else if (e < n2) a.dk2[e - n1] = s;
      else a.dk3[e - n2] = s;
    }
    return;
  }
  const int t = u / lay.p_dw, p = u % lay.p_dw;
  const int side = t / ((cz / 64) * (hid / 64)), r = t % ((cz / 64) * (hid / 64));
  const int m0 = (r / (hid / 64)) * 64, n0 = (r % (hid / 64)) * 64;
  const auto fa = [&](int m, int k) {
    return k < a.BL ? __bfloat162float(a.node[(size_t)k * cz + m0 + m]) : 0.f;
  };
  const auto fb = [&](int k, int n) {
    return k < a.BL ? a.st[(size_t)k * ldst + side * hid + n0 + n] : 0.f;
  };
  float acc[4][4] = {};
  sgemm_tile<false>(fa, fb, p * RK_CHUNK, min(a.BL, (p + 1) * RK_CHUNK), acc, as, bs);
  if (!combine(acc, a.rpart + lay.part_dn() + (size_t)t * lay.p_dw * 4096, p, lay.p_dw,
               a.tickets + lay.t_dn + t))
    return;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(a.dk1 + (size_t)((1 + side) * cz + m0 + 4 * tm + i) * hid + n0 +
                               4 * tn) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
}

template <int CZ>
static int launch_chain(const Args& a, int grid, cudaStream_t st) {
  static bool opt_in[wide::MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= wide::MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  auto kernel = ebwd_chain_kernel<CZ>;
  if (!opt_in[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<CZ>::BYTES);
    if (err != cudaSuccess) return (int)err;
    opt_in[dev] = true;
  }
  kernel<<<grid, tile::NTHREADS, Cfg<CZ>::BYTES, st>>>(a);
  return wide::launched();
}

static inline int stages_of(int cz) {
  return cz == 128 ? Cfg<128>::N_MAIN : cz == 256 ? Cfg<256>::N_MAIN : Cfg<512>::N_MAIN;
}

#ifdef EDGE_BWD_STAMPS
static cudaEvent_t g_events[5];
#define BEVENT(k)                                                      \
  do {                                                                 \
    if (!g_events[k]) cudaEventCreate(&g_events[k]);                   \
    cudaEventRecord(g_events[k], st);                                  \
  } while (0)
#else
#define BEVENT(k) \
  do {            \
  } while (0)
#endif

static int backward(const void* edge, const void* node, const void* mask, const void* g,
                    const void* wn, const void* wb, const void* b1, const void* b2,
                    const void* b3, const void* ln_s, void* y, void* h1i, void* ri, void* da2i,
                    void* da1i, void* doi, void* stv, void* vpart, void* wpart, void* rpart,
                    void* tickets, void* d_edge, void* d_node, void* dk1, void* db1, void* dk2,
                    void* db2, void* dk3, void* db3, void* dln_s, void* dln_b, int B, int L,
                    int cz, int grid, int nslices, long long wb_bytes, long long rpart_floats,
                    int ntickets, int d_edge_f32, float eps, cudaStream_t st) {
  const long long total = (long long)B * L * L;
  if (total > INT_MAX) return (int)cudaErrorInvalidValue;   // pair rows are 32-bit
  if (cz != 128 && cz != 256 && cz != 512) return (int)cudaErrorInvalidValue;
  const int ntiles = (int)((total + TM - 1) / TM);
  if (total == 0 || grid < 1 || grid > ntiles || nslices < 1 || nslices > ntiles)
    return (int)cudaErrorInvalidValue;
  if (wb_bytes != (long long)stages_of(cz) * 2 * PIECE) return (int)cudaErrorInvalidValue;
  const ReduceLayout lay(cz, B * L);
  if (rpart_floats != lay.partials() || ntickets != lay.t_dn + lay.t_dw)
    return (int)cudaErrorInvalidValue;
  const int hid = 3 * cz;
  BEVENT(0);
  wide::Epi e{};
  e.f32 = static_cast<float*>(y);
  e.ld_f32 = 2 * hid;
  WIDE_TRY((wide::gemm<128, 128, false, wide::F32>(wide::opd(wide::seg(node, cz)),
                                                   wide::opd(wide::seg(wn, cz)), B * L, 2 * hid,
                                                   cz, 0, L, e, st)));
  BEVENT(1);
  Args a{};
  a.edge = static_cast<const bf16*>(edge);
  a.node = static_cast<const bf16*>(node);
  a.mask = static_cast<const float*>(mask);
  a.g = static_cast<const bf16*>(g);
  a.y = static_cast<const float*>(y);
  a.wb = static_cast<const unsigned char*>(wb);
  a.b1 = static_cast<const float*>(b1);
  a.b2 = static_cast<const float*>(b2);
  a.b3 = static_cast<const float*>(b3);
  a.ln_s = static_cast<const float*>(ln_s);
  a.h1i = static_cast<unsigned char*>(h1i);
  a.ri = static_cast<unsigned char*>(ri);
  a.da2i = static_cast<unsigned char*>(da2i);
  a.da1i = static_cast<unsigned char*>(da1i);
  a.doi = static_cast<unsigned char*>(doi);
  a.vpart = static_cast<float*>(vpart);
  a.tickets = static_cast<int*>(tickets);
  a.ntickets = ntickets;
  a.d_edge = d_edge;
  a.d_edge_f32 = d_edge_f32;
  a.L = L;
  a.total = (int)total;
  a.eps = eps;
  WIDE_TRY(cz == 128   ? launch_chain<128>(a, grid, st)
           : cz == 256 ? launch_chain<256>(a, grid, st)
                       : launch_chain<512>(a, grid, st));
  BEVENT(2);
  static bool w_opt_in[wide::MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (!w_opt_in[dev]) {
    err = cudaFuncSetAttribute(ebwd_weight_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               W_SMEM);
    if (err != cudaSuccess) return (int)err;
    w_opt_in[dev] = true;
  }
  WeightArgs wa{static_cast<const bf16*>(edge), a.h1i, a.ri, a.da2i, a.da1i, a.doi,
                static_cast<float*>(wpart), static_cast<float*>(stv), cz, L, (int)total, ntiles,
                nslices};
  int na, nb;
  const int units = weight_tiles(cz, &na, &nb) * nslices + B * ((hid + cz) / 64);
  ebwd_weight_kernel<<<units, W_NT, W_SMEM, st>>>(wa);
  WIDE_TRY(wide::launched());
  BEVENT(3);
  ReduceArgs ra{static_cast<const float*>(wpart), static_cast<const float*>(vpart),
                static_cast<const float*>(stv), static_cast<const bf16*>(node),
                static_cast<const bf16*>(wn), static_cast<float*>(rpart),
                static_cast<int*>(tickets), static_cast<float*>(dk1), static_cast<float*>(db1),
                static_cast<float*>(dk2), static_cast<float*>(db2), static_cast<float*>(dk3),
                static_cast<float*>(db3), static_cast<float*>(dln_s), static_cast<float*>(dln_b),
                static_cast<float*>(d_node), cz, B * L, nslices, grid};
  ebwd_reduce_kernel<<<lay.blocks(), 256, 0, st>>>(ra);
  WIDE_TRY(wide::launched());
  BEVENT(4);
  return 0;
}

}  // namespace ebwd

// Device launches of one call of edge_transition_wide_backward: the node
// pre-pass, the chain, weight-gradient and reduction kernels.
extern "C" int edge_transition_wide_bwd_kernels_per_call() { return 4; }

// Dynamic shared memory of the chain kernel at c_z = cz (which = 0) and of
// the weight kernel (which = 1), bytes.
extern "C" int edge_transition_wide_bwd_smem_bytes(int cz, int which) {
  if (which) return ebwd::W_SMEM;
  return cz == 128   ? ebwd::Cfg<128>::BYTES
         : cz == 256 ? ebwd::Cfg<256>::BYTES
                     : ebwd::Cfg<512>::BYTES;
}

// K4 at c_z = cz in {128, 256, 512}. wn: the node rows of k1 and k3
// transposed (cuda_edge.kernel_operands: the node pre-pass reads its first 2
// hid rows, the reduction all); wb the chain kernel's weight stages
// (cuda_edge.wide_bwd_stages), wb_bytes their length.
// Scratch for M = B L L pairs, ntiles = ceil(M / 64): y [B L][2 hid] f32;
// the images h1i, ri, da2i, da1i [ntiles 64][hid] and doi [ntiles 64][cz]
// bf16; st [B L][2 (hid + cz)] f32; vpart [grid][2 hid + 3 cz] f32; wpart
// [nslices][2 cz hid + hid hid] f32; rpart (rpart_floats f32) and tickets
// (ntickets int32) of the reduction's split tiles (cuda_edge.wide_bwd_scratch
// computes their sizes). grid (the chain kernel's persistent grid) and
// nslices (K slices of the weight gradients) lie in [1, ntiles]. Returns
// cudaErrorInvalidValue for a wb of another length than the chain kernel's
// producer reads or scratch sizes other than its own, else the first
// nonzero cudaError_t of its launches.
extern "C" int edge_transition_wide_backward(
    const void* edge, const void* node, const void* mask, const void* g, const void* wn,
    const void* wb, const void* b1, const void* b2, const void* b3, const void* ln_s, void* y,
    void* h1i, void* ri, void* da2i, void* da1i,
    void* doi, void* st, void* vpart, void* wpart, void* rpart, void* tickets, void* d_edge,
    void* d_node, void* dk1, void* db1, void* dk2, void* db2, void* dk3, void* db3, void* dln_s,
    void* dln_b, int B, int L, int cz, int grid, int nslices, long long wb_bytes,
    long long rpart_floats, int ntickets, int d_edge_f32, float eps, void* stream) {
  return ebwd::backward(edge, node, mask, g, wn, wb, b1, b2, b3, ln_s, y, h1i, ri, da2i,
                        da1i, doi, st, vpart, wpart, rpart, tickets, d_edge, d_node, dk1, db1, dk2,
                        db2, dk3, db3, dln_s, dln_b, B, L, cz, grid, nslices, wb_bytes,
                        rpart_floats, ntickets, d_edge_f32, eps,
                        static_cast<cudaStream_t>(stream));
}

#ifdef EDGE_BWD_STAMPS
// The diagnostic build's chain-kernel step sums: [blocks][N_STAMPS] int64
// into host memory at `dst`.
extern "C" int edge_bwd_read_stamps(void* dst, int blocks) {
  return (int)cudaMemcpyFromSymbol(dst, ebwd::g_stamps,
                                   sizeof(long long) * ebwd::N_STAMPS * blocks);
}
// The last call's four kernels' device times, ms, into dst[0..3].
extern "C" int edge_bwd_read_event_ms(float* dst) {
  cudaError_t err = cudaEventSynchronize(ebwd::g_events[4]);
  for (int k = 0; k < 4 && err == cudaSuccess; ++k)
    err = cudaEventElapsedTime(dst + k, ebwd::g_events[k], ebwd::g_events[k + 1]);
  return (int)err;
}
#endif

// Kernels launched on the wide paths since the library was loaded.
extern "C" int edge_transition_bwd_wide_launches() { return wide::g_launches.load(); }
