// EdgeEmbedder distance block, backward, for Hopper, sm_90a (K5).
//
// Replaces: pepflowww_tpu/models/pallas_dist.py::distance_embed_bwd (body
// `_bwd_kernel` :203, pallas_call :320), the backward half of
// fused_distance_embed_vjp (:350).
//
// For the cotangent g of the forward in distance_embed.cu, per pair (i, j)
// with x = bf16(exp(-c * d2) * m_i[a] * m_j[a']), c = softplus(coef) and
// coef = table[aa_i * 22 + aa_j]:
//   recompute  a1 = x.K1 + b1, h = bf16(relu(a1)), a2 = h.K2 + b2
//   backward   do = g * s_i * s_j, da2 = do * (a2 > 0), dh = bf16(da2).K2^T,
//              da1 = dh * (a1 > 0), dx = bf16(da1).K1^T,
//              dcoef = dx * m_i[a] * m_j[a'] * e * (-d2) * sigmoid(coef)
//   outputs    dK2 = h^T.bf16(da2), dK1 = x^T.bf16(da1), db = column sums,
//              d_table[aa_i * 22 + aa_j] += dcoef.
// Positions, masks and tokens are data: no gradient for them. GEMM operands
// are bf16 with fp32 accumulation; d2, the gaussian, dcoef and every sum
// are fp32. Unlike the TPU kernel, dcoef is summed into the table in fp32
// (the TPU kernel rounds it to bf16 for its one-hot matmul, a layout device)
// and d2 is the fp32 difference form, as in the forward.
//
// What bounds it on this card: ~55k MAC per pair (recompute x.K1, h.K2;
// backward dK2, dh, dK1, dx), all bf16 on the tensor cores (~15 us at B=32,
// L=64 at 989 TFLOP/s), ahead of the fp32 work per atom pair and the bytes.
// The gaussian's exp runs on the special function units at 16 a clock an
// SM: once an atom pair it is a floor of ~7-8 us at B=32, L=64.
//
// Design: two launches a call, every cross-block sum through partials added
// in a fixed order (no float atomics: two calls give bit-identical results).
//  1. dist_bwd_kernel: one block an SM, two warpgroups, each block a chunk
//     of the live residues in the stable order by token of
//     csrc/distance_tile.cuh (a residue whose s_i is 0 has do = 0 on every
//     pair). At each run of equal aa_i it fills the slabs softplus(coef) *
//     log2(e) and sigmoid(coef) of the run's 22 table rows in shared memory
//     (no prep launch), and the run's table gradient sums in a 22 x 225 fp32
//     slab in shared memory that leaves as one partial when aa_i changes or
//     the chunk ends: slot z + aa_i of block z, at most grid + 21 partials
//     (~3 MB at 132 blocks), no per-residue scratch. Per tile of 64 pairs
//     (the live rows first, sorted stably by aa_j; L > 64 in tiles of 64)
//     both warpgroups build the x panel and, in fp32, w = e * m_i * m_j *
//     (-d2) * sigmoid(coef) into a [64][228] buffer (so dcoef needs no second
//     exp); the g rows arrive by cp.async meanwhile. Warpgroup 0 runs the
//     chain on wgmma: a1 = x.K1 (x from shared memory, K1 read MN-major), h
//     from registers into h.K2, da2 = g * s_i * s_j * (a2 > 0) in registers
//     over the g rows in place, dh = bf16(da2).K2^T (A from registers, K2
//     read K-major), da1 = dh * (a1 > 0) with a1's signs kept as a bitmask;
//     h, bf16(da2) and bf16(da1) go to swizzled panels. Then each warpgroup
//     issues dx = bf16(da1).K1^T for its 120 columns (m64n64, then m64n56:
//     the same K1 tile read K-major), dK1 += x^T.bf16(da1) for its two
//     64-row blocks (x and da1 read MN-major) and dK2 += h^T.bf16(da2) for
//     its 32 columns (m64n32, da2 read from 64 bytes into its rows). dK1 and
//     dK2 stay in the registers of the two warpgroups for the block's whole
//     chunk (64 + 16 floats a thread). dcoef = dx * w is written over w in
//     place, and one thread a column sums it over each run of equal aa_j in
//     row order into the table slab. db1, db2 are fp32 column sums in a
//     fixed order (quad butterflies into shared memory, the warps in order
//     at the end).
//     The budget is the design problem: 232,348 of the 232,448 bytes of
//     shared memory a block may use, and 249 of 255 registers a thread with
//     no spill. w is kept rather than recomputed (a second exp an atom pair
//     would double the floor above); the walk's state and the bias sums live
//     in shared memory (the latter in the x panel's columns 240 .. 255, which
//     give only dK1's padding rows), as the accumulators fill the registers.
//  2. dist_bwd_reduce_kernel: d_table row (k, k2) sums the partials of the
//     blocks whose chunks hold token k, in block order; dK1, dK2, db1, db2
//     the per-block partials in block order.

#include <climits>

#include "distance_tile.cuh"

namespace {

using namespace dist;

constexpr int NT = 256;                      // two warpgroups
constexpr int WLD = 228;                     // w's row stride (16-byte rows)
constexpr int PB = AA2 * F + F * F + 2 * F;  // per-block partial: dK1 | dK2 | db1 | db2
constexpr int SLAB = NAA * AA2;              // a table partial: 22 rows of 225
constexpr unsigned FULL = 0xffffffffu;

// Shared memory (bytes): K1, K2, the x panel, h, g then bf16(da2), bf16(da1)
// (swizzled panels), w [64][228] f32 (also the order's scratch), the j tile,
// the slabs softplus * log2(e) and sigmoid, the table gradient slab, two
// buffers of residue i's atoms, the window's items, the walk's state (kept
// here rather than in registers, which the accumulators fill). b1 and b2 are
// read through the L1 cache: the block has 100 bytes to spare.
struct Smem {
  static constexpr int K1 = 0;
  static constexpr int K2 = K1 + K1_BYTES;
  static constexpr int X = K2 + K2_BYTES;
  static constexpr int H = X + X_BYTES;
  static constexpr int GD2 = H + PANEL;
  static constexpr int DA1 = GD2 + PANEL;
  static constexpr int W = DA1 + PANEL;
  static constexpr int JT = W + TJ * WLD * 4;
  static constexpr int SP = JT + (int)((sizeof(JTile) + 15) / 16 * 16);
  static constexpr int SG = SP + SLAB_BYTES;
  static constexpr int GS = SG + SLAB_BYTES;
  static constexpr int PI = (GS + SLAB * 4 + 15) / 16 * 16;
  static constexpr int WIN = PI + 2 * 16 * 16;
  static constexpr int ST = WIN + (int)sizeof(Window);   // the walk's state (see st)
  static constexpr int BYTES = ST + 24;
  static constexpr int TOT = W + (NAA + 1) * NT * 4;   // the scan's scratch, in w after the counts
  static_assert(K2 % 1024 == 0 && X % 1024 == 0 && H % 1024 == 0 && GD2 % 1024 == 0 &&
                    DA1 % 1024 == 0,
                "panels on 1024 bytes");
  static_assert(JT % 16 == 0 && SP % 16 == 0 && SG % 16 == 0, "16-byte rows");
  static_assert((NAA + 1) * NT * 4 + 32 * 4 <= TJ * WLD * 4, "the order's scratch fits in w");
  static_assert(BYTES <= 232448, "more shared memory than a block may use");
};

// The sum of entry g = lane / 4 of v over the eight lanes of a quad column
// (the lanes with the same lane % 4), in a fixed butterfly order: a step
// over lane bit m halves the n entries still held, the lane with that bit
// set keeping the upper half. Eight entries are the pairs of columns 2q,
// 2q + 1 of four 8-column blocks, so lane g is left with column
// 8 (g / 2) + 2q + g % 2 of them.
template <int n, int m>
__device__ __forceinline__ void butterfly_step(float* v, int lane) {
  const bool up = lane & m;
#pragma unroll
  for (int k = 0; k < n / 2; ++k) {
    const float send = up ? v[k] : v[k + n / 2];
    const float keep = up ? v[k + n / 2] : v[k];
    v[k] = keep + __shfl_xor_sync(FULL, send, m);
  }
}
__device__ __forceinline__ float quad_column_sum(float* v, int lane) {
  butterfly_step<8, 16>(v, lane);
  butterfly_step<4, 8>(v, lane);
  butterfly_step<2, 4>(v, lane);
  return v[0];
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// dcoef = dx * w over w in place, for the NB 8-column blocks of a thread's
// dx accumulator (rows ra, ra + 8), which start at column c0 of the tile;
// columns from 225 on are padding.
template <int NB>
__device__ __forceinline__ void dcoef(const float (&dx)[4 * NB], float* __restrict__ w, int ra,
                                      int q, int c0) {
#pragma unroll
  for (int j8 = 0; j8 < NB; ++j8) {
    const int c = c0 + 8 * j8 + 2 * q;
    if (c < AA2) {
      float* wa = w + ra * WLD + c;
      float* wb = wa + 8 * WLD;
      if (c + 1 < AA2) {
        const float2 xa = *reinterpret_cast<const float2*>(wa);
        const float2 xb = *reinterpret_cast<const float2*>(wb);
        *reinterpret_cast<float2*>(wa) = make_float2(dx[4 * j8] * xa.x, dx[4 * j8 + 1] * xa.y);
        *reinterpret_cast<float2*>(wb) = make_float2(dx[4 * j8 + 2] * xb.x, dx[4 * j8 + 3] * xb.y);
      } else {
        wa[0] *= dx[4 * j8];
        wb[0] *= dx[4 * j8 + 2];
      }
    }
  }
}

struct Args {
  const float* pos;
  const float* amask;
  const int* aa;
  const float* smask;
  const bf16* g;
  const float* table;
  const bf16* k1;
  const float* b1;
  const bf16* k2;
  const float* b2;
  float* tpart;   // [grid + 21][22][225]: slot z + k holds block z's run of token k
  float* wpart;   // [grid][PB]
  int* starts;    // [23]: the sorted order's bucket starts (block 0 writes them)
  int B, L;
};

__global__ void __launch_bounds__(NT, 1) dist_bwd_kernel(const __grid_constant__ Args a) {
  using S = Smem;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  if (base & 1023) __trap();   // the swizzle is taken from the address bits
  float* w_s = reinterpret_cast<float*>(smem + S::W);
  JTile& jt = *reinterpret_cast<JTile*>(smem + S::JT);
  float* sp2 = reinterpret_cast<float*>(smem + S::SP);
  float* sg = reinterpret_cast<float*>(smem + S::SG);
  float* gslab = reinterpret_cast<float*>(smem + S::GS);
  const float4* pi_buf = reinterpret_cast<const float4*>(smem + S::PI);
  Window& win = *reinterpret_cast<Window*>(smem + S::WIN);
  // The walk's state, in shared memory rather than registers, which the
  // accumulators fill: the run's token, the j tile's b and jt (-1: none),
  // the window, the item in it.
  int* st = reinterpret_cast<int*>(smem + S::ST);
  int* tot = reinterpret_cast<int*>(smem + S::TOT);
  unsigned char* h_p = smem + S::H;
  unsigned char* gd2_p = smem + S::GD2;
  unsigned char* da1_p = smem + S::DA1;
  const uint32_t x_s = base + S::X, k1_s = base + S::K1, k2_s = base + S::K2;
  const uint32_t h_s = base + S::H, gd2_s = base + S::GD2, da1_s = base + S::DA1;
  const uint32_t pi_s = base + S::PI;
  // The warpgroup as a warp-uniform value (a broadcast): the compiler then
  // keeps each warpgroup's wgmma in its branch instead of serializing them.
  const int tid = threadIdx.x, wg = __shfl_sync(FULL, tid >> 7, 0), warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int g = lane >> 2, q = lane & 3, ra = 16 * warp + g;
  const int L = a.L, N = a.B * a.L, G = gridDim.x, z = blockIdx.x;
  const int n_jt = (L + TJ - 1) / TJ;

  stage_weights(k1_s, k2_s, a.k1, a.k2, tid, NT);
  cp_async_commit();
  for (int v = tid; v < SLAB_BYTES / 4; v += NT) {   // the pads stay 0
    sp2[v] = 0.f;
    sg[v] = 0.f;
  }
  for (int v = tid; v < SLAB; v += NT) gslab[v] = 0.f;
  if (tid < 5) st[tid] = tid < 3 ? -1 : 0;

  // dK1 rows 64 (2 wg + m) + 16 warp + g (+ 8) and dK2 rows 16 warp + g (+
  // 8), columns 32 wg .. 32 wg + 31, of this thread, over the block's chunk.
  float dk1[2][32], dk2[16];
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    dk1[0][e] = 0.f;
    dk1[1][e] = 0.f;
  }
#pragma unroll
  for (int e = 0; e < 16; ++e) dk2[e] = 0.f;
  // Warpgroup 0's bias sums, in the x panel's columns 240 .. 255 (which give
  // only dK1's padding rows, never stored): thread t's 16 bytes, the db2 then
  // db1 sums of columns 32 c + 8 (g / 2) + 2q + g % 2 (c = 0, 1) of its warp's
  // rows, are chunk 6 + t % 2 of row t / 2 of the panel's last 64 columns.
  float* db_s = nullptr;
  if (wg == 0) {
    const int r = tid >> 1;
    db_s = reinterpret_cast<float*>(smem + S::X + 3 * PANEL + r * 128 + (((6 + (tid & 1)) ^ (r & 7)) << 4));
    *reinterpret_cast<float4*>(db_s) = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  auto flush = [&](int k) {   // the run's table partial to slot z + k; the slab to 0
    float* dst = a.tpart + (size_t)(z + k) * SLAB;
    for (int v = tid; v < SLAB; v += NT) {
      dst[v] = gslab[v];
      gslab[v] = 0.f;
    }
  };

  // One item (residue) an iteration; the window and the item in it are in
  // st[3], st[4], read after the barrier at the top and advanced by thread 0
  // after the item's first barrier.
  for (;;) {
    __syncthreads();   // the last item is done, st is current
    const int wi = st[3], idx = st[4];
    if (idx == 0) {   // a new window; w is free: it holds the order's counts
      if (sorted_window(a.aa, a.smask, N, G, z, wi, reinterpret_cast<int*>(w_s), tot, win,
                        z == 0 && wi == 0 ? a.starts : nullptr, tid, NT) == 0)
        break;
      load_i_async(pi_s, a.pos, a.amask, win.n[0], tid);
      cp_async_commit();
    }
    {
      const int n = win.n[idx], k = win.tok[idx], b = n / L;
      const float s_i = win.s[idx];
      const bool last = idx + 1 == win.count;
      // The next item's atoms into the other buffer (its last reader, item
      // idx - 1, is done, and so is the copy into it); one group an item, so
      // wait_group 1 leaves only that one in flight.
      if (!last) load_i_async(pi_s + ((idx + 1) & 1) * 256, a.pos, a.amask, win.n[idx + 1], tid);
      cp_async_commit();
      cp_async_wait_group<1>();   // this item's atoms (first also the weights)
      if (k != st[0]) {   // a new run: its table partial starts, its slabs are filled
        if (st[0] >= 0) flush(st[0]);
        fill_slabs(sp2, sg, a.table, k, tid, NT);
        if (tid == 0) st[0] = k;
      }
      __syncthreads();   // every thread's copies of this item's atoms have landed
      if (tid == 0) {
        st[3] = last ? wi + 1 : wi;
        st[4] = last ? 0 : idx + 1;
      }
      const float4* pi = pi_buf + (idx & 1) * 16;
      for (int t = 0; t < n_jt; ++t) {
        if (st[1] != b || st[2] != t) {
          load_jtile<true>(jt, a.pos, a.amask, a.aa, a.smask, L, b, t, tid, NT);
          if (tid == 0) {
            st[1] = b;
            st[2] = t;
          }
        }
        const int nlive = jt.nlive;
        if (nlive == 0) continue;
        const int j0 = t * TJ;
        for (int v = tid; v < TJ * 8; v += NT) {   // the live rows' g, 16 bytes a copy
          const int r = v >> 3, c = v & 7;
          const bool live = r < nlive;
          const bf16* src = live ? a.g + (((size_t)n * L + j0 + jt.src[r]) * F + c * 8) : a.g;
          cp_async16(gd2_s + sw128_offset(r, c), src, live);
        }
        cp_async_commit();
        build_x<NT, 2, WLD>(x_s, w_s, jt, pi, sp2, sg, tid);
        cp_async_wait_all();
        fence_proxy_async();
        __syncthreads();

        if (wg == 0) {   // the chain
          float acc[32];
          uint32_t h[16], d2f[16];
          product_a1(acc, x_s, k1_s);
          const uint32_t m1 = relu_pack(acc, a.b1, h, q);
#pragma unroll
          for (int jb = 0; jb < 8; ++jb) {
            uint32_t* hp = reinterpret_cast<uint32_t*>(h_p + pair_offset(ra, g, q, jb));
            hp[0] = h[2 * jb];
            hp[256] = h[2 * jb + 1];
          }
          product_a2(acc, h, k2_s);
          const float sa = s_i * jt.s[ra], sb = s_i * jt.s[ra + 8];
#pragma unroll
          for (int c = 0; c < 2; ++c) {   // da2 over g in place; its column sums, 32 columns at a time
            float v[8];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int jb = 4 * c + u;
              const float2 bb = __ldg(reinterpret_cast<const float2*>(a.b2 + 8 * jb + 2 * q));
              uint32_t* gp = reinterpret_cast<uint32_t*>(gd2_p + pair_offset(ra, g, q, jb));
              const float2 ga = unpack_bf16(gp[0]), gb = unpack_bf16(gp[256]);
              const float d0 = acc[4 * jb] + bb.x > 0.f ? ga.x * sa : 0.f;
              const float d1 = acc[4 * jb + 1] + bb.y > 0.f ? ga.y * sa : 0.f;
              const float d2 = acc[4 * jb + 2] + bb.x > 0.f ? gb.x * sb : 0.f;
              const float d3 = acc[4 * jb + 3] + bb.y > 0.f ? gb.y * sb : 0.f;
              d2f[2 * jb] = pack_bf16(d0, d1);
              d2f[2 * jb + 1] = pack_bf16(d2, d3);
              gp[0] = d2f[2 * jb];
              gp[256] = d2f[2 * jb + 1];
              v[2 * u] = d0 + d2;
              v[2 * u + 1] = d1 + d3;
            }
            db_s[c] += quad_column_sum(v, lane);
          }
          wgmma_fence();   // dh = bf16(da2).K2^T, K2 read K-major
#pragma unroll
          for (int s = 0; s < F / 16; ++s)
            mma_rs_n64<0>(acc, &d2f[4 * s], desc_sw128(k2_s + s * 32), s > 0);
          wgmma_commit();
          wgmma_wait_all();
          fence_regs(acc);
          fence_regs(d2f);
#pragma unroll
          for (int c = 0; c < 2; ++c) {   // da1 = dh * (a1 > 0); its column sums
            float v[8];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int jb = 4 * c + u;
              const uint32_t bits = m1 >> (4 * jb);
              const float d0 = bits & 1u ? acc[4 * jb] : 0.f;
              const float d1 = bits & 2u ? acc[4 * jb + 1] : 0.f;
              const float d2 = bits & 4u ? acc[4 * jb + 2] : 0.f;
              const float d3 = bits & 8u ? acc[4 * jb + 3] : 0.f;
              uint32_t* dp = reinterpret_cast<uint32_t*>(da1_p + pair_offset(ra, g, q, jb));
              dp[0] = pack_bf16(d0, d1);
              dp[256] = pack_bf16(d2, d3);
              v[2 * u] = d0 + d2;
              v[2 * u + 1] = d1 + d3;
            }
            db_s[2 + c] += quad_column_sum(v, lane);
          }
          fence_proxy_async();
        }
        __syncthreads();   // h, bf16(da2), bf16(da1) are in their panels

        // dx = bf16(da1).K1^T, this warpgroup's 120 columns in two parts (64,
        // then 56), each followed by its dcoef; with the first, dK1 +=
        // x^T.bf16(da1) for the warpgroup's two 64-row blocks and dK2 +=
        // h^T.bf16(da2) over its 32 pairs.
        const uint32_t k1_w = k1_s + wg * 120 * 128;
        {
          float dx[32];
          wgmma_fence();
#pragma unroll
          for (int s = 0; s < F / 16; ++s)
            mma_ss_n64<0, 0>(dx, desc_sw128(da1_s + s * 32), desc_sw128(k1_w + s * 32), s > 0);
#pragma unroll
          for (int m = 0; m < 2; ++m)
#pragma unroll
            for (int s = 0; s < TJ / 16; ++s)
              mma_ss_n64<1, 1>(dk1[m], desc_sw128_mn(x_s + (2 * wg + m) * PANEL + s * 2048, PANEL),
                               desc_sw128_mn(da1_s + s * 2048, PANEL), 1);
#pragma unroll
          for (int s = 0; s < TJ / 16; ++s)   // columns 32 wg .. of da2: 64 bytes into its rows
            mma_ss_n32<1, 1>(dk2, desc_sw128_mn(h_s + s * 2048, PANEL),
                             desc_sw128_mn(gd2_s + wg * 64 + s * 2048, PANEL), 1);
          wgmma_commit();
          wgmma_wait_all();
          fence_regs(dx);
          fence_regs(dk1[0]);
          fence_regs(dk1[1]);
          fence_regs(dk2);
          dcoef<8>(dx, w_s, ra, q, 120 * wg);
        }
        {
          float dx[28];
          wgmma_fence();
#pragma unroll
          for (int s = 0; s < F / 16; ++s)
            mma_ss_n56(dx, desc_sw128(da1_s + s * 32), desc_sw128(k1_w + 64 * 128 + s * 32), s > 0);
          wgmma_commit();
          wgmma_wait_all();
          fence_regs(dx);
          dcoef<7>(dx, w_s, ra, q, 120 * wg + 64);
        }
        __syncthreads();
        if (tid < AA2) {   // each run of equal aa_j, rows in order, into the table slab
          const float* col = w_s + tid;
          int kr = jt.aa[0];
          float run = 0.f;
          for (int r0 = 0; r0 < nlive; r0 += 16) {
            float v[16];
            int kv[16];
#pragma unroll
            for (int u = 0; u < 16; ++u) {   // rows past nlive hold zeros
              v[u] = col[(r0 + u) * WLD];
              kv[u] = jt.aa[r0 + u];
            }
#pragma unroll
            for (int u = 0; u < 16; ++u) {
              if (r0 + u < nlive) {
                if (kv[u] != kr) {
                  gslab[kr * AA2 + tid] += run;
                  run = 0.f;
                  kr = kv[u];
                }
                run += v[u];
              }
            }
          }
          gslab[kr * AA2 + tid] += run;
        }
        __syncthreads();   // w, x and the panels are free for the next tile
      }
    }
  }
  if (st[0] >= 0) flush(st[0]);

  float* part = a.wpart + (size_t)z * PB;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int row = 64 * (2 * wg + m) + ra;
#pragma unroll
    for (int jb = 0; jb < 8; ++jb) {
      if (row < AA2)
        *reinterpret_cast<float2*>(part + row * F + 8 * jb + 2 * q) =
            make_float2(dk1[m][4 * jb], dk1[m][4 * jb + 1]);
      if (row + 8 < AA2)
        *reinterpret_cast<float2*>(part + (row + 8) * F + 8 * jb + 2 * q) =
            make_float2(dk1[m][4 * jb + 2], dk1[m][4 * jb + 3]);
    }
  }
#pragma unroll
  for (int jb = 0; jb < 4; ++jb) {
    float* d = part + AA2 * F + ra * F + 32 * wg + 8 * jb + 2 * q;
    *reinterpret_cast<float2*>(d) = make_float2(dk2[4 * jb], dk2[4 * jb + 1]);
    *reinterpret_cast<float2*>(d + 8 * F) = make_float2(dk2[4 * jb + 2], dk2[4 * jb + 3]);
  }
  // db1 | db2: warpgroup 0's four warps summed in order.
  float* red = reinterpret_cast<float*>(smem + S::X);   // [4 warps][128]
  __syncthreads();
  if (wg == 0) {
    const int col = 8 * (g >> 1) + 2 * q + (g & 1);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      red[warp * 128 + 32 * c + col] = db_s[2 + c];
      red[warp * 128 + F + 32 * c + col] = db_s[c];
    }
  }
  __syncthreads();
  if (tid < 2 * F) {
    float s = 0.f;
    for (int w = 0; w < 4; ++w) s += red[w * 128 + tid];
    part[AA2 * F + F * F + tid] = s;
  }
}

constexpr int NT_R = 256;                            // reduction threads a block
constexpr int TABLE_BLOCKS = (NV * AA2 + NT_R - 1) / NT_R;
constexpr int WEIGHT_BLOCKS = (PB + 63) / 64;        // 64 outputs a block, 4 block groups each

// Blocks below TABLE_BLOCKS: d_table[k * 22 + k2][c], the partials of token
// k's blocks (chunk_of its first and last sorted position, empty chunks left
// out) in block order.
// The rest: 64 outputs of dK1 | dK2 | db1 | db2 a block, each summed over
// four groups of the main kernel's blocks in order, then the groups in order.
__global__ void __launch_bounds__(NT_R)
dist_bwd_reduce_kernel(const float* __restrict__ tpart, const float* __restrict__ wpart,
                       const int* __restrict__ starts, int G, float* __restrict__ d_table,
                       float* __restrict__ dk1, float* __restrict__ db1, float* __restrict__ dk2,
                       float* __restrict__ db2) {
  if (blockIdx.x < TABLE_BLOCKS) {
    const int i = blockIdx.x * NT_R + threadIdx.x;
    if (i >= NV * AA2) return;
    const int v = i / AA2, c = i - AA2 * v, k = v / NAA, k2 = v - NAA * k;
    const int s0 = starts[k], s1 = starts[k + 1], n_live = starts[NAA];
    float s = 0.f;
    if (s1 > s0) {   // an empty chunk between two of the token's (fewer live residues than blocks) wrote none
      const int z1 = chunk_of(s1 - 1, n_live, G);
      for (int zz = chunk_of(s0, n_live, G); zz <= z1; ++zz)
        if (chunk_start(n_live, G, zz) < chunk_start(n_live, G, zz + 1))
          s += tpart[((size_t)(zz + k) * NAA + k2) * AA2 + c];
    }
    d_table[i] = s;
    return;
  }
  __shared__ float grp_sum[4][64];
  const int o = threadIdx.x & 63, grp = threadIdx.x >> 6;
  const int j = (blockIdx.x - TABLE_BLOCKS) * 64 + o;
  float s = 0.f;
  if (j < PB) {
    const int z1 = (int)((long long)G * (grp + 1) / 4);
#pragma unroll 4
    for (int zz = (int)((long long)G * grp / 4); zz < z1; ++zz) s += wpart[(size_t)zz * PB + j];
  }
  grp_sum[grp][o] = s;
  __syncthreads();
  if (grp != 0 || j >= PB) return;
  s = (grp_sum[0][o] + grp_sum[1][o]) + (grp_sum[2][o] + grp_sum[3][o]);
  if (j < AA2 * F) dk1[j] = s;
  else if (j < AA2 * F + F * F) dk2[j - AA2 * F] = s;
  else if (j < AA2 * F + F * F + F) db1[j - AA2 * F - F * F] = s;
  else db2[j - AA2 * F - F * F - F] = s;
}

constexpr int MAX_DEVICES = 64;
bool g_smem_opt_in[MAX_DEVICES];

cudaError_t set_attributes() {
  cudaError_t err = cudaFuncSetAttribute(dist_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, Smem::BYTES);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(dist_bwd_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

}  // namespace

extern "C" int distance_embed_bwd_smem_bytes() { return Smem::BYTES; }
extern "C" int distance_embed_bwd_kernels_per_call() { return 2; }

// Blocks of the main kernel resident on one SM (-1 on an error).
extern "C" int distance_embed_bwd_blocks_per_sm() {
  int n = 0;
  if (set_attributes() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, dist_bwd_kernel, NT, Smem::BYTES) !=
          cudaSuccess)
    return -1;
  return n;
}

// Launches both kernels on `stream`; returns the first non-zero cudaError_t
// (0 on success). Scratch from the caller: tpart [grid + 21][22][225] f32,
// wpart [grid][225*64 + 64*64 + 128] f32, starts [23] int32; grid <= B * L
// blocks. aa must be 16-byte aligned (the order reads it 4 tokens at a time).
extern "C" int distance_embed_backward(const void* pos, const void* amask, const void* aa,
                                       const void* smask, const void* g, const void* table,
                                       const void* k1, const void* b1, const void* k2,
                                       const void* b2, void* tpart, void* wpart, void* starts,
                                       void* d_table, void* d_k1, void* d_b1, void* d_k2,
                                       void* d_b2, int B, int L, int grid, void* stream) {
  const long long n = (long long)B * L;
  if (B < 1 || L < 1 || n > INT_MAX || grid < 1 || grid > n) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!g_smem_opt_in[dev]) {
    err = set_attributes();
    if (err != cudaSuccess) return (int)err;
    g_smem_opt_in[dev] = true;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Args args{static_cast<const float*>(pos), static_cast<const float*>(amask),
            static_cast<const int*>(aa), static_cast<const float*>(smask),
            static_cast<const bf16*>(g), static_cast<const float*>(table),
            static_cast<const bf16*>(k1), static_cast<const float*>(b1),
            static_cast<const bf16*>(k2), static_cast<const float*>(b2),
            static_cast<float*>(tpart), static_cast<float*>(wpart), static_cast<int*>(starts), B,
            L};
  dist_bwd_kernel<<<grid, NT, Smem::BYTES, s>>>(args);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  dist_bwd_reduce_kernel<<<TABLE_BLOCKS + WEIGHT_BLOCKS, NT_R, 0, s>>>(
      static_cast<const float*>(tpart), static_cast<const float*>(wpart),
      static_cast<const int*>(starts), grid, static_cast<float*>(d_table),
      static_cast<float*>(d_k1), static_cast<float*>(d_b1), static_cast<float*>(d_k2),
      static_cast<float*>(d_b2));
  return (int)cudaGetLastError();
}
