// The tile that the distance-embedding kernels share, for Hopper, sm_90a:
// K3 (distance_embed.cu, forward) and K5 (distance_embed_bwd.cu, backward).
//
// Work item: a residue n = b * L + i of the batch against the residues j of
// its batch row, in tiles of TJ = 64 (j0 = 64 jt; the last tile ragged).
// Row r of a tile is one pair (i, j). For each pair the 225-wide gaussian
// row x[a * 15 + a'] = bf16(exp(-softplus(coef) * d2) * m_i[a] * m_j[a'])
// is built straight into a K-major, 128-byte swizzled x panel (wgmma.cuh),
// 240 columns wide (zeros from 225), so that the panel is also the MN-major
// A operand of K5's dK1 = x^T.bf16(da1) over four 64-column blocks; columns
// 240 .. 255, which give only dK1's padding rows, are not written here. d2
// is the fp32 difference form |pos_i[a] - pos_j[a']|^2. A thread builds 4
// columns of a row at a time, so that a warp's 16-byte shared-memory loads
// and stores are consecutive (build_x).
//
// The walk. Pair (i, j) reads table row aa_i * 22 + aa_j, so the pairs of
// residue i touch only the 22 rows of aa_i. Blocks take contiguous chunks
// of the live residues (s_i != 0) in a stable order by token
// (sorted_window, built on the device from the (B, L) tokens and masks: a
// count over per-thread segments, a scan, a second walk; no host sync).
// Block z of G takes the sorted positions [N_live z / G, N_live (z + 1) /
// G): the same number of live residues each, since a residue whose s_i is
// 0 has no work (K3 writes its zero rows apart). At the start of each run
// of equal aa_i the block fills a coefficient slab in shared memory,
// softplus(table[aa_i * 22 + k][c]) * log2(e) for k < 22 (K5 also the
// sigmoid), once per entry and run, so the gaussian of an atom pair is one
// ex2.approx. The next residue's atoms arrive by cp.async during this
// one's tiles; a j tile's data stays while consecutive residues share a
// batch row.
//
// A pair row is "live" when j < L and the structure mask s_j is not 0; a
// row that is not live has its atom masks set to 0, so it is all zero in x
// with no test (the forward's output there is relu(.) * s_i * s_j = 0, and it
// adds nothing to any gradient). K5 puts the live rows of a tile first,
// sorted stably by aa_j (load_jtile with SORT), so that its table gradient
// is a segmented column sum over runs of rows.
//
// Products of one warpgroup on a tile: a1 = x.K1 (m64n64k16 x 15, A = the
// x panel, B = K1 [240][64] read MN-major), h = bf16(relu(a1 + b1)) as the
// A operand from registers of a2 = h.K2 (K2 [64][64] read MN-major). K1 and
// K2 are staged once a block as 128-byte swizzled rows (stage_weights); K5
// also reads them K-major for dx = bf16(da1).K1^T and dh = bf16(da2).K2^T.

#pragma once

#include "wgmma.cuh"

namespace dist {

using namespace hopper;
typedef __nv_bfloat16 bf16;

constexpr int A = 15;               // heavy atoms a residue
constexpr int AA2 = A * A;          // atom pairs: the gaussian row's width
constexpr int KP = 240;             // AA2 padded to the products' depth steps (k1's rows)
constexpr int F = 64;               // features
constexpr int NAA = 22;             // token vocabulary
constexpr int NV = NAA * NAA;       // table rows
constexpr int TJ = 64;              // pairs a tile
constexpr int PANEL = TJ * 128;     // 64 rows of 128 bytes
constexpr int X_BYTES = 4 * PANEL;  // the x panel: 256 columns
constexpr int K1_BYTES = KP * 128;  // K1 [240][64] bf16
constexpr int K2_BYTES = F * 128;   // K2 [64][64] bf16
constexpr int SLAB_LD = 228;        // a coefficient slab's row stride (16-byte rows)
constexpr int SLAB_BYTES = NAA * SLAB_LD * 4;
constexpr int LIST = 64;            // items of a window of the block's chunk
constexpr float LOG2E = 1.4426950408889634f;

// The data of a j tile. Positions and atom masks as (x, y, z, m) and raw_aa
// (the token, NAA where the row is not live) are in source order, row j -
// j0; the tile's row r is source row src[r], with its token aa[r] (0 where
// not live) and structure mask s[r] (0 where not live). Without SORT, src[r]
// = r; with SORT the live rows come first, sorted stably by token, those of
// token k being rows run[k] .. run[k + 1] - 1, nlive in all.
struct JTile {
  float4 pos[TJ][A];
  int aa[TJ];
  float s[TJ];
  int src[TJ];
  int raw_aa[TJ];
  int run[NAA + 1];
  int nlive;
};

__device__ __forceinline__ int token(int v) {   // out-of-range tokens would index past the table
  return min(max(v, 0), NAA - 1);
}

// 2^x, a result below 2^-126 flushed to 0 (a term of a1 below 1e-38).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

// 4 bytes global -> shared, asynchronously; zero-filled when !valid (src
// must still be a valid address).
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

// K1 [240][64] and K2 [64][64] (bf16, row-major) into 128-byte swizzled
// rows at k1_s, k2_s, by cp.async (the caller commits and waits).
__device__ __forceinline__ void stage_weights(uint32_t k1_s, uint32_t k2_s,
                                              const bf16* __restrict__ k1,
                                              const bf16* __restrict__ k2, int tid, int nt) {
  for (int v = tid; v < (KP + F) * 8; v += nt) {
    const int r = v >> 3, c = v & 7;
    if (r < KP) cp_async16(k1_s + sw128_offset(r, c), k1 + r * F + c * 8, true);
    else cp_async16(k2_s + sw128_offset(r - KP, c), k2 + (r - KP) * F + c * 8, true);
  }
}

// Exclusive scan of v over the block's nt threads (a multiple of 32, at
// most 1024); `tot` is 32 ints of shared memory. Ends with a barrier.
__device__ __forceinline__ int block_exclusive_scan(int v, int* tot, int tid, int nt) {
  const int lane = tid & 31, warp = tid >> 5;
  int x = v;
#pragma unroll
  for (int m = 1; m < 32; m <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, m);
    if (lane >= m) x += y;
  }
  if (lane == 31) tot[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int t = lane < nt / 32 ? tot[lane] : 0;
#pragma unroll
    for (int m = 1; m < 32; m <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, t, m);
      if (lane >= m) t += y;
    }
    tot[lane] = t;   // inclusive over warps
  }
  __syncthreads();
  const int before = warp > 0 ? tot[warp - 1] : 0;
  __syncthreads();   // tot may be reused
  return before + x - v;
}

// The window's items: residue n = b * L + i, its token, its structure mask;
// their count.
struct Window {
  int n[LIST];
  int tok[LIST];
  float s[LIST];
  int count;
};

// Window wi of block z's chunk of the live residues (s_i != 0) in a stable
// order by token: the chunk is the sorted positions [N_live z / G, N_live (z
// + 1) / G), the window its items wi LIST .. wi LIST + LIST - 1, into win;
// returns their count (0 past the chunk's end). Residues whose s_i is 0 sort
// after every live one, in a bucket of their own, and are in no chunk.
// Thread t walks the residues [t S, t S + S) (S a multiple of 4, 16-byte
// loads), so the order is by (bucket, t, position in the segment): stable.
// `cnt` is (NAA + 1) * nt ints of scratch, `tot` 32 ints. With `starts`
// (global, NAA + 1 ints) the bucket starts are written there too, the last
// being N_live. Ends with a barrier.
__device__ inline int sorted_window(const int* __restrict__ aa, const float* __restrict__ smask,
                                    int N, int G, int z, int wi, int* cnt, int* tot, Window& win,
                                    int* __restrict__ starts, int tid, int nt) {
  constexpr int NB = NAA + 1;
  const int S = ((N + nt - 1) / nt + 3) & ~3;
  const long long n0 = (long long)tid * S;
  const int n1 = (int)min((long long)N, n0 + S);
  for (int k = 0; k < NB; ++k) cnt[k * nt + tid] = 0;
  auto bucket = [](int v, float s) { return s != 0.f ? token(v) : NAA; };
  auto walk = [&](auto&& visit) {   // 16 residues a step, their loads in flight together
    for (int n = (int)min(n0, (long long)N); n < n1; n += 16) {
      int4 v[4];
      float4 s[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (n + 4 * u + 4 <= n1) {
          v[u] = *reinterpret_cast<const int4*>(aa + n + 4 * u);
          s[u] = *reinterpret_cast<const float4*>(smask + n + 4 * u);
        }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int m = n + 4 * u;
        if (m + 4 <= n1) {
          visit(m, bucket(v[u].x, s[u].x), s[u].x);
          visit(m + 1, bucket(v[u].y, s[u].y), s[u].y);
          visit(m + 2, bucket(v[u].z, s[u].z), s[u].z);
          visit(m + 3, bucket(v[u].w, s[u].w), s[u].w);
        } else {
          for (int e = m; e < n1; ++e) visit(e, bucket(aa[e], smask[e]), smask[e]);
        }
      }
    }
  };
  walk([&](int, int k, float) { cnt[k * nt + tid] += 1; });
  __syncthreads();
  // Exclusive scan of cnt flattened (k, t): thread t scans entries NB t .. NB t + NB - 1.
  int sum = 0;
  for (int e = 0; e < NB; ++e) sum += cnt[tid * NB + e];
  int run = block_exclusive_scan(sum, tot, tid, nt);
  for (int e = 0; e < NB; ++e) {
    const int c = cnt[tid * NB + e];
    cnt[tid * NB + e] = run;
    run += c;
  }
  __syncthreads();
  const int n_live = cnt[NAA * nt];
  if (starts != nullptr && tid <= NAA) starts[tid] = cnt[tid * nt];
  const long long p1 = (long long)n_live * (z + 1) / G;
  const long long w0 = (long long)n_live * z / G + (long long)wi * LIST;
  const long long w1 = min(w0 + LIST, p1);
  if (w1 <= w0) return 0;   // the same for every thread: no barrier is skipped by some
  walk([&](int n, int k, float s) {
    const long long p = cnt[k * nt + tid]++;
    if (p >= w0 && p < w1) {
      win.n[p - w0] = n;
      win.tok[p - w0] = k;
      win.s[p - w0] = s;
    }
  });
  if (tid == 0) win.count = (int)(w1 - w0);
  __syncthreads();
  return (int)(w1 - w0);
}

// Loads the j tile jt of batch row b into `t` (see JTile). Ends with a
// barrier, the positions landed.
template <bool SORT>
__device__ inline void load_jtile(JTile& t, const float* __restrict__ pos,
                                  const float* __restrict__ amask, const int* __restrict__ aa,
                                  const float* __restrict__ smask, int L, int b, int jt, int tid,
                                  int nt) {
  const int j0 = jt * TJ, nj = min(TJ, L - j0);
  const long long row0 = (long long)b * L + j0;
  // Positions and atom masks straight into the (x, y, z, m) slots, 4 bytes a
  // copy, all in flight at once, beside the tokens' and masks' loads; zeros
  // past L.
  const uint32_t pos_s = smem_u32(&t.pos[0][0]);
  for (int v = tid; v < TJ * A * 4; v += nt) {
    const int r = v / (A * 4), e = v - (A * 4) * r, a2 = e >> 2, c = e & 3;
    const bool in = r < nj;
    const long long at = (row0 + r) * A + a2;
    cp_async4(pos_s + (uint32_t)((r * A + a2) * 16 + c * 4),
              !in ? pos : c < 3 ? pos + at * 3 + c : amask + at, in);
  }
  cp_async_commit();
  int a_r = NAA;
  float s_r = 0.f;
  if (tid < TJ) {
    if (tid < nj) {
      s_r = smask[row0 + tid];
      if (s_r != 0.f) a_r = token(aa[row0 + tid]);
    }
    t.raw_aa[tid] = a_r;
  }
  __syncthreads();
  if (tid < TJ) {
    int rank = tid;
    if (SORT) {
      rank = 0;
#pragma unroll 16
      for (int k = 0; k < TJ; ++k) {
        const int ak = t.raw_aa[k];
        rank += ak < a_r || (ak == a_r && k < tid);
      }
    }
    const bool live = a_r < NAA;
    t.src[rank] = tid;
    t.aa[rank] = live ? a_r : 0;
    t.s[rank] = live ? s_r : 0.f;
  }
  if (SORT && tid >= TJ && tid <= TJ + NAA) {
    const int k = tid - TJ;
    int c = 0;
#pragma unroll 16
    for (int r = 0; r < TJ; ++r) c += t.raw_aa[r] < k;
    t.run[k] = c;
    if (k == NAA) t.nlive = c;
  }
  cp_async_wait_all();
  __syncthreads();
  // The atom masks of a row that is not live to 0: its gaussian row is then
  // 0 with no test.
  if (tid < nj && a_r == NAA)
    for (int a2 = 0; a2 < A; ++a2) t.pos[tid][a2].w = 0.f;
  __syncthreads();
}

// Residue n's atoms as (x, y, z, m) into the 15 float4 at pi_s, by cp.async
// (the caller commits, waits and synchronizes).
__device__ __forceinline__ void load_i_async(uint32_t pi_s, const float* __restrict__ pos,
                                             const float* __restrict__ amask, long long n,
                                             int tid) {
  if (tid < A * 4) {
    const int a = tid >> 2, c = tid & 3;
    cp_async4(pi_s + tid * 4, c < 3 ? pos + (n * A + a) * 3 + c : amask + n * A + a, true);
  }
}

// The coefficient slabs of token k: the table rows k * 22 .. k * 22 + 21 by
// cp.async into sp2 (4 bytes a copy, all in flight), then in place sp2[k2][c]
// = softplus(table[k * 22 + k2][c]) * log2(e) and, with sg, sg[k2][c] =
// sigmoid(table[...]): once per entry and run. Every thread's other cp.async
// groups are waited for too. Ends with a barrier.
__device__ inline void fill_slabs(float* sp2, float* sg, const float* __restrict__ table, int k,
                                  int tid, int nt) {
  const float* t = table + (size_t)k * NAA * AA2;
  const uint32_t sp2_s = smem_u32(sp2);
  for (int v = tid; v < NAA * AA2; v += nt) {
    const int k2 = v / AA2;
    cp_async4(sp2_s + (uint32_t)((v + k2 * (SLAB_LD - AA2)) * 4), t + v, true);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  for (int v = tid; v < NAA * AA2; v += nt) {
    const int k2 = v / AA2, at = v + k2 * (SLAB_LD - AA2);
    const float x = sp2[at];
    sp2[at] = softplus(x) * LOG2E;
    if (sg != nullptr) sg[at] = 1.f / (1.f + expf(-x));
  }
  __syncthreads();
}

// A thread's 4 columns c0 .. c0 + 3 of the gaussian row: residue i's atom a
// of each (p, zeros past column 224) and the byte offset of atom a' in a j
// row's 15 (x, y, z, m).
struct Quad {
  float4 p[4];
  int q_off[4];
  int c0;
};

// One row r of the thread's 4 columns: x into xv, and with W w = x * (-d2) *
// sigmoid(coef) into wv. No test: a row that is not live has atom masks 0
// (load_jtile), and a column past 224 has residue i's atom mask 0.
template <bool W>
__device__ __forceinline__ void gaussian_row(float (&xv)[4], float (&wv)[4], const JTile& t, int r,
                                             const Quad& qd, const float* __restrict__ sp2,
                                             const float* __restrict__ sg) {
  const int k = t.aa[r];
  const char* pj = reinterpret_cast<const char*>(t.pos[t.src[r]]);
  const float4 spv = *reinterpret_cast<const float4*>(sp2 + k * SLAB_LD + qd.c0);
  const float sp[4] = {spv.x, spv.y, spv.z, spv.w};
  float sgv[4];
  if (W) {
    const float4 v = *reinterpret_cast<const float4*>(sg + k * SLAB_LD + qd.c0);
    sgv[0] = v.x; sgv[1] = v.y; sgv[2] = v.z; sgv[3] = v.w;
  }
  float4 q[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) q[u] = *reinterpret_cast<const float4*>(pj + qd.q_off[u]);
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const float4 p = qd.p[u];
    const float dx = p.x - q[u].x, dy = p.y - q[u].y, dz = p.z - q[u].z;
    const float d2 = dx * dx + dy * dy + dz * dz;
    xv[u] = ex2(-(sp[u] * d2)) * (p.w * q[u].w);
    if (W) wv[u] = xv[u] * (-d2) * sgv[u];
  }
}

// The x panel of a tile (rows in t's order): thread `tid` of NT builds the 4
// columns 4 (tid % 64) .. + 3 of rows tid / 64, + NT / 64, ..., ROWS rows at a
// time, so that a warp's 16-byte loads of a slab row and stores of w are
// consecutive and its 8-byte stores of x fill half a panel row. With WLD >
// 0 also w[r * WLD + c] = e * m_i * m_j * (-d2) * sigmoid(coef) in fp32,
// the factor of dx in K5's dcoef (zero past column 224). Rows that are not
// live are zero in both (their atom masks are 0).
template <int NT, int ROWS, int WLD>
__device__ __forceinline__ void build_x(uint32_t x_s, float* __restrict__ w, const JTile& t,
                                        const float4* __restrict__ pi,
                                        const float* __restrict__ sp2,
                                        const float* __restrict__ sg, int tid) {
  constexpr int RSTEP = NT / 64;
  static_assert(TJ % (RSTEP * ROWS) == 0, "whole row groups");
  static_assert(WLD == 0 || WLD % 4 == 0, "16-byte rows of w");
  const int c4 = tid & 63;
  const bool cols = 4 * c4 < AA2;   // quads from 57 on lie past column 224: zeros
  Quad qd;
  qd.c0 = cols ? 4 * c4 : 4 * 56;   // the slab's columns past 224 are not read
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int c = 4 * c4 + u, a = min(c / A, A - 1), a2 = c - A * a;
    qd.p[u] = c < AA2 ? pi[a] : make_float4(0.f, 0.f, 0.f, 0.f);
    qd.q_off[u] = c < AA2 ? a2 * 16 : 0;
  }
  // Byte offset in the panel row: chunk (c4 % 16) / 2, half c4 % 2.
  const uint32_t xc = x_s + (c4 >> 4) * PANEL + (c4 & 1) * 8;
  const int chunk = (c4 & 15) >> 1;
  for (int r0 = tid >> 6; r0 < TJ; r0 += RSTEP * ROWS) {
    float xv[ROWS][4], wv[ROWS][4];
#pragma unroll
    for (int k = 0; k < ROWS; ++k) gaussian_row<(WLD > 0)>(xv[k], wv[k], t, r0 + k * RSTEP, qd, sp2, sg);
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      const int r = r0 + k * RSTEP;
      if (c4 < KP / 4)   // columns 240 .. 255: not read by a1 (K5 keeps its bias sums there)
        asm volatile("st.shared.v2.u32 [%0], {%1, %2};\n" ::"r"(
                         xc + r * 128 + ((chunk ^ (r & 7)) << 4)),
                     "r"(pack_bf16(xv[k][0], xv[k][1])), "r"(pack_bf16(xv[k][2], xv[k][3]))
                     : "memory");
      if (WLD > 0 && cols)
        *reinterpret_cast<float4*>(w + r * WLD + 4 * c4) = make_float4(wv[k][0], wv[k][1], wv[k][2], wv[k][3]);
    }
  }
}

// a1 = x.K1 for the warpgroup: A the x panel (K-major, 15 depth steps), B
// K1 read MN-major. Waited for.
__device__ __forceinline__ void product_a1(float (&acc)[32], uint32_t x_s, uint32_t k1_s) {
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < KP / 16; ++s)
    mma_ss_n64<0, 1>(acc, desc_sw128(x_s + (s >> 2) * PANEL + (s & 3) * 32),
                     desc_sw128_mn(k1_s + s * 2048, PANEL), s > 0);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(acc);
}

// h = bf16(relu(a1 + b1)) as A fragments (blocks 2s, 2s + 1 are depth step
// s of the next product); returns the bits of a1 + b1 > 0, four a block:
// (row ra, col 2q), (ra, 2q + 1), (ra + 8, 2q), (ra + 8, 2q + 1).
__device__ __forceinline__ uint32_t relu_pack(const float (&acc)[32], const float* b1,
                                              uint32_t (&h)[16], int q) {
  uint32_t bits = 0u;
#pragma unroll
  for (int jb = 0; jb < 8; ++jb) {
    const float2 bb = *reinterpret_cast<const float2*>(b1 + 8 * jb + 2 * q);
    const float v0 = acc[4 * jb] + bb.x, v1 = acc[4 * jb + 1] + bb.y;
    const float v2 = acc[4 * jb + 2] + bb.x, v3 = acc[4 * jb + 3] + bb.y;
    h[2 * jb] = pack_bf16_relu(v0, v1);
    h[2 * jb + 1] = pack_bf16_relu(v2, v3);
    bits |= ((v0 > 0.f) | (v1 > 0.f) << 1 | (v2 > 0.f) << 2 | (v3 > 0.f) << 3) << (4 * jb);
  }
  return bits;
}

// a2 = h.K2 for the warpgroup: A from registers, B K2 read MN-major. Waited for.
__device__ __forceinline__ void product_a2(float (&acc)[32], uint32_t (&h)[16], uint32_t k2_s) {
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < F / 16; ++s)
    mma_rs_n64<1>(acc, &h[4 * s], desc_sw128_mn(k2_s + s * 2048, PANEL), s > 0);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(acc);
  fence_regs(h);
}

// Byte offset of the thread's bf16 pair (row ra, columns 8 jb + 2q, + 1) in
// a 64-column swizzled panel; row ra + 8 is 1024 bytes on (ra % 8 = g).
__device__ __forceinline__ uint32_t pair_offset(int ra, int g, int q, int jb) {
  return (uint32_t)(ra * 128 + ((jb ^ g) << 4) + 4 * q);
}

// Block z's sorted positions [p0, p1) of N among G blocks, and the block
// that holds position p (the reduction's inverse).
__device__ __forceinline__ long long chunk_start(int N, int G, int z) {
  return (long long)N * z / G;
}
__device__ __forceinline__ int chunk_of(long long p, int N, int G) {
  return (int)(((long long)G * (p + 1) - 1) / N);
}

}  // namespace dist
