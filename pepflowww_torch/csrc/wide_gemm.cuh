// Width-general building blocks of the production profile's kernels at the
// JAX package's 2x, 4x and 8x widths (c_z = 128, 256, 512), for Hopper,
// sm_90a: K1/K2 (edge_transition.cu), K4 (edge_transition_bwd.cu), K3
// (distance_embed.cu) and K5 (distance_embed_bwd.cu) call them through
// their *_wide_* entry points; the 1x kernels keep their own designs.
//
// Why a second design. At 1x every weight of a kernel sits in one block's
// shared memory next to its activation tile. From 2x on it cannot: W2 of the
// EdgeTransition is 295 KB at c_z = 128 and 4.7 MB at 512, against the
// 227 KB a block may hold, and one 64-pair tile's hidden row is 196 KB at
// 512. So each product of a kernel is a tiled GEMM of its own here, with the
// weights streamed through shared memory in K tiles, and the hidden
// activations of a layer kept as a bf16 scratch in device memory between
// the products (from 2x on these products are GEMM-shaped work for the
// tensor cores, which bound every one of K1-K5 there: bounds.py).
//
// The GEMM (gemm_kernel). C[m][n] = sum_k A(m, k) B(n, k) ("NT": A stored
// [M][K], B [N][K], both K-contiguous) or sum_k A(k, m) B(k, n) ("TT": both
// stored [K][*], the weight gradients X^T.Y summed over pairs). Block tile
// BM x BN x 64, warps of 64 x 32 (eight a block; four of 64 x 64 ran 1.3-1.4x
// slower on the H100), three stages of cp.async (16 bytes a thread,
// zero-filled past the edges), ldmatrix (.trans for TT) from rows padded by
// 16 bytes (conflict-free), mma.sync m16n8k16 bf16 -> fp32.
// Every operand is an Opd: up to four column segments, each from its own
// source, whose rows are either the row itself or, for a pair row p = (b L
// + i) L + j, the residue row b L + i or b L + j: so the concat row [e |
// n_i | n_j] of the EdgeTransition and the K-concatenations [h2 | e] and
// [da1 | do] are read in place, never built. A segment starts on a
// multiple of 8 columns, so no 16-byte chunk straddles two (a K tile may:
// each chunk finds its own segment).
//
// The epilogue (MODE) takes each pair of adjacent accumulator columns: bias,
// per-residue terms, ReLU, masks, bf16 rounding, the transposed readout
// writes, the split-K partial slot. Modes DA and DA2D also sum their
// (unrounded) values down the block's columns in a fixed order (lanes,
// then warps) into one partial row a block; wide_reduce_kernel adds partial
// rows or split-K slots in a fixed order. No atomics anywhere: two calls on
// the same inputs give the same bits.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <climits>
#include <cstdint>

#include "wgmma.cuh"

namespace wide {

using hopper::cp_async16;
using hopper::cp_async_commit;
using hopper::cp_async_wait_group;
using hopper::mma_m16n8k16;
using hopper::smem_u32;
typedef __nv_bfloat16 bf16;

constexpr int BK = 64;        // depth of a K tile (NT) / pairs of a K tile (TT)
constexpr int STAGES = 3;
constexpr int MAX_DEVICES = 16;

// Kernels this library has launched on its wide paths (each launch checked
// with cudaGetLastError): a check that a call runs the kernels it is
// designed to (the *_wide_launches entry points).
static std::atomic<int> g_launches{0};

// cudaGetLastError of the launch just made, counted when it is 0.
static inline int launched() {
  const int rc = (int)cudaGetLastError();
  if (rc == 0) g_launches.fetch_add(1, std::memory_order_relaxed);
  return rc;
}

enum Gather { ROW = 0, NODE_I = 1, NODE_J = 2 };
enum Mode { RELU = 0, RELU_PAIRMASK = 1, F32 = 2, RC = 3, DA = 4, DA2D = 5, DX = 6,
            READOUT = 7, PART = 8 };

// A column segment of an operand: columns [start, next start) come from p,
// row-major with leading dimension ld, its rows picked by gather.
struct Seg {
  const bf16* p;
  int ld;
  int gather;
  int start;
};
struct Opd {
  Seg s[4];
  int nseg;
};

// The source row of row r: r itself, or for a pair row r = (b L + i) L + j
// the residue row b L + i (NODE_I) or b L + j (NODE_J).
__device__ __forceinline__ int src_row(int gather, int r, int L) {
  if (gather == NODE_I) return r / L;
  if (gather == NODE_J) return (r / (L * L)) * L + r % L;
  return r;
}

// Division by a divisor fixed for a launch, for n < 2^31: a multiply-high
// and a shift (the round-up reciprocal of CUTLASS's FastDivmod).
struct Div {
  unsigned mul;
  int shr;
  int d;
};
inline Div make_div(int d) {
  Div v{0u, 0, d};
  if (d > 1) {
    int l = 0;
    while ((1ll << l) < d) ++l;   // ceil(log2 d)
    const int p = 31 + l;
    v.mul = (unsigned)(((1ull << p) + d - 1) / d);
    v.shr = p - 32;
  }
  return v;
}
__device__ __forceinline__ int divide(const Div& v, int n) {
  return v.d == 1 ? n : (int)(__umulhi((unsigned)n, v.mul) >> v.shr);
}

// A launch's pair rows r = (b L + i) L + j: L, and divisions by L and L^2.
struct Rows {
  int L;
  Div dl, dll;
};

// The residue rows b L + i and b L + j of pair row r.
__device__ __forceinline__ int2 node_rows(int r, const Rows& rw) {
  const int q = divide(rw.dl, r);
  return make_int2(q, divide(rw.dll, r) * rw.L + (r - q * rw.L));
}

// Element (r, c) of operand o, whose pair row r has residue rows nr (the
// caller computes them once a row): columns pick the segment, the segment's
// gather picks r, nr.x or nr.y.
__device__ __forceinline__ const bf16* opd_at(const Opd& o, int r, int2 nr, int c) {
  const bf16* p = o.s[0].p;
  int ld = o.s[0].ld, g = o.s[0].gather, st = 0;
#pragma unroll
  for (int q = 1; q < 4; ++q) {
    if (q < o.nseg && c >= o.s[q].start) {
      p = o.s[q].p;
      ld = o.s[q].ld;
      g = o.s[q].gather;
      st = o.s[q].start;
    }
  }
  const int row = g == NODE_I ? nr.x : g == NODE_J ? nr.y : r;
  return p + (long long)row * ld + (c - st);
}

// Whether any segment of o gathers residue rows.
__device__ __forceinline__ bool gathers(const Opd& o) {
  bool any = false;
#pragma unroll
  for (int q = 0; q < 4; ++q) any |= q < o.nseg && o.s[q].gather != ROW;
  return any;
}

// What an epilogue reads and writes; each mode uses its own fields.
struct Epi {
  const float* bias;        // [N] or null
  const float* yi;          // per-residue terms of rows b L + i, or null
  const float* yj;          // ... of rows b L + j
  int ld_y;
  float* f32;               // fp32 output [M][ld_f32] (F32), split-K slots (PART)
  int ld_f32;
  bf16* out;                // bf16 output [M][ld_out]
  int ld_out;
  uint8_t* mask_out;        // RC: a2 > 0, [M][N]
  const uint8_t* mask_in;   // DA: the ReLU's mask as bytes [M][N], or null ...
  const bf16* hmask;        // ... else where this bf16 [M][N] is above 0
  const bf16* g;            // DA2D: the output's cotangent [M][N]
  const float* pmask;       // RELU_PAIRMASK, DA2D: residue mask [B L]; pair mask s_i s_j
  Opd x;                    // RC: the residual [e | n_i | n_j]
  float* colpart;           // DA, DA2D: column sums, one row of N a block row
  void* d_edge;             // DX: columns < cz, fp32 (d_edge_f32) or bf16 [M][cz]
  int d_edge_f32;
  int cz;
  bf16* b_out;              // READOUT: (B, n_b, L, L) and (B, n_pz, L, L)
  bf16* pz_out;
  int n_b, n_pz;
};

template <int BM, int BN, bool TT>
struct Cfg {
  static constexpr int WARPS_M = BM / 64, WARPS_N = BN / 32;
  static constexpr int NT = 32 * WARPS_M * WARPS_N;
  static constexpr int A_R = TT ? BK : BM, A_C = TT ? BM : BK;
  static constexpr int B_R = TT ? BK : BN, B_C = TT ? BN : BK;
  static constexpr int A_LD = A_C + 8, B_LD = B_C + 8;   // rows padded by 16 bytes
  static constexpr int A_EL = A_R * A_LD, B_EL = B_R * B_LD, STAGE_EL = A_EL + B_EL;
  static constexpr int SMEM = STAGES * STAGE_EL * 2;
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The epilogue of accumulator columns c, c + 1 of row r (r < M, c < N, c
// even); returns what the column sums take (DA, DA2D), else zeros.
template <int MODE>
__device__ __forceinline__ float2 epilogue(const Epi& e, int r, int2 nr, int c, float v0,
                                           float v1, int LL, int M, int N) {
  if (MODE == PART) {
    *reinterpret_cast<float2*>(e.f32 + ((long long)blockIdx.z * M + r) * N + c) =
        make_float2(v0, v1);
    return make_float2(0.f, 0.f);
  }
  if (MODE == DX) {
    if (c < e.cz) {
      const long long o = (long long)r * e.cz + c;
      if (e.d_edge_f32) *reinterpret_cast<float2*>(static_cast<float*>(e.d_edge) + o) =
          make_float2(v0, v1);
      else store2(static_cast<bf16*>(e.d_edge) + o, v0, v1);
    } else {
      *reinterpret_cast<float2*>(e.f32 + (long long)r * (N - e.cz) + (c - e.cz)) =
          make_float2(v0, v1);
    }
    return make_float2(0.f, 0.f);
  }
  if (MODE == DA) {
    const long long o = (long long)r * N + c;
    bool p0, p1;
    if (e.mask_in) {
      p0 = e.mask_in[o] != 0;
      p1 = e.mask_in[o + 1] != 0;
    } else {
      const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(e.hmask + o);
      p0 = __low2float(h) > 0.f;
      p1 = __high2float(h) > 0.f;
    }
    const float d0 = p0 ? v0 : 0.f, d1 = p1 ? v1 : 0.f;
    store2(e.out + (long long)r * e.ld_out + c, d0, d1);
    return make_float2(d0, d1);
  }
  float a0 = v0, a1 = v1;
  if (e.yi) {
    const float* yi = e.yi + (long long)nr.x * e.ld_y + c;
    const float* yj = e.yj + (long long)nr.y * e.ld_y + c;
    a0 = a0 + yi[0] + yj[0];
    a1 = a1 + yi[1] + yj[1];
  }
  if (e.bias) {
    a0 += e.bias[c];
    a1 += e.bias[c + 1];
  }
  if (MODE == RELU) {
    store2(e.out + (long long)r * e.ld_out + c, fmaxf(a0, 0.f), fmaxf(a1, 0.f));
  } else if (MODE == RELU_PAIRMASK) {
    const float s = e.pmask[nr.x] * e.pmask[nr.y];
    store2(e.out + (long long)r * e.ld_out + c, fmaxf(a0, 0.f) * s, fmaxf(a1, 0.f) * s);
  } else if (MODE == F32) {
    *reinterpret_cast<float2*>(e.f32 + (long long)r * e.ld_f32 + c) = make_float2(a0, a1);
  } else if (MODE == RC) {
    const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(opd_at(e.x, r, nr, c));
    store2(e.out + (long long)r * e.ld_out + c, fmaxf(a0, 0.f) + __low2float(x),
           fmaxf(a1, 0.f) + __high2float(x));
    uchar2 m;
    m.x = a0 > 0.f;
    m.y = a1 > 0.f;
    *reinterpret_cast<uchar2*>(e.mask_out + (long long)r * N + c) = m;
  } else if (MODE == DA2D) {
    const float s = e.pmask[nr.x] * e.pmask[nr.y];
    const __nv_bfloat162 g = *reinterpret_cast<const __nv_bfloat162*>(e.g + (long long)r * N + c);
    const float d0 = a0 > 0.f ? __low2float(g) * s : 0.f;
    const float d1 = a1 > 0.f ? __high2float(g) * s : 0.f;
    store2(e.out + (long long)r * e.ld_out + c, d0, d1);
    return make_float2(d0, d1);
  } else if (MODE == READOUT) {
    const int b = r / LL, ij = r - b * LL;
    const float v[2] = {a0, a1};
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int cc = c + t;
      if (cc < e.n_b)
        e.b_out[((long long)b * e.n_b + cc) * LL + ij] = __float2bfloat16(v[t]);
      else if (cc < e.n_b + e.n_pz)
        e.pz_out[((long long)b * e.n_pz + cc - e.n_b) * LL + ij] = __float2bfloat16(v[t]);
    }
  }
  return make_float2(0.f, 0.f);
}

// C = A.B over K tiles [z kslice, min(K, (z + 1) kslice)) of this block's
// split z (blockIdx.z; only PART has more than one), through epilogue MODE.
template <int BM, int BN, bool TT, int MODE>
__global__ void __launch_bounds__(Cfg<BM, BN, TT>::NT, 2)
wide_gemm_kernel(const __grid_constant__ Opd A, const __grid_constant__ Opd Bo, int M, int N,
                 int K, int kslice, const __grid_constant__ Rows rw,
                 const __grid_constant__ Epi e) {
  using C = Cfg<BM, BN, TT>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / C::WARPS_N, wn = warp % C::WARPS_N;
  // Column tiles vary fastest, so the blocks that read one row tile of A
  // run together and fetch it from device memory once (B, the weights,
  // stays in L2).
  const int n_tiles = (N + BN - 1) / BN, m_tile = blockIdx.x / n_tiles;
  const int m0 = m_tile * BM, n0 = (blockIdx.x - m_tile * n_tiles) * BN;
  const int kbeg = blockIdx.z * kslice, kend = min(K, kbeg + kslice);
  const int nk = (kend - kbeg + BK - 1) / BK;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int t = 0; t < 4; ++t) acc[i][j][t] = 0.f;

  // A thread's 16-byte chunks of a stage: chunk t is v = tid + t NT, row v /
  // (chunks a row), column (v % (chunks a row)) 8. With NT the rows are the
  // same in every K tile, so their residue rows are found once here; with
  // TT the rows are pairs of the K tile, found a tile at a time.
  constexpr int A_CPR = C::A_C / 8, B_CPR = C::B_C / 8;   // 16-byte chunks a row
  constexpr int A_CH = C::A_R * A_CPR / C::NT, B_CH = C::B_R * B_CPR / C::NT;
  static_assert(A_CH * C::NT == C::A_R * A_CPR && B_CH * C::NT == C::B_R * B_CPR,
                "a stage's chunks split evenly over the threads");
  const bool a_gathers = gathers(A), b_gathers = gathers(Bo);
  int2 a_nr[A_CH], b_nr[B_CH];
#pragma unroll
  for (int t = 0; t < A_CH; ++t) {
    const int row = m0 + (tid + t * C::NT) / A_CPR;
    a_nr[t] = !TT && a_gathers && row < M ? node_rows(row, rw) : make_int2(0, 0);
  }
#pragma unroll
  for (int t = 0; t < B_CH; ++t) {
    const int row = n0 + (tid + t * C::NT) / B_CPR;
    b_nr[t] = !TT && b_gathers && row < N ? node_rows(row, rw) : make_int2(0, 0);
  }

  auto load = [&](int stage, int k0) {
    bf16* as = smem + stage * C::STAGE_EL;
    bf16* bs = as + C::A_EL;
#pragma unroll
    for (int t = 0; t < A_CH; ++t) {
      const int v = tid + t * C::NT, r = v / A_CPR, c = (v % A_CPR) * 8;
      const int row = TT ? k0 + r : m0 + r, col = TT ? m0 + c : k0 + c;
      const bool ok = TT ? (row < kend && col < M) : (row < M && col < kend);
      const int2 nr = TT && a_gathers && ok ? node_rows(row, rw) : a_nr[t];
      cp_async16(smem_u32(as + r * C::A_LD + c), ok ? opd_at(A, row, nr, col) : A.s[0].p, ok);
    }
#pragma unroll
    for (int t = 0; t < B_CH; ++t) {
      const int v = tid + t * C::NT, r = v / B_CPR, c = (v % B_CPR) * 8;
      const int row = TT ? k0 + r : n0 + r, col = TT ? n0 + c : k0 + c;
      const bool ok = TT ? (row < kend && col < N) : (row < N && col < kend);
      const int2 nr = TT && b_gathers && ok ? node_rows(row, rw) : b_nr[t];
      cp_async16(smem_u32(bs + r * C::B_LD + c), ok ? opd_at(Bo, row, nr, col) : Bo.s[0].p, ok);
    }
  };

  auto compute = [&](int stage) {
    const bf16* as = smem + stage * C::STAGE_EL;
    const bf16* bs = as + C::A_EL;
    const int mat = lane >> 3;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int mb = wm * 64 + mi * 16;
        if (TT)
          ldsm_x4_t(a[mi], as + (kk + (lane & 7) + ((mat >> 1) << 3)) * C::A_LD + mb +
                               ((mat & 1) << 3));
        else
          ldsm_x4(a[mi], as + (mb + (lane & 15)) * C::A_LD + kk + ((lane >> 4) << 3));
      }
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        const int nb = wn * 32 + nj * 16;
        uint32_t r[4];
        if (TT)
          ldsm_x4_t(r, bs + (kk + (lane & 7) + ((mat & 1) << 3)) * C::B_LD + nb +
                           ((mat >> 1) << 3));
        else
          ldsm_x4(r, bs + (nb + (lane & 7) + ((lane >> 4) << 3)) * C::B_LD + kk +
                         (((lane >> 3) & 1) << 3));
        b[2 * nj][0] = r[0];
        b[2 * nj][1] = r[1];
        b[2 * nj + 1][0] = r[2];
        b[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_m16n8k16(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s, kbeg + s * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait_group<STAGES - 2>();
    __syncthreads();
    const int nxt = kt + STAGES - 1;
    if (nxt < nk) load(nxt % STAGES, kbeg + nxt * BK);
    cp_async_commit();
    compute(kt % STAGES);
  }
  cp_async_wait_group<0>();
  __syncthreads();

  const int g = lane >> 2, q = lane & 3;
  float cs[4][2];
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) cs[ni][0] = cs[ni][1] = 0.f;
  // Residue rows are needed by the per-residue terms, the pair mask and the
  // residual's gathered columns.
  const bool rows_needed = e.yi != nullptr || MODE == RELU_PAIRMASK || MODE == DA2D ||
                           (MODE == RC && gathers(e.x));
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + wm * 64 + mi * 16 + g + 8 * h;
      if (r >= M) continue;
      const int2 nr = rows_needed ? node_rows(r, rw) : make_int2(0, 0);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int c = n0 + wn * 32 + ni * 8 + 2 * q;
        if (c < N) {
          const float2 s = epilogue<MODE>(e, r, nr, c, acc[mi][ni][2 * h],
                                          acc[mi][ni][2 * h + 1], rw.L * rw.L, M, N);
          cs[ni][0] += s.x;
          cs[ni][1] += s.y;
        }
      }
    }
  if (MODE == DA || MODE == DA2D) {
    float* red = reinterpret_cast<float*>(smem_raw);   // [WARPS_M][BN]
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        float v = cs[ni][t];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (g == 0) red[wm * BN + wn * 32 + ni * 8 + 2 * q + t] = v;
      }
    __syncthreads();
    for (int t = tid; t < BN; t += C::NT) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < C::WARPS_M; ++w) s += red[w * BN + t];
      if (n0 + t < N) e.colpart[(long long)m_tile * N + n0 + t] = s;
    }
  }
}

// One GEMM launch: grid (M / BM, N / BN, splits of K by kslice).
template <int BM, int BN, bool TT, int MODE>
static int gemm(const Opd& A, const Opd& B, int M, int N, int K, int kslice, int L,
                const Epi& e, cudaStream_t stream) {
  using C = Cfg<BM, BN, TT>;
  static bool opt_in[MAX_DEVICES];
  if (M <= 0 || N <= 0 || K <= 0) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  auto kernel = wide_gemm_kernel<BM, BN, TT, MODE>;
  if (!opt_in[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return (int)err;
    opt_in[dev] = true;
  }
  if (kslice <= 0) kslice = K;
  const long long tiles = (long long)((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  if (tiles > INT_MAX) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, 1, (K + kslice - 1) / kslice);
  const Rows rw{L, make_div(L), make_div(L * L)};
  kernel<<<grid, C::NT, C::SMEM, stream>>>(A, B, M, N, K, kslice, rw, e);
  return launched();
}

// out[i] = sum over s < S of part[s stride + i], for i < count: a block
// takes 32 consecutive i (a lane each, so a warp's loads are one 128-byte
// row), its 8 warps the slots s = w, w + 8, ... in order, then the warps'
// sums in warp order. A fixed order, so the same bits every call.
constexpr int RED_WARPS = 8;

__global__ void __launch_bounds__(RED_WARPS * 32)
wide_reduce_kernel(const float* __restrict__ part, float* __restrict__ out, int S,
                   long long stride, int count) {
  __shared__ float red[RED_WARPS][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int i = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (i < count) {
#pragma unroll 4
    for (int k = w; k < S; k += RED_WARPS) s += part[k * stride + i];
  }
  red[w][lane] = s;
  __syncthreads();
  if (w == 0 && i < count) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < RED_WARPS; ++k) t += red[k][lane];
    out[i] = t;
  }
}

static inline int reduce(const float* part, float* out, int S, long long stride, int count,
                         cudaStream_t stream) {
  if (count <= 0) return 0;
  wide_reduce_kernel<<<(count + 31) / 32, RED_WARPS * 32, 0, stream>>>(part, out, S, stride,
                                                                        count);
  return launched();
}

inline Seg seg(const void* p, int ld, int start = 0, int gather = ROW) {
  return Seg{static_cast<const bf16*>(p), ld, gather, start};
}
inline Opd opd(Seg a) {
  Opd o{};
  o.s[0] = a;
  o.nseg = 1;
  return o;
}
inline Opd opd(Seg a, Seg b) {
  Opd o = opd(a);
  o.s[1] = b;
  o.nseg = 2;
  return o;
}
inline Opd opd(Seg a, Seg b, Seg c) {
  Opd o = opd(a, b);
  o.s[2] = c;
  o.nseg = 3;
  return o;
}
inline Opd opd(Seg a, Seg b, Seg c, Seg d) {
  Opd o = opd(a, b, c);
  o.s[3] = d;
  o.nseg = 4;
  return o;
}

// Runs each step in order and stops at the first nonzero cudaError_t.
#define WIDE_TRY(x)            \
  do {                         \
    const int rc_ = (x);       \
    if (rc_ != 0) return rc_;  \
  } while (0)

}  // namespace wide
