// IPA attention core (v1) on global-frame points, forward, for Hopper, sm_90a.
//
// Replaces: pepflowww_tpu/models/pallas_ipa.py::fused_ipa_attention (body
// `_kernel`, grid (batch, head)) and ::fused_ipa_attention_bh (body
// `_kernel_bh`, grid (batch,), heads by fori_loop): the two compute the same
// function, so one kernel serves both.
//
// Per batch row b and head h, head-major inputs (B, H, L, *):
//   s[i, j] = q_i.k_j * s1 + bias[i, j] * s2
//             - (|qp_i|^2 + |kp_j|^2 - 2 qp_i.kp_j) / 2 + maskb[j]
//   a = softmax_j(s)                                             (fp32)
//   o[i]      = sum_j cast(a[i, j]) v_j     (cast: to v's dtype and back)
//   o_pt[i]   = sum_j a[i, j] vp_j          (global-frame value points)
//   o_pair[i] = sum_j a[i, j] pz[i, j]      (pz (B, L, L, CZ4))
// with s1 = 1/sqrt(3C), s2 = 1/sqrt(3), the points pre-scaled by
// sqrt(head weight) by the caller, and maskb = inf * (mask - 1) per key.
// q, k, v, bias and pz arrive as fp32 or bf16 (one type for all five),
// points and outputs are fp32. Widths: the model's (C 128, Pq 8, Pv 12,
// CZ4 16) and the JAX tests' (C 32, Pq 4, Pv 6, CZ4 8); any L.
//
// What bounds it on this card: the bytes (bf16 scalar inputs, pair bias and
// pair features, fp32 points and outputs: ~72 MB at B=64, L=64, H 8: ~22 us
// at 3.35 TB/s); the operations (~0.27 G MACs a call on the tensor cores'
// share, ~0.2 G fp32) take less. Beyond the bytes, the pair tile pz[b, i,
// j, :] is read by each of the H heads' blocks (from L2 after the first).
//
// Two kernels, one launch a call:
//
// * bf16 inputs at the model's widths (the configuration the model would
//   feed): the attention core of the fused IPA forward (K7, ipa2.cu), whose
//   pieces it shares (ipa2_tile.cuh, namespace ipa2::fwd), without the
//   frames. One block of one warpgroup (128 threads) per (b, h, 64 query
//   rows); keys in tiles of 64. Per key tile: Q (once), K and V rows (256
//   contiguous bytes each) by cp.async 16-byte copies into 128-byte
//   swizzled panels, and for L % 8 == 0 the bias tile as rows of 64
//   contiguous keys (else the logits read the bias rows in place); the key
//   points (24 fp32) with |kp|^2 and the value points (36) of the tile's 64
//   rows into shared memory, one thread a row and kind; the two query rows'
//   points of each thread in registers. S = Q.K^T on wgmma (m64n64k16 x
//   8), the point term, bias, mask and scales added in fp32 in the
//   accumulator layout (-inf past the ragged edge); the softmax in
//   registers, a row's 64 logits on one quad. For L <= 64 the row is whole
//   and one pass over the keys normalizes a before its bf16 rounding; for L
//   > 64 a first pass takes the logits alone (each row's max and sum), so
//   the rounding point stays the JAX kernel's. o += bf16(a).V on wgmma (the
//   accumulator's packed bf16 pairs as the A fragment, V MN-major through
//   the transpose-B immediate), written to o's rows and, past the first key
//   tile, taken back from there. o_pt and o_pair from the fp32 a in shared
//   memory on the fp32 cores, thread (row, half) summing 18 point columns
//   and 8 pair channels, the pair rows pz[b, i, j:j+8, :] streamed through
//   a per-thread ring of 8-key chunks (16-byte copies of 8 channels of one
//   key) that K7 uses for training's pair layout. No (L, L) matrix is
//   stored; 109,056 bytes of shared memory, two blocks an SM.
//
// * fp32 inputs (held to 1e-3 + 1e-4 |plain|, which needs fp32 products:
//   TF32 tensor cores would not meet it) and the JAX tests' widths (which
//   only those tests use): the first version, on the fp32 cores. One block
//   owns (b, h, 32 query rows) and streams 32-key tiles through shared
//   memory twice (first the softmax's row max and sum, then the normalized
//   weights and the three aggregations, recomputing the logits), so no (L,
//   L) matrix is stored and every L runs.

#include <atomic>

#include "ipa2_tile.cuh"

namespace {

// Launches of each kernel that the runtime accepted (cudaGetLastError 0):
// [0] the tensor-core kernel, [1] the fp32 one (ipa1_kernel_launches).
std::atomic<int> g_launches[2];

// cudaGetLastError of the launch just made of kernel `which`, counted when 0.
int launched(int which) {
  const int rc = (int)cudaGetLastError();
  if (rc == 0) g_launches[which].fetch_add(1, std::memory_order_relaxed);
  return rc;
}

// ---------------------------------------------------------------- fp32 cores
namespace scalar {

typedef __nv_bfloat16 bf16;

constexpr int TILE = 32;   // query rows and key rows per tile
constexpr int NT = 256;    // threads per block: 32 rows x 8 lanes
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
// x rounded to the inputs' type and back (a.astype(v.dtype) in the JAX kernel).
__device__ __forceinline__ float round_as(float x, const float*) { return x; }
__device__ __forceinline__ float round_as(float x, const bf16*) {
  return __bfloat162float(__float2bfloat16(x));
}

constexpr int align16(int x) { return (x + 15) / 16 * 16; }

template <typename E, int C, int P3Q, int P3V, int CZ4>
struct Smem {
  static constexpr int LDC = C + 4 / (int)sizeof(E);   // odd word count: columns conflict-free
  static constexpr int LDQ = P3Q + 1;
  static constexpr int LDV = P3V + 1;
  static constexpr int LDP = TILE + 1;
  static constexpr int LDZ = TILE * CZ4 + 8;
  static constexpr int OFF_Q = 0;                                               // E [T][LDC]
  static constexpr int OFF_K = align16(OFF_Q + TILE * LDC * (int)sizeof(E));    // E [T][LDC]
  static constexpr int OFF_V = align16(OFF_K + TILE * LDC * (int)sizeof(E));    // E [T][LDC]
  static constexpr int OFF_Z = align16(OFF_V + TILE * LDC * (int)sizeof(E));    // E [T][LDZ]
  static constexpr int OFF_QP = align16(OFF_Z + TILE * LDZ * (int)sizeof(E));   // f32 [T][LDQ]
  static constexpr int OFF_KP = OFF_QP + align16(TILE * LDQ * 4);               // f32 [T][LDQ]
  static constexpr int OFF_VP = OFF_KP + align16(TILE * LDQ * 4);               // f32 [T][LDV]
  static constexpr int OFF_P = OFF_VP + align16(TILE * LDV * 4);                // f32 [T][LDP]
  static constexpr int OFF_SQ = OFF_P + align16(TILE * LDP * 4);                // qsq, ksq, mb
  static constexpr int BYTES = OFF_SQ + 3 * TILE * 4;
};

struct Args {
  const void *q, *k, *v, *bias, *pz;
  const float *qp, *kp, *vp, *maskb;
  float *o, *opt, *opair;
  int B, L, H;
  float s1, s2;
};

// Rows [r0, r0 + n) of a head's (L, W) matrix `src` into a [T][ld] tile;
// rows >= n are zero.
template <typename E, typename D>
__device__ __forceinline__ void load_rows(D* dst, int ld, const E* src, int W, int r0, int n,
                                          int tid) {
  for (int idx = tid; idx < TILE * W; idx += NT) {
    const int r = idx / W, c = idx % W;
    dst[r * ld + c] = r < n ? static_cast<D>(src[(long long)(r0 + r) * W + c]) : static_cast<D>(0.f);
  }
}

template <int P3>
__device__ __forceinline__ void row_sq(float* sq, const float* g, int ld, int tid) {
  if (tid < TILE) {
    float s = 0.f;
#pragma unroll
    for (int x = 0; x < P3; ++x) s = fmaf(g[tid * ld + x], g[tid * ld + x], s);
    sq[tid] = s;
  }
}

__device__ __forceinline__ void online(float& m, float& l, float s) {
  if (s == -INFINITY) return;
  const float mn = fmaxf(m, s);
  l = (m == -INFINITY ? 0.f : l * expf(m - mn)) + expf(s - mn);
  m = mn;
}

// Row max and sum of exp held by a row's 8 lanes as running (m, l) pairs,
// combined by a butterfly: every lane ends with the same values.
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

template <typename E, int C, int P3Q, int P3V, int CZ4>
__global__ void __launch_bounds__(NT) ipa1_fwd_kernel(const Args a) {
  using S = Smem<E, C, P3Q, P3V, CZ4>;
  extern __shared__ __align__(16) unsigned char smem[];
  E* q_s = reinterpret_cast<E*>(smem + S::OFF_Q);
  E* k_s = reinterpret_cast<E*>(smem + S::OFF_K);
  E* v_s = reinterpret_cast<E*>(smem + S::OFF_V);
  E* z_s = reinterpret_cast<E*>(smem + S::OFF_Z);
  float* qp_s = reinterpret_cast<float*>(smem + S::OFF_QP);
  float* kp_s = reinterpret_cast<float*>(smem + S::OFF_KP);
  float* vp_s = reinterpret_cast<float*>(smem + S::OFF_VP);
  float* p_s = reinterpret_cast<float*>(smem + S::OFF_P);
  float* qsq_s = reinterpret_cast<float*>(smem + S::OFF_SQ);
  float* ksq_s = qsq_s + TILE;
  float* mb_s = ksq_s + TILE;

  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const int b = blockIdx.z, h = blockIdx.y, i0 = blockIdx.x * TILE;
  const int L = a.L;
  const int nq = min(TILE, L - i0);
  const long long bh = (long long)b * a.H + h;
  const E* q = static_cast<const E*>(a.q) + bh * L * C;
  const E* k = static_cast<const E*>(a.k) + bh * L * C;
  const E* v = static_cast<const E*>(a.v) + bh * L * C;
  const float* qp = a.qp + bh * L * P3Q;
  const float* kp = a.kp + bh * L * P3Q;
  const float* vp = a.vp + bh * L * P3V;
  const int iq = i0 + (ty < nq ? ty : 0);   // this thread's query row (clamped for the loads)
  const E* bias_row = static_cast<const E*>(a.bias) + (bh * L + iq) * L;
  const E* pz = static_cast<const E*>(a.pz) + (long long)b * L * L * CZ4;
  const float* maskb = a.maskb + (long long)b * L;

  load_rows(q_s, S::LDC, q, C, i0, nq, tid);
  load_rows(qp_s, S::LDQ, qp, P3Q, i0, nq, tid);
  __syncthreads();
  row_sq<P3Q>(qsq_s, qp_s, S::LDQ, tid);

  // Logits of query row ty against key columns tx + 8u of the current tile;
  // -inf past the ragged edge nk.
  auto logits = [&](float (&s)[4], int j0, int nk) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f}, pt[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int c = 0; c < C; ++c) {
      const float qv = to_f(q_s[ty * S::LDC + c]);
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[u] = fmaf(qv, to_f(k_s[(tx + 8 * u) * S::LDC + c]), acc[u]);
    }
#pragma unroll
    for (int x = 0; x < P3Q; ++x) {
      const float qx = qp_s[ty * S::LDQ + x];
#pragma unroll
      for (int u = 0; u < 4; ++u) pt[u] = fmaf(qx, kp_s[(tx + 8 * u) * S::LDQ + x], pt[u]);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = tx + 8 * u;
      s[u] = -INFINITY;
      if (j < nk) {
        const float lin = acc[u] * a.s1 + to_f(bias_row[j0 + j]) * a.s2;
        s[u] = (lin + (qsq_s[ty] + ksq_s[j] - 2.f * pt[u]) * -0.5f) + mb_s[j];
      }
    }
  };

  // Pass 1: row max and sum of exp of the logits.
  float m = -INFINITY, l = 0.f;
  for (int j0 = 0; j0 < L; j0 += TILE) {
    const int nk = min(TILE, L - j0);
    __syncthreads();
    load_rows(k_s, S::LDC, k, C, j0, nk, tid);
    load_rows(kp_s, S::LDQ, kp, P3Q, j0, nk, tid);
    if (tid < TILE) mb_s[tid] = tid < nk ? maskb[j0 + tid] : 0.f;
    __syncthreads();
    row_sq<P3Q>(ksq_s, kp_s, S::LDQ, tid);
    __syncthreads();
    float s[4];
    logits(s, j0, nk);
#pragma unroll
    for (int u = 0; u < 4; ++u) online(m, l, s[u]);
  }
  combine_stats(m, l);

  // Pass 2: the weights, and the scalar, point and pair aggregations.
  constexpr int NO = C / 8, NPT = (P3V + 7) / 8, NZ = CZ4 / 8;
  float oacc[NO] = {}, pacc[NPT] = {}, zacc[NZ] = {};
  for (int j0 = 0; j0 < L; j0 += TILE) {
    const int nk = min(TILE, L - j0);
    __syncthreads();
    load_rows(k_s, S::LDC, k, C, j0, nk, tid);
    load_rows(v_s, S::LDC, v, C, j0, nk, tid);
    load_rows(kp_s, S::LDQ, kp, P3Q, j0, nk, tid);
    load_rows(vp_s, S::LDV, vp, P3V, j0, nk, tid);
    for (int idx = tid; idx < TILE * TILE * CZ4; idx += NT) {
      const int r = idx / (TILE * CZ4), rem = idx % (TILE * CZ4);
      E val = static_cast<E>(0.f);
      if (r < nq && rem < nk * CZ4) val = pz[((long long)(i0 + r) * L + j0) * CZ4 + rem];
      z_s[r * S::LDZ + rem] = val;
    }
    if (tid < TILE) mb_s[tid] = tid < nk ? maskb[j0 + tid] : 0.f;
    __syncthreads();
    row_sq<P3Q>(ksq_s, kp_s, S::LDQ, tid);
    __syncthreads();
    float s[4];
    logits(s, j0, nk);
#pragma unroll
    for (int u = 0; u < 4; ++u)
      p_s[ty * S::LDP + tx + 8 * u] = s[u] == -INFINITY ? 0.f : expf(s[u] - m) / l;
    __syncthreads();
    for (int j = 0; j < TILE; ++j) {
      const float pa = p_s[ty * S::LDP + j];
      const float pc = round_as(pa, q);
#pragma unroll
      for (int w = 0; w < NO; ++w)
        oacc[w] = fmaf(pc, to_f(v_s[j * S::LDC + tx + 8 * w]), oacc[w]);
#pragma unroll
      for (int w = 0; w < NPT; ++w) {
        const int x = tx + 8 * w;
        if (x < P3V) pacc[w] = fmaf(pa, vp_s[j * S::LDV + x], pacc[w]);
      }
#pragma unroll
      for (int w = 0; w < NZ; ++w)
        zacc[w] = fmaf(pa, to_f(z_s[ty * S::LDZ + j * CZ4 + tx + 8 * w]), zacc[w]);
    }
  }

  const int i = i0 + ty;
  if (i < L) {
    float* orow = a.o + (bh * L + i) * C;
#pragma unroll
    for (int w = 0; w < NO; ++w) orow[tx + 8 * w] = oacc[w];
    float* prow = a.opt + (bh * L + i) * P3V;
#pragma unroll
    for (int w = 0; w < NPT; ++w)
      if (tx + 8 * w < P3V) prow[tx + 8 * w] = pacc[w];
    float* zrow = a.opair + (bh * L + i) * CZ4;
#pragma unroll
    for (int w = 0; w < NZ; ++w) zrow[tx + 8 * w] = zacc[w];
  }
}

// Per device and instantiation: whether the dynamic shared-memory opt-in is set.
constexpr int MAX_DEVICES = 64;
bool g_smem_opt_in[3][MAX_DEVICES];

template <typename E, int C, int P3Q, int P3V, int CZ4>
int launch(const Args& a, int variant, int dev, cudaStream_t stream) {
  constexpr int bytes = Smem<E, C, P3Q, P3V, CZ4>::BYTES;
  auto kernel = ipa1_fwd_kernel<E, C, P3Q, P3V, CZ4>;
  if (!g_smem_opt_in[variant][dev]) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    g_smem_opt_in[variant][dev] = true;
  }
  const dim3 grid((a.L + TILE - 1) / TILE, a.H, a.B);
  kernel<<<grid, NT, bytes, stream>>>(a);
  return launched(1);
}

}  // namespace scalar

// ------------------------------------------- bf16, model widths: tensor cores
namespace tc {

using namespace ipa2;
using namespace ipa2::fwd;
using namespace hopper;

constexpr int OFF_PZ = OFF_OWN;                    // [2 slots][8 items][128 threads][16 B]
constexpr int SMEM_BYTES = OFF_PZ + 2 * SLOT;
static_assert(2 * (SMEM_BYTES + 1024) <= 233472, "two blocks an SM");

struct Args {
  const bf16 *q, *k, *v, *bias, *pz;
  const float *qp, *kp, *vp, *maskb;
  float *o, *opt, *opair;
  long long stz[4];   // pz's element strides (b, i, j, d)
  int L, H;
  float s1, s2;
};

// W fp32 values at src (16-byte aligned) into x by 4-wide loads; zero when
// !valid (src must still be a valid address).
template <int W>
__device__ __forceinline__ void load_points(float* x, const float* src, bool valid) {
#pragma unroll
  for (int u = 0; u < W / 4; ++u) {
    const float4 v = reinterpret_cast<const float4*>(src)[u];
    x[4 * u] = valid ? v.x : 0.f;
    x[4 * u + 1] = valid ? v.y : 0.f;
    x[4 * u + 2] = valid ? v.z : 0.f;
    x[4 * u + 3] = valid ? v.w : 0.f;
  }
}

// MULTI: L > 64 (several key tiles, two passes); BIAS_ROWS: the bias tile
// copied as rows (L % 8 == 0), else read in place by the logits.
template <bool BIAS_ROWS, bool MULTI>
__global__ void __launch_bounds__(NTH) ipa1_hopper_kernel(const Args a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  if (base & 1023) __trap();   // the swizzle is taken from the address bits
  const uint32_t q_s = base + OFF_Q, v_s = base + OFF_V, k_s = base + OFF_K;
  const bf16* bias_s = reinterpret_cast<const bf16*>(smem + OFF_BIAS);
  float* a_s = reinterpret_cast<float*>(smem + OFF_A);
  float* kg_s = reinterpret_cast<float*>(smem + OFF_KG);
  float* vg_s = reinterpret_cast<float*>(smem + OFF_VG);
  float* ksq_s = reinterpret_cast<float*>(smem + OFF_KSQ);
  float* mb_s = reinterpret_cast<float*>(smem + OFF_MB);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int ra = 16 * warp + g, rb = ra + 8;   // this thread's rows of the accumulators
  const int ar = tid >> 1, ah = tid & 1;       // its row and half in the aggregations
  const int b = blockIdx.z, h = blockIdx.y, i0 = blockIdx.x * TQ;
  const int L = a.L;
  const int nq = min(TQ, L - i0);
  const int ntiles = MULTI ? (L + TQ - 1) / TQ : 1;
  const float s1 = a.s1, s2 = a.s2;
  const long long bh = (long long)b * a.H + h;
  const bf16* q_h = a.q + bh * L * C;
  const bf16* k_h = a.k + bh * L * C;
  const bf16* v_h = a.v + bh * L * C;
  const float* qp_h = a.qp + bh * L * P3Q;
  const float* kp_h = a.kp + bh * L * P3Q;
  const float* vp_h = a.vp + bh * L * P3V;
  const float* maskb = a.maskb + (long long)b * L;
  const bf16* bias_h = a.bias + bh * L * L;
  // The bias rows of ra, rb (read in place; rows past the edge read row i0).
  const bf16* bias_a = bias_h + (long long)(i0 + (ra < nq ? ra : 0)) * L;
  const bf16* bias_b = bias_h + (long long)(i0 + (rb < nq ? rb : 0)) * L;
  const long long* stz = a.stz;
  const bf16* pz_row = a.pz + b * stz[0] + (long long)(i0 + (ar < nq ? ar : 0)) * stz[1];
  float* const o_rows = a.o + bh * L * C;

  float qga[P3Q], qgb[P3Q];   // the query points of rows ra, rb, and their squared norms
  float qsqa = 0.f, qsqb = 0.f;
  // Loaded before the copies for L <= 64; for L > 64 again before each key
  // tile's logits (the loads hit L2), so that no register holds them across
  // the tile loops.
  auto query_points = [&]() {
    const float* qp = MULTI ? opaque(qp_h) : qp_h;
    load_points<P3Q>(qga, qp + (long long)(i0 + (ra < nq ? ra : 0)) * P3Q, ra < nq);
    load_points<P3Q>(qgb, qp + (long long)(i0 + (rb < nq ? rb : 0)) * P3Q, rb < nq);
  };
  auto query_norms = [&]() {
    qsqa = qsqb = 0.f;
#pragma unroll
    for (int x = 0; x < P3Q; ++x) {
      qsqa = fmaf(qga[x], qga[x], qsqa);
      qsqb = fmaf(qgb[x], qgb[x], qsqb);
    }
  };

  // Copies of key tile j0 (K; V with `values`; the bias tile in its row
  // variant), committed as one group.
  auto copy_keys = [&](int j0, int nk, bool values) {
    load_tile(k_s, opaque(k_h), C, j0, nk, tid);
    if (values) load_tile(v_s, opaque(v_h), C, j0, nk, tid);
    if (BIAS_ROWS) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int idx = tid + NTH * k, r = idx >> 3, c = idx & 7;
        const bool valid = r < nq && 8 * c < nk;
        const bf16* src = opaque(bias_h) + (long long)(i0 + r) * L + j0 + 8 * c;
        cp_async16(base + OFF_BIAS + r * (LDB * 2) + c * 16, valid ? src : a.bias, valid);
      }
    }
    cp_async_commit();
  };
  // Row ar of key tile j0: its key points (half 0) or, with `values`, its
  // value points (half 1), and the tile's key masks; loaded, then stored.
  float kv[P3V], mk = 0.f;
  auto key_fetch = [&](int j0, int nk, bool values) {
    const long long row = j0 + (ar < nk ? ar : 0);
    if (ah == 0)
      load_points<P3Q>(kv, opaque(kp_h) + row * P3Q, ar < nk);
    else if (values)
      load_points<P3V>(kv, opaque(vp_h) + row * P3V, ar < nk);
    mk = tid < nk ? maskb[j0 + tid] : 0.f;
  };
  auto key_store = [&](bool values) {
    if (ah == 0)
      store_key_points(kg_s, ksq_s, ar, kv);
    else if (values)
      store_value_points(vg_s, ar, kv);
    if (tid < TQ) mb_s[tid] = mk;
  };

  auto logits = [&](float (&s)[32], int j0, int nk) {
    qk_product(s, q_s, k_s);
    logit_terms<BIAS_ROWS>(s, j0, nk, q, ra, rb, bias_s, bias_a, bias_b, 1, kg_s, ksq_s, mb_s,
                           qga, qgb, qsqa, qsqb, s1, s2);
  };
  auto copy_pair = [&](int kc, int off, int j0, int nk) {
    fwd::copy_pair<PZ_D>(base, kc, off, j0, nk, nq, tid, ar, ah, pz_row, stz, a.pz);
  };

  // One key tile of pass 2 (the only pass for L <= 64): its copies are in
  // flight and its points stored. The logits, the weights (with `single`
  // from the tile's own max and sum, else from pass 1's), the products and
  // the aggregations.
  float ma = -INFINITY, la = 0.f, mb = -INFINITY, lb = 0.f;
  auto tile2 = [&](int t, int j0, int nk, bool single, float (&pacc)[18], float (&zacc)[8]) {
    cp_async_wait_group<2>();   // Q, K, V and the bias; the pair chunks may still fly
    fence_proxy_async();
    __syncthreads();
    if (MULTI) {
      query_points();
      query_norms();
    }
    float s[32];
    logits(s, j0, nk);
    if (single)
      softmax_tile(s, ma, la, mb, lb);
    else
      softmax_from(s, ma, la, mb, lb);

    // o += bf16(a).V; after the first key tile o is taken back from the
    // output, where the tile before left it.
    float o0[32], o1[32];
    if (t > 0) load_o(o0, o1, o_rows, C, i0, nq, q, ra, rb);
    uint32_t ha[16];
    av_issue(o0, o1, ha, s, v_s, t > 0);
    __syncthreads();   // all logits taken: K, the bias tile and, for L <= 64, Q are free
    const int nslot = single ? 4 : 3;
    if (single) copy_pair(2, slot_at(2, true, OFF_PZ), j0, nk);
    if (single) cp_async_commit();
    store_weights(a_s, s, q, ra, rb);
    av_wait(o0, o1, ha);
    __syncthreads();   // the weights and the value points are complete; V has been read
    copy_pair(nslot - 1, slot_at(nslot - 1, single, OFF_PZ), j0, nk);
    cp_async_commit();
    store_o(o0, o1, o_rows, C, i0, L, q, ra, rb);   // its stores overlap the aggregations

    if (t == 0) {
#pragma unroll
      for (int x = 0; x < 18; ++x) pacc[x] = 0.f;
#pragma unroll
      for (int d = 0; d < 8; ++d) zacc[d] = 0.f;
    }
    pair_sums<PZ_D>(base, smem, OFF_PZ, single, j0, nk, nq, tid, ar, ah, a_s, vg_s, pz_row, stz,
                    a.pz, pacc, zacc);
    __syncthreads();   // before the next tile's copies overwrite the tiles
  };

  // The point and pair outputs of row ar: columns 18ah.. of o_pt, channels 8ah.. of o_pair.
  auto outputs = [&](const float (&pacc)[18], const float (&zacc)[8]) {
    if (ar >= nq) return;
    const long long row = bh * L + i0 + ar;
    float4* zrow = reinterpret_cast<float4*>(a.opair + row * CZ4 + 8 * ah);
    zrow[0] = make_float4(zacc[0], zacc[1], zacc[2], zacc[3]);
    zrow[1] = make_float4(zacc[4], zacc[5], zacc[6], zacc[7]);
    float2* prow = reinterpret_cast<float2*>(a.opt + row * P3V + 18 * ah);
#pragma unroll
    for (int u = 0; u < 9; ++u) prow[u] = make_float2(pacc[2 * u], pacc[2 * u + 1]);
  };

  // The points' loads go first, so that they do not queue behind the tile
  // copies: query rows ra, rb (L <= 64) and row ar of the first key tile.
  const int nk0 = min(TQ, L);
  if (!MULTI) query_points();
  key_fetch(0, nk0, !MULTI);
  // Then the copies: the query tile, the first key tile's (their group),
  // and for L <= 64 its first two pair chunks.
  load_tile(q_s, q_h, C, i0, nq, tid);
  copy_keys(0, nk0, !MULTI);
  if (!MULTI) {
    copy_pair(0, slot_at(0, true, OFF_PZ), 0, nk0);
    cp_async_commit();
    copy_pair(1, slot_at(1, true, OFF_PZ), 0, nk0);
    cp_async_commit();
    query_norms();
  }
  key_store(!MULTI);

  if (!MULTI) {
    float pacc[18], zacc[8];
    tile2(0, 0, nk0, true, pacc, zacc);
    outputs(pacc, zacc);
  } else {
    // Pass 1: each row's max and sum of exp over all keys, from the logits alone.
    for (int t = 0; t < ntiles; ++t) {
      const int j0 = t * TQ, nk = min(TQ, L - j0);
      if (t > 0) {
        key_fetch(j0, nk, false);
        copy_keys(j0, nk, false);
        key_store(false);
      }
      cp_async_wait_all();
      fence_proxy_async();
      __syncthreads();
      query_points();
      query_norms();
      float s[32];
      logits(s, j0, nk);
      row_update(s, 0, ma, la);
      row_update(s, 1, mb, lb);
      __syncthreads();   // before the next copies overwrite K, the bias and the points
    }
    float pacc[18], zacc[8];
    for (int t = 0; t < ntiles; ++t) {
      const int j0 = t * TQ, nk = min(TQ, L - j0);
      key_fetch(j0, nk, true);
      copy_keys(j0, nk, true);
      copy_pair(0, slot_at(0, false, OFF_PZ), j0, nk);
      cp_async_commit();
      copy_pair(1, slot_at(1, false, OFF_PZ), j0, nk);
      cp_async_commit();
      key_store(true);
      tile2(t, j0, nk, false, pacc, zacc);
    }
    outputs(pacc, zacc);
  }
}

constexpr int MAX_DEVICES = 64;

template <bool BIAS_ROWS, bool MULTI>
int launch(const Args& a, int B, cudaStream_t stream) {
  static bool opt_in[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  auto kernel = ipa1_hopper_kernel<BIAS_ROWS, MULTI>;
  if (!opt_in[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    opt_in[dev] = true;
  }
  const dim3 grid((a.L + TQ - 1) / TQ, a.H, B);
  kernel<<<grid, NTH, SMEM_BYTES, stream>>>(a);
  return launched(0);
}

// The variant of a call: the bias as row copies when its rows are whole
// 16-byte chunks (L % 8 == 0), one key tile or several.
int forward(const Args& a, int B, cudaStream_t s) {
  const bool rows = a.L % 8 == 0;
  if (a.L > TQ) return rows ? launch<true, true>(a, B, s) : launch<false, true>(a, B, s);
  return rows ? launch<true, false>(a, B, s) : launch<false, false>(a, B, s);
}

}  // namespace tc

}  // namespace

// Launches the kernel on `stream`; returns the cudaError_t of the launch, or
// cudaErrorInvalidValue for widths it does not take. All tensors contiguous
// and 16-byte aligned: q, k, v (B, H, L, C), qp, kp (B, H, L, P3Q), vp (B,
// H, L, P3V), bias (B, H, L, L), pz (B, L, L, CZ4), maskb (B, L); outputs o
// (B, H, L, C), opt (B, H, L, P3V), opair (B, H, L, CZ4). bf16 != 0: q, k,
// v, bias and pz are bf16, else fp32. bf16 at the model's widths runs the
// tensor-core kernel, anything else the fp32 one.
extern "C" int ipa1_forward(const void* q, const void* k, const void* v, const void* qp,
                            const void* kp, const void* vp, const void* bias, const void* pz,
                            const void* maskb, void* o, void* opt, void* opair, int B, int L,
                            int H, int C, int P3Q, int P3V, int CZ4, int bf16_inputs, float s1,
                            float s2, void* stream) {
  if (B == 0 || L == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool model = C == 128 && P3Q == 24 && P3V == 36 && CZ4 == 16;
  const bool test = C == 32 && P3Q == 12 && P3V == 18 && CZ4 == 8;
  if (model && bf16_inputs) {
    const void* ptrs[] = {q, k, v, qp, kp, vp, bias, pz, o, opt, opair};
    for (const void* p : ptrs)
      if (!ipa2::aligned(p, 16)) return (int)cudaErrorInvalidValue;
    tc::Args a;
    a.q = static_cast<const ipa2::bf16*>(q);
    a.k = static_cast<const ipa2::bf16*>(k);
    a.v = static_cast<const ipa2::bf16*>(v);
    a.bias = static_cast<const ipa2::bf16*>(bias);
    a.pz = static_cast<const ipa2::bf16*>(pz);
    a.qp = static_cast<const float*>(qp);
    a.kp = static_cast<const float*>(kp);
    a.vp = static_cast<const float*>(vp);
    a.maskb = static_cast<const float*>(maskb);
    a.o = static_cast<float*>(o);
    a.opt = static_cast<float*>(opt);
    a.opair = static_cast<float*>(opair);
    a.stz[0] = (long long)L * L * CZ4;
    a.stz[1] = (long long)L * CZ4;
    a.stz[2] = CZ4;
    a.stz[3] = 1;
    a.L = L;
    a.H = H;
    a.s1 = s1;
    a.s2 = s2;
    return tc::forward(a, B, s);
  }
  using namespace scalar;
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.bias = bias;
  a.pz = pz;
  a.qp = static_cast<const float*>(qp);
  a.kp = static_cast<const float*>(kp);
  a.vp = static_cast<const float*>(vp);
  a.maskb = static_cast<const float*>(maskb);
  a.o = static_cast<float*>(o);
  a.opt = static_cast<float*>(opt);
  a.opair = static_cast<float*>(opair);
  a.B = B;
  a.L = L;
  a.H = H;
  a.s1 = s1;
  a.s2 = s2;
  if (model) return launch<float, 128, 24, 36, 16>(a, 0, dev, s);
  if (test && bf16_inputs) return launch<bf16, 32, 12, 18, 8>(a, 1, dev, s);
  if (test) return launch<float, 32, 12, 18, 8>(a, 2, dev, s);
  return (int)cudaErrorInvalidValue;
}

// Launches of kernel `which` (0 tensor-core, 1 fp32) that the runtime has
// accepted in this process: a check of which kernel a call ran.
extern "C" int ipa1_kernel_launches(int which) {
  return which == 0 || which == 1 ? g_launches[which].load() : -1;
}

// Dynamic shared memory a block of the tensor-core kernel takes (bytes).
extern "C" int ipa1_smem_bytes() { return tc::SMEM_BYTES; }
