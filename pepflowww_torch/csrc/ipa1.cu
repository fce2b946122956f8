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
// share, ~0.2 G fp32) take less. The TPU kernel held one head's (L, L)
// matrices in VMEM; here one block owns (b, h, 32 query rows) and streams
// 32-key tiles through shared memory twice (first the softmax's row max and
// sum, then the normalized weights and the three aggregations), so no
// (L, L) matrix is stored, every L runs, and the scalar output rounds the
// final weights as the TPU kernel does. This first version computes on the
// fp32 cores (no tensor cores) and recomputes the logits in the second pass.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

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
bool g_smem_opt_in[4][MAX_DEVICES];

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
  return (int)cudaGetLastError();
}

}  // namespace

// Launches the kernel on `stream`; returns the cudaError_t of the launch, or
// cudaErrorInvalidValue for widths it does not take. All tensors contiguous:
// q, k, v (B, H, L, C), qp, kp (B, H, L, P3Q), vp (B, H, L, P3V), bias
// (B, H, L, L), pz (B, L, L, CZ4), maskb (B, L); outputs o (B, H, L, C),
// opt (B, H, L, P3V), opair (B, H, L, CZ4). bf16 != 0: q, k, v, bias and pz
// are bf16, else fp32.
extern "C" int ipa1_forward(const void* q, const void* k, const void* v, const void* qp,
                            const void* kp, const void* vp, const void* bias, const void* pz,
                            const void* maskb, void* o, void* opt, void* opair, int B, int L,
                            int H, int C, int P3Q, int P3V, int CZ4, int bf16_inputs, float s1,
                            float s2, void* stream) {
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool model = C == 128 && P3Q == 24 && P3V == 36 && CZ4 == 16;
  const bool test = C == 32 && P3Q == 12 && P3V == 18 && CZ4 == 8;
  if (model && bf16_inputs) return launch<bf16, 128, 24, 36, 16>(a, 0, dev, s);
  if (model) return launch<float, 128, 24, 36, 16>(a, 1, dev, s);
  if (test && bf16_inputs) return launch<bf16, 32, 12, 18, 8>(a, 2, dev, s);
  if (test) return launch<float, 32, 12, 18, 8>(a, 3, dev, s);
  return (int)cudaErrorInvalidValue;
}
