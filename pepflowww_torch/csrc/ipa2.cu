// Fused IPA interior (v2), forward, for Hopper, sm_90a.
//
// Replaces: pepflowww_tpu/models/pallas_ipa2.py::fused_ipa2 (body `_fwd_kernel`).
//
// Per batch row b and head h, with the frames R, t of each residue:
//   qg, kg = (R x + t) * sw_h for the local query / key points, vg = R x + t
//   s[i, j] = q_i.k_j / sqrt(3C) + bias[h, i, j] / sqrt(3)
//             - (|qg_i|^2 + |kg_j|^2 - 2 qg_i.kg_j) / 2 + maskb[j]
//   a = softmax_j(s)                                               (fp32)
//   o[i]     = sum_j bf16(a[i, j]) v_j                              (C = 128)
//   optl[i]  = R_i^T (sum_j a[i, j] vg_j - t_i), norm = sqrt(sum_c optl_c^2 + eps)
//   opair[i] = sum_j a[i, j] pz[i, j]                               (CZ4 = 16)
// written as fp32 into o_feats' pieces: o (B, L, H*C), optl (B, L, 3*H*PV)
// as [x | y | z] blocks, norm (B, L, H*PV), opair (B, L, H*CZ4).
//
// What bounds it on this card: the bytes of the function (its bf16 inputs
// and fp32 outputs, ~74 MB at B=64, L=64: ~22 us at 3.35 TB/s); its
// operations (~0.27 G bf16 MACs, ~0.18 G fp32 MACs) take less. The TPU
// kernel ran one grid step per batch row with every head's (L, L) matrices
// in VMEM; here one block owns (b, h, 32 query rows), so blocks run in
// parallel with nothing carried between them, and every L is taken: keys
// stream through shared memory in tiles of 32, twice (first the row max and
// sum of the softmax, then the normalized weights and the three
// aggregations), so no (L, L) matrix is ever stored and the ragged tiles
// are masked here. This first version computes on the fp32 cores from bf16
// tiles (no tensor cores) and recomputes the logits in the second pass: a
// cost of this design, not of the function. The pair tile pz[b, i, j, :] is
// read by each of the H heads' blocks, so H times in all (from L2 after the
// first), and it may arrive in the JAX layout (B, L, L, CZ4) or as the
// EdgeTransition epilogue's transposed (B, CZ4, L, L): the kernel reads the
// strides of qp, kvp, bias and pz, so no transpose runs before it.

#include "ipa2_common.cuh"

namespace {

using namespace ipa2;

constexpr int OFF_Q = 0;                        // bf16 [T][LDH]
constexpr int OFF_K = OFF_Q + T * LDH * 2;      // bf16 [T][LDH]
constexpr int OFF_V = OFF_K + T * LDH * 2;      // bf16 [T][LDH]
constexpr int OFF_QG = OFF_V + T * LDH * 2;     // f32 [T][LDG]
constexpr int OFF_KG = OFF_QG + T * LDG * 4;    // f32 [T][LDG]
constexpr int OFF_VG = OFF_KG + T * LDG * 4;    // f32 [T][LDV]; at the end the point sums
constexpr int OFF_QSQ = OFF_VG + T * LDV * 4;   // f32 [T]
constexpr int OFF_KSQ = OFF_QSQ + T * 4;        // f32 [T]
constexpr int OFF_MB = OFF_KSQ + T * 4;         // f32 [T]
constexpr int OFF_P = OFF_MB + T * 4;           // f32 [T][LDP] attention weights of the tile
constexpr int OFF_Z = OFF_P + T * LDP * 4;      // bf16 [T][LDZ] pair tile
constexpr int SMEM_BYTES = OFF_Z + T * LDZ * 2;

struct FwdArgs {
  const bf16 *q, *kv, *qp, *kvp, *bias, *pz;
  const float *r9, *t, *maskb, *sw;
  float *o, *optl, *norm, *opair;
  Layout st;
  int B, L, H;
  float eps, s1, s2;
};

__global__ void __launch_bounds__(NT) ipa2_fwd_kernel(const FwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem + OFF_Q);
  bf16* k_s = reinterpret_cast<bf16*>(smem + OFF_K);
  bf16* v_s = reinterpret_cast<bf16*>(smem + OFF_V);
  float* qg_s = reinterpret_cast<float*>(smem + OFF_QG);
  float* kg_s = reinterpret_cast<float*>(smem + OFF_KG);
  float* vg_s = reinterpret_cast<float*>(smem + OFF_VG);
  float* qsq_s = reinterpret_cast<float*>(smem + OFF_QSQ);
  float* ksq_s = reinterpret_cast<float*>(smem + OFF_KSQ);
  float* mb_s = reinterpret_cast<float*>(smem + OFF_MB);
  float* p_s = reinterpret_cast<float*>(smem + OFF_P);
  bf16* z_s = reinterpret_cast<bf16*>(smem + OFF_Z);

  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const int rg = tid >> 4, cg = tid & 15;   // scalar output: rows 2rg, 2rg+1; column pairs cg + 16u
  const int b = blockIdx.z, h = blockIdx.y, i0 = blockIdx.x * T;
  const int L = a.L, H = a.H;
  const int nq = min(T, L - i0);
  const float sw = a.sw[h];
  const long long HC = (long long)H * C;
  const bf16* kv_b = a.kv + (long long)b * L * 2 * HC + 2LL * h * C;
  const int iq = i0 + (ty < nq ? ty : 0);   // this thread's query row (clamped for the loads)
  const bf16* bias_row = a.bias + b * a.st.bias[0] + h * a.st.bias[1] + iq * a.st.bias[2];

  load_rows(q_s, a.q + (long long)b * L * HC + h * C, HC, i0, nq, tid);
  load_points<PQ>(qg_s, LDG, a.qp, a.st.qp, b, h, 0, a.r9, a.t, L, i0, nq, sw, tid);
  __syncthreads();
  row_sq(qsq_s, qg_s, tid);

  // Pass 1: row max and sum of exp of the logits.
  float m = -INFINITY, l = 0.f;
  for (int j0 = 0; j0 < L; j0 += T) {
    const int nk = min(T, L - j0);
    __syncthreads();
    load_rows(k_s, kv_b, 2 * HC, j0, nk, tid);
    load_points<PQ>(kg_s, LDG, a.kvp, a.st.kvp, b, h, 0, a.r9, a.t, L, j0, nk, sw, tid);
    if (tid < T) mb_s[tid] = tid < nk ? a.maskb[(long long)b * L + j0 + tid] : 0.f;
    __syncthreads();
    row_sq(ksq_s, kg_s, tid);
    __syncthreads();
    float s[4];
    tile_logits(s, q_s, qg_s, qsq_s, k_s, kg_s, ksq_s, mb_s, bias_row + j0 * a.st.bias[3],
                a.st.bias[3], nk, ty, tx, a.s1, a.s2);
#pragma unroll
    for (int u = 0; u < 4; ++u) online(m, l, s[u]);
  }
  combine_stats(m, l);

  // Pass 2: the weights, and the scalar, point and pair aggregations.
  float oacc[2][8] = {};
  float pacc[5] = {};
  float zacc[2] = {};
  for (int j0 = 0; j0 < L; j0 += T) {
    const int nk = min(T, L - j0);
    __syncthreads();
    load_rows(k_s, kv_b, 2 * HC, j0, nk, tid);
    load_rows(v_s, kv_b + C, 2 * HC, j0, nk, tid);
    load_points<PQ>(kg_s, LDG, a.kvp, a.st.kvp, b, h, 0, a.r9, a.t, L, j0, nk, sw, tid);
    load_points<PV>(vg_s, LDV, a.kvp, a.st.kvp, b, h, PQ, a.r9, a.t, L, j0, nk, 1.f, tid);
    load_pair(z_s, a.pz, a.st.pz, b, i0, nq, j0, nk, tid);
    if (tid < T) mb_s[tid] = tid < nk ? a.maskb[(long long)b * L + j0 + tid] : 0.f;
    __syncthreads();
    row_sq(ksq_s, kg_s, tid);
    __syncthreads();
    float s[4];
    tile_logits(s, q_s, qg_s, qsq_s, k_s, kg_s, ksq_s, mb_s, bias_row + j0 * a.st.bias[3],
                a.st.bias[3], nk, ty, tx, a.s1, a.s2);
#pragma unroll
    for (int u = 0; u < 4; ++u)
      p_s[ty * LDP + tx + 8 * u] = s[u] == -INFINITY ? 0.f : expf(s[u] - m) / l;
    __syncthreads();
    for (int j = 0; j < T; ++j) {
      const float a0 = bfr(p_s[(2 * rg) * LDP + j]), a1 = bfr(p_s[(2 * rg + 1) * LDP + j]);
      const __nv_bfloat162* vr = reinterpret_cast<const __nv_bfloat162*>(v_s + j * LDH);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float2 vv = __bfloat1622float2(vr[cg + 16 * u]);
        oacc[0][2 * u] = fmaf(a0, vv.x, oacc[0][2 * u]);
        oacc[0][2 * u + 1] = fmaf(a0, vv.y, oacc[0][2 * u + 1]);
        oacc[1][2 * u] = fmaf(a1, vv.x, oacc[1][2 * u]);
        oacc[1][2 * u + 1] = fmaf(a1, vv.y, oacc[1][2 * u + 1]);
      }
      const float pa = p_s[ty * LDP + j];
#pragma unroll
      for (int u = 0; u < 5; ++u) {
        const int x = tx + 8 * u;
        if (x < P3V) pacc[u] = fmaf(pa, vg_s[j * LDV + x], pacc[u]);
      }
#pragma unroll
      for (int k = 0; k < 2; ++k)
        zacc[k] = fmaf(pa, bf2f(z_s[ty * LDZ + j * CZ4 + tx + 8 * k]), zacc[k]);
    }
  }

  // Scalar and pair outputs.
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int i = i0 + 2 * rg + rr;
    if (i < L) {
      float* orow = a.o + ((long long)b * L + i) * HC + h * C;
#pragma unroll
      for (int u = 0; u < 4; ++u)
        *reinterpret_cast<float2*>(orow + 2 * (cg + 16 * u)) =
            make_float2(oacc[rr][2 * u], oacc[rr][2 * u + 1]);
    }
  }
  if (i0 + ty < L) {
    float* zrow = a.opair + ((long long)b * L + i0 + ty) * H * CZ4 + h * CZ4;
    zrow[tx] = zacc[0];
    zrow[tx + 8] = zacc[1];
  }
  // Point outputs: back to each residue's frame, and the norms.
  __syncthreads();
#pragma unroll
  for (int u = 0; u < 5; ++u) {
    const int x = tx + 8 * u;
    if (x < P3V) vg_s[ty * LDV + x] = pacc[u];
  }
  __syncthreads();
  for (int idx = tid; idx < T * PV; idx += NT) {
    const int r = idx / PV, p = idx % PV, i = i0 + r;
    if (i >= L) continue;
    const float* R = a.r9 + ((long long)b * L + i) * 9;
    const float* t3 = a.t + ((long long)b * L + i) * 3;
    const float d0 = vg_s[r * LDV + p] - t3[0];
    const float d1 = vg_s[r * LDV + PV + p] - t3[1];
    const float d2 = vg_s[r * LDV + 2 * PV + p] - t3[2];
    float nsq = a.eps;
    float* lrow = a.optl + ((long long)b * L + i) * 3 * H * PV + h * PV + p;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float loc = R[c] * d0 + R[3 + c] * d1 + R[6 + c] * d2;
      lrow[c * H * PV] = loc;
      nsq += loc * loc;
    }
    a.norm[((long long)b * L + i) * H * PV + h * PV + p] = sqrtf(nsq);
  }
}

constexpr int MAX_DEVICES = 64;
bool g_smem_opt_in[MAX_DEVICES];

}  // namespace

// Launches the kernel on `stream`; returns the cudaError_t of the launch.
// `strides` holds the element strides of qp, kvp (5 each), bias and pz (4 each).
extern "C" int ipa2_forward(const void* q, const void* kv, const void* qp, const void* kvp,
                            const void* r9, const void* t, const void* bias, const void* pz,
                            const void* maskb, const void* sw, void* o, void* optl, void* norm,
                            void* opair, const long long* strides, int B, int L, int H, float eps,
                            void* stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!g_smem_opt_in[dev]) {
    err = cudaFuncSetAttribute(ipa2_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    g_smem_opt_in[dev] = true;
  }
  FwdArgs a;
  a.q = static_cast<const bf16*>(q);
  a.kv = static_cast<const bf16*>(kv);
  a.qp = static_cast<const bf16*>(qp);
  a.kvp = static_cast<const bf16*>(kvp);
  a.bias = static_cast<const bf16*>(bias);
  a.pz = static_cast<const bf16*>(pz);
  a.r9 = static_cast<const float*>(r9);
  a.t = static_cast<const float*>(t);
  a.maskb = static_cast<const float*>(maskb);
  a.sw = static_cast<const float*>(sw);
  a.o = static_cast<float*>(o);
  a.optl = static_cast<float*>(optl);
  a.norm = static_cast<float*>(norm);
  a.opair = static_cast<float*>(opair);
  for (int k = 0; k < 5; ++k) a.st.qp[k] = strides[k], a.st.kvp[k] = strides[5 + k];
  for (int k = 0; k < 4; ++k) a.st.bias[k] = strides[10 + k], a.st.pz[k] = strides[14 + k];
  a.B = B;
  a.L = L;
  a.H = H;
  a.eps = eps;
  a.s1 = 1.f / sqrtf(3.f * C);
  a.s2 = 1.f / sqrtf(3.f);
  const dim3 grid((L + T - 1) / T, H, B);
  ipa2_fwd_kernel<<<grid, NT, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
