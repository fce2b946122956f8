// EdgeEmbedder distance block, backward, for Hopper, sm_90a.
//
// Replaces: pepflowww_tpu/models/pallas_dist.py::distance_embed_bwd (body
// `_bwd_kernel`), the backward half of fused_distance_embed_vjp.
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
//
// Design. The TPU kernel sums its parameter gradients across grid steps in
// place, relying on the TPU grid running in order; GPU blocks run in no
// order, so here every cross-block sum goes through partials added in a
// fixed order, and no float atomics: two runs give bit-identical gradients.
//  1. dist_bwd_prep_kernel: softplus and sigmoid once per table entry
//     (484 x 225), not once per pair.
//  2. dist_bwd_kernel: a persistent grid (one block per SM) walks the
//     residues i of every batch row; per i it takes the j in tiles of 64,
//     rebuilds the gaussian row of each pair in shared memory, runs the MLP
//     forward and backward on bf16 WMMA, and keeps dK1 and dK2 in register
//     fragments for the whole run (one partial per block). Residue i touches
//     only the 22 table rows aa_i * 22 + (0..21), so dcoef accumulates into
//     a 22 x 225 fp32 slab in shared memory, each column summed by one
//     thread in pair order, and leaves as one partial per residue.
//  3. dist_bwd_table_reduce_kernel and dist_bwd_param_reduce_kernel: the partials summed in a
//     fixed order. The ragged last j tile of any L is masked here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>
#include <type_traits>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int A = 15;       // heavy atoms per residue
constexpr int AA2 = A * A;  // 225 atom pairs
constexpr int KP = 240;     // AA2 padded to a multiple of 16 (K1's rows as given)
constexpr int XP = 256;     // AA2 padded for the 16-row tiles of x^T in dK1
constexpr int F = 64;       // features
constexpr int NAA = 22;     // aa vocabulary
constexpr int NV = NAA * NAA;
constexpr int TJ = 64;      // residues j per tile
constexpr int NT = 256;     // threads per block (8 warps)
constexpr int PB = XP * F + F * F + 2 * F;   // per-block partial: dK1 | dK2 | db1 | db2

constexpr int LD_K = F + 8;
constexpr int LD_X = XP + 8;
constexpr int LD_S = KP + 4;

constexpr int OFF_K1 = 0;                              // K1 [240][LD_K]
constexpr int OFF_K2 = OFF_K1 + KP * LD_K * 2;         // K2 [64][LD_K]
constexpr int OFF_X = OFF_K2 + F * LD_K * 2;           // x [64][LD_X]
constexpr int OFF_H = OFF_X + TJ * LD_X * 2;           // h [64][LD_K]
constexpr int OFF_D2 = OFF_H + TJ * LD_K * 2;          // bf16(da2) [64][LD_K]
constexpr int OFF_D1 = OFF_D2 + TJ * LD_K * 2;         // bf16(da1) [64][LD_K]
constexpr int OFF_S = OFF_D1 + TJ * LD_K * 2;          // fp32 accumulators [64][LD_S]
constexpr int OFF_M1 = OFF_S + TJ * LD_S * 4;          // a1 > 0 [64][64] bytes
constexpr int OFF_PJ = OFF_M1 + TJ * F;                // pos_j [64][45]
constexpr int OFF_MJ = OFF_PJ + TJ * A * 3 * 4;        // m_j [64][15]
constexpr int OFF_PI = OFF_MJ + TJ * A * 4;            // pos_i [45], m_i [15]
constexpr int OFF_AJ = OFF_PI + (A * 3 + A) * 4;       // aa_j [64] int, s_j [64]
constexpr int OFF_SLAB = OFF_AJ + TJ * 4 * 2;          // d_table slab [22][225]
constexpr int OFF_B = OFF_SLAB + NAA * AA2 * 4;        // b1 [64], b2 [64]
constexpr int SMEM_BYTES = OFF_B + 2 * F * 4;

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> FragAT;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBT;

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float pair_d2(const float* p, const float* q) {
  const float dx = p[0] - q[0], dy = p[1] - q[1], dz = p[2] - q[2];
  return dx * dx + dy * dy + dz * dz;
}

// spsg[0] = softplus(table), spsg[1] = sigmoid(table), once per entry.
__global__ void dist_bwd_prep_kernel(const float* __restrict__ table, float* __restrict__ spsg) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= NV * AA2) return;
  const float x = table[v];
  spsg[v] = softplus(x);
  spsg[NV * AA2 + v] = 1.f / (1.f + expf(-x));
}

__global__ void __launch_bounds__(NT, 1)
dist_bwd_kernel(const float* __restrict__ pos, const float* __restrict__ amask,
                const int* __restrict__ aa, const float* __restrict__ smask,
                const bf16* __restrict__ g, const float* __restrict__ spsg,
                const bf16* __restrict__ k1, const float* __restrict__ b1,
                const bf16* __restrict__ k2, const float* __restrict__ b2,
                float* __restrict__ slabs, float* __restrict__ wpart, int B, int L) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* k1_s = reinterpret_cast<bf16*>(smem + OFF_K1);
  bf16* k2_s = reinterpret_cast<bf16*>(smem + OFF_K2);
  bf16* x_s = reinterpret_cast<bf16*>(smem + OFF_X);
  bf16* h_s = reinterpret_cast<bf16*>(smem + OFF_H);
  bf16* d2_s = reinterpret_cast<bf16*>(smem + OFF_D2);
  bf16* d1_s = reinterpret_cast<bf16*>(smem + OFF_D1);
  float* s_s = reinterpret_cast<float*>(smem + OFF_S);
  uint8_t* m1_s = smem + OFF_M1;
  float* pj_s = reinterpret_cast<float*>(smem + OFF_PJ);
  float* mj_s = reinterpret_cast<float*>(smem + OFF_MJ);
  float* pi_s = reinterpret_cast<float*>(smem + OFF_PI);
  float* mi_s = pi_s + A * 3;
  int* aj_s = reinterpret_cast<int*>(smem + OFF_AJ);
  float* sj_s = reinterpret_cast<float*>(aj_s + TJ);
  float* slab_s = reinterpret_cast<float*>(smem + OFF_SLAB);
  float* b1_s = reinterpret_cast<float*>(smem + OFF_B);
  float* b2_s = b1_s + F;
  const float* spt = spsg;
  const float* sgt = spsg + NV * AA2;

  const int tid = threadIdx.x, warp = tid >> 5;
  for (int v = tid; v < KP * (F / 8); v += NT) {
    const int r = v >> 3, c = (v & 7) * 8;
    *reinterpret_cast<uint4*>(k1_s + r * LD_K + c) =
        *reinterpret_cast<const uint4*>(k1 + r * F + c);
  }
  for (int v = tid; v < F * (F / 8); v += NT) {
    const int r = v >> 3, c = (v & 7) * 8;
    *reinterpret_cast<uint4*>(k2_s + r * LD_K + c) =
        *reinterpret_cast<const uint4*>(k2 + r * F + c);
  }
  for (int c = tid; c < F; c += NT) { b1_s[c] = b1[c]; b2_s[c] = b2[c]; }

  // dK1 rows 32w..32w+31 and dK2 rows 16(w/2).., cols 32(w%2).. of this warp,
  // summed over every pair this block takes.
  Acc dk1[8], dk2[2];
#pragma unroll
  for (int q = 0; q < 8; ++q) wmma::fill_fragment(dk1[q], 0.f);
  wmma::fill_fragment(dk2[0], 0.f);
  wmma::fill_fragment(dk2[1], 0.f);
  float acc_b1 = 0.f, acc_b2 = 0.f;   // column tid (< 64) of db1, db2

  const int rm = warp >> 1, cn0 = (warp & 1) * 2;
  const long long n_items = (long long)B * L;
  for (long long item = blockIdx.x; item < n_items; item += gridDim.x) {
    const long long bi = item, b = bi / L;
    __syncthreads();  // the previous item is done with every buffer
    for (int v = tid; v < NAA * AA2; v += NT) slab_s[v] = 0.f;
    for (int v = tid; v < A * 3; v += NT) pi_s[v] = pos[bi * A * 3 + v];
    for (int v = tid; v < A; v += NT) mi_s[v] = amask[bi * A + v];
    const int aa_i = aa[bi];
    const float s_i = smask[bi];

    for (int j0 = 0; j0 < L; j0 += TJ) {
      const int nj = min(TJ, L - j0);
      __syncthreads();
      for (int v = tid; v < nj * A * 3; v += NT) pj_s[v] = pos[(b * L + j0) * A * 3 + v];
      for (int v = tid; v < nj * A; v += NT) mj_s[v] = amask[(b * L + j0) * A + v];
      for (int v = tid; v < nj; v += NT) {
        aj_s[v] = aa[b * L + j0 + v];
        sj_s[v] = smask[b * L + j0 + v];
      }
      __syncthreads();

      for (int idx = tid; idx < TJ * XP; idx += NT) {
        const int r = idx / XP, c = idx % XP;
        float x = 0.f;
        if (r < nj && c < AA2) {
          const int a = c / A, a2 = c % A;
          const float d2 = pair_d2(pi_s + a * 3, pj_s + r * A * 3 + a2 * 3);
          const float sp = spt[(aa_i * NAA + aj_s[r]) * AA2 + c];
          x = expf(-sp * d2) * mi_s[a] * mj_s[r * A + a2];
        }
        x_s[r * LD_X + c] = __float2bfloat16(x);
      }
      __syncthreads();

      {  // a1 accumulators: x[64x240] . K1[240x64]
        Acc acc[2];
        wmma::fill_fragment(acc[0], 0.f);
        wmma::fill_fragment(acc[1], 0.f);
        FragA fa;
        FragB fb;
        for (int k = 0; k < KP / 16; ++k) {
          wmma::load_matrix_sync(fa, x_s + rm * 16 * LD_X + k * 16, LD_X);
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            wmma::load_matrix_sync(fb, k1_s + k * 16 * LD_K + (cn0 + n) * 16, LD_K);
            wmma::mma_sync(acc[n], fa, fb, acc[n]);
          }
        }
#pragma unroll
        for (int n = 0; n < 2; ++n)
          wmma::store_matrix_sync(s_s + rm * 16 * LD_S + (cn0 + n) * 16, acc[n], LD_S,
                                  wmma::mem_row_major);
      }
      __syncthreads();
      for (int idx = tid; idx < TJ * F; idx += NT) {
        const int r = idx / F, c = idx % F;
        const float a1 = s_s[r * LD_S + c] + b1_s[c];
        const bool live = r < nj;
        h_s[r * LD_K + c] = __float2bfloat16(live ? fmaxf(a1, 0.f) : 0.f);
        m1_s[r * F + c] = live && a1 > 0.f;
      }
      __syncthreads();

      {  // a2 accumulators: h[64x64] . K2[64x64]
        Acc acc[2];
        wmma::fill_fragment(acc[0], 0.f);
        wmma::fill_fragment(acc[1], 0.f);
        FragA fa;
        FragB fb;
        for (int k = 0; k < F / 16; ++k) {
          wmma::load_matrix_sync(fa, h_s + rm * 16 * LD_K + k * 16, LD_K);
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            wmma::load_matrix_sync(fb, k2_s + k * 16 * LD_K + (cn0 + n) * 16, LD_K);
            wmma::mma_sync(acc[n], fa, fb, acc[n]);
          }
        }
#pragma unroll
        for (int n = 0; n < 2; ++n)
          wmma::store_matrix_sync(s_s + rm * 16 * LD_S + (cn0 + n) * 16, acc[n], LD_S,
                                  wmma::mem_row_major);
      }
      __syncthreads();
      if (tid < F) {  // da2 = g * s_i * s_j * (a2 > 0); thread tid owns column tid
        const int c = tid;
        for (int r = 0; r < TJ; ++r) {
          float da2 = 0.f;
          if (r < nj && s_s[r * LD_S + c] + b2_s[c] > 0.f)
            da2 = __bfloat162float(g[((bi * L) + j0 + r) * F + c]) * s_i * sj_s[r];
          acc_b2 += da2;
          d2_s[r * LD_K + c] = __float2bfloat16(da2);
        }
      }
      __syncthreads();

      {  // dK2 += h^T . bf16(da2); dh = bf16(da2) . K2^T
        FragAT ft;
        FragB fb;
        for (int k = 0; k < TJ / 16; ++k) {
          wmma::load_matrix_sync(ft, h_s + k * 16 * LD_K + rm * 16, LD_K);
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            wmma::load_matrix_sync(fb, d2_s + k * 16 * LD_K + (cn0 + n) * 16, LD_K);
            wmma::mma_sync(dk2[n], ft, fb, dk2[n]);
          }
        }
        Acc acc[2];
        wmma::fill_fragment(acc[0], 0.f);
        wmma::fill_fragment(acc[1], 0.f);
        FragA fa;
        FragBT fbt;
        for (int k = 0; k < F / 16; ++k) {
          wmma::load_matrix_sync(fa, d2_s + rm * 16 * LD_K + k * 16, LD_K);
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            wmma::load_matrix_sync(fbt, k2_s + (cn0 + n) * 16 * LD_K + k * 16, LD_K);
            wmma::mma_sync(acc[n], fa, fbt, acc[n]);
          }
        }
#pragma unroll
        for (int n = 0; n < 2; ++n)
          wmma::store_matrix_sync(s_s + rm * 16 * LD_S + (cn0 + n) * 16, acc[n], LD_S,
                                  wmma::mem_row_major);
      }
      __syncthreads();
      if (tid < F) {  // da1 = dh * (a1 > 0)
        const int c = tid;
        for (int r = 0; r < TJ; ++r) {
          const float da1 = m1_s[r * F + c] ? s_s[r * LD_S + c] : 0.f;
          acc_b1 += da1;
          d1_s[r * LD_K + c] = __float2bfloat16(da1);
        }
      }
      __syncthreads();

      {  // dK1 += x^T . bf16(da1); dx = bf16(da1) . K1^T
        FragAT ft;
        FragB fb;
        for (int k = 0; k < TJ / 16; ++k) {
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            wmma::load_matrix_sync(ft, x_s + k * 16 * LD_X + (2 * warp + mi) * 16, LD_X);
#pragma unroll
            for (int n = 0; n < 4; ++n) {
              wmma::load_matrix_sync(fb, d1_s + k * 16 * LD_K + n * 16, LD_K);
              wmma::mma_sync(dk1[mi * 4 + n], ft, fb, dk1[mi * 4 + n]);
            }
          }
        }
        FragA fa;
        FragBT fbt;
        for (int n = warp & 1; n < KP / 16; n += 2) {
          Acc acc;
          wmma::fill_fragment(acc, 0.f);
          for (int k = 0; k < F / 16; ++k) {
            wmma::load_matrix_sync(fa, d1_s + rm * 16 * LD_K + k * 16, LD_K);
            wmma::load_matrix_sync(fbt, k1_s + n * 16 * LD_K + k * 16, LD_K);
            wmma::mma_sync(acc, fa, fbt, acc);
          }
          wmma::store_matrix_sync(s_s + rm * 16 * LD_S + n * 16, acc, LD_S, wmma::mem_row_major);
        }
      }
      __syncthreads();
      if (tid < AA2) {  // dcoef into the slab; thread tid owns column tid, pairs in order
        const int c = tid, a = c / A, a2 = c % A;
        const float mi = mi_s[a];
        for (int r = 0; r < nj; ++r) {
          const float d2 = pair_d2(pi_s + a * 3, pj_s + r * A * 3 + a2 * 3);
          const int v = (aa_i * NAA + aj_s[r]) * AA2 + c;
          const float e = expf(-spt[v] * d2);
          const float mp = mi * mj_s[r * A + a2];
          slab_s[aj_s[r] * AA2 + c] += s_s[r * LD_S + c] * mp * e * (-d2) * sgt[v];
        }
      }
    }
    __syncthreads();
    for (int v = tid; v < NAA * AA2; v += NT) slabs[bi * NAA * AA2 + v] = slab_s[v];
  }

  float* part = wpart + (size_t)blockIdx.x * PB;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int n = 0; n < 4; ++n)
      wmma::store_matrix_sync(part + (2 * warp + mi) * 16 * F + n * 16, dk1[mi * 4 + n], F,
                              wmma::mem_row_major);
#pragma unroll
  for (int n = 0; n < 2; ++n)
    wmma::store_matrix_sync(part + XP * F + rm * 16 * F + (cn0 + n) * 16, dk2[n], F,
                            wmma::mem_row_major);
  if (tid < F) {
    part[XP * F + F * F + tid] = acc_b1;
    part[XP * F + F * F + F + tid] = acc_b2;
  }
}

// d_table[a * 22 + a2] = sum over residues n with aa[n] == a, in order, of
// their slab row a2.
__global__ void dist_bwd_table_reduce_kernel(const float* __restrict__ slabs,
                                             const int* __restrict__ aa, int BL,
                                             float* __restrict__ d_table) {
  const int v = blockIdx.x, a = v / NAA, a2 = v % NAA, c = threadIdx.x;
  if (c >= AA2) return;
  float s = 0.f;
  for (int n = 0; n < BL; ++n)
    if (aa[n] == a) s += slabs[((size_t)n * NAA + a2) * AA2 + c];
  d_table[v * AA2 + c] = s;
}

// dK1, dK2, db1, db2: the per-block partials summed in block order.
__global__ void dist_bwd_param_reduce_kernel(const float* __restrict__ wpart, int nblocks,
                                             float* __restrict__ dk1, float* __restrict__ db1,
                                             float* __restrict__ dk2, float* __restrict__ db2) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  constexpr int N1 = AA2 * F, N2 = F * F;
  if (i >= N1 + N2 + 2 * F) return;
  // Offsets in a block's partial: dK1 [256][64] | dK2 [64][64] | db1 | db2.
  const int off = i < N1 ? i : XP * F + (i - N1);
  float* dst;
  if (i < N1) dst = dk1 + i;
  else if (i < N1 + N2) dst = dk2 + (i - N1);
  else if (i < N1 + N2 + F) dst = db1 + (i - N1 - N2);
  else dst = db2 + (i - N1 - N2 - F);
  float s = 0.f;
  for (int b = 0; b < nblocks; ++b) s += wpart[(size_t)b * PB + off];
  *dst = s;
}

constexpr int MAX_DEVICES = 64;
bool g_smem_opt_in[MAX_DEVICES];

}  // namespace

// Launches every stage on `stream`; returns the first non-zero cudaError_t
// of the launches (0 on success). Scratch from the caller: spsg [2][484][225]
// f32, slabs [B*L][22][225] f32, wpart [grid][256*64 + 64*64 + 128] f32.
extern "C" int distance_embed_backward(const void* pos, const void* amask, const void* aa,
                                       const void* smask, const void* g, const void* table,
                                       const void* k1, const void* b1, const void* k2,
                                       const void* b2, void* spsg, void* slabs, void* wpart,
                                       void* d_table, void* d_k1, void* d_b1, void* d_k2,
                                       void* d_b2, int B, int L, int grid, void* stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!g_smem_opt_in[dev]) {
    err = cudaFuncSetAttribute(dist_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    g_smem_opt_in[dev] = true;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dist_bwd_prep_kernel<<<(NV * AA2 + NT - 1) / NT, NT, 0, s>>>(static_cast<const float*>(table),
                                                            static_cast<float*>(spsg));
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  dist_bwd_kernel<<<grid, NT, SMEM_BYTES, s>>>(
      static_cast<const float*>(pos), static_cast<const float*>(amask),
      static_cast<const int*>(aa), static_cast<const float*>(smask),
      static_cast<const bf16*>(g), static_cast<const float*>(spsg),
      static_cast<const bf16*>(k1), static_cast<const float*>(b1),
      static_cast<const bf16*>(k2), static_cast<const float*>(b2), static_cast<float*>(slabs),
      static_cast<float*>(wpart), B, L);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  dist_bwd_table_reduce_kernel<<<NV, NT, 0, s>>>(static_cast<const float*>(slabs),
                                        static_cast<const int*>(aa), B * L,
                                        static_cast<float*>(d_table));
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int nout = AA2 * F + F * F + 2 * F;
  dist_bwd_param_reduce_kernel<<<(nout + NT - 1) / NT, NT, 0, s>>>(
      static_cast<const float*>(wpart), grid, static_cast<float*>(d_k1),
      static_cast<float*>(d_b1), static_cast<float*>(d_k2), static_cast<float*>(d_b2));
  return (int)cudaGetLastError();
}
