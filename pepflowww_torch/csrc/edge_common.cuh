// Pieces of the int8 EdgeTransition forward kernel (edge_transition_int8.cu,
// K6): widths and the pair tile, bf16 WMMA helpers, the node-resolution
// pre-pass (node_proj and its scratch P), and the epilogue (LayerNorm, pair
// mask and the optional pair-resident readout). Only K6 uses them: the bf16
// kernels K1/K2 (edge_transition.cu) run their products on wgmma
// (wgmma.cuh), gather the node rows per pair instead of a pre-pass, and
// keep their epilogues in registers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace edge {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int CZ = 64;     // pair channels in and out
constexpr int HID = 192;   // hidden width = CZ + 2 * CB
constexpr int RO = 32;     // readout lanes (n_b + n_pz <= 32), zero-padded
constexpr int NP = 512;    // node-product lanes: [W1i 192 | W1j 192 | W3i 64 | W3j 64]
constexpr int TM = 64;     // pair rows per tile
constexpr int NT = 256;    // threads per block (8 warps)

// Shared-memory leading dimensions, padded against bank conflicts.
constexpr int LD_H = HID + 8;
constexpr int LD_Z = CZ + 8;
constexpr int LD_R = RO + 8;
constexpr int LD_S = HID + 4;

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;

template <int N>
__device__ __forceinline__ void mma_acc(Acc (&acc)[N], const bf16* A, int lda,
                                        const bf16* Bm, int ldb, int ksteps, int rm, int cn0) {
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
  for (int k = 0; k < ksteps; ++k) {
    wmma::load_matrix_sync(a, A + rm * 16 * lda + k * 16, lda);
#pragma unroll
    for (int n = 0; n < N; ++n) {
      wmma::load_matrix_sync(b, Bm + k * 16 * ldb + (cn0 + n) * 16, ldb);
      wmma::mma_sync(acc[n], a, b, acc[n]);
    }
  }
}

template <int N>
__device__ __forceinline__ void store_acc(Acc (&acc)[N], float* S, int rm, int cn0) {
#pragma unroll
  for (int n = 0; n < N; ++n)
    wmma::store_matrix_sync(S + rm * 16 * LD_S + (cn0 + n) * 16, acc[n], LD_S,
                            wmma::mem_row_major);
}

template <int N>
__device__ __forceinline__ void zero_acc(Acc (&acc)[N]) {
#pragma unroll
  for (int n = 0; n < N; ++n) wmma::fill_fragment(acc[n], 0.0f);
}

// rows x cols bf16 (cols % 8 == 0) from global (row stride lds) to shared.
__device__ __forceinline__ void stage(bf16* dst, int ldd, const bf16* src, int lds,
                                      int rows, int cols) {
  const int per_row = cols / 8;
  for (int v = threadIdx.x; v < rows * per_row; v += blockDim.x) {
    const int r = v / per_row, c = (v % per_row) * 8;
    *reinterpret_cast<uint4*>(dst + r * ldd + c) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * lds + c);
  }
}

// Node-resolution products of residue blockIdx.x, once per residue:
// P[r] = [n.W1[64:128] | n.W1[128:192] | n.W3[64:128] | n.W3[128:192]]
// with the bf16 weights w1 (192 x 192) and w3 (192 x 64).
__device__ __forceinline__ void node_proj(const bf16* __restrict__ node,
                                          const bf16* __restrict__ w1,
                                          const bf16* __restrict__ w3, float* __restrict__ P) {
  __shared__ float n_s[CZ];
  const int r = blockIdx.x;
  if (threadIdx.x < CZ) n_s[threadIdx.x] = __bfloat162float(node[(size_t)r * CZ + threadIdx.x]);
  __syncthreads();
  for (int c = threadIdx.x; c < NP; c += blockDim.x) {
    const bf16* w;
    int ldw, col, row0;
    if (c < HID) { w = w1; ldw = HID; col = c; row0 = CZ; }
    else if (c < 2 * HID) { w = w1; ldw = HID; col = c - HID; row0 = 2 * CZ; }
    else if (c < 2 * HID + CZ) { w = w3; ldw = CZ; col = c - 2 * HID; row0 = CZ; }
    else { w = w3; ldw = CZ; col = c - 2 * HID - CZ; row0 = 2 * CZ; }
    float acc = 0.f;
#pragma unroll 8
    for (int k = 0; k < CZ; ++k) acc += n_s[k] * __bfloat162float(w[(row0 + k) * ldw + col]);
    P[(size_t)r * NP + c] = acc;
  }
}

// Output of the tile's pair rows: o = s_s[r][c] (+ s_s[r][extra + c] when
// extra >= 0) + n_i.W3i + n_j.W3j + b3, LayerNorm (fp32 statistics), affine,
// pair mask, rounded to bf16 into `out` and, with READOUT, into the edge tile
// e_s for the readout product. One warp per pair row, two channels per lane.
template <bool READOUT>
__device__ __forceinline__ void layer_norm_store(const float* s_s, int extra, const float* P,
                                                 const float* mask, const float* b3_s,
                                                 const float* lns_s, const float* lnb_s,
                                                 bf16* out, bf16* e_s, long long row0,
                                                 long long total, int L, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long LL = (long long)L * L;
  for (int r = warp; r < TM; r += NT / 32) {
    const long long row = row0 + r;
    if (row >= total) continue;
    const long long bi = row / L;                       // b * L + i
    const long long bj = (row / LL) * L + row % L;      // b * L + j
    const int c0 = 2 * lane;
    const float* pi = P + bi * NP + 2 * HID;
    const float* pj = P + bj * NP + 2 * HID + CZ;
    float v0 = s_s[r * LD_S + c0], v1 = s_s[r * LD_S + c0 + 1];
    if (extra >= 0) {
      v0 += s_s[r * LD_S + extra + c0];
      v1 += s_s[r * LD_S + extra + c0 + 1];
    }
    v0 = v0 + pi[c0] + pj[c0] + b3_s[c0];
    v1 = v1 + pi[c0 + 1] + pj[c0 + 1] + b3_s[c0 + 1];
    float sum = v0 + v1;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float mu = sum * (1.f / CZ);
    const float d0 = v0 - mu, d1 = v1 - mu;
    float sq = d0 * d0 + d1 * d1;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
    const float rstd = rsqrtf(sq * (1.f / CZ) + eps);
    const float pm = mask[bi] * mask[bj];
    const float o0 = (d0 * rstd * lns_s[c0] + lnb_s[c0]) * pm;
    const float o1 = (d1 * rstd * lns_s[c0 + 1] + lnb_s[c0 + 1]) * pm;
    const __nv_bfloat162 ob = __floats2bfloat162_rn(o0, o1);
    *reinterpret_cast<__nv_bfloat162*>(out + row * CZ + c0) = ob;
    if (READOUT) *reinterpret_cast<__nv_bfloat162*>(e_s + r * LD_Z + c0) = ob;
  }
}

// The next IPA block's pair readouts from the bf16 output tile e_s:
// bf16(out)[64x64] . [kb | kdz | 0][64x32] + [bb | bdz], stored transposed
// as b (B, n_b, L, L) and pz (B, n_pz, L, L). Overwrites s_s; all threads
// of the block call it.
__device__ __forceinline__ void readout_store(const bf16* e_s, const bf16* wr_s, float* s_s,
                                              const float* bro_s, bf16* b_out, bf16* pz_out,
                                              long long row0, long long total, int L, int n_b,
                                              int n_pz) {
  const int tid = threadIdx.x, warp = tid >> 5, rm = warp >> 1;
  __syncthreads();
  {
    Acc acc[1];
    zero_acc(acc);
    mma_acc(acc, e_s, LD_Z, wr_s, LD_R, CZ / 16, rm, warp & 1);
    store_acc(acc, s_s, rm, warp & 1);
  }
  __syncthreads();
  // Transposed stores: consecutive threads take consecutive pairs.
  const long long LL = (long long)L * L;
  const int nro = n_b + n_pz;
  for (int idx = tid; idx < nro * TM; idx += NT) {
    const int c = idx / TM, r = idx % TM;
    const long long row = row0 + r;
    if (row >= total) continue;
    const long long b = row / LL, p = row % LL;
    const bf16 v = __float2bfloat16(s_s[r * LD_S + c] + bro_s[c]);
    if (c < n_b) b_out[(b * n_b + c) * LL + p] = v;
    else pz_out[(b * n_pz + (c - n_b)) * LL + p] = v;
  }
}

}  // namespace edge
