// Fused EdgeTransition backward for Hopper, sm_90a.
//
// Replaces: pepflowww_tpu/models/pallas_edge_bwd.py::edge_transition_bwd
// (body `_bwd_kernel`), the backward half of fused_edge_transition_vjp.
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
//              db = column sums, d_ln_scale = sum g'*y, d_ln_bias = sum g'.
// GEMM operands are bf16 with fp32 accumulation, at the JAX kernel's
// rounding points; LayerNorm statistics and every sum are fp32.
//
// What bounds it on this card: per pair ~61k MAC of recompute (e.W1e, W2,
// r.W3) and ~123k MAC of backward products (dr, dh1, d_edge, dW1e, dW2,
// dW3), all bf16 on the tensor cores; the node terms run at node
// resolution. So operations bound it (~49 us at B=32, L=64 at 989 TFLOP/s).
//
// Design. The TPU kernel sums its weight and node gradients across grid
// steps in place, relying on the TPU grid running in order. GPU blocks run
// concurrently and in no order, so every cross-block sum here goes through
// partials added in a fixed order, and no float atomics: two runs give
// bit-identical gradients. Stages:
//  1. edge_bwd_node_proj_kernel: the node products P = n.[W1i | W1j | W3i | W3j]
//     once per residue (as in the forward).
//  2. edge_bwd_tile_kernel: a persistent grid (one block per SM) walks 32-pair
//     tiles; W1e, W2 and W3 stay in shared memory. Per tile it recomputes
//     the forward and runs the LayerNorm backward and the three backward
//     products (dr, dh1, d_edge) on bf16 WMMA, writes d_edge, and writes
//     the bf16 GEMM operands of the weight gradients (h1, r, do, da2, da1)
//     to scratch. Bias and LayerNorm-parameter sums stay in registers and
//     leave as one partial per block.
//  3. edge_bwd_atb_kernel (x3): the weight gradients dW1e = e^T.da1, dW2 = h1^T.da2,
//     dW3 = r^T.do as split-K products over the pairs, one fp32 partial per
//     pair chunk.
//  4. edge_bwd_node_sum_kernel: per residue the sums of da1 and do over its row and
//     its column of pairs, then d_node from them and W1i, W1j, W3i, W3j.
//  5. edge_bwd_node_weight_kernel: the node rows of dW1 from those sums.
//  6. edge_bwd_reduce_kernel: the partials summed in a fixed order.
// Writing the weight-gradient operands to device memory (~1.7 KB per pair)
// is this design's cost, not the function's: it keeps every cross-block sum
// out of registers and atomics. Pairs are flattened over (b, i, j), so any
// L runs: the ragged last tile is masked here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>
#include <type_traits>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int CZ = 64;     // pair channels in and out; node-bias width
constexpr int HID = 192;   // hidden width = 3 * CZ
constexpr int NP = 512;    // node-product lanes: [W1i 192 | W1j 192 | W3i 64 | W3j 64]
constexpr int TM = 32;     // pair rows per tile
constexpr int NT = 256;    // threads per block (8 warps)
constexpr int VEC = 2 * HID + 3 * CZ;  // d_b1 | d_b2 | d_b3 | d_ln_scale | d_ln_bias
constexpr int NS = 2 * HID + 2 * CZ;   // node sums: da1 row | da1 col | do row | do col

constexpr int LD_H = HID + 8;
constexpr int LD_Z = CZ + 8;
constexpr int LD_S = HID + 4;
constexpr int LD_E = CZ + 4;

constexpr int OFF_W1 = 0;                              // W1e [64][LD_H]
constexpr int OFF_W2 = OFF_W1 + CZ * LD_H * 2;         // W2 [192][LD_H]
constexpr int OFF_W3 = OFF_W2 + HID * LD_H * 2;        // W3 [192][LD_Z]
constexpr int OFF_E = OFF_W3 + HID * LD_Z * 2;         // edge tile [32][LD_Z]
constexpr int OFF_HA = OFF_E + TM * LD_Z * 2;          // h1, then da2 [32][LD_H]
constexpr int OFF_HB = OFF_HA + TM * LD_H * 2;         // r, then da1 [32][LD_H]
constexpr int OFF_DO = OFF_HB + TM * LD_H * 2;         // do [32][LD_Z]
constexpr int OFF_S = OFF_DO + TM * LD_Z * 2;          // fp32 accumulators [32][LD_S]
constexpr int OFF_DR = OFF_S + TM * LD_S * 4;          // dr[:, :64] fp32 [32][LD_E]
constexpr int OFF_M1 = OFF_DR + TM * LD_E * 4;         // a1 > 0 [32][192] bytes
constexpr int OFF_M2 = OFF_M1 + TM * HID;              // a2 > 0 [32][192] bytes
constexpr int OFF_V = OFF_M2 + TM * HID;               // b1 b2 b3 ln_s
constexpr int SMEM_BYTES = OFF_V + (2 * HID + 2 * CZ) * 4;

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;

// acc[n] += A[rm-th 16 rows, K] . B[K, (cn0+n)-th 16 cols]; B is either a
// row-major [K][ldb] matrix or, with col_major, the transpose of a
// row-major [N][ldb] one (so W^T is read from W as it is stored).
template <int N, typename BLayout>
__device__ __forceinline__ void mma_acc(Acc (&acc)[N], const bf16* A, int lda, const bf16* Bm,
                                        int ldb, int ksteps, int rm, int cn0) {
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> b;
  for (int k = 0; k < ksteps; ++k) {
    wmma::load_matrix_sync(a, A + rm * 16 * lda + k * 16, lda);
#pragma unroll
    for (int n = 0; n < N; ++n) {
      if constexpr (std::is_same<BLayout, wmma::row_major>::value)
        wmma::load_matrix_sync(b, Bm + k * 16 * ldb + (cn0 + n) * 16, ldb);
      else
        wmma::load_matrix_sync(b, Bm + (cn0 + n) * 16 * ldb + k * 16, ldb);
      wmma::mma_sync(acc[n], a, b, acc[n]);
    }
  }
}

template <int N>
__device__ __forceinline__ void store_acc(Acc (&acc)[N], float* S, int lds, int rm, int cn0) {
#pragma unroll
  for (int n = 0; n < N; ++n)
    wmma::store_matrix_sync(S + rm * 16 * lds + (cn0 + n) * 16, acc[n], lds, wmma::mem_row_major);
}

template <int N>
__device__ __forceinline__ void zero_acc(Acc (&acc)[N]) {
#pragma unroll
  for (int n = 0; n < N; ++n) wmma::fill_fragment(acc[n], 0.0f);
}

__device__ __forceinline__ void stage(bf16* dst, int ldd, const bf16* src, int lds, int rows,
                                      int cols) {
  const int per_row = cols / 8;
  for (int v = threadIdx.x; v < rows * per_row; v += blockDim.x) {
    const int r = v / per_row, c = (v % per_row) * 8;
    *reinterpret_cast<uint4*>(dst + r * ldd + c) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * lds + c);
  }
}

// Node-resolution products, once per residue (as in the forward):
// P[r] = [n.W1[64:128] | n.W1[128:192] | n.W3[64:128] | n.W3[128:192]].
__global__ void edge_bwd_node_proj_kernel(const bf16* __restrict__ node,
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

__global__ void __launch_bounds__(NT, 1)
edge_bwd_tile_kernel(const bf16* __restrict__ edge, const bf16* __restrict__ node,
                     const float* __restrict__ P, const float* __restrict__ mask,
                     const bf16* __restrict__ g, const bf16* __restrict__ w1,
                     const float* __restrict__ b1, const bf16* __restrict__ w2,
                     const float* __restrict__ b2, const bf16* __restrict__ w3,
                     const float* __restrict__ b3, const float* __restrict__ ln_s,
                     bf16* __restrict__ H1, bf16* __restrict__ R, bf16* __restrict__ DA1,
                     bf16* __restrict__ DA2, bf16* __restrict__ DO, float* __restrict__ vpart,
                     void* __restrict__ d_edge, int d_edge_f32, int L, long long total, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* w1_s = reinterpret_cast<bf16*>(smem + OFF_W1);
  bf16* w2_s = reinterpret_cast<bf16*>(smem + OFF_W2);
  bf16* w3_s = reinterpret_cast<bf16*>(smem + OFF_W3);
  bf16* e_s = reinterpret_cast<bf16*>(smem + OFF_E);
  bf16* ha_s = reinterpret_cast<bf16*>(smem + OFF_HA);
  bf16* hb_s = reinterpret_cast<bf16*>(smem + OFF_HB);
  bf16* do_s = reinterpret_cast<bf16*>(smem + OFF_DO);
  float* s_s = reinterpret_cast<float*>(smem + OFF_S);
  float* dr_s = reinterpret_cast<float*>(smem + OFF_DR);
  uint8_t* m1_s = smem + OFF_M1;
  uint8_t* m2_s = smem + OFF_M2;
  float* b1_s = reinterpret_cast<float*>(smem + OFF_V);
  float* b2_s = b1_s + HID;
  float* b3_s = b2_s + HID;
  float* lns_s = b3_s + CZ;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  stage(w1_s, LD_H, w1, HID, CZ, HID);   // W1 rows 0..63: the edge part
  stage(w2_s, LD_H, w2, HID, HID, HID);
  stage(w3_s, LD_Z, w3, CZ, HID, CZ);
  for (int c = tid; c < HID; c += NT) { b1_s[c] = b1[c]; b2_s[c] = b2[c]; }
  for (int c = tid; c < CZ; c += NT) { b3_s[c] = b3[c]; lns_s[c] = ln_s[c]; }
  __syncthreads();

  // Per-thread partial sums: column tid of d_b1 and d_b2 (tid < 192), and
  // channels 2*lane, 2*lane+1 of d_b3, d_ln_scale, d_ln_bias (per warp).
  float acc_b1 = 0.f, acc_b2 = 0.f;
  float acc_b3[2] = {0.f, 0.f}, acc_sc[2] = {0.f, 0.f}, acc_bi[2] = {0.f, 0.f};

  const long long LL = (long long)L * L;
  const long long ntiles = (total + TM - 1) / TM;
  const int rm = warp & 1, cg = warp >> 1;   // 16-row block, column group of this warp
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long row0 = tile * TM;
    for (int v = tid; v < TM * (CZ / 8); v += NT) {
      const int r = v >> 3, c8 = (v & 7) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (row0 + r < total) val = *reinterpret_cast<const uint4*>(edge + (row0 + r) * CZ + c8);
      *reinterpret_cast<uint4*>(e_s + r * LD_Z + c8) = val;
    }
    __syncthreads();

    {  // a1 accumulators: E[32x64] . W1e[64x192]
      Acc acc[3];
      zero_acc(acc);
      mma_acc<3, wmma::row_major>(acc, e_s, LD_Z, w1_s, LD_H, CZ / 16, rm, cg * 3);
      store_acc(acc, s_s, LD_S, rm, cg * 3);
    }
    __syncthreads();
    for (int idx = tid; idx < TM * HID; idx += NT) {
      const int r = idx / HID, c = idx % HID;
      const long long row = row0 + r;
      float a = 0.f;
      if (row < total) {
        const long long bi = row / L, bj = (row / LL) * L + row % L;
        a = s_s[r * LD_S + c] + P[bi * NP + c] + P[bj * NP + HID + c] + b1_s[c];
      }
      const bf16 h = __float2bfloat16(fmaxf(a, 0.f));
      ha_s[r * LD_H + c] = h;
      m1_s[r * HID + c] = a > 0.f;
      if (row < total) H1[row * HID + c] = h;
    }
    __syncthreads();

    {  // a2 accumulators: bf16(h1)[32x192] . W2[192x192]
      Acc acc[3];
      zero_acc(acc);
      mma_acc<3, wmma::row_major>(acc, ha_s, LD_H, w2_s, LD_H, HID / 16, rm, cg * 3);
      store_acc(acc, s_s, LD_S, rm, cg * 3);
    }
    __syncthreads();
    for (int idx = tid; idx < TM * HID; idx += NT) {
      const int r = idx / HID, c = idx % HID;
      const long long row = row0 + r;
      float rv = 0.f;
      uint8_t pos = 0;
      if (row < total) {
        const float a = s_s[r * LD_S + c] + b2_s[c];
        pos = a > 0.f;
        float xc;
        if (c < CZ) xc = __bfloat162float(e_s[r * LD_Z + c]);
        else if (c < 2 * CZ) xc = __bfloat162float(node[(row / L) * CZ + c - CZ]);
        else xc = __bfloat162float(node[((row / LL) * L + row % L) * CZ + c - 2 * CZ]);
        rv = fmaxf(a, 0.f) + xc;
      }
      const bf16 rb = __float2bfloat16(rv);
      hb_s[r * LD_H + c] = rb;
      m2_s[r * HID + c] = pos;
      if (row < total) R[row * HID + c] = rb;
    }
    __syncthreads();

    {  // o accumulators: bf16(r)[32x192] . W3[192x64]
      Acc acc[1];
      zero_acc(acc);
      mma_acc<1, wmma::row_major>(acc, hb_s, LD_H, w3_s, LD_Z, HID / 16, rm, cg);
      store_acc(acc, s_s, LD_S, rm, cg);
    }
    __syncthreads();

    // LayerNorm forward and backward, one warp per pair row, two channels per lane.
    for (int r = warp; r < TM; r += NT / 32) {
      const long long row = row0 + r;
      const int c0 = 2 * lane;
      if (row >= total) {
        *reinterpret_cast<__nv_bfloat162*>(do_s + r * LD_Z + c0) = __floats2bfloat162_rn(0.f, 0.f);
        continue;
      }
      const long long bi = row / L, bj = (row / LL) * L + row % L;
      const float o0 = s_s[r * LD_S + c0] + b3_s[c0];
      const float o1 = s_s[r * LD_S + c0 + 1] + b3_s[c0 + 1];
      float sum = o0 + o1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float mu = sum * (1.f / CZ);
      const float d0 = o0 - mu, d1 = o1 - mu;
      float sq = d0 * d0 + d1 * d1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
      const float inv = rsqrtf(sq * (1.f / CZ) + eps);
      const float y0 = d0 * inv, y1 = d1 * inv;
      const float pm = mask[bi] * mask[bj];
      const __nv_bfloat162 gb = *reinterpret_cast<const __nv_bfloat162*>(g + row * CZ + c0);
      const float g0 = __low2float(gb) * pm, g1 = __high2float(gb) * pm;
      acc_sc[0] += g0 * y0; acc_sc[1] += g1 * y1;
      acc_bi[0] += g0; acc_bi[1] += g1;
      const float dy0 = g0 * lns_s[c0], dy1 = g1 * lns_s[c0 + 1];
      float m1 = dy0 + dy1, m2 = dy0 * y0 + dy1 * y1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        m1 += __shfl_xor_sync(0xffffffffu, m1, o);
        m2 += __shfl_xor_sync(0xffffffffu, m2, o);
      }
      m1 *= (1.f / CZ);
      m2 *= (1.f / CZ);
      const float do0 = (dy0 - m1 - y0 * m2) * inv, do1 = (dy1 - m1 - y1 * m2) * inv;
      acc_b3[0] += do0; acc_b3[1] += do1;
      const __nv_bfloat162 db = __floats2bfloat162_rn(do0, do1);
      *reinterpret_cast<__nv_bfloat162*>(do_s + r * LD_Z + c0) = db;
      *reinterpret_cast<__nv_bfloat162*>(DO + row * CZ + c0) = db;
    }
    __syncthreads();

    {  // dr accumulators: bf16(do)[32x64] . W3^T[64x192]
      Acc acc[3];
      zero_acc(acc);
      mma_acc<3, wmma::col_major>(acc, do_s, LD_Z, w3_s, LD_Z, CZ / 16, rm, cg * 3);
      store_acc(acc, s_s, LD_S, rm, cg * 3);
    }
    __syncthreads();
    if (tid < HID) {  // da2 = dr * (a2 > 0); thread tid owns column tid
      const int c = tid;
      for (int r = 0; r < TM; ++r) {
        const long long row = row0 + r;
        const float dr = s_s[r * LD_S + c];
        if (c < CZ) dr_s[r * LD_E + c] = dr;
        const float da2 = m2_s[r * HID + c] ? dr : 0.f;
        acc_b2 += da2;
        const bf16 v = __float2bfloat16(da2);
        ha_s[r * LD_H + c] = v;
        if (row < total) DA2[row * HID + c] = v;
      }
    }
    __syncthreads();

    {  // dh1 accumulators: bf16(da2)[32x192] . W2^T[192x192]
      Acc acc[3];
      zero_acc(acc);
      mma_acc<3, wmma::col_major>(acc, ha_s, LD_H, w2_s, LD_H, HID / 16, rm, cg * 3);
      store_acc(acc, s_s, LD_S, rm, cg * 3);
    }
    __syncthreads();
    if (tid < HID) {  // da1 = dh1 * (a1 > 0)
      const int c = tid;
      for (int r = 0; r < TM; ++r) {
        const long long row = row0 + r;
        const float da1 = m1_s[r * HID + c] ? s_s[r * LD_S + c] : 0.f;
        acc_b1 += da1;
        const bf16 v = __float2bfloat16(da1);
        hb_s[r * LD_H + c] = v;
        if (row < total) DA1[row * HID + c] = v;
      }
    }
    __syncthreads();

    {  // d_edge = dr[:, :64] + bf16(da1)[32x192] . W1e^T[192x64]
      Acc acc[1];
      wmma::load_matrix_sync(acc[0], dr_s + rm * 16 * LD_E + cg * 16, LD_E, wmma::mem_row_major);
      mma_acc<1, wmma::col_major>(acc, hb_s, LD_H, w1_s, LD_H, HID / 16, rm, cg);
      store_acc(acc, s_s, LD_S, rm, cg);
    }
    __syncthreads();
    for (int idx = tid; idx < TM * CZ; idx += NT) {
      const int r = idx / CZ, c = idx % CZ;
      const long long row = row0 + r;
      if (row >= total) continue;
      const float v = s_s[r * LD_S + c];
      if (d_edge_f32) static_cast<float*>(d_edge)[row * CZ + c] = v;
      else static_cast<bf16*>(d_edge)[row * CZ + c] = __float2bfloat16(v);
    }
    __syncthreads();
  }

  // This block's partial: d_b1, d_b2 by column owner; the LayerNorm-side
  // channel sums reduced over the 8 warps in order.
  float* part = vpart + (size_t)blockIdx.x * VEC;
  if (tid < HID) {
    part[tid] = acc_b1;
    part[HID + tid] = acc_b2;
  }
  float* red = s_s;  // [8 warps][3][64]
  const int c0 = 2 * lane;
  for (int q = 0; q < 2; ++q) {
    red[(warp * 3 + 0) * CZ + c0 + q] = acc_b3[q];
    red[(warp * 3 + 1) * CZ + c0 + q] = acc_sc[q];
    red[(warp * 3 + 2) * CZ + c0 + q] = acc_bi[q];
  }
  __syncthreads();
  if (tid < 3 * CZ) {
    const int k = tid / CZ, c = tid % CZ;
    float s = 0.f;
    for (int w = 0; w < NT / 32; ++w) s += red[(w * 3 + k) * CZ + c];
    part[2 * HID + k * CZ + c] = s;
  }
}

// out[z][M][N] = sum over the pairs p of chunk z of A[p][m0+m] * B[p][n0+n]:
// one 64x64 tile of a weight gradient per block, fp32 partial per chunk.
constexpr int KC = 32;
__global__ void __launch_bounds__(NT)
edge_bwd_atb_kernel(const bf16* __restrict__ A, int lda, const bf16* __restrict__ Bm, int ldb,
                    int M, int N, long long P, long long chunk, float* __restrict__ out) {
  __shared__ __align__(128) unsigned char ab_raw[2 * KC * LD_Z * 2];
  bf16* As = reinterpret_cast<bf16*>(ab_raw);
  bf16* Bs = As + KC * LD_Z;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int m0 = blockIdx.y * 64, n0 = blockIdx.x * 64;
  const long long p0 = blockIdx.z * chunk;
  const long long p1 = p0 + chunk < P ? p0 + chunk : P;
  const int wm = warp >> 1, wn = (warp & 1) * 2;
  Acc acc[2];
  zero_acc(acc);
  for (long long p = p0; p < p1; p += KC) {
    for (int v = tid; v < KC * 8; v += NT) {
      const int r = v >> 3, c8 = (v & 7) * 8;
      uint4 va = make_uint4(0, 0, 0, 0), vb = make_uint4(0, 0, 0, 0);
      if (p + r < p1) {
        va = *reinterpret_cast<const uint4*>(A + (p + r) * lda + m0 + c8);
        vb = *reinterpret_cast<const uint4*>(Bm + (p + r) * ldb + n0 + c8);
      }
      *reinterpret_cast<uint4*>(As + r * LD_Z + c8) = va;
      *reinterpret_cast<uint4*>(Bs + r * LD_Z + c8) = vb;
    }
    __syncthreads();
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
#pragma unroll
    for (int k = 0; k < KC / 16; ++k) {
      wmma::load_matrix_sync(a, As + k * 16 * LD_Z + wm * 16, LD_Z);   // A^T tile
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        wmma::load_matrix_sync(b, Bs + k * 16 * LD_Z + (wn + n) * 16, LD_Z);
        wmma::mma_sync(acc[n], a, b, acc[n]);
      }
    }
    __syncthreads();
  }
  float* o = out + (size_t)blockIdx.z * M * N + (size_t)(m0 + wm * 16) * N + n0;
#pragma unroll
  for (int n = 0; n < 2; ++n)
    wmma::store_matrix_sync(o + (wn + n) * 16, acc[n], N, wmma::mem_row_major);
}

// Per residue k of row b: the sums of da1 and do over its row (pairs (k, j))
// and its column (pairs (i, k)), then
// d_node = rowda1.W1i^T + rowdo.W3i^T + colda1.W1j^T + coldo.W3j^T.
constexpr int NB = 16;   // residues per block
__global__ void __launch_bounds__(NT)
edge_bwd_node_sum_kernel(const bf16* __restrict__ DA1, const bf16* __restrict__ DO,
                         const bf16* __restrict__ w1, const bf16* __restrict__ w3,
                         float* __restrict__ nsum, float* __restrict__ d_node, int BL, int L) {
  __shared__ float s_s[NB * NS];
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * NB;
  for (int q = 0; q < NB; ++q) {
    const int n = n0 + q;
    if (n >= BL) break;
    const long long b = n / L, k = n % L;
    if (tid < HID) {
      float rs = 0.f, cs = 0.f;
      for (int j = 0; j < L; ++j) {
        rs += __bfloat162float(DA1[((b * L + k) * L + j) * HID + tid]);
        cs += __bfloat162float(DA1[((b * L + j) * L + k) * HID + tid]);
      }
      s_s[q * NS + tid] = rs;
      s_s[q * NS + HID + tid] = cs;
    } else {
      const int c = tid - HID;
      float rs = 0.f, cs = 0.f;
      for (int j = 0; j < L; ++j) {
        rs += __bfloat162float(DO[((b * L + k) * L + j) * CZ + c]);
        cs += __bfloat162float(DO[((b * L + j) * L + k) * CZ + c]);
      }
      s_s[q * NS + 2 * HID + c] = rs;
      s_s[q * NS + 2 * HID + CZ + c] = cs;
    }
  }
  __syncthreads();
  for (int v = tid; v < NB * NS; v += NT) {
    const int n = n0 + v / NS;
    if (n < BL) nsum[(size_t)n * NS + v % NS] = s_s[v];
  }
  for (int o = tid; o < NB * CZ; o += NT) {
    const int q = o / CZ, m = o % CZ, n = n0 + q;
    if (n >= BL) continue;
    const float* s = s_s + q * NS;
    float acc = 0.f;
    for (int c = 0; c < HID; ++c)
      acc += s[c] * __bfloat162float(w1[(CZ + m) * HID + c]) +
             s[HID + c] * __bfloat162float(w1[(2 * CZ + m) * HID + c]);
    for (int c = 0; c < CZ; ++c)
      acc += s[2 * HID + c] * __bfloat162float(w3[(CZ + m) * CZ + c]) +
             s[2 * HID + CZ + c] * __bfloat162float(w3[(2 * CZ + m) * CZ + c]);
    d_node[(size_t)n * CZ + m] = acc;
  }
}

// The node rows of dW1: dW1[64 + m][c] = sum over residues of n[m] * rowda1[c],
// dW1[128 + m][c] = sum over residues of n[m] * colda1[c]. Block: one row.
__global__ void edge_bwd_node_weight_kernel(const bf16* __restrict__ node,
                                            const float* __restrict__ nsum,
                                            float* __restrict__ dw1, int BL) {
  const int half = blockIdx.x / CZ, m = blockIdx.x % CZ, c = threadIdx.x;
  float acc = 0.f;
  for (int n = 0; n < BL; ++n)
    acc += __bfloat162float(node[(size_t)n * CZ + m]) * nsum[(size_t)n * NS + half * HID + c];
  dw1[(CZ + blockIdx.x) * HID + c] = acc;
}

// Partials summed in a fixed order: dW1e, dW2, dW3 over the pair chunks and
// the vectors over the blocks of edge_bwd_tile_kernel.
__global__ void edge_bwd_reduce_kernel(const float* __restrict__ wpart,
                                       const float* __restrict__ vpart, int nchunk, int nblocks,
                                       float* __restrict__ dw1, float* __restrict__ dw2,
                                       float* __restrict__ dw3, float* __restrict__ db1,
                                       float* __restrict__ db2, float* __restrict__ db3,
                                       float* __restrict__ dsc, float* __restrict__ dbi) {
  // wpart holds [dW1e chunks][dW2 chunks][dW3 chunks], each [nchunk][size].
  constexpr int N1 = CZ * HID, N2 = HID * HID, N3 = HID * CZ, NW = N1 + N2 + N3;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < NW) {
    const float* src;
    float* dst;
    int size;
    int j;
    if (i < N1) {
      j = i; src = wpart + j; dst = dw1 + j; size = N1;
    } else if (i < N1 + N2) {
      j = i - N1; src = wpart + (size_t)nchunk * N1 + j; dst = dw2 + j; size = N2;
    } else {
      j = i - N1 - N2; src = wpart + (size_t)nchunk * (N1 + N2) + j; dst = dw3 + j; size = N3;
    }
    float s = 0.f;
    for (int z = 0; z < nchunk; ++z) s += src[(size_t)z * size];
    *dst = s;
  } else if (i < NW + VEC) {
    const int v = i - NW;
    float s = 0.f;
    for (int b = 0; b < nblocks; ++b) s += vpart[(size_t)b * VEC + v];
    if (v < HID) db1[v] = s;
    else if (v < 2 * HID) db2[v - HID] = s;
    else if (v < 2 * HID + CZ) db3[v - 2 * HID] = s;
    else if (v < 2 * HID + 2 * CZ) dsc[v - 2 * HID - CZ] = s;
    else dbi[v - 2 * HID - 2 * CZ] = s;
  }
}

constexpr int MAX_DEVICES = 64;
bool g_smem_opt_in[MAX_DEVICES];

}  // namespace

// Launches every stage on `stream`; returns the first non-zero cudaError_t
// of the launches (0 on success). Scratch and outputs come from the caller:
// P [B*L][512] f32; H1, R, DA1, DA2 [B*L*L][192] bf16; DO [B*L*L][64] bf16;
// vpart [grid][576] f32; wpart [nchunk][64*192 + 192*192 + 192*64] f32;
// nsum [B*L][512] f32.
extern "C" int edge_transition_backward(
    const void* edge, const void* node, const void* mask, const void* g, const void* w1,
    const void* b1, const void* w2, const void* b2, const void* w3, const void* b3,
    const void* ln_s, const void* ln_b, void* P, void* H1, void* R, void* DA1, void* DA2,
    void* DO, void* vpart, void* wpart, void* nsum, void* d_edge, void* d_node, void* dw1,
    void* db1, void* dw2, void* db2, void* dw3, void* db3, void* dsc, void* dbi, int B, int L,
    int grid, int nchunk, int d_edge_f32, float eps, void* stream) {
  (void)ln_b;  // the LayerNorm bias does not enter the backward
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!g_smem_opt_in[dev]) {
    err = cudaFuncSetAttribute(edge_bwd_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    g_smem_opt_in[dev] = true;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* e = static_cast<const bf16*>(edge);
  const bf16* n = static_cast<const bf16*>(node);
  const bf16* W1 = static_cast<const bf16*>(w1);
  const bf16* W3 = static_cast<const bf16*>(w3);
  bf16* h1 = static_cast<bf16*>(H1);
  bf16* r = static_cast<bf16*>(R);
  bf16* da1 = static_cast<bf16*>(DA1);
  bf16* da2 = static_cast<bf16*>(DA2);
  bf16* dO = static_cast<bf16*>(DO);
  float* wp = static_cast<float*>(wpart);
  const int BL = B * L;
  const long long total = (long long)BL * L;

  edge_bwd_node_proj_kernel<<<BL, NT, 0, s>>>(n, W1, W3, static_cast<float*>(P));
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  edge_bwd_tile_kernel<<<grid, NT, SMEM_BYTES, s>>>(
      e, n, static_cast<const float*>(P), static_cast<const float*>(mask),
      static_cast<const bf16*>(g), W1, static_cast<const float*>(b1),
      static_cast<const bf16*>(w2), static_cast<const float*>(b2), W3,
      static_cast<const float*>(b3), static_cast<const float*>(ln_s), h1, r, da1, da2, dO,
      static_cast<float*>(vpart), d_edge, d_edge_f32, L, total, eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const long long chunk = ((total + nchunk - 1) / nchunk + KC - 1) / KC * KC;
  edge_bwd_atb_kernel<<<dim3(HID / 64, CZ / 64, nchunk), NT, 0, s>>>(
      e, CZ, da1, HID, CZ, HID, total, chunk, wp);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  edge_bwd_atb_kernel<<<dim3(HID / 64, HID / 64, nchunk), NT, 0, s>>>(
      h1, HID, da2, HID, HID, HID, total, chunk, wp + (size_t)nchunk * CZ * HID);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  edge_bwd_atb_kernel<<<dim3(CZ / 64, HID / 64, nchunk), NT, 0, s>>>(
      r, HID, dO, CZ, HID, CZ, total, chunk, wp + (size_t)nchunk * (CZ * HID + HID * HID));
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  edge_bwd_node_sum_kernel<<<(BL + NB - 1) / NB, NT, 0, s>>>(
      da1, dO, W1, W3, static_cast<float*>(nsum), static_cast<float*>(d_node), BL, L);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  edge_bwd_node_weight_kernel<<<2 * CZ, HID, 0, s>>>(n, static_cast<const float*>(nsum),
                                                     static_cast<float*>(dw1), BL);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const int nout = CZ * HID + HID * HID + HID * CZ + VEC;
  edge_bwd_reduce_kernel<<<(nout + NT - 1) / NT, NT, 0, s>>>(
      wp, static_cast<const float*>(vpart), nchunk, grid, static_cast<float*>(dw1),
      static_cast<float*>(dw2), static_cast<float*>(dw3), static_cast<float*>(db1),
      static_cast<float*>(db2), static_cast<float*>(db3), static_cast<float*>(dsc),
      static_cast<float*>(dbi));
  return (int)cudaGetLastError();
}
