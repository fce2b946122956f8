// The gaussian rows of the distance block at the JAX package's 2x, 4x and
// 8x widths (F = 128, 256, 512), for Hopper, sm_90a: K3's wide path
// (distance_embed.cu) and K5's (distance_embed_bwd.cu), beside the tiled
// GEMMs of wide_gemm.cuh. The 1x kernels keep distance_tile.cuh.
//
// At F >= 128, K1 [240][F] (246 KB at 512) and K2 [F][F] (524 KB) no longer
// fit a block next to a pair tile, so the x rows are built once into a bf16
// scratch [B L L][256] (225 atom pairs, zeros to 256, the depth of the
// GEMM's K tiles) and the MLP runs as GEMMs that stream the weights. The
// coefficients are softplus(table), computed once an entry a call
// (wide_softplus_kernel) and read from L2 (484 x 225 fp32, 436 KB). One
// block a residue i walks its row's residues j in order; thread a builds
// column a of each pair row, so a row's 512 bytes are one coalesced store.
//
// The table gradient (K5): dcoef[p][a] = dx[p][a] m_i m_j e (-d2)
// sigmoid(coef) goes to table row aa_i 22 + aa_j. wide_dcoef_kernel, one
// block a residue i, adds its pairs into a 22 x 225 slab by aa_j, j in
// order, and writes the slab (the residue's partial of the 22 rows of
// aa_i); wide_table_kernel adds, for each token t and chunk of residues in
// order, the slabs of the residues whose token is t; the chunks' partials
// are then added in a fixed order (wide_reduce_kernel). No atomics: two calls
// give the same bits.

#pragma once

#include "wide_gemm.cuh"

namespace wide {

constexpr int ATOMS = 15;
constexpr int APAIRS = ATOMS * ATOMS;   // 225
constexpr int XW = 256;                 // x row width: APAIRS padded to 8 K tiles
constexpr int NTOK = 22;
constexpr int NTAB = NTOK * NTOK;

__device__ __forceinline__ int tok(int v) {   // out-of-range tokens would index past the table
  return min(max(v, 0), NTOK - 1);
}

// sp = softplus(table), PyTorch's (threshold 20).
__global__ void __launch_bounds__(256)
wide_softplus_kernel(const float* __restrict__ table, float* __restrict__ sp, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float x = table[i];
  sp[i] = x > 20.f ? x : log1pf(expf(x));
}

// x[(b L + i) L + j][a] = bf16(exp(-sp[aa_i 22 + aa_j][a] d2) (m_i[a / 15]
// m_j[a % 15])), d2 = |pos_i[a / 15] - pos_j[a % 15]|^2 in fp32; zeros for
// a >= 225. Block n = b L + i, 256 threads.
__global__ void __launch_bounds__(XW)
wide_dist_x_kernel(const float* __restrict__ pos, const float* __restrict__ amask,
                   const int* __restrict__ aa, const float* __restrict__ sp,
                   bf16* __restrict__ x, int L) {
  const int n = blockIdx.x, a = threadIdx.x, b = n / L;
  const bool live = a < APAIRS;
  const int ai = live ? a / ATOMS : 0, aj = live ? a % ATOMS : 0;
  const float* pi = pos + ((long long)n * ATOMS + ai) * 3;
  const float p0 = pi[0], p1 = pi[1], p2 = pi[2], mi = amask[(long long)n * ATOMS + ai];
  const float* spr = sp + tok(aa[n]) * NTOK * APAIRS + (live ? a : 0);
  for (int j = 0; j < L; ++j) {
    const long long nj = (long long)b * L + j;
    float v = 0.f;
    if (live) {
      const float* pj = pos + (nj * ATOMS + aj) * 3;
      const float d0 = p0 - pj[0], d1 = p1 - pj[1], d2 = p2 - pj[2];
      const float dd = d0 * d0 + d1 * d1 + d2 * d2;
      v = expf(-spr[tok(aa[nj]) * APAIRS] * dd) * (mi * amask[nj * ATOMS + aj]);
    }
    x[((long long)n * L + j) * XW + a] = __float2bfloat16(v);
  }
}

static inline int dist_x(const void* pos, const void* amask, const void* aa, const void* table,
                         void* sp, void* x, int B, int L, cudaStream_t st) {
  wide_softplus_kernel<<<(NTAB * APAIRS + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(table), static_cast<float*>(sp), NTAB * APAIRS);
  WIDE_TRY(launched());
  wide_dist_x_kernel<<<B * L, XW, 0, st>>>(static_cast<const float*>(pos),
                                           static_cast<const float*>(amask),
                                           static_cast<const int*>(aa),
                                           static_cast<const float*>(sp), static_cast<bf16*>(x), L);
  return launched();
}

}  // namespace wide
