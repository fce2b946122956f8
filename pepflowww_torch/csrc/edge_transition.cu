// Fused EdgeTransition forward (with the optional pair-resident readout
// epilogue) for Hopper, sm_90a: K1 (READOUT=false) and K2 (READOUT=true).
//
// Replaces: pepflowww_tpu/models/pallas_edge.py:160 fused_edge_transition
// (body `_kernel` with quant_int8=False), both with readout=None and with
// readout=(kb,bb,kdz,bdz).
//
// Per pair (i, j) of a batch row, with the concat row x = [e | n_i | n_j]
// (e = edge[b,i,j,:], n = node_bias[b,:,:], 192 bf16):
//   h1 = relu(x.W1 + b1)                                  (192 wide)
//   h2 = relu(bf16(h1).W2 + b2)
//   o  = bf16(h2).W3 + x.W3 + b3                          (64 wide)
//   out = (LayerNorm(o) * scale + bias) * mask_i * mask_j  -> bf16
// and, with READOUT, from bf16(out) while it is still on chip:
//   b[b,h,i,j]  = out.kb  + bb   (h < n_b)
//   pz[b,d,i,j] = out.kdz + bdz  (d < n_pz)
// Products of bf16 operands accumulate in fp32; the LayerNorm statistics are
// fp32 (eps passed in, 1e-5). The first layer and the residual projection
// run on the concatenated row, as edge_transition_bwd_plain writes them: the
// same bf16 x bf16 terms as the JAX kernel's factorized form (e.W1e +
// n_i.W1i + n_j.W1j), summed in fp32 in another order.
//
// What bounds it on this card: the bf16 tensor cores. The least work is
// 67,072 MAC per pair and 32,768 per residue (the node products once per
// residue), 35.8 us at B=64, L=64 at 989 TFLOP/s, against ~304 bytes of HBM
// traffic per pair (~24 us). This kernel does the node products per pair
// (100,352 MAC per pair with the padded readout, ~53 us at peak) to need no
// pre-pass and no node-product scratch: one launch per call.
//
// Design: a persistent grid of one block per SM (at most), two consumer
// warpgroups per block, each walking its own 64-pair tiles of the flattened
// (b, i, j) rows, so any L runs and a tile may cross batch rows; the ragged
// last tile is zero-filled and its stores masked. All weights live in
// shared memory for the block's life, transposed to [out][in] (K-major) in
// the 128-byte swizzled layout the wgmma descriptors name (wgmma.cuh). Per
// tile, a warpgroup:
//   1. gathers C = [e | n_i | n_j] (64 x 192 bf16) itself with cp.async
//      16-byte copies into the swizzled layout, a warp's copy reading four
//      whole 128-byte rows; each row's (b*L+i, b*L+j) is computed once a
//      part, by the eight threads that copy it;
//   2. runs C.W1 (m64n192k16 x 12) and C.W3 (m64n64k16 x 12) from shared
//      memory, loading the pair masks of its rows meanwhile. C is then
//      free, and the NEXT tile's gather is issued into it: it lands while
//      this tile's remaining products run (each warpgroup's buffer is the
//      other's second stage);
//   3. adds b1, applies ReLU and packs h1 to bf16 pairs in registers: the
//      fp32 accumulator layout is the bf16 A-fragment layout, so h1 is the
//      A operand of h1.W2 (m64n192k16 x 12) straight from registers;
//   4. the same for h2, accumulated onto C.W3 by h2.W3 (m64n64k16 x 12);
//   5. adds b3 and takes the LayerNorm of each row across the four threads
//      that hold it (quad shuffles), applies scale, bias and the pair mask,
//      rounds to bf16 and stores out;
//   6. with READOUT, bf16(out) is again the A operand from registers of
//      out.[kb | kdz | 0] (m64n32k16 x 4); the readouts pass through each
//      warp's channel-major staging buffer, 16 channels at a time, so each
//      channel's 16 pairs of a warp leave as one whole 32-byte sector along
//      the contiguous (i, j), with no barrier beyond the warp.
// No accumulator passes through shared memory; h1, h2 and out never do.
//
// Shared memory (bytes): W1^T 73,728, W2^T 73,728, W3^T 24,576, Wr^T
// 4,096 (no padding: swizzled), two C tiles 49,152, readout staging 4,096,
// vectors 2,432: 231,808 of the 232,448 a block may use. Registers per
// thread (two warpgroups, so at most 255): the 64x192 fp32 accumulator (96)
// + C.W3's (32) + the bf16 A operand h (48) at the peak of layer 2.

#include <climits>

#include "wgmma.cuh"

namespace {

using namespace hopper;
typedef __nv_bfloat16 bf16;

constexpr int CZ = 64;     // pair channels in and out
constexpr int HID = 192;   // hidden width = CZ + 2 * 64 (the concat row)
constexpr int RO = 32;     // readout lanes (n_b + n_pz <= 32), zero-padded
constexpr int TM = 64;     // pair rows per tile: one warpgroup product

constexpr int N_WG = 2;                              // consumer warpgroups a block
constexpr int NTHREADS = 128 * N_WG;
constexpr int TILE_C = TM * HID * 2;                 // one C tile: 3 panels of 64 rows
constexpr int PANEL_C = TM * 128;
constexpr int RO_CH = 16;                            // readout channels staged at a time
constexpr int RO_WARP = RO_CH * 16;                  // a warp's staging: [16 ch][16 rows] bf16

constexpr int OFF_W1 = 0;                            // W1^T [3][192][128 B]
constexpr int OFF_W2 = OFF_W1 + HID * HID * 2;       // W2^T [3][192][128 B]
constexpr int OFF_W3 = OFF_W2 + HID * HID * 2;       // W3^T [3][64][128 B]
constexpr int OFF_WR = OFF_W3 + CZ * HID * 2;        // Wr^T [1][32][128 B]
constexpr int OFF_C = OFF_WR + RO * CZ * 2;          // C tiles [2][3][64][128 B]
constexpr int OFF_RO = OFF_C + N_WG * TILE_C;        // readout staging [8 warps][RO_WARP]
constexpr int OFF_V = OFF_RO + N_WG * 4 * RO_WARP * 2;     // b1 b2 b3 ln_s ln_b bro
constexpr int N_VEC = 2 * HID + 3 * CZ + RO;
constexpr int SMEM_BYTES = OFF_V + N_VEC * 4;
static_assert(OFF_W2 % 1024 == 0 && OFF_W3 % 1024 == 0 && OFF_WR % 1024 == 0 &&
                  OFF_C % 1024 == 0 && TILE_C % 1024 == 0,
              "swizzled panels start on 1024-byte boundaries");
static_assert(SMEM_BYTES <= 232448, "more shared memory than a block may use");

// N x K bf16, K-major in global ([n][k]), into swizzled panels at `dst`.
__device__ __forceinline__ void stage_kmajor(uint32_t dst, const bf16* __restrict__ src, int N,
                                             int K) {
  const int chunks = K / 8;
  for (int v = threadIdx.x; v < N * chunks; v += NTHREADS) {
    const int n = v / chunks, c = v % chunks;
    cp_async16(dst + (c >> 3) * (N * 128) + sw128_offset(n, c & 7), src + (size_t)n * K + c * 8,
               true);
  }
}

// The tile's concat rows C = [e | n_i | n_j] into the swizzled panels at
// `dst`. Thread wt (0..127 of the warpgroup) copies 16-byte chunk wt % 8 of
// rows wt / 8 + 16k (k = 0..3) of each of the three parts, so each copy of a
// warp reads four whole 128-byte rows. Rows past `total` are zero-filled.
__device__ __forceinline__ void gather(uint32_t dst, const bf16* __restrict__ edge,
                                       const bf16* __restrict__ node, int row0, int total, int L,
                                       int LL, int wt) {
  const int c = wt & 7;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int r = (wt >> 3) + 16 * k, row = row0 + r;
    const bool valid = row < total;
    int bi = 0, bj = 0;
    if (valid) {
      const int b = row / LL, rem = row - b * LL, i = rem / L;
      bi = b * L + i;
      bj = b * L + (rem - i * L);
    }
    const uint32_t d = dst + sw128_offset(r, c);
    cp_async16(d, edge + (size_t)(valid ? row : 0) * CZ + c * 8, valid);
    cp_async16(d + PANEL_C, node + (size_t)bi * CZ + c * 8, valid);
    cp_async16(d + 2 * PANEL_C, node + (size_t)bj * CZ + c * 8, valid);
  }
}

// (mask_i, mask_j) of flattened pair `row` (zeros past `total`).
__device__ __forceinline__ float2 pair_mask(const float* __restrict__ mask, int row, int total,
                                            int L, int LL) {
  if (row >= total) return make_float2(0.f, 0.f);
  const int b = row / LL, rem = row - b * LL, i = rem / L;
  return make_float2(mask[b * L + i], mask[b * L + (rem - i * L)]);
}

// Eight staged readout values of channel `cc` of `dst` (b or pz, `nch`
// channels), pairs row0 .. row0 + 7: one 16-byte store when they lie in one
// batch row and are aligned, else one store each.
__device__ __forceinline__ void store_readout(bf16* __restrict__ dst, int nch, int cc, uint4 v,
                                              int row0, int total, int LL) {
  if (row0 >= total) return;
  const int b = row0 / LL, p = row0 - b * LL;
  bf16* d = dst + ((size_t)b * nch + cc) * LL + p;
  if (row0 + 7 < total && p + 7 < LL && (reinterpret_cast<uintptr_t>(d) & 15) == 0) {
    *reinterpret_cast<uint4*>(d) = v;
    return;
  }
  const bf16* x = reinterpret_cast<const bf16*>(&v);
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int row = row0 + u;
    if (row < total) {
      const int bu = row / LL;
      dst[((size_t)bu * nch + cc) * LL + (row - bu * LL)] = x[u];
    }
  }
}

template <bool READOUT>
__global__ void __launch_bounds__(NTHREADS, 1)
edge_transition_kernel(const bf16* __restrict__ edge, const bf16* __restrict__ node,
                       const float* __restrict__ mask, const bf16* __restrict__ w1t,
                       const float* __restrict__ b1, const bf16* __restrict__ w2t,
                       const float* __restrict__ b2, const bf16* __restrict__ w3t,
                       const float* __restrict__ b3, const float* __restrict__ ln_s,
                       const float* __restrict__ ln_b, const bf16* __restrict__ wrt,
                       const float* __restrict__ bro, bf16* __restrict__ out,
                       bf16* __restrict__ b_out, bf16* __restrict__ pz_out, int L, int total,
                       int n_b, int n_pz, float eps) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  if (base & 1023) __trap();   // the swizzle is taken from the address bits
  float* b1_s = reinterpret_cast<float*>(smem + OFF_V);
  float* b2_s = b1_s + HID;
  float* b3_s = b2_s + HID;
  float* lns_s = b3_s + CZ;
  float* lnb_s = lns_s + CZ;
  float* bro_s = lnb_s + CZ;

  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127;
  const int warp = wt >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int LL = L * L;
  const int ntiles = (total + TM - 1) / TM;
  const int stride = gridDim.x * N_WG;
  const uint32_t c_s = base + OFF_C + wg * TILE_C;
  int tile = blockIdx.x * N_WG + wg;

  stage_kmajor(base + OFF_W1, w1t, HID, HID);
  stage_kmajor(base + OFF_W2, w2t, HID, HID);
  stage_kmajor(base + OFF_W3, w3t, CZ, HID);
  if (READOUT) stage_kmajor(base + OFF_WR, wrt, RO, CZ);
  for (int c = tid; c < HID; c += NTHREADS) { b1_s[c] = b1[c]; b2_s[c] = b2[c]; }
  for (int c = tid; c < CZ; c += NTHREADS) {
    b3_s[c] = b3[c];
    lns_s[c] = ln_s[c];
    lnb_s[c] = ln_b[c];
  }
  if (READOUT)
    for (int c = tid; c < RO; c += NTHREADS) bro_s[c] = bro[c];
  if (tile < ntiles) gather(c_s, edge, node, tile * TM, total, L, LL, wt);
  cp_async_commit();
  cp_async_wait_all();
  fence_proxy_async();
  __syncthreads();

  const int bar = 1 + wg;   // this warpgroup's named barrier
  for (; tile < ntiles; tile += stride) {
    const int row0 = tile * TM;
    cp_async_wait_all();
    fence_proxy_async();
    named_bar(bar, 128);

    // 1. acc = C.W1, o = C.W3, both from shared memory.
    float acc[96], o[32];
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 12; ++s)
      mma_ss_n192(acc, desc_sw128(c_s + (s >> 2) * PANEL_C + (s & 3) * 32),
                  desc_sw128(base + OFF_W1 + (s >> 2) * (HID * 128) + (s & 3) * 32), s > 0);
#pragma unroll
    for (int s = 0; s < 12; ++s)
      mma_ss_n64(o, desc_sw128(c_s + (s >> 2) * PANEL_C + (s & 3) * 32),
                 desc_sw128(base + OFF_W3 + (s >> 2) * (CZ * 128) + (s & 3) * 32), s > 0);
    wgmma_commit();
    // While they run: the masks of this thread's two rows (used by step 4).
    const int ra = row0 + 16 * warp + g, rb = ra + 8;
    const float2 ma = pair_mask(mask, ra, total, L, LL), mb = pair_mask(mask, rb, total, L, LL);
    wgmma_wait_all();
    fence_regs(acc);
    fence_regs(o);
    named_bar(bar, 128);   // every warp's products have read C: gather the next tile
    if (tile + stride < ntiles) gather(c_s, edge, node, (tile + stride) * TM, total, L, LL, wt);
    cp_async_commit();

    // 2. h = bf16(relu(acc + b1)) as A fragments; acc = h.W2.
    uint32_t h[48];
#pragma unroll
    for (int j = 0; j < 24; ++j) {
      const float2 bb = *reinterpret_cast<const float2*>(b1_s + 8 * j + 2 * q);
      h[2 * j] = pack_bf16_relu(acc[4 * j] + bb.x, acc[4 * j + 1] + bb.y);
      h[2 * j + 1] = pack_bf16_relu(acc[4 * j + 2] + bb.x, acc[4 * j + 3] + bb.y);
    }
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 12; ++s)
      mma_rs_n192(acc, &h[4 * s],
                  desc_sw128(base + OFF_W2 + (s >> 2) * (HID * 128) + (s & 3) * 32), s > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    fence_regs(h);

    // 3. h = bf16(relu(acc + b2)); o += h.W3.
#pragma unroll
    for (int j = 0; j < 24; ++j) {
      const float2 bb = *reinterpret_cast<const float2*>(b2_s + 8 * j + 2 * q);
      h[2 * j] = pack_bf16_relu(acc[4 * j] + bb.x, acc[4 * j + 1] + bb.y);
      h[2 * j + 1] = pack_bf16_relu(acc[4 * j + 2] + bb.x, acc[4 * j + 3] + bb.y);
    }
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 12; ++s)
      mma_rs_n64(o, &h[4 * s], desc_sw128(base + OFF_W3 + (s >> 2) * (CZ * 128) + (s & 3) * 32),
                 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    fence_regs(h);

    // 4. + b3, LayerNorm over each row's 64 lanes (16 here, the rest in the
    // quad), affine, pair mask, bf16; y holds bf16(out) as A fragments.
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 bb = *reinterpret_cast<const float2*>(b3_s + 8 * j + 2 * q);
      o[4 * j] += bb.x;
      o[4 * j + 1] += bb.y;
      o[4 * j + 2] += bb.x;
      o[4 * j + 3] += bb.y;
      sa += o[4 * j] + o[4 * j + 1];
      sb += o[4 * j + 2] + o[4 * j + 3];
    }
    sa += __shfl_xor_sync(0xffffffffu, sa, 1);
    sa += __shfl_xor_sync(0xffffffffu, sa, 2);
    sb += __shfl_xor_sync(0xffffffffu, sb, 1);
    sb += __shfl_xor_sync(0xffffffffu, sb, 2);
    const float mua = sa * (1.f / CZ), mub = sb * (1.f / CZ);
    float qa = 0.f, qb = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      o[4 * j] -= mua;
      o[4 * j + 1] -= mua;
      o[4 * j + 2] -= mub;
      o[4 * j + 3] -= mub;
      qa += o[4 * j] * o[4 * j] + o[4 * j + 1] * o[4 * j + 1];
      qb += o[4 * j + 2] * o[4 * j + 2] + o[4 * j + 3] * o[4 * j + 3];
    }
    qa += __shfl_xor_sync(0xffffffffu, qa, 1);
    qa += __shfl_xor_sync(0xffffffffu, qa, 2);
    qb += __shfl_xor_sync(0xffffffffu, qb, 1);
    qb += __shfl_xor_sync(0xffffffffu, qb, 2);
    const float rsa = rsqrtf(qa * (1.f / CZ) + eps), rsb = rsqrtf(qb * (1.f / CZ) + eps);
    const float pma = ma.x * ma.y, pmb = mb.x * mb.y;
    uint32_t y[16];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 8 * j + 2 * q;
      const float2 ls = *reinterpret_cast<const float2*>(lns_s + c);
      const float2 lb = *reinterpret_cast<const float2*>(lnb_s + c);
      y[2 * j] = pack_bf16((o[4 * j] * rsa * ls.x + lb.x) * pma,
                           (o[4 * j + 1] * rsa * ls.y + lb.y) * pma);
      y[2 * j + 1] = pack_bf16((o[4 * j + 2] * rsb * ls.x + lb.x) * pmb,
                               (o[4 * j + 3] * rsb * ls.y + lb.y) * pmb);
      if (ra < total) *reinterpret_cast<uint32_t*>(out + (size_t)ra * CZ + c) = y[2 * j];
      if (rb < total) *reinterpret_cast<uint32_t*>(out + (size_t)rb * CZ + c) = y[2 * j + 1];
    }

    if (READOUT) {
      // 5. r = bf16(out).Wr, y being the A operand (m64n32k16 x 4).
      float r[16];
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < CZ / 16; ++s)
        mma_rs_n32(r, &y[4 * s], desc_sw128(base + OFF_WR + s * 32), s > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(r);
      fence_regs(y);
      // + bro, bf16, out through this warp's staging [16 channels][16 rows],
      // 16 channels at a time: each lane stores 8 consecutive pairs of one
      // channel, so a channel's 16 pairs leave as one whole 32-byte sector.
      bf16* st = reinterpret_cast<bf16*>(smem + OFF_RO) + (wg * 4 + warp) * RO_WARP;
      const int nro = n_b + n_pz;
#pragma unroll
      for (int part = 0; part < RO / RO_CH; ++part) {
        if (part * RO_CH >= nro) break;
#pragma unroll
        for (int jj = 0; jj < RO_CH / 8; ++jj) {
          const int j = part * (RO_CH / 8) + jj, cl = 8 * jj + 2 * q;
          const float2 bo = *reinterpret_cast<const float2*>(bro_s + 8 * j + 2 * q);
          st[cl * 16 + g] = __float2bfloat16(r[4 * j] + bo.x);
          st[(cl + 1) * 16 + g] = __float2bfloat16(r[4 * j + 1] + bo.y);
          st[cl * 16 + g + 8] = __float2bfloat16(r[4 * j + 2] + bo.x);
          st[(cl + 1) * 16 + g + 8] = __float2bfloat16(r[4 * j + 3] + bo.y);
        }
        __syncwarp();
        const int cl = lane >> 1, h8 = (lane & 1) * 8, c = part * RO_CH + cl;
        if (c < nro) {
          const uint4 v = *reinterpret_cast<const uint4*>(st + cl * 16 + h8);
          const int p0 = row0 + 16 * warp + h8;
          if (c < n_b) store_readout(b_out, n_b, c, v, p0, total, LL);
          else store_readout(pz_out, n_pz, c - n_b, v, p0, total, LL);
        }
        __syncwarp();
      }
    }
  }
}

// Per device, set on its first launch: the SM count, and whether each
// variant (readout off, on) has its dynamic shared-memory opt-in. Racing
// first calls from two threads write the same values.
constexpr int MAX_DEVICES = 64;
int g_sms[MAX_DEVICES];
bool g_smem_opt_in[2][MAX_DEVICES];

}  // namespace

// Dynamic shared memory of a block, bytes (both variants).
extern "C" int edge_transition_smem_bytes() { return SMEM_BYTES; }

// Launches the fused kernel on `stream` (one launch); returns its
// cudaError_t (0 on success). w1t, w2t, w3t, wrt are the bf16 weights
// transposed to [out][in]; wrt, bro, b_out and pz_out are null without the
// readout.
extern "C" int edge_transition_forward(
    const void* edge, const void* node, const void* mask, const void* w1t, const void* b1,
    const void* w2t, const void* b2, const void* w3t, const void* b3, const void* ln_s,
    const void* ln_b, const void* wrt, const void* bro, void* out, void* b_out, void* pz_out,
    int B, int L, int n_b, int n_pz, float eps, void* stream) {
  const long long total = (long long)B * L * L;
  if (total == 0) return 0;
  if (total > INT_MAX) return (int)cudaErrorInvalidValue;   // pair rows are 32-bit
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  const int variant = b_out != nullptr;
  auto kernel = variant ? edge_transition_kernel<true> : edge_transition_kernel<false>;
  if (!g_smem_opt_in[variant][dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    g_smem_opt_in[variant][dev] = true;
  }
  if (g_sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&g_sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  const long long pairs_of_tiles = ((total + TM - 1) / TM + N_WG - 1) / N_WG;
  const int grid = (int)(pairs_of_tiles < g_sms[dev] ? pairs_of_tiles : g_sms[dev]);
  kernel<<<grid, NTHREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(edge), static_cast<const bf16*>(node),
      static_cast<const float*>(mask), static_cast<const bf16*>(w1t),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2t),
      static_cast<const float*>(b2), static_cast<const bf16*>(w3t),
      static_cast<const float*>(b3), static_cast<const float*>(ln_s),
      static_cast<const float*>(ln_b), static_cast<const bf16*>(wrt),
      static_cast<const float*>(bro), static_cast<bf16*>(out), static_cast<bf16*>(b_out),
      static_cast<bf16*>(pz_out), L, (int)total, n_b, n_pz, eps);
  return (int)cudaGetLastError();
}
