// Fused EdgeTransition forward (with the optional pair-resident readout
// epilogue) for Hopper, sm_90a: K1 (READOUT=false) and K2 (READOUT=true).
//
// Replaces: pepflowww_tpu/models/pallas_edge.py:160 fused_edge_transition
// (body `_kernel` with quant_int8=False), both with readout=None and with
// readout=(kb,bb,kdz,bdz).
//
// Per pair (i, j) of a batch row, with the concat row x = [e | n_i | n_j]:
//   h1 = relu(x.W1 + b1)                                  (192 wide)
//   h2 = relu(bf16(h1).W2 + b2)
//   o  = bf16(h2).W3 + x.W3 + b3                          (64 wide)
// then LayerNorm, the pair mask and, with READOUT, the next block's b and
// pz from bf16(out) (edge_transition.cuh, which holds the tile loop this
// kernel shares with the int8 kernel K6).
//
// What bounds it on this card: the bf16 tensor cores. The least work is
// 67,072 MAC per pair and 32,768 per residue (the node products once per
// residue), 35.8 us at B=64, L=64 at 989 TFLOP/s, against ~304 bytes of HBM
// traffic per pair (~24 us). This kernel does the node products per pair
// (100,352 MAC per pair with the padded readout, ~53 us at peak) to need no
// pre-pass and no node-product scratch: one launch per call.
//
// Design: edge_transition.cuh. The hidden layers (hidden_bf16): bias and
// ReLU on packed bf16 pairs in registers, which are the A operand of h1.W2
// (m64n192k16 x 12) straight from registers, and the same for h2.W3
// (m64n64k16 x 12), accumulated onto C.W3.
//
// Shared memory (bytes): W1^T 73,728, W2^T 73,728, W3^T 24,576, Wr^T
// 4,096 (no padding: swizzled), two C tiles 49,152, readout staging 4,096,
// vectors 2,432: 231,808 of the 232,448 a block may use. Registers per
// thread (two warpgroups, so at most 255): the 64x192 fp32 accumulator (96)
// + C.W3's (32) + the bf16 A operand h (48) at the peak of layer 2.

#include "edge_transition.cuh"
#include "wide_gemm.cuh"

namespace {

using namespace edge;

template <bool READOUT>
__global__ void __launch_bounds__(NTHREADS, 1)
edge_transition_kernel(const __grid_constant__ Args a) {
  tile_loop<READOUT, false>(a);
}

}  // namespace

// Dynamic shared memory of a block, bytes (both variants).
extern "C" int edge_transition_smem_bytes() { return Smem<false>::BYTES; }

// Launches the fused kernel on `stream` (one launch); returns its
// cudaError_t (0 on success). w1t, w2t, w3t, wrt are the bf16 weights
// transposed to [out][in]; wrt, bro, b_out and pz_out are null without the
// readout.
extern "C" int edge_transition_forward(
    const void* edge, const void* node, const void* mask, const void* w1t, const void* b1,
    const void* w2t, const void* b2, const void* w3t, const void* b3, const void* ln_s,
    const void* ln_b, const void* wrt, const void* bro, void* out, void* b_out, void* pz_out,
    int B, int L, int n_b, int n_pz, float eps, void* stream) {
  Args a{static_cast<const bf16*>(edge), static_cast<const bf16*>(node),
         static_cast<const float*>(mask), static_cast<const bf16*>(w1t),
         static_cast<const float*>(b1), w2t, nullptr, static_cast<const float*>(b2),
         static_cast<const bf16*>(w3t), nullptr, nullptr, static_cast<const float*>(b3),
         static_cast<const float*>(ln_s), static_cast<const float*>(ln_b),
         static_cast<const bf16*>(wrt), static_cast<const float*>(bro), static_cast<bf16*>(out),
         static_cast<bf16*>(b_out), static_cast<bf16*>(pz_out), L, 0, n_b, n_pz, eps};
  const int readout = b_out != nullptr;
  return launch(readout ? edge_transition_kernel<true> : edge_transition_kernel<false>, readout,
                a, B, L, Smem<false>::BYTES, stream);
}

// ---------------------------------------------------------------- 2x, 4x, 8x
// K1 and K2 at c_z = 128, 256, 512 (hidden 3 c_z, readout lanes up to
// 8 + c_z / 4): the same function as the kernel above, as six launches of
// csrc/wide_gemm.cuh's tiled GEMM and one row kernel, since the weights no
// longer fit a block (W2 alone is 295 KB at 128, 4.7 MB at 512):
//   Y  = node.[W1i | W1j | W3i | W3j]                    (residues, fp32)
//   h1 = bf16(relu(e.W1e + Y1_i + Y1_j + b1))            (pairs, scratch)
//   h2 = bf16(relu(h1.W2 + b2))
//   o  = [h2 | e].[W3 ; W3e] + Y3_i + Y3_j + b3          (fp32 scratch)
//   out = bf16(LayerNorm(o) s_i s_j)                      (wide_ln_fwd_kernel)
//   K2: [b | pz] = bf16(out.Wr + br), written transposed (B, n, L, L)
// The node products run once a residue, as the bound counts them. What
// bounds it: the tensor cores (bounds.py: 140 us at c_z 128, B=64, L=64);
// the hidden rows' round trips through device memory (4 x 2 x 3 c_z bytes
// a pair) are the price of the simple design, left to a later change.

namespace wide {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// One warp a pair row: LayerNorm of o (float32 statistics), the pair mask,
// bf16.
template <int NQ>
__global__ void __launch_bounds__(256)
wide_ln_fwd_kernel(const float* __restrict__ o, const float* __restrict__ ln_s,
                   const float* __restrict__ ln_b, const float* __restrict__ mask,
                   bf16* __restrict__ out, int M, int L, float eps) {
  constexpr int CZ = NQ * 32;
  const int r = (blockIdx.x * blockDim.x + threadIdx.x) >> 5, lane = threadIdx.x & 31;
  if (r >= M) return;
  const float* row = o + (long long)r * CZ;
  float v[NQ], s = 0.f;
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    v[q] = row[lane + 32 * q];
    s += v[q];
  }
  const float mu = warp_sum(s) / CZ;
  float ss = 0.f;
#pragma unroll
  for (int q = 0; q < NQ; ++q) ss += (v[q] - mu) * (v[q] - mu);
  const float inv = rsqrtf(warp_sum(ss) / CZ + eps);
  const float m = mask[src_row(NODE_I, r, L)] * mask[src_row(NODE_J, r, L)];
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const int c = lane + 32 * q;
    out[(long long)r * CZ + c] = __float2bfloat16(((v[q] - mu) * inv * ln_s[c] + ln_b[c]) * m);
  }
}

static int edge_forward(const void* edge, const void* node, const void* mask, const void* wn,
                        const void* w1t, const void* b1, const void* w2t, const void* b2,
                        const void* w3t, const void* b3, const void* ln_s, const void* ln_b,
                        const void* wrt, const void* bro, void* y, void* h1, void* h2, void* o,
                        void* out, void* b_out, void* pz_out, int B, int L, int cz, int n_b,
                        int n_pz, int ro_pad, float eps, cudaStream_t st) {
  const long long total = (long long)B * L * L;
  if (total > INT_MAX) return (int)cudaErrorInvalidValue;   // pair rows are 32-bit
  if (cz != 128 && cz != 256 && cz != 512) return (int)cudaErrorInvalidValue;
  if (total == 0) return 0;
  const int M = (int)total, hid = 3 * cz, ny = 2 * hid + 2 * cz;
  float* Y = static_cast<float*>(y);
  Epi e{};
  e.f32 = Y;
  e.ld_f32 = ny;
  WIDE_TRY((gemm<128, 128, false, F32>(opd(seg(node, cz)), opd(seg(wn, cz)), B * L, ny, cz, 0, L,
                                       e, st)));
  e = Epi{};
  e.out = static_cast<bf16*>(h1);
  e.ld_out = hid;
  e.bias = static_cast<const float*>(b1);
  e.yi = Y;
  e.yj = Y + hid;
  e.ld_y = ny;
  WIDE_TRY((gemm<128, 128, false, RELU>(opd(seg(edge, cz)), opd(seg(w1t, hid)), M, hid, cz, 0, L,
                                        e, st)));
  e = Epi{};
  e.out = static_cast<bf16*>(h2);
  e.ld_out = hid;
  e.bias = static_cast<const float*>(b2);
  WIDE_TRY((gemm<128, 128, false, RELU>(opd(seg(h1, hid)), opd(seg(w2t, hid)), M, hid, hid, 0, L,
                                        e, st)));
  e = Epi{};
  e.f32 = static_cast<float*>(o);
  e.ld_f32 = cz;
  e.bias = static_cast<const float*>(b3);
  e.yi = Y + 2 * hid;
  e.yj = Y + 2 * hid + cz;
  e.ld_y = ny;
  WIDE_TRY((gemm<128, 128, false, F32>(opd(seg(h2, hid), seg(edge, cz, hid)),
                                       opd(seg(w3t, hid), seg(w3t, hid, hid)), M, cz, hid + cz,
                                       0, L, e, st)));
  const int blocks = (int)((total * 32 + 255) / 256);
  const float* of = static_cast<const float*>(o);
  const float* s = static_cast<const float*>(ln_s);
  const float* bb = static_cast<const float*>(ln_b);
  const float* mk = static_cast<const float*>(mask);
  bf16* ob = static_cast<bf16*>(out);
  if (cz == 128) wide_ln_fwd_kernel<4><<<blocks, 256, 0, st>>>(of, s, bb, mk, ob, M, L, eps);
  else if (cz == 256) wide_ln_fwd_kernel<8><<<blocks, 256, 0, st>>>(of, s, bb, mk, ob, M, L, eps);
  else wide_ln_fwd_kernel<16><<<blocks, 256, 0, st>>>(of, s, bb, mk, ob, M, L, eps);
  WIDE_TRY(launched());
  if (b_out == nullptr) return 0;
  e = Epi{};
  e.bias = static_cast<const float*>(bro);
  e.b_out = static_cast<bf16*>(b_out);
  e.pz_out = static_cast<bf16*>(pz_out);
  e.n_b = n_b;
  e.n_pz = n_pz;
  return gemm<128, 64, false, READOUT>(opd(seg(out, cz)), opd(seg(wrt, cz)), M, ro_pad, cz, 0, L,
                                       e, st);
}

}  // namespace wide

// Device launches of one call of edge_transition_wide_forward: 6 with the
// readout (K2), 5 without (K1).
extern "C" int edge_transition_wide_kernels_per_call(int readout) { return readout ? 6 : 5; }

// K1/K2 at c_z = cz in {128, 256, 512}: wn [2 hid + 2 cz][cz] are the node
// rows of k1 and k3 transposed ([W1i | W1j | W3i | W3j]^T, bf16), w1t
// [hid][hid], w2t [hid][hid], w3t [cz][hid] as for the 1x kernel; wrt
// [ro_pad][cz] and bro [ro_pad] the readout padded with zeros to a multiple
// of 64 lanes (null without it). Scratch: y [B L][2 hid + 2 cz] f32, h1 and
// h2 [B L L][hid] bf16, o [B L L][cz] f32. Returns the first nonzero
// cudaError_t of its launches.
extern "C" int edge_transition_wide_forward(
    const void* edge, const void* node, const void* mask, const void* wn, const void* w1t,
    const void* b1, const void* w2t, const void* b2, const void* w3t, const void* b3,
    const void* ln_s, const void* ln_b, const void* wrt, const void* bro, void* y, void* h1,
    void* h2, void* o, void* out, void* b_out, void* pz_out, int B, int L, int cz, int n_b,
    int n_pz, int ro_pad, float eps, void* stream) {
  return wide::edge_forward(edge, node, mask, wn, w1t, b1, w2t, b2, w3t, b3, ln_s, ln_b, wrt, bro,
                            y, h1, h2, o, out, b_out, pz_out, B, L, cz, n_b, n_pz, ro_pad, eps,
                            static_cast<cudaStream_t>(stream));
}

// Kernels launched on the wide paths since the library was loaded.
extern "C" int edge_transition_wide_launches() { return wide::g_launches.load(); }
