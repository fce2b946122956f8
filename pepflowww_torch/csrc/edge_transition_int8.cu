// Fused EdgeTransition forward with int8 hidden-width products (the int8
// serving profile), with the optional pair-resident readout epilogue, for
// Hopper, sm_90a: K6, readout off and on.
//
// Replaces: pepflowww_tpu/models/pallas_edge.py::fused_edge_transition with
// quant_int8=True, int8_w3=True (body `_kernel`, `_quant_rows`; the weights
// quantized by `_quant_cols`), both with readout=None and with
// readout=(kb,bb,kdz,bdz).
//
// Per pair (i, j) of a batch row, with the concat row x = [e | n_i | n_j]:
//   h1 = relu(x.W1 + b1)                              (fp32, 192 wide)
//   q1, s1 = quant_rows(h1)                           (int8, amax/127)
//   h2 = relu(float(q1.W2q) * s1 * w2s + b2)          (int32 accumulation)
//   q2, s2 = quant_rows(h2)
//   o  = float(q2.W3q) * s2 * w3s + x.W3 + b3
// then LayerNorm, the pair mask and, with READOUT, the next block's b and
// pz from bf16(out), as the bf16 kernel does: the tile loop, the gather,
// C.W1 and C.W3, the LayerNorm and the readout are edge_transition.cuh's,
// shared with K1/K2. quant_rows: amax over the row's 192 lanes, inv = amax
// > 0 ? 127/amax : 0 (an IEEE division: this file is built without fast
// math), q = round-half-even(h * inv), scale amax/127. W2q, w2s and W3q,
// w3s are the per-output-column int8 quantization of the fp32 k2 and k3
// (made once per set of weights by the wrapper, transposed to [out][in],
// their K axis permuted to the register fragments' order); W1 and W3 are
// their bf16 casts. Products of bf16 operands accumulate in fp32, LayerNorm
// statistics are fp32 (eps 1e-5).
//
// What bounds it on this card: the bytes (edge in, out and the readouts out,
// ~80 MB at B=64, L=64: ~24 us at 3.35 TB/s). Its tensor-core work in this
// concatenated form, 51,200 bf16 MAC a pair (C.W1, C.W3, the padded
// readout; ~27 us at 989 TFLOP/s) and 49,152 int8 MAC (~13 us at 1,979
// TOP/s), runs one after the other on the same units.
//
// Design: edge_transition.cuh; the hidden layers are hidden_int8. h1 stays
// fp32 in the m64n192 accumulator, is quantized in registers (a row's amax
// over its quad by two shuffles) and packed as it lies into the int8 A
// fragments of q1.W2q (m64n192k32 x 6, int32 accumulator) and, the same way,
// q2.W3q (m64n64k32 x 6): no activation passes through shared memory, no
// block barrier is needed. The int8 weights, 192 bytes a row, take two
// 128-byte swizzled panels each, the second half filled.
//
// Shared memory (bytes): W1^T 73,728, W3^T 24,576, W2q^T 49,152, W3q^T
// 16,384, Wr^T 4,096, two C tiles 49,152, readout staging 4,096, vectors
// 3,456: 224,640 of the 232,448 a block may use. Registers per thread at
// the peak of layer 2: the int32 m64n192 accumulator (96) + C.W3's (32) +
// q1's fragments (24).

#include "edge_transition.cuh"
#include "wide_gemm.cuh"

namespace {

using namespace edge;

template <bool READOUT>
__global__ void __launch_bounds__(NTHREADS, 1)
edge_int8_kernel(const __grid_constant__ Args a) {
  tile_loop<READOUT, true>(a);
}

}  // namespace

// Dynamic shared memory of a block, bytes (both variants).
extern "C" int edge_transition_int8_smem_bytes() { return Smem<true>::BYTES; }

// Launches the fused kernel on `stream` (one launch); returns its
// cudaError_t (0 on success). w1t, w3t: bf16 k1, k3 transposed to
// [out][in], (192 x 192), (64 x 192); w2qt, w3qt: int8 k2, k3 quantized per
// output column, transposed, their K axis permuted within each 32-column
// block (cuda_edge.INT8_K_PERM), (192 x 192), (64 x 192), with their column
// scales w2s, w3s; wrt (32 x 64), bro, b_out and pz_out are null without the
// readout.
extern "C" int edge_transition_int8_forward(
    const void* edge, const void* node, const void* mask, const void* w1t, const void* b1,
    const void* w2qt, const void* w2s, const void* b2, const void* w3t, const void* w3qt,
    const void* w3s, const void* b3, const void* ln_s, const void* ln_b, const void* wrt,
    const void* bro, void* out, void* b_out, void* pz_out, int B, int L, int n_b, int n_pz,
    float eps, void* stream) {
  Args a{static_cast<const bf16*>(edge), static_cast<const bf16*>(node),
         static_cast<const float*>(mask), static_cast<const bf16*>(w1t),
         static_cast<const float*>(b1), w2qt, static_cast<const float*>(w2s),
         static_cast<const float*>(b2), static_cast<const bf16*>(w3t),
         static_cast<const int8_t*>(w3qt), static_cast<const float*>(w3s),
         static_cast<const float*>(b3), static_cast<const float*>(ln_s),
         static_cast<const float*>(ln_b), static_cast<const bf16*>(wrt),
         static_cast<const float*>(bro), static_cast<bf16*>(out), static_cast<bf16*>(b_out),
         static_cast<bf16*>(pz_out), L, 0, n_b, n_pz, eps};
  const int readout = b_out != nullptr;
  return launch(readout ? edge_int8_kernel<true> : edge_int8_kernel<false>, readout, a, B, L,
                Smem<true>::BYTES, stream);
}

// ---------------------------------------------------------------- 2x, 4x, 8x
// K6 at c_z = 128, 256, 512 (hidden 3 c_z = 384, 768, 1536; readout lanes up
// to 8 + c_z / 4): the same function as the kernel above, at the JAX
// kernel's rounding points, as launches of csrc/wide_gemm.cuh's tiled GEMM
// and two row kernels, since neither the weights nor a tile's hidden rows
// fit a block from 2x on (W2q alone is 147 KB at 128, 2.4 MB at 512):
//   Y  = node.[W1i | W1j | W3i | W3j]                (residues, fp32)
//   h1 = relu(e.W1e + Y1_i + Y1_j + b1)               (pairs, fp32 scratch)
//   q1, s1 = quant_rows(h1)                            (wide_quant_kernel)
//   h2 = relu(float(q1.W2q) s1 w2s + b2)               (int8 GEMM, fp32 scratch)
//   q2, s2 = quant_rows(h2)
//   o  = float(q2.W3q) s2 w3s                           (int8 GEMM, fp32 scratch)
//   o  = ((o + e.W3e) + Y3_i + Y3_j) + b3               (bf16 GEMM onto o)
//   out = bf16(LayerNorm(o) s_i s_j)                    (wide_ln_fwd_kernel)
//   readout: [b | pz] = bf16(out.Wr + br), transposed (B, n, L, L)
// A row's quantization needs its amax over all 3 c_z columns, which the
// GEMM's 128-column tiles split across blocks: so h1 and h2 go to device
// memory in fp32 and a row kernel (one warp a row) takes the amax, the scale
// 127/amax (an IEEE division: no fast math) and the round-half-even int8
// values. The int32 sums reach 1536 x 127 x 127 < 2^31 at 8x; their
// conversion to fp32 rounds to nearest, as the JAX kernel's astype does.
// What bounds it: the tensor cores (bounds.edge_int8_bound_ms: 90.6 us at
// c_z 128, B=64, L=64 on the int8 and bf16 units); the fp32 hidden rows'
// round trips (2 x 2 x 4 x 3 c_z bytes a pair) are the price of the simple
// design, left to a later change.

namespace wide {

// One warp a row of x [M][32 NQ] fp32: amax, inv = amax > 0 ? 127 / amax :
// 0, q = round-half-even(x inv) as int8, scale amax / 127.
template <int NQ>
__global__ void __launch_bounds__(256)
wide_quant_kernel(const float* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ scale,
                  int M) {
  constexpr int N = NQ * 32;
  const int r = (blockIdx.x * blockDim.x + threadIdx.x) >> 5, lane = threadIdx.x & 31;
  if (r >= M) return;
  const float* row = x + (long long)r * N;
  float v[NQ], amax = 0.f;
#pragma unroll
  for (int k = 0; k < NQ; ++k) {
    v[k] = row[lane + 32 * k];
    amax = fmaxf(amax, fabsf(v[k]));
  }
#pragma unroll
  for (int m = 16; m; m >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, m));
  const float inv = amax > 0.f ? 127.f / amax : 0.f;
  int8_t* out = q + (long long)r * N;
#pragma unroll
  for (int k = 0; k < NQ; ++k) out[lane + 32 * k] = (int8_t)__float2int_rn(v[k] * inv);
  if (lane == 0) scale[r] = amax / 127.f;
}

static int quant(const float* x, int8_t* q, float* scale, int M, int n, cudaStream_t st) {
  const int blocks = (int)(((long long)M * 32 + 255) / 256);
  if (n == 384) wide_quant_kernel<12><<<blocks, 256, 0, st>>>(x, q, scale, M);
  else if (n == 768) wide_quant_kernel<24><<<blocks, 256, 0, st>>>(x, q, scale, M);
  else wide_quant_kernel<48><<<blocks, 256, 0, st>>>(x, q, scale, M);
  return launched();
}

static int edge_int8_forward(const void* edge, const void* node, const void* mask,
                             const void* wn, const void* w1t, const void* b1, const void* w2qt,
                             const void* w2s, const void* b2, const void* w3t, const void* w3qt,
                             const void* w3s, const void* b3, const void* ln_s,
                             const void* ln_b, const void* wrt, const void* bro, void* y,
                             void* h, void* q, void* rs, void* o, void* out, void* b_out,
                             void* pz_out, int B, int L, int cz, int n_b, int n_pz, int ro_pad,
                             float eps, cudaStream_t st) {
  const long long total = (long long)B * L * L;
  if (total > INT_MAX) return (int)cudaErrorInvalidValue;   // pair rows are 32-bit
  if (cz != 128 && cz != 256 && cz != 512) return (int)cudaErrorInvalidValue;
  if (total == 0) return 0;
  const int M = (int)total, hid = 3 * cz, ny = 2 * hid + 2 * cz;
  float* Y = static_cast<float*>(y);
  float* hf = static_cast<float*>(h);
  float* of = static_cast<float*>(o);
  int8_t* qi = static_cast<int8_t*>(q);
  float* s = static_cast<float*>(rs);
  Epi e{};
  e.f32 = Y;
  e.ld_f32 = ny;
  WIDE_TRY((gemm<128, 128, false, F32>(opd(seg(node, cz)), opd(seg(wn, cz)), B * L, ny, cz, 0, L,
                                       e, st)));
  e = Epi{};
  e.f32 = hf;
  e.ld_f32 = hid;
  e.bias = static_cast<const float*>(b1);
  e.yi = Y;
  e.yj = Y + hid;
  e.ld_y = ny;
  WIDE_TRY((gemm<128, 128, false, F32_RELU>(opd(seg(edge, cz)), opd(seg(w1t, hid)), M, hid, cz, 0,
                                            L, e, st)));
  WIDE_TRY(quant(hf, qi, s, M, hid, st));
  // The int8 operands as pairs of bytes: rows of hid / 2 pairs, K = hid / 2.
  e = Epi{};
  e.f32 = hf;
  e.ld_f32 = hid;
  e.bias = static_cast<const float*>(b2);
  e.rscale = s;
  e.cscale = static_cast<const float*>(w2s);
  WIDE_TRY((gemm<128, 128, false, DEQ_RELU>(opd(seg(qi, hid / 2)), opd(seg(w2qt, hid / 2)), M, hid,
                                            hid / 2, 0, L, e, st)));
  WIDE_TRY(quant(hf, qi, s, M, hid, st));
  e = Epi{};
  e.f32 = of;
  e.ld_f32 = cz;
  e.rscale = s;
  e.cscale = static_cast<const float*>(w3s);
  WIDE_TRY((gemm<128, 128, false, DEQ>(opd(seg(qi, hid / 2)), opd(seg(w3qt, hid / 2)), M, cz,
                                       hid / 2, 0, L, e, st)));
  e = Epi{};
  e.f32 = of;
  e.ld_f32 = cz;
  e.bias = static_cast<const float*>(b3);
  e.yi = Y + 2 * hid;
  e.yj = Y + 2 * hid + cz;
  e.ld_y = ny;
  WIDE_TRY((gemm<128, 128, false, F32_ADD>(opd(seg(edge, cz)), opd(seg(w3t, hid)), M, cz, cz, 0,
                                           L, e, st)));
  WIDE_TRY(ln_forward(o, ln_s, ln_b, mask, out, M, L, cz, eps, st));
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

// Device launches of one call of edge_transition_int8_wide_forward: 9 with
// the readout, 8 without.
extern "C" int edge_transition_int8_wide_kernels_per_call(int readout) { return readout ? 9 : 8; }

// K6 at c_z = cz in {128, 256, 512}: wn, w1t, w3t as for the bf16 wide
// kernel (edge_transition_wide_forward); w2qt [hid][hid] and w3qt [cz][hid]
// the int8 k2 and k3 quantized per output column and transposed to
// [out][in] (no permutation), with their column scales w2s [hid], w3s [cz];
// wrt [ro_pad][cz] and bro [ro_pad] the readout padded with zeros to a
// multiple of 64 lanes (null without it). Scratch: y [B L][2 hid + 2 cz]
// f32, h [B L L][hid] f32, q [B L L][hid] int8, rs [B L L] f32, o [B L L][cz]
// f32. Returns the first nonzero cudaError_t of its launches.
extern "C" int edge_transition_int8_wide_forward(
    const void* edge, const void* node, const void* mask, const void* wn, const void* w1t,
    const void* b1, const void* w2qt, const void* w2s, const void* b2, const void* w3t,
    const void* w3qt, const void* w3s, const void* b3, const void* ln_s, const void* ln_b,
    const void* wrt, const void* bro, void* y, void* h, void* q, void* rs, void* o, void* out,
    void* b_out, void* pz_out, int B, int L, int cz, int n_b, int n_pz, int ro_pad, float eps,
    void* stream) {
  return wide::edge_int8_forward(edge, node, mask, wn, w1t, b1, w2qt, w2s, b2, w3t, w3qt, w3s, b3,
                                 ln_s, ln_b, wrt, bro, y, h, q, rs, o, out, b_out, pz_out, B, L,
                                 cz, n_b, n_pz, ro_pad, eps, static_cast<cudaStream_t>(stream));
}

// Kernels launched on the wide path since the library was loaded.
extern "C" int edge_transition_int8_wide_launches() { return wide::g_launches.load(); }
