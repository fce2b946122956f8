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
// kernel's rounding points, where neither the weights nor a tile's hidden
// rows fit a block (W2q alone is 147 KB at 128, 2.4 MB at 512): the node
// pre-pass and one tile kernel on the Hopper tile core, csrc/edge_wide.cuh.
// A row's quantization needs its amax over all 3 c_z columns, which a tile
// produces a chunk at a time: at 128 h1 and then h2 are staged in fp32 in
// shared memory (neither hidden row leaves the chip); at 256 and 512 h1's
// chunk products run twice (the first pass for the amax, the second, bit
// for bit the same, quantizes into q1 in shared memory) and h2 is staged in
// a 64-row slot a block of a global scratch (one round trip); then q2. The int32
// sums reach 1536 x 127 x 127 < 2^31 at 8x; their conversion to fp32
// rounds to nearest, as the JAX kernel's astype does.

#include "edge_wide.cuh"

// Device launches of one call of edge_transition_int8_wide_forward (readout
// on or off): the node pre-pass and the tile kernel.
extern "C" int edge_transition_int8_wide_kernels_per_call(int) { return 2; }

// Dynamic shared memory of the tile kernel at c_z = cz, bytes.
extern "C" int edge_transition_int8_wide_smem_bytes(int cz) {
  return ewide::smem_bytes<true>(cz);
}

// Bytes of the scratch a call at c_z = cz, B, L needs beside y: 256, 512:
// h2 in fp32, one 64-row slot a block of the persistent grid; 0 at 128.
extern "C" int edge_transition_int8_wide_scratch_bytes(int cz, int B, int L) {
  return ewide::scratch_bytes<true>(cz, B, L);
}

// K6 at c_z = cz in {128, 256, 512}: wn as for the bf16 wide kernel
// (edge_transition_wide_forward); wb the stages of the e products (bf16),
// q1.W2q and q2.W3q (k2, k3 quantized per output column, int8), wrb those of
// the readout (null without it), as cuda_edge.kernel_operands(...,
// quant_int8=True) packs them; w2s [hid], w3s [cz] the column scales; bro
// [ro_pad] the readout's bias padded with zeros; wb_bytes, wrb_bytes the
// lengths of wb and wrb. Scratch: y [B L][8 cz] f32 and the scratch of
// edge_transition_int8_wide_scratch_bytes (may be null when that is 0).
// Returns cudaErrorInvalidValue where wb or wrb is not as long as the
// schedule reads, else the first nonzero cudaError_t of its two launches.
extern "C" int edge_transition_int8_wide_forward(
    const void* edge, const void* node, const void* mask, const void* wn, const void* wb,
    const void* wrb, const void* b1, const void* w2s, const void* b2, const void* w3s,
    const void* b3, const void* ln_s, const void* ln_b, const void* bro, void* y, void* scratch,
    void* out, void* b_out, void* pz_out, int B, int L, int cz, int n_b, int n_pz, int ro_pad,
    long long wb_bytes, long long wrb_bytes, float eps, void* stream) {
  ewide::Args a{};
  a.edge = static_cast<const bf16*>(edge);
  a.mask = static_cast<const float*>(mask);
  a.y = static_cast<const float*>(y);
  a.wb = static_cast<const unsigned char*>(wb);
  a.wrb = static_cast<const unsigned char*>(wrb);
  a.b1 = static_cast<const float*>(b1);
  a.b2 = static_cast<const float*>(b2);
  a.b3 = static_cast<const float*>(b3);
  a.w2s = static_cast<const float*>(w2s);
  a.w3s = static_cast<const float*>(w3s);
  a.ln_s = static_cast<const float*>(ln_s);
  a.ln_b = static_cast<const float*>(ln_b);
  a.bro = static_cast<const float*>(bro);
  a.scratch = scratch;
  a.out = static_cast<bf16*>(out);
  a.b_out = static_cast<bf16*>(b_out);
  a.pz_out = static_cast<bf16*>(pz_out);
  a.n_b = n_b;
  a.n_pz = n_pz;
  a.eps = eps;
  return ewide::forward<true>(a, node, wn, B, L, cz, ro_pad, wb_bytes, wrb_bytes,
                               static_cast<cudaStream_t>(stream));
}

#ifdef EDGE_WIDE_STAMPS
// The diagnostic build's stage sums (edge_wide.cuh): [blocks][N_STAMPS] int64
// into host memory at `dst`.
extern "C" int edge_wide_read_stamps(void* dst, int blocks) {
  return (int)cudaMemcpyFromSymbol(dst, ewide::g_stamps,
                                   sizeof(long long) * ewide::N_STAMPS * blocks);
}
#endif

// Kernels launched on the wide path since the library was loaded.
extern "C" int edge_transition_int8_wide_launches() { return wide::g_launches.load(); }
