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
// 8 + c_z / 4): the same function as the kernel above, where neither the
// weights nor a tile's hidden rows fit a block (W2 alone is 295 KB at 128,
// 4.7 MB at 512): the node pre-pass and one tile kernel on the Hopper tile
// core, csrc/edge_wide.cuh (h1 in shared memory at 128 and 256, one bf16
// round trip of it at 512; h2 a chunk of 128 columns at a time, never
// whole).

#include "edge_wide.cuh"

// Device launches of one call of edge_transition_wide_forward (readout on
// or off): the node pre-pass and the tile kernel.
extern "C" int edge_transition_wide_kernels_per_call(int) { return 2; }

// Dynamic shared memory of the tile kernel at c_z = cz, bytes.
extern "C" int edge_transition_wide_smem_bytes(int cz) { return ewide::smem_bytes<false>(cz); }

// Bytes of the scratch a call at c_z = cz, B, L needs beside y: 512: h1's
// panel images, one 64-row slot a block of the persistent grid; 0 below.
extern "C" int edge_transition_wide_scratch_bytes(int cz, int B, int L) {
  return ewide::scratch_bytes<false>(cz, B, L);
}

// K1/K2 at c_z = cz in {128, 256, 512}: wn [2 hid + 2 cz][cz] are the node
// rows of k1 and k3 transposed ([W1i | W1j | W3i | W3j]^T, bf16); wb the
// stages of the e, h1 and h2 products and wrb those of the readout (null
// without it), as cuda_edge.kernel_operands packs them; bro [ro_pad] the
// readout's bias padded with zeros; wb_bytes, wrb_bytes the lengths of wb
// and wrb. Scratch: y [B L][8 cz] f32 and the scratch of
// edge_transition_wide_scratch_bytes (may be null when that is 0). Returns
// cudaErrorInvalidValue where wb or wrb is not as long as the schedule
// reads, else the first nonzero cudaError_t of its two launches.
extern "C" int edge_transition_wide_forward(
    const void* edge, const void* node, const void* mask, const void* wn, const void* wb,
    const void* wrb, const void* b1, const void* b2, const void* b3, const void* ln_s,
    const void* ln_b, const void* bro, void* y, void* scratch, void* out, void* b_out,
    void* pz_out, int B, int L, int cz, int n_b, int n_pz, int ro_pad, long long wb_bytes,
    long long wrb_bytes, float eps, void* stream) {
  ewide::Args a{};
  a.edge = static_cast<const bf16*>(edge);
  a.mask = static_cast<const float*>(mask);
  a.y = static_cast<const float*>(y);
  a.wb = static_cast<const unsigned char*>(wb);
  a.wrb = static_cast<const unsigned char*>(wrb);
  a.b1 = static_cast<const float*>(b1);
  a.b2 = static_cast<const float*>(b2);
  a.b3 = static_cast<const float*>(b3);
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
  return ewide::forward<false>(a, node, wn, B, L, cz, ro_pad, wb_bytes, wrb_bytes,
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

// Kernels launched on the wide paths since the library was loaded.
extern "C" int edge_transition_wide_launches() { return wide::g_launches.load(); }
