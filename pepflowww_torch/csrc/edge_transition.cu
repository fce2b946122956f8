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
