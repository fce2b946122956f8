// Fused EdgeTransition forward (with the optional pair-resident readout
// epilogue) for Hopper, sm_90a.
//
// Replaces: pepflowww_tpu/models/pallas_edge.py::fused_edge_transition
// (body `_kernel`), both with readout=None and with readout=(kb,bb,kdz,bdz).
//
// Per pair (i, j) of a batch row, with e = edge[b,i,j,:] (64 wide) and the
// node-resolution products P (see node_proj_kernel):
//   h1 = relu(e.W1e + n_i.W1i + n_j.W1j + b1)              (192 wide)
//   h2 = relu(bf16(h1).W2 + b2)
//   o  = bf16(h2).W3 + e.W3e + n_i.W3i + n_j.W3j + b3      (64 wide)
//   out = (LayerNorm(o) * scale + bias) * mask_i * mask_j  -> bf16
// and, with READOUT, from bf16(out) while it is still on chip:
//   b[b,h,i,j]  = out.kb  + bb   (h < n_b)
//   pz[b,d,i,j] = out.kdz + bdz  (d < n_pz)
// Products of bf16 operands accumulate in fp32; the LayerNorm statistics are
// fp32 (eps passed in, 1e-5).
//
// What bounds it on this card: 67,072 MAC per pair and 32,768 per residue
// (the node products), all bf16 on the tensor cores (35.4 GFLOP at B=64,
// L=64), against ~304 bytes of HBM traffic per pair, so the bf16
// tensor-core rate, not memory, is the limit (~36 us at 989 TFLOP/s).
// Design: the 192-wide hidden activations never leave shared memory; all
// weights (~131 KB bf16) are staged once per block and the block walks over
// 64-pair tiles (persistent grid, one block per SM), so weight traffic is
// paid once per SM instead of once per tile. The four node-resolution
// products run once per residue in a small pre-pass instead of once per
// pair. GEMMs use bf16 WMMA (mma.sync) with fp32 accumulation; wgmma, TMA
// and a load pipeline are left for later work. Pairs are flattened over
// (b, i, j), so any L runs: the ragged last tile is masked here.

#include "edge_common.cuh"

namespace {

using namespace edge;

constexpr int OFF_W1 = 0;                                   // W1e  [64][LD_H]
constexpr int OFF_W2 = OFF_W1 + CZ * LD_H * 2;              // W2   [192][LD_H]
constexpr int OFF_W3 = OFF_W2 + HID * LD_H * 2;             // W3   [192][LD_Z]
constexpr int OFF_WR = OFF_W3 + HID * LD_Z * 2;             // Wr   [64][LD_R]
constexpr int OFF_E = OFF_WR + CZ * LD_R * 2;               // edge / out tile [64][LD_Z]
constexpr int OFF_H = OFF_E + TM * LD_Z * 2;                // hidden [64][LD_H]
constexpr int OFF_S = OFF_H + TM * LD_H * 2;                // fp32 accumulators [64][LD_S]
constexpr int OFF_V = OFF_S + TM * LD_S * 4;                // b1 b2 b3 ln_s ln_b bro
constexpr int N_VEC = HID + HID + CZ + CZ + CZ + RO;
constexpr int SMEM_BYTES = OFF_V + N_VEC * 4;

__global__ void node_proj_kernel(const bf16* __restrict__ node, const bf16* __restrict__ w1,
                                 const bf16* __restrict__ w3, float* __restrict__ P) {
  node_proj(node, w1, w3, P);
}

template <bool READOUT>
__global__ void __launch_bounds__(NT, 1)
edge_transition_kernel(const bf16* __restrict__ edge, const float* __restrict__ P,
                       const float* __restrict__ mask, const bf16* __restrict__ w1,
                       const float* __restrict__ b1, const bf16* __restrict__ w2,
                       const float* __restrict__ b2, const bf16* __restrict__ w3,
                       const float* __restrict__ b3, const float* __restrict__ ln_s,
                       const float* __restrict__ ln_b, const bf16* __restrict__ wr,
                       const float* __restrict__ bro, bf16* __restrict__ out,
                       bf16* __restrict__ b_out, bf16* __restrict__ pz_out,
                       int L, long long total, int n_b, int n_pz, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* w1_s = reinterpret_cast<bf16*>(smem + OFF_W1);
  bf16* w2_s = reinterpret_cast<bf16*>(smem + OFF_W2);
  bf16* w3_s = reinterpret_cast<bf16*>(smem + OFF_W3);
  bf16* wr_s = reinterpret_cast<bf16*>(smem + OFF_WR);
  bf16* e_s = reinterpret_cast<bf16*>(smem + OFF_E);
  bf16* h_s = reinterpret_cast<bf16*>(smem + OFF_H);
  float* s_s = reinterpret_cast<float*>(smem + OFF_S);
  float* b1_s = reinterpret_cast<float*>(smem + OFF_V);
  float* b2_s = b1_s + HID;
  float* b3_s = b2_s + HID;
  float* lns_s = b3_s + CZ;
  float* lnb_s = lns_s + CZ;
  float* bro_s = lnb_s + CZ;

  const int tid = threadIdx.x, warp = tid >> 5;

  stage(w1_s, LD_H, w1, HID, CZ, HID);   // W1 rows 0..63: the edge part
  stage(w2_s, LD_H, w2, HID, HID, HID);
  stage(w3_s, LD_Z, w3, CZ, HID, CZ);    // all of W3; rows 0..63 are W3e
  if (READOUT) stage(wr_s, LD_R, wr, RO, CZ, RO);
  for (int c = tid; c < HID; c += NT) { b1_s[c] = b1[c]; b2_s[c] = b2[c]; }
  for (int c = tid; c < CZ; c += NT) { b3_s[c] = b3[c]; lns_s[c] = ln_s[c]; lnb_s[c] = ln_b[c]; }
  if (READOUT)
    for (int c = tid; c < RO; c += NT) bro_s[c] = bro[c];
  __syncthreads();

  const long long LL = (long long)L * L;
  const long long ntiles = (total + TM - 1) / TM;
  const int rm = warp >> 1;            // 16-row block of this warp
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long row0 = tile * TM;

    for (int v = tid; v < TM * (CZ / 8); v += NT) {
      const int r = v >> 3, c8 = (v & 7) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (row0 + r < total) val = *reinterpret_cast<const uint4*>(edge + (row0 + r) * CZ + c8);
      *reinterpret_cast<uint4*>(e_s + r * LD_Z + c8) = val;
    }
    __syncthreads();

    {  // h1 accumulators: E[64x64] . W1e[64x192]
      Acc acc[6];
      zero_acc(acc);
      mma_acc(acc, e_s, LD_Z, w1_s, LD_H, CZ / 16, rm, (warp & 1) * 6);
      store_acc(acc, s_s, rm, (warp & 1) * 6);
    }
    __syncthreads();
    for (int idx = tid; idx < TM * HID; idx += NT) {
      const int r = idx / HID, c = idx % HID;
      const long long row = row0 + r;
      float v = 0.f;
      if (row < total) {
        const long long bi = row / L;                       // b * L + i
        const long long bj = (row / LL) * L + row % L;      // b * L + j
        v = fmaxf(s_s[r * LD_S + c] + P[bi * NP + c] + P[bj * NP + HID + c] + b1_s[c], 0.f);
      }
      h_s[r * LD_H + c] = __float2bfloat16(v);
    }
    __syncthreads();

    {  // h2 accumulators: H[64x192] . W2[192x192]
      Acc acc[6];
      zero_acc(acc);
      mma_acc(acc, h_s, LD_H, w2_s, LD_H, HID / 16, rm, (warp & 1) * 6);
      store_acc(acc, s_s, rm, (warp & 1) * 6);
    }
    __syncthreads();
    for (int idx = tid; idx < TM * HID; idx += NT) {
      const int r = idx / HID, c = idx % HID;
      h_s[r * LD_H + c] = __float2bfloat16(fmaxf(s_s[r * LD_S + c] + b2_s[c], 0.f));
    }
    __syncthreads();

    {  // o accumulators: H[64x192] . W3[192x64] + E[64x64] . W3e[64x64]
      Acc acc[2];
      zero_acc(acc);
      mma_acc(acc, h_s, LD_H, w3_s, LD_Z, HID / 16, rm, (warp & 1) * 2);
      mma_acc(acc, e_s, LD_Z, w3_s, LD_Z, CZ / 16, rm, (warp & 1) * 2);
      store_acc(acc, s_s, rm, (warp & 1) * 2);
    }
    __syncthreads();

    layer_norm_store<READOUT>(s_s, -1, P, mask, b3_s, lns_s, lnb_s, out, e_s, row0, total, L,
                              eps);
    if (READOUT) readout_store(e_s, wr_s, s_s, bro_s, b_out, pz_out, row0, total, L, n_b, n_pz);
    __syncthreads();
  }
}

// Per device, set on its first launch: the SM count, and whether each
// variant (readout off, on) has its dynamic shared-memory opt-in. Racing
// first calls from two threads write the same values.
constexpr int MAX_DEVICES = 64;
int g_sms[MAX_DEVICES];
bool g_smem_opt_in[2][MAX_DEVICES];

}  // namespace

// Launches the node pre-pass and the fused kernel on `stream`; returns the
// cudaError_t of the launches (0 on success).
extern "C" int edge_transition_forward(
    const void* edge, const void* node, const void* mask, const void* w1, const void* b1,
    const void* w2, const void* b2, const void* w3, const void* b3, const void* ln_s,
    const void* ln_b, const void* wr, const void* bro, void* P, void* out, void* b_out,
    void* pz_out, int B, int L, int n_b, int n_pz, float eps, void* stream) {
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

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  node_proj_kernel<<<B * L, NT, 0, s>>>(static_cast<const bf16*>(node),
                                        static_cast<const bf16*>(w1),
                                        static_cast<const bf16*>(w3), static_cast<float*>(P));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const long long total = (long long)B * L * L;
  const long long ntiles = (total + TM - 1) / TM;
  const int grid = (int)(ntiles < g_sms[dev] ? ntiles : g_sms[dev]);
  kernel<<<grid, NT, SMEM_BYTES, s>>>(
      static_cast<const bf16*>(edge), static_cast<const float*>(P),
      static_cast<const float*>(mask), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2),
      static_cast<const float*>(b2), static_cast<const bf16*>(w3),
      static_cast<const float*>(b3), static_cast<const float*>(ln_s),
      static_cast<const float*>(ln_b), static_cast<const bf16*>(wr),
      static_cast<const float*>(bro), static_cast<bf16*>(out), static_cast<bf16*>(b_out),
      static_cast<bf16*>(pz_out), L, total, n_b, n_pz, eps);
  return (int)cudaGetLastError();
}
