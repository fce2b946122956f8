// Fused EdgeTransition forward with int8 hidden-width products (the int8
// serving profile), with the optional pair-resident readout epilogue, for
// Hopper, sm_90a.
//
// Replaces: pepflowww_tpu/models/pallas_edge.py::fused_edge_transition with
// quant_int8=True, int8_w3=True (body `_kernel`, `_quant_rows`; the weights
// quantized by `_quant_cols`), both with readout=None and with
// readout=(kb,bb,kdz,bdz).
//
// Per pair (i, j) of a batch row, with e = edge[b,i,j,:] (64 wide) and the
// node-resolution products P (edge_common.cuh, node_proj):
//   h1 = relu(e.W1e + n_i.W1i + n_j.W1j + b1)          (fp32, 192 wide)
//   q1, s1 = quant_rows(h1)                           (int8, amax/127)
//   h2 = relu(float(q1.W2q) * s1 * w2s + b2)          (int32 accumulation)
//   q2, s2 = quant_rows(h2)
//   o  = float(q2.W3q) * s2 * w3s + e.W3e + n_i.W3i + n_j.W3j + b3
//   out = (LayerNorm(o) * scale + bias) * mask_i * mask_j  -> bf16
// and, with READOUT, the next block's b and pz from bf16(out), as the bf16
// kernel (edge_transition.cu) does. quant_rows: amax over the row's 192
// lanes, inv = amax > 0 ? 127/amax : 0 (an IEEE division: this file is
// built without fast math), q = round-half-even(h * inv), scale amax/127.
// W2q, w2s and W3q, w3s are the per-output-column int8 quantization of the
// fp32 k2 and k3 (made once per set of weights by the wrapper, transposed to
// [out][in]); W1 and the 64-wide rows of W3 are their bf16 casts. Products of
// bf16 operands accumulate in fp32, LayerNorm statistics are fp32 (eps 1e-5).
//
// What bounds it on this card: the bytes (edge in, out and the readouts out,
// ~80 MB at B=64, L=64: ~24 us at 3.35 TB/s); its 12.9 G int8 MACs (~13 us
// at 1,979 TOP/s) and 4.9 G bf16 MACs (~10 us) take less. Design: a
// persistent grid of one 8-warp block per SM walking 64-pair tiles of the
// flattened (b, i, j) rows, so any L runs; node products in a pre-pass;
// with the two hidden-width products on the int8 tensor cores
// (mma.sync m16n8k32 s8.s8.s32 from shared memory). The int8 weights (48 KB)
// stay in shared memory for the block's life; each hidden tile is quantized
// in shared memory, one warp per row (row max by shuffles, rounding with
// __float2int_rn), so no activation leaves the SM. h1 stays fp32 until it is
// quantized, as the TPU kernel keeps it. wgmma, TMA and a load pipeline are
// left for later work.

#include "edge_common.cuh"

namespace {

using namespace edge;

constexpr int LD_Q = HID + 16;   // int8 row stride: 52 words, so the 8 rows of an mma
                                 // fragment fall in distinct banks

constexpr int OFF_W1 = 0;                                   // W1e bf16 [64][LD_H]
constexpr int OFF_W3E = OFF_W1 + CZ * LD_H * 2;             // W3e bf16 [64][LD_Z]
constexpr int OFF_WR = OFF_W3E + CZ * LD_Z * 2;             // Wr  bf16 [64][LD_R]
constexpr int OFF_W2Q = OFF_WR + CZ * LD_R * 2;             // W2q^T int8 [192][LD_Q]
constexpr int OFF_W3Q = OFF_W2Q + HID * LD_Q;               // W3q^T int8 [64][LD_Q]
constexpr int OFF_E = OFF_W3Q + CZ * LD_Q;                  // edge / out tile bf16 [64][LD_Z]
constexpr int OFF_Q = OFF_E + TM * LD_Z * 2;                // quantized hidden int8 [64][LD_Q]
constexpr int OFF_S = OFF_Q + TM * LD_Q;                    // fp32 [64][LD_S]
constexpr int OFF_V = OFF_S + TM * LD_S * 4;                // b1 b2 w2s b3 w3s ln_s ln_b bro hs
constexpr int N_VEC = 3 * HID + 4 * CZ + RO + TM;
constexpr int SMEM_BYTES = OFF_V + N_VEC * 4;
static_assert(OFF_E % 32 == 0 && OFF_S % 32 == 0 && OFF_WR % 32 == 0 && OFF_W3E % 32 == 0,
              "WMMA tiles need 256-bit aligned shared memory");

__global__ void edge_int8_node_proj_kernel(const bf16* __restrict__ node,
                                           const bf16* __restrict__ w1,
                                           const bf16* __restrict__ w3, float* __restrict__ P) {
  node_proj(node, w1, w3, P);
}

// rows x cols int8 (cols % 16 == 0) from global (row stride lds) to shared.
__device__ __forceinline__ void stage_s8(int8_t* dst, int ldd, const int8_t* src, int lds,
                                         int rows, int cols) {
  const int per_row = cols / 16;
  for (int v = threadIdx.x; v < rows * per_row; v += blockDim.x) {
    const int r = v / per_row, c = (v % per_row) * 16;
    *reinterpret_cast<uint4*>(dst + r * ldd + c) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * lds + c);
  }
}

// d += a . b on the int8 tensor cores: a 16x32 row-major, b 32x8 column-major.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[n] = A[rows 16 rm .. +16][0:192] . Bt[cols 8 (n0 + n) .. +8][0:192]^T
// with A and Bt int8 tiles of row stride LD_Q (Bt is the weight transposed,
// [out][in]). Fragment layouts of mma.m16n8k32 (g = lane / 4, t = lane % 4):
// a0/a1 rows g/g+8 at k 4t..4t+3, a2/a3 the same at k 16+4t; b0/b1 column g
// at k 4t.. and 16+4t..; d0,d1 / d2,d3 rows g / g+8, columns 2t, 2t+1.
template <int N>
__device__ __forceinline__ void gemm_s8(int (&acc)[N][4], const int8_t* A, const int8_t* Bt,
                                        int rm, int n0, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < N; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0;
#pragma unroll 2
  for (int k0 = 0; k0 < HID; k0 += 32) {
    const int8_t* ap = A + (rm * 16 + g) * LD_Q + k0 + 4 * t;
    uint32_t a[4];
    a[0] = *reinterpret_cast<const uint32_t*>(ap);
    a[1] = *reinterpret_cast<const uint32_t*>(ap + 8 * LD_Q);
    a[2] = *reinterpret_cast<const uint32_t*>(ap + 16);
    a[3] = *reinterpret_cast<const uint32_t*>(ap + 8 * LD_Q + 16);
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const int8_t* bp = Bt + ((n0 + n) * 8 + g) * LD_Q + k0 + 4 * t;
      uint32_t b[2];
      b[0] = *reinterpret_cast<const uint32_t*>(bp);
      b[1] = *reinterpret_cast<const uint32_t*>(bp + 16);
      mma_s8(acc[n], a, b);
    }
  }
}

// One row of 192 fp32 values (6 a lane, lane + 32u) quantized to int8 into
// qrow, its scale amax/127 into *hs: jnp.round's half-to-even by
// __float2int_rn; an all-zero row gets scale 0 and zeros.
__device__ __forceinline__ void quant_row(const float (&v)[6], int8_t* qrow, float* hs,
                                          int lane) {
  float amax = 0.f;
#pragma unroll
  for (int u = 0; u < 6; ++u) amax = fmaxf(amax, fabsf(v[u]));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float inv = amax > 0.f ? 127.f / amax : 0.f;
#pragma unroll
  for (int u = 0; u < 6; ++u) qrow[lane + 32 * u] = (int8_t)__float2int_rn(__fmul_rn(v[u], inv));
  if (lane == 0) *hs = amax / 127.f;
}

template <bool READOUT>
__global__ void __launch_bounds__(NT, 1)
edge_int8_kernel(const bf16* __restrict__ edge, const float* __restrict__ P,
                 const float* __restrict__ mask, const bf16* __restrict__ w1,
                 const float* __restrict__ b1, const int8_t* __restrict__ w2qt,
                 const float* __restrict__ w2s, const float* __restrict__ b2,
                 const bf16* __restrict__ w3, const int8_t* __restrict__ w3qt,
                 const float* __restrict__ w3s, const float* __restrict__ b3,
                 const float* __restrict__ ln_s, const float* __restrict__ ln_b,
                 const bf16* __restrict__ wr, const float* __restrict__ bro,
                 bf16* __restrict__ out, bf16* __restrict__ b_out, bf16* __restrict__ pz_out,
                 int L, long long total, int n_b, int n_pz, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* w1_s = reinterpret_cast<bf16*>(smem + OFF_W1);
  bf16* w3e_s = reinterpret_cast<bf16*>(smem + OFF_W3E);
  bf16* wr_s = reinterpret_cast<bf16*>(smem + OFF_WR);
  int8_t* w2q_s = reinterpret_cast<int8_t*>(smem + OFF_W2Q);
  int8_t* w3q_s = reinterpret_cast<int8_t*>(smem + OFF_W3Q);
  bf16* e_s = reinterpret_cast<bf16*>(smem + OFF_E);
  int8_t* q_s = reinterpret_cast<int8_t*>(smem + OFF_Q);
  float* s_s = reinterpret_cast<float*>(smem + OFF_S);
  float* b1_s = reinterpret_cast<float*>(smem + OFF_V);
  float* b2_s = b1_s + HID;
  float* w2s_s = b2_s + HID;
  float* b3_s = w2s_s + HID;
  float* w3s_s = b3_s + CZ;
  float* lns_s = w3s_s + CZ;
  float* lnb_s = lns_s + CZ;
  float* bro_s = lnb_s + CZ;
  float* hs_s = bro_s + RO;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  stage(w1_s, LD_H, w1, HID, CZ, HID);   // bf16 W1 rows 0..63: the edge part
  stage(w3e_s, LD_Z, w3, CZ, CZ, CZ);    // bf16 W3 rows 0..63: the edge part
  if (READOUT) stage(wr_s, LD_R, wr, RO, CZ, RO);
  stage_s8(w2q_s, LD_Q, w2qt, HID, HID, HID);
  stage_s8(w3q_s, LD_Q, w3qt, HID, CZ, HID);
  for (int c = tid; c < HID; c += NT) { b1_s[c] = b1[c]; b2_s[c] = b2[c]; w2s_s[c] = w2s[c]; }
  for (int c = tid; c < CZ; c += NT) {
    b3_s[c] = b3[c]; w3s_s[c] = w3s[c]; lns_s[c] = ln_s[c]; lnb_s[c] = ln_b[c];
  }
  if (READOUT)
    for (int c = tid; c < RO; c += NT) bro_s[c] = bro[c];
  __syncthreads();

  const long long LL = (long long)L * L;
  const long long ntiles = (total + TM - 1) / TM;
  const int rm = warp >> 1;            // 16-row block of this warp
  const int g = lane >> 2, t = lane & 3;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long row0 = tile * TM;

    for (int v = tid; v < TM * (CZ / 8); v += NT) {
      const int r = v >> 3, c8 = (v & 7) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (row0 + r < total) val = *reinterpret_cast<const uint4*>(edge + (row0 + r) * CZ + c8);
      *reinterpret_cast<uint4*>(e_s + r * LD_Z + c8) = val;
    }
    __syncthreads();

    {  // h1 accumulators: E[64x64] . W1e[64x192] (bf16)
      Acc acc[6];
      zero_acc(acc);
      mma_acc(acc, e_s, LD_Z, w1_s, LD_H, CZ / 16, rm, (warp & 1) * 6);
      store_acc(acc, s_s, rm, (warp & 1) * 6);
    }
    __syncthreads();
    // h1 = relu(. + node terms + b1) in fp32, quantized row by row.
    for (int r = warp; r < TM; r += NT / 32) {
      const long long row = row0 + r;
      float v[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (row < total) {
        const long long bi = row / L;                       // b * L + i
        const long long bj = (row / LL) * L + row % L;      // b * L + j
#pragma unroll
        for (int u = 0; u < 6; ++u) {
          const int c = lane + 32 * u;
          v[u] = fmaxf(s_s[r * LD_S + c] + P[bi * NP + c] + P[bj * NP + HID + c] + b1_s[c], 0.f);
        }
      }
      quant_row(v, q_s + r * LD_Q, hs_s + r, lane);
    }
    __syncthreads();

    {  // h2 = relu(float(Q1[64x192] . W2q[192x192]) * s1 * w2s + b2)
      int acc[12][4];
      gemm_s8(acc, q_s, w2q_s, rm, (warp & 1) * 12, lane);
#pragma unroll
      for (int n = 0; n < 12; ++n) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int r = rm * 16 + g + 8 * (k >> 1);
          const int c = ((warp & 1) * 12 + n) * 8 + 2 * t + (k & 1);
          const float v = __fmul_rn(__fmul_rn((float)acc[n][k], hs_s[r]), w2s_s[c]);
          s_s[r * LD_S + c] = fmaxf(__fadd_rn(v, b2_s[c]), 0.f);
        }
      }
    }
    __syncthreads();
    for (int r = warp; r < TM; r += NT / 32) {
      float v[6];
#pragma unroll
      for (int u = 0; u < 6; ++u) v[u] = s_s[r * LD_S + lane + 32 * u];
      quant_row(v, q_s + r * LD_Q, hs_s + r, lane);
    }
    __syncthreads();

    {  // o: float(Q2[64x192] . W3q[192x64]) * s2 * w3s into columns 0..63,
       // E[64x64] . W3e[64x64] (bf16) into columns 64..127
      int acc[4][4];
      gemm_s8(acc, q_s, w3q_s, rm, (warp & 1) * 4, lane);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int r = rm * 16 + g + 8 * (k >> 1);
          const int c = ((warp & 1) * 4 + n) * 8 + 2 * t + (k & 1);
          s_s[r * LD_S + c] = __fmul_rn(__fmul_rn((float)acc[n][k], hs_s[r]), w3s_s[c]);
        }
      }
      Acc eacc[2];
      zero_acc(eacc);
      mma_acc(eacc, e_s, LD_Z, w3e_s, LD_Z, CZ / 16, rm, (warp & 1) * 2);
      store_acc(eacc, s_s + CZ, rm, (warp & 1) * 2);
    }
    __syncthreads();

    layer_norm_store<READOUT>(s_s, CZ, P, mask, b3_s, lns_s, lnb_s, out, e_s, row0, total, L,
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
// cudaError_t of the launches (0 on success). w1, w3: bf16 k1 (192 x 192),
// k3 (192 x 64); w2qt, w3qt: int8 k2, k3 quantized per output column and
// transposed, (192 x 192), (64 x 192), with their column scales w2s, w3s.
extern "C" int edge_transition_int8_forward(
    const void* edge, const void* node, const void* mask, const void* w1, const void* b1,
    const void* w2qt, const void* w2s, const void* b2, const void* w3, const void* w3qt,
    const void* w3s, const void* b3, const void* ln_s, const void* ln_b, const void* wr,
    const void* bro, void* P, void* out, void* b_out, void* pz_out, int B, int L, int n_b,
    int n_pz, float eps, void* stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  const int variant = b_out != nullptr;
  auto kernel = variant ? edge_int8_kernel<true> : edge_int8_kernel<false>;
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
  edge_int8_node_proj_kernel<<<B * L, NT, 0, s>>>(static_cast<const bf16*>(node),
                                                  static_cast<const bf16*>(w1),
                                                  static_cast<const bf16*>(w3),
                                                  static_cast<float*>(P));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const long long total = (long long)B * L * L;
  const long long ntiles = (total + TM - 1) / TM;
  const int grid = (int)(ntiles < g_sms[dev] ? ntiles : g_sms[dev]);
  kernel<<<grid, NT, SMEM_BYTES, s>>>(
      static_cast<const bf16*>(edge), static_cast<const float*>(P),
      static_cast<const float*>(mask), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const int8_t*>(w2qt),
      static_cast<const float*>(w2s), static_cast<const float*>(b2),
      static_cast<const bf16*>(w3), static_cast<const int8_t*>(w3qt),
      static_cast<const float*>(w3s), static_cast<const float*>(b3),
      static_cast<const float*>(ln_s), static_cast<const float*>(ln_b),
      static_cast<const bf16*>(wr), static_cast<const float*>(bro), static_cast<bf16*>(out),
      static_cast<bf16*>(b_out), static_cast<bf16*>(pz_out), L, total, n_b, n_pz, eps);
  return (int)cudaGetLastError();
}
