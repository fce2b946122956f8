// EdgeEmbedder distance block, forward, for Hopper, sm_90a (K3).
//
// Replaces: pepflowww_tpu/models/pallas_dist.py::fused_distance_embed
// (body `_kernel` :57, pallas_call :144).
//
// Per pair (i, j) of a batch row:
//   d2[a, a']  = |pos_i[a] - pos_j[a']|^2          (15 x 15 heavy atoms, nm, fp32)
//   c[a, a']   = softplus(table[aa_i * 22 + aa_j][a * 15 + a'])
//   x[a, a']   = exp(-c * d2) * m_i[a] * m_j[a']
//   out        = relu(relu(bf16(x).K1 + b1).K2 + b2) * s_i * s_j   -> bf16 (64 wide)
// with K1 225 -> 64 and K2 64 -> 64 in bf16 and fp32 accumulation.
//
// Unlike the TPU kernel, d2 is the plain difference form from the fp32
// coordinates (the TPU kernel's |a|^2 + |b|^2 - 2 a.b form in bf16 was a
// layout device and loses digits to cancellation), and the coefficients are
// read from the fp32 table instead of through a one-hot matmul.
//
// What bounds it on this card: the fp32 work per atom pair (d2, the
// gaussian, the masks; ~11.8 us at B=64, L=64 by bounds.py, which counts an
// exp as one fp32 operation) against 9.7 GFLOP on the tensor cores (~10 us)
// and ~35 MB of HBM traffic (~10.5 us). The exp runs on the special
// function units at 16 a clock an SM: 225 of them a pair are a floor of
// ~14-16 us at B=64, L=64 that the bound does not see.
//
// Design (csrc/distance_tile.cuh): one warpgroup a block, two blocks an SM,
// each block a chunk of the live residues (s_i != 0) in a stable order by
// token, derived on the device; the output rows of a residue whose s_i is 0
// are zeros, written by the block whose index range holds it. At each run
// of equal aa_i the block fills the 22 x 225 slab softplus(coef) * log2(e)
// in shared memory, once per entry, so the gaussian is one ex2.approx an
// atom pair. Per tile of 64 pairs (residue i against 64 residues j, L > 64
// in tiles of 64, the last ragged) the gaussian row is built straight into
// the swizzled x panel, a1 = x.K1 runs on wgmma from shared memory, h =
// bf16(relu(a1 + b1)) is the A operand of h.K2 from registers, and b2, ReLU
// and s_i s_j are applied in registers; the bf16 rows are staged through
// shared memory for 16-byte stores of each 128-byte output row. Rows whose
// s_j is 0 are zero in x (their output is 0 either way). One launch a call.

#include <climits>

#include "distance_tile.cuh"
#include "wide_dist.cuh"

namespace {

using namespace dist;

constexpr int NT = 128;   // one warpgroup

// Shared memory (bytes): K1, K2, the x panel (also the order's scratch and
// the output's staging), the coefficient slab, the j tile, two buffers of
// residue i's atoms (the next item's arrive during this one's tiles), b1 and
// b2, the window's items, the scan's scratch: 110,148 bytes, two blocks an SM.
struct Smem {
  static constexpr int K1 = 0;
  static constexpr int K2 = K1 + K1_BYTES;
  static constexpr int X = K2 + K2_BYTES;
  static constexpr int SP = X + X_BYTES;
  static constexpr int JT = SP + SLAB_BYTES;
  static constexpr int PI = JT + (int)((sizeof(JTile) + 15) / 16 * 16);
  static constexpr int B1 = PI + 2 * 16 * 16;
  static constexpr int WIN = B1 + 2 * F * 4;
  static constexpr int TOT = WIN + (int)sizeof(Window);
  static constexpr int BYTES = TOT + 32 * 4;
  static_assert(K2 % 1024 == 0 && X % 1024 == 0, "panels on 1024 bytes");
  static_assert((NAA + 1) * NT * 4 <= X_BYTES, "the order's scratch fits in the x panel");
  static_assert(2 * (BYTES + 1024) <= 233472, "two blocks an SM");
};

struct Args {
  const float* pos;
  const float* amask;
  const int* aa;
  const float* smask;
  const float* table;
  const bf16* k1;
  const float* b1;
  const bf16* k2;
  const float* b2;
  bf16* out;
  int B, L;
};

__global__ void __launch_bounds__(NT, 2) distance_embed_kernel(const __grid_constant__ Args a) {
  using S = Smem;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  if (base & 1023) __trap();   // the swizzle is taken from the address bits
  float* sp2 = reinterpret_cast<float*>(smem + S::SP);
  JTile& jt = *reinterpret_cast<JTile*>(smem + S::JT);
  const float4* pi_buf = reinterpret_cast<const float4*>(smem + S::PI);
  float* b1_s = reinterpret_cast<float*>(smem + S::B1);
  float* b2_s = b1_s + F;
  Window& win = *reinterpret_cast<Window*>(smem + S::WIN);
  int* tot = reinterpret_cast<int*>(smem + S::TOT);
  unsigned char* x_p = smem + S::X;
  const uint32_t x_s = base + S::X, k1_s = base + S::K1, k2_s = base + S::K2;
  const uint32_t pi_s = base + S::PI;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int ra = 16 * warp + g;
  const int L = a.L, N = a.B * a.L, G = gridDim.x, z = blockIdx.x;
  const int n_jt = (L + TJ - 1) / TJ;

  stage_weights(k1_s, k2_s, a.k1, a.k2, tid, NT);
  cp_async_commit();
  for (int c = tid; c < F; c += NT) {
    b1_s[c] = a.b1[c];
    b2_s[c] = a.b2[c];
  }
  for (int v = tid; v < SLAB_BYTES / 4; v += NT) sp2[v] = 0.f;   // the pads stay 0

  // Residues whose s_i is 0 (no live pair): their output rows are 0. Block
  // z writes those of residues [N z / G, N (z + 1) / G), 16 bytes a thread
  // at a time (the masks' loads independent, so in flight together).
  {
    const long long q0 = chunk_start(N, G, z);
    const int per = L * (F / 8), total = (int)(chunk_start(N, G, z + 1) - q0) * per;
    for (int v = tid; v < total; v += NT) {
      const long long n = q0 + v / per;
      if (a.smask[n] == 0.f)
        reinterpret_cast<uint4*>(a.out + (size_t)n * L * F)[v % per] = make_uint4(0u, 0u, 0u, 0u);
    }
  }

  int cur_k = -1, jt_b = -1, jt_t = -1;   // the slab's token, the j tile's (b, jt)
  for (int wi = 0;; ++wi) {
    __syncthreads();   // the x panel is free: it holds the order's counts
    const int count = sorted_window(a.aa, a.smask, N, G, z, wi, reinterpret_cast<int*>(x_p), tot,
                                    win, nullptr, tid, NT);
    if (count == 0) break;
    load_i_async(pi_s, a.pos, a.amask, win.n[0], tid);
    cp_async_commit();
    for (int idx = 0; idx < count; ++idx) {
      const int n = win.n[idx], k = win.tok[idx], b = n / L;
      const float s_i = win.s[idx];
      bf16* out_n = a.out + (size_t)n * L * F;
      // The next item's atoms into the other buffer (its last reader, item
      // idx - 1, is done, and so is the copy into it); one group an item, so
      // wait_group 1 leaves only that one in flight.
      if (idx + 1 < count) load_i_async(pi_s + ((idx + 1) & 1) * 256, a.pos, a.amask, win.n[idx + 1], tid);
      cp_async_commit();
      cp_async_wait_group<1>();   // this item's atoms (first also the weights)
      if (k != cur_k) {
        fill_slabs(sp2, nullptr, a.table, k, tid, NT);
        cur_k = k;
      }
      __syncthreads();   // every thread's copies of this item's atoms have landed
      const float4* pi = pi_buf + (idx & 1) * 16;
      for (int t = 0; t < n_jt; ++t) {
        if (jt_b != b || jt_t != t) {
          load_jtile<false>(jt, a.pos, a.amask, a.aa, a.smask, L, b, t, tid, NT);
          jt_b = b;
          jt_t = t;
        }
        const int j0 = t * TJ, nj = min(TJ, L - j0);
        build_x<NT, 4, 0>(x_s, nullptr, jt, pi, sp2, nullptr, tid);
        fence_proxy_async();
        __syncthreads();

        float acc[32];
        uint32_t h[16];
        product_a1(acc, x_s, k1_s);
        relu_pack(acc, b1_s, h, q);
        product_a2(acc, h, k2_s);
        __syncthreads();   // every warp's a1 has read x: it takes the output rows
        const float sa = s_i * jt.s[ra], sb = s_i * jt.s[ra + 8];
#pragma unroll
        for (int jb = 0; jb < 8; ++jb) {
          const float2 bb = *reinterpret_cast<const float2*>(b2_s + 8 * jb + 2 * q);
          uint32_t* o = reinterpret_cast<uint32_t*>(x_p + pair_offset(ra, g, q, jb));
          o[0] = pack_bf16(fmaxf(acc[4 * jb] + bb.x, 0.f) * sa, fmaxf(acc[4 * jb + 1] + bb.y, 0.f) * sa);
          o[256] = pack_bf16(fmaxf(acc[4 * jb + 2] + bb.x, 0.f) * sb,
                             fmaxf(acc[4 * jb + 3] + bb.y, 0.f) * sb);
        }
        __syncthreads();
        for (int v = tid; v < nj * 8; v += NT) {
          const int r = v >> 3, c = v & 7;
          reinterpret_cast<uint4*>(out_n + (size_t)(j0 + r) * F)[c] =
              *reinterpret_cast<const uint4*>(x_p + sw128_offset(r, c));
        }
        __syncthreads();   // the staging rows are read: the next tile's x may overwrite them
      }
    }
  }
  cp_async_wait_all();
}

// Per device, set on its first launch: the SM count, and whether the kernel
// has its dynamic shared-memory opt-in. Racing first calls from two threads
// write the same values.
constexpr int MAX_DEVICES = 64;
int g_sms[MAX_DEVICES];
bool g_smem_opt_in[MAX_DEVICES];

// The dynamic shared-memory opt-in, and the largest carveout, so that two
// blocks fit an SM.
cudaError_t set_attributes() {
  cudaError_t err = cudaFuncSetAttribute(distance_embed_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, Smem::BYTES);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(distance_embed_kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

}  // namespace

extern "C" int distance_embed_smem_bytes() { return Smem::BYTES; }
extern "C" int distance_embed_kernels_per_call() { return 1; }

// Blocks of the kernel resident on one SM (-1 on an error).
extern "C" int distance_embed_blocks_per_sm() {
  int n = 0;
  if (set_attributes() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, distance_embed_kernel, NT, Smem::BYTES) !=
          cudaSuccess)
    return -1;
  return n;
}

// Launches the kernel on `stream`; returns the cudaError_t of the launch.
// aa must be 16-byte aligned (the order reads it 4 tokens at a time).
extern "C" int distance_embed_forward(const void* pos, const void* amask, const void* aa,
                                      const void* smask, const void* table, const void* k1,
                                      const void* b1, const void* k2, const void* b2, void* out,
                                      int B, int L, void* stream) {
  if (B < 1 || L < 1 || (long long)B * L > INT_MAX) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!g_smem_opt_in[dev]) {
    err = set_attributes();
    if (err != cudaSuccess) return (int)err;
    g_smem_opt_in[dev] = true;
  }
  if (g_sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&g_sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  const long long n = (long long)B * L, cap = 2LL * g_sms[dev];
  const int grid = (int)(n < cap ? n : cap);
  Args args{static_cast<const float*>(pos), static_cast<const float*>(amask),
            static_cast<const int*>(aa), static_cast<const float*>(smask),
            static_cast<const float*>(table), static_cast<const bf16*>(k1),
            static_cast<const float*>(b1), static_cast<const bf16*>(k2),
            static_cast<const float*>(b2), static_cast<bf16*>(out), B, L};
  distance_embed_kernel<<<grid, NT, Smem::BYTES, static_cast<cudaStream_t>(stream)>>>(args);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- 2x, 4x, 8x
// K3 at F = 128, 256, 512 (csrc/wide_dist.cuh): softplus of the table once,
// the bf16 gaussian rows x [B L L][256], then the MLP as two tiled GEMMs
// (wide_gemm.cuh) that stream K1 and K2 through shared memory:
//   h = bf16(relu(x.K1 + b1)), out = bf16(relu(h.K2 + b2) s_i s_j).
// What bounds it: from F = 128 on, the tensor cores and the 225 exps a pair
// (bounds.py); x's and h's round trips through device memory are the price
// of the simple design.

// Device launches of one call of distance_embed_wide_forward.
extern "C" int distance_embed_wide_kernels_per_call() { return 4; }

// k1t [F][256] is k1 transposed and padded with zeros from 225 columns,
// k2t [F][F] k2 transposed, both bf16. Scratch: sp [484][225] f32, x [B L
// L][256] and h [B L L][F] bf16. Returns the first nonzero cudaError_t.
namespace wide {

static int dist_forward(const void* pos, const void* amask, const void* aa,
                                           const void* smask, const void* table, const void* k1t,
                                           const void* b1, const void* k2t, const void* b2,
                                           void* sp, void* x, void* h, void* out, int B, int L,
                                           int F, void* stream) {
  const long long total = (long long)B * L * L;
  if (B < 1 || L < 1 || total > INT_MAX) return (int)cudaErrorInvalidValue;
  if (F != 128 && F != 256 && F != 512) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = (int)total;
  WIDE_TRY(dist_x(pos, amask, aa, table, sp, x, B, L, st));
  Epi e{};
  e.out = static_cast<bf16*>(h);
  e.ld_out = F;
  e.bias = static_cast<const float*>(b1);
  WIDE_TRY((gemm<128, 128, false, RELU>(opd(seg(x, XW)), opd(seg(k1t, XW)), M, F, XW, 0, L, e,
                                        st)));
  e = Epi{};
  e.out = static_cast<bf16*>(out);
  e.ld_out = F;
  e.bias = static_cast<const float*>(b2);
  e.pmask = static_cast<const float*>(smask);
  return gemm<128, 128, false, RELU_PAIRMASK>(opd(seg(h, F)), opd(seg(k2t, F)), M, F, F, 0, L, e,
                                              st);
}

}  // namespace wide

extern "C" int distance_embed_wide_forward(const void* pos, const void* amask, const void* aa,
                                           const void* smask, const void* table, const void* k1t,
                                           const void* b1, const void* k2t, const void* b2,
                                           void* sp, void* x, void* h, void* out, int B, int L,
                                           int F, void* stream) {
  return wide::dist_forward(pos, amask, aa, smask, table, k1t, b1, k2t, b2, sp, x, h, out, B, L,
                            F, stream);
}

// Kernels launched on the wide paths since the library was loaded.
extern "C" int distance_embed_wide_launches() { return wide::g_launches.load(); }
