// The EdgeTransition forward at the JAX package's 2x, 4x and 8x widths
// (c_z = CZ = 128, 256, 512, hidden HID = 3 CZ, readout lanes up to 8 +
// CZ / 4) for Hopper, sm_90a: K1/K2 (edge_transition.cu, bf16) and K6
// (edge_transition_int8.cu, int8 hidden products), one tile kernel a call
// after the node pre-pass. Replaces pepflowww_tpu/models/pallas_edge.py:160
// fused_edge_transition (body `_kernel`, :47) at those widths.
//
// A call: Y = node.[W1i | W1j | W3i | W3j] over the B L residue rows
// (wide_gemm.cuh, fp32, under 1% of the work), then edge_wide_kernel over
// the B L^2 pair rows. What bounds it: the tensor cores (bounds.py: 142.8,
// 285.0, 284.7 us for K2 at B = 64, 32, 8, L = 64; K6 90.6, 180.7, 180.4 us
// on the int8 and bf16 units together).
//
// The kernel (hopper_tile.cuh's block: one producer warpgroup, two
// consumer warpgroups, a ring of weight stages, a persistent grid). A tile
// is 64 pair rows; both consumer warpgroups work on all of them, each on
// half of every product's output columns (64 of each 128-column chunk,
// half of o's), so every product is m64n64 with B from the ring and A from
// shared memory that both warpgroups wrote. The large products (layers 1,
// 2 and 3) run on wgmma with one group in flight; the two small ones (o =
// e.W3e and the readout, under 8% of the work) on each warp's mma.sync from
// the same swizzled panels (run_k_sync): their wgmma accumulators would
// cost ptxas the registers it needs to keep the large products
// asynchronous at 8x, where it serialized every wgmma of the kernel. Per
// tile:
//   0. the consumers gather the tile's e rows (cp.async, swizzled panels);
//   1. layer 1, chunk by chunk of 128 hidden columns: acc = e.W1e, then
//      h1 = relu(((acc + Y1_i) + Y1_j) + b1) (the JAX order; the j-side node
//      terms loaded before the chunk's products at 2x and 4x). bf16: h1
//      rounded into the h1 panels in shared memory (2x, 4x) or, at 8x where
//      64 rows of it are 196 KB, into this block's slot of a global scratch
//      in the same panel images, which the producer copies back into the
//      ring as the A operand of layer 2 (one round trip of h1, bf16). int8:
//      h1 stays fp32 until each row's amax over its 3 CZ columns is known
//      (shuffles in a quad, the two warpgroups' maxima through shared
//      memory): at 2x staged in shared memory (96 KB, the h2 staging's
//      room), at 4x and 8x the chunk products run twice, bit for bit the
//      same, the first pass only for the amax; then q1 = round-half-even(h1
//      * (127 / amax)) (an IEEE division; scale amax / 127) into int8
//      panels in shared memory;
//   2. bf16: o = e.W3e (fp32, each warpgroup its half of o's columns);
//   3. bf16: layers 2 and 3 interleaved by chunks of 128 columns of h2:
//      acc = h1.W2 (K = HID), h2 = bf16(relu(acc + b2)) into one of two
//      chunk buffers in shared memory, a barrier of both warpgroups, o +=
//      h2_chunk.W3_chunk. h2 is never whole anywhere. int8: acc = q1.W2q
//      (int32), h2 = relu(float(acc) s1 w2s + b2) (the JAX order, no FMA
//      contraction) staged in fp32, each thread reading back only what it
//      wrote: in shared memory at 2x (96 KB, so neither hidden row leaves
//      the chip), in this block's slot of a global scratch at 4x and 8x
//      (one round trip of h2, fp32); once every chunk is done, the row
//      amax as for h1, q2 into the q1 panels; then a 64-column block of o
//      at a time: o = e.W3e, then o = float(q2.W3q) s2 w3s + o (so o is not
//      held through layer 2);
//   4. ((o + Y3_i) + Y3_j) + b3, the LayerNorm over each row's CZ columns
//      (quad shuffles, then the two warpgroups' partial sums added in a
//      fixed order through shared memory, twice: mean, then the centred
//      squares), scale, bias, the pair mask s_i s_j, bf16 out into panels
//      in shared memory (over e's) and from there to device memory in
//      16-byte chunks. Where o's columns a warpgroup are many (bf16 8x,
//      int8 4x and 8x) its blocks are parked in the block's scratch slot
//      (free by then) and the LayerNorm takes them a block at a time;
//   5. with READOUT: [b | pz] = out.Wr + br from those panels (64-lane
//      blocks, one a warpgroup), through a staging in shared memory so
//      that each lane's pair rows leave as 16-byte stores, transposed as
//      (B, n_b, L, L) and (B, n_pz, L, L).
// Products of bf16 operands accumulate in fp32; LayerNorm statistics are
// fp32. The ring's stages are the weights cut into 8 KB pieces, packed once
// per set of weights by cuda_edge.kernel_operands in exactly the order the
// consumers take them (wb: steps 1-3; wrb: step 5), so the producer copies
// them one stage after another, the same for every tile. No atomics: two
// calls on the same inputs give the same bits. Pair rows are 32-bit. The
// consumer reads its thread indices and the rows' residues where it uses
// them and adds some terms in the epilogues' later passes, so that no
// instance spills (chip_smoke.py checks ptxas's report).

#pragma once

#ifdef EDGE_WIDE_STAMPS
#define TILE_STAMPS   // the ring sums its waits (hopper_tile.cuh)
#endif

#include <climits>

#include "edge_transition.cuh"
#include "hopper_tile.cuh"
#include "wide_gemm.cuh"

namespace ewide {

using namespace hopper;
using tile::PIECE;
typedef __nv_bfloat16 bf16;

constexpr int TM = 64;              // pair rows a tile
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory a block may use
constexpr int MAX_STAGES = 8;
constexpr int BAR_ID = 1;           // the consumers' named barrier (256 threads); 2, 3 a
                                    // warpgroup's own
constexpr int RO_LD = 72;           // rows of a readout lane in the staging (64 + 8: 16-byte
                                    // aligned, two-way bank conflicts at most)

// Built with -DEDGE_WIDE_STAMPS (a diagnostic build: pepflowww_torch.edge_stages),
// consumer thread 0 of each block sums the SM clock cycles of each stage of
// its tiles and the cycles it waited for full ring slots, and leaves them
// in g_stamps[block][N_STAMPS] (edge_wide_read_stamps copies them out).
#ifdef EDGE_WIDE_STAMPS
constexpr int N_STAMPS = 10;   // e gather, layer 1, e.W3e, hidden, q2 + q2.W3q, LN, readout,
                               // waits, tiles, spare
constexpr int MAX_BLOCKS = 1024;
__device__ long long g_stamps[MAX_BLOCKS * N_STAMPS];
#define STAMP(k)                          \
  do {                                    \
    const long long now_ = clock64();     \
    stamps[k] += now_ - last_;            \
    last_ = now_;                         \
  } while (0)
#else
#define STAMP(k) \
  do {           \
  } while (0)
#endif

struct Args {
  const bf16* edge;          // [M][CZ]
  const float* mask;         // [B L]
  const float* y;            // [B L][8 CZ]: Y1_i | Y1_j | Y3_i | Y3_j
  const unsigned char* wb;   // stages of steps 1-3
  const unsigned char* wrb;  // stages of the readout (READOUT only)
  const float* b1;
  const float* b2;
  const float* b3;
  const float* ln_s;
  const float* ln_b;
  const float* bro;          // [ro_pad] (READOUT only)
  const float* w2s;          // int8 only: column scales of W2q, W3q
  const float* w3s;
  void* scratch;             // 8x bf16: h1 images; int8 4x, 8x: h2 fp32; a slot a block
  bf16* out;
  bf16* b_out;
  bf16* pz_out;
  int L, total, n_b, n_pz, nrp;   // nrp: stage pairs of 128 readout lanes
  float eps;
};

template <int CZ, bool INT8>
struct Cfg {
  static constexpr int HID = 3 * CZ, NY = 8 * CZ;
  static constexpr int NJ = CZ / 128;       // o's 64-column blocks a consumer warpgroup owns
  static constexpr int KE = CZ / 64;        // K panels of e and of out (bf16)
  static constexpr int NC = HID / 128;      // hidden chunks of 128 columns
  static constexpr int KH = INT8 ? HID / 128 : HID / 64;   // K panels of a hidden row
  static constexpr bool STREAM_H1 = !INT8 && CZ == 512;
  static constexpr bool H2_GLOBAL = INT8 && CZ > 128;
  // int8: h1 is staged in fp32 beside h2's staging where that is in shared
  // memory (2x); at 4x and 8x its chunk products run twice instead.
  static constexpr bool RECOMPUTE_H1 = H2_GLOBAL;
  static constexpr int A_BYTES = STREAM_H1 ? PIECE : 0;    // a stage's A piece
  static constexpr int STAGE = A_BYTES + 2 * PIECE;
  // Per-tile stages: bf16: layer 1, o = e.W3e, then per chunk KH of W2 and
  // 2 NJ of W3; int8: layer 1 (twice where RECOMPUTE_H1), NC KH of W2q, then
  // per block of o KE of W3e and KH of W3q.
  static constexpr int N_L1 = NC * KE, N_O = NJ * KE;
  static constexpr int N_MAIN = INT8 ? (RECOMPUTE_H1 ? 2 : 1) * N_L1 + N_O + NC * KH + NJ * KH
                                     : N_L1 + N_O + NC * (KH + 2 * NJ);
  // Shared memory (bytes): e (and later out) panels, the hidden panels
  // (bf16 h1 unless streamed; int8 q1, then q2), the h2 buffers (bf16: two
  // chunks of two panels; int8 at 2x: the fp32 staging), the ring, the
  // exchange rows and the barriers.
  static constexpr int E = 0;
  static constexpr int H = E + KE * PIECE;
  static constexpr int H_BYTES = STREAM_H1 ? 0 : KH * PIECE;
  static constexpr int H2 = H + H_BYTES;
  static constexpr int H2_BYTES = INT8 ? (H2_GLOBAL ? 0 : TM * HID * 4) : 4 * PIECE;
  static constexpr int RING = H2 + H2_BYTES;
  // The readout's staging, 2 x 64 lanes x RO_LD rows bf16 (18 KB), over
  // buffers free by then: the h2 chunks (bf16), the h2 staging (int8 2x)
  // or the q2 panels (int8 4x, 8x).
  static constexpr int RO_STAGE = INT8 && H2_GLOBAL ? H : H2;
  static_assert((INT8 && H2_GLOBAL ? H_BYTES : H2_BYTES) >= 2 * 64 * RO_LD * 2,
                "room for the readout's staging");
  static constexpr int FIXED = RING + 2048 + 256;
  static constexpr int NSTAGE =
      (SMEM_LIMIT - FIXED) / STAGE < MAX_STAGES ? (SMEM_LIMIT - FIXED) / STAGE : MAX_STAGES;
  static constexpr int RED = RING + NSTAGE * STAGE;   // [4][2][64] fp32
  static constexpr int BAR = RED + 2048;
  static constexpr int BYTES = BAR + 256;
  // Scratch a block: 8x bf16 h1 panel images; int8 4x, 8x fp32 h2.
  static constexpr long long SCRATCH =
      STREAM_H1 ? (long long)KH * PIECE : H2_GLOBAL ? (long long)TM * HID * 4 : 0;
  static_assert(H % 1024 == 0 && H2 % 1024 == 0 && RING % 1024 == 0 && STAGE % 1024 == 0,
                "swizzled panels start on 1024-byte boundaries");
  static_assert(NSTAGE >= 3, "a ring of at least three stages");
  static_assert(BYTES <= SMEM_LIMIT, "more shared memory than a block may use");
};

// The tile's pair rows [row0, row0 + 64) of e into the swizzled panels at
// `dst` (panel p: columns 64p .. 64p + 63), by the 256 consumer threads
// (`ct`): 16-byte copies, consecutive threads along a row; rows past
// `total` zero-filled.
template <int CZ>
__device__ __forceinline__ void gather_e(uint32_t dst, const bf16* __restrict__ edge, int row0,
                                         int total, int ct) {
  constexpr int CPR = CZ / 8;   // 16-byte chunks a row
#pragma unroll
  for (int t = 0; t < TM * CPR / 256; ++t) {
    const int v = ct + 256 * t, r = v / CPR, c = v % CPR;
    const bool ok = row0 + r < total;
    cp_async16(dst + (c >> 3) * PIECE + sw128_offset(r, c & 7),
               edge + (size_t)(ok ? row0 + r : 0) * CZ + c * 8, ok);
  }
}

// Byte offset of bf16 columns 8 jj + 2q, +1 of row r in a 64-column panel.
__device__ __forceinline__ uint32_t bf16_at(int r, int jj, int q) {
  return (uint32_t)(r * 128 + ((jj ^ (r & 7)) << 4) + 4 * q);
}
// Byte offset of int8 column c (0..127) of row r in a 128-column panel.
__device__ __forceinline__ uint32_t s8_at(int r, int c) {
  return (uint32_t)(r * 128 + ((((c >> 4) ^ (r & 7))) << 4) + (c & 15));
}

// threadIdx.x, read where it is used: an asm volatile, so the compiler
// neither keeps it (nor what is derived from it) in a register across a
// long stretch of code nor moves it.
__device__ __forceinline__ int tid_x() {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;\n" : "=r"(t));
  return t;
}

// Four 8x8 bf16 matrices from shared memory (rows at the lanes' addresses).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}
__device__ __forceinline__ void st_shared_u16(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(addr), "h"((unsigned short)v) : "memory");
}

// A pair row's residue rows b L + i and b L + j (both 0 past `total`, whose
// rows store nothing).
__device__ __forceinline__ int2 residues(int row, int total, int L) {
  if (row >= total) return make_int2(0, 0);
  const int LL = L * L, b = row / LL, rem = row - b * LL, i = rem / L;
  return make_int2(b * L + i, b * L + (rem - i * L));
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The row values of the two warpgroups, exchanged through `red` ([2][64]
// fp32 in shared memory): this warpgroup's value of tile row r is written
// by lane q == 0, then, after the consumers' barrier, warpgroup 0's and
// warpgroup 1's are combined in that order (sum or max).
template <bool MAX>
__device__ __forceinline__ float2 exchange(float* red, int cw, int r, int q, float va, float vb) {
  if (q == 0) {
    red[cw * TM + r] = va;
    red[cw * TM + r + 8] = vb;
  }
  named_bar(BAR_ID, 256);
  const float a0 = red[r], a1 = red[TM + r], b0 = red[r + 8], b1 = red[TM + r + 8];
  return MAX ? make_float2(fmaxf(a0, a1), fmaxf(b0, b1)) : make_float2(a0 + a1, b0 + b1);
}

// Keeps the compiler from moving memory accesses across this point: an
// unrolled epilogue then loads one block of values at a time instead of
// hoisting every load, which would take the registers that o and the
// products hold.
__device__ __forceinline__ void fence_compiler() { asm volatile("" ::: "memory"); }

// ((v + Y_i) + Y_j) + bias of two adjacent columns: the JAX order.
__device__ __forceinline__ float2 sum3(float v0, float v1, float2 yi, float2 yj, float2 bb) {
  return make_float2(__fadd_rn(__fadd_rn(__fadd_rn(v0, yi.x), yj.x), bb.x),
                     __fadd_rn(__fadd_rn(__fadd_rn(v1, yi.y), yj.y), bb.y));
}
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// The node terms of a thread's columns c = cb + 8 jj, +1 (jj < 8) in its
// rows a and b (yi_*, yj_*: the rows' Y_i and Y_j at cb): the j-side rows,
// a different residue for each pair row of a tile, loaded ahead of the
// product they follow so that their latency overlaps it; the i-side row
// (one residue for a tile's pair rows at L >= 64, which the L1 cache holds)
// and the bias (a small vector) read where they are added.
struct Terms {
  float2 yja[8], yjb[8];
  const float *yia, *yib, *bias;
  __device__ __forceinline__ void load(const float* yi_a, const float* yj_a, const float* yi_b,
                                       const float* yj_b, const float* b) {
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      yja[jj] = ld2(yj_a + 8 * jj);
      yjb[jj] = ld2(yj_b + 8 * jj);
    }
    yia = yi_a;
    yib = yi_b;
    bias = b;
  }
  // ((v + Y_i) + Y_j) + bias of columns jj, row a (r = 0) or b (r = 1).
  __device__ __forceinline__ float2 sum(float v0, float v1, int jj, int r) const {
    return sum3(v0, v1, ld2((r ? yib : yia) + 8 * jj), r ? yjb[jj] : yja[jj],
                __ldg(reinterpret_cast<const float2*>(bias + 8 * jj)));
  }
  // h1 before rounding or quantization: relu of the sum. One function for
  // both int8 passes, so they compute the same bits.
  __device__ __forceinline__ float2 h1(float v0, float v1, int jj, int r) const {
    const float2 h = sum(v0, v1, jj, r);
    return make_float2(fmaxf(h.x, 0.f), fmaxf(h.y, 0.f));
  }
};

// o's block (an m64n64 accumulator) plus the node terms and bias of its
// columns (as Terms), loaded here, a column pair at a time, or taken from
// `pre` where it was loaded ahead.
__device__ __forceinline__ void add_terms(float (&o)[32], const float* yi_a, const float* yj_a,
                                          const float* yi_b, const float* yj_b, const float* bias,
                                          const Terms* pre) {
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    if (!pre) fence_compiler();   // a column pair's terms at a time
    float2 a, b;
    if (pre) {
      a = pre->sum(o[4 * jj], o[4 * jj + 1], jj, 0);
      b = pre->sum(o[4 * jj + 2], o[4 * jj + 3], jj, 1);
    } else {
      const float2 bb = __ldg(reinterpret_cast<const float2*>(bias + 8 * jj));
      a = sum3(o[4 * jj], o[4 * jj + 1], ld2(yi_a + 8 * jj), ld2(yj_a + 8 * jj), bb);
      b = sum3(o[4 * jj + 2], o[4 * jj + 3], ld2(yi_b + 8 * jj), ld2(yj_b + 8 * jj), bb);
    }
    o[4 * jj] = a.x;
    o[4 * jj + 1] = a.y;
    o[4 * jj + 2] = b.x;
    o[4 * jj + 3] = b.y;
  }
}

// float(n) s w, the JAX dequantization (the int32 sum rounded to nearest,
// then two products, no FMA contraction).
__device__ __forceinline__ float dequant(int n, float s, float w) {
  return __fmul_rn(__fmul_rn(__int2float_rn(n), s), w);
}

// A thread's values of o's block j parked in device memory: float4 [block]
// [8 jj][256 consumer threads], so a warp's accesses are 512 contiguous bytes.
__device__ __forceinline__ void park_store(float4* park, int j, int ct, const float (&v)[32]) {
#pragma unroll
  for (int jj = 0; jj < 8; ++jj)
    park[(j * 8 + jj) * 256 + ct] =
        make_float4(v[4 * jj], v[4 * jj + 1], v[4 * jj + 2], v[4 * jj + 3]);
}
__device__ __forceinline__ void park_load(const float4* park, int j, int ct, float (&v)[32]) {
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const float4 x = park[(j * 8 + jj) * 256 + ct];
    v[4 * jj] = x.x;
    v[4 * jj + 1] = x.y;
    v[4 * jj + 2] = x.z;
    v[4 * jj + 3] = x.w;
  }
}

// round-half-even(h inv) as an int8 in the low byte: |h inv| <= 127.5, and x +
// 1.5 2^23 rounds x to an integer, ties to even, as __float2int_rn does, for
// |x| < 2^22, leaving the integer's two's-complement low byte in the sum's
// (edge_transition.cuh round_low_byte), without the conversion units.
__device__ __forceinline__ int quant(float h, float inv) {
  return __float_as_int(__fadd_rn(__fmul_rn(h, inv), 12582912.f));
}

// A thread's fp32 values of a hidden row, columns 8 jj + 2q, +1 of chunk c,
// rows a and b, in the staging that only this thread (ct) reads back: float2
// [chunk][16][256 threads], so a warp's accesses are 256 contiguous bytes.
__device__ __forceinline__ void stage(float2* st, int c, int jj, int ct, float2 ha, float2 hb) {
  st[(c * 16 + 2 * jj) * 256 + ct] = ha;
  st[(c * 16 + 2 * jj + 1) * 256 + ct] = hb;
}
__device__ __forceinline__ void unstage(const float2* st, int c, int jj, int ct, float2& ha,
                                        float2& hb) {
  ha = st[(c * 16 + 2 * jj) * 256 + ct];
  hb = st[(c * 16 + 2 * jj + 1) * 256 + ct];
}

// q = round-half-even(h inv) of columns cc, cc + 1 (of a 128-column int8
// panel at `panel`) of rows r and r + 8, stored as int8 pairs.
__device__ __forceinline__ void quantize(uint32_t panel, int cc, int r, float2 ha, float2 hb,
                                         float inva, float invb) {
  st_shared_u16(panel + s8_at(r, cc),
                (quant(ha.x, inva) & 0xff) | ((quant(ha.y, inva) & 0xff) << 8));
  st_shared_u16(panel + s8_at(r + 8, cc),
                (quant(hb.x, invb) & 0xff) | ((quant(hb.y, invb) & 0xff) << 8));
}

// The K loop of one m64n64 product over NK stages of a tile::Ring (whose
// stages hold an A piece of A_BYTES, then one B piece a consumer
// warpgroup): A at a_addr(k, slot), B this warpgroup's piece of the stage;
// one wgmma group in flight while the next stage is awaited, each stage
// freed once its group is done. The forward's tile kernel (Kernel below)
// and the wide backward's chain kernel (edge_transition_bwd.cu) run their
// products through it.
template <bool I8, int NK, int A_BYTES, class Ring, class Acc, class AAddr>
__device__ __forceinline__ void ring_product(Acc (&acc)[32], Ring& ring, int cw, AAddr a_addr,
                                             bool accumulate) {
  int prev = 0;
#pragma unroll 1
  for (int k = 0; k < NK; ++k) {
    const int s = ring.acquire();
    const uint32_t b = ring.stage(s) + A_BYTES + cw * PIECE, a = a_addr(k, s);
    wgmma_fence();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int sc = (k > 0 || i > 0 || accumulate) ? 1 : 0;
      if constexpr (I8)
        tile::mma_ss_s8_n64(acc, desc_sw128(a + 32 * i), desc_sw128(b + 32 * i), sc);
      else
        mma_ss_n64(acc, desc_sw128(a + 32 * i), desc_sw128(b + 32 * i), sc);
    }
    wgmma_commit();
    if (k > 0) {
      tile::wgmma_wait<1>();
      ring.release(prev);
    }
    prev = s;
  }
  tile::wgmma_wait<0>();
  fence_regs(acc);
  ring.release(prev);
}

// d = A . B, one warp's m16n8k16 product with C = 0: d is only written, so
// that no zero fill of it need precede the product.
__device__ __forceinline__ void mma_m16n8k16_start(float (&d)[4], const uint32_t (&a)[4],
                                                   uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7},"
      " {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

// The same product with each warp's own mma.sync m16n8k16 (its 16 rows,
// operands through ldmatrix from the swizzled panels), leaving the m64n64
// accumulator layout: used for the small products (the forward's o = e.W3e
// and readout, the backward's d_edge = do.W3e^T), whose wgmma would cost the
// compiler the accumulator registers it needs to keep the large products
// asynchronous at 8x. acc starts at 0; with START the first step's products
// start it (the backward: a zero fill before them was hoisted far up and
// held acc's registers through the steps before).
template <int NK, int A_BYTES, bool START = false, class Ring, class AAddr>
__device__ __forceinline__ void ring_product_sync(float (&acc)[32], Ring& ring, int cw,
                                                  AAddr a_addr) {
  const int lane = threadIdx.x & 31, ar = 16 * ((threadIdx.x >> 5) & 3) + (lane & 15);
  const int bn = (lane & 7) + ((lane >> 4) << 3), bk = (lane >> 3) & 1;
  // One stage's products; `first`: the first step's start acc.
  const auto step = [&](int k, bool first) {
    const int s = ring.acquire();
    const uint32_t b = ring.stage(s) + A_BYTES + cw * PIECE, a = a_addr(k, s);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t af[4];
      ldsm_x4(af, a + ar * 128 + (((2 * kk + (lane >> 4)) ^ (ar & 7)) << 4));
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        const int n = 16 * np + bn;
        uint32_t bf[4];
        ldsm_x4(bf, b + n * 128 + (((2 * kk + bk) ^ (n & 7)) << 4));
        if (first && kk == 0) {
          mma_m16n8k16_start(*reinterpret_cast<float(*)[4]>(&acc[8 * np]), af, bf[0], bf[1]);
          mma_m16n8k16_start(*reinterpret_cast<float(*)[4]>(&acc[8 * np + 4]), af, bf[2], bf[3]);
        } else {
          mma_m16n8k16(*reinterpret_cast<float(*)[4]>(&acc[8 * np]), af, bf[0], bf[1]);
          mma_m16n8k16(*reinterpret_cast<float(*)[4]>(&acc[8 * np + 4]), af, bf[2], bf[3]);
        }
      }
    }
    ring.release(s);
  };
  if constexpr (START) {
    step(0, true);   // peeled, so that no path reads acc before it is written
#pragma unroll 1
    for (int k = 1; k < NK; ++k) step(k, false);
  } else {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
#pragma unroll 1
    for (int k = 0; k < NK; ++k) step(k, false);
  }
}

template <int CZ, bool INT8, bool READOUT>
struct Kernel {
  using C = Cfg<CZ, INT8>;
  using Ring = tile::Ring<C::NSTAGE, C::STAGE, C::RING, C::BAR>;
  // Node terms loaded ahead of the product they follow where registers allow:
  // layer 1's up to 4x, o's at 2x (one block of o).
  static constexpr bool PREFETCH_H1 = C::NJ <= 2, PREFETCH_O = C::NJ == 1;
  static constexpr int Y3I = 2 * C::HID, Y3J = 2 * C::HID + CZ;   // Y3_i, Y3_j in a Y row
  // Where o's columns a warpgroup are many (bf16 8x, int8 4x and 8x), its
  // finished blocks are parked in the scratch slot for the LayerNorm, which
  // takes them a block at a time (registers for the rest).
  static constexpr bool PARK = INT8 ? C::NJ > 1 : C::NJ > 2;
  static_assert(!PARK || C::SCRATCH >= (long long)TM * CZ * 4, "room to park o");

  template <bool I8, int NK, class Acc, class AAddr>
  static __device__ __forceinline__ void run_k(Acc (&acc)[32], Ring& ring, int cw, AAddr a_addr,
                                               bool accumulate) {
    ring_product<I8, NK, C::A_BYTES>(acc, ring, cw, a_addr, accumulate);
  }
  template <int NK, class AAddr>
  static __device__ __forceinline__ void run_k_sync(float (&acc)[32], Ring& ring, int cw,
                                                    AAddr a_addr) {
    ring_product_sync<NK, C::A_BYTES>(acc, ring, cw, a_addr);
  }

  // The producer's one thread: every tile's stages, in the consumers' order.
  static __device__ __forceinline__ void produce(const Args& a, Ring& ring, int ntiles) {
    int it = 0;
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x, ++it) {
      const unsigned char* w = a.wb;
      auto copy_b = [&](int n) {
        for (int i = 0; i < n; ++i) {
          const int s = ring.claim(2 * PIECE);
          tile::bulk_copy(ring.stage(s) + C::A_BYTES, w, 2 * PIECE, ring.full(s));
          w += 2 * PIECE;
        }
      };
      if constexpr (C::STREAM_H1) {
        copy_b(C::N_L1 + C::N_O);
        tile::mbar_wait(ring.ready(), it & 1);   // this tile's h1 is in the scratch
        const unsigned char* h1 =
            static_cast<const unsigned char*>(a.scratch) + blockIdx.x * C::SCRATCH;
        for (int c = 0; c < C::NC; ++c) {
          for (int k = 0; k < C::KH; ++k) {
            const int s = ring.claim(C::STAGE);
            tile::bulk_copy(ring.stage(s), h1 + k * PIECE, PIECE, ring.full(s));
            tile::bulk_copy(ring.stage(s) + PIECE, w, 2 * PIECE, ring.full(s));
            w += 2 * PIECE;
          }
          copy_b(2 * C::NJ);
        }
      } else {
        copy_b(C::N_MAIN);
      }
      if (READOUT) {
        w = a.wrb;
        copy_b(a.nrp * C::KE);
      }
    }
  }

  // The two consumer warpgroups (cw = 0, 1): every tile of this block.
  static __device__ __forceinline__ void consume(const Args& a, Ring& ring, unsigned char* smem,
                                                 uint32_t base) {
    // The thread's indices, read afresh where they are used (tid_x), so
    // that no register holds them through a tile: the consumer thread
    // (0..255), its warpgroup, its thread in the warpgroup, its quad lane
    // and its two tile rows 16 w + g and + 8.
    const auto ct = [] { return tid_x() - 128; };
    const auto cw = [] { return (tid_x() - 128) >> 7; };
    const auto wt = [] { return tid_x() & 127; };
    const auto q = [] { return tid_x() & 3; };
    const auto ra = [] { return 16 * ((tid_x() >> 5) & 3) + ((tid_x() & 31) >> 2); };
    const auto rb = [] { return 16 * ((tid_x() >> 5) & 3) + ((tid_x() & 31) >> 2) + 8; };
    const auto red = [=] { return reinterpret_cast<float*>(smem + C::RED); };
    const uint32_t E = base + C::E, H = base + C::H;
#ifdef EDGE_WIDE_STAMPS
    long long stamps[N_STAMPS] = {}, last_ = clock64();
#endif
    for (int t = blockIdx.x; t < (a.total + TM - 1) / TM; t += gridDim.x) {
      const int row0 = t * TM;
      named_bar(BAR_ID, 256);   // the last tile's readers of every buffer are done
      gather_e<CZ>(E, a.edge, row0, a.total, ct());
      cp_async_commit();
      // This thread's rows' residue rows; their node terms Y1_i, Y1_j at
      // columns c (yi, yj below), Y3_i, Y3_j at 2 HID + c and 2 HID + CZ + c.
      // The rows' residue rows, computed where used (a few integer
      // operations) rather than held through the tile's products.
      const auto na = [&] { return residues(t * TM + ra(), a.total, a.L); };
      const auto nb = [&] { return residues(t * TM + rb(), a.total, a.L); };
      const auto yi = [&](int n, int c) { return a.y + (size_t)n * C::NY + c; };
      cp_async_wait_all();
      fence_proxy_async();
      named_bar(BAR_ID, 256);
      STAMP(0);
      const auto e_panel = [&](int k, int) { return E + k * PIECE; };
      // At 8x o's finished blocks wait for the LayerNorm in this block's
      // scratch slot (int8: over h2's staging, read by then; bf16: over h1's
      // panel images, copied by then), this thread's values only.
      const auto slot = [&] {
        return static_cast<unsigned char*>(a.scratch) + blockIdx.x * C::SCRATCH;
      };
      const auto park = [&] { return reinterpret_cast<float4*>(slot()); };
      // int8: the fp32 staging of a hidden row, this thread's values.
      const auto st = [&] {
        return reinterpret_cast<float2*>(C::H2_GLOBAL ? slot() : smem + C::H2);
      };

      // 1. Layer 1, a chunk of 64 columns a warpgroup at a time: its node
      // terms and bias are loaded before its products, which hide their
      // latency.
      float s1a = 0.f, s1b = 0.f;   // int8: q1's row scales
      float inva = 0.f, invb = 0.f;
      constexpr int PASSES = C::RECOMPUTE_H1 ? 2 : 1;
#pragma unroll 1
      for (int pass = 0; pass < PASSES; ++pass) {
        float ma = 0.f, mb = 0.f;
#pragma unroll 1
        for (int c1 = 0; c1 < C::NC; ++c1) {
          const int cb = c1 * 128 + cw() * 64 + 2 * q();
          Terms tm;
          const auto load = [&] {
            const int2 ia = na(), ib = nb();
            tm.load(yi(ia.x, cb), yi(ia.y, C::HID + cb), yi(ib.x, cb), yi(ib.y, C::HID + cb),
                    a.b1 + cb);
          };
          if (PREFETCH_H1) load();
          float acc[32];
          run_k<false, C::KE>(acc, ring, cw(), e_panel, false);
          if (!PREFETCH_H1) load();
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const float2 ha = tm.h1(acc[4 * jj], acc[4 * jj + 1], jj, 0);
            const float2 hb = tm.h1(acc[4 * jj + 2], acc[4 * jj + 3], jj, 1);
            if constexpr (INT8) {
              if (pass == 0) {
                ma = fmaxf(ma, fmaxf(ha.x, ha.y));
                mb = fmaxf(mb, fmaxf(hb.x, hb.y));
                if (!C::RECOMPUTE_H1) stage(st(), c1, jj, ct(), ha, hb);
              } else {
                quantize(H + c1 * PIECE, cw() * 64 + 8 * jj + 2 * q(), ra(), ha, hb, inva, invb);
              }
            } else if constexpr (C::STREAM_H1) {
              unsigned char* p = static_cast<unsigned char*>(a.scratch) + blockIdx.x * C::SCRATCH +
                                 (2 * c1 + cw()) * PIECE;
              *reinterpret_cast<uint32_t*>(p + bf16_at(ra(), jj, q())) = pack_bf16(ha.x, ha.y);
              *reinterpret_cast<uint32_t*>(p + bf16_at(rb(), jj, q())) = pack_bf16(hb.x, hb.y);
            } else {
              const uint32_t p = H + (2 * c1 + cw()) * PIECE;
              st_shared_u32(p + bf16_at(ra(), jj, q()), pack_bf16(ha.x, ha.y));
              st_shared_u32(p + bf16_at(rb(), jj, q()), pack_bf16(hb.x, hb.y));
            }
          }
        }
        if constexpr (INT8) {
          if (pass == 0) {
            const float2 m = exchange<true>(red(), cw(), ra(), q(), quad_max(ma), quad_max(mb));
            inva = m.x > 0.f ? __fdiv_rn(127.f, m.x) : 0.f;
            invb = m.y > 0.f ? __fdiv_rn(127.f, m.y) : 0.f;
            s1a = __fdiv_rn(m.x, 127.f);
            s1b = __fdiv_rn(m.y, 127.f);
          }
        }
      }
      if constexpr (INT8 && !C::RECOMPUTE_H1) {
#pragma unroll 1
        for (int c1 = 0; c1 < C::NC; ++c1)
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            fence_compiler();
            float2 ha, hb;
            unstage(st(), c1, jj, ct(), ha, hb);
            quantize(H + c1 * PIECE, cw() * 64 + 8 * jj + 2 * q(), ra(), ha, hb, inva, invb);
          }
      }
      if constexpr (C::STREAM_H1) {
        tile::fence_proxy_async_global();
        tile::mbar_arrive(ring.ready());   // the producer copies it back as layer 2's A
      } else {
        fence_proxy_async();
      }
      STAMP(1);

      // 2. o = e.W3e, this warpgroup's NJ blocks of 64 columns (int8: in
      // step 3, each block just before its q2.W3q, so that o is not held
      // through layer 2).
      float o[C::NJ][32];
      if constexpr (!INT8) {
#pragma unroll
        for (int j = 0; j < C::NJ; ++j) run_k_sync<C::KE>(o[j], ring, cw(), e_panel);
      }
      named_bar(BAR_ID, 256);   // both halves of h1 (q1) are in place
      STAMP(2);

      // 3. The hidden layers. Each of o's blocks j takes its node terms and
      // b3 after its last product: ((o + Y3_i) + Y3_j) + b3, the terms
      // loaded before that product where registers allow (one block of o,
      // 2x), else after it.
      const auto ob = [&] { return cw() * (CZ / 2) + 2 * q(); };   // o's column of block 0, jj 0
      if constexpr (INT8) {
        const auto q_panel = [&](int k, int) { return H + k * PIECE; };
        float ma = 0.f, mb = 0.f;
#pragma unroll 1
        for (int c2 = 0; c2 < C::NC; ++c2) {
          const int cb = c2 * 128 + cw() * 64 + 2 * q();
          int acc[32];
          run_k<true, C::KH>(acc, ring, cw(), q_panel, false);
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            fence_compiler();
            const float2 ws = __ldg(reinterpret_cast<const float2*>(a.w2s + cb + 8 * jj));
            const float2 bb = __ldg(reinterpret_cast<const float2*>(a.b2 + cb + 8 * jj));
            const float2 ha =
                make_float2(fmaxf(__fadd_rn(dequant(acc[4 * jj], s1a, ws.x), bb.x), 0.f),
                            fmaxf(__fadd_rn(dequant(acc[4 * jj + 1], s1a, ws.y), bb.y), 0.f));
            const float2 hb =
                make_float2(fmaxf(__fadd_rn(dequant(acc[4 * jj + 2], s1b, ws.x), bb.x), 0.f),
                            fmaxf(__fadd_rn(dequant(acc[4 * jj + 3], s1b, ws.y), bb.y), 0.f));
            ma = fmaxf(ma, fmaxf(ha.x, ha.y));
            mb = fmaxf(mb, fmaxf(hb.x, hb.y));
            stage(st(), c2, jj, ct(), ha, hb);
          }
        }
        STAMP(3);
        // Every product on q1 is done in both warpgroups (the exchange's
        // barrier): q2 takes its panels.
        const float2 m =
            exchange<true>(red() + 2 * TM, cw(), ra(), q(), quad_max(ma), quad_max(mb));
        const float i2a = m.x > 0.f ? __fdiv_rn(127.f, m.x) : 0.f;
        const float i2b = m.y > 0.f ? __fdiv_rn(127.f, m.y) : 0.f;
        const float s2a = __fdiv_rn(m.x, 127.f), s2b = __fdiv_rn(m.y, 127.f);
#pragma unroll 1
        for (int c2 = 0; c2 < C::NC; ++c2) {
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            fence_compiler();
            float2 ha, hb;
            unstage(st(), c2, jj, ct(), ha, hb);
            quantize(H + c2 * PIECE, cw() * 64 + 8 * jj + 2 * q(), ra(), ha, hb, i2a, i2b);
          }
        }
        fence_proxy_async();
        named_bar(BAR_ID, 256);
#pragma unroll
        for (int j = 0; j < C::NJ; ++j) {
          const int cb = ob() + 64 * j;
          Terms tm;
          if (PREFETCH_O) {
            const int2 ia = na(), ib = nb();
            tm.load(yi(ia.x, Y3I + cb), yi(ia.y, Y3J + cb), yi(ib.x, Y3I + cb), yi(ib.y, Y3J + cb),
                    a.b3 + cb);
          }
          run_k_sync<C::KE>(o[j], ring, cw(), e_panel);
          int acc[32];
          run_k<true, C::KH>(acc, ring, cw(), q_panel, false);
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            fence_compiler();
            const float2 ws = __ldg(reinterpret_cast<const float2*>(a.w3s + cb + 8 * jj));
            o[j][4 * jj] = __fadd_rn(dequant(acc[4 * jj], s2a, ws.x), o[j][4 * jj]);
            o[j][4 * jj + 1] = __fadd_rn(dequant(acc[4 * jj + 1], s2a, ws.y), o[j][4 * jj + 1]);
            o[j][4 * jj + 2] = __fadd_rn(dequant(acc[4 * jj + 2], s2b, ws.x), o[j][4 * jj + 2]);
            o[j][4 * jj + 3] = __fadd_rn(dequant(acc[4 * jj + 3], s2b, ws.y), o[j][4 * jj + 3]);
          }
          {
            const int2 ia = na(), ib = nb();
            add_terms(o[j], yi(ia.x, Y3I + cb), yi(ia.y, Y3J + cb), yi(ib.x, Y3I + cb),
                      yi(ib.y, Y3J + cb), a.b3 + cb, PREFETCH_O ? &tm : nullptr);
          }
          if constexpr (PARK) park_store(park(), j, ct(), o[j]);
        }
      } else {
        const uint32_t H2 = base + C::H2;
#pragma unroll 1
        for (int c2 = 0; c2 < C::NC; ++c2) {
          const int cb = c2 * 128 + cw() * 64 + 2 * q();
          float acc[32];
          if constexpr (C::STREAM_H1)
            run_k<false, C::KH>(acc, ring, cw(), [&](int, int s) { return ring.stage(s); }, false);
          else
            run_k<false, C::KH>(acc, ring, cw(), [&](int k, int) { return H + k * PIECE; }, false);
          const uint32_t buf = H2 + (c2 & 1) * 2 * PIECE;
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const float2 bb = __ldg(reinterpret_cast<const float2*>(a.b2 + cb + 8 * jj));
            st_shared_u32(buf + cw() * PIECE + bf16_at(ra(), jj, q()),
                          pack_bf16_relu(acc[4 * jj] + bb.x, acc[4 * jj + 1] + bb.y));
            st_shared_u32(buf + cw() * PIECE + bf16_at(rb(), jj, q()),
                          pack_bf16_relu(acc[4 * jj + 2] + bb.x, acc[4 * jj + 3] + bb.y));
          }
          fence_proxy_async();
          named_bar(BAR_ID, 256);   // the chunk's two halves are in place
          const auto h2_panel = [&](int k, int) { return buf + k * PIECE; };
          // The terms after the last chunk, here unless o is parked (then the
          // LayerNorm's first pass adds them, a block at a time).
          const bool last = !PARK && c2 + 1 == C::NC;
#pragma unroll
          for (int j = 0; j < C::NJ; ++j) {
            const int cb3 = ob() + 64 * j;
            Terms tm;
            if (PREFETCH_O && last) {
              const int2 ia = na(), ib = nb();
              tm.load(yi(ia.x, Y3I + cb3), yi(ia.y, Y3J + cb3), yi(ib.x, Y3I + cb3),
                      yi(ib.y, Y3J + cb3), a.b3 + cb3);
            }
            run_k<false, 2>(o[j], ring, cw(), h2_panel, true);
            if (last) {
              fence_compiler();
              const int2 ia = na(), ib = nb();
              add_terms(o[j], yi(ia.x, Y3I + cb3), yi(ia.y, Y3J + cb3), yi(ib.x, Y3I + cb3),
                        yi(ib.y, Y3J + cb3), a.b3 + cb3, PREFETCH_O ? &tm : nullptr);
            }
          }
        }
      }
      STAMP(INT8 ? 4 : 3);

      // 4. LayerNorm over each row's CZ columns, affine, pair mask, bf16: o
      // a block at a time (at 8x from its parking slot) in three passes.
      if constexpr (!INT8 && PARK)
#pragma unroll
        for (int j = 0; j < C::NJ; ++j) park_store(park(), j, ct(), o[j]);
      const auto block = [&](int j, float (&v)[32]) {
        if constexpr (PARK) {
          fence_compiler();
          park_load(park(), j, ct(), v);
        } else {
#pragma unroll
          for (int i = 0; i < 32; ++i) v[i] = o[j][i];
        }
      };
      float sa = 0.f, sb = 0.f;
#pragma unroll
      for (int j = 0; j < C::NJ; ++j) {
        float v[32];
        block(j, v);
        if constexpr (!INT8 && PARK) {   // ((o + Y3_i) + Y3_j) + b3, parked again
          const int cb3 = ob() + 64 * j;
          const int2 ia = na(), ib = nb();
          add_terms(v, yi(ia.x, Y3I + cb3), yi(ia.y, Y3J + cb3), yi(ib.x, Y3I + cb3),
                    yi(ib.y, Y3J + cb3), a.b3 + cb3, nullptr);
          park_store(park(), j, ct(), v);
        }
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          sa += v[4 * jj] + v[4 * jj + 1];
          sb += v[4 * jj + 2] + v[4 * jj + 3];
        }
      }
      const float2 mu =
          exchange<false>(red() + 4 * TM, cw(), ra(), q(), quad_sum(sa), quad_sum(sb));
      const float mua = mu.x * (1.f / CZ), mub = mu.y * (1.f / CZ);
      float qa = 0.f, qb = 0.f;
#pragma unroll
      for (int j = 0; j < C::NJ; ++j) {
        float v[32];
        block(j, v);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const float d0 = v[4 * jj] - mua, d1 = v[4 * jj + 1] - mua;
          const float d2 = v[4 * jj + 2] - mub, d3 = v[4 * jj + 3] - mub;
          qa += d0 * d0 + d1 * d1;
          qb += d2 * d2 + d3 * d3;
        }
      }
      const float2 var =
          exchange<false>(red() + 6 * TM, cw(), ra(), q(), quad_sum(qa), quad_sum(qb));
      const float rsa = rsqrtf(var.x * (1.f / CZ) + a.eps);
      const float rsb = rsqrtf(var.y * (1.f / CZ) + a.eps);
      // bf16(out) into panels over e's (free since step 2), then to device
      // memory a 16-byte chunk a thread, each row's panels whole sectors.
      const int2 ia = na(), ib = nb();
      const float pma = row0 + ra() < a.total ? a.mask[ia.x] * a.mask[ia.y] : 0.f;
      const float pmb = row0 + rb() < a.total ? a.mask[ib.x] * a.mask[ib.y] : 0.f;
#pragma unroll
      for (int j = 0; j < C::NJ; ++j) {
        float v[32];
        block(j, v);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          fence_compiler();   // a column pair's loads at a time
          const int c = ob() + 64 * j + 8 * jj;
          const float2 ls = __ldg(reinterpret_cast<const float2*>(a.ln_s + c));
          const float2 lb = __ldg(reinterpret_cast<const float2*>(a.ln_b + c));
          const uint32_t ya = pack_bf16(((v[4 * jj] - mua) * rsa * ls.x + lb.x) * pma,
                                        ((v[4 * jj + 1] - mua) * rsa * ls.y + lb.y) * pma);
          const uint32_t yb = pack_bf16(((v[4 * jj + 2] - mub) * rsb * ls.x + lb.x) * pmb,
                                        ((v[4 * jj + 3] - mub) * rsb * ls.y + lb.y) * pmb);
          const uint32_t p = E + (cw() * C::NJ + j) * PIECE;
          st_shared_u32(p + bf16_at(ra(), jj, q()), ya);
          st_shared_u32(p + bf16_at(rb(), jj, q()), yb);
        }
      }
      fence_proxy_async();   // the readout's products read these panels
      named_bar(BAR_ID, 256);
#pragma unroll 4
      for (int v = ct(); v < TM * CZ / 8; v += 256) {
        const int r = v / (CZ / 8), c = v % (CZ / 8);
        if (row0 + r < a.total) {
          uint4 x;
          asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                       : "=r"(x.x), "=r"(x.y), "=r"(x.z), "=r"(x.w)
                       : "r"(E + (c >> 3) * PIECE + sw128_offset(r, c & 7)));
          *reinterpret_cast<uint4*>(a.out + (size_t)(row0 + r) * CZ + c * 8) = x;
        }
      }
      STAMP(5);

      // 5. The readout: lanes (2 rp + cw) 64 .. + 63 of [b | pz], through
      // this warpgroup's staging [64 lanes][RO_LD rows] bf16 so that each
      // lane's rows leave as 16-byte stores along the contiguous (i, j).
      if (READOUT) {
        const int LL = a.L * a.L, nro = a.n_b + a.n_pz;
        bf16* stg = reinterpret_cast<bf16*>(smem + C::RO_STAGE) + cw() * 64 * RO_LD;
#pragma unroll 1
        for (int rp = 0; rp < a.nrp; ++rp) {
          const int c0 = (2 * rp + cw()) * 64;
          float r[32];
          run_k_sync<C::KE>(r, ring, cw(), e_panel);
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const int l = 8 * jj + 2 * q() + u;
              const float bu = c0 + l < nro ? __ldg(a.bro + c0 + l) : 0.f;
              stg[l * RO_LD + ra()] = __float2bfloat16(r[4 * jj + u] + bu);
              stg[l * RO_LD + rb()] = __float2bfloat16(r[4 * jj + 2 + u] + bu);
            }
          named_bar(2 + cw(), 128);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int v = wt() + 128 * k, l = v >> 3, s8 = (v & 7) * 8, c = c0 + l;
            if (c < nro) {
              const uint4 val = *reinterpret_cast<const uint4*>(stg + l * RO_LD + s8);
              if (c < a.n_b) edge::store_readout(a.b_out, a.n_b, c, val, row0 + s8, a.total, LL);
              else edge::store_readout(a.pz_out, a.n_pz, c - a.n_b, val, row0 + s8, a.total, LL);
            }
          }
          named_bar(2 + cw(), 128);
        }
      }
      STAMP(6);
#ifdef EDGE_WIDE_STAMPS
      stamps[8] += 1;
#endif
    }
#ifdef EDGE_WIDE_STAMPS
    stamps[7] = ring.waited;
    if (ct() == 0 && blockIdx.x < MAX_BLOCKS)
      for (int k = 0; k < N_STAMPS; ++k) g_stamps[blockIdx.x * N_STAMPS + k] = stamps[k];
#endif
  }
};

template <int CZ, bool INT8, bool READOUT>
__global__ void __launch_bounds__(tile::NTHREADS, 1)
edge_wide_kernel(const __grid_constant__ Args a) {
  using K = Kernel<CZ, INT8, READOUT>;
  using C = typename K::C;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  typename K::Ring ring{base};
  if (threadIdx.x == 0) {
    if (base & 1023) __trap();   // the swizzle is taken from the address bits
    for (int s = 0; s < C::NSTAGE; ++s) {
      tile::mbar_init(ring.full(s), 1);
      tile::mbar_init(ring.empty(s), tile::EMPTY_ARRIVALS);
    }
    tile::mbar_init(ring.ready(), 256);
    tile::mbar_fence_init();
  }
  __syncthreads();
  const int ntiles = (a.total + TM - 1) / TM;
  if (tile::warpgroup_index() == 0) {   // the producer warpgroup: one thread copies
    tile::setmaxnreg_dec<tile::PRODUCER_REGS>();
    if (threadIdx.x == 0) K::produce(a, ring, ntiles);
  } else {
    tile::setmaxnreg_inc<tile::CONSUMER_REGS>();
    K::consume(a, ring, smem, base);
  }
}

template <int CZ, bool INT8, bool READOUT>
static int launch_tile(const Args& a, int grid, cudaStream_t st) {
  using C = Cfg<CZ, INT8>;
  static bool opt_in[wide::MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  auto kernel = edge_wide_kernel<CZ, INT8, READOUT>;
  if (!opt_in[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES);
    if (err != cudaSuccess) return (int)err;
    opt_in[dev] = true;
  }
  kernel<<<grid, tile::NTHREADS, C::BYTES, st>>>(a);
  return wide::launched();
}

// The persistent grid of a call: one block an SM at most.
static inline int grid_of(int B, int L, int* grid) {
  static int sms[wide::MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= wide::MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  const long long tiles = ((long long)B * L * L + TM - 1) / TM;
  *grid = (int)(tiles < sms[dev] ? tiles : sms[dev]);
  return 0;
}

// Bytes of scratch a call needs beside y (0 where nothing round-trips; -1
// when the device cannot be read).
template <bool INT8>
static int scratch_bytes(int cz, int B, int L) {
  int grid = 0;
  if (grid_of(B, L, &grid) != 0) return -1;
  const long long per = cz == 128   ? Cfg<128, INT8>::SCRATCH
                        : cz == 256 ? Cfg<256, INT8>::SCRATCH
                                    : Cfg<512, INT8>::SCRATCH;
  return (int)(per * grid);
}

template <bool INT8>
static int smem_bytes(int cz) {
  return cz == 128   ? Cfg<128, INT8>::BYTES
         : cz == 256 ? Cfg<256, INT8>::BYTES
                     : Cfg<512, INT8>::BYTES;
}

// Whether wb holds the N_MAIN stages the producer copies each tile and,
// with the readout, wrb its nrp * KE (bytes as the caller allocated them).
template <int CZ, bool INT8>
static bool stages_fit(long long wb_bytes, long long wrb_bytes, int nrp, bool readout) {
  using C = Cfg<CZ, INT8>;
  return wb_bytes == (long long)C::N_MAIN * 2 * PIECE &&
         (!readout || wrb_bytes == (long long)nrp * C::KE * 2 * PIECE);
}

// One call: the node pre-pass, then the tile kernel (two device kernels).
// Refuses (cudaErrorInvalidValue) weight stages of another length than the
// kernel's schedule reads.
template <bool INT8>
static int forward(Args a, const void* node, const void* wn, int B, int L, int cz, int ro_pad,
                   long long wb_bytes, long long wrb_bytes, cudaStream_t st) {
  const long long total = (long long)B * L * L;
  if (total > INT_MAX) return (int)cudaErrorInvalidValue;   // pair rows are 32-bit
  if (cz != 128 && cz != 256 && cz != 512) return (int)cudaErrorInvalidValue;
  a.nrp = (ro_pad + 127) / 128;
  const bool ro = a.b_out != nullptr;
  const bool fit = cz == 128   ? stages_fit<128, INT8>(wb_bytes, wrb_bytes, a.nrp, ro)
                   : cz == 256 ? stages_fit<256, INT8>(wb_bytes, wrb_bytes, a.nrp, ro)
                               : stages_fit<512, INT8>(wb_bytes, wrb_bytes, a.nrp, ro);
  if (!fit) return (int)cudaErrorInvalidValue;
  if (total == 0) return 0;
  wide::Epi e{};
  e.f32 = const_cast<float*>(a.y);
  e.ld_f32 = 8 * cz;
  WIDE_TRY((wide::gemm<128, 128, false, wide::F32>(wide::opd(wide::seg(node, cz)),
                                                   wide::opd(wide::seg(wn, cz)), B * L, 8 * cz,
                                                   cz, 0, L, e, st)));
  int grid = 0;
  WIDE_TRY(grid_of(B, L, &grid));
  a.L = L;
  a.total = (int)total;
  if (ro) {
    if (cz == 128) return launch_tile<128, INT8, true>(a, grid, st);
    if (cz == 256) return launch_tile<256, INT8, true>(a, grid, st);
    return launch_tile<512, INT8, true>(a, grid, st);
  }
  if (cz == 128) return launch_tile<128, INT8, false>(a, grid, st);
  if (cz == 256) return launch_tile<256, INT8, false>(a, grid, st);
  return launch_tile<512, INT8, false>(a, grid, st);
}

}  // namespace ewide
