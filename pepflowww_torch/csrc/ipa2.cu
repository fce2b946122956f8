// Fused IPA interior (v2), forward, for Hopper, sm_90a.
//
// Replaces: pepflowww_tpu/models/pallas_ipa2.py::fused_ipa2 (body `_fwd_kernel`).
//
// Per batch row b and head h, with the frames R, t of each residue:
//   qg, kg = (R x + t) * sw_h for the local query / key points, vg = R x + t
//   s[i, j] = q_i.k_j / sqrt(3C) + bias[h, i, j] / sqrt(3)
//             - (|qg_i|^2 + |kg_j|^2 - 2 qg_i.kg_j) / 2 + maskb[j]
//   a = softmax_j(s)                                               (fp32)
//   o[i]     = sum_j bf16(a[i, j]) v_j                              (C = 128)
//   optl[i]  = R_i^T (sum_j a[i, j] vg_j - t_i), norm = sqrt(sum_c optl_c^2 + eps)
//   opair[i] = sum_j a[i, j] pz[i, j]                               (CZ4 = 16)
// written as fp32 into o_feats' pieces: o (B, L, H*C), optl (B, L, 3*H*PV)
// as [x | y | z] blocks, norm (B, L, H*PV), opair (B, L, H*CZ4).
//
// What bounds it on this card: the bytes of the function (its bf16 inputs
// and fp32 outputs, ~69 MB at B=64, L=64: ~20.5 us at 3.35 TB/s). Its two
// 128-deep products (q.k and a.v, ~0.27 G bf16 MACs) take ~0.5 us on the
// tensor cores, its fp32 work (the 24-deep point term, the 36 point and 16
// pair aggregation columns, the softmax: ~0.18 G ops) ~3 us on the fp32
// units. Beyond the bytes, the pair tile pz[b, i, j, :] is read by each of
// the H heads' blocks (8.4 MB at B=64, L=64, so ~67 MB from L2 in all), and
// a block's loads come in bursts between its compute stages.
//
// Design: one block of one warpgroup (128 threads) per (b, h, 64 query
// rows); keys in tiles of 64. Per key tile:
//   1. The points' and frames' loads go first (the frames of the tile's 64
//      rows as contiguous spans, the points as vectors), then Q (once), K
//      and V rows (256 contiguous bytes each) by cp.async 16-byte copies
//      into 128-byte swizzled panels (wgmma.cuh); in the sampler's layout
//      the bias tile too (rows of 64 contiguous keys), in any other layout
//      the logits read the bias through its strides. Each key row's points
//      are moved to the global frame once (kg with |kg|^2, vg).
//   2. S = Q.K^T on wgmma (m64n64k16 x 8, both operands K-major from
//      shared memory). The point term, the bias, the mask and the scales
//      are added in the accumulator layout on the CUDA cores in fp32, with
//      the thread's two query rows' qg in registers; keys past the ragged
//      edge get -inf.
//   3. The softmax in registers: a row's 64 logits lie on the four threads
//      of a quad, so its max and sum take two shuffles each. For L <= 64
//      the row is whole, and a is normalized before any product with v, at
//      the JAX kernel's rounding point, in one pass over the keys. For
//      L > 64 a first pass takes the logits alone (no v, vg or pair loads)
//      for each row's max and sum, so the rounding point stays the same.
//   4. o += bf16(a).V on wgmma (m64n64k16 x 4 for each half of C): the
//      packed bf16 pairs of the accumulator's blocks 2s, 2s+1 are the A
//      fragment of depth step s, and V, rows j with channels contiguous, is
//      the MN-major B operand read with the transpose-B immediate. o goes
//      to the output at once, four channels a store; a later key tile takes
//      it back from there, so no accumulator stays live across tiles.
//   5. The fp32 a goes to shared memory; thread (row, half) sums its 18
//      point columns and 8 pair channels over the keys. The pair tile
//      streams through a per-thread ring of 8-key chunks, each copied by
//      the thread that reads it (16-byte cp.async: 8 keys of one channel
//      plane in the sampler's pz layout, 8 channels of one key in
//      training's), so no barrier guards it: two slots of its own, whose
//      copies overlap steps 1-4, then Q's panels (L <= 64) and V's once the
//      products have read them.
// No (L, L) matrix is stored. 115,200 bytes of shared memory: two blocks an
// SM. Variants, chosen from the strides and alignment of the call: the
// sampler's layout, training's, and strided loads for any other; each for
// one key tile (L <= 64) or several. Built with -DIPA2_STAMPS (a
// diagnostic build, pepflowww_torch/ipa2_stages.py), the kernel records
// the global timer at its stage boundaries (ipa2_forward_stamps).

#include "ipa2_tile.cuh"

namespace {

using namespace ipa2;
using namespace hopper;

constexpr int LDB = TQ + 8;              // bf16 row stride of the bias tile
constexpr int LDA = TQ + 8;              // fp32 row stride of the weights
constexpr int LDK = 28;                  // fp32 row stride of the key points
constexpr int LDV = 40;                  // fp32 row stride of the value points: halves at 0, 20
constexpr int CHUNK = 8;                 // keys of a pair chunk
constexpr int NCHUNK = TQ / CHUNK;
constexpr int SLOT = 8 * NTH * 16;       // one chunk: eight 16-byte items a thread

enum PairMode { PZ_J = 0, PZ_D = 1, PZ_ANY = 2 };

constexpr int OFF_Q = 0;                           // bf16 panels [2][64][128 B]
constexpr int OFF_V = OFF_Q + TILE_BYTES;          // bf16 panels [2][64][128 B]
constexpr int OFF_K = OFF_V + TILE_BYTES;          // bf16 panels [2][64][128 B]
constexpr int OFF_BIAS = OFF_K + TILE_BYTES;       // bf16 [64][LDB]
constexpr int OFF_A = OFF_K;                       // f32 [64][LDA], over K and the bias
constexpr int OFF_KG = OFF_BIAS + TQ * LDB * 2;    // f32 [64][LDK]
constexpr int OFF_VG = OFF_KG + TQ * LDK * 4;      // f32 [64][LDV]; at the end the point sums
constexpr int OFF_KSQ = OFF_VG + TQ * LDV * 4;     // f32 [64]
constexpr int OFF_MB = OFF_KSQ + TQ * 4;           // f32 [64]
constexpr int OFF_RT = OFF_MB + TQ * 4;            // f32 [64][12]: R, t of the query rows
constexpr int OFF_RK = OFF_RT + TQ * 12 * 4;       // f32 [64][12]: R, t of the key rows (L > 64)
constexpr int OFF_PZ = OFF_RK + TQ * 12 * 4;       // [2 slots][8 items][128 threads][16 B]
constexpr int SMEM_BYTES = OFF_PZ + 2 * SLOT;
static_assert(TQ * LDA * 4 <= OFF_KG - OFF_A, "the weights fit over K and the bias tile");
static_assert(OFF_V % 1024 == 0 && OFF_K % 1024 == 0, "swizzled panels on 1024-byte boundaries");
static_assert(2 * (SMEM_BYTES + 1024) <= 233472, "two blocks an SM");

#ifdef IPA2_STAMPS
constexpr int N_STAMPS = 11;
#endif

struct FwdArgs {
  const bf16 *q, *kv, *qp, *kvp, *bias, *pz;
  const float *r9, *t, *maskb, *sw;
  float *o, *optl, *norm, *opair;
#ifdef IPA2_STAMPS
  long long* stamps;
#endif
  Layout st;
  int L, H;
  bool qp_vec, kvp_vec;
  float eps, s1, s2;
};

// One row's running max and sum of exp (m, l) updated with its 16 logits
// in this thread (accumulator entries 4j + 2 half + 0..1) and the other
// three of its quad.
__device__ __forceinline__ void row_update(const float (&s)[32], int half, float& m, float& l) {
  float tm = -INFINITY;
#pragma unroll
  for (int j = 0; j < 8; ++j) tm = fmaxf(tm, fmaxf(s[4 * j + 2 * half], s[4 * j + 2 * half + 1]));
  tm = fmaxf(tm, __shfl_xor_sync(FULL, tm, 1));
  tm = fmaxf(tm, __shfl_xor_sync(FULL, tm, 2));
  const float mn = fmaxf(m, tm);
  float sum = 0.f;
  if (mn != -INFINITY) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      sum += expf(s[4 * j + 2 * half] - mn) + expf(s[4 * j + 2 * half + 1] - mn);
  }
  sum += __shfl_xor_sync(FULL, sum, 1);
  sum += __shfl_xor_sync(FULL, sum, 2);
  l = (m == -INFINITY ? 0.f : l * expf(m - mn)) + sum;
  m = mn;
}

// MULTI: L > 64 (several key tiles, two passes); a separate instantiation,
// so that the one-tile path of the sampler's L is compiled for its own
// registers.
template <bool BIAS_ROWS, int PZ, bool MULTI>
__global__ void __launch_bounds__(NTH) ipa2_fwd_kernel(const FwdArgs a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  if (base & 1023) __trap();   // the swizzle is taken from the address bits
  const uint32_t q_s = base + OFF_Q, v_s = base + OFF_V, k_s = base + OFF_K;
  const bf16* bias_s = reinterpret_cast<const bf16*>(smem + OFF_BIAS);
  float* a_s = reinterpret_cast<float*>(smem + OFF_A);
  float* kg_s = reinterpret_cast<float*>(smem + OFF_KG);
  float* vg_s = reinterpret_cast<float*>(smem + OFF_VG);
  float* ksq_s = reinterpret_cast<float*>(smem + OFF_KSQ);
  float* mb_s = reinterpret_cast<float*>(smem + OFF_MB);
  float* rt_s = reinterpret_cast<float*>(smem + OFF_RT);
  float* rk_s = reinterpret_cast<float*>(smem + OFF_RK);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int ra = 16 * warp + g, rb = ra + 8;   // this thread's rows of the accumulators
  const int ar = tid >> 1, ah = tid & 1;       // its row and half in the aggregations
  const int b = blockIdx.z, h = blockIdx.y, i0 = blockIdx.x * TQ;
  const int L = a.L, H = a.H;
  const int nq = min(TQ, L - i0);
  const int ntiles = MULTI ? (L + TQ - 1) / TQ : 1;
  const float sw = a.sw[h], s1 = a.s1, s2 = a.s2;
  const long long HC = (long long)H * C;
  const bf16* kv_b = a.kv + (long long)b * L * 2 * HC + 2LL * h * C;
  const long long* stb = a.st.bias;
  const long long* stz = a.st.pz;
  // The bias rows of ra, rb (strided variant; rows past the edge read row i0).
  const bf16* bias_bh = a.bias + b * stb[0] + h * stb[1];
  const bf16* bias_a = bias_bh + (long long)(i0 + (ra < nq ? ra : 0)) * stb[2];
  const bf16* bias_b = bias_bh + (long long)(i0 + (rb < nq ? rb : 0)) * stb[2];
  const bf16* pz_row = a.pz + b * stz[0] + (long long)(i0 + (ar < nq ? ar : 0)) * stz[1];
  // Stamp k of this block (thread 0; a diagnostic build's stamped call).
#ifdef IPA2_STAMPS
  auto mark = [&](int k) {
    if (a.stamps && tid == 0)
      a.stamps[N_STAMPS * (((long long)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +
                           blockIdx.x) + k] = global_ns();
  };
#else
  auto mark = [](int) {};
#endif
  mark(0);

  float qga[P3Q], qgb[P3Q];   // the query points of rows ra, rb, and their squared norms
  float qsqa = 0.f, qsqb = 0.f;

  // Copies of key tile j0 (K; V with `values`; the bias tile in its row
  // variant), committed as one group.
  auto copy_keys = [&](int j0, int nk, bool values) {
    const bf16* kvb = opaque(kv_b);
    load_tile(k_s, kvb, 2 * HC, j0, nk, tid);
    if (values) load_tile(v_s, kvb + C, 2 * HC, j0, nk, tid);
    if (BIAS_ROWS) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int idx = tid + NTH * k, r = idx >> 3, c = idx & 7;
        const bool valid = r < nq && 8 * c < nk;
        const bf16* src = opaque(a.bias) + b * stb[0] + h * stb[1] +
                          (long long)(i0 + r) * stb[2] + j0 + 8 * c;
        cp_async16(base + OFF_BIAS + r * (LDB * 2) + c * 16, valid ? src : a.bias, valid);
      }
    }
    cp_async_commit();
  };
  // The key points of tile j0 (and with `values` its value points), one
  // thread a row and kind: fetched, then stored in the global frame.
  auto key_fetch = [&](RawRow& rk, int j0, int nk, bool values) {
    if (ah == 0)
      fetch_row<PQ>(rk, opaque(a.kvp), a.st.kvp, b, h, 0, j0 + ar, a.kvp_vec, ar < nk);
    else if (values)
      fetch_row<PV>(rk, opaque(a.kvp), a.st.kvp, b, h, PQ, j0 + ar, a.kvp_vec, ar < nk);
  };
  // After the frames are stored (`rk_rows`: the key rows' [row][12]).
  auto key_store = [&](const RawRow& rk, const float* rk_rows, bool values) {
    if (ah == 0) {
      float kg[P3Q];
      to_global<PQ>(rk, rk_rows + ar * 12, kg, sw);
      float sq = 0.f;
#pragma unroll
      for (int x = 0; x < P3Q; ++x) sq = fmaf(kg[x], kg[x], sq);
      float4* dst = reinterpret_cast<float4*>(kg_s + ar * LDK);
#pragma unroll
      for (int u = 0; u < P3Q / 4; ++u)
        dst[u] = make_float4(kg[4 * u], kg[4 * u + 1], kg[4 * u + 2], kg[4 * u + 3]);
      ksq_s[ar] = sq;
    } else if (values) {
      float vg[P3V];
      to_global<PV>(rk, rk_rows + ar * 12, vg, 1.f);
      float2* dst = reinterpret_cast<float2*>(vg_s + ar * LDV);
#pragma unroll
      for (int u = 0; u < 9; ++u) {
        dst[u] = make_float2(vg[2 * u], vg[2 * u + 1]);
        dst[10 + u] = make_float2(vg[18 + 2 * u], vg[19 + 2 * u]);
      }
    }
  };

  // The logits of the loaded key tile in the accumulator layout: entry
  // 4j + e (e < 2) is row ra, key 8j + 2q + e; 4j + 2 + e row rb.
  auto logits = [&](float (&s)[32], int j0, int nk) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C / 16; ++kk)
      mma_ss_n64(s, desc_sw128(q_s + (kk >> 2) * PANEL + (kk & 3) * 32),
                 desc_sw128(k_s + (kk >> 2) * PANEL + (kk & 3) * 32), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c0 = 8 * j + 2 * q;
      float2 ba = make_float2(0.f, 0.f), bb = make_float2(0.f, 0.f);
      if (BIAS_ROWS) {
        ba = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias_s + ra * LDB + c0));
        bb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias_s + rb * LDB + c0));
      } else {
        if (c0 < nk) {
          ba.x = bf2f(bias_a[(long long)(j0 + c0) * stb[3]]);
          bb.x = bf2f(bias_b[(long long)(j0 + c0) * stb[3]]);
        }
        if (c0 + 1 < nk) {
          ba.y = bf2f(bias_a[(long long)(j0 + c0 + 1) * stb[3]]);
          bb.y = bf2f(bias_b[(long long)(j0 + c0 + 1) * stb[3]]);
        }
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = c0 + e;
        if (c < nk) {
          const float4* kr = reinterpret_cast<const float4*>(kg_s + c * LDK);
          float pa = 0.f, pb = 0.f, pa2 = 0.f, pb2 = 0.f;   // two chains a row
#pragma unroll
          for (int u = 0; u < P3Q / 4; ++u) {
            const float4 k4 = kr[u];
            pa = fmaf(qga[4 * u], k4.x, pa);
            pa2 = fmaf(qga[4 * u + 1], k4.y, pa2);
            pa = fmaf(qga[4 * u + 2], k4.z, pa);
            pa2 = fmaf(qga[4 * u + 3], k4.w, pa2);
            pb = fmaf(qgb[4 * u], k4.x, pb);
            pb2 = fmaf(qgb[4 * u + 1], k4.y, pb2);
            pb = fmaf(qgb[4 * u + 2], k4.z, pb);
            pb2 = fmaf(qgb[4 * u + 3], k4.w, pb2);
          }
          pa += pa2;
          pb += pb2;
          const float ksq = ksq_s[c], mb = mb_s[c];
          s[4 * j + e] = s[4 * j + e] * s1 + (e ? ba.y : ba.x) * s2 -
                         0.5f * (qsqa + ksq - 2.f * pa) + mb;
          s[4 * j + 2 + e] = s[4 * j + 2 + e] * s1 + (e ? bb.y : bb.x) * s2 -
                             0.5f * (qsqb + ksq - 2.f * pb) + mb;
        } else {
          s[4 * j + e] = -INFINITY;
          s[4 * j + 2 + e] = -INFINITY;
        }
      }
    }
  };

  // The ring's slots (byte offsets): two of their own, then, once the tile's
  // products have read them, Q's panels (for L <= 64 only: the query tile
  // stays for later key tiles otherwise) and V's.
  auto slot_at = [&](int k, bool single) {
    return k < 2 ? OFF_PZ + k * SLOT : (k == 2 && single ? OFF_Q : OFF_V);
  };

  // The pair chunk kc of key tile j0 into the slot at `off`: this thread's
  // eight 16-byte items (sampler: keys 8kc..8kc+7 of channel plane 8ah + u;
  // training: channels 8ah..8ah+7 of key 8kc + u). Keys past nk and rows
  // past nq are zero-filled; a chunk wholly past nk is not copied.
  auto copy_pair = [&](int kc, int off, int j0, int nk) {
    if (PZ == PZ_ANY || CHUNK * kc >= nk) return;
    const uint32_t dst = base + off + tid * 16;
    const int jc = j0 + CHUNK * kc;
    const bf16* zrow = opaque(pz_row);
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      bool valid = ar < nq;
      const bf16* src;
      if (PZ == PZ_J) {
        src = zrow + jc + (long long)(8 * ah + u) * stz[3];
      } else {
        valid = valid && CHUNK * kc + u < nk;
        src = zrow + (long long)(jc + u) * stz[2] + 8 * ah;
      }
      cp_async16(dst + u * NTH * 16, valid ? src : a.pz, valid);
    }
  };

  // Row ar's weights of chunk kc against the value points (columns 18ah ..
  // 18ah + 17) and the pair channels 8ah .. 8ah + 7.
  auto consume = [&](int kc, int off, int j0, int nk, float (&pacc)[18], float (&zacc)[8]) {
    const uint4* zs = reinterpret_cast<const uint4*>(smem + off) + tid;
    const float4 a0 = *reinterpret_cast<const float4*>(a_s + ar * LDA + CHUNK * kc);
    const float4 a1 = *reinterpret_cast<const float4*>(a_s + ar * LDA + CHUNK * kc + 4);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const float* vr = vg_s + (CHUNK * kc + u) * LDV + 20 * ah;
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const float4 v = reinterpret_cast<const float4*>(vr)[x];
        pacc[4 * x] = fmaf(av[u], v.x, pacc[4 * x]);
        pacc[4 * x + 1] = fmaf(av[u], v.y, pacc[4 * x + 1]);
        pacc[4 * x + 2] = fmaf(av[u], v.z, pacc[4 * x + 2]);
        pacc[4 * x + 3] = fmaf(av[u], v.w, pacc[4 * x + 3]);
      }
      const float2 v = reinterpret_cast<const float2*>(vr)[8];
      pacc[16] = fmaf(av[u], v.x, pacc[16]);
      pacc[17] = fmaf(av[u], v.y, pacc[17]);
    }
    if (PZ == PZ_J) {
#pragma unroll
      for (int d = 0; d < 8; ++d) {
        float z[8];
        unpack8(zs[d * NTH], z);
#pragma unroll
        for (int u = 0; u < 8; ++u) zacc[d] = fmaf(av[u], z[u], zacc[d]);
      }
    } else if (PZ == PZ_D) {
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        float z[8];
        unpack8(zs[u * NTH], z);
#pragma unroll
        for (int d = 0; d < 8; ++d) zacc[d] = fmaf(av[u], z[d], zacc[d]);
      }
    } else if (ar < nq) {
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int j = CHUNK * kc + u;
        if (j < nk) {
          const bf16* zr = pz_row + (long long)(j0 + j) * stz[2] + (long long)(8 * ah) * stz[3];
#pragma unroll
          for (int d = 0; d < 8; ++d) zacc[d] = fmaf(av[u], bf2f(zr[d * stz[3]]), zacc[d]);
        }
      }
    }
  };

  // The points' and frames' loads go first, so that they do not queue
  // behind the tile copies: query rows ra, rb, row ar of the first key
  // tile, and the frames (for L <= 64 the key rows are the query rows).
  const int nk0 = min(TQ, L);
  const bool one_tile = !MULTI;
  RawRow rqa, rqb, rk0;
  fetch_row<PQ>(rqa, a.qp, a.st.qp, b, h, 0, i0 + ra, a.qp_vec, ra < nq);
  fetch_row<PQ>(rqb, a.qp, a.st.qp, b, h, 0, i0 + rb, a.qp_vec, rb < nq);
  key_fetch(rk0, 0, nk0, one_tile);
  Frames fq, fk;
  fetch_frames(fq, a.r9, a.t, one_tile ? a.maskb : nullptr, (long long)b * L + i0, nq, tid);
  if (!one_tile) fetch_frames(fk, a.r9, a.t, a.maskb, (long long)b * L, nk0, tid);
  mark(1);
  // Then the copies: the query tile, the first key tile's (their group),
  // and for L <= 64 its first two pair chunks.
  load_tile(q_s, a.q + (long long)b * L * HC + h * C, HC, i0, nq, tid);
  if (!one_tile) {
    copy_keys(0, nk0, false);
  } else {
    copy_keys(0, nk0, true);
    mark(2);
    copy_pair(0, slot_at(0, true), 0, nk0);
    cp_async_commit();
    copy_pair(1, slot_at(1, true), 0, nk0);
    cp_async_commit();
  }
  mark(3);
  // The query points of rows ra, rb in registers; the first key tile's
  // points in shared memory.
  store_frames(fq, rt_s, one_tile ? mb_s : nullptr, tid);
  if (!one_tile) store_frames(fk, rk_s, mb_s, tid);
  __syncthreads();
  mark(4);
  const float* rk_rows = one_tile ? rt_s : rk_s;
  // qg, |qg|^2 of rows ra, rb from their fetched points. For L > 64 they
  // are taken again before each key tile's logits (the loads hit L2), so
  // that no register holds them across the tile loops.
  auto query_points = [&](const RawRow& rqa, const RawRow& rqb) {
    to_global<PQ>(rqa, rt_s + ra * 12, qga, sw);
    to_global<PQ>(rqb, rt_s + rb * 12, qgb, sw);
    qsqa = qsqb = 0.f;
#pragma unroll
    for (int x = 0; x < P3Q; ++x) {
      qsqa = fmaf(qga[x], qga[x], qsqa);
      qsqb = fmaf(qgb[x], qgb[x], qsqb);
    }
  };
  auto query_points_again = [&]() {
    if (!MULTI) return;
    RawRow rqa, rqb;
    fetch_row<PQ>(rqa, opaque(a.qp), a.st.qp, b, h, 0, i0 + ra, a.qp_vec, ra < nq);
    fetch_row<PQ>(rqb, opaque(a.qp), a.st.qp, b, h, 0, i0 + rb, a.qp_vec, rb < nq);
    query_points(rqa, rqb);
  };
  if (!MULTI) query_points(rqa, rqb);
  key_store(rk0, rk_rows, one_tile);
  mark(5);

  // o: lanes q, q ^ 1 trade a pair so that each stores four contiguous
  // channels of one row (even q row ra, odd q row rb).
  auto store_o = [&](const float (&o0)[32], const float (&o1)[32]) {
    const bool odd = q & 1;
    const int i = i0 + (odd ? rb : ra);
    float* orow = a.o + ((long long)b * L + (i < L ? i : 0)) * HC + h * C + 2 * (q & 2);
    auto put = [&](const float (&o)[32], float* dst) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float y0 = __shfl_xor_sync(FULL, odd ? o[4 * j] : o[4 * j + 2], 1);
        const float y1 = __shfl_xor_sync(FULL, odd ? o[4 * j + 1] : o[4 * j + 3], 1);
        const float4 v = odd ? make_float4(y0, y1, o[4 * j + 2], o[4 * j + 3])
                             : make_float4(o[4 * j], o[4 * j + 1], y0, y1);
        if (i < L) *reinterpret_cast<float4*>(dst + 8 * j) = v;
      }
    };
    put(o0, orow);
    put(o1, orow + 64);
  };
  // The partial o of rows ra, rb back from the output (rows past the edge
  // read row i0), in the accumulator layout.
  auto load_o = [&](float (&o0)[32], float (&o1)[32]) {
    const float* pa = a.o + ((long long)b * L + i0 + (ra < nq ? ra : 0)) * HC + h * C + 2 * q;
    const float* pb = a.o + ((long long)b * L + i0 + (rb < nq ? rb : 0)) * HC + h * C + 2 * q;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 x0 = *reinterpret_cast<const float2*>(pa + 8 * j);
      const float2 x1 = *reinterpret_cast<const float2*>(pb + 8 * j);
      const float2 y0 = *reinterpret_cast<const float2*>(pa + 64 + 8 * j);
      const float2 y1 = *reinterpret_cast<const float2*>(pb + 64 + 8 * j);
      o0[4 * j] = x0.x, o0[4 * j + 1] = x0.y, o0[4 * j + 2] = x1.x, o0[4 * j + 3] = x1.y;
      o1[4 * j] = y0.x, o1[4 * j + 1] = y0.y, o1[4 * j + 2] = y1.x, o1[4 * j + 3] = y1.y;
    }
  };

  // One key tile of pass 2 (the only pass for L <= 64): its copies are in
  // flight and its points stored. The logits, the weights (with `single`
  // from the tile's own max and sum, else from pass 1's), the products and
  // the aggregations.
  float ma = -INFINITY, la = 0.f, mb = -INFINITY, lb = 0.f;
  auto tile2 = [&](int t, int j0, int nk, bool single, float (&pacc)[18], float (&zacc)[8]) {
    cp_async_wait_group<2>();   // Q, K, V and the bias; the pair chunks may still fly
    fence_proxy_async();
    __syncthreads();
    mark(6);

    query_points_again();
    float s[32];
    logits(s, j0, nk);
    if (single) {
      ma = mb = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        ma = fmaxf(ma, fmaxf(s[4 * j], s[4 * j + 1]));
        mb = fmaxf(mb, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
      ma = fmaxf(ma, __shfl_xor_sync(FULL, ma, 1));
      ma = fmaxf(ma, __shfl_xor_sync(FULL, ma, 2));
      mb = fmaxf(mb, __shfl_xor_sync(FULL, mb, 1));
      mb = fmaxf(mb, __shfl_xor_sync(FULL, mb, 2));
      la = lb = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[4 * j + e] = ma == -INFINITY ? 0.f : expf(s[4 * j + e] - ma);
          s[4 * j + 2 + e] = mb == -INFINITY ? 0.f : expf(s[4 * j + 2 + e] - mb);
          la += s[4 * j + e];
          lb += s[4 * j + 2 + e];
        }
      }
      la += __shfl_xor_sync(FULL, la, 1);
      la += __shfl_xor_sync(FULL, la, 2);
      lb += __shfl_xor_sync(FULL, lb, 1);
      lb += __shfl_xor_sync(FULL, lb, 2);
      const float inva = la > 0.f ? 1.f / la : 0.f, invb = lb > 0.f ? 1.f / lb : 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[4 * j + e] *= inva;
          s[4 * j + 2 + e] *= invb;
        }
      }
    } else {
      const float inva = la > 0.f ? 1.f / la : 0.f, invb = lb > 0.f ? 1.f / lb : 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[4 * j + e] = ma == -INFINITY ? 0.f : expf(s[4 * j + e] - ma) * inva;
          s[4 * j + 2 + e] = mb == -INFINITY ? 0.f : expf(s[4 * j + 2 + e] - mb) * invb;
        }
      }
    }
    mark(7);

    // o += bf16(a).V, A from registers, V MN-major; after the first key
    // tile o is taken back from the output, where the tile before left it
    // (so that no accumulator stays live across tiles).
    float o0[32], o1[32];
    if (t > 0) load_o(o0, o1);
    uint32_t ha[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) ha[k] = pack_bf16(s[2 * k], s[2 * k + 1]);
    wgmma_fence();
#pragma unroll
    for (int st = 0; st < TQ / 16; ++st)
      mma_rs_n64<1>(o0, &ha[4 * st], desc_sw128(v_s + st * 2048), st > 0 || t > 0);
#pragma unroll
    for (int st = 0; st < TQ / 16; ++st)
      mma_rs_n64<1>(o1, &ha[4 * st], desc_sw128(v_s + PANEL + st * 2048), st > 0 || t > 0);
    wgmma_commit();
    __syncthreads();   // all logits taken: K, the bias tile and, for L <= 64, Q are free
    const int nslot = single ? 4 : 3;
    if (single) copy_pair(2, slot_at(2, true), j0, nk);
    if (single) cp_async_commit();
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 8 * j + 2 * q;
      *reinterpret_cast<float2*>(a_s + ra * LDA + c) = make_float2(s[4 * j], s[4 * j + 1]);
      *reinterpret_cast<float2*>(a_s + rb * LDA + c) = make_float2(s[4 * j + 2], s[4 * j + 3]);
    }
    wgmma_wait_all();
    fence_regs(o0);
    fence_regs(o1);
    fence_regs(ha);
    __syncthreads();   // the weights and the value points are complete; V has been read
    copy_pair(nslot - 1, slot_at(nslot - 1, single), j0, nk);
    cp_async_commit();
    store_o(o0, o1);   // its stores overlap the aggregations
    mark(8);

    if (t == 0) {
#pragma unroll
      for (int x = 0; x < 18; ++x) pacc[x] = 0.f;
#pragma unroll
      for (int d = 0; d < 8; ++d) zacc[d] = 0.f;
    }
    for (int kc = 0; kc < NCHUNK; ++kc) {
      // Chunk kc has landed; the nslot - 1 chunks after it may still fly.
      if (single) cp_async_wait_group<3>(); else cp_async_wait_group<2>();
      const int off = slot_at(kc % nslot, single);
      if (CHUNK * kc < nk) consume(kc, off, j0, nk, pacc, zacc);
      if (kc + nslot < NCHUNK) copy_pair(kc + nslot, off, j0, nk);
      cp_async_commit();
    }
    mark(9);
    __syncthreads();   // before the next tile's copies, or the point sums, overwrite the tiles
  };

  // The pair and point outputs.
  auto outputs = [&](const float (&pacc)[18], const float (&zacc)[8]) {
    if (ar < nq) {
      float4* zrow = reinterpret_cast<float4*>(a.opair + ((long long)b * L + i0 + ar) * H * CZ4 +
                                               h * CZ4 + 8 * ah);
      zrow[0] = make_float4(zacc[0], zacc[1], zacc[2], zacc[3]);
      zrow[1] = make_float4(zacc[4], zacc[5], zacc[6], zacc[7]);
    }
    // Point outputs: the row's 36 sums meet in shared memory, then each
    // half takes 6 points back to the residue's frame, with their norms.
    float* pts = vg_s;
#pragma unroll
    for (int x = 0; x < 18; ++x) pts[ar * P3V + 18 * ah + x] = pacc[x];
    __syncthreads();
    if (ar < nq) {
      const long long row = (long long)b * L + i0 + ar;
      const float* Rr = rt_s + ar * 12;
      const float t0 = Rr[9], t1 = Rr[10], t2 = Rr[11];
      float* lrow = a.optl + row * 3 * H * PV + h * PV;
      float* nrow = a.norm + row * H * PV + h * PV;
#pragma unroll
      for (int k = 0; k < PV / 2; ++k) {
        const int p = (PV / 2) * ah + k;
        const float d0 = pts[ar * P3V + p] - t0;
        const float d1 = pts[ar * P3V + PV + p] - t1;
        const float d2 = pts[ar * P3V + 2 * PV + p] - t2;
        float nsq = a.eps;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float loc = Rr[c] * d0 + Rr[3 + c] * d1 + Rr[6 + c] * d2;
          lrow[c * H * PV + p] = loc;
          nsq += loc * loc;
        }
        nrow[p] = sqrtf(nsq);
      }
    }
  };

  if (!MULTI) {
    float pacc[18], zacc[8];
    tile2(0, 0, nk0, true, pacc, zacc);
    outputs(pacc, zacc);
  } else {
    // Pass 1: each row's max and sum of exp over all keys, from the logits alone.
    for (int t = 0; t < ntiles; ++t) {
      const int j0 = t * TQ, nk = min(TQ, L - j0);
      if (t > 0) {
        RawRow rk;
        Frames f;
        key_fetch(rk, j0, nk, false);
        fetch_frames(f, a.r9, a.t, a.maskb, (long long)b * L + j0, nk, tid);
        copy_keys(j0, nk, false);
        store_frames(f, rk_s, mb_s, tid);
        __syncthreads();
        key_store(rk, rk_s, false);
      }
      cp_async_wait_all();
      fence_proxy_async();
      __syncthreads();
      query_points_again();
      float s[32];
      logits(s, j0, nk);
      row_update(s, 0, ma, la);
      row_update(s, 1, mb, lb);
      __syncthreads();   // before the next copies overwrite K, the bias and the points
    }
    float pacc[18], zacc[8];
    for (int t = 0; t < ntiles; ++t) {
      const int j0 = t * TQ, nk = min(TQ, L - j0);
      RawRow rk;
      Frames f;
      key_fetch(rk, j0, nk, true);
      fetch_frames(f, a.r9, a.t, a.maskb, (long long)b * L + j0, nk, tid);
      copy_keys(j0, nk, true);
      copy_pair(0, slot_at(0, false), j0, nk);
      cp_async_commit();
      copy_pair(1, slot_at(1, false), j0, nk);
      cp_async_commit();
      store_frames(f, rk_s, mb_s, tid);
      __syncthreads();
      key_store(rk, rk_s, true);
      tile2(t, j0, nk, false, pacc, zacc);
    }
    outputs(pacc, zacc);
  }
  mark(10);
}

constexpr int MAX_DEVICES = 64;

template <bool BIAS_ROWS, int PZ, bool MULTI>
int launch(const FwdArgs& a, int B, cudaStream_t stream) {
  static bool opt_in[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  auto kernel = ipa2_fwd_kernel<BIAS_ROWS, PZ, MULTI>;
  if (!opt_in[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    opt_in[dev] = true;
  }
  const dim3 grid((a.L + TQ - 1) / TQ, a.H, B);
  kernel<<<grid, NTH, SMEM_BYTES, stream>>>(a);
  return (int)cudaGetLastError();
}

// The three variants: the sampler's layout (bias rows, key-contiguous pair
// chunks), training's (channel-contiguous pair chunks; its bias, h-fastest,
// read through its strides), and strided loads of both for anything else
// (a sampler's call at L % 8 != 0, or mixed layouts).
template <bool MULTI>
int dispatch(const FwdArgs& a, int B, bool rows, int mode, cudaStream_t s) {
  if (rows && mode == PZ_J) return launch<true, PZ_J, MULTI>(a, B, s);
  if (mode == PZ_D) return launch<false, PZ_D, MULTI>(a, B, s);
  return launch<false, PZ_ANY, MULTI>(a, B, s);
}

// The arguments of a call and its variant: the bias as row copies when its
// keys are contiguous in 16-byte aligned rows of whole chunks; the pair
// tile as key-contiguous chunks (PZ_J), channel-contiguous chunks (PZ_D) or
// strided loads (PZ_ANY).
FwdArgs make_args(const void* q, const void* kv, const void* qp, const void* kvp, const void* r9,
                  const void* t, const void* bias, const void* pz, const void* maskb,
                  const void* sw, void* o, void* optl, void* norm, void* opair,
                  const long long* strides, int L, int H, float eps, bool& bias_rows,
                  int& pz_mode) {
  FwdArgs a;
  a.q = static_cast<const bf16*>(q);
  a.kv = static_cast<const bf16*>(kv);
  a.qp = static_cast<const bf16*>(qp);
  a.kvp = static_cast<const bf16*>(kvp);
  a.bias = static_cast<const bf16*>(bias);
  a.pz = static_cast<const bf16*>(pz);
  a.r9 = static_cast<const float*>(r9);
  a.t = static_cast<const float*>(t);
  a.maskb = static_cast<const float*>(maskb);
  a.sw = static_cast<const float*>(sw);
  a.o = static_cast<float*>(o);
  a.optl = static_cast<float*>(optl);
  a.norm = static_cast<float*>(norm);
  a.opair = static_cast<float*>(opair);
#ifdef IPA2_STAMPS
  a.stamps = nullptr;
#endif
  for (int k = 0; k < 5; ++k) a.st.qp[k] = strides[k], a.st.kvp[k] = strides[5 + k];
  for (int k = 0; k < 4; ++k) a.st.bias[k] = strides[10 + k], a.st.pz[k] = strides[14 + k];
  a.L = L;
  a.H = H;
  a.qp_vec = a.st.qp[4] == 1 && divisible(a.st.qp, 4, 4) && aligned(qp, 8);
  a.kvp_vec = a.st.kvp[4] == 1 && divisible(a.st.kvp, 4, 4) && aligned(kvp, 8);
  a.eps = eps;
  a.s1 = 1.f / sqrtf(3.f * C);
  a.s2 = 1.f / sqrtf(3.f);
  const long long* sb = a.st.bias;
  const long long* sz = a.st.pz;
  bias_rows = sb[3] == 1 && divisible(sb, 3, 8) && L % 8 == 0 && aligned(bias, 16);
  if (sz[2] == 1 && sz[0] % 8 == 0 && sz[1] % 8 == 0 && sz[3] % 8 == 0 && L % 8 == 0 &&
      aligned(pz, 16))
    pz_mode = PZ_J;
  else if (sz[3] == 1 && divisible(sz, 3, 8) && aligned(pz, 16))
    pz_mode = PZ_D;
  else
    pz_mode = PZ_ANY;
  return a;
}

}  // namespace

// Launches the kernel on `stream`; returns the cudaError_t of the launch.
// `strides` holds the element strides of qp, kvp (5 each), bias and pz (4 each).
extern "C" int ipa2_forward(const void* q, const void* kv, const void* qp, const void* kvp,
                            const void* r9, const void* t, const void* bias, const void* pz,
                            const void* maskb, const void* sw, void* o, void* optl, void* norm,
                            void* opair, const long long* strides, int B, int L, int H, float eps,
                            void* stream) {
  if (B == 0 || L == 0) return 0;
  bool rows;
  int mode;
  const FwdArgs a = make_args(q, kv, qp, kvp, r9, t, bias, pz, maskb, sw, o, optl, norm, opair,
                              strides, L, H, eps, rows, mode);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return L > TQ ? dispatch<true>(a, B, rows, mode, s) : dispatch<false>(a, B, rows, mode, s);
}

// Dynamic shared memory a block of the kernel takes (bytes).
extern "C" int ipa2_smem_bytes() { return SMEM_BYTES; }

#ifdef IPA2_STAMPS
// The same call in the sampler's layout (bias rows, key-contiguous pair
// tile; anything else returns cudaErrorInvalidValue), with `stamps` (int64,
// 11 per block, block (x, y, z) at ((z * H + y) * tiles + x) * 11)
// receiving the global timer (ns) at: 0 the block's start, 1 the points'
// and frames' loads sent, 2 Q, K, V and the bias copies sent, 3 the
// first pair chunks sent, 4 the frames stored, 5 the points in the
// global frame, 6 the copies landed, 7 the softmax done, 8 the o product
// done, 9 the aggregations done, 10 the end (for L <= 64; entry 2 only
// there).
extern "C" int ipa2_forward_stamps(const void* q, const void* kv, const void* qp,
                                   const void* kvp, const void* r9, const void* t,
                                   const void* bias, const void* pz, const void* maskb,
                                   const void* sw, void* o, void* optl, void* norm, void* opair,
                                   const long long* strides, int B, int L, int H, float eps,
                                   void* stamps, void* stream) {
  bool rows;
  int mode;
  FwdArgs a = make_args(q, kv, qp, kvp, r9, t, bias, pz, maskb, sw, o, optl, norm, opair,
                        strides, L, H, eps, rows, mode);
  if (!rows || mode != PZ_J || B == 0) return (int)cudaErrorInvalidValue;
  a.stamps = static_cast<long long*>(stamps);
  if (L > TQ) return (int)cudaErrorInvalidValue;
  return launch<true, PZ_J, false>(a, B, static_cast<cudaStream_t>(stream));
}
#endif
