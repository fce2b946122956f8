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
// the global timer at its stage boundaries (ipa2_forward_stamps). The
// pieces of steps 2-5 and the shared-memory layout up to the frames are in
// ipa2_tile.cuh (namespace ipa2::fwd), shared with the v1 attention core
// (ipa1.cu, K9).

#include "ipa2_tile.cuh"

namespace {

using namespace ipa2;
using namespace hopper;
using namespace ipa2::fwd;

constexpr int OFF_RT = OFF_OWN;                    // f32 [64][12]: R, t of the query rows
constexpr int OFF_RK = OFF_RT + TQ * 12 * 4;       // f32 [64][12]: R, t of the key rows (L > 64)
constexpr int OFF_PZ = OFF_RK + TQ * 12 * 4;       // [2 slots][8 items][128 threads][16 B]
constexpr int SMEM_BYTES = OFF_PZ + 2 * SLOT;
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
      store_key_points(kg_s, ksq_s, ar, kg);
    } else if (values) {
      float vg[P3V];
      to_global<PV>(rk, rk_rows + ar * 12, vg, 1.f);
      store_value_points(vg_s, ar, vg);
    }
  };

  // The logits of the loaded key tile in the accumulator layout.
  auto logits = [&](float (&s)[32], int j0, int nk) {
    qk_product(s, q_s, k_s);
    logit_terms<BIAS_ROWS>(s, j0, nk, q, ra, rb, bias_s, bias_a, bias_b, stb[3], kg_s, ksq_s,
                           mb_s, qga, qgb, qsqa, qsqb, s1, s2);
  };
  // The pair chunk kc of key tile j0 into the slot at `off` (pair ring).
  auto copy_pair = [&](int kc, int off, int j0, int nk) {
    fwd::copy_pair<PZ>(base, kc, off, j0, nk, nq, tid, ar, ah, pz_row, stz, a.pz);
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
    copy_pair(0, slot_at(0, true, OFF_PZ), 0, nk0);
    cp_async_commit();
    copy_pair(1, slot_at(1, true, OFF_PZ), 0, nk0);
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

  // Row i of this head's o in o_feats' layout is at o_rows + i * HC.
  float* const o_rows = a.o + (long long)b * L * HC + h * C;

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
    if (single)
      softmax_tile(s, ma, la, mb, lb);
    else
      softmax_from(s, ma, la, mb, lb);
    mark(7);

    // o += bf16(a).V; after the first key tile o is taken back from the
    // output, where the tile before left it (so that no accumulator stays
    // live across tiles).
    float o0[32], o1[32];
    if (t > 0) load_o(o0, o1, o_rows, HC, i0, nq, q, ra, rb);
    uint32_t ha[16];
    av_issue(o0, o1, ha, s, v_s, t > 0);
    __syncthreads();   // all logits taken: K, the bias tile and, for L <= 64, Q are free
    const int nslot = single ? 4 : 3;
    if (single) copy_pair(2, slot_at(2, true, OFF_PZ), j0, nk);
    if (single) cp_async_commit();
    store_weights(a_s, s, q, ra, rb);
    av_wait(o0, o1, ha);
    __syncthreads();   // the weights and the value points are complete; V has been read
    copy_pair(nslot - 1, slot_at(nslot - 1, single, OFF_PZ), j0, nk);
    cp_async_commit();
    store_o(o0, o1, o_rows, HC, i0, L, q, ra, rb);   // its stores overlap the aggregations
    mark(8);

    if (t == 0) {
#pragma unroll
      for (int x = 0; x < 18; ++x) pacc[x] = 0.f;
#pragma unroll
      for (int d = 0; d < 8; ++d) zacc[d] = 0.f;
    }
    pair_sums<PZ>(base, smem, OFF_PZ, single, j0, nk, nq, tid, ar, ah, a_s, vg_s, pz_row, stz,
                  a.pz, pacc, zacc);
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
      copy_pair(0, slot_at(0, false, OFF_PZ), j0, nk);
      cp_async_commit();
      copy_pair(1, slot_at(1, false, OFF_PZ), j0, nk);
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
