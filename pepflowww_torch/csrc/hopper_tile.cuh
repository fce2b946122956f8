// The Hopper tile core (sm_90a) of the wide EdgeTransition forwards (K1/K2
// in edge_transition.cu, K6 in edge_transition_int8.cu, both through
// edge_wide.cuh) and of its backward's chain kernel (K4,
// edge_transition_bwd.cu): warp specialisation, a weight ring in shared memory
// guarded by mbarriers, 1-D bulk asynchronous copies and the int8 wgmma
// with both operands in shared memory. Built on wgmma.cuh.
//
// The block. One producer warpgroup and two consumer warpgroups (384
// threads). The producer gives its registers up (setmaxnreg.dec to 24) and
// only its first thread works: it walks the weights' stages, the same
// schedule every tile, and copies each into the next free slot of the
// ring. The consumers take the registers (setmaxnreg.inc to 240), wait for
// a slot to fill, run their products on it and free it. The grid is
// persistent: at most one block an SM, each walking pair tiles blockIdx.x,
// blockIdx.x + gridDim.x, ..., so the producer runs ahead into the next
// tile's first stages while the consumers finish this tile's epilogue.
//
// The ring. NSTAGE slots of STAGE bytes; slot s has a full barrier (one
// arrival, the producer's arrive.expect_tx, plus the copy's bytes) and an
// empty barrier (EMPTY_ARRIVALS = 8: lane 0 of each consumer warp once the
// warpgroup's products on the slot are complete). The producer waits for
// slot s to be empty with the parity of its previous use (the first round
// passes at once), the consumers wait for it to be full with the parity of
// this use. A stage is one contiguous image of pieces that the wrapper
// packed once per set of weights (cuda_edge.kernel_operands), so one bulk
// copy fills it: a piece is 64 rows (output columns) by 128 bytes of K (64
// bf16 or 128 int8), in the 128-byte swizzled K-major layout that the
// wgmma descriptors name (wgmma.cuh: chunk c of row r at chunk c ^ (r % 8),
// 1024-byte aligned), 8 KB. A stage holds the piece of consumer warpgroup
// 0, then that of warpgroup 1, after an optional A piece (8 KB) that the
// producer copies from elsewhere (the 8x kernels' hidden rows).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "wgmma.cuh"

namespace tile {

using hopper::smem_u32;

constexpr int PIECE = 64 * 128;          // bytes of a piece: 64 rows x 128 bytes
constexpr int CONSUMERS = 2;             // consumer warpgroups a block
constexpr int NTHREADS = 128 * (1 + CONSUMERS);
constexpr int EMPTY_ARRIVALS = 4 * CONSUMERS;
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// Makes the barriers' initialisation visible to the async proxy (the bulk
// copies' completions); a block barrier must follow.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// Waits until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// `bytes` (a multiple of 16) from global `src` (16-byte aligned) to shared
// `dst`, completing on barrier `bar` (which expects them).
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Makes this thread's generic-proxy writes to global memory visible to
// later async-proxy reads (a bulk copy issued after a barrier).
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// The index of this thread's warpgroup, read so that the compiler knows it
// is the same in every lane of a warp (a role branch on it is then taken by
// whole warps, and setmaxnreg's register counts hold in each role).
__device__ __forceinline__ int warpgroup_index() {
  return __shfl_sync(0xffffffffu, (int)(threadIdx.x >> 7), 0);
}

// Waits until at most N committed wgmma groups are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d = A . B (+ d when scale_d), m64n64k32, int8 x int8 -> int32, both
// operands from shared memory, K-major (desc_sw128).
__device__ __forceinline__ void mma_ss_s8_n64(int (&d)[32], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8\n"
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(scale_d)
      : "memory");
}

// The ring as one side sees it: the next slot it takes and the parity of
// that slot's current round. `base` is the shared address of the block's
// dynamic shared memory; the slots lie at RING_OFF (STAGE bytes each), the
// full barriers at BAR_OFF, the empty ones after them (8 bytes each).
template <int NSTAGE, int STAGE, int RING_OFF, int BAR_OFF>
struct Ring {
  uint32_t base;
  uint32_t state = 0;   // the next slot, and the parity of its round in bit 8
#ifdef TILE_STAMPS
  long long waited = 0;   // cycles this thread spent waiting for full slots
#endif

  __device__ __forceinline__ uint32_t full(int s) const { return base + BAR_OFF + 8 * s; }
  __device__ __forceinline__ uint32_t empty(int s) const {
    return base + BAR_OFF + 8 * (NSTAGE + s);
  }
  // A further barrier after the empty ones, for the kernel's own use (at 8x
  // "this tile's hidden row is in device memory", which the producer copies
  // back).
  __device__ __forceinline__ uint32_t ready() const { return base + BAR_OFF + 16 * NSTAGE; }
  __device__ __forceinline__ uint32_t stage(int s) const { return base + RING_OFF + s * STAGE; }
  __device__ __forceinline__ int slot() const { return state & 0xff; }
  __device__ __forceinline__ uint32_t phase() const { return state >> 8; }
  __device__ __forceinline__ void advance() {
    state = slot() + 1 == NSTAGE ? (state & 0x100) ^ 0x100 : state + 1;
  }
  // Consumer: waits for the next slot to fill and returns its index.
  __device__ __forceinline__ int acquire() {
    const int s = slot();
#ifdef TILE_STAMPS
    const long long t0 = clock64();
    mbar_wait(full(s), phase());
    waited += clock64() - t0;
#else
    mbar_wait(full(s), phase());
#endif
    advance();
    return s;
  }
  // Consumer: slot s is free again (the warpgroup's products on it are
  // complete); lane 0 of each warp arrives.
  __device__ __forceinline__ void release(int s) const {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty(s));
  }
  // Producer: waits for the next slot to be free, announces `bytes` on its
  // full barrier and returns its index (the caller issues the copies).
  __device__ __forceinline__ int claim(uint32_t bytes) {
    const int s = slot();
    mbar_wait(empty(s), phase() ^ 1u);
    mbar_arrive_tx(full(s), bytes);
    advance();
    return s;
  }
};

}  // namespace tile
