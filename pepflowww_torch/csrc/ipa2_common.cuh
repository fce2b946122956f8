// Shared pieces of the fused IPA interior kernels (ipa2.cu, ipa2_bwd.cu):
// the widths and the input layout. The Hopper pieces (64-row swizzled
// tiles, point fetches, frames) are in ipa2_tile.cuh.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace ipa2 {

typedef __nv_bfloat16 bf16;

constexpr int C = 128;          // scalar channels per head
constexpr int PQ = 8;           // query / key points per head
constexpr int PV = 12;          // value points per head
constexpr int CZ4 = 16;         // pair readout channels
constexpr int P3Q = 3 * PQ;
constexpr int P3V = 3 * PV;
constexpr unsigned FULL = 0xffffffffu;

// Element strides of the inputs that may arrive as permuted views:
// qp, kvp (b, h, coordinate, l, p), bias (b, h, i, j), pz (b, i, j, d).
struct Layout {
  long long qp[5], kvp[5], bias[4], pz[4];
};

__device__ __forceinline__ float bf2f(bf16 x) { return __bfloat162float(x); }

}  // namespace ipa2
