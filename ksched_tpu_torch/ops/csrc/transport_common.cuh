// Helpers shared by the transport kernels (transport.cu, transport_tiered.cu):
// the block shape, int32 arithmetic with two's-complement wrap, warp
// scans, and the excess phase both solves run before every decision.
//
// Arithmetic is int32 with wrap (the same as the plain versions' tensors),
// through unsigned adds so nothing is undefined. Sentinels match
// solver/layered.py: BIG = 1 << 30, BIG_D = 1 << 28.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kPerLane = 4;              // consecutive columns per lane
constexpr int kChunk = 32 * kPerLane;    // columns per row-sweep step
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBig = 1 << 30;
constexpr int kBigD = 1 << 28;

__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
__device__ __forceinline__ int wsub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}
// jnp.clip(x, 0, hi) == minimum(maximum(x, 0), hi)
__device__ __forceinline__ int clip0(int x, int hi) { return min(max(x, 0), hi); }

__device__ __forceinline__ int warp_sum(int v) {
  return static_cast<int>(__reduce_add_sync(kFull, static_cast<unsigned>(v)));
}

__device__ __forceinline__ int warp_incl_scan(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v = wadd(v, t);
  }
  return v;
}

// Excesses of the flow y [C, Mp] / z [Mp]: ecol = sum_c y - z per column
// (a thread per column), erow = supply - sum_m y per row (a warp per
// row), and, on the warp after the last row, esink = sum z - total.
// Returns, across the block, whether any excess is positive (kNonzero:
// whether any is nonzero).
template <bool kNonzero>
__device__ bool block_excesses(int C, int Mp, const int* y, const int* z,
                               const int* supply, int total, int* ecol,
                               int* erow, int* esink) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  bool flag = false;
  for (int m = threadIdx.x; m < Mp; m += kThreads) {
    int acc = 0;
    for (int c = 0; c < C; ++c) acc = wadd(acc, y[c * Mp + m]);
    const int e = wsub(acc, z[m]);
    ecol[m] = e;
    flag |= kNonzero ? e != 0 : e > 0;
  }
  for (int r = warp; r <= C; r += kWarps) {
    int acc = 0;
    if (r < C) {
      for (int m = lane; m < Mp; m += 32) acc = wadd(acc, y[r * Mp + m]);
      const int e = wsub(supply[r], warp_sum(acc));
      if (lane == 0) erow[r] = e;
      flag |= kNonzero ? e != 0 : e > 0;
    } else {
      for (int m = lane; m < Mp; m += 32) acc = wadd(acc, z[m]);
      const int e = wsub(warp_sum(acc), total);
      if (lane == 0) *esink = e;
      flag |= kNonzero ? e != 0 : e > 0;
    }
  }
  return __syncthreads_or(flag) != 0;
}

}  // namespace

extern "C" const char* ksched_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
