// Shared helpers of the port's CUDA kernels (plain C interface, built by
// src/repro_torch/kernels/_build.py for sm_90a).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace clover {

constexpr int kWarp = 32;

__device__ __forceinline__ float warp_max(float x) {
  for (int o = kWarp / 2; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = kWarp / 2; o > 0; o >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// One level K of a sum of N values held by each of L neighbouring lanes
// across the L lanes (L a power of two, N in {1, 2, 4}, N <= L): while a
// lane holds more than one value, the level halves them (the lane keeps one
// half and trades the other with its partner: a reduce-scatter), then it
// adds its partner's value to its own (a butterfly).  Split so that its
// shuffles (issue) and its adds (finish) can sit apart in the instruction
// stream, with independent work between them.
template <int N, int L, int K>
struct LaneLevel {
  static_assert((N == 1 || N == 2 || N == 4) && N <= L,
                "1, 2 or 4 values over at least as many lanes");
  static constexpr int kIn = (N >> K) > 0 ? (N >> K) : 1;  // values entering
  static constexpr int kOut = kIn > 1 ? kIn / 2 : 1;
  static constexpr int kOff = L >> (K + 1);
  float keep[kOut], got[kOut];
  __device__ __forceinline__ void issue(const float (&v)[N]) {
    if constexpr (kIn > 1) {
      const bool hi = threadIdx.x % L & kOff;
#pragma unroll
      for (int i = 0; i < kOut; ++i) {
        keep[i] = hi ? v[i + kOut] : v[i];
        got[i] = __shfl_xor_sync(0xffffffffu, hi ? v[i] : v[i + kOut], kOff);
      }
    } else {
      keep[0] = v[0];
      got[0] = __shfl_xor_sync(0xffffffffu, v[0], kOff);
    }
  }
  __device__ __forceinline__ void finish(float (&v)[N]) {
#pragma unroll
    for (int i = 0; i < kOut; ++i) v[i] = keep[i] + got[i];
  }
};

// All log2(L) levels at once.  Returns the sum of value lane_held<N, L>,
// which L / N lanes share; the one with (lane & (L / N - 1)) == 0 may
// write it.  v is clobbered.
template <int N, int L, int K = 0>
__device__ __forceinline__ float lane_reduce(float (&v)[N]) {
  if constexpr ((L >> (K + 1)) == 0) {
    return v[0];
  } else {
    LaneLevel<N, L, K> level;
    level.issue(v);
    level.finish(v);
    return lane_reduce<N, L, K + 1>(v);
  }
}

// Which of the N values lane_reduce<N, L> leaves with a lane.
template <int N, int L>
__device__ __forceinline__ int lane_held(int lane) {
  int held = 0;
  if constexpr (N == 4) held += lane & (L / 2) ? 2 : 0;
  if constexpr (N >= 2) held += lane & (N == 4 ? L / 4 : L / 2) ? 1 : 0;
  return held;
}

__device__ __forceinline__ float component(const float4& f, int m) {
  return m == 0 ? f.x : m == 1 ? f.y : m == 2 ? f.z : f.w;
}

// Asynchronous copy of Bytes (16, 8 or 4) from global to shared memory;
// an invalid one fills zeros and reads nothing.
template <int Bytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (Bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
                 "l"(src), "r"(valid ? 16 : 0));
  else if constexpr (Bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(d),
                 "l"(src), "r"(valid ? 8 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d),
                 "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N));
}

// Opt a kernel in to more than 48 KB of dynamic shared memory.
template <class Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace clover
