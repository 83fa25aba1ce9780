// Shared helpers of the port's CUDA kernels (plain C interface, built by
// src/repro_torch/kernels/_build.py for sm_90a).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

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

// One online-softmax update of `rows` score rows of width kWarp held in
// shared memory (row r at s[r * kWarp]): one warp per row, one column
// per lane.  Turns the scores into probabilities in place and updates
// the running max m, sum l and the rescale factor alpha of each row.
// A row whose running max is still -inf (all masked so far) keeps
// p = 0, alpha = 1.
__device__ __forceinline__ void online_softmax_rows(
    float* s, float* m, float* l, float* alpha, int rows) {
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int n_warps = blockDim.x / kWarp;
  for (int r = warp; r < rows; r += n_warps) {
    const float x = s[r * kWarp + lane];
    const float m_old = m[r];
    const float m_new = fmaxf(m_old, warp_max(x));
    const bool dead = (m_new == -INFINITY);
    const float p = dead ? 0.f : expf(x - m_new);
    const float sum = warp_sum(p);
    s[r * kWarp + lane] = p;
    if (lane == 0) {
      const float a = dead ? 1.f : expf(m_old - m_new);
      alpha[r] = a;
      l[r] = l[r] * a + sum;
      m[r] = m_new;
    }
  }
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
