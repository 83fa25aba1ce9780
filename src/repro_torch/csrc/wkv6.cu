// RWKV-6 (Finch) wkv recurrence (DESIGN.md §4): the time-mix core of the
// rwkv6 family, run by every time-mix layer in prefill chunks, decode and
// TAIL steps (T = 1) and full-sequence scoring.
//
// Replaces the TPU kernel
//   repro/kernels/wkv6.py  wkv6  (_wkv6_kernel)
// r, k, v, logw are (B, H, T, d) float32, u (H, d), s0 (B, H, d, d) or null
// (zeros).  Per step, the decay applied BEFORE the read, as the reference's
// code computes it (ref.wkv6_ref; the Pallas kernel's inclusive cumsum):
//   Sd = diag(exp(logw_t)) S
//   o_t = r_t Sd + (r_t . (u * k_t)) v_t
//   S   = Sd + k_t v_t^T
// out (B, H, T, d) and S_end (B, H, d, d) go to their own buffers: s0 is
// never written, because the engine keeps idle slots' old state rows.
//
// Design: one block per (b, h) with d threads; thread e owns column e of S
// (the d entries S[:, e]) in registers for the whole sequence, so the state
// never leaves the SM between steps.  T is a loop bound: nothing is padded
// (the TPU's sequential chunk axis becomes this loop).  Each round stages
// kStage steps of r, k, v, exp(logw) and u * k in shared memory with
// coalesced loads, then walks them in order; every thread reads the staged
// rows as broadcasts.  The two dot products accumulate in four partial sums
// each to shorten their dependency chains.  d is a template parameter
// (32 and 64: the reduced and the full rwkv6 head widths).
//
// Bound on the H100: each input read once and each output written once,
// 4 * (4 * B*H*T*d + H*d + 2 * B*H*d*d + B*H*T*d) bytes over 3.35 TB/s,
// against 5 * d * d + 6 * d float32 FLOPs per (b, h, t) over 67 TFLOP/s:
// bytes bound at every shape of the rwkv6 path.  This simple design is latency
// bound instead: B*H blocks of d threads (128 blocks of 2 warps at B = 4,
// H = 32) walk T dependent steps of ~5 * d instructions each.  What it
// leaves on the table: the chunked form (intra-chunk pairwise decays in log
// space as tensor-core products, the state touched once per chunk) and more
// than one warp pair per SM.
#include "common.cuh"

namespace clover {
namespace {

constexpr int kStage = 32;  // time steps staged in shared memory per round

template <int D>
__global__ void __launch_bounds__(D)
    wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ logw,
                const float* __restrict__ u, const float* __restrict__ s0,
                float* __restrict__ out, float* __restrict__ s_end, int H,
                int T) {
  __shared__ __align__(16) float sr[kStage][D];
  __shared__ __align__(16) float sk[kStage][D];
  __shared__ __align__(16) float sw[kStage][D];   // exp(logw)
  __shared__ __align__(16) float sb[kStage][D];   // u * k
  __shared__ __align__(16) float sv[kStage][D];
  const int bh = blockIdx.x;                       // b * H + h
  const int e = threadIdx.x;                       // the column this thread owns
  const size_t seq = static_cast<size_t>(bh) * T * D;
  const size_t st = static_cast<size_t>(bh) * D * D;
  const float ue = u[(bh % H) * D + e];

  float S[D];
#pragma unroll
  for (int i = 0; i < D; ++i)
    S[i] = s0 != nullptr ? s0[st + static_cast<size_t>(i) * D + e] : 0.f;

  for (int t0 = 0; t0 < T; t0 += kStage) {
    const int n = min(kStage, T - t0);
    __syncthreads();  // every thread is done reading the previous round
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const size_t off = seq + static_cast<size_t>(t0 + j) * D + e;
      const float kv = k[off];
      sr[j][e] = r[off];
      sk[j][e] = kv;
      sb[j][e] = ue * kv;
      sv[j][e] = v[off];
      sw[j][e] = expf(logw[off]);
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float vt = sv[j][e];
      float o[4] = {0.f, 0.f, 0.f, 0.f};
      float bonus[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < D; ++i) {
        const float ri = sr[j][i];
        const float ki = sk[j][i];
        const float sd = sw[j][i] * S[i];
        o[i % 4] = fmaf(ri, sd, o[i % 4]);
        bonus[i % 4] = fmaf(ri, sb[j][i], bonus[i % 4]);
        S[i] = fmaf(ki, vt, sd);
      }
      const float ot = (o[0] + o[1]) + (o[2] + o[3]);
      const float bt = (bonus[0] + bonus[1]) + (bonus[2] + bonus[3]);
      out[seq + static_cast<size_t>(t0 + j) * D + e] = fmaf(bt, vt, ot);
    }
  }
#pragma unroll
  for (int i = 0; i < D; ++i)
    s_end[st + static_cast<size_t>(i) * D + e] = S[i];
}

template <int D>
int wkv6_launch(const float* r, const float* k, const float* v,
                const float* logw, const float* u, const float* s0,
                float* out, float* s_end, int B, int H, int T,
                cudaStream_t stream) {
  const unsigned grid = static_cast<unsigned>(B) * static_cast<unsigned>(H);
  wkv6_kernel<D><<<grid, D, 0, stream>>>(r, k, v, logw, u, s0, out, s_end,
                                         H, T);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace clover

// r, k, v, logw (B, H, T, d) float32, u (H, d), s0 (B, H, d, d) or null,
// out (B, H, T, d), s_end (B, H, d, d); all contiguous.  d is 32 or 64
// (anything else returns cudaErrorInvalidValue).  T may be 0: S_end is then
// s0 (or zeros).
extern "C" int clover_wkv6(const float* r, const float* k, const float* v,
                           const float* logw, const float* u,
                           const float* s0, float* out, float* s_end, int B,
                           int H, int T, int d, cudaStream_t stream) {
  if (B == 0 || H == 0) return 0;
  switch (d) {
    case 32:
      return clover::wkv6_launch<32>(r, k, v, logw, u, s0, out, s_end, B, H,
                                     T, stream);
    case 64:
      return clover::wkv6_launch<64>(r, k, v, logw, u, s0, out, s_end, B, H,
                                     T, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
