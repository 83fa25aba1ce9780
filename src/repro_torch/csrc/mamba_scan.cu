// Mamba-1 selective scan (DESIGN.md §4): the SSM core of every Mamba layer of
// the jamba family, run in prefill chunks, decode and TAIL steps (S = 1) and
// full-sequence scoring.
//
// Replaces the TPU kernel
//   repro/kernels/mamba_scan.py  mamba_scan  (_mamba_kernel)
// dt, x are (B, S, dI) float32, A (dI, dS) (positive), Bm, C (B, S, dS),
// h0 (B, dI, dS) or null (zeros).  Per channel (b, i) and step t:
//   h_t = exp(dt_t * -A[i]) * h_{t-1} + (dt_t * x_t) * B_t
//   y_t = h_t . C_t
// y (B, S, dI) and h_end (B, dI, dS) go to their own buffers: h0 is never
// written, because the engine keeps idle slots' old state rows.
//
// Design: the TPU kernel keeps a (tile, dS) state in VMEM across a
// sequential chunk axis, so the decays exp(dt A) and inputs dt x B never
// reach HBM.  Here each channel's dS states live in registers for the whole
// sequence, split over kLanes neighbouring lanes (dS / kLanes each, so
// B * dI * kLanes threads fill the card even at B = 1: 64 blocks of 128
// channels would leave half the 132 SMs idle); y_t is the lanes' partial
// dot products summed with two shuffles.  S is a loop bound: nothing is
// padded (the reference pads S to a chunk multiple with dt = 0).  Each
// round stages kSteps steps of dt and dt * x for the block's kChannels
// channels (coalesced rows of dI) and of B and C (shared by every channel
// of row b) in shared memory, walks them in order, collects y in shared
// memory and writes it back as coalesced rows.  A and h0 load, and h_end
// stores, as one contiguous run of dS floats per channel.  dS is a template
// parameter (16: jamba's and the reduced configs' state size).  The
// exponential is the accurate expf (no fast-math).
//
// Bound on the H100: each input read once and each output written once,
//   4 * (3 B S dI + 2 B S dS + dI dS + (h0 ? 2 : 1) B dI dS) bytes
// over 3.35 TB/s, against ~5 B S dI dS float32 operations over 67 TFLOP/s
// and B S dI dS exponentials over the special-function units (16 per SM per
// clock on compute capability 9.0, the CUDA C++ Programming Guide's
// throughput table: 132 * 16 * 1.98 GHz = 4.18e12 per second at the clock
// the 67 TFLOP/s figure assumes).  At (B = 4, S = 1024) bytes and
// exponentials are the same order (~0.12 and ~0.13 ms): the exponentials
// set the bound.  What this simple design leaves on the table: the staging
// loads are not overlapped with the walk (a block waits at each round's
// barrier), and at S = 1 a launch moves 4 * 3 * B * dI bytes of step
// inputs beside 8 * B * dI * dS of state, so it is bound by the state.
#include "common.cuh"

namespace clover {
namespace {

constexpr int kLanes = 4;                        // lanes per channel
constexpr int kChannels = 32;                    // channels per block
constexpr int kThreads = kLanes * kChannels;     // 128
constexpr int kSteps = 32;                       // steps staged per round

template <int DS>
__global__ void __launch_bounds__(kThreads)
    mamba_scan_kernel(const float* __restrict__ dt, const float* __restrict__ A,
                      const float* __restrict__ Bm, const float* __restrict__ C,
                      const float* __restrict__ x, const float* __restrict__ h0,
                      float* __restrict__ y, float* __restrict__ h_end, int S,
                      int dI) {
  constexpr int kPer = DS / kLanes;              // states per lane
  static_assert(DS % kLanes == 0, "dS must split over the lanes");
  __shared__ float sdt[kSteps][kChannels];       // dt
  __shared__ float sdx[kSteps][kChannels];       // dt * x
  __shared__ float sb[kSteps][DS];
  __shared__ float sc[kSteps][DS];
  __shared__ float sy[kSteps][kChannels];
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int i0 = blockIdx.x * kChannels;
  const int c = tid / kLanes;                    // the channel this lane serves
  const int lane = tid % kLanes;
  const int i = i0 + c;
  const bool live = i < dI;                      // a ragged last block idles
  const size_t state = (static_cast<size_t>(b) * dI + i) * DS + lane * kPer;

  float negA[kPer], h[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    negA[k] = live ? -A[static_cast<size_t>(i) * DS + lane * kPer + k] : 0.f;
    h[k] = (live && h0 != nullptr) ? h0[state + k] : 0.f;
  }

  for (int t0 = 0; t0 < S; t0 += kSteps) {
    const int n = min(kSteps, S - t0);
    __syncthreads();  // the previous round's stage and y rows are consumed
    for (int e = tid; e < kSteps * kChannels; e += kThreads) {
      const int t = e / kChannels, cc = e % kChannels;
      float d = 0.f, dx = 0.f;
      if (t < n && i0 + cc < dI) {
        const size_t off = (static_cast<size_t>(b) * S + t0 + t) * dI + i0 + cc;
        d = dt[off];
        dx = d * x[off];
      }
      sdt[t][cc] = d;
      sdx[t][cc] = dx;
    }
    for (int e = tid; e < kSteps * DS; e += kThreads) {
      const int t = e / DS;
      const size_t off = (static_cast<size_t>(b) * S + t0) * DS + e;
      sb[t][e % DS] = t < n ? Bm[off] : 0.f;
      sc[t][e % DS] = t < n ? C[off] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const float d = sdt[j][c];
      const float dx = sdx[j][c];
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int s = lane * kPer + k;
        h[k] = fmaf(expf(d * negA[k]), h[k], dx * sb[j][s]);
        acc = fmaf(h[k], sc[j][s], acc);
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (lane == 0) sy[j][c] = acc;
    }
    __syncthreads();
    for (int e = tid; e < kSteps * kChannels; e += kThreads) {
      const int t = e / kChannels, cc = e % kChannels;
      if (t < n && i0 + cc < dI)
        y[(static_cast<size_t>(b) * S + t0 + t) * dI + i0 + cc] = sy[t][cc];
    }
  }
  if (live) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) h_end[state + k] = h[k];
  }
}

template <int DS>
int mamba_scan_launch(const float* dt, const float* A, const float* Bm,
                      const float* C, const float* x, const float* h0,
                      float* y, float* h_end, int B, int S, int dI,
                      cudaStream_t stream) {
  const dim3 grid((dI + kChannels - 1) / kChannels, B);
  mamba_scan_kernel<DS><<<grid, kThreads, 0, stream>>>(dt, A, Bm, C, x, h0, y,
                                                       h_end, S, dI);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace clover

// dt, x (B, S, dI) float32, A (dI, dS), Bm, C (B, S, dS), h0 (B, dI, dS) or
// null, y (B, S, dI), h_end (B, dI, dS); all contiguous.  dS is 16 (anything
// else returns cudaErrorInvalidValue).  S may be 0: h_end is then h0 (or
// zeros).
extern "C" int clover_mamba_scan(const float* dt, const float* A,
                                 const float* Bm, const float* C,
                                 const float* x, const float* h0, float* y,
                                 float* h_end, int B, int S, int dI, int dS,
                                 cudaStream_t stream) {
  if (B == 0 || dI == 0) return 0;
  switch (dS) {
    case 16:
      return clover::mamba_scan_launch<16>(dt, A, Bm, C, x, h0, y, h_end, B,
                                           S, dI, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
