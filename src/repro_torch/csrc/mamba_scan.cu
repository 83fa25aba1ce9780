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
// Bound on the H100: each input read once and each output written once,
//   4 * (3 B S dI + 2 B S dS + dI dS + (h0 ? 2 : 1) B dI dS) bytes
// over 3.35 TB/s, against ~5 B S dI dS float32 operations over 67 TFLOP/s
// and B S dI dS exponentials over the special-function units (16 per SM per
// clock on compute capability 9.0, the CUDA C++ Programming Guide's
// throughput table: 132 * 16 * 1.98 GHz = 4.18e12 per second at the clock
// the 67 TFLOP/s figure assumes).  At (B = 4, S = 1024) the exponentials
// set it: 0.128 ms.  A warp's MUFU.EX2 holds its scheduler's quarter of the
// units for 8 cycles, and each state needs four float32 operations beside
// it (the argument, dt x B, the h and y FMAs) plus its share of the step's
// shared-memory reads and lane sums: issue and the units are of one order,
// and every instruction saved beside the exponential shows (exp2f's three
// per state did, in this kernel's timing at S = 1024: PERF.md §6).
//
// Design.  The TPU kernel keeps a (tile, dS) state in VMEM across a
// sequential chunk axis, so the decays exp(dt A) and inputs dt x B never
// reach HBM.  Here each channel's dS states live in registers for the whole
// sequence, split over LANES neighbouring lanes (dS / LANES each); y_t is
// the lanes' partial dot products joined by shuffles.  CH channels make a
// block, so B * dI / CH blocks fill the card at B = 1 too.
// (a) Each decay is one MUFU.EX2 of dt * (-A log2 e), the factor prescaled
//     once per state in registers: no expf range reduction.  The extra
//     rounding of the prescaled argument is ~|dt A| 2^-24 relative, the
//     unit's own ~2^-22.  It is the bare ex2.approx.ftz: exp2f would add
//     three instructions per state only to keep subnormal results (decays
//     below 2^-126, which move h by less than 1e-38 of itself); it was
//     slower at S = 64 and 1024 and no faster at S = 1 (PERF.md §6).
// (b) Staging is double-buffered: each round copies kSteps steps of dt, x
//     (the block's CH channels of a row) and of B and C (shared by every
//     channel of row b) into shared memory with cp.async while the previous
//     round is walked; one barrier per round publishes it.  y is collected
//     in shared memory and written back as coalesced rows one round later,
//     behind the next barrier.  The walk reads step j + 1's operands while
//     step j runs.
// (c) An S = 1 step issues every load (h0 and A as float4 per lane, the
//     copies of dt, x, B and C) before its only barrier: one DRAM round
//     trip.
// (d) LANES and CH are template parameters; the wrapper's plan
//     (kernels/mamba_scan.py) takes 2 lanes of 8 states in blocks of 64
//     channels, or 4 lanes of 4 where 2 would leave fewer than 8 warps per
//     SM (B = 1), as chip_smoke.py's tile sweep measured.
// S is a loop bound: nothing is padded (rows past S are neither copied nor
// walked), and every step's arithmetic is the same wherever a call starts,
// so chained calls equal one call bit for bit.  dS is a template parameter
// (16: jamba's and the reduced configs' state size).
#include "common.cuh"

namespace clover {
namespace {

constexpr int kSteps = 16;                       // steps staged per round
constexpr float kLog2e = 1.4426950408889634f;

template <int DS, int CH>
struct MambaStage {
  // one row past the round: the walk reads step j + 1's operands while it
  // walks step j, unconditionally (the padding row is never used)
  float dt[kSteps + 1][CH];
  float x[kSteps + 1][CH];
  float4 b[kSteps + 1][DS / 4];
  float4 c[kSteps + 1][DS / 4];
};

// 2^x: the bare MUFU.EX2, subnormal results flushed to zero
__device__ __forceinline__ float pow2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// DS: state size; LANES: threads per channel; CH: channels per block
template <int DS, int LANES, int CH>
__global__ void __launch_bounds__(CH * LANES)
    mamba_scan_kernel(const float* __restrict__ dt, const float* __restrict__ A,
                      const float* __restrict__ Bm, const float* __restrict__ C,
                      const float* __restrict__ x, const float* __restrict__ h0,
                      float* __restrict__ y, float* __restrict__ h_end, int S,
                      int dI) {
  constexpr int kThreads = CH * LANES;
  constexpr int kPer = DS / LANES;               // states per lane
  constexpr int kG = kPer / 4;                   // float4s per lane
  constexpr int kQ = DS / 4;                     // float4s of a B or C row
  static_assert(kPer % 4 == 0, "each lane holds whole float4s of states");
  static_assert(kThreads % kWarp == 0 && CH % 4 == 0,
                "whole warps; whole float4s of channels");
  __shared__ __align__(16) MambaStage<DS, CH> stage[2];
  __shared__ float sy[2][kSteps][CH];
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int i0 = blockIdx.x * CH;
  const int c = tid / LANES;                     // the channel this lane serves
  const int lane = tid % LANES;                  // which of its states
  const int i = i0 + c;
  const bool live = i < dI;                      // a ragged last block idles
  const size_t state = (static_cast<size_t>(b) * dI + i) * DS + lane * kPer;
  const bool vec = dI % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(dt) |
                    reinterpret_cast<uintptr_t>(x) |
                    reinterpret_cast<uintptr_t>(Bm) |
                    reinterpret_cast<uintptr_t>(C)) % 16 == 0;
  const bool avec = (reinterpret_cast<uintptr_t>(A) |
                     reinterpret_cast<uintptr_t>(h0) |
                     reinterpret_cast<uintptr_t>(h_end)) % 16 == 0;
  const int rounds = (S + kSteps - 1) / kSteps;

  // copies of round `round` (rows past S are neither copied nor read)
  auto load = [&](int round) {
    const int t0 = round * kSteps;
    const int n = min(kSteps, S - t0);
    MambaStage<DS, CH>& s = stage[round & 1];
    for (int e = tid; e < n * (CH / 4); e += kThreads) {
      const int j = e / (CH / 4), cc = 4 * (e % (CH / 4));
      const size_t row = static_cast<size_t>(b) * S + t0 + j;
      if (vec) {
        const bool ok = i0 + cc < dI;
        const size_t off = row * dI + (ok ? i0 + cc : 0);
        cp_async<16>(&s.dt[j][cc], dt + off, ok);
        cp_async<16>(&s.x[j][cc], x + off, ok);
      } else {
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const bool ok = i0 + cc + m < dI;
          const size_t off = row * dI + (ok ? i0 + cc + m : 0);
          cp_async<4>(&s.dt[j][cc + m], dt + off, ok);
          cp_async<4>(&s.x[j][cc + m], x + off, ok);
        }
      }
    }
    for (int e = tid; e < n * kQ; e += kThreads) {
      const int j = e / kQ, q = e % kQ;
      const size_t off = (static_cast<size_t>(b) * S + t0 + j) * DS + 4 * q;
      float* db = reinterpret_cast<float*>(&s.b[j][q]);
      float* dc = reinterpret_cast<float*>(&s.c[j][q]);
      if (vec) {
        cp_async<16>(db, Bm + off, true);
        cp_async<16>(dc, C + off, true);
      } else {
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          cp_async<4>(db + m, Bm + off + m, true);
          cp_async<4>(dc + m, C + off + m, true);
        }
      }
    }
    cp_async_commit();
  };

  // y rows of a walked round, coalesced
  auto write_back = [&](int round) {
    const int t0 = round * kSteps;
    const int n = min(kSteps, S - t0);
    for (int e = tid; e < n * CH; e += kThreads) {
      const int j = e / CH, cc = e % CH;
      if (i0 + cc < dI)
        y[(static_cast<size_t>(b) * S + t0 + j) * dI + i0 + cc] =
            sy[round & 1][j][cc];
    }
  };

  if (rounds > 0) load(0);
  // -A log2(e) and h0 for this lane's states, in registers (a channel past
  // dI idles on zeros)
  float negA2[kPer], h[kPer];
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), s = a;
    if (live) {
      const float* ap = A + static_cast<size_t>(i) * DS + lane * kPer + 4 * g;
      a = avec ? *reinterpret_cast<const float4*>(ap)
               : make_float4(ap[0], ap[1], ap[2], ap[3]);
      if (h0 != nullptr) {
        const float* hp = h0 + state + 4 * g;
        s = avec ? *reinterpret_cast<const float4*>(hp)
                 : make_float4(hp[0], hp[1], hp[2], hp[3]);
      }
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      negA2[4 * g + m] = -component(a, m) * kLog2e;
      h[4 * g + m] = component(s, m);
    }
  }

  for (int n = 0; n < rounds; ++n) {
    cp_async_wait<0>();
    // round n's copies are visible to every thread; every thread is done
    // walking round n - 1 (its stage may be refilled) and has put that
    // round's y in shared memory
    __syncthreads();
    if (n > 0) write_back(n - 1);
    if (n + 1 < rounds) load(n + 1);
    const MambaStage<DS, CH>& s = stage[n & 1];
    const int steps = min(kSteps, S - n * kSteps);
    // each step's operands are read from shared memory one step ahead
    float xd, xx;
    float4 xb[kG], xc[kG];
    auto fetch = [&](int j, float& fd, float& fx, float4(&fb)[kG],
                     float4(&fc)[kG]) {
      fd = s.dt[j][c];
      fx = s.x[j][c];
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        fb[g] = s.b[j][lane * kG + g];
        fc[g] = s.c[j][lane * kG + g];
      }
    };
    fetch(0, xd, xx, xb, xc);
#pragma unroll 2
    for (int j = 0; j < steps; ++j) {
      float yd, yx;
      float4 yb[kG], yc[kG];
      fetch(j + 1, yd, yx, yb, yc);
      const float dx = xd * xx;
      float acc[1] = {0.f};
#pragma unroll
      for (int g = 0; g < kG; ++g)
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          float& hs = h[4 * g + m];
          hs = fmaf(pow2(xd * negA2[4 * g + m]), hs,
                    dx * component(xb[g], m));
          acc[0] = fmaf(hs, component(xc[g], m), acc[0]);
        }
      const float yt = lane_reduce<1, LANES>(acc);
      if (lane == 0) sy[n & 1][j][c] = yt;
      xd = yd;
      xx = yx;
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        xb[g] = yb[g];
        xc[g] = yc[g];
      }
    }
  }
  if (rounds > 0) {
    __syncthreads();
    write_back(rounds - 1);
  }
  if (live) {
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      float* hp = h_end + state + 4 * g;
      if (avec) {
        *reinterpret_cast<float4*>(hp) =
            make_float4(h[4 * g], h[4 * g + 1], h[4 * g + 2], h[4 * g + 3]);
      } else {
#pragma unroll
        for (int m = 0; m < 4; ++m) hp[m] = h[4 * g + m];
      }
    }
  }
}

template <int DS, int LANES, int CH>
int mamba_scan_launch(const float* dt, const float* A, const float* Bm,
                      const float* C, const float* x, const float* h0,
                      float* y, float* h_end, int B, int S, int dI,
                      cudaStream_t stream) {
  const dim3 grid((dI + CH - 1) / CH, B);
  mamba_scan_kernel<DS, LANES, CH><<<grid, CH * LANES, 0, stream>>>(
      dt, A, Bm, C, x, h0, y, h_end, S, dI);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace clover

// dt, x (B, S, dI) float32, A (dI, dS), Bm, C (B, S, dS), h0 (B, dI, dS) or
// null, y (B, S, dI), h_end (B, dI, dS); all contiguous.  (dS, lanes per
// channel, channels per block) is one of the instances below (anything else
// returns cudaErrorInvalidValue).  S may be 0: h_end is then h0 (or
// zeros).
extern "C" int clover_mamba_scan(const float* dt, const float* A,
                                 const float* Bm, const float* C,
                                 const float* x, const float* h0, float* y,
                                 float* h_end, int B, int S, int dI, int dS,
                                 int lanes, int channels,
                                 cudaStream_t stream) {
  using clover::mamba_scan_launch;
  if (B == 0 || dI == 0) return 0;
#define CLOVER_MAMBA(DS, L, CH)                                          \
  if (dS == DS && lanes == L && channels == CH)                          \
    return mamba_scan_launch<DS, L, CH>(dt, A, Bm, C, x, h0, y, h_end, B, \
                                        S, dI, stream);
  CLOVER_MAMBA(16, 2, 64)
  CLOVER_MAMBA(16, 4, 32)
#undef CLOVER_MAMBA
  return static_cast<int>(cudaErrorInvalidValue);
}
