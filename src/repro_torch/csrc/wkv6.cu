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
// Bound on the H100: each input read once and each output written once,
// 4 * (4 * B*H*T*d + H*d + 2 * B*H*d*d + B*H*T*d) bytes over 3.35 TB/s,
// against 5 * d * d + 6 * d float32 FLOPs per (b, h, t) over 67 TFLOP/s:
// bytes bound at every shape of the rwkv6 path (0.0507 ms at B 4, H 32, T
// 1024, d 64).  A recurrent walk is held by issue instead: three float32
// operations per state entry and step over d^2 = 4096 entries, plus the
// shared-memory reads and the lane sums, ~0.07 ms of issue at (4, 32,
// 1024, 64) on 528 schedulers.
//
// Design.
// (a) Columns are independent: column e of S needs only v_e and the full
//     r, k, w rows.  The grid is (d / COLS, H, B); a thread holds CC
//     consecutive columns, so each r, k, w value it reads from shared
//     memory serves CC entries.  The wrapper's plan (kernels/wkv6.py)
//     takes the large tile (CC = 4, COLS = 64: one block of 4 warps per
//     head) while its grid still covers the SMs, else the small one (CC =
//     1, COLS = 16: 4 blocks per head), as at B = 1.
// (b) The d key rows of a column are split over L = 8 neighbouring lanes,
//     each holding d / 8 rows in registers for the whole sequence (rows
//     4 (lane + 8 g) + m: float4 groups interleaved over the lanes, so a
//     quarter-warp's float4 reads of a staged row hit 32 distinct banks).
//     o is the lanes' partial sums joined by a reduce-scatter: log2(CC)
//     levels that halve the columns a lane keeps, then a butterfly
//     (LaneLevel in common.cuh).
// (c) Per-step quantities are staged once per block and step, not once per
//     column: w = exp(logw), r * w and the bonus scalar beta_t = r_t . (u *
//     k_t) (a shuffle tree over the threads that copied row t).  An entry
//     then costs three operations a step: o += (r_i w_i) S_ie against the
//     old S, S_ie = fma(k_i, v_e, w_i S_ie); out = o_e + beta_t v_e.  This
//     regroups r_i (w_i S_ie) as (r_i w_i) S_ie, which changes the rounding
//     only (tests/test_torch_scan_design.py emulates it against the plain
//     version and the JAX oracle).
// (d) Staging is double-buffered with cp.async: each thread waits for its
//     own copies of round n, transforms them in place (no other thread
//     reads them yet), then one barrier per round publishes round n and
//     frees the other buffer, whose copies for round n + 1 start before
//     round n is walked.  A T = 1 step issues its copies and its state
//     loads (float4 rows of its columns) together, before its only
//     barrier: one DRAM round trip; a call of at most one round takes one
//     stage buffer.
// (e) The walk is software-pipelined for the few warps a large tile leaves
//     on an SM (one per scheduler at B 4, H 32): step j + 1's operands are
//     read from shared memory while step j runs, and the three shuffle
//     levels of step j - 1's sums sit between the four row quarters of
//     step j's FMAs, so no warp waits on a shuffle.
// T is a loop bound: nothing is padded (rows past T are neither copied nor
// walked).  Every step's arithmetic is the same wherever a call starts, so
// chained calls equal one call bit for bit.
//
// Why not the chunked tensor-core form of the Pallas kernel: its factorised
// products r * exp(cum) and k * exp(-cum) overflow float32 within 8 steps
// of a chunk at the model's clamp logw = -10 (models/rwkv.py), its safe
// form (a (C, C, d) decay cube) takes C times the walk's exponentials, and
// either would need 3xTF32 products for float32 parity.  The walk comes
// within ~3x of the byte bound without them; the chunked form stays a later
// option.
#include "common.cuh"

namespace clover {
namespace {

constexpr int kStage = 32;       // time steps staged per round

// D: head width; L: lanes per state column; CC: columns per thread; COLS:
// columns per block
template <int D, int L, int CC, int COLS>
struct Wkv6Plan {
  static constexpr int kThreads = COLS / CC * L;
  static constexpr int kRows = D / L;        // state rows per thread
  static constexpr int kGroups = kRows / 4;  // float4 row groups per thread
  static constexpr int kQ = D / 4;           // float4s of a staged row
  static constexpr int kCV = COLS / 4;       // float4s of v per step
  static_assert(kRows % 4 == 0, "each lane holds whole float4 row groups");
  static_assert(L == 8, "the walk's pipeline interleaves log2(L) = 3 "
                "shuffle levels with the four row quarters of a step");
  static_assert(D % COLS == 0 && COLS % (4 * CC) == 0 && CC <= L,
                "column blocks tile d; a thread's columns lie in one float4");
  static_assert(kThreads % kWarp == 0 && kThreads % kQ == 0 &&
                    kWarp % kQ == 0 && kStage * kQ % kThreads == 0,
                "whole warps; a staged row's float4s lie in one warp, one "
                "per thread, and every thread stages as many rows");
};

template <int D, int COLS>
struct Wkv6Stage {
  // one row past the round: the walk reads step j + 1's operands while
  // it walks step j, unconditionally (the padding row is never used)
  float4 r[kStage + 1][D / 4];   // r, then r * w
  float4 k[kStage + 1][D / 4];
  float4 w[kStage + 1][D / 4];   // logw, then exp(logw)
  float4 v[kStage + 1][COLS / 4];
  float beta[kStage];            // r_t . (u * k_t)
};

// 16 bytes from global to shared memory: one copy, or four where the
// source is not 16-byte aligned
__device__ __forceinline__ void copy4(float4* dst, const float* src,
                                      bool ok, bool vec) {
  float* d = reinterpret_cast<float*>(dst);
  if (vec) {
    cp_async<16>(d, src, ok);
  } else {
#pragma unroll
    for (int m = 0; m < 4; ++m) cp_async<4>(d + m, src + m, ok);
  }
}

template <int D, int L, int CC, int COLS>
__global__ void __launch_bounds__(Wkv6Plan<D, L, CC, COLS>::kThreads)
    wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ logw,
                const float* __restrict__ u, const float* __restrict__ s0,
                float* __restrict__ out, float* __restrict__ s_end, int H,
                int T) {
  using P = Wkv6Plan<D, L, CC, COLS>;
  using Stage = Wkv6Stage<D, COLS>;
  extern __shared__ __align__(16) unsigned char smem[];
  Stage* stage = reinterpret_cast<Stage*>(smem);
  const int tid = threadIdx.x;
  const int lane = tid % L;                 // which rows of the columns
  const int ct = tid / L;                   // which CC columns of the block
  const int c0 = blockIdx.x * COLS;
  const int h = blockIdx.y;
  const int e0 = c0 + ct * CC;              // this thread's first column
  const size_t bh = static_cast<size_t>(blockIdx.z) * H + h;
  const size_t seq = bh * T * D;
  const size_t st = bh * D * D;
  const bool vec = (reinterpret_cast<uintptr_t>(r) |
                    reinterpret_cast<uintptr_t>(k) |
                    reinterpret_cast<uintptr_t>(v) |
                    reinterpret_cast<uintptr_t>(logw)) % 16 == 0;
  const int q = tid % P::kQ;                // staging: this thread's float4
  const int rounds = (T + kStage - 1) / kStage;

  // copies of round `round` (rows past T are neither copied nor read)
  auto load = [&](int round) {
    const int t0 = round * kStage;
    const int n = min(kStage, T - t0);
    Stage& s = stage[round & 1];
    for (int i = tid; i < n * P::kQ; i += P::kThreads) {
      const int j = i / P::kQ;
      const size_t off = seq + static_cast<size_t>(t0 + j) * D + 4 * q;
      copy4(&s.r[j][q], r + off, true, vec);
      copy4(&s.k[j][q], k + off, true, vec);
      copy4(&s.w[j][q], logw + off, true, vec);
    }
    for (int i = tid; i < n * P::kCV; i += P::kThreads) {
      const int j = i / P::kCV, c = i % P::kCV;
      copy4(&s.v[j][c], v + seq + static_cast<size_t>(t0 + j) * D + c0 + 4 * c,
            true, vec);
    }
    cp_async_commit();
  };

  if (rounds > 0) load(0);
  // u for this thread's staging float4; the state block (rows
  // 4 (lane + L g) + m, columns e0 .. e0 + CC - 1) in registers, a float4
  // of columns at a time where it can
  const float* uh = u + h * D + 4 * q;
  const float u0 = uh[0], u1 = uh[1], u2 = uh[2], u3 = uh[3];
  const bool svec = CC == 4 && (reinterpret_cast<uintptr_t>(s0) |
                                reinterpret_cast<uintptr_t>(s_end)) % 16 == 0;
  float S[P::kRows][CC];
#pragma unroll
  for (int g = 0; g < P::kGroups; ++g)
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const size_t row = st + static_cast<size_t>(4 * (lane + L * g) + m) * D;
      if (s0 == nullptr) {
#pragma unroll
        for (int cc = 0; cc < CC; ++cc) S[4 * g + m][cc] = 0.f;
      } else if (svec) {
        const float4 x = *reinterpret_cast<const float4*>(s0 + row + e0);
#pragma unroll
        for (int cc = 0; cc < CC; ++cc) S[4 * g + m][cc] = component(x, cc);
      } else {
#pragma unroll
        for (int cc = 0; cc < CC; ++cc) S[4 * g + m][cc] = s0[row + e0 + cc];
      }
    }
  // the column of out this lane adds up (of the block's v), and whether it
  // writes it
  const int held = lane_held<CC, L>(lane);
  const int vcol = ct * CC + held;
  const bool writer = (lane & (L / CC - 1)) == 0;
  // the shuffle group of the kQ threads that staged one row
  const unsigned rmask =
      P::kQ == kWarp ? 0xffffffffu
                     : ((1u << P::kQ) - 1) << (tid % kWarp / P::kQ * P::kQ);

  for (int n = 0; n < rounds; ++n) {
    Stage& s = stage[n & 1];
    const int t0 = n * kStage;
    const int steps = min(kStage, T - t0);
    cp_async_wait<0>();            // this thread's copies of round n
    for (int i = tid; i < steps * P::kQ; i += P::kThreads) {
      const int j = i / P::kQ;
      const float4 rr = s.r[j][q], kk = s.k[j][q], lw = s.w[j][q];
      const float4 w = make_float4(expf(lw.x), expf(lw.y), expf(lw.z),
                                   expf(lw.w));
      s.w[j][q] = w;
      s.r[j][q] = make_float4(rr.x * w.x, rr.y * w.y, rr.z * w.z,
                              rr.w * w.w);
      float p = fmaf(rr.w, u3 * kk.w,
                     fmaf(rr.z, u2 * kk.z,
                          fmaf(rr.y, u1 * kk.y, rr.x * (u0 * kk.x))));
#pragma unroll
      for (int off = P::kQ / 2; off > 0; off >>= 1)
        p += __shfl_xor_sync(rmask, p, off);
      if (q == 0) s.beta[j] = p;
    }
    // round n is visible to every thread, and every thread is done with
    // round n - 1's buffer
    __syncthreads();
    if (n + 1 < rounds) load(n + 1);

    // the walk, software-pipelined: each step's operands are read from
    // shared memory one step ahead, and the partial sums of step j - 1
    // cross the lanes (three shuffle levels) while the FMAs of step j run,
    // one level per row quarter m
    float* o = out + seq + static_cast<size_t>(t0) * D + e0 + held;
    float4 xr[P::kGroups], xw[P::kGroups], xk[P::kGroups];
    float xv[CC];
    auto fetch = [&](int j, float4(&fr)[P::kGroups], float4(&fw)[P::kGroups],
                     float4(&fk)[P::kGroups], float(&fv)[CC]) {
#pragma unroll
      for (int g = 0; g < P::kGroups; ++g) {
        const int qq = lane + L * g;
        fr[g] = s.r[j][qq];
        fw[g] = s.w[j][qq];
        fk[g] = s.k[j][qq];
      }
      const float* vj = reinterpret_cast<const float*>(s.v[j]) + ct * CC;
#pragma unroll
      for (int cc = 0; cc < CC; ++cc) fv[cc] = vj[cc];
    };
    // quarter m of a step: rows 4 (lane + L g) + m
    auto fmas = [&](int m, float(&a)[CC]) {
#pragma unroll
      for (int g = 0; g < P::kGroups; ++g) {
        const float rm = component(xr[g], m), wm = component(xw[g], m);
        const float km = component(xk[g], m);
#pragma unroll
        for (int cc = 0; cc < CC; ++cc) {
          float& x = S[4 * g + m][cc];
          a[cc] = fmaf(rm, x, a[cc]);
          x = fmaf(km, xv[cc], wm * x);
        }
      }
    };
    auto shift = [&](float4(&yr)[P::kGroups], float4(&yw)[P::kGroups],
                     float4(&yk)[P::kGroups], float(&yv)[CC]) {
#pragma unroll
      for (int g = 0; g < P::kGroups; ++g) {
        xr[g] = yr[g];
        xw[g] = yw[g];
        xk[g] = yk[g];
      }
#pragma unroll
      for (int cc = 0; cc < CC; ++cc) xv[cc] = yv[cc];
    };
    auto emit = [&](int j, float acc) {
      const float vh = reinterpret_cast<const float*>(s.v[j])[vcol];
      if (writer) o[static_cast<size_t>(j) * D] = fmaf(s.beta[j], vh, acc);
    };

    float a[CC];                   // step j - 1's partial sums, in flight
#pragma unroll
    for (int cc = 0; cc < CC; ++cc) a[cc] = 0.f;
    fetch(0, xr, xw, xk, xv);
    {
      float4 yr[P::kGroups], yw[P::kGroups], yk[P::kGroups];
      float yv[CC];
      fetch(1, yr, yw, yk, yv);
#pragma unroll
      for (int m = 0; m < 4; ++m) fmas(m, a);
      shift(yr, yw, yk, yv);
    }
#pragma unroll 2
    for (int j = 1; j < steps; ++j) {
      float4 yr[P::kGroups], yw[P::kGroups], yk[P::kGroups];
      float yv[CC];
      fetch(j + 1, yr, yw, yk, yv);
      float b[CC];
#pragma unroll
      for (int cc = 0; cc < CC; ++cc) b[cc] = 0.f;
      LaneLevel<CC, L, 0> l0;
      l0.issue(a);
      fmas(0, b);
      l0.finish(a);
      LaneLevel<CC, L, 1> l1;
      l1.issue(a);
      fmas(1, b);
      l1.finish(a);
      LaneLevel<CC, L, 2> l2;
      l2.issue(a);
      fmas(2, b);
      l2.finish(a);
      emit(j - 1, a[0]);
      fmas(3, b);
#pragma unroll
      for (int cc = 0; cc < CC; ++cc) a[cc] = b[cc];
      shift(yr, yw, yk, yv);
    }
    emit(steps - 1, lane_reduce<CC, L>(a));
  }
#pragma unroll
  for (int g = 0; g < P::kGroups; ++g)
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      float* row =
          s_end + st + static_cast<size_t>(4 * (lane + L * g) + m) * D + e0;
      if (svec) {
        float4 x;
        x.x = S[4 * g + m][0];
        x.y = S[4 * g + m][CC > 1 ? 1 : 0];
        x.z = S[4 * g + m][CC > 2 ? 2 : 0];
        x.w = S[4 * g + m][CC > 3 ? 3 : 0];
        *reinterpret_cast<float4*>(row) = x;
      } else {
#pragma unroll
        for (int cc = 0; cc < CC; ++cc) row[cc] = S[4 * g + m][cc];
      }
    }
}

template <int D, int L, int CC, int COLS>
int wkv6_launch(const float* r, const float* k, const float* v,
                const float* logw, const float* u, const float* s0,
                float* out, float* s_end, int B, int H, int T,
                cudaStream_t stream) {
  using P = Wkv6Plan<D, L, CC, COLS>;
  // a second stage buffer only where there is a second round
  const size_t smem = (T > kStage ? 2 : 1) * sizeof(Wkv6Stage<D, COLS>);
  cudaError_t err = allow_smem(wkv6_kernel<D, L, CC, COLS>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(D / COLS, H, B);
  wkv6_kernel<D, L, CC, COLS><<<grid, P::kThreads, smem, stream>>>(
      r, k, v, logw, u, s0, out, s_end, H, T);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace clover

// r, k, v, logw (B, H, T, d) float32, u (H, d), s0 (B, H, d, d) or null,
// out (B, H, T, d), s_end (B, H, d, d); all contiguous.  (d, lanes per
// column, columns per thread, columns per block) is one of the instances
// below (anything else returns cudaErrorInvalidValue).  T may be 0: S_end is
// then s0 (or zeros).
extern "C" int clover_wkv6(const float* r, const float* k, const float* v,
                           const float* logw, const float* u,
                           const float* s0, float* out, float* s_end, int B,
                           int H, int T, int d, int lanes, int cols_thread,
                           int cols_block, cudaStream_t stream) {
  using clover::wkv6_launch;
  if (B == 0 || H == 0) return 0;
#define CLOVER_WKV6(D, L, CC, COLS)                                        \
  if (d == D && lanes == L && cols_thread == CC && cols_block == COLS)     \
    return wkv6_launch<D, L, CC, COLS>(r, k, v, logw, u, s0, out, s_end, B, \
                                       H, T, stream);
  CLOVER_WKV6(64, 8, 4, 64)
  CLOVER_WKV6(64, 8, 1, 16)
  CLOVER_WKV6(32, 8, 4, 32)
  CLOVER_WKV6(32, 8, 1, 16)
#undef CLOVER_WKV6
  return static_cast<int>(cudaErrorInvalidValue);
}
