// Causal flash attention for CLOVER-pruned heads (DESIGN.md §4): GQA with
// asymmetric head widths (dq != dv), online softmax, in two forms: float32
// (3xTF32, below) and the TPU kernel's 16-bit form (bfloat16 / float16
// operands, further down).  Beside them the window form (last): the
// reference's XLA attention over a cache window at 16 bits.
//
// Replaces the TPU kernel
//   repro/kernels/clover_attention.py  flash_attention  (_flash_kernel)
//
// The float32 form's design: tensor cores at float32 accuracy (3xTF32).
// Every product runs as mma.sync m16n8k8 on TF32 operands, each float32
// operand x split once into big = tf32(x) and small = tf32(x - big), and
// a . b taken as small_a big_b + big_a small_b + big_a big_b (small terms
// first) with a float32 accumulator: the dropped small_a small_b term is
// ~2^-22 of the product, so the result keeps float32 accuracy (CUTLASS's
// OpMultiplyAddFastF32, which PyTorch's float32 memory-efficient attention
// uses).  No product here is single-pass TF32 (~1e-3 relative error).
//   * One block per (64 queries, head h, batch b), 4 warps of 16 query rows
//     (one m16 tile each); the grid's q-tiles run last-first, so the blocks
//     with the most keys start first.  Queries align to the END of the keys
//     (query i sits at position q_offset + i, q_offset = T - S); key tiles
//     past the block's last query are never loaded, and the causal mask is
//     applied only on tiles that cross a warp's diagonal.  T and S are loop
//     bounds: nothing is padded.
//   * Widths are zero-padded in shared memory up to a compile-time bucket D
//     (32, 64, 128, 256) the wrapper picks; the zeros add exact zeros.  Key
//     tiles of BK = 64 (32 at D = 256) of K and V are staged by 16-byte
//     cp.async copies (4-byte ones when a width is not a multiple of 4),
//     two stages deep, so tile j + 1 loads while tile j computes.
//   * Q is pre-scaled and staged once; at D <= 64 each warp splits its Q
//     fragments once into registers, at D >= 128 (where they would cost
//     D registers a thread) it splits them from shared memory per tile.
//   * S = Q K^T lands in the m16n8 accumulator, where each query row's
//     scores sit in the four lanes of a quad: the row max and the partial
//     sums need two __shfl_xor_sync each.  The online softmax runs in
//     registers, in log2 units (log2 e folded into Q's scale, exp2f; a
//     row whose running max is still -inf keeps p = 0, alpha = 1; the
//     denominator is clamped at 1e-30).  P goes through a per-warp
//     shared-memory slab, because the accumulator layout is not the A
//     operand layout, and O += P V runs from it.
//   * The tensor cores' float32 accumulation truncates, so no long chain
//     of mma adds is kept: the small cross terms of S get an accumulator of
//     their own, and each tile's P V goes to a fresh accumulator that joins
//     O in one rounded FMA (at D = 256, where that would spill, into O
//     directly).  With one accumulator for everything, jamba's width-128
//     scoring case read 1.9e-5 against the plain version on an H100; with
//     this, 4.9e-6.
//
// Bound on the H100: operations at scoring length.  The causal pairs times
// 2 (dq + dv) FLOPs over the 3xTF32 rate, 495 / 3 = 165 TFLOP/s of dense
// TF32 tensor-core work (the exponentials, one per pair over the
// special-function units, and the bytes are smaller).  What this design
// leaves on the table: mma.sync reaches a fraction of the wgmma rate; each
// warp splits the K and V tiles it reads (four times per block), where a
// TMA + wgmma design with a producer warp would split once; at D = 128 one
// block fits an SM.
//
// The 16-bit form computes the TPU kernel's function in the operands'
// dtype (kernels/ref.py: flash_attention_ref):
//   * q, K and V in one dtype (bfloat16 or float16), both products as
//     mma.sync m16n8k16 at that dtype with float32 accumulators.  Their
//     sums are the tensor cores': per step the 16 exact products and the
//     accumulator are truncated toward 0 at 2^-25 of the largest exponent
//     sum and their sum rounded toward 0 (measured on an H100), a chain the
//     plain version emulates (ref._mma_chain), so the two agree bit for
//     bit: a 16-bit p rounds the other way under a logit one ulp off.  Each
//     logit is dot * scale, a rounded float32 multiply (no log2 e folded
//     in: a different float32 p rounds to another 16-bit value).
//   * Keys are walked in the TPU's blocks of 128 from key 0 (T <= 128: one
//     block), one block a tile: the row's running max m moves once per
//     block, over the whole block's scores, masked ones -inf.
//   * p = exp(logit - m) in float32 stays in the S accumulator's registers
//     and is rounded to V's dtype where it becomes the A operand of P V (the
//     m16n8 accumulator of two key tiles is the A fragment of one k-step):
//     no shared-memory P slab.  l sums the unrounded p; per block
//     l = alpha l + sum(p) and O = alpha O + P V, the block's P V in an
//     accumulator of its own (16 output columns at a time), alpha =
//     exp(m_prev - m); no product or sum here is contracted into an FMA,
//     as the TPU kernel's are not.  The output is O / max(l, 1e-30),
//     rounded once to q's dtype.
//   * One block per (64 queries, head, batch) as above, 4 warps of 16 rows;
//     Q, K and V tiles in shared memory at 16 bits (rows of D + 8 elements:
//     ldmatrix rows on distinct banks), fragments by ldmatrix (V's
//     transposed), copies by cp.async (16, 8 or 4 bytes by width and
//     alignment, 2-byte loads otherwise), two stages at D <= 64, one
//     above.  Causal work is skipped per warp: tiles above its rows, and
//     in a diagonal tile the 16-key steps past its last row.
// Bound on the H100: the exponentials at gpt2-xl's scoring shape (one per
// causal pair over the special-function units, 16 / SM / clock), the
// products (2 (dq + dv) FLOPs a pair at 989 TFLOP/s) at 128-wide heads.
// What it leaves: mma.sync, not wgmma; every warp loads its own K and V
// fragments; no producer warp or TMA (ROADMAP B item 1).
#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include "common.cuh"

// The build compiles this file in CLOVER_PARTS objects in parallel
// (kernels/_build.py: PARTS), each with -DCLOVER_PART=p: part 0 holds the
// float32 form and the entry points, part 1 the bfloat16 forms (flash and
// window), part 2 the float16 ones.  Without them one object holds every
// part.
#ifdef CLOVER_PART
#define CLOVER_HOLDS(p) (CLOVER_PART == (p) % CLOVER_PARTS)
#else
#define CLOVER_HOLDS(p) 1
#endif

namespace clover {
namespace flash16 {

struct Args {
  const uint16_t* q;
  const uint16_t* k;
  const uint16_t* v;
  uint16_t* out;
  int B, S, T, H, KV, dq, dv, width;
  float scale;
  cudaStream_t stream;
};

// the 16-bit form's launch (kBF16: bfloat16, else float16), in part 1 / 2
template <bool kBF16>
int launch16(const Args& a);

// the window form's operands: K and V read through their batch, position
// and head strides (elements; unit stride along the width)
struct WindowArgs {
  const uint16_t* q;
  const uint16_t* k;
  const uint16_t* v;
  uint16_t* out;
  int B, S, T, H, KV, dq, dv, width;
  long long ks_b, ks_t, ks_h, vs_b, vs_t, vs_h;
  float scale;
  int scale_first;
  cudaStream_t stream;
};

// the window form's launch, in part 1 / 2 as launch16
template <bool kBF16>
int launch_window16(const WindowArgs& a);

}  // namespace flash16
}  // namespace clover

#if CLOVER_HOLDS(0)
namespace clover {
namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * kWarp;
constexpr int kBQ = 16 * kWarps;   // query rows per block

// float32 -> TF32 (round to nearest, ties away), as a float32 bit pattern
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in 3xTF32, the small terms first
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4],
                                     const uint32_t (&bb)[2],
                                     const uint32_t (&bs)[2]) {
  mma_tf32(d, as, bb);
  mma_tf32(d, ab, bs);
  mma_tf32(d, ab, bb);
}

// Shared-memory row strides (floats), chosen so the fragment reads hit 32
// distinct banks: Q, K and P rows read as (row = lane / 4, col = lane % 4)
// need a stride = 4 mod 32; V rows read as (row = lane % 4, col = lane / 4)
// need 8 mod 32.
template <int D, int BK>
struct Plan {
  static constexpr int QS = D + 4, KS = D + 4, VS = D + 8, PS = BK + 4;
  static constexpr size_t floats =
      static_cast<size_t>(kBQ) * QS + 2 * BK * (KS + VS) + kWarps * 16 * PS;
};

template <int D, int BK>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ out, int S,
             int T, int H, int KV, int dq, int dv, float scale) {
  using P = Plan<D, BK>;
  constexpr int QS = P::QS, KS = P::KS, VS = P::VS, PS = P::PS;
  constexpr int NK = D / 8;       // k-steps of Q K^T, n-tiles of P V
  constexpr int NT = BK / 8;      // n-tiles of Q K^T, k-steps of P V
  constexpr bool kQRegs = D <= 64;
  constexpr bool kTileAcc = D <= 128;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  const int grp = lane >> 2, tig = lane & 3;
  float* sQ = smem;
  float* sK = sQ + kBQ * QS;                 // [2][BK][KS]
  float* sV = sK + 2 * BK * KS;              // [2][BK][VS]
  float* sP = sV + 2 * BK * VS + warp * 16 * PS;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kv = h / (H / KV);
  const int q0 = qt * kBQ;
  const int nq = min(kBQ, S - q0);
  const int q_offset = T - S;
  const int t_end = q_offset + q0 + nq;      // keys visible to the block
  const int n_tiles = (t_end + BK - 1) / BK;
  const int pos0 = q_offset + q0 + warp * 16;  // the warp's first row
  // scores in log2 units: softmax by exp2f, the same ratios as exp
  const float qscale = scale * 1.4426950408889634f;

  for (int i = tid; i < 2 * BK * (KS + VS); i += kThreads) sK[i] = 0.f;
  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    sQ[r * QS + c] =
        r < nq && c < dq
            ? q[((static_cast<size_t>(b) * S + q0 + r) * H + h) * dq + c] *
                  qscale
            : 0.f;
  }
  __syncthreads();

  const bool vec = dq % 4 == 0 && dv % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0;
  // stage key tile j: rows at or past t_end are zero-filled
  auto load_tile = [&](int j) {
    const int t0 = j * BK;
    float* dk = sK + (j & 1) * BK * KS;
    float* dvs = sV + (j & 1) * BK * VS;
    const size_t row0 = static_cast<size_t>(b) * T;
    if (vec) {
      const int ck = dq / 4, cv = dv / 4;
      for (int i = tid; i < BK * ck; i += kThreads) {
        const int r = i / ck, c = (i % ck) * 4;
        const bool ok = t0 + r < t_end;
        cp_async<16>(dk + r * KS + c,
                     k + ((row0 + (ok ? t0 + r : 0)) * KV + kv) * dq + c, ok);
      }
      for (int i = tid; i < BK * cv; i += kThreads) {
        const int r = i / cv, c = (i % cv) * 4;
        const bool ok = t0 + r < t_end;
        cp_async<16>(dvs + r * VS + c,
                     v + ((row0 + (ok ? t0 + r : 0)) * KV + kv) * dv + c, ok);
      }
    } else {
      for (int i = tid; i < BK * dq; i += kThreads) {
        const int r = i / dq, c = i % dq;
        const bool ok = t0 + r < t_end;
        cp_async<4>(dk + r * KS + c,
                    k + ((row0 + (ok ? t0 + r : 0)) * KV + kv) * dq + c, ok);
      }
      for (int i = tid; i < BK * dv; i += kThreads) {
        const int r = i / dv, c = i % dv;
        const bool ok = t0 + r < t_end;
        cp_async<4>(dvs + r * VS + c,
                    v + ((row0 + (ok ? t0 + r : 0)) * KV + kv) * dv + c, ok);
      }
    }
    cp_async_commit();
  };

  // this warp's Q rows as A fragments (big, small)
  const float* wq = sQ + warp * 16 * QS;
  auto q_frag = [&](int kk, uint32_t(&ab)[4], uint32_t(&as)[4]) {
    const float* p = wq + kk * 8;
    split(p[grp * QS + tig], ab[0], as[0]);
    split(p[(grp + 8) * QS + tig], ab[1], as[1]);
    split(p[grp * QS + tig + 4], ab[2], as[2]);
    split(p[(grp + 8) * QS + tig + 4], ab[3], as[3]);
  };
  uint32_t qb[kQRegs ? NK : 1][4], qsm[kQRegs ? NK : 1][4];
  if constexpr (kQRegs) {
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) q_frag(kk, qb[kk], qsm[kk]);
  }

  // rows grp and grp + 8 of the warp's tile: running max, lane-partial
  // sums, and O in the accumulator layout
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[NK][4];
#pragma unroll
  for (int n = 0; n < NK; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  if (n_tiles > 0) load_tile(0);
  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {
      load_tile(j + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int t0 = j * BK;
    if (t0 <= pos0 + 15) {            // else the tile is above every row
      const float* cK = sK + (j & 1) * BK * KS;
      const float* cV = sV + (j & 1) * BK * VS;
      // big x big terms in sc, the small cross terms in ss: the tensor
      // cores' accumulation truncates, so each chain of mma adds is kept
      // short and relative to its own magnitude; the two meet in one
      // rounded float32 add
      float sc[NT][4], ss[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = ss[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        uint32_t ab[4], as[4];
        if constexpr (kQRegs) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ab[e] = qb[kk][e];
            as[e] = qsm[kk][e];
          }
        } else {
          q_frag(kk, ab, as);
        }
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const float* kr = cK + (n * 8 + grp) * KS + kk * 8 + tig;
          uint32_t bb[2], bs[2];
          split(kr[0], bb[0], bs[0]);
          split(kr[4], bb[1], bs[1]);
          mma_tf32(ss[n], as, bb);
          mma_tf32(ss[n], ab, bs);
          mma_tf32(sc[n], ab, bb);
        }
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] += ss[n][e];
      if (t0 + BK - 1 > pos0) {         // the tile crosses the diagonal
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = t0 + n * 8 + 2 * tig + (e & 1);
            if (key > pos0 + grp + 8 * (e >> 1)) sc[n][e] = -INFINITY;
          }
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int n = 0; n < NT; ++n)
          mx = fmaxf(mx, fmaxf(sc[n][2 * r], sc[n][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[r], mx);
        alpha[r] = m_new == -INFINITY ? 1.f : exp2f(m[r] - m_new);
        m[r] = m_new;
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const float p = m[r] == -INFINITY ? 0.f : exp2f(sc[n][e] - m[r]);
          sc[n][e] = p;
          rs[r] += p;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
      // O = alpha O + P V.  At D <= 128 the tile's P V goes to a fresh
      // accumulator first (24 truncating mma adds, not 24 per tile over
      // the whole row) and joins O in one rounded float32 FMA
      float ot[kTileAcc ? NK : 1][4];
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if constexpr (kTileAcc) {
            ot[n][e] = 0.f;
          } else {
            o[n][e] *= alpha[e >> 1];
          }
        }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        float* p0 = sP + grp * PS + n * 8 + 2 * tig;
        p0[0] = sc[n][0];
        p0[1] = sc[n][1];
        p0[8 * PS] = sc[n][2];
        p0[8 * PS + 1] = sc[n][3];
      }
      __syncwarp();
#pragma unroll
      for (int kk = 0; kk < NT; ++kk) {
        uint32_t ab[4], as[4];
        const float* pp = sP + kk * 8;
        split(pp[grp * PS + tig], ab[0], as[0]);
        split(pp[(grp + 8) * PS + tig], ab[1], as[1]);
        split(pp[grp * PS + tig + 4], ab[2], as[2]);
        split(pp[(grp + 8) * PS + tig + 4], ab[3], as[3]);
#pragma unroll
        for (int n = 0; n < NK; ++n) {
          const float* vr = cV + (kk * 8 + tig) * VS + n * 8 + grp;
          uint32_t bb[2], bs[2];
          split(vr[0], bb[0], bs[0]);
          split(vr[4 * VS], bb[1], bs[1]);
          if constexpr (kTileAcc)
            mma3(ot[n], ab, as, bb, bs);
          else
            mma3(o[n], ab, as, bb, bs);
        }
      }
      if constexpr (kTileAcc) {
#pragma unroll
        for (int n = 0; n < NK; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            o[n][e] = fmaf(o[n][e], alpha[e >> 1], ot[n][e]);
      }
      __syncwarp();
    }
    __syncthreads();                    // the stage may now be refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int r = warp * 16 + grp + 8 * (e >> 1);
    if (r >= nq) continue;
    const float inv = 1.f / fmaxf(l[e >> 1], 1e-30f);
    float* orow =
        out + ((static_cast<size_t>(b) * S + q0 + r) * H + h) * dv;
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      const int c = n * 8 + 2 * tig + (e & 1);
      if (c < dv) orow[c] = o[n][e] * inv;
    }
  }
}

template <int D, int BK>
int launch(const float* q, const float* k, const float* v, float* out, int B,
           int S, int T, int H, int KV, int dq, int dv, float scale,
           cudaStream_t stream) {
  const size_t smem = Plan<D, BK>::floats * sizeof(float);
  cudaError_t err = allow_smem(flash_kernel<D, BK>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_kernel<D, BK><<<grid, kThreads, smem, stream>>>(q, k, v, out, S, T, H,
                                                        KV, dq, dv, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace clover

#endif  // CLOVER_HOLDS(0)

#if CLOVER_HOLDS(1) || CLOVER_HOLDS(2)
namespace clover {
namespace flash16 {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * kWarp;
constexpr int kBQ = 16 * kWarps;   // query rows per block
constexpr int kBK = 128;           // keys a tile: the TPU kernel's block

template <bool kBF16>
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  if constexpr (kBF16) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
  } else {
    const __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
}

template <bool kBF16>
__device__ __forceinline__ uint16_t round16(float x) {
  if constexpr (kBF16)
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  else
    return __half_as_ushort(__float2half_rn(x));
}

// d += a b: m16n8k16, 16-bit operands, float32 accumulator
template <bool kBF16>
__device__ __forceinline__ void mma16(float (&d)[4], const uint32_t (&a)[4],
                                      uint32_t b0, uint32_t b1) {
  if constexpr (kBF16)
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 16-bit matrices from shared memory, lane l giving the address
// of row l % 8 of matrix l / 8 (kTrans: each matrix transposed)
template <bool kTrans>
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const uint16_t* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  if constexpr (kTrans)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a));
}

// Rows [0, n) of a slab of width elements whose row r starts at src + r *
// ld, into rows of RS elements at dst; rows [n, R) are zero-filled.  VE
// elements a copy: cp.async of 2 VE bytes, or 2-byte loads at VE = 1.
template <int VE, int R>
__device__ __forceinline__ void stage(uint16_t* dst, int RS,
                                      const uint16_t* src, size_t ld, int n,
                                      int width) {
  const int cw = width / VE;
  for (int i = threadIdx.x; i < R * cw; i += kThreads) {
    const int r = i / cw, c = (i % cw) * VE;
    const bool ok = r < n;
    const uint16_t* s = src + static_cast<size_t>(ok ? r : 0) * ld + c;
    if constexpr (VE > 1)
      cp_async<2 * VE>(dst + r * RS + c, s, ok);
    else
      dst[r * RS + c] = ok ? *s : uint16_t{0};
  }
}

// the copy width every slab of a launch takes: VE elements, VE | dq, dv and
// every base address 2 VE-byte aligned
__device__ __forceinline__ int copy_width(const Args& a) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(a.q) |
                         reinterpret_cast<uintptr_t>(a.k) |
                         reinterpret_cast<uintptr_t>(a.v);
  for (int ve = 8; ve > 1; ve /= 2)
    if (a.dq % ve == 0 && a.dv % ve == 0 && addr % (2 * ve) == 0) return ve;
  return 1;
}

template <int R>
__device__ __forceinline__ void stage_slab(uint16_t* dst, int RS,
                                          const uint16_t* src, size_t ld,
                                          int n, int width, int ve) {
  switch (ve) {
    case 8: stage<8, R>(dst, RS, src, ld, n, width); break;
    case 4: stage<4, R>(dst, RS, src, ld, n, width); break;
    case 2: stage<2, R>(dst, RS, src, ld, n, width); break;
    default: stage<1, R>(dst, RS, src, ld, n, width);
  }
}

template <int D>
struct Plan {
  static constexpr int RS = D + 8;            // row stride, elements
  static constexpr int kStages = D <= 64 ? 2 : 1;
  // each warp keeps its Q fragments in registers up to D = 128; wider
  // ones (D registers a thread) are read from shared memory per tile
  static constexpr bool kQRegs = D <= 128;
  static constexpr size_t elems =
      static_cast<size_t>(kBQ) * RS + 2 * kStages * kBK * RS;
};

// zero the columns past dq / dv of the Q, K and V slabs once: the copies
// never write them, and their zeros add exact zeros
template <int D>
__device__ __forceinline__ void zero_tails(uint16_t* sQ, uint16_t* sK,
                                           uint16_t* sV, int dq, int dv) {
  constexpr int RS = Plan<D>::RS, kStages = Plan<D>::kStages;
  for (int i = threadIdx.x; i < kBQ * (D - dq); i += kThreads)
    sQ[i / (D - dq) * RS + dq + i % (D - dq)] = 0;
  for (int i = threadIdx.x; i < kStages * kBK * (D - dq); i += kThreads)
    sK[i / (D - dq) * RS + dq + i % (D - dq)] = 0;
  for (int i = threadIdx.x; i < kStages * kBK * (D - dv); i += kThreads)
    sV[i / (D - dv) * RS + dv + i % (D - dv)] = 0;
  __syncthreads();
}

// S = Q K^T over a 128-key tile, 16 keys (two n-tiles) at a time, the
// 16-key steps at or past kmax left at 0
template <int D, bool kBF16>
__device__ __forceinline__ void score_tile(float (&sc)[kBK / 8][4],
                                           const uint16_t* cK,
                                           uint32_t (*qa)[4],
                                           const uint16_t* wq, int kmax,
                                           int lane) {
  constexpr int RS = Plan<D>::RS, NK = D / 16;
  const int lrow = lane & 7, lmat = lane >> 3;
#pragma unroll
  for (int np = 0; np < kBK / 16; ++np) {
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[2 * np][e] = sc[2 * np + 1][e] = 0.f;
    if (np * 16 < kmax) {
      const uint16_t* kr =
          cK + (np * 16 + (lmat >> 1) * 8 + lrow) * RS + (lmat & 1) * 8;
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        uint32_t bk[4], qf[4];
        ldsm4<false>(bk, kr + kk * 16);
        if constexpr (Plan<D>::kQRegs) {
#pragma unroll
          for (int e = 0; e < 4; ++e) qf[e] = qa[kk][e];
        } else {
          ldsm4<false>(qf, wq + kk * 16);
        }
        mma16<kBF16>(sc[2 * np], qf, bk[0], bk[1]);
        mma16<kBF16>(sc[2 * np + 1], qf, bk[2], bk[3]);
      }
    }
  }
}

// in a tile that crosses the warp's diagonal, keys past a row -inf
__device__ __forceinline__ void mask_tile(float (&sc)[kBK / 8][4], int t0,
                                          int pos0, int lane) {
  if (t0 + kBK - 1 <= pos0) return;
  const int grp = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = t0 + n * 8 + 2 * tig + (e & 1);
      if (key > pos0 + grp + 8 * (e >> 1)) sc[n][e] = -INFINITY;
    }
}

template <int D, bool kBF16>
__global__ void __launch_bounds__(kThreads) flash16_kernel(Args a) {
  using P = Plan<D>;
  constexpr int RS = P::RS, kStages = P::kStages;
  constexpr int NK = D / 16;      // k-steps of Q K^T, column pairs of P V
  constexpr int NT = kBK / 8;     // key tiles of 8 a block
  constexpr bool kQRegs = P::kQRegs;
  extern __shared__ __align__(16) uint16_t sm16[];
  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  const int grp = lane >> 2, tig = lane & 3;
  uint16_t* sQ = sm16;
  uint16_t* sK = sQ + kBQ * RS;                      // [stages][kBK][RS]
  uint16_t* sV = sK + kStages * kBK * RS;            // [stages][kBK][RS]
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kv = h / (a.H / a.KV);
  const int q0 = qt * kBQ;
  const int nq = min(kBQ, a.S - q0);
  const int q_offset = a.T - a.S;
  const int t_end = q_offset + q0 + nq;      // keys visible to the block
  const int n_tiles = (t_end + kBK - 1) / kBK;
  const int pos0 = q_offset + q0 + warp * 16;  // the warp's first row
  const bool live = warp * 16 < nq;            // the warp holds a query
  const int ve = copy_width(a);

  zero_tails<D>(sQ, sK, sV, a.dq, a.dv);

  const size_t ldk = static_cast<size_t>(a.KV) * a.dq;
  const size_t ldv = static_cast<size_t>(a.KV) * a.dv;
  auto load_tile = [&](int j) {
    const int t0 = j * kBK;
    const size_t row0 = static_cast<size_t>(b) * a.T + t0;
    stage_slab<kBK>(sK + (j % kStages) * kBK * RS, RS,
                    a.k + (row0 * a.KV + kv) * a.dq, ldk, t_end - t0, a.dq,
                    ve);
    stage_slab<kBK>(sV + (j % kStages) * kBK * RS, RS,
                    a.v + (row0 * a.KV + kv) * a.dv, ldv, t_end - t0, a.dv,
                    ve);
    cp_async_commit();
  };
  stage_slab<kBQ>(sQ, RS,
                  a.q + ((static_cast<size_t>(b) * a.S + q0) * a.H + h) * a.dq,
                  static_cast<size_t>(a.H) * a.dq, nq, a.dq, ve);
  if (n_tiles > 0) load_tile(0);

  // lane l addresses row l % 8 of ldmatrix matrix l / 8
  const int lrow = lane & 7, lmat = lane >> 3;
  // this warp's Q rows: the A fragment of k-step kk
  const uint16_t* wq = sQ + (warp * 16 + (lmat & 1) * 8 + lrow) * RS +
                       (lmat >> 1) * 8;
  uint32_t qa[kQRegs ? NK : 1][4];

  // rows grp and grp + 8 of the warp's tile: running max and sum (the
  // same in the quad's four lanes), O in the accumulator layout
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[2 * NK][4];
#pragma unroll
  for (int n = 0; n < 2 * NK; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    if constexpr (kStages == 2) {
      if (j + 1 < n_tiles) {
        load_tile(j + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (kQRegs) {
      if (j == 0) {
#pragma unroll
        for (int kk = 0; kk < NK; ++kk) ldsm4<false>(qa[kk], wq + kk * 16);
      }
    }
    const int t0 = j * kBK;
    // keys of the tile at or before the warp's last row
    const int kmax = min(kBK, pos0 + 16 - t0);
    if (live && kmax > 0) {
      const uint16_t* cK = sK + (j % kStages) * kBK * RS;
      const uint16_t* cV = sV + (j % kStages) * kBK * RS;
      float sc[NT][4];
      score_tile<D, kBF16>(sc, cK, qa, wq, kmax, lane);
      // logits: dot * scale; in a tile that crosses the warp's diagonal,
      // keys past a row (or past kmax) -inf
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = __fmul_rn(sc[n][e], a.scale);
      mask_tile(sc, t0, pos0, lane);
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int n = 0; n < NT; ++n)
          mx = fmaxf(mx, fmaxf(sc[n][2 * r], sc[n][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[r], mx);   // finite: key 0 is seen
        alpha[r] = expf(m[r] - m_new);
        m[r] = m_new;
      }
      // p in float32 for l; rounded to V's dtype as the P V A fragments
      uint32_t pk[NT][2];
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = expf(sc[n][e] - m[e >> 1]);
          rs[e >> 1] = __fadd_rn(rs[e >> 1], p[e]);
        }
        pk[n][0] = pack<kBF16>(p[0], p[1]);
        pk[n][1] = pack<kBF16>(p[2], p[3]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rs[r] = __fadd_rn(rs[r], __shfl_xor_sync(0xffffffffu, rs[r], 1));
        rs[r] = __fadd_rn(rs[r], __shfl_xor_sync(0xffffffffu, rs[r], 2));
        l[r] = __fadd_rn(__fmul_rn(alpha[r], l[r]), rs[r]);
      }
      // O = alpha O + P V, 16 output columns at a time, the block's P V in
      // an accumulator of its own
      const uint16_t* vr =
          cV + ((lmat & 1) * 8 + lrow) * RS + (lmat >> 1) * 8;
#pragma unroll
      for (int np = 0; np < NK; ++np) {
        float ot[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int kk = 0; kk < NT / 2; ++kk) {
          if (kk * 16 < kmax) {
            uint32_t bv[4];
            ldsm4<true>(bv, vr + kk * 16 * RS + np * 16);
            const uint32_t pa[4] = {pk[2 * kk][0], pk[2 * kk][1],
                                    pk[2 * kk + 1][0], pk[2 * kk + 1][1]};
            mma16<kBF16>(ot[0], pa, bv[0], bv[1]);
            mma16<kBF16>(ot[1], pa, bv[2], bv[3]);
          }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            o[2 * np + i][e] =
                __fadd_rn(__fmul_rn(o[2 * np + i][e], alpha[e >> 1]),
                          ot[i][e]);
      }
    }
    __syncthreads();                    // the stage may now be refilled
    if constexpr (kStages == 1) {
      if (j + 1 < n_tiles) load_tile(j + 1);
    }
  }

#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int r = warp * 16 + grp + 8 * (e >> 1);
    if (r >= nq) continue;
    const float den = fmaxf(l[e >> 1], 1e-30f);
    uint16_t* orow =
        a.out + ((static_cast<size_t>(b) * a.S + q0 + r) * a.H + h) * a.dv;
#pragma unroll
    for (int n = 0; n < 2 * NK; ++n) {
      const int c = n * 8 + 2 * tig + (e & 1);
      if (c < a.dv) orow[c] = round16<kBF16>(__fdiv_rn(o[n][e], den));
    }
  }
}

template <int D, bool kBF16>
int launch_width(const Args& a) {
  const size_t smem = Plan<D>::elems * sizeof(uint16_t);
  cudaError_t err = allow_smem(flash16_kernel<D, kBF16>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.S + kBQ - 1) / kBQ, a.H, a.B);
  flash16_kernel<D, kBF16><<<grid, kThreads, smem, a.stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool kBF16>
int launch16(const Args& a) {
  switch (a.width) {
    case 32: return launch_width<32, kBF16>(a);
    case 64: return launch_width<64, kBF16>(a);
    case 128: return launch_width<128, kBF16>(a);
    case 256: return launch_width<256, kBF16>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---- the window form ------------------------------------------------------
// The reference's XLA attention over a cache window at a 16-bit compute
// dtype (repro/models/layers.py: _causal_attention_chunked, and the masked
// path within ATTN_CHUNK queries; kernels/ref.py: window_attention_ref):
//   * x = dot(q, k) on the tensor cores (the chains above) rounded to the
//     compute dtype (round to nearest even, as XLA's convert); scaled in
//     float32 after the cast (the chunked path), or, with scale_first (the
//     masked path), by the scale rounded to the dtype with the product
//     rounded again before it.  Keys past a row's position give exp = 0.
//   * The softmax covers the whole row: no TPU blocks.  Each block (64
//     query rows of one head, 4 warps of 16, as flash16_kernel) sweeps its
//     visible keys twice in 128-key tiles: sweep 1 takes the row max m and
//     l = sum exp(x - m) online (per tile l = alpha l + sum, alpha =
//     exp(m_prev - m), the tile's sum in the lanes' order); sweep 2 takes
//     the same logits again, p = exp(x - m) / l (correctly rounded, as
//     jax.nn.softmax divides) rounded to V's dtype as the P V A fragment,
//     each tile's P V in an accumulator of its own added to O.  The output
//     is O rounded once.  No product or sum is contracted into an FMA.
//   * K and V are read through their batch, position and head strides, so
//     a cache window's views cache[:, :end, :, :d] reach the kernel as they
//     lie.  Staging, fragments and widths are flash16_kernel's.
// Bound on the H100 (the function's work): one Q K^T and one P V a causal
// pair on the tensor cores (2 (dq + dv) FLOPs at 989 TFLOP/s), one
// exponential a pair on the special-function units, q, K and V read once
// and the output written once; at 64-wide heads the bytes bound it.  The
// two sweeps make this design's own floor higher: twice the Q K^T FLOPs
// and the exponentials.  It replaces no TPU kernel: the reference runs
// XLA here.

template <bool kBF16>
__device__ __forceinline__ float round_trip(float x) {
  if constexpr (kBF16)
    return __bfloat162float(__float2bfloat16_rn(x));
  else
    return __half2float(__float2half_rn(x));
}

// the copy width of a window launch: VE | dq, dv, every stride, and every
// base address 2 VE-byte aligned
__device__ __forceinline__ int window_copy_width(const WindowArgs& a) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(a.q) |
                         reinterpret_cast<uintptr_t>(a.k) |
                         reinterpret_cast<uintptr_t>(a.v);
  const long long strides =
      a.ks_b | a.ks_t | a.ks_h | a.vs_b | a.vs_t | a.vs_h;
  for (int ve = 8; ve > 1; ve /= 2)
    if (a.dq % ve == 0 && a.dv % ve == 0 && addr % (2 * ve) == 0 &&
        strides % ve == 0)
      return ve;
  return 1;
}

template <int D, bool kBF16>
__global__ void __launch_bounds__(kThreads) window16_kernel(WindowArgs a) {
  using P = Plan<D>;
  constexpr int RS = P::RS, kStages = P::kStages;
  constexpr int NK = D / 16;      // k-steps of Q K^T, column pairs of P V
  constexpr int NT = kBK / 8;     // key tiles of 8 a block
  constexpr bool kQRegs = P::kQRegs;
  extern __shared__ __align__(16) uint16_t sm16[];
  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  const int grp = lane >> 2, tig = lane & 3;
  uint16_t* sQ = sm16;
  uint16_t* sK = sQ + kBQ * RS;                      // [stages][kBK][RS]
  uint16_t* sV = sK + kStages * kBK * RS;            // [stages][kBK][RS]
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kv = h / (a.H / a.KV);
  const int q0 = qt * kBQ;
  const int nq = min(kBQ, a.S - q0);
  const int q_offset = a.T - a.S;
  const int t_end = q_offset + q0 + nq;      // keys visible to the block
  const int n_tiles = (t_end + kBK - 1) / kBK;
  const int steps = 2 * n_tiles;             // sweep 1, then sweep 2
  const int pos0 = q_offset + q0 + warp * 16;  // the warp's first row
  const bool live = warp * 16 < nq;            // the warp holds a query
  const int ve = window_copy_width(a);
  const float s16 = round_trip<kBF16>(a.scale);

  zero_tails<D>(sQ, sK, sV, a.dq, a.dv);

  // step j: tile j % n_tiles of sweep j / n_tiles (sweep 2 also stages V)
  auto load_tile = [&](int j) {
    const int t0 = (j % n_tiles) * kBK;
    stage_slab<kBK>(sK + (j % kStages) * kBK * RS, RS,
                    a.k + b * a.ks_b + t0 * a.ks_t + kv * a.ks_h,
                    static_cast<size_t>(a.ks_t), t_end - t0, a.dq, ve);
    if (j >= n_tiles)
      stage_slab<kBK>(sV + (j % kStages) * kBK * RS, RS,
                      a.v + b * a.vs_b + t0 * a.vs_t + kv * a.vs_h,
                      static_cast<size_t>(a.vs_t), t_end - t0, a.dv, ve);
    cp_async_commit();
  };
  stage_slab<kBQ>(sQ, RS,
                  a.q + ((static_cast<size_t>(b) * a.S + q0) * a.H + h) * a.dq,
                  static_cast<size_t>(a.H) * a.dq, nq, a.dq, ve);
  if (steps > 0) load_tile(0);

  const int lrow = lane & 7, lmat = lane >> 3;
  const uint16_t* wq = sQ + (warp * 16 + (lmat & 1) * 8 + lrow) * RS +
                       (lmat >> 1) * 8;
  uint32_t qa[kQRegs ? NK : 1][4];

  // rows grp and grp + 8 of the warp's tile: the max and sum (the same in
  // the quad's four lanes), O in the accumulator layout
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[2 * NK][4];
#pragma unroll
  for (int n = 0; n < 2 * NK; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  for (int j = 0; j < steps; ++j) {
    if constexpr (kStages == 2) {
      if (j + 1 < steps) {
        load_tile(j + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (kQRegs) {
      if (j == 0) {
#pragma unroll
        for (int kk = 0; kk < NK; ++kk) ldsm4<false>(qa[kk], wq + kk * 16);
      }
    }
    const bool second = j >= n_tiles;
    const int t0 = (j % n_tiles) * kBK;
    const int kmax = min(kBK, pos0 + 16 - t0);
    if (live && kmax > 0) {
      const uint16_t* cK = sK + (j % kStages) * kBK * RS;
      const uint16_t* cV = sV + (j % kStages) * kBK * RS;
      float sc[NT][4];
      score_tile<D, kBF16>(sc, cK, qa, wq, kmax, lane);
      // logits: x rounded to the dtype, then scaled (in it, rounded
      // again, with scale_first; else in float32); keys past a row -inf
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = round_trip<kBF16>(sc[n][e]);
          sc[n][e] = a.scale_first ? round_trip<kBF16>(__fmul_rn(x, s16))
                                   : __fmul_rn(x, a.scale);
        }
      mask_tile(sc, t0, pos0, lane);
      if (!second) {
        // sweep 1: the row's max and l, online
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mx = -INFINITY;
#pragma unroll
          for (int n = 0; n < NT; ++n)
            mx = fmaxf(mx, fmaxf(sc[n][2 * r], sc[n][2 * r + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m[r], mx);   // finite: key 0 is seen
          alpha[r] = expf(m[r] - m_new);
          m[r] = m_new;
        }
        float rs[2] = {0.f, 0.f};
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            rs[e >> 1] = __fadd_rn(rs[e >> 1], expf(sc[n][e] - m[e >> 1]));
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          rs[r] = __fadd_rn(rs[r], __shfl_xor_sync(0xffffffffu, rs[r], 1));
          rs[r] = __fadd_rn(rs[r], __shfl_xor_sync(0xffffffffu, rs[r], 2));
          l[r] = __fadd_rn(__fmul_rn(alpha[r], l[r]), rs[r]);
        }
      } else {
        // sweep 2: the normalised p, rounded to V's dtype, and O += P V.
        // p = ex / l correctly rounded, without a division in the loop:
        // q = ex y with y = 1 / l rounded, corrected once by its exact
        // residual (Markstein: exact while q is normal, ex >= 2^-100
        // here); a lane that met a smaller nonzero ex redoes its tile
        // with the division (with a division in the loop the kernel ran
        // 1.3-1.5x slower on an H100)
        uint32_t pk[NT][2];
        const float y[2] = {__frcp_rn(l[0]), __frcp_rn(l[1])};
        bool tiny = false;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          float p[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float ex = expf(sc[n][e] - m[e >> 1]);
            const float q = __fmul_rn(ex, y[e >> 1]);
            p[e] = __fmaf_rn(__fmaf_rn(-q, l[e >> 1], ex), y[e >> 1], q);
            tiny |= ex > 0.f && ex < 0x1p-100f;
          }
          pk[n][0] = pack<kBF16>(p[0], p[1]);
          pk[n][1] = pack<kBF16>(p[2], p[3]);
        }
        if (tiny) {
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            float p[4];
#pragma unroll
            for (int e = 0; e < 4; ++e)
              p[e] = __fdiv_rn(expf(sc[n][e] - m[e >> 1]), l[e >> 1]);
            pk[n][0] = pack<kBF16>(p[0], p[1]);
            pk[n][1] = pack<kBF16>(p[2], p[3]);
          }
        }
        const uint16_t* vr =
            cV + ((lmat & 1) * 8 + lrow) * RS + (lmat >> 1) * 8;
#pragma unroll
        for (int np = 0; np < NK; ++np) {
          float ot[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
          for (int kk = 0; kk < NT / 2; ++kk) {
            if (kk * 16 < kmax) {
              uint32_t bv[4];
              ldsm4<true>(bv, vr + kk * 16 * RS + np * 16);
              const uint32_t pa[4] = {pk[2 * kk][0], pk[2 * kk][1],
                                      pk[2 * kk + 1][0], pk[2 * kk + 1][1]};
              mma16<kBF16>(ot[0], pa, bv[0], bv[1]);
              mma16<kBF16>(ot[1], pa, bv[2], bv[3]);
            }
          }
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              o[2 * np + i][e] = __fadd_rn(o[2 * np + i][e], ot[i][e]);
        }
      }
    }
    __syncthreads();                    // the stage may now be refilled
    if constexpr (kStages == 1) {
      if (j + 1 < steps) load_tile(j + 1);
    }
  }

#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int r = warp * 16 + grp + 8 * (e >> 1);
    if (r >= nq) continue;
    uint16_t* orow =
        a.out + ((static_cast<size_t>(b) * a.S + q0 + r) * a.H + h) * a.dv;
#pragma unroll
    for (int n = 0; n < 2 * NK; ++n) {
      const int c = n * 8 + 2 * tig + (e & 1);
      if (c < a.dv) orow[c] = round16<kBF16>(o[n][e]);
    }
  }
}

template <int D, bool kBF16>
int launch_window_width(const WindowArgs& a) {
  const size_t smem = Plan<D>::elems * sizeof(uint16_t);
  cudaError_t err = allow_smem(window16_kernel<D, kBF16>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.S + kBQ - 1) / kBQ, a.H, a.B);
  window16_kernel<D, kBF16><<<grid, kThreads, smem, a.stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool kBF16>
int launch_window16(const WindowArgs& a) {
  switch (a.width) {
    case 32: return launch_window_width<32, kBF16>(a);
    case 64: return launch_window_width<64, kBF16>(a);
    case 128: return launch_window_width<128, kBF16>(a);
    case 256: return launch_window_width<256, kBF16>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

#if CLOVER_HOLDS(1)
template int launch16<true>(const Args&);
template int launch_window16<true>(const WindowArgs&);
#endif
#if CLOVER_HOLDS(2)
template int launch16<false>(const Args&);
template int launch_window16<false>(const WindowArgs&);
#endif

}  // namespace flash16
}  // namespace clover
#endif  // CLOVER_HOLDS(1) || CLOVER_HOLDS(2)
#if CLOVER_HOLDS(0)
// width: the bucket (32, 64, 128 or 256) that holds max(dq, dv); form: the
// operands' dtype (kernels/clover_attention.py: FORM_CODES), 0 float32, 1
// bfloat16, 2 float16
extern "C" int clover_flash_attention(const void* q, const void* k,
                                      const void* v, void* out, int B,
                                      int S, int T, int H, int KV, int dq,
                                      int dv, int width, int form,
                                      float scale, cudaStream_t stream) {
  using clover::launch;
  if (dq > width || dv > width) return static_cast<int>(cudaErrorInvalidValue);
  if (form == 1 || form == 2) {
    const clover::flash16::Args a{
        static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
        static_cast<const uint16_t*>(v), static_cast<uint16_t*>(out),
        B, S, T, H, KV, dq, dv, width, scale, stream};
    return form == 1 ? clover::flash16::launch16<true>(a)
                     : clover::flash16::launch16<false>(a);
  }
  if (form != 0) return static_cast<int>(cudaErrorInvalidValue);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(out);
  switch (width) {
    case 32: return launch<32, 64>(qf, kf, vf, of, B, S, T, H, KV, dq, dv,
                                   scale, stream);
    case 64: return launch<64, 64>(qf, kf, vf, of, B, S, T, H, KV, dq, dv,
                                   scale, stream);
    case 128: return launch<128, 64>(qf, kf, vf, of, B, S, T, H, KV, dq, dv,
                                     scale, stream);
    case 256: return launch<256, 32>(qf, kf, vf, of, B, S, T, H, KV, dq, dv,
                                     scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K / V strides in elements (batch, position, head); form 1 bfloat16, 2
// float16 (kernels/clover_attention.py: WINDOW_CODES); scale_first: the
// reference's masked path (scale the 16-bit logits before the cast)
extern "C" int clover_window_attention(
    const void* q, const void* k, const void* v, void* out, int B, int S,
    int T, int H, int KV, int dq, int dv, long long ks_b, long long ks_t,
    long long ks_h, long long vs_b, long long vs_t, long long vs_h,
    int width, int form, float scale, int scale_first,
    cudaStream_t stream) {
  if (dq > width || dv > width || (form != 1 && form != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const clover::flash16::WindowArgs a{
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<uint16_t*>(out),
      B, S, T, H, KV, dq, dv, width, ks_b, ks_t, ks_h, vs_b, vs_t, vs_h,
      scale, scale_first, stream};
  return form == 1 ? clover::flash16::launch_window16<true>(a)
                   : clover::flash16::launch_window16<false>(a);
}
#endif  // CLOVER_HOLDS(0)
