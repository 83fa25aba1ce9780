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
//   * The tile pipeline, shared with the window form (below):
//     - GQA heads packed into the rows.  A block owns one (batch, KV head)
//       and 128 (position, head) rows of that head group, row i being
//       position i / G and query head i % G (a position's G heads lie next
//       to each other, as in q's layout), so every K / V tile it stages
//       serves all G heads; each row's causal limit is its own position; a
//       group's ragged last tile masks its rows past the end and writes
//       none of them.  Row tiles run last-first (most keys first).
//     - 8 warps of 16 rows (one m16 tile each; two m16 tiles a warp held
//       twice the scores and spilled at 255 registers).  Q is staged once
//       a warp (ldmatrix rows of D + 8 elements); its fragments stay in
//       registers at D = 64, elsewhere they are read per tile.
//     - K and V in rings of their own, 2-4 stages by width (one at D =
//       256), each slot a 128-key tile as TMA's 64- / 128-byte swizzle
//       writes it (ldmatrix reads eight rows of a 16-byte chunk on 32
//       banks), with full and empty mbarriers.  Warp 0 is the producer:
//       its lane 0 issues one cp.async.bulk.tensor box a 64-column panel
//       (4-D tensor maps over the K / V strides, encoded by the wrapper's
//       launch; rows past T and columns past the width arrive as zeros),
//       or, where a stride or a base is not 16-byte aligned, all its lanes
//       copy by cp.async and arrive on the same barrier.  It stages ahead
//       as far as the slots are free, waiting only for the tile about to
//       be computed and testing the others between its own sections, so
//       the loads run behind the compute.  A ninth, dedicated producer
//       warp would cap every thread at 168 registers (the SM
//       sub-partition holding three of the block's warps) and spilled at
//       every width.
//     - A tile below a warp's diagonal runs as one straight block of
//       ldmatrix / mma (no mask, no skip); in a diagonal tile the 16-key
//       steps past the warp's last row are skipped and their p are 0.
//     - At D = 32 two blocks share an SM (128 registers a thread: O lives
//       in shared memory), above one (255).
//   * Why mma.sync, not wgmma: chip_mma_probe.py --wgmma found wgmma's
//     sums equal to the same emulation on every output, so wgmma may
//     carry these chains; this design keeps mma.sync, whose per-warp
//     16-row tiles fit the packed rows and the per-warp causal skip.
// Bound on the H100: the exponentials at gpt2-xl's scoring shape (one per
// causal pair over the special-function units, 16 / SM / clock), the
// products (2 (dq + dv) FLOPs a pair at 989 TFLOP/s) at 128-wide heads.
// What it leaves: the softmax's ~12 float32 instructions a score (expf's
// range reduction, the scale, the max, the row sum; none can be folded
// without changing a bit) are issued by two warps an SM sub-partition and
// do not overlap the tensor cores' work within a warp; mma.sync reaches a
// fraction of wgmma's rate, and each warp reads its own K / V fragments
// (ROADMAP B item 1).
#include <cuda.h>   // CUtensorMap (the encoder comes from the runtime)
#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include "common.cuh"

// The build compiles this file in CLOVER_PARTS objects in parallel
// (kernels/_build.py: PARTS), each with -DCLOVER_PART=p: part 0 holds the
// float32 form and the entry points, part 1 the bfloat16 flash form, part
// 2 the float16 one, parts 3 and 4 the window form in bfloat16 and
// float16 (with fewer parts, part p holds p modulo their count).  Without
// them one object holds every part.
#ifdef CLOVER_PART
#define CLOVER_HOLDS(p) (CLOVER_PART == (p) % CLOVER_PARTS)
#else
#define CLOVER_HOLDS(p) 1
#endif

namespace clover {
namespace flash16 {

// the 16-bit forms' tile: 128 (position, head) rows of one KV head's group
// (kernels/clover_attention.py: ROWS, which plans the grid)
constexpr int kRows = 128;
// how the producer stages K and V (kernels/clover_attention.py: ROUTES)
constexpr int kRouteCopy = 0, kRouteTma = 1;
// returned (negated) when the driver has no cuTensorMapEncodeTiled
constexpr int kNoEncoder = 100000;

// a 16-bit launch: K and V read through their batch, position and head
// strides (elements; unit stride along the width), q and the output
// contiguous (B, S, H, d)
struct Args {
  const uint16_t* q;
  const uint16_t* k;
  const uint16_t* v;
  uint16_t* out;
  int B, S, T, H, KV, dq, dv, width;
  long long ks_b, ks_t, ks_h, vs_b, vs_t, vs_h;
  float scale;
  int scale_first;      // the window form's masked path
  int tiles;            // row tiles of kRows per (batch, KV head)
  int route;            // kRouteCopy or kRouteTma
  cudaStream_t stream;
};

// the 16-bit flash form's and the window form's launches (kBF16:
// bfloat16, else float16), in part 1 / 2; a negative return is a tensor
// map the driver refused to encode
template <bool kBF16>
int launch16(const Args& a);
template <bool kBF16>
int launch_window16(const Args& a);

// a 16-bit launch of form 1 / 2 (window: the window form) after the plan's
// checks: the tiles the wrapper planned cover the S G rows of a head
// group, and the route is one of the two
inline int launch_checked(const Args& a, int form, bool window) {
  const long long rows = static_cast<long long>(a.S) * (a.H / a.KV);
  if ((form != 1 && form != 2) || a.KV < 1 || a.H % a.KV != 0 ||
      a.tiles != (rows + kRows - 1) / kRows ||
      (a.route != kRouteCopy && a.route != kRouteTma))
    return static_cast<int>(cudaErrorInvalidValue);
  if (window)
    return form == 1 ? launch_window16<true>(a) : launch_window16<false>(a);
  return form == 1 ? launch16<true>(a) : launch16<false>(a);
}

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

#if CLOVER_HOLDS(1) || CLOVER_HOLDS(2) || CLOVER_HOLDS(3) || CLOVER_HOLDS(4)
namespace clover {
namespace flash16 {

constexpr int kWarps = kRows / 16;           // warps of 16 rows
constexpr int kThreads = kWarps * kWarp;
constexpr int kBK = 128;                      // keys a tile: the TPU's block

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

template <bool kBF16>
__device__ __forceinline__ float round_trip(float x) {
  if constexpr (kBF16)
    return __bfloat162float(__float2bfloat16_rn(x));
  else
    return __half2float(__float2half_rn(x));
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

// four 8x8 16-bit matrices from shared memory (a shared-window address),
// lane l giving the address of row l % 8 of matrix l / 8 (kTrans: each
// matrix transposed)
template <bool kTrans>
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t a) {
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

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers and TMA ------------------------------------------------------
__device__ __forceinline__ void bar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// the producer's one arrival of a TMA phase, with the bytes it will deliver
__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(bar), "r"(bytes) : "memory");
}

// an arrival once every cp.async this thread has issued has landed
__device__ __forceinline__ void bar_copies(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];"
               ::"r"(bar) : "memory");
}

// whether the phase of the given parity has completed (no wait)
__device__ __forceinline__ uint32_t bar_test(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done;
}

// Wait for the phase of the given parity.  A phase that never completes
// traps after ~2^31 cycles (a launch error the next synchronize reports)
// instead of holding the card.
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  const long long t0 = clock64();
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (!done && clock64() - t0 > (1ll << 31)) __trap();
  } while (!done);
}

// one box of a 4-D tensor map (width, head, position, batch) into shared
// memory, its bytes reported to bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap& map,
                                         int c0, int c1, int c2, int c3,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(&map)), "r"(c0), "r"(c1),
        "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// ---- the shared tile pipeline -------------------------------------------------
template <int D>
struct Plan {
  // a K or V tile as TMA's swizzle writes it: panels of kPanel columns,
  // rows of 2 kPanel bytes whose 16-byte chunks are XOR-permuted by the
  // row (64-byte swizzle at D = 32, 128-byte above), so ldmatrix reads
  // eight rows of one chunk on 32 distinct banks
  static constexpr int kPanel = D == 32 ? 32 : 64;
  static constexpr int kPanelBytes = kBK * kPanel * 2;
  static constexpr int kTileBytes = kBK * D * 2;
  // blocks an SM: two at D = 32 (128 registers a thread, 16 warps an SM),
  // one above (255 registers)
  static constexpr int kMinBlocks = D == 32 ? 2 : 1;
  // K / V stages in each ring (two at least up to D = 128)
  static constexpr int kStages = D == 32 ? 4 : D == 64 ? 3 : D == 128 ? 2 : 1;
  static constexpr int QS = D + 8;           // Q row stride (elements)
  // Q's fragments stay in registers at D = 64; at D = 32 (128 registers)
  // and from D = 128 (D / 4 registers) they are read from shared memory
  // per tile
  static constexpr bool kQRegs = D == 64;
  // a tile below the warp's diagonal runs as one straight block at D = 64
  // and 128; at D = 32 the second copy of the tile's code spilled at 128
  // registers, and D = 256 (which spills anyway) is not worth its build
  static constexpr bool kSplit = D == 64 || D == 128;
  // with two blocks an SM the output accumulators live in shared memory
  // (D / 2 floats a thread) and the window form streams its P V
  static constexpr bool kOSmem = kMinBlocks > 1;
  static constexpr size_t kStageBytes = 2 * static_cast<size_t>(kTileBytes);
  static constexpr size_t kOBytes =
      kOSmem ? static_cast<size_t>(kThreads) * (D / 2) * 4 : 0;
  // 1024 bytes of slack to align the stages (the 128-byte swizzle repeats
  // every 1024 bytes), the stages (a K and a V slot each), Q, the output
  // accumulators (kOSmem), then a full and an empty mbarrier a slot and
  // the producer's two step counters
  static constexpr size_t bytes = 1024 + kStages * kStageBytes +
                                  static_cast<size_t>(kRows) * QS * 2 +
                                  kOBytes + 4 * kStages * 8 + 8;
};

// byte offset of 16-byte chunk c of row r in a K / V tile
template <int D>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  if constexpr (D == 32)
    return r * 64 + ((c ^ ((r >> 1) & 3)) << 4);
  else
    return (c >> 3) * Plan<D>::kPanelBytes + r * 128 +
           (((c & 7) ^ (r & 7)) << 4);
}

// A lane's ldmatrix addresses in a K / V tile: row rl + 16 i, chunk 2 j +
// cl (rl < 16, cl < 2; i, j unrolled), swz's offsets.  Chunk 2 j + cl of
// row rl lands at chunk (cl ^ x) ^ 2 j (x the row's XOR), so one offset a
// lane holds them all: off0 ^ (j << 5) within a panel.
template <int D>
struct Lanes {
  uint32_t off0;
  __device__ __forceinline__ Lanes(int rl, int cl)
      : off0(D == 32 ? rl * 64 + ((cl ^ ((rl >> 1) & 3)) << 4)
                     : rl * 128 + ((cl ^ (rl & 7)) << 4)) {}
  __device__ __forceinline__ uint32_t at(int i, int j) const {
    if constexpr (D == 32)
      return (off0 ^ (j << 5)) + i * 16 * 64;
    else
      return (off0 ^ ((j & 3) << 5)) + (j >> 2) * Plan<D>::kPanelBytes +
             i * 16 * 128;
  }
};

// The block's rows and keys.  A block owns (batch b, KV head kvh) and
// rows [row0, row0 + kRows) of that head group's S G rows, row i being
// (position i / G, query head kvh G + i % G): a position's G heads lie
// next to each other, as in q's (B, S, H, d) layout, and every K / V tile
// staged serves all of them.  Row tiles run last-first over blockIdx.y, so
// the blocks with the most keys start first.
struct Geo {
  int b, kvh, G, SG, row0, q_offset, t_end, n_tiles;
};

__device__ __forceinline__ Geo geometry(const Args& a) {
  Geo g;
  g.kvh = blockIdx.x % a.KV;
  g.b = blockIdx.x / a.KV;
  g.G = a.H / a.KV;
  g.SG = a.S * g.G;
  g.row0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  g.q_offset = a.T - a.S;
  // keys visible to the block: up to its last row's position
  g.t_end = g.q_offset + (min(g.row0 + kRows, g.SG) - 1) / g.G + 1;
  g.n_tiles = (g.t_end + kBK - 1) / kBK;
  return g;
}

// the (b, s, h) row index of q and the output for group row gi
__device__ __forceinline__ size_t row_index(const Args& a, const Geo& g,
                                            int gi) {
  const int s = gi / g.G;
  return (static_cast<size_t>(g.b) * a.S + s) * a.H + g.kvh * g.G +
         (gi - s * g.G);
}

// A consumer warp's 16 rows from first(g): the positions of this lane's
// rows grp and grp + 8 (the causal limit is each row's own position; rows
// past the group's end take its last row's, finite and never written).
// Only these are held: the first row, whether the warp has one, and the
// positions of its first and last rows (lane 0's first, lane 31's last)
// are taken again where needed, to keep registers free.
struct Rows {
  int pos[2];
  __device__ __forceinline__ int first(const Geo& g) const {
    return g.row0 + 16 * static_cast<int>(threadIdx.x / kWarp);
  }
  __device__ __forceinline__ bool live(const Geo& g) const {
    return first(g) < g.SG;
  }
  __device__ __forceinline__ int pos_first() const {
    return __shfl_sync(0xffffffffu, pos[0], 0);
  }
  __device__ __forceinline__ int pos_last() const {
    return __shfl_sync(0xffffffffu, pos[1], kWarp - 1);
  }
};

__device__ __forceinline__ Rows rows_of(const Geo& g, int lane) {
  Rows r;
  const int first = r.first(g);
#pragma unroll
  for (int h = 0; h < 2; ++h)
    r.pos[h] = g.q_offset + min(first + (lane >> 2) + 8 * h, g.SG - 1) / g.G;
  return r;
}

// the copy width (elements) of a cp.async staging: ve | width, every
// stride, and the base 2 ve-byte aligned
__device__ __forceinline__ int copy_width(const void* base, int width,
                                          long long strides) {
  for (int ve = 8; ve > 1; ve /= 2)
    if (width % ve == 0 && strides % ve == 0 &&
        reinterpret_cast<uintptr_t>(base) % (2 * ve) == 0)
      return ve;
  return 1;
}

// one copy of ve elements (cp.async of 2 ve bytes; a 2-byte load and
// store at ve = 1); an invalid one fills zeros and reads nothing
__device__ __forceinline__ void copy_ve(void* dst, const uint16_t* src,
                                        bool ok, int ve) {
  switch (ve) {
    case 8: cp_async<16>(dst, src, ok); break;
    case 4: cp_async<8>(dst, src, ok); break;
    case 2: cp_async<4>(dst, src, ok); break;
    default: *static_cast<uint16_t*>(dst) = ok ? *src : uint16_t{0};
  }
}

// The producer's staging without TMA: rows [0, n) of a width-wide slab
// whose row r starts at src + r ld into a swizzled tile (rows past n zero;
// columns past width never written, zero from the block's start)
template <int D>
__device__ __forceinline__ void copy_tile(uint8_t* tile, const uint16_t* src,
                                          long long ld, int n, int width,
                                          int ve, int lane) {
  const int cw = width / ve;
  for (int i = lane; i < kBK * cw; i += kWarp) {
    const int r = i / cw, c = (i - r * cw) * ve;
    const bool ok = r < n;
    copy_ve(tile + swz<D>(r, c >> 3) + (c & 7) * 2,
            src + (ok ? r : 0) * ld + c, ok, ve);
  }
}

// The block's shared memory and its start: the slots zeroed where the
// copies never write (columns past dq / dv), the barriers initialised
// (full: the TMA lane's one arrival, or the 32 lanes of warp 0; empty:
// one arrival a warp), the producer's counters (K from step 0, V from step
// v0), all before any copy.  K and V have rings of their own (slot s of
// each in stage s): K of a tile is released after Q K^T, V after P V.
template <int D>
struct Smem {
  uint8_t* stages;
  uint16_t* q;
  float* o;                     // the output accumulators (kOSmem)
  uint32_t fk, fv, ek, ev;      // full / empty barriers of the K / V slots
  int* next;                    // the producer's next K / V step
  __device__ __forceinline__ Smem(uint8_t* raw, const Args& a, int v0) {
    using P = Plan<D>;
    const uint32_t base = saddr(raw);
    stages = raw + (((base + 1023) & ~1023u) - base);
    q = reinterpret_cast<uint16_t*>(stages + P::kStages * P::kStageBytes);
    o = reinterpret_cast<float*>(q + kRows * P::QS);
    fk = saddr(o) + P::kOBytes;
    fv = fk + 8 * P::kStages;
    ek = fv + 8 * P::kStages;
    ev = ek + 8 * P::kStages;
    next = reinterpret_cast<int*>(reinterpret_cast<uint8_t*>(o) + P::kOBytes +
                                  32 * P::kStages);
    if (a.dq < D || a.dv < D) {
      uint4* z = reinterpret_cast<uint4*>(stages);
      for (int i = threadIdx.x; i < P::kStages * P::kStageBytes / 16;
           i += kThreads)
        z[i] = make_uint4(0, 0, 0, 0);
    }
    if (threadIdx.x == 0) {
      next[0] = 0;
      next[1] = v0;
      for (int s = 0; s < P::kStages; ++s) {
        bar_init(fk + 8 * s, a.route == kRouteTma ? 1 : kWarp);
        bar_init(fv + 8 * s, a.route == kRouteTma ? 1 : kWarp);
        bar_init(ek + 8 * s, kWarps);
        bar_init(ev + 8 * s, kWarps);
      }
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    // the zeros (generic writes) before any TMA write (async proxy)
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
  }
  __device__ __forceinline__ uint8_t* k_slot(int s) const {
    return stages + s * Plan<D>::kStageBytes;
  }
  __device__ __forceinline__ uint8_t* v_slot(int s) const {
    return k_slot(s) + Plan<D>::kTileBytes;
  }
};

// The producer: warp 0 (its lane 0 on the TMA route, all its lanes on the
// cp.async route) keeps the rings full.  Step t stages K of key tile t
// into K slot t % kStages once the warps have released the slot's
// previous tile, and V into V slot (t - v0) % kStages (the window form: K
// of tile t % n_tiles for sweep t / n_tiles, V in sweep 2 only, from step
// v0 = n_tiles).  feed stages every step up to `upto` whose slot is free,
// waiting for the slots of steps up to `must` (the step about to be
// computed) and only testing the others, so warp 0 calls it between its
// own sections without stalling on the slowest warp.  The TMA route arms
// the slot's full barrier with the bytes and issues one box a 64-column
// panel (32 at D = 32); rows past T and columns past the width arrive as
// zeros.  The cp.async route copies with all 32 lanes, each arriving on
// the same barrier once its copies have landed.  The next steps to stage
// live in shared memory (Smem::next), read and written by warp 0 alone.
// (A ninth, dedicated producer warp would cap every thread of the block at
// 168 registers -- the SM sub-partition holding three of its warps -- and
// spilled at every width.)
template <int D>
__device__ __forceinline__ void feed(const Args& a, const CUtensorMap& mk,
                                     const CUtensorMap& mv, const Smem<D>& sm,
                                     const Geo& g, bool window, int upto,
                                     int must, int lane) {
  using P = Plan<D>;
  const bool tma = a.route == kRouteTma;
  const int steps = window ? 2 * g.n_tiles : g.n_tiles;
  const int v0 = window ? g.n_tiles : 0;
  upto = min(upto, steps - 1);
  // the slot of use idx of a ring is free once use idx - kStages is
  // released (a warp-uniform answer: lane 0 tests, or all lanes wait)
  auto free = [&](uint32_t empty, int idx, bool wait) {
    if (idx < P::kStages) return true;
    const uint32_t bar = empty + 8 * (idx % P::kStages);
    const uint32_t parity = (idx / P::kStages - 1) & 1;
    if (wait) {
      bar_wait(bar, parity);
      return true;
    }
    return __shfl_sync(0xffffffffu, lane == 0 ? bar_test(bar, parity) : 0,
                       0) != 0;
  };
  auto stage = [&](uint8_t* slot, uint32_t bar, const CUtensorMap& map,
                   const uint16_t* src, long long ld, int width, int t0) {
    const int panels = (width + P::kPanel - 1) / P::kPanel;
    if (tma) {
      if (lane == 0) {
        bar_expect(bar, panels * P::kPanelBytes);
        for (int p = 0; p < panels; ++p)
          tma_load(saddr(slot) + p * P::kPanelBytes, map, p * P::kPanel,
                   g.kvh, t0, g.b, bar);
      }
    } else {
      const int ve =
          min(copy_width(a.k, a.dq, a.ks_b | a.ks_t | a.ks_h),
              copy_width(a.v, a.dv, a.vs_b | a.vs_t | a.vs_h));
      copy_tile<D>(slot, src, ld, min(kBK, a.T - t0), width, ve, lane);
      if (ve > 1)
        bar_copies(bar);
      else
        bar_arrive(bar);
    }
  };
  int k_next = sm.next[0], v_next = sm.next[1];
  while (k_next <= upto && free(sm.ek, k_next, k_next <= must)) {
    const int t = k_next++, s = t % P::kStages;
    const int t0 = (window ? t % g.n_tiles : t) * kBK;
    stage(sm.k_slot(s), sm.fk + 8 * s, mk,
          a.k + g.b * a.ks_b + t0 * a.ks_t + g.kvh * a.ks_h, a.ks_t, a.dq, t0);
  }
  while (v_next <= upto && free(sm.ev, v_next - v0, v_next <= must)) {
    const int t = v_next++, s = (t - v0) % P::kStages;
    const int t0 = (t - v0) * kBK;
    stage(sm.v_slot(s), sm.fv + 8 * s, mv,
          a.v + g.b * a.vs_b + t0 * a.vs_t + g.kvh * a.vs_h, a.vs_t, a.dv, t0);
  }
  __syncwarp();
  if (lane == 0) {
    sm.next[0] = k_next;
    sm.next[1] = v_next;
  }
  __syncwarp();
}

// A warp's output accumulators, this lane's rows grp and grp + 8: n-tile
// n's four values in the m16n8 accumulator layout, in registers, or with
// kOSmem in shared memory, each thread's n-tile n a float4 in a stripe of
// its warp's (32 lanes' float4s side by side, so a warp's access is 512
// contiguous bytes)
template <int D, bool kSmem = Plan<D>::kOSmem>
struct Acc {
  float r[D / 8][4];
  __device__ __forceinline__ explicit Acc(const Smem<D>&) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) r[n][e] = 0.f;
  }
  // o = join(o, pv, row) for n-tile n's four values
  template <typename J>
  __device__ __forceinline__ void merge(int n, const float (&pv)[4],
                                        J join) {
#pragma unroll
    for (int e = 0; e < 4; ++e) r[n][e] = join(r[n][e], pv[e], e >> 1);
  }
  __device__ __forceinline__ float get(int n, int e) const { return r[n][e]; }
};

template <int D>
struct Acc<D, true> {
  float4* base;                 // n-tile 0 of this thread
  __device__ __forceinline__ explicit Acc(const Smem<D>& sm)
      : base(reinterpret_cast<float4*>(sm.o) +
             (threadIdx.x / kWarp) * kWarp * (D / 8) + threadIdx.x % kWarp) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      base[n * kWarp] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  template <typename J>
  __device__ __forceinline__ void merge(int n, const float (&pv)[4],
                                        J join) {
    float4* p = base + n * kWarp;
    float4 v = *p;
    v.x = join(v.x, pv[0], 0);
    v.y = join(v.y, pv[1], 0);
    v.z = join(v.z, pv[2], 1);
    v.w = join(v.w, pv[3], 1);
    *p = v;
  }
  __device__ __forceinline__ float get(int n, int e) const {
    return component(base[n * kWarp], e);
  }
};

// A warp's 16 rows of Q into rows of QS elements (columns past dq and rows
// past the group zero)
template <int D>
__device__ __forceinline__ void stage_q(uint16_t* sq, const Args& a,
                                        const Geo& g, const Rows& rw,
                                        int lane) {
  constexpr int QS = Plan<D>::QS;
  const int ve = copy_width(a.q, a.dq, a.dq);
  const int cw = a.dq / ve;
  const int first = rw.first(g);
  for (int i = lane; i < 16 * cw; i += kWarp) {
    const int r = i / cw, c = (i - r * cw) * ve;
    const bool ok = first + r < g.SG;
    copy_ve(sq + r * QS + c,
            a.q + row_index(a, g, ok ? first + r : first) * a.dq + c, ok,
            ve);
  }
  const int tail = D - a.dq;
  for (int i = lane; i < 16 * tail; i += kWarp)
    sq[i / tail * QS + a.dq + i % tail] = 0;
  cp_async_commit();
  cp_async_wait<0>();
  __syncwarp();
}

// A warp's start: its rows, Q staged and (kQRegs) its Q fragments in
// registers, the lane's ldmatrix addresses
template <int D>
struct Consumer {
  Rows rw;
  uint32_t wq;                 // the lane's Q row for ldmatrix
  Lanes<D> kl, vl;
  uint32_t qa[Plan<D>::kQRegs ? D / 16 : 1][4];
  __device__ __forceinline__ Consumer(const Smem<D>& sm, const Args& a,
                                      const Geo& g, int warp, int lane)
      : rw(rows_of(g, lane)),
        kl(((lane >> 4) << 3) + (lane & 7), (lane >> 3) & 1),
        vl((((lane >> 3) & 1) << 3) + (lane & 7), lane >> 4) {
    constexpr int QS = Plan<D>::QS;
    const int lrow = lane & 7, lmat = lane >> 3;
    uint16_t* sq = sm.q + warp * 16 * QS;
    wq = saddr(sq + ((lmat & 1) * 8 + lrow) * QS + (lmat >> 1) * 8);
    if (rw.live(g)) {
      stage_q<D>(sq, a, g, rw, lane);
      if constexpr (Plan<D>::kQRegs) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) ldsm4<false>(qa[kk], wq + kk * 32);
      }
    }
  }
};

// S = Q K^T of 16 keys (two n-tiles, group np of the tile), the width
// walked in k-steps of 16 from 0
template <int D, bool kBF16>
__device__ __forceinline__ void score_group(float (&sc)[2][4], uint32_t sk,
                                            const Consumer<D>& cw, int np) {
#pragma unroll
  for (int e = 0; e < 4; ++e) sc[0][e] = sc[1][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t bk[4], qf[4];
    ldsm4<false>(bk, sk + cw.kl.at(np, kk));
    if constexpr (Plan<D>::kQRegs) {
#pragma unroll
      for (int e = 0; e < 4; ++e) qf[e] = cw.qa[kk][e];
    } else {
      ldsm4<false>(qf, cw.wq + kk * 32);
    }
    mma16<kBF16>(sc[0], qf, bk[0], bk[1]);
    mma16<kBF16>(sc[1], qf, bk[2], bk[3]);
  }
}

// S = Q K^T over a 128-key tile, 16 keys (two n-tiles) at a time.  A tile
// below the warp's diagonal (kFull) is one straight run; in a diagonal
// tile the 16-key steps at or past kmax stay 0.
template <int D, bool kBF16, bool kFull>
__device__ __forceinline__ void score_tile(float (&sc)[kBK / 8][4],
                                           uint32_t sk, const Consumer<D>& cw,
                                           int kmax) {
#pragma unroll
  for (int np = 0; np < kBK / 16; ++np) {
    float g[2][4];
    if (kFull || np * 16 < kmax) {
      score_group<D, kBF16>(g, sk, cw, np);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) g[0][e] = g[1][e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[2 * np][e] = g[0][e];
      sc[2 * np + 1][e] = g[1][e];
    }
  }
}

// in a tile that crosses the warp's first row's diagonal, keys past each
// row's own position -inf
__device__ __forceinline__ void mask_tile(float (&sc)[kBK / 8][4], int t0,
                                          const Rows& rw, int lane) {
  const int tig = lane & 3;
#pragma unroll
  for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = t0 + n * 8 + 2 * tig + (e & 1);
      if (key > rw.pos[e >> 1]) sc[n][e] = -INFINITY;
    }
}

// the row max of a tile's scores over the quad, into m; alpha = exp(m_prev
// - m) (finite m: every row sees key 0)
__device__ __forceinline__ void row_max(const float (&sc)[kBK / 8][4],
                                        float (&m)[2], float (&alpha)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // a tree of depth 6 over the 32 scores (max is exact in any order)
    float v[8];
#pragma unroll
    for (int n = 0; n < 8; ++n)
      v[n] = fmaxf(fmaxf(sc[2 * n][2 * r], sc[2 * n][2 * r + 1]),
                   fmaxf(sc[2 * n + 1][2 * r], sc[2 * n + 1][2 * r + 1]));
    v[0] = fmaxf(v[0], v[4]);
    v[1] = fmaxf(v[1], v[5]);
    v[2] = fmaxf(v[2], v[6]);
    v[3] = fmaxf(v[3], v[7]);
    float mx = fmaxf(fmaxf(v[0], v[2]), fmaxf(v[1], v[3]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[r], mx);
    alpha[r] = expf(m[r] - m_new);
    m[r] = m_new;
  }
}

// l = alpha l + the tile's sum: a lane's partial sums rs (keys 8 n + 2 t
// and 8 n + 2 t + 1 in turn), then the quad's as (s0 + s1) + (s2 + s3)
__device__ __forceinline__ void add_sums(float (&rs)[2], float (&l)[2],
                                         const float (&alpha)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rs[r] = __fadd_rn(rs[r], __shfl_xor_sync(0xffffffffu, rs[r], 1));
    rs[r] = __fadd_rn(rs[r], __shfl_xor_sync(0xffffffffu, rs[r], 2));
    l[r] = __fadd_rn(__fmul_rn(alpha[r], l[r]), rs[r]);
  }
}

// O = join(O, the tile's P V): each 16-column pair of P V from a zero
// accumulator, a chain of 8 k-steps of 16 keys (in a diagonal tile the
// all-zero steps at or past kmax add nothing and are skipped), then
// joined to O by join(o, pv, row)
template <int D, bool kBF16, bool kFull, typename J>
__device__ __forceinline__ void pv_tile(Acc<D>& o,
                                        const uint32_t (&pk)[kBK / 8][2],
                                        uint32_t sv, const Lanes<D>& vl,
                                        int kmax, J join) {
#pragma unroll
  for (int np = 0; np < D / 16; ++np) {
    float ot[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      if (kFull || kk * 16 < kmax) {
        uint32_t bv[4];
        ldsm4<true>(bv, sv + vl.at(kk, np));
        const uint32_t pa[4] = {pk[2 * kk][0], pk[2 * kk][1],
                                pk[2 * kk + 1][0], pk[2 * kk + 1][1]};
        mma16<kBF16>(ot[0], pa, bv[0], bv[1]);
        mma16<kBF16>(ot[1], pa, bv[2], bv[3]);
      }
    }
    o.merge(2 * np, ot[0], join);
    o.merge(2 * np + 1, ot[1], join);
  }
}

// the output rows of this lane, rounded to the dtype (pairs of columns in
// one 4-byte store where dv is even)
template <int D, bool kBF16, typename F>
__device__ __forceinline__ void write_out(const Args& a, const Geo& g,
                                          const Rows& rw, int lane,
                                          const Acc<D>& o, F fin) {
  const int grp = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gi = rw.first(g) + grp + 8 * h;
    if (gi >= g.SG) continue;
    uint16_t* orow = a.out + row_index(a, g, gi) * a.dv;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int c = n * 8 + 2 * tig;
      const float x0 = fin(o.get(n, 2 * h), h);
      const float x1 = fin(o.get(n, 2 * h + 1), h);
      if (c + 1 < a.dv && (a.dv & 1) == 0) {
        *reinterpret_cast<uint32_t*>(orow + c) = pack<kBF16>(x0, x1);
      } else {
        if (c < a.dv) orow[c] = round16<kBF16>(x0);
        if (c + 1 < a.dv) orow[c + 1] = round16<kBF16>(x1);
      }
    }
  }
}

// One key tile of the flash form for a live warp: S = Q K^T, logits dot
// * scale (keys past a row -inf in a diagonal tile), the block's running
// max, p = exp(logit - m) in float32 for l and rounded to V's dtype as the
// P V A fragments, then O = alpha O + P V (the block's P V in an
// accumulator of its own).  kFull: a tile below the warp's diagonal.
// poll() runs between the softmax and P V (warp 0 feeds the rings).
template <int D, bool kBF16, bool kFull, typename F>
__device__ __forceinline__ void flash_tile(const Consumer<D>& cw,
                                           const Smem<D>& sm, int s, int t0,
                                           int kmax, float scale, int lane,
                                           float (&m)[2], float (&l)[2],
                                           Acc<D>& o, F poll) {
  constexpr int NT = kBK / 8;
  float sc[NT][4];
  score_tile<D, kBF16, kFull>(sc, saddr(sm.k_slot(s)), cw, kmax);
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[n][e] = __fmul_rn(sc[n][e], scale);
  if constexpr (!kFull) mask_tile(sc, t0, cw.rw, lane);
  float alpha[2];
  row_max(sc, m, alpha);
  // the 16-key steps past kmax are 0 for every row of the warp
  uint32_t pk[NT][2];
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    if (kFull || n / 2 * 16 < kmax) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = expf(sc[n][e] - m[e >> 1]);
        rs[e >> 1] = __fadd_rn(rs[e >> 1], p[e]);
      }
      pk[n][0] = pack<kBF16>(p[0], p[1]);
      pk[n][1] = pack<kBF16>(p[2], p[3]);
    } else {
      pk[n][0] = pk[n][1] = 0u;
    }
  }
  add_sums(rs, l, alpha);
  poll();
  pv_tile<D, kBF16, kFull>(o, pk, saddr(sm.v_slot(s)), cw.vl, kmax,
                           [&](float x, float pv, int r) {
                             return __fadd_rn(__fmul_rn(x, alpha[r]), pv);
                           });
}

template <int D, bool kBF16>
__global__ void __launch_bounds__(kThreads, Plan<D>::kMinBlocks)
    flash16_kernel(const __grid_constant__ Args a,
                   const __grid_constant__ CUtensorMap mk,
                   const __grid_constant__ CUtensorMap mv) {
  using P = Plan<D>;
  constexpr int kS = P::kStages;
  extern __shared__ __align__(16) uint8_t smem16[];
  const Geo g = geometry(a);
  const Smem<D> sm(smem16, a, 0);
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  // warp 0 produces: the first tiles go out before Q is staged
  auto poll = [&](int upto, int must) {
    if (warp == 0) feed<D>(a, mk, mv, sm, g, false, upto, must, lane);
  };
  poll(kS - 1, 0);
  const Consumer<D> cw(sm, a, g, warp, lane);
  const Rows& rw = cw.rw;

  // rows grp and grp + 8: running max and sum (the same in the quad's four
  // lanes), O
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  Acc<D> o(sm);
  for (int j = 0; j < g.n_tiles; ++j) {
    const int s = j % kS;
    const uint32_t parity = (j / kS) & 1;
    poll(j + kS - 1, j);
    bar_wait(sm.fk + 8 * s, parity);
    bar_wait(sm.fv + 8 * s, parity);
    const int t0 = j * kBK;
    // keys of the tile at or before the warp's last row
    const int kmax = min(kBK, rw.pos_last() + 1 - t0);
    auto mid = [&] { poll(j + kS - 1, -1); };
    if (rw.live(g) && kmax > 0) {
      if (P::kSplit && t0 + kBK - 1 <= rw.pos_first())
        flash_tile<D, kBF16, P::kSplit>(cw, sm, s, t0, kmax, a.scale, lane, m,
                                        l, o, mid);
      else
        flash_tile<D, kBF16, false>(cw, sm, s, t0, kmax, a.scale, lane, m, l,
                                    o, mid);
    }
    __syncwarp();
    if (lane == 0) {                    // the slots are free
      bar_arrive(sm.ek + 8 * s);
      bar_arrive(sm.ev + 8 * s);
    }
  }
  if (!rw.live(g)) return;
  write_out<D, kBF16>(a, g, rw, lane, o, [&](float x, int h) {
    return __fdiv_rn(x, fmaxf(l[h], 1e-30f));
  });
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
//   * The softmax covers the whole row: no TPU blocks.  Each block sweeps
//     its visible keys twice in 128-key tiles on the pipeline above (the
//     producer stages K, then K and V): sweep 1 takes the row max m and l
//     = sum exp(x - m) online (per tile l = alpha l + sum, alpha =
//     exp(m_prev - m), the tile's sum in the lanes' order); sweep 2 takes
//     the same logits again, p = exp(x - m) / l (correctly rounded, as
//     jax.nn.softmax divides) rounded to V's dtype as the P V A fragment,
//     each tile's P V in an accumulator of its own added to O.  The output
//     is O rounded once.  No product or sum is contracted into an FMA.
//   * K and V are read through their batch, position and head strides, so
//     a cache window's views cache[:, :end, :, :d] reach the kernel as they
//     lie (TMA where the strides allow).
// Bound on the H100 (the function's work): one Q K^T and one P V a causal
// pair on the tensor cores, one exponential a pair on the special-function
// units, q, K and V read once and the output written once; at 64-wide
// heads the bytes bound it.  What this design leaves: the second sweep's
// Q K^T and exponentials (its own floor, 1.5x the products and twice the
// exponentials of the function), and the softmax's float32 instructions,
// as the flash form's.  It replaces no TPU kernel: the reference runs XLA
// here.

// the tile's logits: x rounded to the dtype, then scaled (in it, rounded
// again, with scale_first; else in float32); keys past a row -inf
template <bool kBF16, bool kFull>
__device__ __forceinline__ void window_logits(float (&sc)[kBK / 8][4],
                                              const Args& a, float s16,
                                              int t0, const Rows& rw,
                                              int lane) {
#pragma unroll
  for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = round_trip<kBF16>(sc[n][e]);
      sc[n][e] = a.scale_first ? round_trip<kBF16>(__fmul_rn(x, s16))
                               : __fmul_rn(x, a.scale);
    }
  if constexpr (!kFull) mask_tile(sc, t0, rw, lane);
}

// Sweep 1 of the window form over one key tile: the row's max and l,
// online (l = alpha l + the tile's sum in the lanes' order)
template <int D, bool kBF16, bool kFull>
__device__ __forceinline__ void window_max_tile(const Consumer<D>& cw,
                                                const Smem<D>& sm,
                                                const Args& a, float s16,
                                                int s, int t0, int kmax,
                                                int lane, float (&m)[2],
                                                float (&l)[2]) {
  constexpr int NT = kBK / 8;
  float sc[NT][4];
  score_tile<D, kBF16, kFull>(sc, saddr(sm.k_slot(s)), cw, kmax);
  window_logits<kBF16, kFull>(sc, a, s16, t0, cw.rw, lane);
  float alpha[2];
  row_max(sc, m, alpha);
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NT; ++n)
    if (kFull || n / 2 * 16 < kmax) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        rs[e >> 1] = __fadd_rn(rs[e >> 1], expf(sc[n][e] - m[e >> 1]));
    }
  add_sums(rs, l, alpha);
}

// Sweep 2 over one key tile: the normalised p, rounded to V's dtype, and
// O += P V.  p = ex / l correctly rounded, without a division in the loop:
// q = ex y with y = 1 / l rounded, corrected once by its exact residual
// (Markstein: exact while q is normal, ex >= 2^-100 here); where a lane
// met a smaller nonzero ex the warp takes those p by division instead (the
// same bits wherever the residual's were exact; with a division in the
// loop the kernel ran 1.3-1.5x slower on an H100).  With two blocks an SM
// (kOSmem, 128 registers a thread) each 16-key group's logits become p as
// they come and go straight into their k-step of P V for every column pair
// (the tile's P V held whole, each pair's chain of 8 k-steps in order);
// with one, the whole tile is scored in one run, its p packed, and P V
// taken 16 columns at a time (the streamed form ran 1.14x slower there at
// D = 64).  V lies in slot u of its ring.
template <int D, bool kBF16, bool kFull, typename F>
__device__ __forceinline__ void window_pv_tile(
    const Consumer<D>& cw, const Smem<D>& sm, const Args& a, float s16,
    int s, int u, int t0, int kmax, int lane, const float (&m)[2],
    const float (&l)[2], const float (&y)[2], Acc<D>& o, F poll) {
  constexpr int NT = kBK / 8;
  const uint32_t sk = saddr(sm.k_slot(s)), sv = saddr(sm.v_slot(u));
  auto add = [](float x, float pv, int) { return __fadd_rn(x, pv); };
  if constexpr (Plan<D>::kOSmem) {
    float ot[D / 8][4];
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) ot[c][e] = 0.f;
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      if (np == NT / 4) poll();
      if (kFull || np * 16 < kmax) {
        // group np's logits (x rounded, scaled; keys past a row -inf)
        float sc[2][4];
        score_group<D, kBF16>(sc, sk, cw, np);
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = round_trip<kBF16>(sc[c][e]);
            float v = a.scale_first ? round_trip<kBF16>(__fmul_rn(x, s16))
                                    : __fmul_rn(x, a.scale);
            if (!kFull && t0 + (2 * np + c) * 8 + 2 * (lane & 3) + (e & 1) >
                              cw.rw.pos[e >> 1])
              v = -INFINITY;
            sc[c][e] = v;
          }
        float p[2][4];
        bool tiny = false;
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float ex = expf(sc[c][e] - m[e >> 1]);
            const float q = __fmul_rn(ex, y[e >> 1]);
            p[c][e] = __fmaf_rn(__fmaf_rn(-q, l[e >> 1], ex), y[e >> 1], q);
            tiny |= ex > 0.f && ex < 0x1p-100f;
          }
        if (__any_sync(0xffffffffu, tiny)) {
#pragma unroll
          for (int c = 0; c < 2; ++c)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              p[c][e] = __fdiv_rn(expf(sc[c][e] - m[e >> 1]), l[e >> 1]);
        }
        const uint32_t pa[4] = {
            pack<kBF16>(p[0][0], p[0][1]), pack<kBF16>(p[0][2], p[0][3]),
            pack<kBF16>(p[1][0], p[1][1]), pack<kBF16>(p[1][2], p[1][3])};
#pragma unroll
        for (int cp = 0; cp < D / 16; ++cp) {
          uint32_t bv[4];
          ldsm4<true>(bv, sv + cw.vl.at(np, cp));
          mma16<kBF16>(ot[2 * cp], pa, bv[0], bv[1]);
          mma16<kBF16>(ot[2 * cp + 1], pa, bv[2], bv[3]);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < D / 8; ++c) o.merge(c, ot[c], add);
  } else {
    // the whole tile's logits in one run of the tensor cores, then p
    float sc[NT][4];
    score_tile<D, kBF16, kFull>(sc, sk, cw, kmax);
    window_logits<kBF16, kFull>(sc, a, s16, t0, cw.rw, lane);
    uint32_t pk[NT][2];
    bool tiny = false;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if (kFull || n / 2 * 16 < kmax) {
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
      } else {
        pk[n][0] = pk[n][1] = 0u;
      }
    }
    if (__any_sync(0xffffffffu, tiny)) {
      // the logits again (keeping them through the loop above would hold
      // 64 registers more), p by division
      score_tile<D, kBF16, kFull>(sc, sk, cw, kmax);
      window_logits<kBF16, kFull>(sc, a, s16, t0, cw.rw, lane);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        if (kFull || n / 2 * 16 < kmax) {
          float p[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            p[e] = __fdiv_rn(expf(sc[n][e] - m[e >> 1]), l[e >> 1]);
          pk[n][0] = pack<kBF16>(p[0], p[1]);
          pk[n][1] = pack<kBF16>(p[2], p[3]);
        }
      }
    }
    poll();
    pv_tile<D, kBF16, kFull>(o, pk, sv, cw.vl, kmax, add);
  }
}

template <int D, bool kBF16>
__global__ void __launch_bounds__(kThreads, Plan<D>::kMinBlocks)
    window16_kernel(const __grid_constant__ Args a,
                    const __grid_constant__ CUtensorMap mk,
                    const __grid_constant__ CUtensorMap mv) {
  using P = Plan<D>;
  constexpr int kS = P::kStages;
  extern __shared__ __align__(16) uint8_t smem16[];
  const Geo g = geometry(a);
  const Smem<D> sm(smem16, a, g.n_tiles);
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  // warp 0 produces: the first tiles go out before Q is staged
  auto poll = [&](int upto, int must) {
    if (warp == 0) feed<D>(a, mk, mv, sm, g, true, upto, must, lane);
  };
  poll(kS - 1, 0);
  const Consumer<D> cw(sm, a, g, warp, lane);
  const Rows& rw = cw.rw;
  const float s16 = round_trip<kBF16>(a.scale);
  const int n = g.n_tiles;

  // steps 0 .. n - 1: sweep 1 (K's ring only)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int j = 0; j < n; ++j) {
    const int s = j % kS;
    poll(j + kS - 1, j);
    bar_wait(sm.fk + 8 * s, (j / kS) & 1);
    const int t0 = j * kBK;
    const int kmax = min(kBK, rw.pos_last() + 1 - t0);
    if (rw.live(g) && kmax > 0) {
      if (P::kSplit && t0 + kBK - 1 <= rw.pos_first())
        window_max_tile<D, kBF16, P::kSplit>(cw, sm, a, s16, s, t0, kmax,
                                             lane, m, l);
      else
        window_max_tile<D, kBF16, false>(cw, sm, a, s16, s, t0, kmax, lane,
                                         m, l);
    }
    __syncwarp();
    if (lane == 0) bar_arrive(sm.ek + 8 * s);
  }

  // steps n .. 2 n - 1: sweep 2 (V's ring counts from step n)
  const float y[2] = {__frcp_rn(l[0]), __frcp_rn(l[1])};
  Acc<D> o(sm);
  for (int j = n; j < 2 * n; ++j) {
    const int s = j % kS, u = (j - n) % kS;
    poll(j + kS - 1, j);
    bar_wait(sm.fk + 8 * s, (j / kS) & 1);
    bar_wait(sm.fv + 8 * u, ((j - n) / kS) & 1);
    const int t0 = (j - n) * kBK;
    const int kmax = min(kBK, rw.pos_last() + 1 - t0);
    auto mid = [&] { poll(j + kS - 1, -1); };
    if (rw.live(g) && kmax > 0) {
      if (P::kSplit && t0 + kBK - 1 <= rw.pos_first())
        window_pv_tile<D, kBF16, P::kSplit>(cw, sm, a, s16, s, u, t0, kmax,
                                            lane, m, l, y, o, mid);
      else
        window_pv_tile<D, kBF16, false>(cw, sm, a, s16, s, u, t0, kmax,
                                        lane, m, l, y, o, mid);
    }
    __syncwarp();
    if (lane == 0) {
      bar_arrive(sm.ek + 8 * s);
      bar_arrive(sm.ev + 8 * u);
    }
  }
  if (!rw.live(g)) return;
  write_out<D, kBF16>(a, g, rw, lane, o, [](float x, int) { return x; });
}

// ---- the launch -----------------------------------------------------------
// cuTensorMapEncodeTiled, from the driver through the runtime (the build
// links no driver library)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult got;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &got) != cudaSuccess ||
        got != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// K or V (B, T, KV, width) through its strides (elements) as a 4-D tensor
// map (width, head, position, batch) of boxes of kPanel columns by 128
// positions, swizzled as Plan<D> reads them; 0, or the driver's error
// (kNoEncoder without the entry point)
template <int D>
int encode(CUtensorMap* map, const uint16_t* base, int width, int KV, int T,
           int B, long long s_h, long long s_t, long long s_b) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return kNoEncoder;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(width),
                              static_cast<cuuint64_t>(KV),
                              static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s_h) * 2,
                                 static_cast<cuuint64_t>(s_t) * 2,
                                 static_cast<cuuint64_t>(s_b) * 2};
  const cuuint32_t box[4] = {Plan<D>::kPanel, 1, kBK, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return static_cast<int>(fn(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT16, 4, const_cast<uint16_t*>(base),
      dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      D == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}

template <int D, bool kBF16, bool kWindow>
int launch_width(const Args& a) {
  using P = Plan<D>;
  CUtensorMap mk{}, mv{};
  if (a.route == kRouteTma) {
    int rc = encode<D>(&mk, a.k, a.dq, a.KV, a.T, a.B, a.ks_h, a.ks_t,
                       a.ks_b);
    if (rc == 0)
      rc = encode<D>(&mv, a.v, a.dv, a.KV, a.T, a.B, a.vs_h, a.vs_t, a.vs_b);
    if (rc != 0) return -rc;         // the wrapper raises: no other route
  }
  // one kernel a part (a conditional over both would build both)
  const auto kernel = [] {
    if constexpr (kWindow)
      return window16_kernel<D, kBF16>;
    else
      return flash16_kernel<D, kBF16>;
  }();
  cudaError_t err = allow_smem(kernel, P::bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.KV * a.B, a.tiles);
  kernel<<<grid, kThreads, P::bytes, a.stream>>>(a, mk, mv);
  return static_cast<int>(cudaGetLastError());
}

template <bool kBF16, bool kWindow>
int launch_form(const Args& a) {
  switch (a.width) {
    case 32: return launch_width<32, kBF16, kWindow>(a);
    case 64: return launch_width<64, kBF16, kWindow>(a);
    case 128: return launch_width<128, kBF16, kWindow>(a);
    case 256: return launch_width<256, kBF16, kWindow>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool kBF16>
int launch16(const Args& a) {
  return launch_form<kBF16, false>(a);
}

template <bool kBF16>
int launch_window16(const Args& a) {
  return launch_form<kBF16, true>(a);
}

#if CLOVER_HOLDS(1)
template int launch16<true>(const Args&);
#endif
#if CLOVER_HOLDS(2)
template int launch16<false>(const Args&);
#endif
#if CLOVER_HOLDS(3)
template int launch_window16<true>(const Args&);
#endif
#if CLOVER_HOLDS(4)
template int launch_window16<false>(const Args&);
#endif

}  // namespace flash16
}  // namespace clover
#endif  // CLOVER_HOLDS(1) .. CLOVER_HOLDS(4)
#if CLOVER_HOLDS(0)
// width: the bucket (32, 64, 128 or 256) that holds max(dq, dv); form: the
// operands' dtype (kernels/clover_attention.py: FORM_CODES), 0 float32, 1
// bfloat16, 2 float16; tiles and route: the 16-bit forms' plan
// (kernels/clover_attention.py: plan16), unused by the float32 form
extern "C" int clover_flash_attention(const void* q, const void* k,
                                      const void* v, void* out, int B,
                                      int S, int T, int H, int KV, int dq,
                                      int dv, int width, int form,
                                      float scale, int tiles, int route,
                                      cudaStream_t stream) {
  using clover::launch;
  if (dq > width || dv > width) return static_cast<int>(cudaErrorInvalidValue);
  if (form == 1 || form == 2) {
    const long long kq = dq, kv = dv, n = KV;
    return clover::flash16::launch_checked(
        {static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
         static_cast<const uint16_t*>(v), static_cast<uint16_t*>(out), B, S,
         T, H, KV, dq, dv, width, T * n * kq, n * kq, kq, T * n * kv, n * kv,
         kv, scale, 0, tiles, route, stream},
        form, false);
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
// reference's masked path (scale the 16-bit logits before the cast);
// tiles and route as above
extern "C" int clover_window_attention(
    const void* q, const void* k, const void* v, void* out, int B, int S,
    int T, int H, int KV, int dq, int dv, long long ks_b, long long ks_t,
    long long ks_h, long long vs_b, long long vs_t, long long vs_h,
    int width, int form, float scale, int scale_first, int tiles, int route,
    cudaStream_t stream) {
  if (dq > width || dv > width) return static_cast<int>(cudaErrorInvalidValue);
  return clover::flash16::launch_checked(
      {static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
       static_cast<const uint16_t*>(v), static_cast<uint16_t*>(out), B, S, T,
       H, KV, dq, dv, width, ks_b, ks_t, ks_h, vs_b, vs_t, vs_h, scale,
       scale_first, tiles, route, stream},
      form, true);
}
#endif  // CLOVER_HOLDS(0)
