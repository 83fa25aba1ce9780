// Causal flash attention for CLOVER-pruned heads (DESIGN.md §4): GQA with
// asymmetric head widths (dq != dv), float32, online softmax.
//
// Replaces the TPU kernel
//   repro/kernels/clover_attention.py  flash_attention  (_flash_kernel)
//
// Design: tensor cores at float32 accuracy (3xTF32).  Every product runs
// as mma.sync m16n8k8 on TF32 operands, each float32 operand x split once
// into big = tf32(x) and small = tf32(x - big), and a . b taken as
// small_a big_b + big_a small_b + big_a big_b (small terms first) with a
// float32 accumulator: the dropped small_a small_b term is ~2^-22 of the
// product, so the result keeps float32 accuracy (CUTLASS's
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
#include "common.cuh"

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

// width: the bucket (32, 64, 128 or 256) that holds max(dq, dv)
extern "C" int clover_flash_attention(const float* q, const float* k,
                                      const float* v, float* out, int B,
                                      int S, int T, int H, int KV, int dq,
                                      int dv, int width, float scale,
                                      cudaStream_t stream) {
  using clover::launch;
  if (dq > width || dv > width) return static_cast<int>(cudaErrorInvalidValue);
  switch (width) {
    case 32: return launch<32, 64>(q, k, v, out, B, S, T, H, KV, dq, dv,
                                   scale, stream);
    case 64: return launch<64, 64>(q, k, v, out, B, S, T, H, KV, dq, dv,
                                   scale, stream);
    case 128: return launch<128, 64>(q, k, v, out, B, S, T, H, KV, dq, dv,
                                     scale, stream);
    case 256: return launch<256, 32>(q, k, v, out, B, S, T, H, KV, dq, dv,
                                     scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
