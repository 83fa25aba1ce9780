// Flash-decoding for CLOVER-rank KV caches, dense and paged (DESIGN.md §4,
// §6, §14): one new token's query per row against the row's cached keys
// and values, online softmax in float32, optionally under a per-KV-head
// kept-rank plan.
//
// Replaces the TPU kernels
//   repro/kernels/decode_attention.py        flash_decode        (_decode_kernel)
//   repro/kernels/paged_decode_attention.py  paged_flash_decode  (_paged_decode_kernel)
//   repro/kernels/decode_attention.py        flash_decode_ranked (_decode_ranked_kernel)
//   repro/kernels/paged_decode_attention.py  paged_flash_decode_ranked
//                                            (_paged_decode_ranked_kernel)
// One template serves all four; they differ only in how position t of row
// b is addressed (DenseRows: k[b, t, kv]; PagedRows: pool[table[b, t / pt],
// t % pt, kv]) and in whether rank vectors are given.
//
// Design.  One block per (kv head, row b), 128 threads.  The block keeps
// the whole GQA group's G queries (pre-scaled) in shared memory, walks the
// row's positions [0, lengths[b]) in tiles of 32, stages each tile's K
// (padded rows, no bank conflicts) and V rows in shared memory, computes
// the G x 32 scores, runs the online-softmax update (one warp per query
// row) and accumulates acc[G, dv] in shared memory.  The TPU grid's
// sequential time/page axis becomes this loop; its index-map clamp that
// stops streaming past the row's length becomes the loop bound, so
// positions >= lengths[b] are never read and a paged row dereferences only
// pages < ceil(lengths[b] / pt).  The denominator is clamped at 1e-30, so
// a row of length 0 outputs exactly 0.
//
// Rank plans (the *_ranked entry points; a non-uniform RankBudget,
// DESIGN.md §14).  Each block reads its head's kept widths once, rq =
// min(qk_ranks[kv], dq) and rv = min(vo_ranks[kv], dv) (null pointers:
// full width, so the unranked entry points keep their behaviour).  Only
// K columns c < rq and V columns c < rv of each tile are staged, the
// score loop runs over c < rq and the accumulator update over c < rv, and
// output columns c >= rv are written as 0 (the TPU kernel's never-updated
// accumulator blocks give exactly 0 there too).  The TPU kernel's rank
// grid axis (K-phase blocks, one softmax step, V-phase blocks) exists to
// skip whole rank_block-wide DMAs; here it becomes these two loop bounds.
// The TPU kernel clamps per rank_block, this one per dimension, which is
// the plain version's _rank_mask semantics; the two agree whenever ranks
// are block multiples or the data obeys the mask_head_ranks zero-pad
// convention, and on the serving path both hold (plans snap to
// rank_multiple = 8 and the reference's rank_block is max(8, 8) = 8).  The
// loop order is the unranked one, so on zero-padded data the ranked kernel
// is BITWISE the unranked kernel: every skipped term is fmaf(x, 0, s) == s.
//
// Bound on the H100: the bytes of K and V streamed over 3.35 TB/s --
// lengths[b] * (dq + dv) * 4 per (b, kv) unranked, and sum_b lengths[b] *
// sum_kv (rq[kv] + rv[kv]) * 4 ranked.  What the simple design leaves on
// the table: (1) one block per (b, kv) gives only B * KV blocks -- at
// gpt2-xl's 25 MHA heads and 4 slots that is 100 blocks on 132 SMs, each
// walking its row serially; a split-K pass over the time axis with a
// second reduction kernel would fill the card.  (2) Loads are scalar and
// synchronous; 16-byte vector loads and a cp.async/TMA double buffer would
// overlap the stream with the arithmetic.  (3) With G = 1 only 32 of 128
// threads compute scores.
#include "common.cuh"

namespace clover {
namespace {

constexpr int kThreads = 128;
constexpr int kTileT = kWarp;   // positions per tile (one lane each)

struct DenseRows {
  const float* k;
  const float* v;
  int T, KV, dq, dv;
  __device__ const float* krow(int b, int kv, int t) const {
    return k + ((static_cast<size_t>(b) * T + t) * KV + kv) * dq;
  }
  __device__ const float* vrow(int b, int kv, int t) const {
    return v + ((static_cast<size_t>(b) * T + t) * KV + kv) * dv;
  }
};

struct PagedRows {
  const float* k;
  const float* v;
  const int* table;
  int n_p, pt, KV, dq, dv;
  __device__ size_t slot(int b, int kv, int t) const {
    const int page = table[static_cast<size_t>(b) * n_p + t / pt];
    return (static_cast<size_t>(page) * pt + t % pt) * KV + kv;
  }
  __device__ const float* krow(int b, int kv, int t) const {
    return k + slot(b, kv, t) * dq;
  }
  __device__ const float* vrow(int b, int kv, int t) const {
    return v + slot(b, kv, t) * dv;
  }
};

size_t decode_smem_bytes(int G, int dq, int dv) {
  const size_t floats = static_cast<size_t>(G) * dq      // q
                        + kTileT * (dq + 1)              // K tile (padded)
                        + kTileT * dv                    // V tile
                        + G * kTileT                     // scores
                        + G * dv                         // acc
                        + 3 * G;                         // m, l, alpha
  return floats * sizeof(float);
}

template <class Rows>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const float* __restrict__ q, const int* __restrict__ lengths,
              const int* __restrict__ qk_ranks,
              const int* __restrict__ vo_ranks, float* __restrict__ out,
              Rows rows, int H, int G, int dq, int dv, float scale) {
  extern __shared__ float smem[];
  const int kv = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int ks = dq + 1;
  // this head's kept widths: columns past them are never read
  const int rq = qk_ranks ? max(0, min(qk_ranks[kv], dq)) : dq;
  const int rv = vo_ranks ? max(0, min(vo_ranks[kv], dv)) : dv;
  float* sq = smem;
  float* sk = sq + G * dq;
  float* sv = sk + kTileT * ks;
  float* ss = sv + kTileT * dv;
  float* sacc = ss + G * kTileT;
  float* sm = sacc + G * dv;
  float* sl = sm + G;
  float* salpha = sl + G;

  // H is laid out as KV groups of G consecutive query heads.
  const float* qb = q + (static_cast<size_t>(b) * H + kv * G) * dq;
  for (int i = tid; i < G * dq; i += kThreads) sq[i] = qb[i] * scale;
  for (int i = tid; i < G * dv; i += kThreads) sacc[i] = 0.f;
  for (int g = tid; g < G; g += kThreads) {
    sm[g] = -INFINITY;
    sl[g] = 0.f;
  }

  const int n = lengths[b];
  for (int t0 = 0; t0 < n; t0 += kTileT) {
    const int nt = min(kTileT, n - t0);
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < nt * rq; i += kThreads) {
      const int r = i / rq, c = i % rq;
      sk[r * ks + c] = rows.krow(b, kv, t0 + r)[c];
    }
    for (int i = tid; i < nt * rv; i += kThreads) {
      const int r = i / rv, c = i % rv;
      sv[r * dv + c] = rows.vrow(b, kv, t0 + r)[c];
    }
    __syncthreads();
    for (int i = tid; i < G * kTileT; i += kThreads) {
      const int g = i / kTileT, r = i % kTileT;
      float s = -INFINITY;
      if (r < nt) {
        s = 0.f;
        const float* qg = sq + g * dq;
        const float* kr = sk + r * ks;
        for (int c = 0; c < rq; ++c) s = fmaf(qg[c], kr[c], s);
      }
      ss[i] = s;
    }
    __syncthreads();
    online_softmax_rows(ss, sm, sl, salpha, G);
    __syncthreads();
    for (int i = tid; i < G * rv; i += kThreads) {
      const int g = i / rv, c = i % rv;
      const float* p = ss + g * kTileT;
      float a = sacc[g * dv + c] * salpha[g];
      for (int r = 0; r < nt; ++r) a = fmaf(p[r], sv[r * dv + c], a);
      sacc[g * dv + c] = a;
    }
  }
  __syncthreads();
  float* ob = out + (static_cast<size_t>(b) * H + kv * G) * dv;
  for (int i = tid; i < G * dv; i += kThreads)
    ob[i] = i % dv < rv ? sacc[i] / fmaxf(sl[i / dv], 1e-30f) : 0.f;
}

template <class Rows>
int launch(const float* q, const int* lengths, const int* qk_ranks,
           const int* vo_ranks, float* out, Rows rows, int B, int H, int KV,
           int dq, int dv, float scale, cudaStream_t stream) {
  const int G = H / KV;
  const size_t smem = decode_smem_bytes(G, dq, dv);
  cudaError_t err = allow_smem(decode_kernel<Rows>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_kernel<Rows><<<dim3(KV, B), kThreads, smem, stream>>>(
      q, lengths, qk_ranks, vo_ranks, out, rows, H, G, dq, dv, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace clover

extern "C" int clover_flash_decode(const float* q, const float* k,
                                   const float* v, const int* lengths,
                                   float* out, int B, int T, int H, int KV,
                                   int dq, int dv, float scale,
                                   cudaStream_t stream) {
  clover::DenseRows rows{k, v, T, KV, dq, dv};
  return clover::launch(q, lengths, nullptr, nullptr, out, rows, B, H, KV,
                        dq, dv, scale, stream);
}

extern "C" int clover_paged_flash_decode(const float* q, const float* k_pool,
                                         const float* v_pool,
                                         const int* page_table,
                                         const int* lengths, float* out,
                                         int B, int n_p, int pt, int H,
                                         int KV, int dq, int dv, float scale,
                                         cudaStream_t stream) {
  clover::PagedRows rows{k_pool, v_pool, page_table, n_p, pt, KV, dq, dv};
  return clover::launch(q, lengths, nullptr, nullptr, out, rows, B, H, KV,
                        dq, dv, scale, stream);
}

extern "C" int clover_flash_decode_ranked(const float* q, const float* k,
                                          const float* v, const int* lengths,
                                          const int* qk_ranks,
                                          const int* vo_ranks, float* out,
                                          int B, int T, int H, int KV,
                                          int dq, int dv, float scale,
                                          cudaStream_t stream) {
  clover::DenseRows rows{k, v, T, KV, dq, dv};
  return clover::launch(q, lengths, qk_ranks, vo_ranks, out, rows, B, H, KV,
                        dq, dv, scale, stream);
}

extern "C" int clover_paged_flash_decode_ranked(
    const float* q, const float* k_pool, const float* v_pool,
    const int* page_table, const int* lengths, const int* qk_ranks,
    const int* vo_ranks, float* out, int B, int n_p, int pt, int H, int KV,
    int dq, int dv, float scale, cudaStream_t stream) {
  clover::PagedRows rows{k_pool, v_pool, page_table, n_p, pt, KV, dq, dv};
  return clover::launch(q, lengths, qk_ranks, vo_ranks, out, rows, B, H, KV,
                        dq, dv, scale, stream);
}
