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
// Design: split-K flash-decoding.  The TPU grid walks each row's time axis
// in order on one core; here that axis is cut into n_split spans of `span`
// positions (a paged span is whole pages), chosen by the Python planner
// from the static capacity and B * KV only -- never from `lengths`, so a
// decode step needs no host read.  Grid (n_split, KV, B), 4 warps a block:
//   * A split whose span starts at or past lengths[b] writes m = -inf,
//     l = 0 and exits; positions >= lengths[b] are never read, and a paged
//     row dereferences only pages < ceil(lengths[b] / pt).
//   * Each warp takes tiles of 32 positions (one lane each) round robin and
//     keeps its own running max m[g], lane-partial sums l[g] and
//     accumulator acc[g][dv] for the G query heads of the KV group: no
//     __syncthreads inside the walk.  Lane j first starts 16-byte cp.async
//     copies of its position's V row into the warp's shared-memory slab,
//     then scores the position against the G pre-scaled queries (staged
//     once in shared memory), reading the K row with 16-byte loads where
//     the width allows, so the V stream is in flight during the K loads
//     and the softmax.  The probabilities go through a per-warp slab too,
//     and lane c accumulates V column c (+ 32 i) over the tile's rows from
//     shared memory.  The paged form reads each page-table entry the tile
//     touches once (one lane each) and broadcasts it by shuffle.
//   * The warps merge in shared memory; the block writes its partial (m,
//     l, acc) per query head.  A second kernel merges the splits: split s
//     weighs exp(m_s - M), an empty split 0, and the sum is divided by
//     max(sum_s w_s l_s, 1e-30), so a row of length 0 outputs exactly 0.
// Every reduction tree (score chains, tiles, warps, splits) depends on the
// shapes and lengths only.
//
// Row strides (the self-speculative draft, DESIGN.md §8).  A cache row --
// one (position, KV head) -- starts ldk floats after the previous one in K
// and ldv in V, and the kernel reads its first dq / dv floats.  ldk == dq
// and ldv == dv is a contiguous cache; the draft passes cache[..., :r] of
// the full-width cache or pool as it lies (ldk, ldv = the cache widths), so
// it streams only the leading r floats of each row and no copy of the
// sliced cache is made.  The 16-byte paths depend on the stride and the
// base pointer (the q rows in shared memory are padded to 4 floats), not
// on the width; an odd stride takes the 4-byte path with the same chains,
// so a strided call is bitwise the call on a contiguous copy of the view.
//
// Rank plans (the *_ranked entry points; a non-uniform RankBudget,
// DESIGN.md §14).  Each block reads its head's kept widths once, rq =
// min(qk_ranks[kv], dq) and rv = min(vo_ranks[kv], dv) (null pointers:
// full width).  K columns c >= rq and V columns c >= rv are never loaded;
// they enter the same FMA chains as exact zeros, and output columns c >= rv
// are 0.  So on zero-padded data the ranked kernel is BITWISE the unranked
// one: every skipped term is fmaf(x, 0, s) == s, and the trees above do not
// depend on the rank.  The TPU kernel clamps per rank_block, this one per
// dimension (the plain version's _rank_mask semantics); the two agree
// whenever ranks are block multiples or the data obeys the mask_head_ranks
// zero-pad convention, and on the serving path both hold.
//
// Bound on the H100: the bytes of K and V streamed over 3.35 TB/s --
// lengths[b] * (dq + dv) * 4 per (b, kv) unranked, and sum_b lengths[b] *
// sum_kv (rq[kv] + rv[kv]) * 4 ranked.  At the serving shapes that is a
// microsecond, so launch latency and the dependent chain of one tile (load
// K, score, shuffle-reduce, load V, accumulate) set the time.  The register
// accumulator holds G * ceil(dv / 32) floats a lane: at G = 16 and dv = 256
// it spills (an edge the contract allows, not a serving shape).
#include "common.cuh"

namespace clover {
namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * kWarp;
constexpr int kTile = kWarp;    // positions per warp tile (one lane each)

struct DenseRows {
  const float* k;
  const float* v;
  int T, KV;
  int ldk, ldv;   // floats between consecutive (position, KV head) rows
  // row index (of ldk / ldv floats) of position t0 + lane, lanes >= n
  // clamped to the tile's last position
  __device__ size_t slot(int b, int kv, int t0, int n, int lane) const {
    return (static_cast<size_t>(b) * T + t0 + min(lane, n - 1)) * KV + kv;
  }
};

struct PagedRows {
  const float* k;
  const float* v;
  const int* table;
  int n_p, pt, KV;
  int ldk, ldv;   // floats between consecutive (position, KV head) rows
  // all lanes must call: one table read per page the tile touches
  __device__ size_t slot(int b, int kv, int t0, int n, int lane) const {
    const int p0 = t0 / pt;
    const int pages = (t0 + n - 1) / pt - p0 + 1;          // <= kTile
    const int entry =
        lane < pages ? table[static_cast<size_t>(b) * n_p + p0 + lane] : 0;
    const int t = t0 + min(lane, n - 1);
    const int page = __shfl_sync(0xffffffffu, entry, t / pt - p0);
    return (static_cast<size_t>(page) * pt + t % pt) * KV + kv;
  }
};

// V rows staged per warp tile and the q rows, padded to 16 bytes
__host__ __device__ inline int pad4(int d) { return (d + 3) & ~3; }

size_t decode_smem_bytes(int G, int GB, int dq, int dv) {
  const size_t floats = kWarps * kTile * pad4(dv)           // V slabs
                        + static_cast<size_t>(G) * pad4(dq)  // q
                        + kWarps * GB * kTile                // p slabs
                        + kWarps * G * (dv + 2);             // warp merge
  return floats * sizeof(float);
}

// GB: query heads per KV head, rounded up (1, 4, 16); CW: V columns per
// lane, ceil(dv / 32) rounded up (1, 2, 4, 8).  One FMA chain per head, or
// four (by column mod 4) at GB = 1, where nothing else hides the latency.
template <class Rows, int GB, int CW>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const float* __restrict__ q,
                    const int* __restrict__ lengths,
                    const int* __restrict__ qk_ranks,
                    const int* __restrict__ vo_ranks,
                    float* __restrict__ part, Rows rows, int H, int G, int dq,
                    int dv, int span, float scale) {
  constexpr int kCh = GB == 1 ? 4 : 1;
  extern __shared__ __align__(16) float smem[];
  const int s = blockIdx.x, kv = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x;
  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  const size_t stride = static_cast<size_t>(dv) + 2;   // m, l, acc[dv]
  const size_t head_stride = n_split * stride;
  float* pb = part + (static_cast<size_t>(b) * H + kv * G) * head_stride +
              s * stride;
  const int lo = s * span;
  const int hi = min(lo + span, lengths[b]);
  if (lo >= hi) {                        // nothing of this row here
    for (int g = tid; g < G; g += kThreads) {
      pb[g * head_stride] = -INFINITY;
      pb[g * head_stride + 1] = 0.f;
    }
    return;
  }
  const int rq = qk_ranks ? max(0, min(qk_ranks[kv], dq)) : dq;
  const int rv = vo_ranks ? max(0, min(vo_ranks[kv], dv)) : dv;
  // 16-byte global reads need every row start 16-byte aligned
  const bool vec = rows.ldk % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(rows.k) % 16 == 0;
  const bool vec_v = rows.ldv % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(rows.v) % 16 == 0;
  const int vs = pad4(dv), qs = pad4(dq);
  float* sv = smem + warp * kTile * vs;                 // this warp's V rows
  float* sq = smem + kWarps * kTile * vs;               // q, rows of qs
  float* sp = sq + G * qs + warp * GB * kTile;          // this warp's p slab
  float* sm = sq + G * qs + kWarps * GB * kTile;        // merge: m
  float* sl = sm + kWarps * G;                          //        l
  float* sa = sl + kWarps * G;                          //        acc

  // H is laid out as KV groups of G consecutive query heads.
  const float* qb = q + (static_cast<size_t>(b) * H + kv * G) * dq;
  for (int i = tid; i < G * dq; i += kThreads)
    sq[i / dq * qs + i % dq] = qb[i] * scale;
  __syncthreads();

  float m[GB], l[GB], acc[GB][CW];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < CW; ++i) acc[g][i] = 0.f;
  }

  for (int t0 = lo + warp * kTile; t0 < hi; t0 += kWarps * kTile) {
    const int n = min(kTile, hi - t0);
    const size_t slot = rows.slot(b, kv, t0, n, lane);
    // lane j stages its position's V row (columns < rv) while it scores
    if (lane < n) {
      const float* vr = rows.v + slot * rows.ldv;
      float* dst = sv + lane * vs;
      int c = 0;
      if (vec_v)
        for (; c + 4 <= rv; c += 4) cp_async<16>(dst + c, vr + c, true);
      for (; c < rv; ++c) cp_async<4>(dst + c, vr + c, true);
    }
    cp_async_commit();
    float sc[GB];
    {
      float ch[GB][kCh];
#pragma unroll
      for (int g = 0; g < GB; ++g)
#pragma unroll
        for (int j = 0; j < kCh; ++j) ch[g][j] = 0.f;
      if (lane < n) {
        const float* kr = rows.k + slot * rows.ldk;
        int c = 0;
        if (vec) {
#pragma unroll 8
          for (; c + 4 <= rq; c += 4) {
            const float4 kk = __ldg(reinterpret_cast<const float4*>(kr + c));
#pragma unroll
            for (int g = 0; g < GB; ++g) {
              if (g < G) {
                const float4 qq =
                    *reinterpret_cast<const float4*>(sq + g * qs + c);
                ch[g][0 % kCh] = fmaf(qq.x, kk.x, ch[g][0 % kCh]);
                ch[g][1 % kCh] = fmaf(qq.y, kk.y, ch[g][1 % kCh]);
                ch[g][2 % kCh] = fmaf(qq.z, kk.z, ch[g][2 % kCh]);
                ch[g][3 % kCh] = fmaf(qq.w, kk.w, ch[g][3 % kCh]);
              }
            }
          }
        }
        // the rest four at a time (columns past rq enter as exact zeros,
        // so every chain sees the same terms in the same order as in the
        // vector loop)
        for (; c < rq; c += 4) {
          float kk[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) kk[j] = c + j < rq ? __ldg(kr + c + j)
                                                         : 0.f;
#pragma unroll
          for (int g = 0; g < GB; ++g) {
            if (g < G) {
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const float qq = c + j < rq ? sq[g * qs + c + j] : 0.f;
                ch[g][j % kCh] = fmaf(qq, kk[j], ch[g][j % kCh]);
              }
            }
          }
        }
      }
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        float dot = ch[g][0];
        if constexpr (kCh == 4) dot = (dot + ch[g][1]) + (ch[g][2] + ch[g][3]);
        sc[g] = lane < n ? dot : -INFINITY;
      }
    }
    // online softmax, one head at a time: m is warp-uniform, l per lane
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      if (g < G) {
        const float m_new = fmaxf(m[g], warp_max(sc[g]));
        const bool dead = m_new == -INFINITY;
        const float p = dead ? 0.f : expf(sc[g] - m_new);
        const float alpha = dead ? 1.f : expf(m[g] - m_new);
        m[g] = m_new;
        l[g] = l[g] * alpha + p;
#pragma unroll
        for (int i = 0; i < CW; ++i) acc[g][i] *= alpha;
        sp[g * kTile + lane] = p;
      }
    }
    cp_async_wait<0>();
    __syncwarp();
    // acc[g][c] += p[g][j] * v[j][c], lane c (+ 32 i), rows in order
#pragma unroll 8
    for (int j = 0; j < n; ++j) {
      float vv[CW];
#pragma unroll
      for (int i = 0; i < CW; ++i) {
        const int c = lane + kWarp * i;
        vv[i] = c < rv ? sv[j * vs + c] : 0.f;
      }
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        if (g < G) {
          const float pj = sp[g * kTile + j];
#pragma unroll
          for (int i = 0; i < CW; ++i) acc[g][i] = fmaf(pj, vv[i], acc[g][i]);
        }
      }
    }
    __syncwarp();
  }

  // merge the warps (fixed order), then write this split's partials
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    if (g < G) {
      const float lw = warp_sum(l[g]);
      if (lane == 0) {
        sm[warp * G + g] = m[g];
        sl[warp * G + g] = lw;
      }
#pragma unroll
      for (int i = 0; i < CW; ++i) {
        const int c = lane + kWarp * i;
        if (c < dv) sa[(warp * G + g) * dv + c] = acc[g][i];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < G * (dv + 1); i += kThreads) {
    const int g = i / (dv + 1), c = i % (dv + 1) - 1;   // c = -1: m and l
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sm[w * G + g]);
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw = sm[w * G + g];
      if (mw == -INFINITY) continue;        // a warp with no tile here
      const float wt = expf(mw - M);
      sum += wt * (c < 0 ? sl[w * G + g] : sa[(w * G + g) * dv + c]);
    }
    float* ph = pb + g * head_stride;
    if (c < 0) {
      ph[0] = M;
      ph[1] = sum;
    } else {
      ph[2 + c] = c < rv ? sum : 0.f;
    }
  }
}

// out[b, h, c] = sum_s w_s acc_s[c] / max(sum_s w_s l_s, 1e-30), w_s =
// exp(m_s - max_s m_s), and 0 for an empty split (m_s = -inf).  With
// ``lse`` (may be null) also lse[b, h] = max_s m_s + log(sum_s w_s l_s),
// the log-sum-exp of the row's scaled logits, -inf for a row of length 0
// (the sequence-split cache's combine over ranks reads it).
__global__ void __launch_bounds__(kThreads)
decode_combine_kernel(const float* __restrict__ part, float* __restrict__ out,
                      float* __restrict__ lse, int n_split, int dv) {
  const size_t stride = static_cast<size_t>(dv) + 2;
  const float* ph = part + blockIdx.x * n_split * stride;
  float M = -INFINITY;
  for (int s = 0; s < n_split; ++s) M = fmaxf(M, ph[s * stride]);
  float L = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const float ms = ph[s * stride];
    if (ms != -INFINITY) L += expf(ms - M) * ph[s * stride + 1];
  }
  const float inv = 1.f / fmaxf(L, 1e-30f);
  if (lse != nullptr && threadIdx.x == 0)
    lse[blockIdx.x] = L > 0.f ? M + logf(L) : -INFINITY;
  for (int c = threadIdx.x; c < dv; c += blockDim.x) {
    float a = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float ms = ph[s * stride];
      if (ms != -INFINITY) a += expf(ms - M) * ph[s * stride + 2 + c];
    }
    out[blockIdx.x * static_cast<size_t>(dv) + c] = a * inv;
  }
}

template <class Rows, int GB, int CW>
int launch_split(const float* q, const int* lengths, const int* qk_ranks,
                 const int* vo_ranks, float* part, Rows rows, int B, int H,
                 int KV, int dq, int dv, int n_split, int span, float scale,
                 cudaStream_t stream) {
  const int G = H / KV;
  const size_t smem = decode_smem_bytes(G, GB, dq, dv);
  cudaError_t err = allow_smem(decode_split_kernel<Rows, GB, CW>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_split_kernel<Rows, GB, CW>
      <<<dim3(n_split, KV, B), kThreads, smem, stream>>>(
          q, lengths, qk_ranks, vo_ranks, part, rows, H, G, dq, dv, span,
          scale);
  return static_cast<int>(cudaGetLastError());
}

template <class Rows, int GB>
int launch_cw(const float* q, const int* lengths, const int* qk_ranks,
              const int* vo_ranks, float* part, Rows rows, int B, int H,
              int KV, int dq, int dv, int n_split, int span, float scale,
              cudaStream_t stream) {
  const int cw = (dv + kWarp - 1) / kWarp;
#define CLOVER_SPLIT(CW)                                                    \
  return launch_split<Rows, GB, CW>(q, lengths, qk_ranks, vo_ranks, part,  \
                                    rows, B, H, KV, dq, dv, n_split, span,  \
                                    scale, stream)
  if (cw <= 1) CLOVER_SPLIT(1);
  if (cw <= 2) CLOVER_SPLIT(2);
  if (cw <= 4) CLOVER_SPLIT(4);
  CLOVER_SPLIT(8);
#undef CLOVER_SPLIT
}

template <class Rows>
int launch(const float* q, const int* lengths, const int* qk_ranks,
           const int* vo_ranks, float* part, float* out, Rows rows, int B,
           int H, int KV, int dq, int dv, int n_split, int span, float scale,
           cudaStream_t stream, float* lse = nullptr) {
  const int G = H / KV;
  int rc;
  if (G == 1)
    rc = launch_cw<Rows, 1>(q, lengths, qk_ranks, vo_ranks, part, rows, B,
                            H, KV, dq, dv, n_split, span, scale, stream);
  else if (G <= 4)
    rc = launch_cw<Rows, 4>(q, lengths, qk_ranks, vo_ranks, part, rows, B,
                            H, KV, dq, dv, n_split, span, scale, stream);
  else
    rc = launch_cw<Rows, 16>(q, lengths, qk_ranks, vo_ranks, part, rows, B,
                             H, KV, dq, dv, n_split, span, scale, stream);
  if (rc != 0) return rc;
  decode_combine_kernel<<<B * H, kThreads, 0, stream>>>(part, out, lse,
                                                       n_split, dv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace clover

// part: (B, H, n_split, dv + 2) float32 scratch; n_split * span covers the
// cache's capacity (the wrapper's planner).  ldk >= dq, ldv >= dv: the row
// strides of k and v in floats (dq, dv for a contiguous cache).
extern "C" int clover_flash_decode(const float* q, const float* k,
                                   const float* v, const int* lengths,
                                   float* part, float* out, int B, int T,
                                   int H, int KV, int dq, int dv, int ldk,
                                   int ldv, int n_split, int span,
                                   float scale, cudaStream_t stream) {
  clover::DenseRows rows{k, v, T, KV, ldk, ldv};
  return clover::launch(q, lengths, nullptr, nullptr, part, out, rows, B, H,
                        KV, dq, dv, n_split, span, scale, stream);
}

// clover_flash_decode, also writing lse: (B, H) float32, the log-sum-exp
// of each row's scaled logits over its lengths (-inf at length 0).
extern "C" int clover_flash_decode_lse(const float* q, const float* k,
                                       const float* v, const int* lengths,
                                       float* part, float* out, float* lse,
                                       int B, int T, int H, int KV, int dq,
                                       int dv, int ldk, int ldv, int n_split,
                                       int span, float scale,
                                       cudaStream_t stream) {
  clover::DenseRows rows{k, v, T, KV, ldk, ldv};
  return clover::launch(q, lengths, nullptr, nullptr, part, out, rows, B, H,
                        KV, dq, dv, n_split, span, scale, stream, lse);
}

extern "C" int clover_paged_flash_decode(
    const float* q, const float* k_pool, const float* v_pool,
    const int* page_table, const int* lengths, float* part, float* out,
    int B, int n_p, int pt, int H, int KV, int dq, int dv, int ldk, int ldv,
    int n_split, int span, float scale, cudaStream_t stream) {
  clover::PagedRows rows{k_pool, v_pool, page_table, n_p, pt, KV, ldk, ldv};
  return clover::launch(q, lengths, nullptr, nullptr, part, out, rows, B, H,
                        KV, dq, dv, n_split, span, scale, stream);
}

extern "C" int clover_flash_decode_ranked(
    const float* q, const float* k, const float* v, const int* lengths,
    const int* qk_ranks, const int* vo_ranks, float* part, float* out, int B,
    int T, int H, int KV, int dq, int dv, int ldk, int ldv, int n_split,
    int span, float scale, cudaStream_t stream) {
  clover::DenseRows rows{k, v, T, KV, ldk, ldv};
  return clover::launch(q, lengths, qk_ranks, vo_ranks, part, out, rows, B,
                        H, KV, dq, dv, n_split, span, scale, stream);
}

extern "C" int clover_paged_flash_decode_ranked(
    const float* q, const float* k_pool, const float* v_pool,
    const int* page_table, const int* lengths, const int* qk_ranks,
    const int* vo_ranks, float* part, float* out, int B, int n_p, int pt,
    int H, int KV, int dq, int dv, int ldk, int ldv, int n_split, int span,
    float scale, cudaStream_t stream) {
  clover::PagedRows rows{k_pool, v_pool, page_table, n_p, pt, KV, ldk, ldv};
  return clover::launch(q, lengths, qk_ranks, vo_ranks, part, out, rows, B,
                        H, KV, dq, dv, n_split, span, scale, stream);
}
