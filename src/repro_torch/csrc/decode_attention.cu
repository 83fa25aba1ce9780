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
// b is addressed (a dense cache: k[b, t, kv]; a paged one: pool[table[b,
// t / pt], t % pt, kv]) and in whether rank vectors are given.
//
// Dtypes.  q and the output are in the compute dtype (float32, bfloat16
// or float16); K and V in one storage dtype (float32, bfloat16, float16,
// float8 e4m3 or e5m2), read as they lie and converted in registers, each
// element to its value in the compute dtype, as the reference's call
// sites' astype(x.dtype) converts the cache (exact, except a float32 cache
// rounded to a 16-bit compute dtype, or bfloat16 and float16 to each
// other: round to nearest even).  Scores and sums are float32.
//
// The 16-bit form.  The TPU kernel walks a row's positions in blocks (a
// dense cache: the whole cache up to 256 positions, else blocks of 256; a
// paged one: one page) and rounds each p = exp(logit - m) to the compute
// dtype before P.V, m the running max over the blocks walked so far; l sums
// the unrounded p.  The rounding makes m part of the function: a p rounds
// differently against another max.  A split of this kernel cannot see the
// maxima of the splits before it, so at 16-bit compute a first pass
// (decode_max_kernel) scores every live position and writes the max logit
// of each unit of u positions (u = 32 dense, gcd(32, pt) paged: a unit
// never straddles a tile or a block).  Each split of the main pass then
// builds, per head, the running max R_j through every block j its span
// touches (the max over the units before its first block, then a
// max-scan over its blocks' units) and rounds each p = exp(s - R_j(t))
// relative to it, exactly the TPU's m.  Within a tile the warp keeps the
// block max of the tile's last position as its reference m; a position of
// an earlier block (pages shorter than a tile) enters with the weight
// exp(R_j - m).  The output is acc / max(l, 1e-30) rounded once to the
// compute dtype.  At float32 compute the rounding is the identity, no
// first pass runs, and each split keeps its own running max.
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
//     copies of its position's V row (in the storage dtype) into the warp's
//     shared-memory slab, then scores the position against the G queries
//     (staged once in shared memory as float32; pre-scaled at float32
//     compute, the dot scaled after at 16-bit as the TPU scales it),
//     reading the K row with 16-byte loads where the stride allows (4
//     float32, 8 16-bit or 16 8-bit elements), so the V stream is in
//     flight during the K loads and the softmax.  The probabilities go
//     through a per-warp slab too, and lane c accumulates V column c (+ 32
//     i) over the tile's rows from shared memory.  The paged form reads
//     each page-table entry the tile touches once (one lane each) and
//     broadcasts it by shuffle.
//   * The warps merge in shared memory; the block writes its partial (m,
//     l, acc) per query head.  A second kernel merges the splits: split s
//     weighs exp(m_s - M), an empty split 0, and the sum is divided by
//     max(sum_s w_s l_s, 1e-30), so a row of length 0 outputs exactly 0.
// Every reduction tree (score chains, tiles, warps, splits) depends on the
// shapes and lengths only, and the score chains not on the storage dtype:
// at float32 compute a 16- or 8-bit cache gives bit for bit the result of
// a float32 copy of it.
//
// Row strides (the self-speculative draft, DESIGN.md §8).  A cache row --
// one (position, KV head) -- starts ldk elements after the previous one in
// K and ldv in V, and the kernel reads its first dq / dv elements.  ldk ==
// dq and ldv == dv is a contiguous cache; the draft passes cache[..., :r]
// of the full-width cache or pool as it lies (ldk, ldv = the cache
// widths), so it streams only the leading r elements of each row and no
// copy of the sliced cache is made.  The 16-byte paths depend on the
// stride in bytes and the base pointer (the q rows in shared memory are
// padded to 4 floats), not on the width; another stride takes element
// loads with the same chains, so a strided call is bitwise the call on a
// contiguous copy of the view.
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
// lengths[b] * (dq + dv) * e per (b, kv) unranked (e bytes an element),
// and sum_b lengths[b] * sum_kv (rq[kv] + rv[kv]) * e ranked.  At the
// serving shapes that is a microsecond, so launch latency and the
// dependent chain of one tile (load K, score, shuffle-reduce, load V,
// accumulate) set the time; the 16-bit form's first pass adds a launch
// and a second read of K.  The register accumulator holds G * ceil(dv /
// 32) floats a lane: at G = 16 and dv = 256 it spills (an edge the
// contract allows, not a serving shape).
//
// Instances: one per element kind (5), query-head bucket (3) and V
// columns a lane (4) -- 60 split kernels -- and 12 first passes (the 4
// kinds 16-bit compute reaches x 3 buckets); the storage format within a
// kind, the compute dtype and so the form (float32 or 16-bit, a uniform
// branch per tile) are read at run time.  Five objects of this file
// compile them in parallel (CLOVER_PART).
#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include "common.cuh"

// The build compiles this file in CLOVER_PARTS objects in parallel
// (kernels/_build.py: PARTS), each with -DCLOVER_PART=p: part p
// instantiates the kernels of the element kinds i with i % CLOVER_PARTS
// == p (``launch_kind`` below), part 0 also the combine kernel and the
// entry point.  Without them one object holds every part.
#ifdef CLOVER_PART
#define CLOVER_HOLDS(p) (CLOVER_PART == (p) % CLOVER_PARTS)
#else
#define CLOVER_HOLDS(p) 1
#endif

namespace clover {
namespace decode {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * kWarp;
constexpr int kTile = kWarp;    // positions per warp tile (one lane each)

// dtype codes (kernels/decode_attention.py: DTYPE_CODES)
enum Dtype : int { kF32 = 0, kBF16 = 1, kF16 = 2, kE4M3 = 3, kE5M2 = 4 };

// How a cache element becomes a float: its bytes, and whether its value
// rounds to the compute dtype first.
enum Kind : int {
  kF32Kv = 0,      // float32 at float32 compute
  kF32Round = 1,   // float32 rounded to a 16-bit compute dtype
  k16Kv = 2,       // bfloat16 / float16 at its own value
  k16Round = 3,    // bfloat16 / float16 rounded to the other
  k8Kv = 4,        // float8 e4m3 / e5m2 at its own value (exact in both)
};

template <int K>
struct Elem {
  static constexpr int kBytes = K <= kF32Round ? 4 : K <= k16Round ? 2 : 1;
  static constexpr int kVec = 16 / kBytes;   // elements a 16-byte load
};

struct Fmt {
  int kv;   // storage dtype code
  int cd;   // compute dtype code
};

__device__ __forceinline__ float round_to(float x, int cd) {
  return cd == kBF16 ? __bfloat162float(__float2bfloat16_rn(x))
                     : __half2float(__float2half_rn(x));
}

// one element's bits (low bytes of raw) -> its value in the compute dtype
template <int K>
__device__ __forceinline__ float to_float(uint32_t raw, Fmt f) {
  if constexpr (Elem<K>::kBytes == 4) {
    const float x = __uint_as_float(raw);
    if constexpr (K == kF32Round) return round_to(x, f.cd);
    return x;
  } else if constexpr (Elem<K>::kBytes == 2) {
    const float x =
        f.kv == kBF16 ? __uint_as_float(raw << 16)
                      : __half2float(__ushort_as_half(
                            static_cast<unsigned short>(raw)));
    if constexpr (K == k16Round) return round_to(x, f.cd);
    return x;
  } else {
    // e5m2 is the high byte of a float16; e4m3's exponent and mantissa
    // shifted one bit lower form a float16 2^-8 of its value (subnormals
    // included)
    const bool e4 = f.kv == kE4M3;
    const uint32_t h = (raw & 0x80u) << 8 | (raw & 0x7Fu) << (e4 ? 7 : 8);
    return __half2float(__ushort_as_half(static_cast<unsigned short>(h))) *
           (e4 ? 256.f : 1.f);
  }
}

// a 16-byte word -> its kVec elements, in column order
template <int K>
__device__ __forceinline__ void unpack(const uint4& w,
                                       float (&x)[Elem<K>::kVec], Fmt f) {
  constexpr int kB = Elem<K>::kBytes;
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < Elem<K>::kVec; ++i) {
    const uint32_t word = u[i * kB / 4];
    uint32_t raw = word;
    if constexpr (kB == 2) raw = i % 2 ? word >> 16 : word & 0xFFFFu;
    if constexpr (kB == 1) raw = word >> (8 * (i % 4)) & 0xFFu;
    x[i] = to_float<K>(raw, f);
  }
}

// element c of a row in global (ldg) or shared memory
template <int K, bool kGlobal>
__device__ __forceinline__ float load_one(const uint8_t* row, int c, Fmt f) {
  constexpr int kB = Elem<K>::kBytes;
  uint32_t raw;
  if constexpr (kB == 4) {
    const uint32_t* p = reinterpret_cast<const uint32_t*>(row) + c;
    raw = kGlobal ? __ldg(p) : *p;
  } else if constexpr (kB == 2) {
    const unsigned short* p = reinterpret_cast<const unsigned short*>(row) + c;
    raw = kGlobal ? __ldg(p) : *p;
  } else {
    raw = kGlobal ? __ldg(row + c) : row[c];
  }
  return to_float<K>(raw, f);
}

__device__ __forceinline__ float load_q(const void* q, size_t i, int cd) {
  if (cd == kF32) return static_cast<const float*>(q)[i];
  if (cd == kBF16)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(q)[i]);
  return __half2float(static_cast<const __half*>(q)[i]);
}

__device__ __forceinline__ void store_out(void* out, size_t i, float x,
                                          int cd) {
  if (cd == kF32)
    static_cast<float*>(out)[i] = x;
  else if (cd == kBF16)
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(x);
  else
    static_cast<__half*>(out)[i] = __float2half_rn(x);
}

struct Rows {
  const uint8_t* k;
  const uint8_t* v;
  const int* table;   // null: a dense cache of pt positions a row
  int n_p, pt, KV;    // table entries a row, positions a page (or a row)
  int ldk, ldv;       // elements between consecutive (position, KV head) rows
  // row index (of ldk / ldv elements) of position t0 + lane, lanes >= n
  // clamped to the tile's last position; all lanes must call (paged: one
  // table read per page the tile touches)
  __device__ size_t slot(int b, int kv, int t0, int n, int lane) const {
    const int t = t0 + min(lane, n - 1);
    if (table == nullptr)
      return (static_cast<size_t>(b) * pt + t) * KV + kv;
    const int p0 = t0 / pt;
    const int pages = (t0 + n - 1) / pt - p0 + 1;          // <= kTile
    const int entry =
        lane < pages ? table[static_cast<size_t>(b) * n_p + p0 + lane] : 0;
    const int page = __shfl_sync(0xffffffffu, entry, t / pt - p0);
    return (static_cast<size_t>(page) * pt + t % pt) * KV + kv;
  }
};

// The TPU's online-softmax blocks (16-bit compute): bt positions a block,
// the first pass's unit of u positions, n_units units a row, and nbs the
// most blocks one span touches.
struct Blocks {
  int bt, unit, n_units, nbs;
};

// q rows, padded to 16 bytes
__host__ __device__ inline int pad4(int d) { return (d + 3) & ~3; }

// bytes of one staged V row in the storage dtype, padded to 16
__host__ __device__ inline int vrow_bytes(int dv, int bytes) {
  return (dv * bytes + 15) & ~15;
}

inline size_t decode_smem_bytes(int G, int GB, int dq, int dv, int bytes,
                                int nbs) {
  // the merge area doubles as the running block maxima during the walk
  const size_t warps = static_cast<size_t>(kWarps) * G * (dv + 2);
  const size_t maxima = static_cast<size_t>(G) * nbs;
  const size_t merge = warps > maxima ? warps : maxima;
  const size_t floats = static_cast<size_t>(G) * pad4(dq)   // q
                        + kWarps * GB * kTile               // p slabs
                        + merge;
  return static_cast<size_t>(kWarps) * kTile * vrow_bytes(dv, bytes) +
         floats * sizeof(float);
}

// Scores of position t0 + lane against the G queries in sq (rows of qs
// floats): one FMA chain per head, or four (by column mod 4) at GB = 1,
// over the K columns < rq in column order whatever the load width; -inf
// for a lane past the tile (live false).  scaled: the dot times scale,
// rounded (16-bit compute, as the TPU scales); else q came pre-scaled.
template <int GB, int K>
__device__ __forceinline__ void score(const uint8_t* kr, bool vec,
                                      const float* sq, int qs, int G, int rq,
                                      bool live, bool scaled, float scale,
                                      Fmt f, float (&sc)[GB]) {
  constexpr int kCh = GB == 1 ? 4 : 1;
  constexpr int kVec = Elem<K>::kVec;
  constexpr int kB = Elem<K>::kBytes;
  constexpr int kUnroll = 32 / kVec;
  float ch[GB][kCh];
#pragma unroll
  for (int g = 0; g < GB; ++g)
#pragma unroll
    for (int j = 0; j < kCh; ++j) ch[g][j] = 0.f;
  if (live) {
    int c = 0;
    if (vec) {
#pragma unroll(kUnroll)
      for (; c + kVec <= rq; c += kVec) {
        float kk[kVec];
        unpack<K>(__ldg(reinterpret_cast<const uint4*>(kr + c * kB)), kk, f);
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          if (g < G) {
#pragma unroll
            for (int j = 0; j < kVec; j += 4) {
              const float4 qq =
                  *reinterpret_cast<const float4*>(sq + g * qs + c + j);
              ch[g][0 % kCh] = fmaf(qq.x, kk[j], ch[g][0 % kCh]);
              ch[g][1 % kCh] = fmaf(qq.y, kk[j + 1], ch[g][1 % kCh]);
              ch[g][2 % kCh] = fmaf(qq.z, kk[j + 2], ch[g][2 % kCh]);
              ch[g][3 % kCh] = fmaf(qq.w, kk[j + 3], ch[g][3 % kCh]);
            }
          }
        }
      }
    }
    // the rest four at a time (columns past rq enter as exact zeros, so
    // every chain sees the same terms in the same order as in the vector
    // loop)
    for (; c < rq; c += 4) {
      float kk[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kk[j] = c + j < rq ? load_one<K, true>(kr, c + j, f) : 0.f;
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
    if (scaled) dot = __fmul_rn(dot, scale);
    sc[g] = live ? dot : -INFINITY;
  }
}

// The queries of KV group kv of row b into sq (rows of qs floats), as
// float32, times `scale` (float32 compute) or not.
__device__ __forceinline__ void stage_q(const void* q, float* sq, int b,
                                        int kv, int H, int G, int dq, int qs,
                                        float scale, int cd) {
  const size_t q0 = (static_cast<size_t>(b) * H + kv * G) * dq;
  for (int i = threadIdx.x; i < G * dq; i += kThreads) {
    const float x = load_q(q, q0 + i, cd);
    sq[i / dq * qs + i % dq] = cd == kF32 ? x * scale : x;
  }
}

// 16-byte global reads need every row start 16-byte aligned
__device__ __forceinline__ bool vec_rows(const uint8_t* base, int ld,
                                         int bytes) {
  return ld * bytes % 16 == 0 && reinterpret_cast<uintptr_t>(base) % 16 == 0;
}

// First pass (16-bit compute): the max scaled logit of each unit of
// blk.unit live positions, per query head, into umax (B, H, n_units).
// Same grid, spans, tiles and score chains as the main pass, so its
// maxima are maxima of the main pass's own logits.
template <int GB, int K>
__global__ void __launch_bounds__(kThreads)
decode_max_kernel(const void* __restrict__ q,
                  const int* __restrict__ lengths,
                  const int* __restrict__ qk_ranks,
                  float* __restrict__ umax, Rows rows, Blocks blk, Fmt f,
                  int H, int G, int dq, int span, float scale) {
  extern __shared__ __align__(16) float sq[];
  const int kv = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int lo = blockIdx.x * span;
  const int hi = min(lo + span, lengths[b]);
  if (lo >= hi) return;
  const int rq = qk_ranks ? max(0, min(qk_ranks[kv], dq)) : dq;
  const bool vec = vec_rows(rows.k, rows.ldk, Elem<K>::kBytes);
  const int qs = pad4(dq);
  stage_q(q, sq, b, kv, H, G, dq, qs, scale, f.cd);
  __syncthreads();
  const size_t head0 = (static_cast<size_t>(b) * H + kv * G) * blk.n_units;
  for (int t0 = lo + warp * kTile; t0 < hi; t0 += kWarps * kTile) {
    const int n = min(kTile, hi - t0);
    const size_t slot = rows.slot(b, kv, t0, n, lane);
    float sc[GB];
    score<GB, K>(rows.k + slot * rows.ldk * Elem<K>::kBytes, vec, sq, qs,
                 G, rq, lane < n, true, scale, f, sc);
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      if (g < G) {
        float x = sc[g];
        for (int o = 1; o < blk.unit; o <<= 1)   // within aligned units
          x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
        if (lane % blk.unit == 0 && lane < n)
          umax[head0 + g * blk.n_units + (t0 + lane) / blk.unit] = x;
      }
    }
  }
}

// GB: query heads per KV head, rounded up (1, 4, 16); CW: V columns per
// lane, ceil(dv / 32) rounded up (1, 2, 4, 8); K: the element kind.  At
// 16-bit compute (read at run time, uniform over the grid) p is rounded
// against the blocks' running maxima.
template <int GB, int CW, int K>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const void* __restrict__ q,
                    const int* __restrict__ lengths,
                    const int* __restrict__ qk_ranks,
                    const int* __restrict__ vo_ranks,
                    const float* __restrict__ umax, float* __restrict__ part,
                    Rows rows, Blocks blk, Fmt f, int H, int G, int dq,
                    int dv, int span, float scale) {
  constexpr int kB = Elem<K>::kBytes;
  constexpr int kVec = Elem<K>::kVec;
  extern __shared__ __align__(16) uint8_t smem[];
  const int s = blockIdx.x, kv = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x;
  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  const size_t stride = static_cast<size_t>(dv) + 2;   // m, l, acc[dv]
  const size_t head_stride = n_split * stride;
  float* pb = part + (static_cast<size_t>(b) * H + kv * G) * head_stride +
              s * stride;
  const int len = lengths[b];
  const int lo = s * span;
  const int hi = min(lo + span, len);
  if (lo >= hi) {                        // nothing of this row here
    for (int g = tid; g < G; g += kThreads) {
      pb[g * head_stride] = -INFINITY;
      pb[g * head_stride + 1] = 0.f;
    }
    return;
  }
  const int rq = qk_ranks ? max(0, min(qk_ranks[kv], dq)) : dq;
  const int rv = vo_ranks ? max(0, min(vo_ranks[kv], dv)) : dv;
  const bool vec = vec_rows(rows.k, rows.ldk, kB);
  const bool vec_v = vec_rows(rows.v, rows.ldv, kB);
  const int vrow = vrow_bytes(dv, kB), qs = pad4(dq);
  uint8_t* sv = smem + warp * kTile * vrow;             // this warp's V rows
  float* sq = reinterpret_cast<float*>(smem + kWarps * kTile * vrow);
  float* sp = sq + G * qs + warp * GB * kTile;          // this warp's p slab
  float* sm = sq + G * qs + kWarps * GB * kTile;        // merge: m
  float* sl = sm + kWarps * G;                          //        l
  float* sa = sl + kWarps * G;                          //        acc
  float* sR = sm;           // 16-bit: running block maxima during the walk
  // 16-bit compute (the cross kinds run only there, a float32 cache at
  // float32 compute only as kF32Kv): folded where the kind decides it
  const bool r16 = K == kF32Round || K == k16Round ||
                   (K != kF32Kv && f.cd != kF32);

  // H is laid out as KV groups of G consecutive query heads.
  stage_q(q, sq, b, kv, H, G, dq, qs, scale, f.cd);
  const int j0 = lo / blk.bt;             // the first block the span touches
  if (r16) {
    // R_j for the blocks j0 .. of the span, per head: the max over the
    // units before block j0, then a running max over each block's units
    const int nb = (hi - 1) / blk.bt - j0 + 1;
    const int nu = (len + blk.unit - 1) / blk.unit;   // units holding a live
    const int u0 = j0 * blk.bt / blk.unit;            // position
    for (int g = warp; g < G; g += kWarps) {
      const float* um = umax + (static_cast<size_t>(b) * H + kv * G + g) *
                                   blk.n_units;
      float x = -INFINITY;
      for (int i = lane; i < u0; i += kWarp) x = fmaxf(x, um[i]);
      float carry = warp_max(x);
      for (int c0 = 0; c0 < nb; c0 += kWarp) {
        const int jj = c0 + lane;
        float bm = -INFINITY;
        if (jj < nb) {
          const int j = j0 + jj;
          const int ub = min(((j + 1) * blk.bt + blk.unit - 1) / blk.unit, nu);
          for (int i = j * blk.bt / blk.unit; i < ub; ++i)
            bm = fmaxf(bm, um[i]);
        }
        for (int o = 1; o < kWarp; o <<= 1) {
          const float y = __shfl_up_sync(0xffffffffu, bm, o);
          if (lane >= o) bm = fmaxf(bm, y);
        }
        bm = fmaxf(bm, carry);
        if (jj < nb) sR[g * blk.nbs + jj] = bm;
        carry = __shfl_sync(0xffffffffu, bm, kWarp - 1);
      }
    }
  }
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
      const uint8_t* vr = rows.v + slot * rows.ldv * kB;
      uint8_t* dst = sv + lane * vrow;
      int c = 0;
      if (vec_v)
        for (; c + kVec <= rv; c += kVec)
          cp_async<16>(dst + c * kB, vr + c * kB, true);
      if constexpr (kB == 4) {
        for (; c < rv; ++c) cp_async<4>(dst + c * kB, vr + c * kB, true);
      } else if constexpr (kB == 2) {
        for (; c < rv; ++c)
          reinterpret_cast<unsigned short*>(dst)[c] =
              __ldg(reinterpret_cast<const unsigned short*>(vr) + c);
      } else {
        for (; c < rv; ++c) dst[c] = __ldg(vr + c);
      }
    }
    cp_async_commit();
    float sc[GB];
    score<GB, K>(rows.k + slot * rows.ldk * kB, vec, sq, qs, G, rq,
                 lane < n, r16, scale, f, sc);
    if (r16) {
      // p against the running max R of its own block, rounded; the tile's
      // reference is R of its last position's block
      const int jl = (t0 + min(lane, n - 1)) / blk.bt - j0;
      const int jn = (t0 + n - 1) / blk.bt - j0;
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        if (g < G) {
          const float m_new = sR[g * blk.nbs + jn];
          const float r = sR[g * blk.nbs + jl];
          const float p = expf(sc[g] - r);
          const float e = expf(r - m_new);
          const float alpha = expf(m[g] - m_new);
          m[g] = m_new;
          l[g] = l[g] * alpha + p * e;
#pragma unroll
          for (int i = 0; i < CW; ++i) acc[g][i] *= alpha;
          sp[g * kTile + lane] = round_to(p, f.cd) * e;
        }
      }
    } else {
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
        vv[i] = c < rv ? load_one<K, false>(sv + j * vrow, c, f) : 0.f;
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
  if (r16) __syncthreads();    // the walk's maxima share the merge area

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

struct Args {
  const void* q;
  const int* lengths;
  const int* qk_ranks;
  const int* vo_ranks;
  float* part;
  float* umax;
  void* out;
  float* lse;
  Rows rows;
  Blocks blk;
  Fmt f;
  int B, H, KV, dq, dv, n_split, span;
  float scale;
  cudaStream_t stream;
};

template <int GB, int CW, int K>
int launch_split(const Args& a) {
  const int G = a.H / a.KV;
  const size_t smem = decode_smem_bytes(G, GB, a.dq, a.dv, Elem<K>::kBytes,
                                        a.f.cd != kF32 ? a.blk.nbs : 0);
  cudaError_t err = allow_smem(decode_split_kernel<GB, CW, K>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_split_kernel<GB, CW, K>
      <<<dim3(a.n_split, a.KV, a.B), kThreads, smem, a.stream>>>(
          a.q, a.lengths, a.qk_ranks, a.vo_ranks, a.umax, a.part, a.rows,
          a.blk, a.f, a.H, G, a.dq, a.dv, a.span, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int GB, int K>
int launch_max(const Args& a) {
  const int G = a.H / a.KV;
  const size_t smem = static_cast<size_t>(G) * pad4(a.dq) * sizeof(float);
  cudaError_t err = allow_smem(decode_max_kernel<GB, K>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_max_kernel<GB, K>
      <<<dim3(a.n_split, a.KV, a.B), kThreads, smem, a.stream>>>(
          a.q, a.lengths, a.qk_ranks, a.umax, a.rows, a.blk, a.f, a.H, G,
          a.dq, a.span, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int GB, int K>
int launch_gb(const Args& a) {
  if constexpr (K != kF32Kv) {     // a float32 cache at 16-bit: kF32Round
    if (a.f.cd != kF32) {          // 16-bit compute: the first pass
      const int rc = launch_max<GB, K>(a);
      if (rc != 0) return rc;
    }
  }
  const int cw = (a.dv + kWarp - 1) / kWarp;
  if (cw <= 1) return launch_split<GB, 1, K>(a);
  if (cw <= 2) return launch_split<GB, 2, K>(a);
  if (cw <= 4) return launch_split<GB, 4, K>(a);
  return launch_split<GB, 8, K>(a);
}

template <int K>
int launch_kind(const Args& a) {
  const int G = a.H / a.KV;
  if (G == 1) return launch_gb<1, K>(a);
  if (G <= 4) return launch_gb<4, K>(a);
  return launch_gb<16, K>(a);
}

// kind i (its split kernels and first passes): part i % CLOVER_PARTS
#if CLOVER_HOLDS(0)                        // 15 kernels
template int launch_kind<k16Kv>(const Args&);
#elif CLOVER_HOLDS(0)
extern template int launch_kind<k16Kv>(const Args&);
#endif
#if CLOVER_HOLDS(1)                        // 12 kernels
template int launch_kind<kF32Kv>(const Args&);
#elif CLOVER_HOLDS(0)
extern template int launch_kind<kF32Kv>(const Args&);
#endif
#if CLOVER_HOLDS(2)                        // 15 kernels
template int launch_kind<kF32Round>(const Args&);
#elif CLOVER_HOLDS(0)
extern template int launch_kind<kF32Round>(const Args&);
#endif
#if CLOVER_HOLDS(3)                        // 15 kernels
template int launch_kind<k8Kv>(const Args&);
#elif CLOVER_HOLDS(0)
extern template int launch_kind<k8Kv>(const Args&);
#endif
#if CLOVER_HOLDS(4)                        // 15 kernels
template int launch_kind<k16Round>(const Args&);
#elif CLOVER_HOLDS(0)
extern template int launch_kind<k16Round>(const Args&);
#endif

#if CLOVER_HOLDS(0)
// out[b, h, c] = sum_s w_s acc_s[c] / max(sum_s w_s l_s, 1e-30), w_s =
// exp(m_s - max_s m_s), and 0 for an empty split (m_s = -inf), in the
// compute dtype cd (at 16-bit a true division, as the TPU divides; at
// float32 a product with the reciprocal).  With ``lse`` (may be null) also
// lse[b, h] = max_s m_s + log(sum_s w_s l_s), the log-sum-exp of the row's
// scaled logits, -inf for a row of length 0 (the sequence-split cache's
// combine over ranks reads it).
__global__ void __launch_bounds__(kThreads)
decode_combine_kernel(const float* __restrict__ part, void* __restrict__ out,
                      float* __restrict__ lse, int n_split, int dv, int cd) {
  const size_t stride = static_cast<size_t>(dv) + 2;
  const float* ph = part + blockIdx.x * n_split * stride;
  float M = -INFINITY;
  for (int s = 0; s < n_split; ++s) M = fmaxf(M, ph[s * stride]);
  float L = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const float ms = ph[s * stride];
    if (ms != -INFINITY) L += expf(ms - M) * ph[s * stride + 1];
  }
  const float den = fmaxf(L, 1e-30f);
  const float inv = 1.f / den;
  if (lse != nullptr && threadIdx.x == 0)
    lse[blockIdx.x] = L > 0.f ? M + logf(L) : -INFINITY;
  for (int c = threadIdx.x; c < dv; c += blockDim.x) {
    float a = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float ms = ph[s * stride];
      if (ms != -INFINITY) a += expf(ms - M) * ph[s * stride + 2 + c];
    }
    store_out(out, blockIdx.x * static_cast<size_t>(dv) + c,
              cd == kF32 ? a * inv : a / den, cd);
  }
}

int launch(const Args& a) {
  const bool r = a.f.cd != kF32;   // 16-bit compute
  int rc;
  if (a.f.kv == kF32)
    rc = r ? launch_kind<kF32Round>(a) : launch_kind<kF32Kv>(a);
  else if (a.f.kv == kBF16 || a.f.kv == kF16)
    rc = r && a.f.kv != a.f.cd ? launch_kind<k16Round>(a)
                               : launch_kind<k16Kv>(a);
  else
    rc = launch_kind<k8Kv>(a);
  if (rc != 0) return rc;
  decode_combine_kernel<<<a.B * a.H, kThreads, 0, a.stream>>>(
      a.part, a.out, a.lse, a.n_split, a.dv, a.f.cd);
  return static_cast<int>(cudaGetLastError());
}
#endif  // CLOVER_HOLDS(0)

}  // namespace decode
}  // namespace clover

#if CLOVER_HOLDS(0)
// One entry point for the four kernels.  table: (B, n_p) int32 pool rows
// (paged), or null for a dense cache of pt positions a row (n_p 1);
// qk_ranks / vo_ranks: (KV,) int32 or null (full width); lse: (B, H)
// float32 or null.  part: (B, H, n_split, dv + 2) float32 scratch;
// n_split * span covers the capacity (the wrapper's planner).  umax: (B,
// H, n_units) float32 scratch at 16-bit compute (n_units = ceil(n_p * pt
// / unit)), else null.  ldk >= dq, ldv >= dv: the row strides of k and v
// in elements.  bt, unit: the TPU's softmax block and the first pass's
// unit (positions).  cd: q's and out's dtype code; kvd: k's and v's.
extern "C" int clover_decode(const void* q, const void* k, const void* v,
                             const int* table, const int* lengths,
                             const int* qk_ranks, const int* vo_ranks,
                             float* part, float* umax, void* out, float* lse,
                             int B, int n_p, int pt, int H, int KV, int dq,
                             int dv, int ldk, int ldv, int n_split, int span,
                             int bt, int unit, int cd, int kvd, float scale,
                             cudaStream_t stream) {
  using namespace clover::decode;
  Args a;
  a.q = q;
  a.lengths = lengths;
  a.qk_ranks = qk_ranks;
  a.vo_ranks = vo_ranks;
  a.part = part;
  a.umax = umax;
  a.out = out;
  a.lse = lse;
  a.rows = Rows{static_cast<const uint8_t*>(k), static_cast<const uint8_t*>(v),
                table, n_p, pt, KV, ldk, ldv};
  const int capacity = n_p * pt;
  a.blk = Blocks{bt, unit, (capacity + unit - 1) / unit, (span - 1) / bt + 2};
  a.f = Fmt{kvd, cd};
  a.B = B;
  a.H = H;
  a.KV = KV;
  a.dq = dq;
  a.dv = dv;
  a.n_split = n_split;
  a.span = span;
  a.scale = scale;
  a.stream = stream;
  return launch(a);
}
#endif  // CLOVER_HOLDS(0)
