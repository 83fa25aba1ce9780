// Flash-decoding for CLOVER-rank KV caches, dense and paged (DESIGN.md §4,
// §6): one new token's query per row against the row's cached keys and
// values, online softmax in float32.
//
// Replaces the TPU kernels
//   repro/kernels/decode_attention.py        flash_decode        (_decode_kernel)
//   repro/kernels/paged_decode_attention.py  paged_flash_decode  (_paged_decode_kernel)
// One template serves both; they differ only in how position t of row b is
// addressed (DenseRows: k[b, t, kv]; PagedRows: pool[table[b, t / pt],
// t % pt, kv]).
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
// Bound on the H100: the bytes of K and V streamed, lengths[b] * (dq + dv)
// * 4 per (b, kv), over 3.35 TB/s.  What the simple design leaves on the
// table: (1) one block per (b, kv) gives only B * KV blocks -- at gpt2-xl's
// 25 MHA heads and 4 slots that is 100 blocks on 132 SMs, each walking its
// row serially; a split-K pass over the time axis with a second reduction
// kernel would fill the card.  (2) Loads are scalar and synchronous; 16-byte
// vector loads and a cp.async/TMA double buffer would overlap the stream
// with the arithmetic.  (3) With G = 1 only 32 of 128 threads compute
// scores.
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
              float* __restrict__ out, Rows rows, int H, int G, int dq,
              int dv, float scale) {
  extern __shared__ float smem[];
  const int kv = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int ks = dq + 1;
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
    for (int i = tid; i < nt * dq; i += kThreads) {
      const int r = i / dq, c = i % dq;
      sk[r * ks + c] = rows.krow(b, kv, t0 + r)[c];
    }
    for (int i = tid; i < nt * dv; i += kThreads) {
      const int r = i / dv, c = i % dv;
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
        for (int c = 0; c < dq; ++c) s = fmaf(qg[c], kr[c], s);
      }
      ss[i] = s;
    }
    __syncthreads();
    online_softmax_rows(ss, sm, sl, salpha, G);
    __syncthreads();
    for (int i = tid; i < G * dv; i += kThreads) {
      const int g = i / dv, c = i % dv;
      const float* p = ss + g * kTileT;
      float a = sacc[i] * salpha[g];
      for (int r = 0; r < nt; ++r) a = fmaf(p[r], sv[r * dv + c], a);
      sacc[i] = a;
    }
  }
  __syncthreads();
  float* ob = out + (static_cast<size_t>(b) * H + kv * G) * dv;
  for (int i = tid; i < G * dv; i += kThreads)
    ob[i] = sacc[i] / fmaxf(sl[i / dv], 1e-30f);
}

template <class Rows>
int launch(const float* q, const int* lengths, float* out, Rows rows, int B,
           int H, int KV, int dq, int dv, float scale, cudaStream_t stream) {
  const int G = H / KV;
  const size_t smem = decode_smem_bytes(G, dq, dv);
  cudaError_t err = allow_smem(decode_kernel<Rows>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_kernel<Rows><<<dim3(KV, B), kThreads, smem, stream>>>(
      q, lengths, out, rows, H, G, dq, dv, scale);
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
  return clover::launch(q, lengths, out, rows, B, H, KV, dq, dv, scale,
                        stream);
}

extern "C" int clover_paged_flash_decode(const float* q, const float* k_pool,
                                         const float* v_pool,
                                         const int* page_table,
                                         const int* lengths, float* out,
                                         int B, int n_p, int pt, int H,
                                         int KV, int dq, int dv, float scale,
                                         cudaStream_t stream) {
  clover::PagedRows rows{k_pool, v_pool, page_table, n_p, pt, KV, dq, dv};
  return clover::launch(q, lengths, out, rows, B, H, KV, dq, dv, scale,
                        stream);
}
