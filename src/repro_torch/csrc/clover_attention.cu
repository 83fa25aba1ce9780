// Causal flash attention for CLOVER-pruned heads (DESIGN.md §4): GQA with
// asymmetric head widths (dq != dv), float32, online softmax.
//
// Replaces the TPU kernel
//   repro/kernels/clover_attention.py  flash_attention  (_flash_kernel)
//
// Design.  One block per (q-tile of 16 queries, head h, batch b), 128
// threads.  Queries align to the END of the key range (query i sits at
// position q_offset + i, q_offset = T - S).  The block stages its 16
// pre-scaled query rows in shared memory and walks key tiles of 32 from
// position 0 up to its causal diagonal only (the TPU kernel's `pl.when`
// skip of blocks above the diagonal becomes the loop bound), staging each
// tile's K (padded rows) and V in shared memory: 16 x 32 scores, the
// online-softmax update (one warp per query row), then acc[16, dv] += P V
// in shared memory.  The loop is bounded by the true T, so no padding of
// S or T is needed (the reference pads to block multiples in
// ops._clover_body).
//
// Bound on the H100: operations at scoring length.  The causal pairs times
// 2 (dq + dv) FLOPs, over the 67 TFLOP/s float32 peak of the CUDA cores;
// the bytes (q, k, v read once, out written once) are far smaller.  What
// the simple design leaves on the table: scores and P V run as scalar FMAs
// out of shared memory (two shared loads per FMA); register tiling, and on
// Hopper wgmma on TF32 or bf16 tiles with TMA-fed double buffers, would
// raise the arithmetic rate by an order of magnitude or more.  Each block
// also re-reads K/V tiles its neighbours read (L2 absorbs most of it).
#include "common.cuh"

namespace clover {
namespace {

constexpr int kThreads = 128;
constexpr int kBQ = 16;      // queries per block
constexpr int kBK = kWarp;   // keys per tile (one lane each)

size_t flash_smem_bytes(int dq, int dv) {
  const size_t floats = static_cast<size_t>(kBQ) * dq   // q
                        + kBK * (dq + 1)                // K tile (padded)
                        + kBK * dv                      // V tile
                        + kBQ * kBK                     // scores
                        + kBQ * dv                      // acc
                        + 3 * kBQ;                      // m, l, alpha
  return floats * sizeof(float);
}

__global__ void __launch_bounds__(kThreads)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ out, int S,
             int T, int H, int KV, int dq, int dv, float scale) {
  extern __shared__ float smem[];
  const int h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int kv = h / (H / KV);
  const int q0 = blockIdx.x * kBQ;
  const int nq = min(kBQ, S - q0);
  const int q_offset = T - S;
  const int ks = dq + 1;
  float* sq = smem;
  float* sk = sq + kBQ * dq;
  float* sv = sk + kBK * ks;
  float* ss = sv + kBK * dv;
  float* sacc = ss + kBQ * kBK;
  float* sm = sacc + kBQ * dv;
  float* sl = sm + kBQ;
  float* salpha = sl + kBQ;

  for (int i = tid; i < kBQ * dq; i += kThreads) {
    const int r = i / dq, c = i % dq;
    sq[i] = r < nq
        ? q[((static_cast<size_t>(b) * S + q0 + r) * H + h) * dq + c] * scale
        : 0.f;
  }
  for (int i = tid; i < kBQ * dv; i += kThreads) sacc[i] = 0.f;
  for (int r = tid; r < kBQ; r += kThreads) {
    sm[r] = -INFINITY;
    sl[r] = 0.f;
  }

  // keys visible to this tile: [0, position of its last query]
  const int t_end = q_offset + q0 + nq;
  for (int t0 = 0; t0 < t_end; t0 += kBK) {
    const int nt = min(kBK, t_end - t0);
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < nt * dq; i += kThreads) {
      const int r = i / dq, c = i % dq;
      sk[r * ks + c] =
          k[((static_cast<size_t>(b) * T + t0 + r) * KV + kv) * dq + c];
    }
    for (int i = tid; i < nt * dv; i += kThreads) {
      const int r = i / dv, c = i % dv;
      sv[r * dv + c] =
          v[((static_cast<size_t>(b) * T + t0 + r) * KV + kv) * dv + c];
    }
    __syncthreads();
    for (int i = tid; i < kBQ * kBK; i += kThreads) {
      const int r = i / kBK, j = i % kBK;
      float s = -INFINITY;
      if (r < nq && j < nt && t0 + j <= q_offset + q0 + r) {
        s = 0.f;
        const float* qr = sq + r * dq;
        const float* kr = sk + j * ks;
        for (int c = 0; c < dq; ++c) s = fmaf(qr[c], kr[c], s);
      }
      ss[i] = s;
    }
    __syncthreads();
    online_softmax_rows(ss, sm, sl, salpha, kBQ);
    __syncthreads();
    for (int i = tid; i < kBQ * dv; i += kThreads) {
      const int r = i / dv, c = i % dv;
      const float* p = ss + r * kBK;
      float a = sacc[i] * salpha[r];
      for (int j = 0; j < nt; ++j) a = fmaf(p[j], sv[j * dv + c], a);
      sacc[i] = a;
    }
  }
  __syncthreads();
  for (int i = tid; i < nq * dv; i += kThreads) {
    const int r = i / dv, c = i % dv;
    out[((static_cast<size_t>(b) * S + q0 + r) * H + h) * dv + c] =
        sacc[i] / fmaxf(sl[r], 1e-30f);
  }
}

}  // namespace
}  // namespace clover

extern "C" int clover_flash_attention(const float* q, const float* k,
                                      const float* v, float* out, int B,
                                      int S, int T, int H, int KV, int dq,
                                      int dv, float scale,
                                      cudaStream_t stream) {
  using namespace clover;
  const size_t smem = flash_smem_bytes(dq, dv);
  cudaError_t err = allow_smem(flash_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_kernel<<<grid, kThreads, smem, stream>>>(q, k, v, out, S, T, H, KV,
                                                 dq, dv, scale);
  return static_cast<int>(cudaGetLastError());
}
