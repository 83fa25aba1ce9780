// Batched KV-page row movers of the paged pool (DESIGN.md §9, §12): the
// device half of copy-on-write prefix caching and of the host spill
// tier's restore.
//
// Replaces the TPU kernels
//   repro/kernels/page_copy.py  page_copy     (_page_copy_kernel)
//   repro/kernels/page_copy.py  page_restore  (_page_restore_kernel)
// A pool leaf is (n_blocks, N, pt, KV, r) float32; one page of one block is
// a contiguous row of pt * KV * r floats.  Both kernels move whole rows and
// update the pool in place.
//
// page_copy: row dst[i] <- row src[i] for i = 0..m-1, in that order, in
// every block.  The TPU runs its (pair, block) grid sequentially, and the
// engine relies on that order: a page freed after serving as src[i] may be
// reallocated as dst[j] for a later j in the same batch.  A grid of one
// block per pair would let pair j overwrite that page before pair i has
// read it.  So the grid covers only (element offset within a row, block),
// and each thread walks the m pairs in order for its own offset: it reads
// src[i] at that offset before any later pair writes the same address.
// Sentinel -> sentinel padding pairs are self-copies and change nothing.
//
// page_restore: row dst[i] <- rows[b, i] for i = 0..W-1.  Every (offset,
// pair, block) is independent, so the grid covers all three.  Padding pairs
// repeat the sentinel dst with all-zero slabs: duplicate targets receive
// identical bytes, so the race between them is benign.
//
// Rows whose byte size is a multiple of 16 (and 16-byte aligned pointers)
// move as float4, one 16-byte load and store per thread; any other row size
// takes the scalar instantiation.
//
// Bound on the H100: pure data movement, the bytes read plus the bytes
// written (2 * pairs * n_blocks * row bytes) over 3.35 TB/s.  At the main
// path's shapes (48 blocks, rows of 16 * 25 * 32 floats, 4 pairs) that is
// 19.7 MB, about 5.9 us.  What the simple design leaves on the table: the
// copy's thread walks its pairs serially, so a batch's loads are not all
// in flight at once; one thread per 16 bytes and no cp.async/TMA bulk copy.
#include <stdint.h>

#include "common.cuh"

namespace clover {
namespace {

constexpr int kThreads = 256;

template <class V>
__global__ void page_copy_kernel(V* pool, const int* src, const int* dst,
                                 int m, size_t row, size_t block_stride) {
  const size_t off = static_cast<size_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
  if (off >= row) return;
  V* layer = pool + blockIdx.y * block_stride;
  // in order: pair i's read precedes every later pair's write of the same
  // address, because both are this thread's (no __restrict__: the source
  // and destination rows may be the same memory)
  for (int i = 0; i < m; ++i)
    layer[static_cast<size_t>(dst[i]) * row + off] =
        layer[static_cast<size_t>(src[i]) * row + off];
}

template <class V>
__global__ void page_restore_kernel(V* pool, const V* rows, const int* dst,
                                    int W, size_t row, size_t block_stride) {
  const size_t off = static_cast<size_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
  if (off >= row) return;
  const int i = blockIdx.y, b = blockIdx.z;
  pool[b * block_stride + static_cast<size_t>(dst[i]) * row + off] =
      rows[(static_cast<size_t>(b) * W + i) * row + off];
}

bool vec4_ok(int row_elems, const void* a, const void* b) {
  return row_elems % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(b) % 16 == 0;
}

template <class V>
int copy_launch(float* pool, const int* src, const int* dst, int n_blocks,
                int N, int row_elems, int m, cudaStream_t stream) {
  constexpr int kVec = sizeof(V) / sizeof(float);
  const size_t row = row_elems / kVec;
  const unsigned gx = static_cast<unsigned>((row + kThreads - 1) / kThreads);
  page_copy_kernel<V><<<dim3(gx, n_blocks), kThreads, 0, stream>>>(
      reinterpret_cast<V*>(pool), src, dst, m, row, row * N);
  return static_cast<int>(cudaGetLastError());
}

template <class V>
int restore_launch(float* pool, const float* rows, const int* dst,
                   int n_blocks, int N, int row_elems, int W,
                   cudaStream_t stream) {
  constexpr int kVec = sizeof(V) / sizeof(float);
  const size_t row = row_elems / kVec;
  const unsigned gx = static_cast<unsigned>((row + kThreads - 1) / kThreads);
  page_restore_kernel<V><<<dim3(gx, W, n_blocks), kThreads, 0, stream>>>(
      reinterpret_cast<V*>(pool), reinterpret_cast<const V*>(rows), dst, W,
      row, row * N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace clover

// pool (n_blocks, N, row_elems) float32, src/dst (m,) int32 row ids in
// [0, N).  Launches nothing for an empty batch.
extern "C" int clover_page_copy(float* pool, const int* src, const int* dst,
                                int n_blocks, int N, int row_elems, int m,
                                cudaStream_t stream) {
  if (m == 0 || n_blocks == 0 || row_elems == 0) return 0;
  if (clover::vec4_ok(row_elems, pool, pool))
    return clover::copy_launch<float4>(pool, src, dst, n_blocks, N,
                                       row_elems, m, stream);
  return clover::copy_launch<float>(pool, src, dst, n_blocks, N, row_elems,
                                    m, stream);
}

// pool (n_blocks, N, row_elems) float32, rows (n_blocks, W, row_elems)
// float32, dst (W,) int32 row ids in [0, N).
extern "C" int clover_page_restore(float* pool, const float* rows,
                                   const int* dst, int n_blocks, int N,
                                   int row_elems, int W,
                                   cudaStream_t stream) {
  if (W == 0 || n_blocks == 0 || row_elems == 0) return 0;
  if (clover::vec4_ok(row_elems, pool, rows))
    return clover::restore_launch<float4>(pool, rows, dst, n_blocks, N,
                                          row_elems, W, stream);
  return clover::restore_launch<float>(pool, rows, dst, n_blocks, N,
                                       row_elems, W, stream);
}
