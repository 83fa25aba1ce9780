// Batched KV-page row movers of the paged pool (DESIGN.md §9, §12): the
// device half of copy-on-write prefix caching and of the host spill
// tier's restore.
//
// Replaces the TPU kernels
//   repro/kernels/page_copy.py  page_copy     (_page_copy_kernel)
//   repro/kernels/page_copy.py  page_restore  (_page_restore_kernel)
// A pool leaf is (n_blocks, N, pt, KV, r) of any KV cache dtype (float32,
// bfloat16, float16, float8); one page of one block is a contiguous row of
// pt * KV * r elements.  Both kernels move whole rows as bytes, whatever
// the dtype, and update the pool in place.
//
// page_copy: row dst[i] <- row src[i] for i = 0..m-1, in that order, in
// every block.  The TPU runs its (pair, block) grid sequentially, and the
// engine relies on that order: a page freed after serving as src[i] may be
// reallocated as dst[j] for a later j in the same batch.  A grid of one
// block per pair would let pair j overwrite that page before pair i has
// read it.  So the grid covers only (access offset within a row, block),
// and each thread walks the m pairs in order for its own offset: it reads
// src[i] at that offset before any later pair writes the same address.
// Sentinel -> sentinel padding pairs are self-copies and change nothing.
//
// page_restore: row dst[i] <- rows[b, i] for i = 0..W-1.  Every (offset,
// pair, block) is independent, so the grid covers all three.  Padding pairs
// repeat the sentinel dst with all-zero slabs: duplicate targets receive
// identical bytes, so the race between them is benign.
//
// Each thread moves one access of the widest size (16, 8, 4, 2 or 1 bytes)
// that divides the row's byte size and both base pointers: row starts are
// multiples of the row's bytes, so every access is then aligned.  A
// float32 row of a multiple of 16 bytes moves as 16-byte vectors, as the
// float4 instantiation did before the movers took narrow pools.
//
// Bound on the H100: pure data movement, the bytes read plus the bytes
// written (2 * pairs * n_blocks * row bytes) over 3.35 TB/s.  At the main
// path's shapes (48 blocks, rows of 16 * 25 * 32 elements, 4 pairs) that is
// 19.7 MB in float32, about 5.9 us (2.9 us in bfloat16, 1.5 us in float8).
// What the simple design leaves on the table: the copy's thread walks its
// pairs serially, so a batch's loads are not all in flight at once; one
// thread per access and no cp.async/TMA bulk copy.
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

// the widest access in bytes that divides the row's byte size and both
// pointers
int access_bytes(int row_bytes, const void* a, const void* b) {
  const uintptr_t bits = static_cast<uintptr_t>(row_bytes) |
                         reinterpret_cast<uintptr_t>(a) |
                         reinterpret_cast<uintptr_t>(b);
  int w = 16;
  while (w > 1 && bits % w != 0) w >>= 1;
  return w;
}

// launch(V{}) with V the unsigned type of ``bytes`` bytes
template <class F>
int by_access(int bytes, F launch) {
  switch (bytes) {
    case 16: return launch(uint4{});
    case 8: return launch(uint2{});
    case 4: return launch(uint32_t{});
    case 2: return launch(uint16_t{});
    default: return launch(uint8_t{});
  }
}

unsigned grid_x(size_t row) {
  return static_cast<unsigned>((row + kThreads - 1) / kThreads);
}

}  // namespace
}  // namespace clover

// pool (n_blocks, N, row_bytes) bytes, src/dst (m,) int32 row ids in
// [0, N).  Launches nothing for an empty batch.
extern "C" int clover_page_copy(void* pool, const int* src, const int* dst,
                                int n_blocks, int N, int row_bytes, int m,
                                cudaStream_t stream) {
  if (m == 0 || n_blocks == 0 || row_bytes == 0) return 0;
  return clover::by_access(
      clover::access_bytes(row_bytes, pool, pool), [&](auto v) {
        using V = decltype(v);
        const size_t row = row_bytes / sizeof(V);
        clover::page_copy_kernel<V>
            <<<dim3(clover::grid_x(row), n_blocks), clover::kThreads, 0,
               stream>>>(static_cast<V*>(pool), src, dst, m, row, row * N);
        return static_cast<int>(cudaGetLastError());
      });
}

// pool (n_blocks, N, row_bytes) bytes, rows (n_blocks, W, row_bytes) bytes
// of the pool's dtype, dst (W,) int32 row ids in [0, N).
extern "C" int clover_page_restore(void* pool, const void* rows,
                                   const int* dst, int n_blocks, int N,
                                   int row_bytes, int W,
                                   cudaStream_t stream) {
  if (W == 0 || n_blocks == 0 || row_bytes == 0) return 0;
  return clover::by_access(
      clover::access_bytes(row_bytes, pool, rows), [&](auto v) {
        using V = decltype(v);
        const size_t row = row_bytes / sizeof(V);
        clover::page_restore_kernel<V>
            <<<dim3(clover::grid_x(row), W, n_blocks), clover::kThreads, 0,
               stream>>>(static_cast<V*>(pool), static_cast<const V*>(rows),
                         dst, W, row, row * N);
        return static_cast<int>(cudaGetLastError());
      });
}
