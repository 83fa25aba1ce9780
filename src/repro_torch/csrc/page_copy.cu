// Batched KV-page row movers of the paged pool (DESIGN.md §9, §12): the
// device half of copy-on-write prefix caching and of the host spill
// tier's restore.
//
// Replaces the TPU kernels
//   repro/kernels/page_copy.py  page_copy     (_page_copy_kernel)
//   repro/kernels/page_copy.py  page_restore  (_page_restore_kernel)
// A pool leaf is (n_blocks, N, pt, KV, r) of any KV cache dtype (float32,
// bfloat16, float16, float8); one page of one block is a contiguous row of
// pt * KV * r elements.  Both movers move whole rows as bytes, whatever the
// dtype, and update the pool in place.  One launch covers every KV leaf of
// a batch (K and V of each KV pattern entry): the leaves travel in a table
// passed by value (at most kMaxLeaves; the wrapper refuses more), each
// entry its pool, for a restore its slab rows, n_blocks, N, row bytes and
// its share of the grid.  The grid is one flat run of blocks over (leaf,
// block, chunk of the row); a block finds its entry by a scan of the table
// unrolled over constant indices, so the table stays in parameter space.
//
// page_copy: row dst[i] <- row src[i] for i = 0..m-1, in every block.  The
// movers read every pair's source before they write any destination: the
// plain versions of both packages (gather, then scatter: every read sees
// the input pool).  The TPU kernel runs its pairs in order; the two agree
// on every batch in which no pair reads a row an earlier pair wrote, which
// is every batch the engine makes (a page freed after serving as src[i]
// may come back as dst[j] only for a later j).  The executor refuses the
// other batches on the host (``LocalExecutor.page_copy``): a chained pair
// (dst[k] == src[i], k < i, pair k not a self-copy) and two pairs writing
// one row from different sources.  Self-copies (the sentinel -> sentinel
// padding) change nothing and move no bytes.
//
// page_restore: row dst[i] <- rows[b, i] for i = 0..W-1.  Padding repeats
// the sentinel dst with all-zero slabs: duplicate targets receive
// identical bytes, so the race between them is benign.
//
// Bound on the H100: pure data movement, the bytes read plus the bytes
// written, summed over the batch's leaves (2 * pairs * n_blocks * row
// bytes per leaf), over 3.35 TB/s.  gpt2-xl's batch of 4 pairs over its
// two leaves (48 blocks, rows of 16 * 25 * 32 elements each) is 39.3 MB in
// float32, 11.7 us (5.9 us in bfloat16, 2.9 us in float8) -- the size of a
// launch's own cost, so the design spends one launch per batch and keeps
// the whole batch's reads in flight at once:
//
//  * The bulk route (rows of a multiple of 16 bytes on 16-byte aligned
//    pools: every pool the repo serves).  A block stages its chunk of
//    every pair's source row in shared memory with 1-D TMA bulk copies
//    (cp.async.bulk ... mbarrier::complete_tx), issued back to back by one
//    thread onto one mbarrier, then writes them out with bulk stores
//    (cp.async.bulk.global.shared::cta.bulk_group), so no block waits on
//    one pair's read before it starts the next.  When m chunks exceed
//    the 227 KB a block may hold, the pairs run in groups, each group
//    read before it is written.  The restore takes the same route from
//    its slabs (16-byte vector loads with every slab in flight per
//    thread measured no faster; PERF.md).
//  * The byte route (any other row: odd widths, or a pointer off 16-byte
//    alignment).  One thread per access of the widest size (8, 4, 2 or 1
//    bytes) that divides every leaf's row bytes and every pointer; the
//    copy's thread walks its pairs in order.  The wrapper picks the route
//    on the host; each route counts its own launches.
#include <stdint.h>

#include "common.cuh"

namespace clover {
namespace {

constexpr int kMaxLeaves = 16;   // the table's capacity (kernels/page_copy.py)
constexpr int kFields = 7;       // int64s per leaf in the host's table
constexpr int kThreads = 256;    // byte route: accesses per block
constexpr int kBulkThreads = 32; // bulk route: one thread issues, one warp
constexpr int kBarBytes = 16;    // the mbarrier's slot before the chunks

struct Leaf {
  char* pool;         // (n_blocks, N, row_bytes) bytes
  const char* rows;   // restore: (n_blocks, W, row_bytes) bytes
  int n_blocks, N, row_bytes, n_chunks, cta_start;
};

struct Leaves {
  Leaf leaf[kMaxLeaves];
  int n;
};

// This block's leaf, pool block and chunk of the row.
struct Place {
  Leaf leaf;
  int block, chunk;
};

__device__ __forceinline__ Place place(const Leaves& t) {
  const int cta = blockIdx.x;
  Leaf l = t.leaf[0];
#pragma unroll
  for (int i = 1; i < kMaxLeaves; ++i)
    if (i < t.n && cta >= t.leaf[i].cta_start) l = t.leaf[i];
  const int local = cta - l.cta_start;
  return {l, local / l.n_chunks, local % l.n_chunks};
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// the one arrival of a phase, with the bytes its copies will deliver
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar,
                                              uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// Wait for the phase's copies.  A phase that never completes (bytes that
// never land) traps after ~2^31 cycles, a launch error the next
// synchronize reports, instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1ll << 31)) __trap();
}

__device__ __forceinline__ void bulk_load(uint32_t to, const void* from,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(to), "l"(from), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* to, uint32_t from,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               ::"l"(to), "r"(from), "r"(bytes) : "memory");
}

// every committed bulk store has read its shared memory
__device__ __forceinline__ void bulk_commit_and_drain() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// The bulk route.  Dynamic shared memory: the mbarrier, then ``group``
// chunks of ``chunk`` bytes.  A restore reads slab i of the block's rows
// (``src`` unused, m = W) and skips nothing.
template <bool kRestore>
__global__ void __launch_bounds__(kBulkThreads)
    page_bulk_kernel(Leaves t, const int* src, const int* dst, int m,
                     int chunk, int group) {
  extern __shared__ __align__(128) unsigned char smem[];
  if (threadIdx.x != 0) return;
  const Place p = place(t);
  const size_t row = p.leaf.row_bytes;
  const size_t off = static_cast<size_t>(p.chunk) * chunk;
  const uint32_t bytes =
      static_cast<uint32_t>(row - off < static_cast<size_t>(chunk)
                                ? row - off : chunk);
  char* layer = p.leaf.pool + static_cast<size_t>(p.block) * p.leaf.N * row;
  const char* slabs =
      kRestore ? p.leaf.rows + static_cast<size_t>(p.block) * m * row
               : nullptr;
  const uint32_t bar = smem_addr(smem);
  const uint32_t data = bar + kBarBytes;
  mbar_init(bar);
  uint32_t parity = 0;
  for (int g0 = 0; g0 < m; g0 += group) {
    const int g1 = g0 + group < m ? g0 + group : m;
    int n = 0;
    for (int i = g0; i < g1; ++i) n += kRestore || src[i] != dst[i];
    if (n == 0) continue;
    mbar_expect(bar, n * bytes);
    int k = 0;
    for (int i = g0; i < g1; ++i) {
      if (!kRestore && src[i] == dst[i]) continue;
      const char* from =
          kRestore ? slabs + static_cast<size_t>(i) * row + off
                   : layer + static_cast<size_t>(src[i]) * row + off;
      bulk_load(data + k++ * chunk, from, bytes, bar);
    }
    mbar_wait(bar, parity);
    parity ^= 1;
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    k = 0;
    for (int i = g0; i < g1; ++i) {
      if (!kRestore && src[i] == dst[i]) continue;
      bulk_store(layer + static_cast<size_t>(dst[i]) * row + off,
                 data + k++ * chunk, bytes);
    }
    // the next group's loads reuse the chunks; the block's shared memory
    // must outlive the last stores' reads
    bulk_commit_and_drain();
  }
}

// The byte route: one thread per V-sized access of the block's chunk of
// kThreads accesses.
template <class V>
__global__ void __launch_bounds__(kThreads)
    page_copy_bytes_kernel(Leaves t, const int* src, const int* dst, int m) {
  const Place p = place(t);
  const size_t row = p.leaf.row_bytes / sizeof(V);
  const size_t a = static_cast<size_t>(p.chunk) * kThreads + threadIdx.x;
  if (a >= row) return;
  V* layer = reinterpret_cast<V*>(p.leaf.pool) +
             static_cast<size_t>(p.block) * p.leaf.N * row;
  // in order: pair i's read precedes every later pair's write of the same
  // address, because both are this thread's (no __restrict__: the source
  // and destination rows may be the same memory)
  for (int i = 0; i < m; ++i)
    layer[static_cast<size_t>(dst[i]) * row + a] =
        layer[static_cast<size_t>(src[i]) * row + a];
}

template <class V>
__global__ void __launch_bounds__(kThreads)
    page_restore_bytes_kernel(Leaves t, const int* __restrict__ dst,
                              int W) {
  const Place p = place(t);
  const size_t row = p.leaf.row_bytes / sizeof(V);
  const size_t a = static_cast<size_t>(p.chunk) * kThreads + threadIdx.x;
  if (a >= row) return;
  V* layer = reinterpret_cast<V*>(p.leaf.pool) +
             static_cast<size_t>(p.block) * p.leaf.N * row;
  const V* __restrict__ slabs = reinterpret_cast<const V*>(p.leaf.rows) +
                                static_cast<size_t>(p.block) * W * row;
  for (int i = 0; i < W; ++i)
    layer[static_cast<size_t>(dst[i]) * row + a] =
        slabs[static_cast<size_t>(i) * row + a];
}

// launch(V{}) with V the unsigned type of ``bytes`` bytes (8, 4, 2, 1)
template <class F>
int by_access(int bytes, F launch) {
  switch (bytes) {
    case 8: return launch(uint2{});
    case 4: return launch(uint32_t{});
    case 2: return launch(uint16_t{});
    case 1: return launch(uint8_t{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// the host's table (kFields int64s per leaf) as the kernels' parameter
int unpack(const int64_t* table, int n, Leaves* t) {
  if (n < 1 || n > kMaxLeaves)
    return static_cast<int>(cudaErrorInvalidValue);
  *t = Leaves{};
  t->n = n;
  for (int i = 0; i < n; ++i) {
    const int64_t* f = table + i * kFields;
    Leaf& l = t->leaf[i];
    l.pool = reinterpret_cast<char*>(static_cast<intptr_t>(f[0]));
    l.rows = reinterpret_cast<const char*>(static_cast<intptr_t>(f[1]));
    l.n_blocks = static_cast<int>(f[2]);
    l.N = static_cast<int>(f[3]);
    l.row_bytes = static_cast<int>(f[4]);
    l.n_chunks = static_cast<int>(f[5]);
    l.cta_start = static_cast<int>(f[6]);
  }
  return 0;
}

// the bulk kernels take up to 227 KB of dynamic shared memory
template <class K>
int allow_smem(K kernel, int smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

}  // namespace
}  // namespace clover

// The routes: 0 the byte route (``access`` bytes per thread), 1 the bulk
// route (TMA).  table:
// n_leaves x 7 int64 (pool, rows, n_blocks, N, row_bytes, n_chunks,
// cta_start), planned by kernels/page_copy.py; ctas the grid.

// src/dst (m,) int32 row ids in [0, N) of every leaf.
extern "C" int clover_page_copy(const int64_t* table, int n_leaves,
                                const int* src, const int* dst, int m,
                                int route, int access, int chunk, int group,
                                int smem, int ctas, cudaStream_t stream) {
  if (m == 0 || ctas == 0) return 0;
  clover::Leaves t;
  if (int rc = clover::unpack(table, n_leaves, &t)) return rc;
  if (route == 1) {
    auto kernel = clover::page_bulk_kernel<false>;
    if (int rc = clover::allow_smem(kernel, smem)) return rc;
    kernel<<<ctas, clover::kBulkThreads, smem, stream>>>(t, src, dst, m,
                                                         chunk, group);
    return static_cast<int>(cudaGetLastError());
  }
  if (route != 0) return static_cast<int>(cudaErrorInvalidValue);
  return clover::by_access(access, [&](auto v) {
    using V = decltype(v);
    clover::page_copy_bytes_kernel<V>
        <<<ctas, clover::kThreads, 0, stream>>>(t, src, dst, m);
    return static_cast<int>(cudaGetLastError());
  });
}

// rows of each leaf (n_blocks, W, row_bytes) bytes of its pool's dtype, dst
// (W,) int32 row ids in [0, N).
extern "C" int clover_page_restore(const int64_t* table, int n_leaves,
                                   const int* dst, int W, int route,
                                   int access, int chunk, int group,
                                   int smem, int ctas, cudaStream_t stream) {
  if (W == 0 || ctas == 0) return 0;
  clover::Leaves t;
  if (int rc = clover::unpack(table, n_leaves, &t)) return rc;
  if (route == 1) {
    auto kernel = clover::page_bulk_kernel<true>;
    if (int rc = clover::allow_smem(kernel, smem)) return rc;
    kernel<<<ctas, clover::kBulkThreads, smem, stream>>>(t, nullptr, dst, W,
                                                         chunk, group);
    return static_cast<int>(cudaGetLastError());
  }
  if (route != 0) return static_cast<int>(cudaErrorInvalidValue);
  return clover::by_access(access, [&](auto v) {
    using V = decltype(v);
    clover::page_restore_bytes_kernel<V>
        <<<ctas, clover::kThreads, 0, stream>>>(t, dst, W);
    return static_cast<int>(cudaGetLastError());
  });
}
