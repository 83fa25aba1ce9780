"""Batched KV-page row movers (DESIGN.md §9, §12): the wrappers of the
CUDA kernels in ``csrc/page_copy.cu``.

Replaces ``repro/kernels/page_copy.py: page_copy`` (copy-on-write
clone of shared prefix pages) and ``page_restore`` (scatter of
host-tier bytes back into the pool).  Both update their pool leaves IN
PLACE and return them; every row other than the ``dst`` rows keeps its
bytes.  As the TPU kernels do, they take a pool of any KV cache dtype
the reference serves (``POOL_DTYPES``): the kernels move rows as bytes.

One launch moves a batch over every KV leaf given
(``page_copy_leaves`` / ``page_restore_leaves``, at most ``MAX_LEAVES``;
more raise); ``page_copy`` / ``page_restore`` are the reference's
one-leaf contract, the one-leaf case of the same launch.  A copy reads
every pair's source row before it writes any destination (the plain
versions' gather-then-scatter); the reference's TPU kernel runs its
pairs in order, and the two agree on every batch in which no pair reads
a row an earlier pair wrote -- every batch the engine makes.  The
executor refuses the others on the host (``serve.executor.
LocalExecutor.page_copy``).

``plan_movers`` is the host half, a pure function of the leaves' shapes
and pointers: the route (``"bulk"``, TMA bulk copies, for rows of a
multiple of 16 bytes on 16-byte aligned pointers -- every pool the repo
serves; or ``"bytes"``, one thread per access of the widest width that divides
every row and pointer), the chunk of a row each block moves, the pairs
staged in shared memory at once, the block's shared memory and the
leaf table.  Each route counts its own launches (``page_copy.routes``,
``page_restore.routes``) beside the mover's total (``launches``).  The
kernels' design is noted in the source.

Row ids are not bounds-checked on the device (that would cost a host
sync per launch): the caller checks them on the host, where the page
allocator made them, before moving them to the card.
"""
from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.kernels import _build

# the KV cache dtypes a pool may hold (``ArchConfig.kv_cache_dtype``)
POOL_DTYPES = (torch.float32, torch.bfloat16, torch.float16,
               torch.float8_e4m3fn, torch.float8_e5m2)
MAX_LEAVES = 16          # kMaxLeaves: the leaf table's capacity
SMEM_MAX = 232_448       # shared memory a block may use on the H100
BAR_BYTES = 16           # kBarBytes: the mbarrier's slot before the chunks
CHUNK_BYTES = 4096       # the bulk route's target chunk of a row per block
THREADS = 256            # kThreads: the byte route's accesses per block
_ROUTE_CODE = {"bytes": 0, "bulk": 1}
# a leaf as the planner sees it: (pool pointer, rows pointer or 0,
# n_blocks, N, row bytes)
Leaf = Tuple[int, int, int, int, int]


@dataclass(frozen=True)
class MoverPlan:
    """One launch of a mover.  ``table``: per leaf (pool, rows, n_blocks,
    N, row bytes, chunks per row, first block), the kernels' parameter;
    ``ctas`` the grid."""
    route: str
    access: int          # bytes per access (16 on the bulk route)
    chunk: int           # bytes of a row each block moves
    group: int           # pairs staged in shared memory at once (bulk)
    smem: int            # dynamic shared memory per block
    table: Tuple[Tuple[int, ...], ...]
    ctas: int


def plan_movers(leaves: Sequence[Leaf], m: int) -> MoverPlan:
    """Plan one launch over ``leaves`` moving ``m`` pairs (a copy's
    ``rows`` pointers are 0; a restore's its leaves' slabs, m = W).  The
    bulk route's chunk is the widest row cut into near-equal chunks of
    at most ``CHUNK_BYTES`` (a multiple of 16: power-of-two chunks would
    land every block on the same offsets).  Leaves of no bytes are
    dropped."""
    if len(leaves) > MAX_LEAVES:
        raise ValueError(f"{len(leaves)} pool leaves in one launch: the "
                         f"movers' table holds {MAX_LEAVES}")
    live = [lf for lf in leaves if lf[2] > 0 and lf[4] > 0]
    bits = 0
    for pool, rows, _, _, row in live:
        bits |= pool | rows | row
    group = smem = 0
    if bits % 16:
        route = "bytes"
        access = next(w for w in (8, 4, 2, 1) if bits % w == 0)
        chunk = THREADS * access
    else:
        route, access = "bulk", 16
        widest = max((lf[4] for lf in live), default=16)
        chunk = 16 * math.ceil(widest / math.ceil(widest / CHUNK_BYTES) / 16)
        group = max(1, min(m, (SMEM_MAX - BAR_BYTES) // chunk))
        smem = BAR_BYTES + group * chunk
    table, ctas = [], 0
    for pool, rows, n_blocks, N, row in live:
        n_chunks = math.ceil(row / chunk)
        table.append((pool, rows, n_blocks, N, row, n_chunks, ctas))
        ctas += n_blocks * n_chunks
    if ctas >= 2 ** 31:
        raise ValueError(f"{ctas} blocks: past CUDA's grid limit")
    return MoverPlan(route, access, chunk, group, smem, tuple(table),
                     ctas if m > 0 else 0)


def _check_pool(pool: torch.Tensor) -> None:
    if pool.dtype not in POOL_DTYPES:
        raise TypeError(f"pool: the kernels take a KV cache dtype "
                        f"({', '.join(str(d) for d in POOL_DTYPES)}), got "
                        f"{pool.dtype}")
    if not pool.is_cuda:
        raise ValueError("pool must be a CUDA tensor")
    if pool.dim() != 5 or not pool.is_contiguous():
        raise ValueError("pool must be a contiguous (n_blocks, N, "
                         f"page_tokens, KV, r) tensor, got "
                         f"{tuple(pool.shape)}")


def _check_pools(pools: Sequence[torch.Tensor]) -> None:
    if not pools:
        raise ValueError("no pool leaves")
    if len(pools) > MAX_LEAVES:
        raise ValueError(f"{len(pools)} pool leaves in one launch: the "
                         f"movers' table holds {MAX_LEAVES}")
    for pool in pools:
        _check_pool(pool)
        if pool.device != pools[0].device:
            raise ValueError("pool leaves on different devices")
        if pool.shape[1] != pools[0].shape[1]:
            raise ValueError("pool leaves of different row counts N: one "
                             "page id addresses every leaf")


def mover_leaf(pool: torch.Tensor, rows: Optional[torch.Tensor] = None
               ) -> Leaf:
    """``pool`` (and a restore's ``rows``) as ``plan_movers`` takes a
    leaf; a row is one page of one block."""
    return (pool.data_ptr(), 0 if rows is None else rows.data_ptr(),
            pool.shape[0], pool.shape[1],
            math.prod(pool.shape[2:]) * pool.element_size())


def _check_ids(name: str, ids: torch.Tensor, pool: torch.Tensor) -> None:
    if (ids.dim() != 1 or ids.dtype != torch.int32
            or ids.device != pool.device or not ids.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous 1-D int32 tensor on "
                         "the pool's device")


def _launch(mover, plan: MoverPlan, pools, *ids_and_m) -> None:
    """Launch ``plan`` through the C entry of ``mover`` (``page_copy`` or
    ``page_restore``) and count it: the mover's launches and its
    route's."""
    if plan.ctas == 0:
        return
    flat = [f for leaf in plan.table for f in leaf]
    table = (ctypes.c_int64 * len(flat))(*flat)
    stream = torch.cuda.current_stream(pools[0].device).cuda_stream
    rc = getattr(_build.lib(), f"clover_{mover.__name__}")(
        table, len(plan.table), *ids_and_m, _ROUTE_CODE[plan.route],
        plan.access, plan.chunk, plan.group, plan.smem, plan.ctas, stream)
    _build.check(rc, mover.__name__)
    mover.launches += 1
    mover.routes[plan.route] += 1


def page_copy_leaves(pools: Sequence[torch.Tensor], src: torch.Tensor,
                     dst: torch.Tensor):
    """pools: KV leaves (n_blocks, N, page_tokens, KV, r) of
    ``POOL_DTYPES`` dtypes, one N; src, dst: (m,) int32 row ids in [0,
    N).  In every leaf row ``dst[i]`` becomes a copy of row ``src[i]``,
    every source read before any destination is written; one launch.
    -> ``pools``, updated in place."""
    _check_pools(pools)
    _check_ids("src", src, pools[0])
    _check_ids("dst", dst, pools[0])
    if src.shape != dst.shape:
        raise ValueError(f"src {tuple(src.shape)} / dst {tuple(dst.shape)}")
    m = src.shape[0]
    plan = plan_movers([mover_leaf(p) for p in pools], m)
    _launch(page_copy, plan, pools, src.data_ptr(), dst.data_ptr(), m)
    return pools


def page_copy(pool: torch.Tensor, src: torch.Tensor,
              dst: torch.Tensor) -> torch.Tensor:
    """pool: (n_blocks, N, page_tokens, KV, r) of a ``POOL_DTYPES`` dtype;
    src, dst: (m,) int32 row ids in [0, N).  Row ``dst[i]`` becomes a
    copy of row ``src[i]``.  -> ``pool``, updated in place."""
    page_copy_leaves([pool], src, dst)
    return pool


page_copy.launches = 0
page_copy.routes = {"bulk": 0, "bytes": 0}


def page_restore_leaves(pools: Sequence[torch.Tensor],
                        rows: Sequence[torch.Tensor], dst: torch.Tensor):
    """pools: KV leaves as ``page_copy_leaves``'; rows: per leaf its
    (n_blocks, W, page_tokens, KV, r) slabs of the pool's dtype on its
    device (slices of one packed buffer, or not); dst: (W,) int32 row
    ids in [0, N).  Row ``dst[i]`` of each leaf receives its ``rows[:,
    i]``; one launch.  -> ``pools``, updated in place."""
    _check_pools(pools)
    _check_ids("dst", dst, pools[0])
    if len(rows) != len(pools):
        raise ValueError(f"{len(rows)} row slabs for {len(pools)} pool "
                         "leaves")
    W = dst.shape[0]
    for pool, r in zip(pools, rows):
        want = (pool.shape[0], W) + tuple(pool.shape[2:])
        if (r.device != pool.device or r.dtype != pool.dtype
                or not r.is_contiguous() or tuple(r.shape) != want):
            raise ValueError(f"rows must be a contiguous {pool.dtype} "
                             f"{want} tensor on the pool's device, got "
                             f"{r.dtype} {tuple(r.shape)}")
    plan = plan_movers([mover_leaf(p, r) for p, r in zip(pools, rows)], W)
    _launch(page_restore, plan, pools, dst.data_ptr(), W)
    return pools


def page_restore(pool: torch.Tensor, rows: torch.Tensor,
                 dst: torch.Tensor) -> torch.Tensor:
    """pool: (n_blocks, N, page_tokens, KV, r) of a ``POOL_DTYPES`` dtype;
    rows: (n_blocks, W, page_tokens, KV, r) of the pool's dtype on its
    device; dst: (W,) int32 row ids in [0, N).  Row ``dst[i]`` receives
    ``rows[:, i]``.  -> ``pool``, updated in place."""
    page_restore_leaves([pool], [rows], dst)
    return pool


page_restore.launches = 0
page_restore.routes = {"bulk": 0, "bytes": 0}
