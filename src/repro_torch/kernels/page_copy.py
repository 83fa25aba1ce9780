"""Batched KV-page row movers (DESIGN.md §9, §12): the wrappers of the
CUDA kernels in ``csrc/page_copy.cu``.

Replaces ``repro/kernels/page_copy.py: page_copy`` (copy-on-write
clone of shared prefix pages) and ``page_restore`` (scatter of
host-tier bytes back into the pool).  Both update the pool leaf IN
PLACE and return it; every row other than the ``dst`` rows keeps its
bytes.  As the TPU kernels do, they take a pool of any KV cache dtype
the reference serves (``POOL_DTYPES``): the kernels move rows as bytes.
The kernels' design, and why the copy walks its pairs in order, is
noted in the source.

Row ids are not bounds-checked on the device (that would cost a host
sync per launch): the caller checks them on the host, where the page
allocator made them, before moving them to the card
(``serve.executor.LocalExecutor._page_ids``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

_GRID_MAX = 65535       # CUDA's limit on a grid's y and z extents
# the KV cache dtypes a pool may hold (``ArchConfig.kv_cache_dtype``)
POOL_DTYPES = (torch.float32, torch.bfloat16, torch.float16,
               torch.float8_e4m3fn, torch.float8_e5m2)


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
    if pool.shape[0] > _GRID_MAX:
        raise ValueError(f"n_blocks={pool.shape[0]} > {_GRID_MAX}")


def _row_bytes(pool: torch.Tensor) -> int:
    """Bytes of one page of one block: what each kernel moves a row of."""
    return (pool.shape[2] * pool.shape[3] * pool.shape[4]
            * pool.element_size())


def _check_ids(name: str, ids: torch.Tensor, pool: torch.Tensor) -> None:
    if (ids.dim() != 1 or ids.dtype != torch.int32
            or ids.device != pool.device or not ids.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous 1-D int32 tensor on "
                         "the pool's device")


def page_copy(pool: torch.Tensor, src: torch.Tensor,
              dst: torch.Tensor) -> torch.Tensor:
    """pool: (n_blocks, N, page_tokens, KV, r) of a ``POOL_DTYPES`` dtype;
    src, dst: (m,) int32 row ids in [0, N).  Row ``dst[i]`` becomes a
    copy of row ``src[i]``, pairs in order.  -> ``pool``, updated in
    place."""
    _check_pool(pool)
    _check_ids("src", src, pool)
    _check_ids("dst", dst, pool)
    if src.shape != dst.shape:
        raise ValueError(f"src {tuple(src.shape)} / dst {tuple(dst.shape)}")
    n_blocks, N = pool.shape[:2]
    stream = torch.cuda.current_stream(pool.device).cuda_stream
    rc = _build.lib().clover_page_copy(
        pool.data_ptr(), src.data_ptr(), dst.data_ptr(), n_blocks, N,
        _row_bytes(pool), src.shape[0], stream)
    _build.check(rc, "page_copy")
    page_copy.launches += 1
    return pool


page_copy.launches = 0


def page_restore(pool: torch.Tensor, rows: torch.Tensor,
                 dst: torch.Tensor) -> torch.Tensor:
    """pool: (n_blocks, N, page_tokens, KV, r) of a ``POOL_DTYPES`` dtype;
    rows: (n_blocks, W, page_tokens, KV, r) of the pool's dtype on its
    device; dst: (W,) int32 row ids in [0, N).  Row ``dst[i]`` receives
    ``rows[:, i]``.  -> ``pool``, updated in place."""
    _check_pool(pool)
    _check_ids("dst", dst, pool)
    W = dst.shape[0]
    if (rows.device != pool.device or rows.dtype != pool.dtype
            or not rows.is_contiguous()
            or rows.shape != (pool.shape[0], W) + pool.shape[2:]):
        raise ValueError(f"rows must be a contiguous {pool.dtype} "
                         f"{(pool.shape[0], W) + tuple(pool.shape[2:])} "
                         f"tensor on the pool's device, got {rows.dtype} "
                         f"{tuple(rows.shape)}")
    if W > _GRID_MAX:
        raise ValueError(f"W={W} > {_GRID_MAX}")
    n_blocks, N = pool.shape[:2]
    stream = torch.cuda.current_stream(pool.device).cuda_stream
    rc = _build.lib().clover_page_restore(
        pool.data_ptr(), rows.data_ptr(), dst.data_ptr(), n_blocks, N,
        _row_bytes(pool), W, stream)
    _build.check(rc, "page_restore")
    page_restore.launches += 1
    return pool


page_restore.launches = 0
