"""Paged flash-decoding against the global CLOVER-rank page pool
(DESIGN.md §4, §6, §14): the wrappers of the CUDA kernels in
``csrc/decode_attention.cu`` (one template with the dense kernels).

``paged_flash_decode`` replaces ``repro/kernels/paged_decode_attention.
py: paged_flash_decode``, ``paged_flash_decode_ranked`` its per-KV-head
rank-clamped variant (see ``decode_attention.flash_decode_ranked``).
Position ``t`` of row ``b`` lives at ``pool[page_table[b, t // pt],
t % pt]``; the kernels walk positions ``< lengths[b]`` only, so table
entries past ``ceil(lengths[b] / pt)`` (sentinel ids, pages of
rolled-back positions) are never dereferenced.  The time axis splits
into spans of whole pages (``decode_attention.plan_splits``).  The pools
may be ``pool[..., :r]`` views, read through the pool's row stride
(``decode_attention.row_stride``), in any ``POOL_DTYPES`` dtype with q in
a compute dtype, as the dense wrappers take them; each page is one block
of the online softmax the 16-bit form rounds against.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention import (check_decode_args,
                                                  check_dtypes,
                                                  check_rank_args, launch)


def _check_table(q: torch.Tensor, page_table: torch.Tensor) -> None:
    if (page_table.dim() != 2 or page_table.shape[0] != q.shape[0]
            or page_table.dtype != torch.int32
            or page_table.device != q.device
            or not page_table.is_contiguous()):
        raise ValueError("page_table must be a contiguous (B, n_p) int32 "
                         "tensor on q's device")


def paged_flash_decode(q: torch.Tensor, k_pool: torch.Tensor,
                       v_pool: torch.Tensor, page_table: torch.Tensor,
                       lengths: torch.Tensor, *,
                       scale: float) -> torch.Tensor:
    """q: (B, H, dq);  k_pool: (N, pt, KV, dq);  v_pool: (N, pt, KV, dv);
    page_table: (B, n_p) int32 pool rows;  lengths: (B,) int32 with
    ``lengths[b] <= n_p * pt``.  -> (B, H, dv) in q's dtype."""
    ldk, ldv = check_decode_args(q, k_pool, v_pool, lengths, q.shape[0])
    _check_table(q, page_table)
    return launch(paged_flash_decode, q, k_pool, v_pool, lengths, ldk, ldv,
                  scale=scale, table=page_table)


paged_flash_decode.launches = paged_flash_decode.strided_launches = 0


def paged_flash_decode_ranked(q: torch.Tensor, k_pool: torch.Tensor,
                              v_pool: torch.Tensor, page_table: torch.Tensor,
                              lengths: torch.Tensor, qk_ranks: torch.Tensor,
                              vo_ranks: torch.Tensor, *,
                              scale: float) -> torch.Tensor:
    """``paged_flash_decode`` with per-KV-head kept ranks: qk_ranks,
    vo_ranks (KV,) int32 on q's device.  -> (B, H, dv), dims >=
    vo_ranks[kv] exactly 0."""
    check_dtypes(q, k_pool, v_pool)
    check_rank_args(qk_ranks, vo_ranks, k_pool)
    ldk, ldv = check_decode_args(q, k_pool, v_pool, lengths, q.shape[0])
    _check_table(q, page_table)
    if qk_ranks.device != q.device or vo_ranks.device != q.device:
        raise ValueError("rank vectors must be on q's device")
    return launch(paged_flash_decode_ranked, q, k_pool, v_pool, lengths,
                  ldk, ldv, scale=scale, table=page_table,
                  ranks=(qk_ranks, vo_ranks))


paged_flash_decode_ranked.launches = 0
paged_flash_decode_ranked.strided_launches = 0
