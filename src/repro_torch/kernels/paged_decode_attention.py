"""Paged flash-decoding against the global CLOVER-rank page pool
(DESIGN.md §4, §6): the wrapper of the CUDA kernel in
``csrc/decode_attention.cu`` (one template with the dense kernel).

Replaces ``repro/kernels/paged_decode_attention.py:
paged_flash_decode``.  Position ``t`` of row ``b`` lives at
``pool[page_table[b, t // pt], t % pt]``; the kernel walks positions
``< lengths[b]`` only, so table entries past ``ceil(lengths[b] / pt)``
(sentinel ids, pages of rolled-back positions) are never dereferenced.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import check_decode_args


def paged_flash_decode(q: torch.Tensor, k_pool: torch.Tensor,
                       v_pool: torch.Tensor, page_table: torch.Tensor,
                       lengths: torch.Tensor, *,
                       scale: float) -> torch.Tensor:
    """q: (B, H, dq);  k_pool: (N, pt, KV, dq);  v_pool: (N, pt, KV, dv);
    page_table: (B, n_p) int32 pool rows;  lengths: (B,) int32 with
    ``lengths[b] <= n_p * pt``.  -> (B, H, dv)."""
    check_decode_args(q, k_pool, v_pool, lengths, q.shape[0])
    B, H, dq = q.shape
    _, pt, KV, _ = k_pool.shape
    dv = v_pool.shape[3]
    if (page_table.dim() != 2 or page_table.shape[0] != B
            or page_table.dtype != torch.int32
            or page_table.device != q.device
            or not page_table.is_contiguous()):
        raise ValueError("page_table must be a contiguous (B, n_p) int32 "
                         "tensor on q's device")
    n_p = page_table.shape[1]
    out = torch.empty((B, H, dv), device=q.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _build.lib().clover_paged_flash_decode(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        B, n_p, pt, H, KV, dq, dv, float(scale), stream)
    _build.check(rc, "paged_flash_decode")
    paged_flash_decode.launches += 1
    return out


paged_flash_decode.launches = 0
