"""Kernel entry points: dispatch on the tensor's device (DESIGN.md §4,
§10).

A CUDA tensor goes to the hand-written kernel, a CPU tensor to the
plain PyTorch version in ``ref.py``.  There is no fallback: a kernel
that fails to build or launch raises.  (The reference's shard_map
branch and ``*_ranked`` variants arrive with their slices.)

The page movers update the pool leaf in place (the reference returns
a new array; its TPU kernel aliases the pool through).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.clover_attention import flash_attention
from repro_torch.kernels.decode_attention import flash_decode
from repro_torch.kernels.page_copy import page_copy as _page_copy
from repro_torch.kernels.page_copy import page_restore as _page_restore
from repro_torch.kernels.paged_decode_attention import paged_flash_decode


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no kernel for device {t.device}")
    return t.is_cuda


def clover_attention(q, k, v, *, scale: float) -> torch.Tensor:
    """Causal GQA attention with asymmetric head widths.
    q (B,S,H,dq), k (B,T,KV,dq), v (B,T,KV,dv) -> (B,S,H,dv)."""
    if _on_cuda(q):
        return flash_attention(q, k, v, scale=scale)
    return ref.attention_ref(q, k, v, scale=scale, causal=True)


def decode_attention(q, k, v, lengths, *, scale: float) -> torch.Tensor:
    """Flash-decoding vs a dense (CLOVER-rank) cache.
    q (B,H,dq), k (B,T,KV,dq), v (B,T,KV,dv), lengths (B,) -> (B,H,dv)."""
    if _on_cuda(q):
        return flash_decode(q, k, v, lengths.to(torch.int32).contiguous(),
                            scale=scale)
    return ref.decode_attention_ref(q, k, v, lengths, scale=scale)


def paged_decode_attention(q, k_pool, v_pool, page_table, lengths, *,
                           scale: float) -> torch.Tensor:
    """Flash-decoding vs the paged pool.  q (B,H,dq), k_pool
    (N,pt,KV,dq), v_pool (N,pt,KV,dv), page_table (B,n_p), lengths (B,)
    -> (B,H,dv)."""
    if _on_cuda(q):
        return paged_flash_decode(
            q, k_pool, v_pool, page_table.to(torch.int32).contiguous(),
            lengths.to(torch.int32).contiguous(), scale=scale)
    return ref.paged_decode_attention_ref(q, k_pool, v_pool, page_table,
                                          lengths, scale=scale)


def page_copy(pool, src, dst) -> torch.Tensor:
    """Batched KV-page clone backing copy-on-write (DESIGN.md §9).
    pool (n_blocks, N, page_tokens, KV, r), src/dst (m,) pool-row ids
    -> pool with row ``dst[i]`` a copy of row ``src[i]``, in place."""
    if _on_cuda(pool):
        return _page_copy(pool, src.to(torch.int32).contiguous(),
                          dst.to(torch.int32).contiguous())
    return ref.page_copy_ref(pool, src, dst)


def page_restore(pool, rows, dst) -> torch.Tensor:
    """Host-tier restore scatter (DESIGN.md §12).  pool (n_blocks, N,
    page_tokens, KV, r), rows (n_blocks, W, page_tokens, KV, r) on the
    pool's device, dst (W,) pool-row ids -> pool with row ``dst[i]``
    holding ``rows[:, i]``, in place."""
    if _on_cuda(pool):
        return _page_restore(pool, rows, dst.to(torch.int32).contiguous())
    return ref.page_restore_ref(pool, rows, dst)
