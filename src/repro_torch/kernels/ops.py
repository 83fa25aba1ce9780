"""Kernel entry points: dispatch on the tensor's device (DESIGN.md §4,
§10).

A CUDA tensor goes to the hand-written kernel, a CPU tensor to the
plain PyTorch version in ``ref.py``.  There is no fallback: a kernel
that fails to build or launch raises.  (The reference's shard_map
branch and ``*_ranked`` variants arrive with their slices.)
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.clover_attention import flash_attention
from repro_torch.kernels.decode_attention import flash_decode
from repro_torch.kernels.paged_decode_attention import paged_flash_decode


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no attention kernel for device {t.device}")
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
