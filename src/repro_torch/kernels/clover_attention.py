"""Causal flash attention for CLOVER-pruned heads (DESIGN.md §4): the
wrapper of the CUDA kernel in ``csrc/clover_attention.cu``.

Replaces ``repro/kernels/clover_attention.py: flash_attention``: GQA,
asymmetric head widths (dq != dv), queries aligned to the end of the
key range (``q_offset = T - S``), key tiles above the causal diagonal
skipped.  The kernel bounds its loop by the true ``T``, so no padding
is needed.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

MAX_WIDTH = 256     # dq, dv the kernel's shared-memory plan accepts


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float) -> torch.Tensor:
    """q: (B, S, H, dq);  k: (B, T, KV, dq);  v: (B, T, KV, dv) with
    S <= T and H % KV == 0.  Causal.  -> (B, S, H, dv) float32."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the kernel takes float32, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-D, got {tuple(t.shape)}")
    B, S, H, dq = q.shape
    _, T, KV, _ = k.shape
    dv = v.shape[3]
    if k.shape[0] != B or k.shape[3] != dq or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} do not match")
    if KV < 1 or H % KV:
        raise ValueError(f"H={H} is not a multiple of KV={KV}")
    if not 1 <= S <= T:
        raise ValueError(f"need 1 <= S={S} <= T={T}")
    if not (1 <= dq <= MAX_WIDTH and 1 <= dv <= MAX_WIDTH):
        raise ValueError(f"dq={dq}, dv={dv}: the kernel takes widths in "
                         f"[1, {MAX_WIDTH}]")
    out = torch.empty((B, S, H, dv), device=q.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _build.lib().clover_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, S, T, H, KV, dq, dv, float(scale), stream)
    _build.check(rc, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
