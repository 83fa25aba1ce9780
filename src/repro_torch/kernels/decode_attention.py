"""Flash-decoding against a dense CLOVER-rank KV cache (DESIGN.md §4):
the wrapper of the CUDA kernel in ``csrc/decode_attention.cu``.

Replaces ``repro/kernels/decode_attention.py: flash_decode``.  One
query token per row against that row's cache, bounded by
``lengths[b]``; positions past it may hold anything and never count.
The kernel's design and its bound on the H100 are noted in the source.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

MAX_WIDTH = 256     # dq, dv the kernel's shared-memory plan accepts
MAX_GROUP = 16      # query heads per KV head


def check_decode_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      lengths: torch.Tensor, n_rows: int) -> None:
    """Validate what the decode kernels take (raise on anything else).
    ``k``/``v``: the dense cache (B, T, KV, d) or the pools (N, pt, KV,
    d); ``n_rows``: the batch size the lengths must cover."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the kernel takes float32, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dim() != 3 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"bad ranks: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    B, H, dq = q.shape
    KV = k.shape[2]
    dv = v.shape[3]
    if k.shape[:3] != v.shape[:3] or k.shape[3] != dq:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if KV < 1 or H % KV or H // KV > MAX_GROUP:
        raise ValueError(f"H={H} must be a multiple of KV={KV} with at "
                         f"most {MAX_GROUP} query heads per KV head")
    if not (1 <= dq <= MAX_WIDTH and 1 <= dv <= MAX_WIDTH):
        raise ValueError(f"dq={dq}, dv={dv}: the kernel takes widths in "
                         f"[1, {MAX_WIDTH}]")
    if (lengths.shape != (n_rows,) or lengths.dtype != torch.int32
            or lengths.device != q.device or not lengths.is_contiguous()):
        raise ValueError(f"lengths must be a contiguous ({n_rows},) int32 "
                         "tensor on q's device")


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lengths: torch.Tensor, *, scale: float) -> torch.Tensor:
    """q: (B, H, dq);  k: (B, T, KV, dq);  v: (B, T, KV, dv);
    lengths: (B,) int32 with ``lengths[b] <= T``.  -> (B, H, dv).

    H is laid out as KV groups of G = H / KV consecutive query heads.
    """
    check_decode_args(q, k, v, lengths, q.shape[0])
    B, H, dq = q.shape
    _, T, KV, _ = k.shape
    dv = v.shape[3]
    if k.shape[0] != B:
        raise ValueError(f"cache batch {k.shape[0]} != q batch {B}")
    out = torch.empty((B, H, dv), device=q.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _build.lib().clover_flash_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), B, T, H, KV, dq, dv, float(scale), stream)
    _build.check(rc, "flash_decode")
    flash_decode.launches += 1
    return out


flash_decode.launches = 0
