"""Kernel entry points: dispatch on the tensor's device (DESIGN.md §4,
§6, §10, §14).

A CUDA tensor goes to the hand-written kernel, a CPU tensor to the
plain PyTorch version in ``ref.py``.  There is no fallback: a kernel
that fails to build or launch raises.  The decode entries take
optional per-KV-head rank vectors: with neither given the unranked
kernels run unchanged; with one given the other defaults to full width
and the rank-clamped kernel runs.  (The reference's shard_map branch
arrives with tensor parallelism.)

Training is explicit: ``clover_attention``, ``wkv6`` and
``mamba_scan`` take ``plain=True`` from the training forward
(``models.transformer.train_forward``), which runs the plain version
under autograd on any device -- the reference trains through its XLA
path too (``kernel_impl="xla"``), and neither it nor the port has a
backward kernel.  A CUDA input that requires grad without ``plain``
raises, so no kernel is silently differentiated and no plain path is
silently taken.

The page movers update the pool leaf in place (the reference returns
a new array; its TPU kernel aliases the pool through).  ``wkv6`` and
``mamba_scan`` take the sequence length as a loop bound on the card, so
they pad nothing (the reference pads it to a chunk multiple with
state-neutral steps).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.clover_attention import flash_attention
from repro_torch.kernels.decode_attention import (flash_decode,
                                                  flash_decode_ranked)
from repro_torch.kernels.mamba_scan import mamba_scan as _mamba_scan
from repro_torch.kernels.page_copy import page_copy as _page_copy
from repro_torch.kernels.page_copy import page_restore as _page_restore
from repro_torch.kernels.paged_decode_attention import (
    paged_flash_decode, paged_flash_decode_ranked)
from repro_torch.kernels.wkv6 import wkv6 as _wkv6


# each kernel wrapper counts its launches where it launches, each plain
# version its calls
_WRAPPERS = (flash_attention, flash_decode, paged_flash_decode, _page_copy,
             _page_restore, flash_decode_ranked, paged_flash_decode_ranked,
             _mamba_scan, _wkv6)
_PLAIN = (ref.attention_ref, ref.decode_attention_ref,
          ref.paged_decode_attention_ref, ref.page_copy_ref,
          ref.page_restore_ref, ref.mamba_scan_ref, ref.wkv6_ref)


def launch_counts() -> dict:
    """{kernel name: launches} of this process's kernel wrappers, {plain
    version name: calls} of the plain versions, and {"<name>.strided":
    strided launches} of the decode kernels (reads of ``cache[..., :r]``
    views): what a process that served reports back."""
    out = {f.__name__: f.launches for f in _WRAPPERS}
    out.update({f.__name__: f.calls for f in _PLAIN})
    out.update({f"{f.__name__}.strided": f.strided_launches
                for f in _WRAPPERS if hasattr(f, "strided_launches")})
    return out


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no kernel for device {t.device}")
    return t.is_cuda


def _kernel(name: str, *inputs) -> bool:
    """True: launch the CUDA kernel; False: run the plain version (CPU
    inputs).  Raises on CUDA inputs that require grad: the kernels have
    no backward, and training asks for the plain version explicitly."""
    if not _on_cuda(inputs[0]):
        return False
    if any(t is not None and t.requires_grad for t in inputs):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward; the training "
            "forward passes plain=True (the reference trains through its "
            "XLA path as well)")
    return True


def clover_attention(q, k, v, *, scale: float,
                     plain: bool = False) -> torch.Tensor:
    """Causal GQA attention with asymmetric head widths.
    q (B,S,H,dq), k (B,T,KV,dq), v (B,T,KV,dv) -> (B,S,H,dv).
    ``plain``: the plain version on any device (training)."""
    if not plain and _kernel("clover_attention", q, k, v):
        return flash_attention(q, k, v, scale=scale)
    return ref.attention_ref(q, k, v, scale=scale, causal=True)


def _int32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32).contiguous()   # no copy if it already is


def _rank_vectors(qk_ranks, vo_ranks, KV: int, dq: int, dv: int, device):
    """Both (KV,) int32 rank vectors for a ranked kernel; a missing one
    is full width."""
    def full(r, d):
        if r is None:
            return torch.full((KV,), d, dtype=torch.int32, device=device)
        return _int32(r)
    return full(qk_ranks, dq), full(vo_ranks, dv)


def decode_attention(q, k, v, lengths, *, scale: float, qk_ranks=None,
                     vo_ranks=None) -> torch.Tensor:
    """Flash-decoding vs a dense (CLOVER-rank) cache.
    q (B,H,dq), k (B,T,KV,dq), v (B,T,KV,dv), lengths (B,) -> (B,H,dv).
    k / v may be ``cache[..., :r]`` views of a wider cache (the draft's
    sliced ranks, DESIGN.md §8): the kernel reads them through the
    cache's row stride.  qk_ranks / vo_ranks: optional (KV,) per-head
    kept ranks (a non-uniform ``RankBudget`` plan, DESIGN.md §14)."""
    if not _on_cuda(q):
        return ref.decode_attention_ref(q, k, v, lengths, scale=scale,
                                        qk_ranks=qk_ranks,
                                        vo_ranks=vo_ranks)
    if qk_ranks is None and vo_ranks is None:
        return flash_decode(q, k, v, _int32(lengths), scale=scale)
    qk, vo = _rank_vectors(qk_ranks, vo_ranks, k.shape[2], q.shape[-1],
                           v.shape[-1], q.device)
    return flash_decode_ranked(q, k, v, _int32(lengths), qk, vo,
                               scale=scale)


def paged_decode_attention(q, k_pool, v_pool, page_table, lengths, *,
                           scale: float, qk_ranks=None,
                           vo_ranks=None) -> torch.Tensor:
    """Flash-decoding vs the paged pool.  q (B,H,dq), k_pool
    (N,pt,KV,dq), v_pool (N,pt,KV,dv), page_table (B,n_p), lengths (B,)
    -> (B,H,dv).  Strided pool views and qk_ranks / vo_ranks as in
    ``decode_attention``."""
    if not _on_cuda(q):
        return ref.paged_decode_attention_ref(
            q, k_pool, v_pool, page_table, lengths, scale=scale,
            qk_ranks=qk_ranks, vo_ranks=vo_ranks)
    if qk_ranks is None and vo_ranks is None:
        return paged_flash_decode(q, k_pool, v_pool, _int32(page_table),
                                  _int32(lengths), scale=scale)
    qk, vo = _rank_vectors(qk_ranks, vo_ranks, k_pool.shape[2],
                           q.shape[-1], v_pool.shape[-1], q.device)
    return paged_flash_decode_ranked(q, k_pool, v_pool, _int32(page_table),
                                     _int32(lengths), qk, vo, scale=scale)


def page_copy(pool, src, dst) -> torch.Tensor:
    """Batched KV-page clone backing copy-on-write (DESIGN.md §9).
    pool (n_blocks, N, page_tokens, KV, r), src/dst (m,) pool-row ids
    -> pool with row ``dst[i]`` a copy of row ``src[i]``, in place."""
    if _on_cuda(pool):
        return _page_copy(pool, _int32(src), _int32(dst))
    return ref.page_copy_ref(pool, src, dst)


def page_restore(pool, rows, dst) -> torch.Tensor:
    """Host-tier restore scatter (DESIGN.md §12).  pool (n_blocks, N,
    page_tokens, KV, r), rows (n_blocks, W, page_tokens, KV, r) on the
    pool's device, dst (W,) pool-row ids -> pool with row ``dst[i]``
    holding ``rows[:, i]``, in place."""
    if _on_cuda(pool):
        return _page_restore(pool, rows, _int32(dst))
    return ref.page_restore_ref(pool, rows, dst)


def wkv6(r, k, v, logw, u, s0=None, *, plain: bool = False):
    """RWKV-6 wkv recurrence (the time-mix core of the rwkv family).
    r, k, v, logw (B, H, T, d), u (H, d), s0 (B, H, d, d) or None
    (zeros) -> (out (B, H, T, d), S_end (B, H, d, d)), float32; ``s0``
    is not modified.  ``plain``: the plain version (training)."""
    if not plain and _kernel("wkv6", r, k, v, logw, u, s0):
        return _wkv6(r, k, v, logw, u, s0)
    return ref.wkv6_ref(r, k, v, logw, u, s0)


def mamba_scan(dt, A, Bmat, C, x, h0=None, *, plain: bool = False):
    """Mamba-1 selective scan (the SSM core of the jamba family).
    dt, x (B, S, dI), A (dI, dS) positive, Bmat, C (B, S, dS), h0 (B,
    dI, dS) or None (zeros) -> (y (B, S, dI), h_end (B, dI, dS)),
    float32; ``h0`` is not modified.  ``plain``: the plain version
    (training)."""
    if not plain and _kernel("mamba_scan", x, dt, A, Bmat, C, h0):
        return _mamba_scan(dt, A, Bmat, C, x, h0)
    return ref.mamba_scan_ref(dt, A, Bmat, C, x, h0)
