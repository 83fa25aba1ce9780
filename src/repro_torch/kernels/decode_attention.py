"""Flash-decoding against a dense CLOVER-rank KV cache (DESIGN.md §4,
§14): the wrappers of the CUDA kernels in ``csrc/decode_attention.cu``.

``flash_decode`` replaces ``repro/kernels/decode_attention.py:
flash_decode``: one query token per row against that row's cache,
bounded by ``lengths[b]``; positions past it may hold anything and
never count.  With ``return_lse`` it also returns each row's float32
log-sum-exp of the scaled logits (-inf at length 0), from the split-K
combine's (m, l) pairs: a cache split along its sequence merges its
windows with it (``parallel.sharding.combine_seq_partials``).  ``flash_decode_ranked`` replaces ``flash_decode_ranked``
there: the same with a per-KV-head kept-rank clamp (a non-uniform
``RankBudget`` plan), K dims >= ``qk_ranks[kv]`` and V dims >=
``vo_ranks[kv]`` neither loaded nor computed, and output dims >=
``vo_ranks[kv]`` written as 0.  The kernels' design and their bound on
the H100 are noted in the source.

K and V may be row-strided views: ``cache[..., :r]`` of a contiguous
cache (or pool) reaches the kernels as it lies, with the cache's width
as the row stride (``row_stride``).  The self-speculative draft reads
its sliced ranks that way (DESIGN.md §8); any other layout is refused.

The kernels split each row's time axis over blocks (split-K, then a
combine kernel).  ``plan_splits`` picks the split from static shapes
only -- the cache's capacity, the rows B * KV and the card's SM count,
never ``lengths`` -- so a decode step reads nothing back to the host.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.kernels import _build

MAX_WIDTH = 256     # dq, dv the kernel's shared-memory plan accepts
MAX_GROUP = 16      # query heads per KV head
MIN_SPAN = 32       # positions a split spans at least (one warp tile)
BLOCKS_PER_SM = 4   # the planner's target: B * KV * n_split >= 4 * SMs


def plan_splits(capacity: int, rows: int, sms: int,
                page_tokens: int = 1) -> Tuple[int, int]:
    """-> (n_split, span): split the positions ``[0, capacity)`` of each
    of ``rows`` (B * KV) rows into ``n_split`` spans of ``span``
    positions (the last may be short), so that ``rows * n_split`` reaches
    ``BLOCKS_PER_SM * sms`` where the capacity allows.  A span is a
    multiple of ``lcm(MIN_SPAN, page_tokens)``: whole warp tiles of 32
    positions and, paged, whole pages."""
    if capacity < 1 or rows < 1 or sms < 1 or page_tokens < 1:
        raise ValueError(f"plan_splits({capacity}, {rows}, {sms}, "
                         f"{page_tokens}): need positive sizes")
    unit = math.lcm(MIN_SPAN, page_tokens)
    units = -(-capacity // unit)
    want = -(-BLOCKS_PER_SM * sms // rows)
    span_units = max(1, units // want)
    return -(-units // span_units), span_units * unit


def split_scratch(q: torch.Tensor, capacity: int, KV: int, dv: int,
                  page_tokens: int = 1):
    """(n_split, span, partials) for a decode launch: the plan and the
    (B, H, n_split, dv + 2) float32 scratch its blocks write."""
    B, H = q.shape[0], q.shape[1]
    n_split, span = plan_splits(capacity, B * KV,
                                _build.sm_count(q.device.index),
                                page_tokens)
    part = torch.empty((B, H, n_split, dv + 2), device=q.device,
                       dtype=torch.float32)
    return n_split, span, part


def row_stride(name: str, t: torch.Tensor) -> int:
    """The row stride ``ld`` (in elements) of a (..., d) K or V operand:
    the last dimension has stride 1 and every other dimension the stride
    of a contiguous tensor of width ``ld >= d`` -- a contiguous tensor
    (``ld == d``) or ``x[..., :d]`` of one (``ld`` = its width).  Size-1
    dimensions may have any stride.  Raises on any other layout."""
    *lead, d = t.shape
    if d > 1 and t.stride(-1) != 1:
        raise ValueError(f"{name}: the last dimension must have stride 1, "
                         f"got strides {t.stride()}")
    ld, inner = None, 1
    for size, stride in zip(reversed(lead), reversed(t.stride()[:-1])):
        if size > 1:
            if ld is None:
                ld = stride // inner if stride % inner == 0 else -1
            if stride != inner * ld:
                ld = -1
                break
        inner *= size
    ld = d if ld is None else ld
    if ld < d:
        raise ValueError(f"{name} {tuple(t.shape)} with strides "
                         f"{t.stride()}: not a contiguous tensor or a "
                         "[..., :d] slice of one")
    return ld


def check_decode_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      lengths: torch.Tensor, n_rows: int) -> Tuple[int, int]:
    """Validate what the decode kernels take (raise on anything else).
    ``k``/``v``: the dense cache (B, T, KV, d) or the pools (N, pt, KV,
    d), contiguous or a ``[..., :d]`` slice of a contiguous one;
    ``n_rows``: the batch size the lengths must cover.  -> the row
    strides (ldk, ldv)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the kernel takes float32, got "
                            f"{t.dtype}")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
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
    return row_stride("k", k), row_stride("v", v)


def count_launch(wrapper, k: torch.Tensor, v: torch.Tensor, ldk: int,
                 ldv: int) -> None:
    """One launch of ``wrapper``'s kernel; ``strided_launches`` counts
    those that read K or V through a row stride wider than the width."""
    wrapper.launches += 1
    if ldk != k.shape[-1] or ldv != v.shape[-1]:
        wrapper.strided_launches += 1


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lengths: torch.Tensor, *, scale: float,
                 return_lse: bool = False):
    """q: (B, H, dq);  k: (B, T, KV, dq);  v: (B, T, KV, dv);
    lengths: (B,) int32 with ``lengths[b] <= T``.  -> (B, H, dv), and
    with ``return_lse`` also the (B, H) float32 log-sum-exp of the
    scaled logits over each row's lengths (-inf where it is 0; the
    context is then 0).  The context is the same bits either way.

    H is laid out as KV groups of G = H / KV consecutive query heads.
    """
    ldk, ldv = check_decode_args(q, k, v, lengths, q.shape[0])
    B, H, dq = q.shape
    _, T, KV, _ = k.shape
    dv = v.shape[3]
    if k.shape[0] != B:
        raise ValueError(f"cache batch {k.shape[0]} != q batch {B}")
    n_split, span, part = split_scratch(q, T, KV, dv)
    out = torch.empty((B, H, dv), device=q.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if return_lse:
        lse = torch.empty((B, H), device=q.device, dtype=torch.float32)
        rc = _build.lib().clover_flash_decode_lse(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            part.data_ptr(), out.data_ptr(), lse.data_ptr(), B, T, H, KV,
            dq, dv, ldk, ldv, n_split, span, float(scale), stream)
    else:
        rc = _build.lib().clover_flash_decode(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            part.data_ptr(), out.data_ptr(), B, T, H, KV, dq, dv, ldk, ldv,
            n_split, span, float(scale), stream)
    _build.check(rc, "flash_decode")
    count_launch(flash_decode, k, v, ldk, ldv)
    if return_lse:
        flash_decode.lse_launches += 1
        return out, lse
    return out


flash_decode.launches = flash_decode.strided_launches = 0
flash_decode.lse_launches = 0


def check_rank_args(qk_ranks: torch.Tensor, vo_ranks: torch.Tensor,
                    k: torch.Tensor) -> None:
    """Validate the ranked kernels' rank vectors: contiguous (KV,) int32
    CUDA tensors, KV taken from the cache/pool ``k`` (raise otherwise).
    Checked before the other arguments, so a bad vector is named."""
    KV = k.shape[2] if k.dim() == 4 else None
    named = (("qk_ranks", qk_ranks), ("vo_ranks", vo_ranks))
    for name, r in named:
        if r.dtype != torch.int32:
            raise TypeError(f"{name}: the kernel takes int32, got "
                            f"{r.dtype}")
        if r.dim() != 1 or r.shape[0] != KV:
            raise ValueError(f"{name} {tuple(r.shape)}: need ({KV},), one "
                             "kept rank per KV head")
    for name, r in named:
        if not r.is_cuda or not r.is_contiguous():
            raise ValueError(f"{name} must be a contiguous CUDA tensor")


def flash_decode_ranked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        lengths: torch.Tensor, qk_ranks: torch.Tensor,
                        vo_ranks: torch.Tensor, *,
                        scale: float) -> torch.Tensor:
    """``flash_decode`` with per-KV-head kept ranks: qk_ranks, vo_ranks
    (KV,) int32 on q's device (values past the widths clamp to them).
    -> (B, H, dv), dims >= vo_ranks[kv] exactly 0."""
    check_rank_args(qk_ranks, vo_ranks, k)
    ldk, ldv = check_decode_args(q, k, v, lengths, q.shape[0])
    B, H, dq = q.shape
    _, T, KV, _ = k.shape
    dv = v.shape[3]
    if k.shape[0] != B:
        raise ValueError(f"cache batch {k.shape[0]} != q batch {B}")
    if qk_ranks.device != q.device or vo_ranks.device != q.device:
        raise ValueError("rank vectors must be on q's device")
    n_split, span, part = split_scratch(q, T, KV, dv)
    out = torch.empty((B, H, dv), device=q.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _build.lib().clover_flash_decode_ranked(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        qk_ranks.data_ptr(), vo_ranks.data_ptr(), part.data_ptr(),
        out.data_ptr(), B, T, H, KV, dq, dv, ldk, ldv, n_split, span,
        float(scale), stream)
    _build.check(rc, "flash_decode_ranked")
    count_launch(flash_decode_ranked, k, v, ldk, ldv)
    return out


flash_decode_ranked.launches = flash_decode_ranked.strided_launches = 0
