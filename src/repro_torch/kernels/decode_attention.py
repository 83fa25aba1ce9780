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

Dtypes: q in a compute dtype (``COMPUTE_DTYPES``), K and V in one
storage dtype (``page_copy.POOL_DTYPES``), read as they lie -- no copy
of the cache is made; the output comes in q's dtype.  The kernels
compute the TPU kernels' function in it (``ref.decode_attention_ref``):
in bfloat16 or float16 each p is rounded against the running max of the
TPU's blocks of positions (``softmax_blocks``), which a first pass of
the kernels finds.  Any other dtype pair raises ``TypeError``.

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
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.page_copy import POOL_DTYPES
from repro_torch.kernels.ref import decode_block

MAX_WIDTH = 256     # dq, dv the kernel's shared-memory plan accepts
MAX_GROUP = 16      # query heads per KV head
MIN_SPAN = 32       # positions a split spans at least (one warp tile)
BLOCKS_PER_SM = 4   # the planner's target: B * KV * n_split >= 4 * SMs
COMPUTE_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
# the kernels' dtype codes (csrc/decode_attention.cu: Dtype)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
               torch.float8_e4m3fn: 3, torch.float8_e5m2: 4}


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


def softmax_blocks(capacity: int,
                   page_tokens: Optional[int] = None) -> Tuple[int, int]:
    """-> (block, unit): the positions of one TPU online-softmax block --
    ``ref.decode_block(capacity)`` for a dense cache, one page for a
    paged one -- and of one unit of the kernels' first pass (its max
    logits): 32 dense (a tile), ``gcd(32, page_tokens)`` paged, so no
    unit straddles a tile or a block."""
    if page_tokens is None:
        return decode_block(capacity), MIN_SPAN
    return page_tokens, math.gcd(MIN_SPAN, page_tokens)


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


def check_dtypes(q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor) -> None:
    """The pairs the kernels take: q in a ``COMPUTE_DTYPES`` dtype, K and
    V in one ``POOL_DTYPES`` dtype (raise ``TypeError`` on any other;
    nothing is cast)."""
    if (q.dtype not in COMPUTE_DTYPES or k.dtype != v.dtype
            or k.dtype not in POOL_DTYPES):
        raise TypeError(
            f"q {q.dtype}, k {k.dtype}, v {v.dtype}: the kernels take q in "
            f"{', '.join(map(str, COMPUTE_DTYPES))} and K and V in one of "
            f"{', '.join(map(str, POOL_DTYPES))}")


def check_decode_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      lengths: torch.Tensor, n_rows: int) -> Tuple[int, int]:
    """Validate what the decode kernels take (raise on anything else).
    ``k``/``v``: the dense cache (B, T, KV, d) or the pools (N, pt, KV,
    d), contiguous or a ``[..., :d]`` slice of a contiguous one;
    ``n_rows``: the batch size the lengths must cover.  -> the row
    strides (ldk, ldv)."""
    check_dtypes(q, k, v)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor")
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


def launch(wrapper, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           lengths: torch.Tensor, ldk: int, ldv: int, *, scale: float,
           table: Optional[torch.Tensor] = None, ranks=(None, None),
           lse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One launch of the kernels (checked arguments): the dense cache k
    / v (B, T, KV, d), or the pools (N, pt, KV, d) with ``table`` (B,
    n_p); ``ranks`` (qk, vo) int32 vectors or Nones; ``lse`` a (B, H)
    float32 output or None.  Counts the launch on ``wrapper``.  -> the
    (B, H, dv) context in q's dtype."""
    B, H, dq = q.shape
    KV, dv = k.shape[2], v.shape[3]
    pt = k.shape[1]                # positions a page (dense: a row)
    n_p = 1 if table is None else table.shape[1]
    paged = None if table is None else pt
    block, unit = softmax_blocks(n_p * pt, paged)
    n_split, span = plan_splits(n_p * pt, B * KV,
                                _build.sm_count(q.device.index), paged or 1)
    part = torch.empty((B, H, n_split, dv + 2), device=q.device,
                       dtype=torch.float32)   # the splits' (m, l, acc)
    umax = None
    if q.dtype != torch.float32:   # the first pass's max logit per unit
        umax = torch.empty((B, H, -(-n_p * pt // unit)), device=q.device,
                           dtype=torch.float32)
    out = torch.empty((B, H, dv), device=q.device, dtype=q.dtype)

    def ptr(t):
        return None if t is None else t.data_ptr()
    rc = _build.lib().clover_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(table),
        lengths.data_ptr(), ptr(ranks[0]), ptr(ranks[1]), part.data_ptr(),
        ptr(umax), out.data_ptr(), ptr(lse), B, n_p, pt, H, KV, dq, dv, ldk,
        ldv, n_split, span, block, unit, DTYPE_CODES[q.dtype],
        DTYPE_CODES[k.dtype], float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, wrapper.__name__)
    wrapper.launches += 1
    if ldk != k.shape[-1] or ldv != v.shape[-1]:
        wrapper.strided_launches += 1
    return out


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lengths: torch.Tensor, *, scale: float,
                 return_lse: bool = False):
    """q: (B, H, dq);  k: (B, T, KV, dq);  v: (B, T, KV, dv);
    lengths: (B,) int32 with ``lengths[b] <= T``.  -> (B, H, dv) in q's
    dtype, and with ``return_lse`` also the (B, H) float32 log-sum-exp
    of the scaled logits over each row's lengths (-inf where it is 0;
    the context is then 0).  The context is the same bits either way.

    H is laid out as KV groups of G = H / KV consecutive query heads.
    """
    ldk, ldv = check_decode_args(q, k, v, lengths, q.shape[0])
    if k.shape[0] != q.shape[0]:
        raise ValueError(f"cache batch {k.shape[0]} != q batch {q.shape[0]}")
    lse = (torch.empty(q.shape[:2], device=q.device, dtype=torch.float32)
           if return_lse else None)
    out = launch(flash_decode, q, k, v, lengths, ldk, ldv, scale=scale,
                 lse=lse)
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
    check_dtypes(q, k, v)
    check_rank_args(qk_ranks, vo_ranks, k)
    ldk, ldv = check_decode_args(q, k, v, lengths, q.shape[0])
    if k.shape[0] != q.shape[0]:
        raise ValueError(f"cache batch {k.shape[0]} != q batch {q.shape[0]}")
    if qk_ranks.device != q.device or vo_ranks.device != q.device:
        raise ValueError("rank vectors must be on q's device")
    return launch(flash_decode_ranked, q, k, v, lengths, ldk, ldv,
                  scale=scale, ranks=(qk_ranks, vo_ranks))


flash_decode_ranked.launches = flash_decode_ranked.strided_launches = 0
