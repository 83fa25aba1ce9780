"""Core layers of the port: norms, GQA attention (optionally
CLOVER-factored, optionally under a per-head rank plan), dense MLPs —
own port of ``repro/models/layers.py`` (DESIGN.md §2, §4, §6, §14).

Attention weight layout (CLOVER-ready, as in the reference):
    wq : (D, H,  dq)     dq = head_dim, or the CLOVER-pruned Q-K rank
    wk : (D, KV, dq)
    wv : (D, KV, dv)     dv = head_dim, or the CLOVER-pruned V-O rank
    wo : (H, dv, D)

The attention carries CLOVER-S's transitions (``s_qk`` on q, ``k_t``
on k -- the intra-layer RoPE fallback, applied before RoPE -- and
``s_vo`` on the context, on every path), rotary embeddings on the first
``min(rope_dims, dq)`` dims of q and k (half-split convention; partial
RoPE passes the un-rotated tail through), applied after the projections
and transitions and before any cache write, so cached K is post-RoPE;
and the decomposed MLP.Up (``up_u`` / ``up_t``).  The attention logit
softcap runs on the plain attention; musicgen's sinusoidal positions
are ``sinusoidal_positions``.  ``draft_rank`` runs the self-speculative
draft at sliced ranks over the shared cache (DESIGN.md §8); per-slot SV
``adapter`` scales multiply the outputs of the ``s_qk`` / ``s_vo``
transitions (DESIGN.md §13).  ``plain=True`` (the training forward)
runs the plain attention under autograd.  Under tensor parallelism
(DESIGN.md §10) ``shard`` is this rank's ``launch.mesh.Mesh`` and the
weights are its slices: head and KV-head counts are read off the
weights, and the attention output and the MLP output are summed over
the mesh's "model" axis only when their heads or ff axis was split (a
replicated leaf computes the whole sum on every rank and is never
reduced); under autograd each split region's input passes through
``copy_to_model``, whose backward sums the rank's partial input
gradient over "model" (a no-op without a graph).  KV caches are updated IN
PLACE (the reference is functional; with buffer donation it updates in
place too) and the updated cache is also returned.

The kernels take q in the compute dtype and the cache as it lies (the
decode kernels), q / K / V in the compute dtype (the flash kernel's
scoring pass), or, over a cache window at a 16-bit compute dtype, q in
it and the window's K / V views as they lie (the window kernel, the
reference's XLA attention there; ``_causal_window``).  A causal pass
longer than ``ATTN_CHUNK`` without a kernel (training's plain
attention, a softcapped config) runs
``_causal_attention_chunked``, query block by query block, so no (S, T)
logits or mask exist; a whole-batch cached prefill that long runs a
kernel over the cache's live window (the window kernel at 16 bits, the
flash kernel at float32).  Serving under training's
sharding rules (``train.step.make_serve_step``) splits the dense cache
along its SEQUENCE over "model" (``SeqSplit``): every rank computes
every head's q / K / V, the rank owning a position writes it, each rank
attends over its window and the windows' partials are combined over
"model" (``parallel.sharding.combine_seq_partials``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops
from repro_torch.parallel.sharding import (all_gather_dim, axis_group,
                                           combine_seq_partials,
                                           copy_to_model, reduce_model)

Params = Dict[str, Any]

# query block of the chunked causal attention: its peak logits slab is
# (B, H, ATTN_CHUNK, T) instead of (B, H, S, T) (the reference's)
ATTN_CHUNK = 512


# ---------------------------------------------------------------------------
# initializers / norms
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape, in_axis_size: int, *,
               dtype=torch.float32, device=None) -> torch.Tensor:
    """N(0, 1) / sqrt(fan_in), the reference's ``dense_init``."""
    scale = 1.0 / math.sqrt(max(1, in_axis_size))
    x = torch.randn(shape, generator=gen, device=device,
                    dtype=torch.float32)
    return (x * scale).to(dtype)


def init_norm(cfg, *, dtype=torch.float32, device=None) -> Params:
    p = {"scale": torch.ones((cfg.d_model,), dtype=dtype, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((cfg.d_model,), dtype=dtype, device=device)
    return p


def apply_norm(p: Params, cfg, x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "layernorm":
        y = F.layer_norm(xf, (xf.shape[-1],), p["scale"].float(),
                         p["bias"].float(), cfg.norm_eps)
    else:  # rmsnorm
        ms = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + cfg.norm_eps) * p["scale"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings (partial-RoPE aware)
# ---------------------------------------------------------------------------

def rope_tables(positions: torch.Tensor, rot_dims: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (..., S) int -> cos, sin of shape (..., S, rot_dims//2),
    float32, in the reference's operation order."""
    half = rot_dims // 2
    dev = positions.device
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=dev) / half)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


class Rope:
    """One step's RoPE tables, made once per rotated width and shared by
    every layer of the step (``transformer`` builds one per call)."""

    def __init__(self, positions: torch.Tensor, theta: float):
        self.positions, self.theta = positions, theta
        self._tables = {}

    def tables(self, rot_dims: int) -> Tuple[torch.Tensor, torch.Tensor]:
        if rot_dims not in self._tables:
            self._tables[rot_dims] = rope_tables(self.positions, rot_dims,
                                                 self.theta)
        return self._tables[rot_dims]


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               rot_dims: int) -> torch.Tensor:
    """x (B, S, N, dq): rotates the first ``rot_dims`` dims (half-split
    convention) and passes the rest through (partial RoPE)."""
    if rot_dims == 0:
        return x
    half = rot_dims // 2
    x1, x2 = x[..., :half], x[..., half:rot_dims]
    c = cos[:, :, None, :].to(x.dtype)
    s = sin[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s, x[..., rot_dims:]],
                     dim=-1)


def sinusoidal_positions(positions: torch.Tensor, d_model: int
                         ) -> torch.Tensor:
    """positions (..., S) int -> (..., S, d_model) float32: the sines of
    ``positions * 10000^(-i / half)`` then their cosines (musicgen's
    absolute positions, added to the embeddings).  The frequencies are
    computed in float64 and rounded once: torch's float32 ``pow`` is off
    by an ulp at some exponents where the reference's is not, and at
    position 3000 one ulp of a frequency is 2.4e-4 of angle."""
    half = d_model // 2
    exps = -torch.arange(0, half, dtype=torch.float32,
                         device=positions.device) / half
    freqs = (10000.0 ** exps.double()).float()
    ang = positions.float()[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def init_attention(gen: torch.Generator, cfg, *, dtype=torch.float32,
                   device=None) -> Params:
    D, H, KV = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    dq, dv = cfg.qk_dim, cfg.vo_dim
    kw = dict(dtype=dtype, device=device)
    return {
        "wq": dense_init(gen, (D, H, dq), D, **kw),
        "wk": dense_init(gen, (D, KV, dq), D, **kw),
        "wv": dense_init(gen, (D, KV, dv), D, **kw),
        "wo": dense_init(gen, (H, dv, D), H * dv, **kw),
    }


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, S, D) @ (D, N, r) -> (B, S, N, r)."""
    D, N, r = w.shape
    return (x @ w.reshape(D, N * r)).reshape(*x.shape[:-1], N, r)


def _pad_rank(t: torch.Tensor, width: int) -> torch.Tensor:
    """Zero-pad the last (rank) dim up to ``width`` (no-op if already
    there): the draft's sliced-rank K/V land in the full-width cache."""
    d = t.shape[-1]
    return t if d == width else F.pad(t, (0, width - d))


def _masked_attention(q, k, v, mask, scale, G, softcap=0.0):
    """Chunked-prefill read path (S > 1 against a cache), and every path
    of a softcapped config: masked softmax over the positions ``mask``
    allows, with the logits capped to ``tanh(logits / c) * c`` where
    ``softcap`` c > 0 -- computed outside any Pallas kernel in the
    reference, so it stays plain tensor code here.
    q (B,S,H,dq), k (B,T,KV,dq), v (B,T,KV,dv), mask (B,S,T)."""
    B, S, H, dq = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, S, KV, G, dq)
    logits = torch.einsum("bskgq,btkq->bkgst", qg, k) * scale
    if softcap > 0:
        logits = torch.tanh(logits / softcap) * softcap
    logits = logits.float()
    neg = torch.finfo(torch.float32).min
    logits = logits.masked_fill(~mask[:, None, None, :, :], neg)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    ctx = torch.einsum("bkgst,btkv->bskgv", probs, v)
    return ctx.reshape(B, S, H, v.shape[-1])


def _attn_block(qb, k, v, kpos, q0, scale, softcap):
    """One query block of ``_causal_attention_chunked``: queries at
    positions ``q0 + [0, bq)`` against every key, causal."""
    B, bq, H, dq = qb.shape
    KV = k.shape[2]
    qg = qb.reshape(B, bq, KV, H // KV, dq)
    logits = torch.einsum("bskgq,btkq->bkgst", qg, k).float() * scale
    if softcap > 0:
        logits = torch.tanh(logits / softcap) * softcap
    qpos = q0 + torch.arange(bq, device=qb.device)
    mask = qpos[:, None] >= kpos[None, :]                     # (bq, T)
    logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
    p = torch.softmax(logits, dim=-1).to(v.dtype)
    ob = torch.einsum("bkgst,btkv->bskgv", p, v)
    return ob.reshape(B, bq, H, v.shape[-1])


def _causal_attention_chunked(q, k, v, scale, *, softcap: float = 0.0,
                              q_offset=0):
    """Memory-bounded causal attention (the reference's
    ``_causal_attention_chunked``): a loop over query blocks of
    ``ATTN_CHUNK``, each a (B, H, ATTN_CHUNK, T) logits slab; under
    autograd each block goes through ``torch.utils.checkpoint``, as the
    reference remats each block, so the backward keeps no slab.
    q (B,S,H,dq), k (B,T,KV,dq), v (B,T,KV,dv) -> (B,S,H,dv); query i
    sits at position ``q_offset + i`` (an int or a 0-d tensor), key t at
    t.  ``calls`` counts its calls (the training phase of the smoke
    reads it)."""
    _causal_attention_chunked.calls += 1
    S, T = q.shape[1], k.shape[1]
    kpos = torch.arange(T, device=q.device)
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    outs = []
    for lo in range(0, S, ATTN_CHUNK):
        qb = q[:, lo:lo + ATTN_CHUNK]
        if grad:
            outs.append(checkpoint(_attn_block, qb, k, v, kpos,
                                   q_offset + lo, scale, softcap,
                                   use_reentrant=False))
        else:
            outs.append(_attn_block(qb, k, v, kpos, q_offset + lo, scale,
                                    softcap))
    return torch.cat(outs, dim=1)


_causal_attention_chunked.calls = 0


def _causal_window(q, k, v, scale, softcap, G, dtype, window=False):
    """Causal attention of the S queries ending the window k / v (B, T,
    ...) covers -- query i at position T - S + i -- in ``dtype``, K and V
    cast to it first (the reference's ``astype(x.dtype)`` of a cache; no
    copy where the cache is in ``dtype``).  Without a softcap: for a
    scoring pass the flash kernel on q / K / V in ``dtype`` (the
    reference's Pallas site; the TPU kernel's 16-bit function in a 16-bit
    dtype).  Over a cache ``window`` (a long cached prefill, a
    sequence-split cache), where the reference runs XLA attention, a
    16-bit dtype takes the window kernel on q / K / V in it (the
    reference's function: logits and normalised p rounded to the dtype;
    scaled before the float32 cast within ``ATTN_CHUNK`` queries, its
    masked path, after it beyond, its chunked path), float32 the flash
    kernel.  With a softcap the chunked plain attention beyond
    ``ATTN_CHUNK`` queries, the masked one within."""
    S, T = q.shape[1], k.shape[1]
    k, v = k.to(dtype), v.to(dtype)
    if softcap == 0:
        if window and dtype in (torch.bfloat16, torch.float16):
            return ops.window_attention(q.contiguous(), k, v, scale=scale,
                                        scale_first=S <= ATTN_CHUNK)
        return ops.clover_attention(q.contiguous(), k.contiguous(),
                                    v.contiguous(), scale=scale)
    if S > ATTN_CHUNK:
        return _causal_attention_chunked(q, k, v, scale, softcap=softcap,
                                         q_offset=T - S)
    qpos = (T - S + torch.arange(S, device=q.device))[None].expand(
        q.shape[0], S)
    mask = torch.arange(T, device=q.device)[None, None, :] <= qpos[..., None]
    return _masked_attention(q, k, v, mask, scale, G, softcap)


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A float8 cache as its bytes (torch indexes no float8 on the CPU);
    any other tensor as is."""
    if t.is_floating_point() and t.element_size() == 1:
        return t.view(torch.uint8)
    return t


def _write_positions(cache, at, src, mine=None) -> None:
    """``cache[:, at] = src`` in place (``at`` (n,) int64 positions);
    with ``mine`` (a bool tensor) only where it is True, the old
    contents elsewhere."""
    c, src = _bits(cache), _bits(src.to(cache.dtype))
    if mine is not None:
        src = torch.where(mine, src, c.index_select(1, at))
    c.index_copy_(1, at, src)


def _window_end(cache_index: torch.Tensor, S: int, capacity: int) -> int:
    """One past the last position a whole-batch prefill of S tokens at
    ``cache_index`` writes (one host read; on meta, where nothing can be
    read, the cache's capacity: the dry-run's prefills fill it)."""
    if cache_index.device.type == "meta":
        return capacity
    return int(cache_index) + S


@dataclass(frozen=True)
class SeqSplit:
    """A dense cache split along its sequence over "model": this rank
    holds positions ``[lo, lo + size)``.  ``start``: the host position
    of a prefill's first token (every rank reads the same replicated
    index); None for a one-token decode step."""
    lo: int
    size: int
    start: Optional[int] = None


def _seq_split_attention(q, k, v, cache, index, seq: SeqSplit, scale,
                         softcap, shard, h_split, kv_split, dtype):
    """Attention on a sequence-split dense cache -> the context of every
    head (B, S, H, dv).  q / k / v hold this rank's heads; split ones
    are gathered over "model" first, so every rank issues the same
    collectives in the same order, an empty window included."""
    group, m = axis_group(shard, "model")
    if h_split:
        q = all_gather_dim(q, 2, group, m)
    if kv_split:
        k, v = all_gather_dim(k, 2, group, m), all_gather_dim(v, 2, group, m)
    ck, cv = cache["k"], cache["v"]
    B, S, H, dq = q.shape
    dv = v.shape[-1]
    kw = _pad_rank(k, ck.shape[-1]).to(ck.dtype)
    vw = _pad_rank(v, cv.shape[-1]).to(cv.dtype)
    if seq.start is None:                 # decode: the owner writes index
        if S != 1 or softcap > 0:
            raise ValueError("a sequence-split cache decodes one token per "
                             "step through flash_decode, which caps no "
                             "logits")
        at = index.long().reshape(1) - seq.lo
        mine = (at >= 0) & (at < seq.size)
        at = at.clamp(0, seq.size - 1)
        _write_positions(ck, at, kw, mine)
        _write_positions(cv, at, vw, mine)
        lengths = (index.long() + 1 - seq.lo).clamp(0, seq.size).to(
            torch.int32).reshape(1).expand(B).contiguous()
        out, lse = ops.decode_attention(
            q[:, 0].contiguous(), ck[..., :dq], cv[..., :dv], lengths,
            scale=scale, return_lse=True)
        return combine_seq_partials(out, lse, shard)[:, None].to(dtype)
    # prefill: each rank writes the positions of its window
    a, b = max(seq.start, seq.lo), min(seq.start + S, seq.lo + seq.size)
    if a < b:
        ck[:, a - seq.lo:b - seq.lo] = kw[:, a - seq.start:b - seq.start]
        cv[:, a - seq.lo:b - seq.lo] = vw[:, a - seq.start:b - seq.start]
    end = seq.start + S
    if seq.start:                         # earlier positions: every window
        k = all_gather_dim(ck, 1, group, m)[:, :end, :, :dq]
        v = all_gather_dim(cv, 1, group, m)[:, :end, :, :dv]
    return _causal_window(q, k, v, scale, softcap, H // k.shape[2], dtype,
                          window=True)


def attention(params: Params, cfg, x: torch.Tensor, *,
              positions: torch.Tensor,
              rope: Optional[Rope] = None,
              kv_cache: Optional[Params] = None,
              cache_index: Optional[torch.Tensor] = None,
              page_table: Optional[torch.Tensor] = None,
              write_floor: Optional[torch.Tensor] = None,
              draft_rank: Optional[Tuple[int, int]] = None,
              adapter: Optional[Params] = None,
              plain: bool = False,
              shard=None,
              seq: Optional[SeqSplit] = None,
              ) -> Tuple[torch.Tensor, Optional[Params]]:
    """GQA attention (``repro/models/layers.py:212-460``).

    Full sequence: ``kv_cache is None`` -> causal flash attention, or
    with ``plain`` (training) the plain attention, differentiable.
    Dense cache: ``kv_cache`` holds {"k": (B, Smax, KV, dq), "v": (B,
    Smax, KV, dv)}; ``cache_index`` is a scalar (whole batch at one
    position) or a (B,) per-slot vector, and the S-token window is
    written at [index, index + S).  Callers keep that window inside the
    cache (``transformer`` checks it once per step; the reference's
    ``dynamic_update_slice`` would clamp instead).
    Paged cache: ``page_table`` (B, n_p) is given and ``kv_cache`` holds
    the global pools {"k": (N, pt, KV, dq), "v": (N, pt, KV, dv)}; over
    "data" replicas of ``shard`` the pools are whole on each, so every
    replica's new rows are all-gathered and written on every replica.
    Positions past the table and, with ``write_floor``, writes below
    each slot's floor go to the garbage row ``N - 1``.  Every table
    entry must be a valid pool row.
    S == 1 with a cache runs the flash-decoding kernels; S > 1 with a
    cache runs the masked chunked-prefill path, except a whole-batch
    prefill of S > ``ATTN_CHUNK`` tokens, which runs the window kernel
    (the flash kernel at float32 compute) over the live window ``[0,
    index + S)``.  A config with the
    attention logit softcap (``attn_logit_softcap`` c > 0) runs the
    masked path (chunked beyond ``ATTN_CHUNK`` queries) on every path,
    logits capped to ``tanh(logits / c) * c``: no kernel caps its logits
    (the reference bypasses its kernels too).  ``plain`` (training) runs
    the plain attention, chunked beyond ``ATTN_CHUNK``.  ``seq``: the
    dense cache is split along its sequence over "model" (see
    ``SeqSplit``; a scalar ``cache_index``).
    ``positions`` (B, S) (or (1, S)) are the absolute positions RoPE
    rotates by; ``rope``, the step's shared tables for them (made here
    when not given).

    Self-speculative draft (DESIGN.md §8): ``draft_rank = (r_q, r_v)``
    runs the SAME weights with every head sliced to its leading ``r_q``
    / ``r_v`` directions (CLOVER's factors are sorted, so ``x @ wq[...,
    :r]`` is the leading dims of the full projection), RoPE on the first
    ``min(rope_dims, r_q)`` dims, and reads the shared cache as the
    views ``cache[..., :r]``, which the decode kernels take through the
    cache's row stride: no copy of the cache is made.  Its K/V writes
    are zero-padded to the cache width.  The writes land in the live
    cache (the reference's draft writes a state it then discards): the
    verify pass rewrites all its positions at full rank before the full
    model reads them.  Weights may come pre-sliced (a slice of a slice
    at its own width is the same tensor).

    Multi-tenant SV adapters (DESIGN.md §13): ``adapter`` holds per-slot
    rank-space scales {"a_qk": (B, H, dq_c), "a_vo": (B, H, dv_c)} at the
    cache widths (the draft uses their leading ``:dq`` / ``:dv``, as it
    slices the weights).  They multiply the outputs of the ``s_qk`` (q,
    before RoPE) and ``s_vo`` (the context, before ``wo``) transitions
    on every path; the all-ones identity leaves every path bit for bit
    unchanged (``x * 1.0 == x``).

    Tensor parallelism (DESIGN.md §10): with ``shard`` the weights,
    caches and adapter scales hold this rank's heads (H and KV are read
    off ``wq`` / ``wk``) and the output projection's partial sum is
    reduced over "model" when the heads were split.  Under autograd the
    split heads' input passes through ``copy_to_model``; with query
    heads split over replicated KV heads (one KV head, MQA) the K and V
    activations do instead, so the replicated ``wk`` / ``wv`` get their
    whole gradients.
    """
    B, S, D = x.shape
    H, KV = params["wq"].shape[-2], params["wk"].shape[-2]
    G = H // KV
    h_split = shard is not None and H != cfg.n_heads
    kv_split = shard is not None and KV != cfg.n_kv_heads
    # query heads split over replicated KV heads (granite's 16 over 8 at
    # model 16): without a cache, this rank's heads read the KV heads
    # [kv0, kv0 + n) of its query heads; a sequence-split cache gathers
    # every head instead
    kv_sel = None
    if h_split and not kv_split and KV > 1 and seq is None:
        Gf = cfg.q_per_kv
        if kv_cache is not None or (H % Gf and Gf % H):
            raise ValueError(
                f"{cfg.name}: {cfg.n_heads} query heads split over 'model' "
                f"but not their {KV} KV heads: each rank's heads would read "
                "the wrong KV heads")
        kv_sel = (shard.coords["model"] * H // Gf, max(1, H // Gf))
        G = H // kv_sel[1]
    xq = copy_to_model(x, shard) if h_split else x
    xkv = xq if kv_split else x
    dq_c, dv_c = cfg.qk_dim, cfg.vo_dim     # cache (full-model) widths
    dq, dv = draft_rank if draft_rank is not None else (dq_c, dv_c)
    if not (0 < dq <= dq_c and 0 < dv <= dv_c):
        raise ValueError(f"draft_rank {draft_rank} outside the cache "
                         f"widths ({dq_c}, {dv_c})")
    # CLOVER-pruned heads approximate the ORIGINAL product Q K^T, so the
    # softmax scale stays 1/sqrt(original head_dim) regardless of rank.
    scale = 1.0 / math.sqrt(cfg.head_dim_)

    q = _proj(xq, params["wq"][..., :dq].to(x.dtype))
    k = _proj(xkv, params["wk"][..., :dq].to(x.dtype))
    v = _proj(xkv, params["wv"][..., :dv].to(x.dtype))
    if "k_t" in params:    # intra-layer K transition (RoPE-safe CLOVER-S)
        k = torch.einsum("bskq,kqr->bskr", k,
                         params["k_t"][..., :dq, :dq].to(k.dtype))
    if "s_qk" in params:   # CLOVER-S: the Q-K transition, on every path
        q = torch.einsum("bshq,hqr->bshr", q,
                         params["s_qk"][..., :dq, :dq].to(q.dtype))
    if adapter is not None and "a_qk" in adapter:
        # per-slot singular-value scales of the Q-K transition's output
        q = q * adapter["a_qk"][:, None, :, :dq].to(q.dtype)
    # partial-RoPE pruning keeps the rotated block intact at the front,
    # so RoPE always rotates the first min(rope_dims, dq) dims
    rot = min(cfg.rope_dims, dq)
    if rot:
        cos, sin = (rope or Rope(positions, cfg.rope_theta)).tables(rot)
        q = apply_rope(q, cos, sin, rot)
        k = apply_rope(k, cos, sin, rot)
    if h_split and not kv_split:        # replicated KV heads under split q
        k, v = copy_to_model(k, shard), copy_to_model(v, shard)
    if kv_sel is not None:
        k = k[:, :, kv_sel[0]:kv_sel[0] + kv_sel[1]]
        v = v[:, :, kv_sel[0]:kv_sel[0] + kv_sel[1]]

    # Non-uniform RankBudget plans (DESIGN.md §14): apply_rank_budget
    # leaves (n_blocks, KV) int32 kept-rank tables in the stacked attn
    # params and the layer loop hands this layer's (KV,) rows here.  The
    # weights are already zero-padded past each head's rank, so the
    # full-sequence and chunked paths need nothing; the vectors feed the
    # decode kernels' per-head rank clamp (they stay on the device).
    # The draft clamps them to its sliced widths.
    ranks = {"qk_ranks": params.get("rank_qk"),
             "vo_ranks": params.get("rank_vo")}
    if draft_rank is not None:
        ranks = {"qk_ranks": _clamp(ranks["qk_ranks"], dq),
                 "vo_ranks": _clamp(ranks["vo_ranks"], dv)}

    def vo_out(ctx):                              # (B, S, H, dv) -> (B, S, D)
        if "s_vo" in params:  # CLOVER-S: the V-O transition
            ctx = torch.einsum("bshv,hvw->bshw", ctx,
                               params["s_vo"][..., :dv, :dv].to(ctx.dtype))
        if adapter is not None and "a_vo" in adapter:
            ctx = ctx * adapter["a_vo"][:, None, :, :dv].to(ctx.dtype)
        wo = params["wo"][..., :dv, :].to(x.dtype)
        out = ctx.reshape(B, S, H * dv) @ wo.reshape(H * dv, D)
        if h_split:                                  # heads were split
            out = reduce_model(out, shard)
        return out

    # softcapped logits have no kernel: every path of a capped config
    # takes the masked plain attention below, as the reference's einsum
    # path does
    softcap = cfg.attn_logit_softcap
    kernel = softcap == 0
    if seq is not None:
        if ranks["qk_ranks"] is not None or ranks["vo_ranks"] is not None \
                or adapter is not None or draft_rank is not None:
            raise ValueError("a sequence-split cache serves the plain "
                             "model: no rank plan, adapter or draft")
        ctx = _seq_split_attention(q, k, v, kv_cache, cache_index, seq,
                                   scale, softcap, shard, h_split, kv_split,
                                   x.dtype)
        if h_split:                           # this rank's heads for wo
            ctx = ctx[:, :, shard.coords["model"] * H:][:, :, :H]
        return vo_out(ctx), kv_cache
    if kv_cache is None:
        if kernel and not plain:
            return vo_out(_causal_window(q, k, v, scale, 0.0, G,
                                         x.dtype)), None
        if S > ATTN_CHUNK:
            return vo_out(_causal_attention_chunked(
                q, k, v, scale, softcap=softcap)), None
        if kernel:                            # training, S <= ATTN_CHUNK
            ctx = ops.clover_attention(q.contiguous(), k.contiguous(),
                                       v.contiguous(), scale=scale,
                                       plain=True)
            return vo_out(ctx), None
        qpos = torch.arange(S, device=x.device)[None].expand(B, S)
        mask = qpos[:, None, :] <= qpos[:, :, None]              # (B, S, S)
        return vo_out(_masked_attention(q, k, v, mask, scale, G,
                                        softcap)), None

    ck, cv = kv_cache["k"], kv_cache["v"]
    ar = torch.arange(S, device=x.device)
    if page_table is not None:
        N, PT = ck.shape[0], ck.shape[1]
        P = page_table.shape[1]
        pos = cache_index.long()[:, None] + ar[None, :]          # (B, S)
        pslot = pos // PT
        page = page_table.long().gather(1, pslot.clamp(0, P - 1))
        # positions past the table (an idle slot whose index ran beyond
        # its pages) route to the garbage row explicitly
        page = torch.where(pslot >= P, N - 1, page)
        if write_floor is not None:
            # read-only prefix: any sub-floor write goes to the garbage row
            page = torch.where(pos >= write_floor.long()[:, None], page,
                               N - 1)
        dest = (page * PT + pos % PT).reshape(-1)                # (B*S,)
        kw = _pad_rank(k, dq_c).reshape(B * S, KV, dq_c).to(ck.dtype)
        vw = _pad_rank(v, dv_c).reshape(B * S, KV, dv_c).to(cv.dtype)
        group, nd = axis_group(shard, "data")
        if nd > 1:       # the pools are whole on every data replica
            dest, kw, vw = (all_gather_dim(t, 0, group, nd)
                            for t in (dest, kw, vw))
        ck.view(N * PT, KV, dq_c)[dest] = kw
        cv.view(N * PT, KV, dv_c)[dest] = vw
        new_cache = {"k": ck, "v": cv}
        if S == 1 and kernel:  # paged flash-decoding: the serving hot path
            # the pool's [..., :r] slice reaches the kernel as it lies, a
            # strided view in its own dtype: the kernel converts each
            # element to the compute dtype (the reference's astype), so no
            # copy of the pool is made; the context comes in x's dtype
            lengths = cache_index + 1
            ctx = ops.paged_decode_attention(
                q[:, 0].contiguous(), ck[..., :dq], cv[..., :dv],
                page_table, lengths, scale=scale, **ranks)
            return vo_out(ctx[:, None]), new_cache
        # chunked prefill: gather each slot's pages into a dense view
        tab = page_table.long()
        k = ck[tab].reshape(B, P * PT, KV, dq_c)[..., :dq].to(x.dtype)
        v = cv[tab].reshape(B, P * PT, KV, dv_c)[..., :dv].to(x.dtype)
        qpos = pos
    else:
        if cache_index.dim() == 1:     # per-slot positions
            pos = cache_index.long()[:, None] + ar[None, :]      # (B, S)
            rows = torch.arange(B, device=x.device)[:, None]
            ck[rows, pos] = _pad_rank(k, dq_c).to(ck.dtype)
            cv[rows, pos] = _pad_rank(v, dv_c).to(cv.dtype)
            qpos = pos
        else:                          # whole batch at one position
            pos = cache_index.long().reshape(1) + ar             # (S,)
            _write_positions(ck, pos, _pad_rank(k, dq_c))
            _write_positions(cv, pos, _pad_rank(v, dv_c))
            qpos = pos[None, :].expand(B, S)
            if S > ATTN_CHUNK:         # long prefill: over the live window
                end = _window_end(cache_index, S, ck.shape[1])
                ctx = _causal_window(q, ck[:, :end, :, :dq],
                                     cv[:, :end, :, :dv], scale, softcap,
                                     G, x.dtype, window=True)
                return vo_out(ctx), {"k": ck, "v": cv}
        new_cache = {"k": ck, "v": cv}
        if S == 1 and kernel:  # flash-decoding against the cache
            lengths = (qpos[:, 0] + 1).to(torch.int32)
            ctx = ops.decode_attention(q[:, 0].contiguous(), ck[..., :dq],
                                       cv[..., :dv], lengths, scale=scale,
                                       **ranks)
            return vo_out(ctx[:, None]), new_cache
        k, v = ck[..., :dq].to(x.dtype), cv[..., :dv].to(x.dtype)
    T = k.shape[1]
    kv_pos = torch.arange(T, device=x.device)
    # query j of slot b sits at position qpos[b, j]; causal against
    # every cached position
    mask = kv_pos[None, None, :] <= qpos[:, :, None]             # (B, S, T)
    ctx = _masked_attention(q, k, v, mask, scale, G, softcap)
    return vo_out(ctx), new_cache


def _clamp(ranks: Optional[torch.Tensor], width: int):
    return None if ranks is None else ranks.clamp(max=width)


# ---------------------------------------------------------------------------
# dense MLP
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, cfg, *, dtype=torch.float32,
             device=None) -> Params:
    D, Fd = cfg.d_model, cfg.d_ff
    kw = dict(dtype=dtype, device=device)
    if cfg.mlp_act in ("swiglu", "geglu"):
        return {"w_gate": dense_init(gen, (D, Fd), D, **kw),
                "w_up": dense_init(gen, (D, Fd), D, **kw),
                "w_down": dense_init(gen, (Fd, D), Fd, **kw)}
    return {"w_up": dense_init(gen, (D, Fd), D, **kw),
            "w_down": dense_init(gen, (Fd, D), Fd, **kw)}


def clover_up(params: Params, x: torch.Tensor) -> torch.Tensor:
    """CLOVER's blockwise-decomposed Up: ``x @ up_u`` per block, then
    each block's ``up_t`` transition.  up_u (D, nb, r), up_t (nb, r, k)
    -> (..., nb * k)."""
    h = torch.einsum("...d,dnr->...nr", x, params["up_u"].to(x.dtype))
    h = torch.einsum("...nr,nrk->...nk", h, params["up_t"].to(x.dtype))
    return h.reshape(*x.shape[:-1], -1)


def apply_mlp(params: Params, cfg, x: torch.Tensor, shard=None
              ) -> torch.Tensor:
    """Dense MLP; with ``shard`` (tensor parallelism) on this rank's ff
    slice, its ``w_down`` partial sum reduced over "model" when ff was
    split (and its input through ``copy_to_model``)."""
    split = shard is not None and params["w_down"].shape[0] != cfg.d_ff
    if split:
        x = copy_to_model(x, shard)
    if "up_u" in params:
        up = clover_up(params, x)
    else:
        up = x @ params["w_up"].to(x.dtype)
    if cfg.mlp_act == "swiglu":
        h = F.silu(x @ params["w_gate"].to(x.dtype)) * up
    elif cfg.mlp_act == "geglu":
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(x @ params["w_gate"].to(x.dtype), approximate="tanh") * up
    else:
        h = F.gelu(up, approximate="tanh")
    out = h @ params["w_down"].to(x.dtype)
    if split:
        out = reduce_model(out, shard)
    return out
