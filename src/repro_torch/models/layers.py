"""Core layers of the port: norms, GQA attention (optionally
CLOVER-factored), dense MLPs — own port of ``repro/models/layers.py``
(DESIGN.md §2, §4, §6).

Attention weight layout (CLOVER-ready, as in the reference):
    wq : (D, H,  dq)     dq = head_dim, or the CLOVER-pruned Q-K rank
    wk : (D, KV, dq)
    wv : (D, KV, dv)     dv = head_dim, or the CLOVER-pruned V-O rank
    wo : (H, dv, D)

This slice ports the no-RoPE attention branches (gpt2-xl); RoPE,
self-speculative ``draft_rank`` slicing and SV ``adapter`` scales raise
``NotImplementedError`` until their slices land.  KV caches are
updated IN PLACE (the reference is functional; with buffer donation it
updates in place too) and the updated cache is also returned.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

Params = Dict[str, Any]


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


def _masked_attention(q, k, v, mask, scale, G):
    """Chunked-prefill read path (S > 1 against a cache): masked softmax
    over every cached position — computed outside any Pallas kernel in
    the reference, so it stays plain tensor code here.
    q (B,S,H,dq), k (B,T,KV,dq), v (B,T,KV,dv), mask (B,S,T)."""
    B, S, H, dq = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, S, KV, G, dq)
    logits = torch.einsum("bskgq,btkq->bkgst", qg, k) * scale
    logits = logits.float()
    neg = torch.finfo(torch.float32).min
    logits = logits.masked_fill(~mask[:, None, None, :, :], neg)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    ctx = torch.einsum("bkgst,btkv->bskgv", probs, v)
    return ctx.reshape(B, S, H, v.shape[-1])


def attention(params: Params, cfg, x: torch.Tensor, *,
              positions: torch.Tensor,
              kv_cache: Optional[Params] = None,
              cache_index: Optional[torch.Tensor] = None,
              page_table: Optional[torch.Tensor] = None,
              write_floor: Optional[torch.Tensor] = None,
              draft_rank: Optional[Tuple[int, int]] = None,
              adapter: Optional[Params] = None,
              ) -> Tuple[torch.Tensor, Optional[Params]]:
    """GQA attention (``repro/models/layers.py:212-460``, no-RoPE
    branches).

    Full sequence: ``kv_cache is None`` -> causal flash attention.
    Dense cache: ``kv_cache`` holds {"k": (B, Smax, KV, dq), "v": (B,
    Smax, KV, dv)}; ``cache_index`` is a scalar (whole batch at one
    position) or a (B,) per-slot vector, and the S-token window is
    written at [index, index + S).  Callers keep that window inside the
    cache (``transformer`` checks it once per step; the reference's
    ``dynamic_update_slice`` would clamp instead).
    Paged cache: ``page_table`` (B, n_p) is given and ``kv_cache`` holds
    the global pools {"k": (N, pt, KV, dq), "v": (N, pt, KV, dv)}.
    Positions past the table and, with ``write_floor``, writes below
    each slot's floor go to the garbage row ``N - 1``.  Every table
    entry must be a valid pool row.
    S == 1 with a cache runs the flash-decoding kernels; S > 1 with a
    cache runs the masked chunked-prefill path.
    """
    if draft_rank is not None or adapter is not None:
        raise NotImplementedError(
            "draft_rank (self-speculative decoding) and SV adapters are "
            "not ported yet")
    if cfg.rope_dims > 0:
        raise NotImplementedError("RoPE configs are not ported yet")
    if cfg.attn_logit_softcap > 0:
        raise NotImplementedError("attention logit softcap is not ported "
                                  "yet")
    B, S, D = x.shape
    H, KV = cfg.n_heads, cfg.n_kv_heads
    G = cfg.q_per_kv
    dq, dv = cfg.qk_dim, cfg.vo_dim
    # CLOVER-pruned heads approximate the ORIGINAL product Q K^T, so the
    # softmax scale stays 1/sqrt(original head_dim) regardless of rank.
    scale = 1.0 / math.sqrt(cfg.head_dim_)

    q = _proj(x, params["wq"].to(x.dtype))
    k = _proj(x, params["wk"].to(x.dtype))
    v = _proj(x, params["wv"].to(x.dtype))

    def vo_out(ctx):                              # (B, S, H, dv) -> (B, S, D)
        wo = params["wo"].to(x.dtype)
        return ctx.reshape(B, S, H * dv) @ wo.reshape(H * dv, D)

    if kv_cache is None:
        ctx = ops.clover_attention(q.contiguous(), k.contiguous(),
                                   v.contiguous(), scale=scale)
        return vo_out(ctx), None

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
        ck.view(N * PT, KV, dq)[dest] = k.reshape(B * S, KV, dq).to(ck.dtype)
        cv.view(N * PT, KV, dv)[dest] = v.reshape(B * S, KV, dv).to(cv.dtype)
        new_cache = {"k": ck, "v": cv}
        if S == 1:  # paged flash-decoding: the serving hot path
            lengths = cache_index + 1
            ctx = ops.paged_decode_attention(
                q[:, 0].contiguous(), ck, cv, page_table, lengths,
                scale=scale)
            return vo_out(ctx[:, None]), new_cache
        # chunked prefill: gather each slot's pages into a dense view
        tab = page_table.long()
        k = ck[tab].reshape(B, P * PT, KV, dq).to(x.dtype)
        v = cv[tab].reshape(B, P * PT, KV, dv).to(x.dtype)
        qpos = pos
    else:
        if cache_index.dim() == 1:     # per-slot positions
            pos = cache_index.long()[:, None] + ar[None, :]      # (B, S)
            rows = torch.arange(B, device=x.device)[:, None]
            ck[rows, pos] = k.to(ck.dtype)
            cv[rows, pos] = v.to(cv.dtype)
            qpos = pos
        else:                          # whole batch at one position
            i = int(cache_index)
            ck[:, i:i + S] = k.to(ck.dtype)
            cv[:, i:i + S] = v.to(cv.dtype)
            qpos = (i + ar)[None, :].expand(B, S)
        new_cache = {"k": ck, "v": cv}
        if S == 1:  # flash-decoding against the cache
            lengths = (qpos[:, 0] + 1).to(torch.int32)
            ctx = ops.decode_attention(q[:, 0].contiguous(), ck, cv,
                                       lengths, scale=scale)
            return vo_out(ctx[:, None]), new_cache
        k, v = ck.to(x.dtype), cv.to(x.dtype)
    T = k.shape[1]
    kv_pos = torch.arange(T, device=x.device)
    # query j of slot b sits at position qpos[b, j]; causal against
    # every cached position
    mask = kv_pos[None, None, :] <= qpos[:, :, None]             # (B, S, T)
    ctx = _masked_attention(q, k, v, mask, scale, G)
    return vo_out(ctx), new_cache


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


def apply_mlp(params: Params, cfg, x: torch.Tensor) -> torch.Tensor:
    if "up_u" in params:
        raise NotImplementedError("the CLOVER MLP.Up PEFT path is not "
                                  "ported yet")
    up = x @ params["w_up"].to(x.dtype)
    if cfg.mlp_act == "swiglu":
        h = F.silu(x @ params["w_gate"].to(x.dtype)) * up
    elif cfg.mlp_act == "geglu":
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(x @ params["w_gate"].to(x.dtype), approximate="tanh") * up
    else:
        h = F.gelu(up, approximate="tanh")
    return h @ params["w_down"].to(x.dtype)
