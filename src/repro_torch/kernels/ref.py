"""Plain PyTorch versions of the attention kernels (own port of
``repro/kernels/ref.py``; DESIGN.md §4).

They are the semantics the CUDA kernels reproduce: the CPU path of
``kernels/ops.py`` and the target ``chip_smoke.py`` holds each kernel
to on the card.  Nothing on the main path calls them when a card is
present; each keeps a ``calls`` count so a run can show that.

One deliberate difference from the jnp oracles: the decode versions
clamp the softmax denominator at 1e-30 like the kernels, so a row with
``lengths[b] == 0`` outputs exactly 0 (the jnp oracle's all-masked
softmax gives NaN there; the Pallas kernels give 0).  For every row
with a valid position the two agree.
"""
from __future__ import annotations

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  scale: float, causal: bool = True) -> torch.Tensor:
    """GQA attention with asymmetric head widths (dq != dv allowed).

    q: (B, S, H, dq);  k: (B, T, KV, dq);  v: (B, T, KV, dv)
    -> (B, S, H, dv).  Causal queries align to the END of the key range
    (query i sits at position ``T - S + i``).
    """
    attention_ref.calls += 1
    B, S, H, dq = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, S, KV, G, dq)
    logits = torch.einsum("bskgq,btkq->bkgst", qg, k).float() * scale
    if causal:
        qi = torch.arange(S, device=q.device)[:, None] + (T - S)
        mask = qi >= torch.arange(T, device=q.device)[None, :]
        logits = logits.masked_fill(~mask, float("-inf"))
    p = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkv->bskgv", p, v)
    return out.reshape(B, S, H, v.shape[-1])


attention_ref.calls = 0


def _masked_softmax_av(logits: torch.Tensor, mask: torch.Tensor,
                       v: torch.Tensor) -> torch.Tensor:
    """softmax(logits | mask) @ v with the kernels' clamped denominator.
    logits (B, KV, G, T) f32, mask (B, T) bool, v (B, T, KV, dv)."""
    logits = logits.masked_fill(~mask[:, None, None, :], float("-inf"))
    m = logits.amax(dim=-1, keepdim=True).clamp_min(-1e30)
    p = torch.exp(logits - m)
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bkgt,btkv->bkgv", p.to(v.dtype), v)
    return out / denom


def _decode(q, k, v, lengths, scale):
    B, H, dq = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, dq)
    logits = torch.einsum("bkgq,btkq->bkgt", qg, k).float() * scale
    mask = (torch.arange(T, device=q.device)[None, :]
            < lengths.to(q.device).long()[:, None])
    out = _masked_softmax_av(logits, mask, v)
    return out.reshape(B, H, v.shape[-1]).to(q.dtype)


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         lengths: torch.Tensor, *,
                         scale: float) -> torch.Tensor:
    """Single-token flash-decoding.

    q: (B, H, dq);  k: (B, T, KV, dq);  v: (B, T, KV, dv);
    lengths: (B,) int — positions >= length are masked.  -> (B, H, dv)
    """
    decode_attention_ref.calls += 1
    return _decode(q, k, v, lengths, scale)


decode_attention_ref.calls = 0


def paged_decode_attention_ref(q: torch.Tensor, k_pool: torch.Tensor,
                               v_pool: torch.Tensor,
                               page_table: torch.Tensor,
                               lengths: torch.Tensor, *,
                               scale: float) -> torch.Tensor:
    """Paged flash-decoding: gather each slot's pages into a dense cache
    through the page table, then the dense version.

    q: (B, H, dq);  k_pool: (N, page_tokens, KV, dq);
    v_pool: (N, page_tokens, KV, dv);  page_table: (B, n_p) int;
    lengths: (B,) int.  Every table entry must be a valid pool row (the
    engine pads with the garbage row ``N - 1``).  -> (B, H, dv)
    """
    paged_decode_attention_ref.calls += 1
    B, n_p = page_table.shape
    pt = k_pool.shape[1]
    tab = page_table.long()
    k = k_pool[tab].reshape(B, n_p * pt, *k_pool.shape[2:])
    v = v_pool[tab].reshape(B, n_p * pt, *v_pool.shape[2:])
    return _decode(q, k, v, lengths, scale)


paged_decode_attention_ref.calls = 0
