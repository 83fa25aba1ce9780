"""CLOVER pruning planner — own port of the uniform part of
``repro/core/prune.py`` (DESIGN.md §3, §4).

After ``clover_decompose`` every head's factors are sorted by singular
value, so structured pruning is a static slice ``[..., :r]`` at the same
rate in every layer (the paper's setting).  The KV cache then stores K
at rank ``r_qk`` and V at rank ``r_vo``.  Kept ranks snap UP to
``cfg.clover.rank_multiple``.  The vanilla baseline, threshold planning
and non-uniform rank budgets arrive with later slices.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig, MIXER_ATTN
from repro_torch.core.decompose import qk_mode

Params = Dict[str, Any]


def snap_rank(r: int, multiple: int, d: int) -> int:
    """Snap a kept rank UP to ``multiple``, capped at d."""
    if multiple <= 1:
        return max(1, min(r, d))
    return max(multiple, min(d, ((r + multiple - 1) // multiple) * multiple))


def plan_ranks(cfg: ArchConfig, qk_ratio: float, vo_ratio: float
               ) -> Tuple[int, int]:
    """Kept per-head widths (qk_keep, vo_keep) for a pruning ratio."""
    d = cfg.head_dim_
    m = cfg.clover.rank_multiple
    mode = qk_mode(cfg)
    if mode == "cross":
        qk_keep = snap_rank(round(d * (1.0 - qk_ratio)), m, d)
    elif mode == "partial":
        rot = cfg.rope_dims
        tail = d - rot
        qk_keep = rot + snap_rank(round(tail * (1.0 - qk_ratio)), m, tail)
    else:  # intra (full RoPE): Q-K pruning illegal (paper §5)
        qk_keep = d
    vo_keep = snap_rank(round(d * (1.0 - vo_ratio)), m, d)
    return qk_keep, vo_keep


def _set_ranks(cfg: ArchConfig, qk_keep: int, vo_keep: int) -> ArchConfig:
    d = cfg.head_dim_
    return dataclasses.replace(
        cfg, clover=dataclasses.replace(
            cfg.clover, enabled=True,
            qk_rank=0 if qk_keep == d else qk_keep,
            vo_rank=0 if vo_keep == d else vo_keep))


def _prune_attn_clover(attn: Params, cfg: ArchConfig,
                       qk_keep: int, vo_keep: int) -> Params:
    """Slice the sorted factors of stacked attention params:
    wq (nb, D, H, dq), wk (nb, D, KV, dq), wv (nb, D, KV, dv),
    wo (nb, H, dv, D).  The slices are copied out contiguous, so the
    full-width weights can be freed."""
    new = dict(attn)
    d = cfg.head_dim_
    if qk_keep < d and qk_mode(cfg) != "intra":
        new["wq"] = attn["wq"][..., :qk_keep].contiguous()
        new["wk"] = attn["wk"][..., :qk_keep].contiguous()
    if vo_keep < d:
        new["wv"] = attn["wv"][..., :vo_keep].contiguous()
        new["wo"] = attn["wo"][..., :vo_keep, :].contiguous()
    return new


@torch.no_grad()
def clover_prune(params: Params, cfg: ArchConfig, *,
                 qk_ratio: float = 0.0, vo_ratio: float = 0.0,
                 ) -> Tuple[Params, ArchConfig]:
    """Prune a CLOVER-decomposed model.  Returns (params', cfg') with
    cfg'.clover ranks set so the weights and KV caches shrink."""
    if not cfg.clover.enabled:
        raise ValueError("clover_prune requires a decomposed model "
                         "(run clover_decompose first)")
    qk_keep, vo_keep = plan_ranks(cfg, qk_ratio, vo_ratio)
    new_blocks = []
    for j, (mixer, _) in enumerate(cfg.pattern):
        stacked = dict(params["blocks"][j])
        if mixer == MIXER_ATTN:
            stacked["attn"] = _prune_attn_clover(stacked["attn"], cfg,
                                                 qk_keep, vo_keep)
        new_blocks.append(stacked)
    out = dict(params)
    out["blocks"] = tuple(new_blocks)
    return out, _set_ranks(cfg, qk_keep, vo_keep)
