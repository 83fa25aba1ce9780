"""Spectrum analytics of the port — own copy of the parts of
``repro/core/analytics.py`` that Fig. 2 and the rank-budget planner
(DESIGN.md §14) need.

Fig. 2's curves (``qk_curves``, ``vo_curves``, ``energy_topk``) are
torch, on the weights' device: CLOVER's singular spectra of the grouped
Q-K / V-O products against the sorted per-dimension L2-norm products
that vanilla magnitude pruning ranks by.  ``energy_blocks`` is host
numpy in float64, not torch: the planner runs at plan time, and its
candidate order must be the reference's to the bit, so the port's torch
spectra are brought to the host (``host_array``) and scored exactly as
the reference scores its jnp spectra.  The adapter analytics of Figs.
4-6 (``coverage``, ``projection_mass``, ``delta_spectrum``,
``effective_rank``, ``intruder_dims``) arrive with the adapter-serving
slice.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.core.decompose import svd_lowrank_product

Params = Dict[str, Any]


def qk_curves(attn: Params, G: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(clover, vanilla) importance per K dim of ONE layer, each (KV, d)
    sorted descending: the singular values of the grouped Q-K product
    (what CLOVER prunes on) and the grouped products ||wq_i|| * ||wk_i||
    (what magnitude pruning prunes on), sorted for comparability."""
    wq, wk = attn["wq"].float(), attn["wk"].float()
    D, H, d = wq.shape
    KV = wk.shape[1]
    A = wq.permute(1, 0, 2).reshape(KV, G * D, d)
    _, S, _ = svd_lowrank_product(A, wk.permute(1, 0, 2))
    nq = torch.linalg.vector_norm(wq, dim=0).reshape(KV, G, d).sum(1)
    nk = torch.linalg.vector_norm(wk, dim=0)
    vanilla = torch.sort(nq * nk, dim=-1, descending=True).values
    return S, vanilla


def vo_curves(attn: Params, G: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """As ``qk_curves`` for the V-O pair of ONE layer."""
    wv, wo = attn["wv"].float(), attn["wo"].float()
    D, KV, d = wv.shape
    Bt = wo.reshape(KV, G, d, -1).permute(0, 1, 3, 2).reshape(KV, G * D, d)
    _, S, _ = svd_lowrank_product(wv.permute(1, 0, 2), Bt)
    nv = torch.linalg.vector_norm(wv, dim=0)
    no = torch.linalg.vector_norm(wo, dim=2).reshape(KV, G, d).sum(1)
    vanilla = torch.sort(nv * no, dim=-1, descending=True).values
    return S, vanilla


def energy_topk(spectrum: torch.Tensor, k: int) -> torch.Tensor:
    """Fraction of squared mass in the top-k entries (already sorted)."""
    sq = spectrum.square()
    return sq[..., :k].sum(-1) / sq.sum(-1).clamp_min(1e-30)


def host_array(a) -> np.ndarray:
    """A torch tensor (on any device) or array-like -> numpy on the
    host, dtype kept."""
    if torch.is_tensor(a):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def energy_blocks(spectrum, multiple: int) -> np.ndarray:
    """Squared singular mass per ``multiple``-wide rank block.

    ``spectrum`` (..., d), sorted descending -> (..., ceil(d/multiple))
    float64 block sums (a short final block zero-pads).  Block ``i`` of
    a head is the energy gained by growing that head's kept rank from
    ``i*multiple`` to ``(i+1)*multiple``; the descending sort makes the
    per-head block energies monotone, so the planner's greedy
    allocation always extends prefixes."""
    sq = np.square(np.asarray(host_array(spectrum), np.float64))
    d = sq.shape[-1]
    multiple = max(1, int(multiple))
    n = -(-d // multiple)
    pad = n * multiple - d
    if pad:
        sq = np.concatenate(
            [sq, np.zeros(sq.shape[:-1] + (pad,), sq.dtype)], axis=-1)
    return sq.reshape(sq.shape[:-1] + (n, multiple)).sum(-1)
