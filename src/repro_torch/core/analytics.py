"""Spectrum and projection analytics of the port — own copy of
``repro/core/analytics.py``: Fig. 2's curves, the rank-budget planner's
block energies (DESIGN.md §14) and the adapter analytics of Figs. 4-6.

Fig. 2's curves (``qk_curves``, ``vo_curves``, ``energy_topk``) are
torch, on the weights' device: CLOVER's singular spectra of the grouped
Q-K / V-O products against the sorted per-dimension L2-norm products
that vanilla magnitude pruning ranks by.  ``energy_blocks`` is host
numpy in float64, not torch: the planner runs at plan time, and its
candidate order must be the reference's to the bit, so the port's torch
spectra are brought to the host (``host_array``) and scored exactly as
the reference scores its jnp spectra.

Figs. 4-6 are torch in float32 on the inputs' device: Fig. 4's share
of data-feature energy on adapter directions (``projection_mass``,
``coverage``: random rank-r directions for LoRA, the top-r principal
ones for PiSSA, all d for CLOVER); Fig. 5's rank of the fine-tuning
update (``delta_spectrum``, ``effective_rank``); Fig. 6's intruder
dimensions, top singular vectors of the tuned weight with no
counterpart in the base (``intruder_dims``).  Counts and the coverage
are Python numbers.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

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


# ---------------------------------------------------------------------------
# Fig. 4: projection of data features onto adapter directions
# ---------------------------------------------------------------------------

def projection_mass(X: torch.Tensor, dirs: torch.Tensor,
                    weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Share of feature energy captured by each direction.  X (n, D)
    activations, dirs (D, r) columns (need not be complete), weights an
    optional per-direction scale (singular values: the model amplifies
    the large-singular-value directions).  -> (r,) fractions of the
    total projected energy."""
    e = (X.float() @ dirs.float()).square().sum(0)              # (r,)
    if weights is not None:
        e = e * weights.float().square()
    return e / e.sum().clamp_min(1e-30)


def coverage(X: torch.Tensor, dirs: torch.Tensor) -> float:
    """Fraction of the total feature energy INSIDE span(dirs): its
    complement is LoRA's / PiSSA's zero-gradient risk."""
    Q, _ = torch.linalg.qr(dirs.float())
    Xf = X.float()
    inside = (Xf @ Q).square().sum()
    return float(inside / Xf.square().sum().clamp_min(1e-30))


# ---------------------------------------------------------------------------
# Figs. 5-6: update rank and intruder dimensions
# ---------------------------------------------------------------------------

def delta_spectrum(W0: torch.Tensor, W1: torch.Tensor) -> torch.Tensor:
    """Singular values of the update dW = W1 - W0; a 3-D update is
    flattened to 2-D by the reference's rule."""
    d = W1.float() - W0.float()
    if d.dim() == 3:
        d = (d.reshape(d.shape[0], -1) if d.shape[0] > d.shape[2]
             else d.reshape(-1, d.shape[2]))
    return torch.linalg.svdvals(d)


def effective_rank(s: torch.Tensor, tol: float = 1e-3) -> int:
    """Number of singular values above ``tol`` x the largest."""
    return int((s > tol * s.max()).sum())


def intruder_dims(W0: torch.Tensor, W1: torch.Tensor, *, k: int = 16,
                  tau: float = 0.6) -> int:
    """How many of W1's top-``k`` left singular vectors have a best
    |cosine| below ``tau`` against every left singular vector of W0
    (Shuttleworth et al., 2024): LoRA injects such dimensions, full
    fine-tuning and CLOVER do not.  |cos| makes the SVD's sign choices
    irrelevant."""
    U0 = torch.linalg.svd(W0.float(), full_matrices=False).U
    U1 = torch.linalg.svd(W1.float(), full_matrices=False).U
    best = (U1[:, :k].T @ U0).abs().max(dim=1).values
    return int((best < tau).sum())
