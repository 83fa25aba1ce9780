"""Spectrum analytics of the port — own copy of the part of
``repro/core/analytics.py`` the rank-budget planner needs (DESIGN.md
§14).

Host numpy in float64, not torch: the planner runs at plan time, and
its candidate order must be the reference's to the bit, so the port's
torch spectra are brought to the host (``host_array``) and scored
exactly as the reference scores its jnp spectra.
"""
from __future__ import annotations

import numpy as np
import torch


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
