"""Weight bridge between the JAX package's parameter trees and the
port's.

Weights cross the frameworks as numpy arrays: a caller with the JAX
package turns its pytree into numpy (``jax.tree.map(np.asarray,
params)``) and hands it to ``from_numpy``; ``to_numpy`` goes back, so
tests compare parameters after decompose and prune.  The layout is kept
as it is: dicts stay dicts and ``params["blocks"]`` stays a tuple with
one stacked tree per pattern position, each leaf carrying a leading
``n_blocks`` axis (``repro/models/transformer.py:80-86``).  Peft
splits, optimizer states and adapter trees cross the same way:
``None`` leaves stay ``None`` and 0-d arrays (an adapter's ``r_eff``,
the optimizer's ``step``) stay 0-d.  A rank plan
crosses as its plain fields (``budget_from_fields``); the ``rank_qk``/
``rank_vo`` leaves of a budgeted model cross with the weights, as int32.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.prune import RankBudget
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.tree import tree_map  # noqa: F401  (re-exported)


# floats numpy knows only through ``ml_dtypes`` (the JAX package's
# bfloat16 and float8 arrays): they cross as unsigned ints of their width,
# bit for bit, and are viewed as the torch dtype of the same name
_NARROW = ("bfloat16", "float8_e4m3fn", "float8_e5m2")
_NARROW_TORCH = {getattr(torch, n): n for n in _NARROW}
_UINT = {1: np.uint8, 2: np.uint16}
_UINT_TORCH = {1: torch.uint8, 2: torch.uint16}


def _leaf_from_numpy(a, dev) -> torch.Tensor:
    if a is None:
        return None
    a = np.array(a)
    if a.dtype.name in _NARROW:
        bits = torch.from_numpy(a.view(_UINT[a.dtype.itemsize]))
        return bits.view(getattr(torch, a.dtype.name)).to(dev)
    return torch.from_numpy(a).to(dev)


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    if t is None:
        return None
    t = t.detach().cpu()
    name = _NARROW_TORCH.get(t.dtype)
    if name is None:
        return t.numpy()
    import ml_dtypes     # JAX's dependency: only narrow trees need it
    bits = t.view(_UINT_TORCH[t.element_size()]).numpy()
    return bits.view(getattr(ml_dtypes, name))


def from_numpy(tree: Any, device: DeviceLike = None) -> Any:
    """numpy tree (same structure as the JAX params/state) -> torch
    tensors on ``device`` (default ``cuda``).  Dtypes are kept, bfloat16
    and float8 bit for bit."""
    dev = resolve_device(device)
    return tree_map(lambda a: _leaf_from_numpy(a, dev), tree)


def to_numpy(tree: Any) -> Any:
    """torch tree -> numpy arrays on the host (the reverse bridge);
    bfloat16 and float8 leaves come back as ``ml_dtypes`` arrays, bit for
    bit."""
    return tree_map(_leaf_to_numpy, tree)


def budget_from_fields(head_dim: int, rank_multiple: int, total_rank: int,
                       budget: int, qk_ranks, vo_ranks) -> RankBudget:
    """A rank plan from its plain fields (ints and nested int tuples),
    e.g. those of the reference's ``RankBudget`` (DESIGN.md §14)."""
    def freeze(table):
        return tuple(tuple(tuple(int(r) for r in row) for row in j)
                     for j in table)
    return RankBudget(head_dim=int(head_dim),
                      rank_multiple=int(rank_multiple),
                      total_rank=int(total_rank), budget=int(budget),
                      qk_ranks=freeze(qk_ranks), vo_ranks=freeze(vo_ranks))
