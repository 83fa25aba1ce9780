"""Weight bridge between the JAX package's parameter trees and the
port's.

Weights cross the frameworks as numpy arrays: a caller with the JAX
package turns its pytree into numpy (``jax.tree.map(np.asarray,
params)``) and hands it to ``from_numpy``; ``to_numpy`` goes back, so
tests compare parameters after decompose and prune.  The layout is kept
as it is: dicts stay dicts and ``params["blocks"]`` stays a tuple with
one stacked tree per pattern position, each leaf carrying a leading
``n_blocks`` axis (``repro/models/transformer.py:80-86``).
"""
from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


def tree_map(fn: Callable, tree: Any) -> Any:
    """Map ``fn`` over the leaves of a dict / tuple / list tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(tree_map(fn, v) for v in tree)
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def from_numpy(tree: Any, device: DeviceLike = None) -> Any:
    """numpy tree (same structure as the JAX params/state) -> torch
    tensors on ``device`` (default ``cuda``).  Dtypes are kept."""
    dev = resolve_device(device)
    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(dev), tree)


def to_numpy(tree: Any) -> Any:
    """torch tree -> numpy arrays on the host (the reverse bridge)."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)
