"""AdamW with decoupled weight decay, global-norm clipping and LR
schedules — own port of ``repro/optim/adamw.py``.

Plain functions on trees of tensors, under ``torch.no_grad()``, with
the reference's semantics kept exactly: moments are float32 whatever
the parameter dtype; ``None`` leaves (the frozen half of
``core.peft.partition``) pass through, so CLOVER-S trains the trainable
half with the same optimizer; bias correction uses the incremented
step; the returned norm is the pre-clip one; weight decay applies to
leaves with ``ndim >= 2``.  That last rule is the reference's "no decay
on norms/bias", but block leaves carry the stacked ``n_blocks`` axis,
so every block's norm scales and biases ARE decayed and only
``final_norm`` is spared: a fault of the reference that the port copies
on purpose (ROADMAP C).

The update is functional: it returns new parameter and moment tensors
and leaves its inputs as they were.

Sharded trees (``specs``: the leaves' ``parallel.sharding`` specs,
``mesh``: this rank's mesh): ``global_norm`` sums each leaf's squares
over the mesh axes it is split on, and counts a replicated leaf once,
so every rank gets the same norm (and the same clip scale).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from repro_torch.parallel.sharding import (all_reduce, axis_group,
                                           map_with_specs, split_axes)
from repro_torch.tree import tree_leaves, tree_map

Params = Dict[str, Any]


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0     # 0 disables


def _zeros_f32(p):
    return None if p is None else torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device)


def adamw_init(params: Params) -> Params:
    """{"m", "v"}: float32 zeros shaped like ``params`` (``None`` where
    it is ``None``); "step": a 0-d int32 counter on the leaves' device."""
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    return {"m": tree_map(_zeros_f32, params),
            "v": tree_map(_zeros_f32, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _split_axes(spec, mesh) -> Tuple[str, ...]:
    """The mesh axes of extent > 1 that ``spec`` splits over, sorted."""
    return tuple(sorted({a for a in split_axes(spec)
                         if mesh.shape.get(a, 1) > 1}))


def _sum(xs):
    total = xs[0]
    for x in xs[1:]:
        total = total + x
    return total


@torch.no_grad()
def global_norm(tree, specs=None, mesh=None) -> torch.Tensor:
    """sqrt of the sum of every leaf's squared entries, float32.  With
    ``specs`` and ``mesh``: of the whole (unsharded) tree -- the leaves
    split over the same axes are summed together and that sum is
    all-reduced over those axes, in a fixed order on every rank."""
    if specs is None or mesh is None:
        sq = [g.float().square().sum() for g in tree_leaves(tree)]
        return _sum(sq).sqrt() if sq else torch.zeros(())
    buckets: Dict[Tuple[str, ...], list] = {}
    map_with_specs(lambda g, spec: buckets.setdefault(
        _split_axes(spec, mesh), []).append(g.float().square().sum()),
        tree, specs)
    if not buckets:
        return torch.zeros(())
    parts = []
    for axes in sorted(buckets):
        part = _sum(buckets[axes])
        for a in axes:
            part = all_reduce(part.contiguous().clone(),
                              axis_group(mesh, a)[0])
        parts.append(part)
    return _sum(parts).sqrt()


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float, specs=None, mesh=None):
    """-> (grads scaled to a global norm <= ``max_norm``, pre-clip
    norm); ``specs`` / ``mesh`` as in ``global_norm``."""
    gn = global_norm(grads, specs, mesh)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)
    return tree_map(lambda g: None if g is None else g * scale, grads), gn


@torch.no_grad()
def adamw_update(grads: Params, opt_state: Params, params: Params,
                 cfg: AdamWConfig, lr_scale=1.0, specs=None, mesh=None,
                 ) -> Tuple[Params, Params, torch.Tensor]:
    """Returns (new_params, new_opt_state, pre-clip grad norm).  On a
    mesh the trees are this rank's slices, ``specs`` their spec tree
    (the norm is the whole tree's; the update is elementwise)."""
    if cfg.grad_clip > 0:
        grads, gn = clip_by_global_norm(grads, cfg.grad_clip, specs, mesh)
    else:
        gn = global_norm(grads, specs, mesh)
    step = opt_state["step"] + 1
    b1, b2 = cfg.b1, cfg.b2
    sf = step.float()
    bc1 = 1.0 - torch.pow(torch.tensor(b1, device=sf.device), sf)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, device=sf.device), sf)
    lr = cfg.lr * lr_scale

    def upd(p, g, m, v):
        if p is None or g is None:
            return _Moved(None, None, None)
        gf = g.float()
        m = b1 * m + (1 - b1) * gf
        v = b2 * v + (1 - b2) * gf.square()
        delta = (m / bc1) / ((v / bc2).sqrt() + cfg.eps)
        if cfg.weight_decay > 0 and p.dim() >= 2:   # the reference's rule
            delta = delta + cfg.weight_decay * p.float()
        return _Moved((p.float() - lr * delta).to(p.dtype), m, v)

    out = tree_map(upd, params, grads, opt_state["m"], opt_state["v"])
    return (tree_map(lambda o: o.p, out),
            {"m": tree_map(lambda o: o.m, out),
             "v": tree_map(lambda o: o.v, out), "step": step}, gn)


class _Moved:
    """One leaf's update (a tree leaf, not a tuple node)."""
    __slots__ = ("p", "m", "v")

    def __init__(self, p, m, v):
        self.p, self.m, self.v = p, m, v


# ---------------------------------------------------------------------------
# schedules (multipliers of the base lr)
# ---------------------------------------------------------------------------

def _step_f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def warmup_cosine(step, *, warmup: int, total: int, floor: float = 0.1):
    """Linear warmup from 0, then cosine decay to ``floor``."""
    s = _step_f32(step)
    warm = s / max(1.0, warmup)
    prog = torch.clamp((s - warmup) / max(1.0, total - warmup), 0, 1)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(s < warmup, warm, cos)


def warmup_linear(step, *, warmup: int, total: int):
    """Linear warmup from 0, then linear decay to 0."""
    s = _step_f32(step)
    warm = s / max(1.0, warmup)
    decay = torch.clamp(1.0 - (s - warmup) / max(1.0, total - warmup), 0, 1)
    return torch.where(s < warmup, warm, decay)
