"""int8 gradient compression for the cross-pod hop — own port of
``repro/parallel/compress.py``.

At many pods the scarce resource is the link between pods.  The
gradient all-reduce is reassociated: full precision over the fast
intra-pod axis ("data", ``train.step``), then an int8-quantized sum over
the slow "pod" axis (here), cutting cross-pod bytes 4x (float32) / 2x
(bfloat16).  Quantization uses a per-tensor symmetric scale (max-abs);
an int32 accumulator avoids saturation (pod count << 2^23).  The pods
agree on the scale before they quantize (a MAX all-reduce of each
pod's max-abs), so every pod's int8 values count on one grid and the
dequantized sum is the pods' sum up to rounding: unbiased, however
unequal the pods' shares.  Error feedback (the residual carried to the
next step) carries that rounding; the residual tree lives beside the
optimizer state.

Each pod's gradients enter as that pod's replica (the same on every
pod's ranks that hold the same shard) and leave averaged over pods, the
same bytes on every pod.  On replicated inputs (the only ones the
reference's GSPMD step passes: its gradients are already averaged over
("pod", "data")) the agreed scale is each pod's own, and the result is
the reference's bit for bit.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.distributed as dist

from repro_torch.parallel.sharding import (all_reduce, axis_group,
                                           map_with_specs)
from repro_torch.tree import tree_map

Params = Dict[str, Any]


def _scale(x: torch.Tensor, mesh) -> torch.Tensor:
    """The pods' common float32 scale: the largest max|x| / 127 over
    "pod" (a MAX all-reduce; at least 1e-12 / 127)."""
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    group, n = axis_group(mesh, "pod")
    if n > 1:
        all_reduce(scale, group, op=dist.ReduceOp.MAX)
    return scale


def _quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """-> int8 q: x ~ q * scale, |q| <= 127."""
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def _sum_int8(q: torch.Tensor, scale: torch.Tensor, mesh) -> torch.Tensor:
    """The pods' int8 ``q`` summed in int32, dequantized with their
    common ``scale``."""
    group, n = axis_group(mesh, "pod")
    total = q.to(torch.int32)
    if n > 1:
        all_reduce(total, group)
    return total.float() * scale


def _psum_int8(x: torch.Tensor, mesh) -> torch.Tensor:
    """Quantize -> int32 sum over "pod" -> dequantize, in ``x``'s dtype."""
    xf = x.float()
    scale = _scale(xf, mesh)
    return _sum_int8(_quantize(xf, scale), scale, mesh).to(x.dtype)


def compress_cross_pod(grads: Params, mesh) -> Params:
    """``grads`` averaged over the "pod" axis in int8 (``None`` leaves
    pass through)."""
    n = axis_group(mesh, "pod")[1]
    return tree_map(lambda g: None if g is None
                    else _psum_int8(g, mesh) / n, grads)


def compress_cross_pod_ef(grads: Params, residual: Params, mesh
                          ) -> Tuple[Params, Params]:
    """Error-feedback variant: quantize (g + residual), carry the error.
    Returns (pod-averaged grads, new residual)."""
    n = axis_group(mesh, "pod")[1]

    def one(g, r):
        x = g.float() + r
        scale = _scale(x, mesh)
        q = _quantize(x, scale)
        err = x - q.float() * scale               # what the wire lost
        return (_sum_int8(q, scale, mesh) / n).to(g.dtype), err

    pairs = map_with_specs(one, grads, residual)
    return (map_with_specs(lambda _, p: p[0], grads, pairs),
            map_with_specs(lambda _, p: p[1], grads, pairs))


def init_residual(grads_like: Params) -> Params:
    """float32 zeros shaped like ``grads_like``."""
    return tree_map(lambda g: None if g is None else torch.zeros(
        g.shape, dtype=torch.float32, device=g.device), grads_like)
