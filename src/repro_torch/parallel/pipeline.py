"""GPipe pipeline parallelism over a "pipe" mesh axis — own port of
``repro/parallel/pipeline.py`` (forward only, as the reference's).

A deployment whose layers outgrow one card's memory chooses a mesh with
a "pipe" axis and runs ``pipeline_apply`` over stage-stacked block
params: stage ``s`` (this rank's "pipe" coordinate) reads only its
slice of them.

Schedule: classic GPipe -- m microbatches flush through p stages in m +
p - 1 ticks (bubble fraction (p - 1) / (m + p - 1)).  At tick t, stage
0 ingests microbatch t and stage s works on microbatch t - s (while
0 <= t - s < m); after each tick a stage passes its activations one hop
forward with ``send`` / ``recv`` over "pipe".  The last stage's outputs
are broadcast to every rank at the end.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict

import torch
import torch.distributed as dist

from repro_torch.parallel.sharding import (COLLECTIVES, log_collective,
                                           timed)
from repro_torch.tree import tree_map

Params = Dict[str, Any]


def _exchange(send, dst, recv_like, src):
    """Send ``send`` to global rank ``dst`` and receive a tensor like
    ``recv_like`` from ``src`` (either may be None), concurrently.  gloo
    moves host memory only: a CUDA tensor goes through a host copy."""
    host = dist.get_backend() == "gloo"
    t0 = time.perf_counter()
    reqs, got = [], None
    if send is not None:
        reqs.append(dist.isend(send.cpu() if host else send.contiguous(),
                               dst))
        COLLECTIVES["send"] += 1
        log_collective("send", send, 2)
    if recv_like is not None:
        got = torch.empty_like(recv_like, device="cpu" if host else None)
        reqs.append(dist.irecv(got, src))
        COLLECTIVES["recv"] += 1
        log_collective("recv", got, 2)
    for r in reqs:
        r.wait()
    COLLECTIVES["seconds"] += time.perf_counter() - t0
    return None if got is None else got.to(recv_like.device)


def pipeline_apply(stage_params: Params, x: torch.Tensor, mesh,
                   stage_fn: Callable[[Params, torch.Tensor], torch.Tensor],
                   *, n_microbatches: int, axis: str = "pipe",
                   ) -> torch.Tensor:
    """Run ``stage_fn`` as a GPipe pipeline along ``axis``.

    stage_params: tree whose leaves have a leading axis == the number of
        stages; stage s applies ``stage_fn(slice s, h)``.
    x: (n_microbatches * mb, ...) global batch (microbatches contiguous),
        the same on every rank; ``stage_fn`` keeps a microbatch's shape
        and dtype.
    Returns the last stage's outputs in microbatch order, on every rank.
    """
    p = mesh.shape[axis]
    m = n_microbatches
    if x.shape[0] % m or m < p:
        raise ValueError(f"a batch of {x.shape[0]} in {m} microbatches over "
                         f"{p} stages: GPipe wants whole microbatches, at "
                         "least one per stage")
    mb = x.shape[0] // m
    stage = mesh.coords[axis]
    peers = mesh.axis_ranks[axis]
    params = tree_map(lambda a: a[stage], stage_params)
    xs = x.reshape((m, mb) + tuple(x.shape[1:]))
    out = torch.zeros_like(xs)
    buf = None
    for t in range(m + p - 1):
        i = t - stage                         # this stage's microbatch
        y = None
        if 0 <= i < m:
            y = stage_fn(params, xs[t] if stage == 0 else buf)
            if stage == p - 1:
                out[i] = y
        # pass it one hop forward; take the previous stage's next one
        send = y if y is not None and stage < p - 1 else None
        take = stage > 0 and 0 <= t + 1 - stage < m
        if send is not None or take:
            buf = _exchange(send, peers[min(stage + 1, p - 1)],
                            xs[0] if take else None, peers[stage - 1])
    if p > 1:
        timed("broadcast", lambda: dist.broadcast(
            out, src=peers[p - 1], group=mesh.groups[axis]), out, p)
    return out.reshape((x.shape[0],) + tuple(out.shape[2:]))
