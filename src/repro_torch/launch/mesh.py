"""Host meshes of the port over ``torch.distributed`` — own port of
``make_host_mesh`` / ``axis_size`` / ``batch_axes`` from
``repro/launch/mesh.py``.

One process per shard (SPMD): the caller initialises the process group
(``init_process_group`` with its own address, world size and rank;
nothing here reads a cluster's environment) and ``make_host_mesh``
lays the ranks out as a ``("data", "model")`` grid, data-major, as
``jax.make_mesh`` orders devices.  Axis semantics: "data" would carry
slot-batch replicas, "model" tensor / expert parallelism (heads, ff,
experts, vocab).  Serving runs ``data == 1``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve_device


@dataclass(frozen=True)
class Mesh:
    """This rank's view of the mesh.  ``shape``: extent per axis;
    ``coords``: this rank's position on each axis; ``rank``: its
    position on "model"; ``group``: the process group of its "model"
    axis (None on a single process); ``model_ranks``: that group's
    global ranks; ``device``: where this rank's shard lives."""
    shape: Dict[str, int]
    coords: Dict[str, int]
    group: Any
    model_ranks: Tuple[int, ...]
    device: torch.device
    rank: int = field(init=False)

    def __post_init__(self):
        object.__setattr__(self, "rank", self.coords["model"])


def make_host_mesh(data: Optional[int] = None, model: int = 1, *,
                   device: DeviceLike = None) -> Mesh:
    """The ``(data, model)`` mesh over the initialised process group's
    ranks.  ``model`` must divide the world size (and ``data * model``
    must use every rank when ``data`` is given); ``model > 1`` needs an
    initialised group.  ``device``: ``cpu`` when the caller asks for it
    (the tests); else the rank's card, ``cuda:{rank % device_count}``
    (an explicit ``cuda:i`` is kept)."""
    if model < 1:
        raise ValueError(f"model axis must be >= 1, got {model}")
    grouped = dist.is_available() and dist.is_initialized()
    if not grouped and model > 1:
        raise ValueError(
            f"model={model} needs an initialised torch.distributed process "
            "group of model * data ranks (init_process_group with its "
            "address, world size and rank); none is initialised")
    n = dist.get_world_size() if grouped else 1
    me = dist.get_rank() if grouped else 0
    if n % model != 0:
        raise ValueError(
            f"model={model} does not divide the world size {n}; pick a "
            f"tensor-parallel degree from the divisors of {n}")
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh ({data}, {model}) needs {data * model} "
                         f"ranks but the world size is {n}")
    coords = {"data": me // model, "model": me % model}
    model_ranks = tuple(coords["data"] * model + m for m in range(model))
    group = None
    if grouped:
        if data == 1:
            group = dist.group.WORLD
        else:
            # every rank creates every group, in the same order
            for d in range(data):
                g = dist.new_group(list(range(d * model, (d + 1) * model)))
                if d == coords["data"]:
                    group = g
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", me % torch.cuda.device_count())
    return Mesh({"data": data, "model": model}, coords, group, model_ranks,
                dev)


def axis_size(mesh, name: str) -> int:
    return mesh.shape[name] if name in mesh.shape else 1


def batch_axes(mesh) -> Tuple[str, ...]:
    """Mesh axes the global batch splits over."""
    return tuple(a for a in ("pod", "data") if a in mesh.shape)
