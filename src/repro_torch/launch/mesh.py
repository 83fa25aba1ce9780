"""Host meshes of the port over ``torch.distributed`` — own port of
``make_mesh`` / ``make_production_mesh`` / ``make_host_mesh`` /
``axis_size`` / ``batch_axes`` from ``repro/launch/mesh.py``.

One process per shard (SPMD): the caller initialises the process group
(``init_process_group`` with its own address, world size and rank;
nothing here reads a cluster's environment) and the mesh functions lay
the ranks out row-major over the named axes, as ``jax.make_mesh``
orders devices.  Axis semantics:

  pod   -- data-parallel replicas across pods (slow links); gradients
           cross this axis once per step (optionally int8-compressed,
           ``parallel.compress``).
  data  -- data parallel + FSDP: the batch AND the d_model dim of every
           weight split here; weights are gathered per layer on use.
  model -- tensor / expert parallel: heads, ff, experts, vocab.
  pipe  -- pipeline stages (``parallel.pipeline``).

Every axis of extent > 1 gets one process group per line of the mesh
along it (the whole world's group when the axis spans every rank);
every rank creates every group, in the same order.  Serving splits over
"model" only (``ShardedExecutor``); training uses every axis.
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve_device

AXES = ("pod", "data", "model", "pipe")


@dataclass(frozen=True)
class Mesh:
    """This rank's view of the mesh.  ``shape``: extent per axis, in the
    mesh's axis order; ``coords``: this rank's position on each axis;
    ``groups``: the process group of this rank's line along each axis
    (None for an axis of extent 1, or on a single process);
    ``axis_ranks``: the global ranks of that line, in axis order;
    ``device``: where this rank's shards live.  ``rank`` (this rank's
    position on "model"), ``group`` and ``model_ranks`` are the "model"
    axis's, which the serving code reads."""
    shape: Dict[str, int]
    coords: Dict[str, int]
    group: Any
    model_ranks: Tuple[int, ...]
    device: torch.device
    groups: Dict[str, Any] = field(default_factory=dict)
    axis_ranks: Dict[str, Tuple[int, ...]] = field(default_factory=dict)
    rank: int = field(init=False)

    def __post_init__(self):
        object.__setattr__(self, "rank", self.coords.get("model", 0))

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())


def make_mesh(shape: Sequence[int], axes: Sequence[str], *,
              device: DeviceLike = None) -> Mesh:
    """The mesh of ``shape`` over ``axes`` (any of "pod", "data",
    "model", "pipe") on the initialised process group's ranks, laid out
    row-major; ``prod(shape)`` must be the world size (1 without a
    process group).  ``device``: ``cpu`` when the caller asks for it
    (the tests); else the rank's card, ``cuda:{rank % device_count}``
    (an explicit ``cuda:i`` is kept)."""
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes) or len(set(axes)) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} must pair up "
                         "one extent with each distinct axis")
    unknown = [a for a in axes if a not in AXES]
    if unknown:
        raise ValueError(f"unknown mesh axes {unknown}: expected {AXES}")
    if any(n < 1 for n in shape):
        raise ValueError(f"mesh extents must be >= 1, got {shape}")
    grouped = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if grouped else 1
    me = dist.get_rank() if grouped else 0
    if math.prod(shape) != world:
        need = ("an initialised torch.distributed process group of "
                f"{math.prod(shape)} ranks (init_process_group with its "
                "address, world size and rank)" if not grouped else
                f"{math.prod(shape)} ranks but the world size is {world}")
        raise ValueError(f"mesh {dict(zip(axes, shape))} needs {need}")
    # row-major: the last axis varies fastest
    strides = [math.prod(shape[i + 1:]) for i in range(len(shape))]
    coords = {a: (me // s) % n for a, s, n in zip(axes, strides, shape)}
    groups: Dict[str, Any] = {}
    axis_ranks: Dict[str, Tuple[int, ...]] = {}
    for i, a in enumerate(axes):
        # this rank's line along axis a: the other coords fixed
        base = me - coords[a] * strides[i]
        axis_ranks[a] = tuple(base + k * strides[i] for k in range(shape[i]))
        groups[a] = None
        if not grouped or shape[i] == 1:
            continue
        if shape[i] == world:
            groups[a] = dist.group.WORLD
            continue
        others = [range(n) for j, n in enumerate(shape) if j != i]
        for rest in itertools.product(*others):
            c = list(rest)
            c.insert(i, 0)
            first = sum(x * s for x, s in zip(c, strides))
            ranks = [first + k * strides[i] for k in range(shape[i])]
            g = dist.new_group(ranks)     # collective: every rank, in order
            if me in ranks:
                groups[a] = g
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", me % torch.cuda.device_count())
    return Mesh(dict(zip(axes, shape)), coords, groups.get("model"),
                axis_ranks.get("model", (me,)), dev, groups, axis_ranks)


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = None) -> Mesh:
    """The reference's production meshes: (16, 16) over ("data",
    "model"), or (2, 16, 16) over ("pod", "data", "model")."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def make_host_mesh(data: Optional[int] = None, model: int = 1, *,
                   device: DeviceLike = None) -> Mesh:
    """The ``(data, model)`` mesh over the initialised process group's
    ranks.  ``model`` must divide the world size (and ``data * model``
    must use every rank when ``data`` is given); ``model > 1`` needs an
    initialised group."""
    if model < 1:
        raise ValueError(f"model axis must be >= 1, got {model}")
    grouped = dist.is_available() and dist.is_initialized()
    if not grouped and model > 1:
        raise ValueError(
            f"model={model} needs an initialised torch.distributed process "
            "group of model * data ranks (init_process_group with its "
            "address, world size and rank); none is initialised")
    n = dist.get_world_size() if grouped else 1
    if n % model != 0:
        raise ValueError(
            f"model={model} does not divide the world size {n}; pick a "
            f"tensor-parallel degree from the divisors of {n}")
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh ({data}, {model}) needs {data * model} "
                         f"ranks but the world size is {n}")
    return make_mesh((data, model), ("data", "model"), device=device)


def axis_size(mesh, name: str) -> int:
    return mesh.shape[name] if name in mesh.shape else 1


def batch_axes(mesh) -> Tuple[str, ...]:
    """Mesh axes the global batch splits over."""
    return tuple(a for a in ("pod", "data") if a in mesh.shape)
