"""Logical-axis sharding rules of the port, serving half — own port of
``repro/parallel/sharding.py`` (DESIGN.md §10).

Each weight leaf is matched BY NAME to a tuple of logical axes; logical
axes map to mesh axes through ``ShardingRules``; a dim whose size does
not divide its mesh-axis extent degrades to replication (None).  That
is what absorbs awkward counts (gpt2-xl's 25 heads, phi3's odd KV
heads, granite's vocab of 49155) without per-architecture cases.

A spec here is a ``Spec``: a tuple with one entry per dim, the mesh
axis that dim splits over or None, as the reference's ``PartitionSpec``
spells it.  The functions read only ``mesh.shape`` (a ``{"data": ..,
"model": ..}`` dict), so the decisions can be computed, and compared
with the reference's, for any mesh without one existing.
``shard_tree`` takes this rank's contiguous slice of every split leaf;
``reduce_model`` and ``gather_vocab`` are the two collectives the
sharded model needs, an ``all_reduce`` (sum) and, for a replicated
vocab, a ``broadcast`` (``torch.distributed``, any backend: gloo runs
them on CUDA tensors too).  ``COLLECTIVES`` counts them and the host
seconds spent in them.

Training's FSDP rules, ``data_specs``, ``decode_state_specs`` and the
pipeline and gradient-compression modules are not ported yet.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

Params = Dict[str, Any]

# logical axis names
BATCH = "batch"
EMBED = "embed"        # d_model dim of weights (FSDP in training)
HEADS = "heads"        # query heads
KV_HEADS = "kv"        # kv heads
FF = "ff"              # MLP hidden
EXPERTS = "experts"    # MoE expert dim
VOCAB = "vocab"
KV_SEQ = "kv_seq"      # KV-cache sequence dim (training's decode rules)


class Spec(tuple):
    """Per-dim mesh axes of one leaf (None: that dim is replicated)."""


@dataclass(frozen=True)
class ShardingRules:
    """logical axis -> mesh axis (or tuple of mesh axes, or None)."""
    rules: Dict[str, Any] = field(default_factory=lambda: {
        BATCH: ("pod", "data"),
        EMBED: "data",
        HEADS: "model",
        KV_HEADS: "model",
        FF: "model",
        EXPERTS: "model",
        VOCAB: "model",
        KV_SEQ: "model",
    })

    def mesh_axes(self, logical: Optional[str], mesh):
        if logical is None:
            return None
        ax = self.rules.get(logical)
        if ax is None:
            return None
        if isinstance(ax, tuple):
            present = tuple(a for a in ax if a in mesh.shape)
            return present if present else None
        return ax if ax in mesh.shape else None

    def spec(self, logical_axes: Tuple[Optional[str], ...], shape,
             mesh) -> Spec:
        """Logical axes -> Spec, dropping the non-divisible ones."""
        out = []
        for ax_name, dim in zip(logical_axes, shape):
            m = self.mesh_axes(ax_name, mesh)
            if m is None:
                out.append(None)
                continue
            out.append(m if dim % _extent(m, mesh) == 0 else None)
        return Spec(out)


def _extent(m, mesh) -> int:
    return (math.prod(mesh.shape[a] for a in m) if isinstance(m, tuple)
            else mesh.shape[m])


# ---------------------------------------------------------------------------
# per-leaf logical axes, keyed by leaf name (copied from the reference)
# ---------------------------------------------------------------------------

# name -> logical axes for the TRAILING dims (the leading stacked n_blocks
# axis is always replicated).  Names are unique across the tree.
_WEIGHT_AXES: Dict[str, Tuple[Optional[str], ...]] = {
    # attention (wq (D,H,dq), wk/wv (D,KV,d), wo (H,dv,D))
    "wq": (EMBED, HEADS, None),
    "wv": (EMBED, KV_HEADS, None),
    "wo": (HEADS, None, EMBED),
    # clover transitions
    "s_qk": (HEADS, None, None),
    "s_vo": (HEADS, None, None),
    "k_t": (KV_HEADS, None, None),
    "up_t": (FF, None, None),           # (n_up_blocks, blk, blk)
    "up_u": (EMBED, FF, None),          # (D, n_up_blocks, blk)
    # dense mlp
    "w_gate": (EMBED, FF),
    "w_up": (EMBED, FF),
    "w_down": (FF, EMBED),
    # moe (router (D,E), experts (E,D,de) / (E,de,D), shared (D,ds))
    "router": (EMBED, None),
    "shared_up": (EMBED, FF),
    "shared_gate": (EMBED, FF),
    "shared_down": (FF, EMBED),
    # mamba
    "in_proj": (EMBED, FF),
    "conv_w": (None, FF),
    "conv_b": (FF,),
    "x_proj": (FF, None),
    "dt_proj": (None, FF),
    "dt_bias": (FF,),
    "A_log": (FF, None),
    "D": (FF,),
    "out_proj": (FF, EMBED),
    # rwkv time/channel mix
    "wr": (EMBED, FF),
    "wg": (EMBED, FF),
    "w_lora_a": (EMBED, None),
    "w_lora_b": (None, FF),
    "u": (HEADS, None),
    "out": (FF, EMBED),
    # norms / mixing coefficients / small vectors: replicated
}

# context-dependent overrides: leaf "wk" means attention K (D,KV,d) in
# "attn" but channel-mix key (D,F) in "rwkv_chan".
_CONTEXT_AXES: Dict[Tuple[str, str], Tuple[Optional[str], ...]] = {
    ("attn", "wk"): (EMBED, KV_HEADS, None),
    ("rwkv_chan", "wk"): (EMBED, FF),
    ("rwkv_time", "wk"): (EMBED, FF),
    ("rwkv_time", "wv"): (EMBED, FF),
    ("moe", "w_up"): (EXPERTS, EMBED, None),
    ("moe", "w_gate"): (EXPERTS, EMBED, None),
    ("moe", "w_down"): (EXPERTS, None, EMBED),
    ("rwkv_chan", "up_u"): (EMBED, FF, None),
    ("rwkv_chan", "up_t"): (FF, None, None),
}

_TOP_LEVEL: Dict[str, Tuple[Optional[str], ...]] = {
    "embed": (VOCAB, EMBED),
    "pos_embed": (None, EMBED),
    "lm_head": (EMBED, VOCAB),
}


def _leaf_axes(names: Tuple[str, ...]) -> Optional[Tuple[Optional[str], ...]]:
    leaf = names[-1]
    parent = names[-2] if len(names) >= 2 else ""
    if (parent, leaf) in _CONTEXT_AXES:
        return _CONTEXT_AXES[(parent, leaf)]
    if leaf in _TOP_LEVEL and "blocks" not in names:
        return _TOP_LEVEL[leaf]
    return _WEIGHT_AXES.get(leaf)


def map_with_names(fn, tree, names: Tuple[str, ...] = ()):
    """``fn(dict keys on the path, leaf)`` over a tree of dicts and
    tuples (tuple positions are not names, as the reference's key paths
    skip sequence indices)."""
    if isinstance(tree, dict):
        return {k: map_with_names(fn, v, names + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)) and not isinstance(tree, Spec):
        return tuple(map_with_names(fn, v, names) for v in tree)
    return fn(names, tree)


def _fit(axes, ndim: int):
    axes = tuple(axes)[:ndim]
    return axes + (None,) * (ndim - len(axes))


def param_specs(params: Params, mesh,
                rules: Optional[ShardingRules] = None) -> Params:
    """Spec tree matching ``params`` (the ``init_lm_params`` layout)."""
    rules = rules or ShardingRules()

    def visit(names, leaf):
        axes = _leaf_axes(names)
        if axes is None:
            return Spec()          # replicate (norms, scalars, biases)
        if "blocks" in names:      # leading stacked n_blocks axis
            axes = (None,) + tuple(axes)
        return rules.spec(_fit(axes, leaf.dim()), leaf.shape, mesh)

    return map_with_names(visit, params)


def serve_rules() -> ShardingRules:
    """Logical -> mesh map for the SERVING path (DESIGN.md §10): "data"
    carries only the slot batch and weights replicate across it; heads,
    ff, experts and vocab split over "model"; the KV cache splits along
    its KV-HEAD axis (where CLOVER's per-head ranks put the bytes and
    FLOPs), never along the sequence: page ids are host-global, every
    shard holds the same page rows for its own heads."""
    return ShardingRules(rules={
        BATCH: "data",
        EMBED: None,
        HEADS: "model",
        KV_HEADS: "model",
        FF: "model",
        EXPERTS: "model",
        VOCAB: "model",
        KV_SEQ: None,
    })


def serve_state_specs(state: Params, mesh, *, paged: bool,
                      rules: Optional[ShardingRules] = None) -> Params:
    """Spec tree for the serving engine's decode state.  KV leaves split
    along the KV-head axis (axis -2 of dense ``(nb, B, T, KV, r)`` and
    paged ``(nb, n_pages+1, PT, KV, r)``); the dense layout also splits
    slots over "data".  The paged pool's page-row axis is replicated
    (page ids are global; the sentinel row stays on every shard).
    Recurrent leaves split only their slot axis over "data"; ``index``
    replicates.  Size-1 mesh axes and trailing Nones are dropped, the
    reference's canonical form."""
    rules = rules or serve_rules()

    def visit(names, leaf):
        if names[-1] == "index":
            return Spec()
        if "kv" in names:
            axes = ((None, None, None, KV_HEADS, None) if paged
                    else (None, BATCH, None, KV_HEADS, None))
        else:
            axes = (None, BATCH) + (None,) * (leaf.dim() - 2)
        spec = [m if m is None or _extent(m, mesh) > 1 else None
                for m in rules.spec(_fit(axes, leaf.dim()), leaf.shape,
                                    mesh)]
        while spec and spec[-1] is None:
            spec.pop()
        return Spec(spec)

    return map_with_names(visit, state)


def kernel_axes(mesh, *, batch: int, kv_heads: int,
                rules: Optional[ShardingRules] = None
                ) -> Tuple[Optional[str], Optional[str]]:
    """(batch axis, head axis) the serving kernels' operands split over:
    the slot batch over "data", KV heads over "model", as
    ``serve_state_specs`` lays out the pools.  A dim that does not
    divide its axis (or an axis of extent 1) gives None: the kernel runs
    on that dim whole on every shard.  ``mesh=None``: (None, None)."""
    if mesh is None:
        return None, None
    rules = rules or serve_rules()

    def pick(logical: str, dim: int) -> Optional[str]:
        m = rules.mesh_axes(logical, mesh)
        if m is None or isinstance(m, tuple):
            return None
        return m if (mesh.shape[m] > 1 and dim % mesh.shape[m] == 0) \
            else None

    return pick(BATCH, batch), pick(KV_HEADS, kv_heads)


def split_dims(spec) -> Tuple[Tuple[int, str], ...]:
    """(dim, mesh axis) of every split dim of a spec."""
    return tuple((d, m) for d, m in enumerate(spec) if m is not None)


def local_slice(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's contiguous block of ``t`` under ``spec`` (a copy when
    any dim splits; ``t`` itself when none does)."""
    for d, m in split_dims(spec):
        axes = m if isinstance(m, tuple) else (m,)
        n = math.prod(mesh.shape[a] for a in axes)
        coord = 0
        for a in axes:                      # row-major over the axes
            coord = coord * mesh.shape[a] + mesh.coords[a]
        size = t.shape[d] // n
        t = t.narrow(d, coord * size, size)
    return t.contiguous() if split_dims(spec) else t


def shard_tree(tree, specs, mesh):
    """``tree`` with every split leaf replaced by this rank's slice."""
    def walk(node, spec):
        if isinstance(node, dict):
            return {k: walk(v, spec[k]) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return tuple(walk(v, s) for v, s in zip(node, spec))
        return local_slice(node, spec, mesh)
    return walk(tree, specs)


# ---------------------------------------------------------------------------
# collectives over "model"
# ---------------------------------------------------------------------------

COLLECTIVES = {"all_reduce": 0, "broadcast": 0, "seconds": 0.0}


def reset_collectives() -> None:
    COLLECTIVES.update(all_reduce=0, broadcast=0, seconds=0.0)


def _collective(kind: str, fn, x: torch.Tensor) -> torch.Tensor:
    t0 = time.perf_counter()
    fn(x)
    COLLECTIVES[kind] += 1
    COLLECTIVES["seconds"] += time.perf_counter() - t0
    return x


def reduce_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """Sum of ``x`` over the "model" axis (every rank gets the same
    bytes); ``x`` itself on a single shard."""
    if mesh is None or mesh.shape.get("model", 1) == 1:
        return x
    return _collective("all_reduce", lambda t: dist.all_reduce(
        t, group=mesh.group), x.contiguous())


def gather_vocab(local_logits: torch.Tensor, mesh, vocab: int
                 ) -> torch.Tensor:
    """Full-vocab logits on every rank from each rank's contiguous
    columns: an ``all_reduce`` of a zero-filled (..., vocab) buffer each
    rank writes its own columns into (exact: x + 0.0 == x).  A
    replicated vocab (every rank computed all ``vocab`` columns) is
    broadcast from the group's first rank instead, so every rank holds
    the same bytes either way."""
    if mesh is None or mesh.shape.get("model", 1) == 1:
        return local_logits
    n = local_logits.shape[-1]
    if n == vocab:
        return _collective("broadcast", lambda t: dist.broadcast(
            t, src=mesh.model_ranks[0], group=mesh.group),
            local_logits.contiguous())
    buf = local_logits.new_zeros(local_logits.shape[:-1] + (vocab,))
    lo = mesh.coords["model"] * n
    buf[..., lo:lo + n] = local_logits
    return _collective("all_reduce", lambda t: dist.all_reduce(
        t, group=mesh.group), buf)
