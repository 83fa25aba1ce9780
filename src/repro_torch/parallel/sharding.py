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
``shard_tree`` takes this rank's contiguous slice of every split leaf.

Training's half: ``param_specs`` under the default ``ShardingRules``
is FSDP + tensor parallel (d_model over "data", heads / ff / experts /
vocab over "model"); ``data_specs`` splits the batch over ("pod",
"data"); ``decode_state_specs`` and ``opt_specs`` are the reference's.

The collectives (``torch.distributed``, any backend: gloo runs them on
CUDA tensors too, through host memory) are autograd-aware where the
sharded backward needs them, and under ``no_grad`` (serving) issue
exactly what they issue without a graph:

  ``reduce_model``    all_reduce over "model" forward, identity backward
                      (a row-parallel output; every rank then holds the
                      same bytes and the same gradient);
  ``copy_to_model``   identity forward, all_reduce over "model"
                      backward (the input of a tensor-parallel region:
                      each rank's partial input gradient is summed, so
                      replicated leaves before it get whole gradients);
  ``gather_vocab``    the full-vocab logits; backward, this rank's
                      columns of the gradient;
  ``gather_fsdp``     a leaf's d_model shards gathered over "data";
                      backward, the gradient reduce-scattered (summed
                      over "data", this rank's shard kept);
  ``reduce_batch``    a sum over the batch axes forward, identity
                      backward (global token counts and batch means).

``COLLECTIVES`` counts every collective by kind and the host seconds
spent in them; ``COLLECTIVE_LOG`` tallies each one by (kind, result
bytes, group size), as a compiled HLO line prints a collective, which
``parallel.hlo.collective_bytes`` turns into operand bytes.

The sequence-split decode cache of training's rules (``KV_SEQ`` over
"model"): ``seq_window`` is this rank's window of cache positions and
``combine_seq_partials`` merges the windows' flash-decoding partials
(context and log-sum-exp) into every head's context -- the max / sum
combines GSPMD inserts for the reference.
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


def data_specs(mesh, rules: Optional[ShardingRules] = None,
               global_batch: Optional[int] = None) -> Spec:
    """(tokens, labels) spec: the batch over ("pod", "data");
    replicated when the batch does not divide (long_500k decode has
    batch 1)."""
    rules = rules or ShardingRules()
    b = rules.mesh_axes(BATCH, mesh)
    if (b is not None and global_batch is not None
            and global_batch % _extent(b, mesh) != 0):
        b = None
    return Spec((b, None))


def decode_state_specs(state: Params, mesh,
                       rules: Optional[ShardingRules] = None) -> Params:
    """Training's decode-state tree: KV caches (nb, B, T, KV, d) split
    batch over ("pod", "data") and the cache sequence over "model";
    Mamba / RWKV states split batch and the inner dim over "model";
    ``index`` replicates."""
    rules = rules or ShardingRules()

    def visit(names, leaf):
        if "kv" in names:                         # (nb, B, T, KV, d)
            axes = (None, BATCH, KV_SEQ, None, None)
        elif "mamba" in names and names[-1] == "ssm":   # (nb, B, dI, dS)
            axes = (None, BATCH, FF, None)
        elif "mamba" in names:                    # conv (nb, B, dc-1, dI)
            axes = (None, BATCH, None, FF)
        elif names[-1] == "wkv":                  # (nb, B, H, d, d)
            axes = (None, BATCH, HEADS, None, None)
        elif names[-1] == "last_x":               # (nb, B, D)
            axes = (None, BATCH, None)
        elif names[-1] == "index":
            return Spec()
        else:
            axes = (None, BATCH) + (None,) * (leaf.dim() - 2)
        return rules.spec(_fit(axes, leaf.dim()), leaf.shape, mesh)

    return map_with_names(visit, state)


def opt_specs(param_spec_tree: Params) -> Params:
    """Optimizer moments inherit the param sharding; scalars replicate
    (the step places ``{"m": ..., "v": ..., "step": Spec()}``)."""
    return param_spec_tree


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


def split_axes(spec) -> Tuple[str, ...]:
    """Every mesh axis ``spec`` splits over, in dim order."""
    return tuple(a for _, m in split_dims(spec)
                 for a in (m if isinstance(m, tuple) else (m,)))


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


def map_with_specs(fn, tree, specs):
    """``fn(leaf, spec)`` over the leaves of ``tree`` (dicts and tuples;
    ``None`` leaves pass through), the spec at the same place in
    ``specs``."""
    if isinstance(tree, dict):
        return {k: map_with_specs(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(map_with_specs(fn, v, s) for v, s in zip(tree, specs))
    return None if tree is None else fn(tree, specs)


def specs_by_path(tree, specs) -> Dict[str, Any]:
    """{keystr path: spec} of every non-``None`` leaf of ``tree``."""
    out: Dict[str, Any] = {}

    def walk(node, spec, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, spec[k], f"{path}[{k!r}]")
        elif isinstance(node, (tuple, list)):
            for i, (v, s) in enumerate(zip(node, spec)):
                walk(v, s, f"{path}[{i}]")
        elif node is not None:
            out[path] = spec
    walk(tree, specs, "")
    return out


def shard_tree(tree, specs, mesh):
    """``tree`` with every split leaf replaced by this rank's slice."""
    return map_with_specs(lambda t, spec: local_slice(t, spec, mesh), tree,
                          specs)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

COLLECTIVES = {"all_reduce": 0, "broadcast": 0, "all_gather": 0,
               "reduce_scatter": 0, "send": 0, "recv": 0, "seconds": 0.0}
# (kind, result bytes, group size) -> count
COLLECTIVE_LOG: Dict[Tuple[str, int, int], int] = {}


def reset_collectives() -> None:
    COLLECTIVES.update({k: 0 for k in COLLECTIVES}, seconds=0.0)
    COLLECTIVE_LOG.clear()


def log_collective(kind: str, result: torch.Tensor, group_size: int
                   ) -> None:
    """Count one collective of ``kind`` whose result on this rank is
    ``result``, over a group of ``group_size`` ranks."""
    key = (kind, result.numel() * result.element_size(), int(group_size))
    COLLECTIVE_LOG[key] = COLLECTIVE_LOG.get(key, 0) + 1


def timed(kind: str, fn, result: Optional[torch.Tensor] = None,
          group_size: int = 1) -> None:
    """Run the collective ``fn()``, counted under ``kind`` (and logged
    with its ``result`` tensor and group size when given)."""
    t0 = time.perf_counter()
    fn()
    COLLECTIVES[kind] += 1
    COLLECTIVES["seconds"] += time.perf_counter() - t0
    if result is not None:
        log_collective(kind, result, group_size)


def _group_size(group) -> int:
    return dist.get_world_size(group) if group is not None else \
        dist.get_world_size()


def _broadcast(x: torch.Tensor, mesh) -> torch.Tensor:
    """In-place broadcast of a contiguous ``x`` from the "model" group's
    first rank, counted."""
    timed("broadcast", lambda: dist.broadcast(
        x, src=mesh.model_ranks[0], group=mesh.group), x,
        mesh.shape.get("model", 1))
    return x


def axis_group(mesh, name: str):
    """(process group, extent) of ``mesh``'s axis ``name``; extent 1
    when the mesh has no such axis."""
    n = mesh.shape.get(name, 1) if mesh is not None else 1
    if n == 1:
        return None, 1
    return (mesh.group if name == "model" else mesh.groups[name]), n


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM
               ) -> torch.Tensor:
    """In-place ``all_reduce`` of a contiguous ``x``, counted."""
    timed("all_reduce", lambda: dist.all_reduce(x, op=op, group=group), x,
          _group_size(group))
    return x


def _grad_on(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


# the fused single-tensor collectives, by their newer names where torch
# has them (gloo runs both on CUDA tensors too)
_ALL_GATHER = getattr(dist, "all_gather_single",
                      getattr(dist, "all_gather_into_tensor", None))
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single",
                          getattr(dist, "reduce_scatter_tensor", None))


def all_gather_dim(x: torch.Tensor, dim: int, group, n: int
                   ) -> torch.Tensor:
    """The ``n`` members' ``x`` concatenated along ``dim`` in group-rank
    order (no graph).  A 1-byte float (a float8 KV cache's rows) crosses
    as its uint8 view: gloo has no float8."""
    src = x.movedim(dim, 0).contiguous()
    if src.is_floating_point() and src.element_size() == 1:
        src = src.view(torch.uint8)
    out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
    timed("all_gather", lambda: _ALL_GATHER(out, src, group=group), out, n)
    return out.view(x.dtype).movedim(0, dim)


def reduce_scatter_dim(x: torch.Tensor, dim: int, group, n: int
                       ) -> torch.Tensor:
    """The sum of the members' ``x`` over the group, split along ``dim``
    into ``n`` blocks: this member's block (no graph)."""
    src = x.movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
    timed("reduce_scatter", lambda: _REDUCE_SCATTER(out, src, group=group),
          out, n)
    return out.movedim(0, dim).contiguous()


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group forward; the gradient passes through unchanged
    (every member's output is the same value, used on every member)."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyIn(torch.autograd.Function):
    """Identity forward; the members' gradients summed backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` forward; reduce-scatter backward."""

    @staticmethod
    def forward(ctx, x, dim, group, n):
        ctx.dim, ctx.group, ctx.n = dim, group, n
        return all_gather_dim(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        return (reduce_scatter_dim(g, ctx.dim, ctx.group, ctx.n), None,
                None, None)


class _Columns(torch.autograd.Function):
    """``gather_vocab`` of split columns: this rank's columns of the
    gradient backward."""

    @staticmethod
    def forward(ctx, local, mesh, vocab):
        n = local.shape[-1]
        ctx.lo, ctx.n = mesh.coords["model"] * n, n
        buf = local.new_zeros(local.shape[:-1] + (vocab,))
        buf[..., ctx.lo:ctx.lo + n] = local
        return all_reduce(buf, mesh.group)

    @staticmethod
    def backward(ctx, g):
        return g[..., ctx.lo:ctx.lo + ctx.n], None, None


class _Broadcast(torch.autograd.Function):
    """``gather_vocab`` of a replicated vocab: every rank computed the
    same logits, so each keeps its own gradient."""

    @staticmethod
    def forward(ctx, local, mesh):
        return _broadcast(local.contiguous().clone(), mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


def reduce_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """Sum of ``x`` over the "model" axis (every rank gets the same
    bytes); ``x`` itself on a single shard.  Under autograd the
    gradient passes through unchanged."""
    if mesh is None or mesh.shape.get("model", 1) == 1:
        return x
    if _grad_on(x):
        return _AllReduceSum.apply(x, mesh.group)
    return all_reduce(x.contiguous(), mesh.group)


def copy_to_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """The input of a tensor-parallel region: ``x`` itself forward; its
    gradient summed over "model" backward.  ``x`` untouched (no
    collective) on a single shard or without a graph."""
    if mesh is None or mesh.shape.get("model", 1) == 1 or not _grad_on(x):
        return x
    return _CopyIn.apply(x, mesh.group)


def batch_extent(mesh) -> int:
    """Ranks the batch splits over: the product of the "pod" and "data"
    extents (1 without a mesh)."""
    if mesh is None:
        return 1
    return mesh.shape.get("pod", 1) * mesh.shape.get("data", 1)


def reduce_batch(x: torch.Tensor, mesh) -> torch.Tensor:
    """Sum of ``x`` over the batch axes ("data", then "pod"): every
    rank gets the same bytes; the gradient passes through unchanged
    (each rank's share of a global mean differentiates locally, and the
    step sums the ranks' gradients)."""
    for name in ("data", "pod"):
        group, n = axis_group(mesh, name)
        if n > 1:
            x = (_AllReduceSum.apply(x, group) if _grad_on(x)
                 else all_reduce(x.contiguous().clone(), group))
    return x


def gather_vocab(local_logits: torch.Tensor, mesh, vocab: int
                 ) -> torch.Tensor:
    """Full-vocab logits on every rank from each rank's contiguous
    columns: an ``all_reduce`` of a zero-filled (..., vocab) buffer each
    rank writes its own columns into (exact: x + 0.0 == x).  A
    replicated vocab (every rank computed all ``vocab`` columns) is
    broadcast from the group's first rank instead, so every rank holds
    the same bytes either way.  Under autograd each rank keeps the
    gradient of its own columns (all of them when replicated)."""
    if mesh is None or mesh.shape.get("model", 1) == 1:
        return local_logits
    n = local_logits.shape[-1]
    if _grad_on(local_logits):
        if n == vocab:
            return _Broadcast.apply(local_logits, mesh)
        return _Columns.apply(local_logits, mesh, vocab)
    if n == vocab:
        return _broadcast(local_logits.contiguous(), mesh)
    buf = local_logits.new_zeros(local_logits.shape[:-1] + (vocab,))
    lo = mesh.coords["model"] * n
    buf[..., lo:lo + n] = local_logits
    return all_reduce(buf, mesh.group)


def _gathered_axes(spec, keep_model: bool):
    """(dim, axis) pairs to gather, innermost axis first per dim (the
    inverse of ``local_slice``'s row-major split)."""
    out = []
    for d, m in split_dims(spec):
        for a in reversed(m if isinstance(m, tuple) else (m,)):
            if not (keep_model and a == "model"):
                out.append((d, a))
    return out


def gather_fsdp(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """``t`` with its FSDP split undone: every dim split over an axis
    other than "model" all-gathered over it (tensor-parallel splits
    stay).  Under autograd the gradient is reduce-scattered back."""
    if mesh is None or spec is None:
        return t
    for d, a in _gathered_axes(spec, keep_model=True):
        group, n = axis_group(mesh, a)
        if n == 1:
            continue
        t = (_Gather.apply(t, d, group, n) if _grad_on(t)
             else all_gather_dim(t, d, group, n))
    return t


def gather_full(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The whole leaf from this rank's slice (every split dim gathered;
    no graph): the inverse of ``local_slice``."""
    if mesh is None or spec is None:
        return t
    for d, a in _gathered_axes(spec, keep_model=False):
        group, n = axis_group(mesh, a)
        if n > 1:
            t = all_gather_dim(t, d, group, n)
    return t


# ---------------------------------------------------------------------------
# the sequence-split decode cache, and whole recurrent layers
# ---------------------------------------------------------------------------

def model_extent(mesh) -> int:
    return 1 if mesh is None else mesh.shape.get("model", 1)


def seq_window(capacity: int, mesh) -> Tuple[int, int]:
    """(lo, size): this rank's window ``[r * T / m, (r + 1) * T / m)`` of
    a dense cache of ``capacity`` positions split along its sequence
    over "model" (r this rank's "model" coordinate, m its extent)."""
    m = model_extent(mesh)
    if capacity % m:
        raise ValueError(f"a cache of {capacity} positions does not split "
                         f"over {m} ranks")
    size = capacity // m
    return mesh.coords.get("model", 0) * size, size


def combine_seq_partials(out: torch.Tensor, lse: torch.Tensor, mesh
                         ) -> torch.Tensor:
    """Every window's flash-decoding partials merged over "model": ``out``
    (B, H, dv), this rank's context over its window in the compute dtype
    (merged in float32), and ``lse`` (B, H) its log-sum-exp of the
    scaled logits (-inf for an empty window) -> the context over the
    union of the windows.  A MAX
    all-reduce of lse, then one SUM all-reduce of ``exp(lse - max) *
    out`` beside the weights ``exp(lse - max)``; a row whose windows are
    all empty gives 0, as the kernels' clamped denominator does."""
    group, n = axis_group(mesh, "model")
    if n == 1:
        return out
    mx = all_reduce(lse.contiguous().clone(), group, op=dist.ReduceOp.MAX)
    mx = torch.where(torch.isinf(mx), torch.zeros_like(mx), mx)
    w = torch.exp(lse - mx)                                 # (B, H)
    both = torch.cat([out * w[..., None], w[..., None]], dim=-1)
    both = all_reduce(both.contiguous(), group)
    return both[..., :-1] / both[..., -1:].clamp_min(1e-30)


def model_spec(spec) -> Spec:
    """``spec`` with only its "model" splits kept."""
    return Spec(m if m == "model" else None for m in (spec or ()))


class _GatherWhole(torch.autograd.Function):
    """All-gather along ``dim`` forward for a computation every member
    then runs whole: each member already holds the whole gradient, so
    the backward keeps this member's block of it (no sum)."""

    @staticmethod
    def forward(ctx, x, dim, group, n, coord):
        ctx.dim, ctx.size, ctx.coord = dim, x.shape[dim], coord
        return all_gather_dim(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, ctx.coord * ctx.size, ctx.size),
                None, None, None, None)


def gather_model_dims(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """``t`` with every dim that ``spec`` splits over "model" gathered
    (other splits stay), for a layer every "model" rank runs whole;
    under autograd each rank keeps its block of the (whole, identical)
    gradient."""
    group, n = axis_group(mesh, "model")
    if n == 1 or spec is None:
        return t
    for d, m in split_dims(spec):
        if m == "model":
            t = (_GatherWhole.apply(t, d, group, n, mesh.coords["model"])
                 if _grad_on(t) else all_gather_dim(t, d, group, n))
    return t
