"""Executors of the port: run planned engine steps on the device —
own port of ``LocalExecutor``, ``ShardedExecutor`` and
``validate_kernel_parallelism`` from ``repro/serve/executor.py``
(DESIGN.md §6, §9, §10, §12).

The engine plans WHAT happens each step (host numpy); the executor
holds the params and the decode state on the device and runs the two
step entries, ``prefill_chunk`` and ``decode_step``, with speculation
(``spec_k > 0``, DESIGN.md §8) the rank-sliced ``draft_step`` and the
``verify_chunk`` window, plus the paged pool's page movers:
``page_copy`` (copy-on-write clones), ``page_restore`` (host-tier bytes
back into the pool) and ``read_page`` (the spill read).  PyTorch runs
eagerly, so there is no jit cache; ``compiled_shapes()`` counts the
distinct (entry, input shapes) pairs run instead, which is what the
reference's jit cache counts.  The contract stays the same: 2 for any
prompt-length mix, dense or paged, +2 with speculation, +1 once a
fixed-width copy batch has run, +1 once a fixed-width restore batch has
run (DESIGN.md §6, §8, §9, §12).

Multi-tenant SV adapters (DESIGN.md §13): the executor holds the
stacked adapter gather bank (``AdapterRegistry.bank()``, on its device)
and every step entry takes a per-slot ``(slots,)`` adapter-id vector;
the bank gather is data, so adapter traffic mixes never add step
shapes.  Without a bank the entries take no ids (``_aids`` is None).

The decode state's KV caches are updated in place by every step and
every page mover.  Recurrent (Mamba, RWKV) leaves are replaced by new
tensors each step, so the executor can zero fresh rows and keep
inactive rows by per-row selects, as the reference does.  ``index`` is
a new tensor each step as well.  So a step run again on the same state
(the engine's fault retry, DESIGN.md §11) writes the same K/V at the
same positions and reads the same recurrent leaves: the state is never
donated (``donates_state`` is False).

``ShardedExecutor`` is rank-balanced tensor and expert parallelism
(DESIGN.md §10), SPMD over ``torch.distributed``: one process per
shard, each running the same host engine (scheduler, allocator, trie,
host tier) on the same inputs, its executor computing only its shard.
The head -> shard plan (``core.prune.rank_balanced_partition``) is
realized by permuting the attention head axes, then every rank keeps
its slices (``parallel.sharding``: heads, ff, experts and vocab over
"model"; a dim that does not divide the degree is replicated).  The KV
pools split along their KV-head axis; page ids stay host-global, so one
allocator and one trie address the same rows on every shard, and the
host tier holds each rank's slice of a page under the same id.  The
step logits are assembled by a collective that leaves the same bytes on
every rank, so every rank's engine makes the same decisions.  The
kernels run on each rank's slices unchanged.

Over a "data" axis of d > 1 replicas (the reference's ``make_host_mesh(
model=tp)`` on d * tp devices) the slot batch splits into d contiguous
blocks (``slots % d == 0``): each replica runs its slots' rows of every
step and the per-slot logits and positions are all-gathered over "data"
for the host scheduler.  Dense state splits by slots.  The paged pools
stay whole on every replica -- page ids are global, and a prefix page
one replica's slot wrote is read by another's -- so each replica writes
every replica's new K/V rows (all-gathered over "data" in the
attention) and runs every ``page_copy`` / ``page_restore``.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.bridge import tree_map
from repro_torch.configs.base import ArchConfig, MIXER_ATTN, MLP_RWKV
from repro_torch.core.prune import (draft_ranks, head_rank_loads,
                                    permute_attention_heads,
                                    rank_balanced_partition)
from repro_torch.kernels import ops
from repro_torch.models import transformer as T
from repro_torch.parallel import sharding as sh
from repro_torch.serve.config import EngineConfig

Params = Dict[str, Any]


def is_recurrent(cfg: ArchConfig) -> bool:
    """Whether the model carries per-slot recurrent state (any
    non-attention mixer, or RWKV's channel-mix token shift)."""
    return any(mixer != MIXER_ATTN or mlp == MLP_RWKV
               for mixer, mlp in cfg.pattern)


def validate_kernel_parallelism(cfg: ArchConfig, tp: int,
                                device: torch.device) -> None:
    """Loud, early rejection of the one (kernel path, parallelism)
    combination that cannot run: recurrent (Mamba, RWKV) mixers carry
    cross-step state per head and their kernels (``mamba_scan``,
    ``wkv6``) have no per-shard form.  The kernel path is the card (a
    CPU tensor runs the plain versions); attention kernels compose with
    any ``tp``."""
    if tp > 1 and torch.device(device).type == "cuda" and is_recurrent(cfg):
        raise ValueError(
            f"the CUDA kernel path with tp={tp} is unsupported on recurrent "
            "(mamba/rwkv) architectures: mamba_scan/wkv6 carry cross-step "
            "recurrent state and have no per-shard form, so the kernel "
            "path cannot run per shard")


# the host tier holds a 16- or 8-bit pool's rows as unsigned integers of
# the same width (numpy has no bfloat16 or float8): a view on the way out
# and on the way back, never a conversion of values; float32 rows stay
# float32
_HOST_VIEWS = {torch.bfloat16: torch.uint16, torch.float16: torch.uint16,
               torch.float8_e4m3fn: torch.uint8,
               torch.float8_e5m2: torch.uint8}


def _kv_leaves(blocks) -> Iterator[torch.Tensor]:
    """Every KV pool leaf in tree order (per pattern entry with a KV
    cache: k, then v) — the order ``read_page`` produces and
    ``page_restore`` consumes, as the reference's pytree traversal
    does."""
    for entry in blocks:
        kv = entry.get("kv", {})
        for name in sorted(kv):
            yield kv[name]


def check_copy_order(src: np.ndarray, dst: np.ndarray) -> None:
    """Refuse a copy batch on which reading every source before writing
    any destination (the kernel and both packages' plain versions) could
    differ from moving the pairs in order (the reference's TPU kernel):
    a chained pair, whose source an earlier pair wrote (``dst[k] ==
    src[i]``, k < i, pair k not a self-copy), and two pairs writing one
    row from different sources.  The engine never makes either: a page
    freed after serving as a source comes back only as a LATER
    destination, and destinations are fresh pages or the sentinel's
    self-copies."""
    if src.shape != dst.shape:
        raise ValueError(f"src {src.shape} / dst {dst.shape}")
    written, source = {}, {}
    for i, (a, b) in enumerate(zip(src.tolist(), dst.tolist())):
        if a in written:
            raise ValueError(f"chained copy batch: pair {i} reads row {a}, "
                             f"which pair {written[a]} writes")
        if source.setdefault(b, a) != a:
            raise ValueError(f"copy batch writes row {b} twice, from rows "
                             f"{source[b]} and {a}")
        if a != b:
            written.setdefault(b, i)


def _map_recurrent(fn, blocks, *others):
    """Apply ``fn(leaf, *other leaves)`` to every non-KV leaf of the
    stacked blocks (same structure in ``others``); KV subtrees of
    ``blocks`` pass through."""
    def walk(node, *rest):
        if isinstance(node, dict):
            return {k: walk(v, *(o[k] for o in rest))
                    for k, v in node.items()}
        return fn(node, *rest)
    return tuple(
        {name: sub if name == "kv" else walk(sub, *(o[name] for o in rest))
         for name, sub in entry.items()}
        for entry, *rest in zip(blocks, *others))


def _rows(flags: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """(B,) bool -> broadcastable to a stacked state leaf (nb, B, ...)."""
    return flags.reshape((1, flags.shape[0]) + (1,) * (leaf.dim() - 2))


def _reset_fresh(state: Params, fresh: torch.Tensor,
                 resume: torch.Tensor) -> Params:
    """Zero freshly admitted (and idle) rows' recurrent state and set
    their ``index`` to ``resume``.  KV caches keep their stale
    contents, masked by the per-slot index until overwritten."""
    index = torch.where(fresh, resume.to(state["index"].dtype),
                        state["index"])
    blocks = _map_recurrent(
        lambda leaf: torch.where(_rows(fresh, leaf), 0, leaf),
        state["blocks"])
    return {"blocks": blocks, "index": index}


def _merge_inactive(old_blocks, new_blocks, active: torch.Tensor):
    """Keep inactive slots' recurrent state across a chunk step: their
    padded window must not advance it (a per-row select, as the
    reference's).  KV caches are taken wholesale: inactive rows' padded
    writes land past their index (masked or overwritten before
    readable) or, paged, in the garbage row."""
    return _map_recurrent(
        lambda new, old: torch.where(_rows(active, new), new, old),
        new_blocks, old_blocks)


def _select_adapters(bank, ids: Optional[torch.Tensor]):
    """Per-slot SV-adapter scales gathered out of the stacked bank:
    ``(nb, A, H, d)`` -> ``(nb, B, H, d)`` per pattern position, an index
    gather on axis 1 (DESIGN.md §13)."""
    if bank is None:
        return None
    return tuple(
        None if entry is None else
        {k: v.index_select(1, ids) for k, v in entry.items()}
        for entry in bank)


class LocalExecutor:
    """Single-device executor — params moved to ``device`` (a no-op where
    they already are)."""

    # a step never consumes its input state: same-input retry is sound
    donates_state = False
    # this rank's mesh under tensor parallelism; None on one device
    shard = None

    def __init__(self, params: Params, cfg: ArchConfig, ecfg: EngineConfig,
                 device: torch.device, *, adapter_bank=None):
        self.cfg = cfg
        self.ecfg = ecfg
        self.device = device
        self.params = params = self._place_params(params)
        # stacked per-tenant SV-adapter scales (AdapterRegistry.bank()),
        # an engine-lifetime constant
        self.abank = self._place_adapters(adapter_bank)
        self._shapes: Set[Tuple] = set()
        self.spec_enabled = ecfg.spec_k > 0 and not is_recurrent(cfg)
        self.draft_rank: Optional[Tuple[int, int]] = None
        self.draft_params = params
        if self.spec_enabled:
            dr = draft_ranks(cfg, ecfg.draft_rank_ratio)
            # a full-width "draft" is the exact model: no slicing
            if dr != (cfg.qk_dim, cfg.vo_dim):
                self.draft_rank = dr
                self.draft_params = T.draft_params(params, cfg, dr)

    def _t(self, a, dtype=None) -> Optional[torch.Tensor]:
        if a is None:
            return None
        return torch.as_tensor(np.asarray(a), device=self.device,
                               dtype=dtype)

    def _place_params(self, params: Params) -> Params:
        return tree_map(lambda t: t.to(self.device), params)

    def _place_adapters(self, bank):
        if bank is None:
            return None
        return tuple(None if entry is None else
                     {k: v.to(self.device) for k, v in entry.items()}
                     for entry in bank)

    # the slots this executor's device rows hold (all on one device)
    local_slots = property(lambda self: self.ecfg.slots)

    def _aids(self, aids) -> Optional[torch.Tensor]:
        """Per-slot adapter ids as a device vector, the identity (0) when
        the engine passes none; None without a bank, so adapter-free
        steps take no ids at all."""
        if self.abank is None:
            return None
        if aids is None:
            return torch.zeros((self.local_slots,), dtype=torch.long,
                               device=self.device)
        return self._t(aids, torch.long)

    def _adapters(self, aids):
        """-> (the step's per-slot adapter trees or None, the ids as
        recorded with the step's shapes)."""
        ids = self._aids(aids)
        return _select_adapters(self.abank, ids), ids

    def _record(self, entry: str, *arrays) -> None:
        self._shapes.add((entry,) + tuple(
            None if a is None else tuple(np.shape(a)) for a in arrays))

    def init_state(self) -> Params:
        return self._new_state(self.device)

    def _new_state(self, device) -> Params:
        cfg, ecfg = self.cfg, self.ecfg
        if ecfg.paged:
            return T.init_decode_state_paged(cfg, ecfg.slots,
                                             ecfg.pool_pages,
                                             ecfg.page_tokens,
                                             device=device)
        state = T.init_decode_state(cfg, ecfg.slots, ecfg.capacity,
                                    device=device)
        # per-slot positions: slots at different depths share one batch
        state["index"] = torch.zeros((ecfg.slots,), dtype=torch.int32,
                                     device=device)
        return state

    def prefill_chunk(self, state, tokens, lengths, fresh, resume, pages,
                      wfloor, aids=None):
        """(slots, C) chunk step -> (last-valid logits, new state).
        ``aids``: the (slots,) adapter ids (every entry takes them)."""
        ad, ids = self._adapters(aids)
        self._record("prefill_chunk", tokens, lengths, fresh, resume, pages,
                     wfloor, ids)
        st = _reset_fresh(state, self._t(fresh, torch.bool),
                          self._t(resume))
        lens = self._t(lengths, torch.int32)
        logits, new = T.prefill_chunk(
            self.params, self.cfg, self._t(tokens, torch.long), st, lens,
            pages=self._t(pages, torch.int32),
            write_floor=self._t(wfloor, torch.int32), adapters=ad,
            shard=self.shard)
        blocks = _merge_inactive(st["blocks"], new["blocks"], lens > 0)
        return logits, {"blocks": blocks, "index": new["index"]}

    def decode_step(self, state, tok, fresh, resume, pages, wfloor,
                    aids=None):
        """(slots,) one-token step -> (logits, new state)."""
        ad, ids = self._adapters(aids)
        self._record("decode_step", tok, fresh, resume, pages, wfloor, ids)
        st = _reset_fresh(state, self._t(fresh, torch.bool),
                          self._t(resume))
        return T.decode_step(self.params, self.cfg,
                             self._t(tok, torch.long), st,
                             pages=self._t(pages, torch.int32),
                             write_floor=self._t(wfloor, torch.int32),
                             adapters=ad, shard=self.shard)

    def draft_step(self, state, tok, pages, wfloor, aids=None):
        """(slots,) one-token DRAFT step at the sliced ranks -> (logits,
        state with ``index`` + 1).  The engine keeps its pre-draft state
        (its ``index``): the draft's K/V writes land in the shared cache
        and the verify step rewrites those positions at full rank."""
        ad, ids = self._adapters(aids)
        self._record("draft_step", tok, pages, wfloor, ids)
        return T.decode_step(self.draft_params, self.cfg,
                             self._t(tok, torch.long), state,
                             pages=self._t(pages, torch.int32),
                             write_floor=self._t(wfloor, torch.int32),
                             draft_rank=self.draft_rank, adapters=ad,
                             shard=self.shard)

    def verify_chunk(self, state, tokens, lengths, pages, wfloor,
                     aids=None):
        """(slots, k+1) verify window -> (logits at every position,
        state with ``index`` + lengths)."""
        ad, ids = self._adapters(aids)
        self._record("verify_chunk", tokens, lengths, pages, wfloor, ids)
        return T.verify_chunk(self.params, self.cfg,
                              self._t(tokens, torch.long), state,
                              self._t(lengths, torch.int32),
                              pages=self._t(pages, torch.int32),
                              write_floor=self._t(wfloor, torch.int32),
                              adapters=ad, shard=self.shard)

    def commit_index(self, state, index) -> Params:
        """Replace the per-slot index with a host value (the engine's
        speculative rollback)."""
        return {"blocks": state["blocks"],
                "index": self._t(np.asarray(index, np.int32), torch.int32)}

    def _page_ids(self, ids, state) -> torch.Tensor:
        """Host page ids -> int32 device tensor, each checked against
        the pool (the kernels do not bound-check their row ids)."""
        ids = np.asarray(ids, np.int32)
        n_rows = next(_kv_leaves(state["blocks"])).shape[1]
        if ids.ndim != 1 or (ids.size and not (
                0 <= ids.min() and ids.max() < n_rows)):
            raise ValueError(f"page ids {ids.tolist()} outside the pool's "
                             f"{n_rows} rows")
        return self._t(ids, torch.int32)

    def page_copy(self, state, src, dst) -> Params:
        """Clone pool rows ``src[i] -> dst[i]`` in every KV leaf, one
        mover call for the batch (copy-on-write; DESIGN.md §9).  In
        place."""
        s, d = self._page_ids(src, state), self._page_ids(dst, state)
        check_copy_order(np.asarray(src, np.int32), np.asarray(dst, np.int32))
        self._record("page_copy", src, dst)
        ops.page_copy_leaves(list(_kv_leaves(state["blocks"])), s, d)
        return state

    def read_page(self, state, page: int) -> List[np.ndarray]:
        """Device->host spill read: pool row ``page`` of every KV leaf,
        as numpy copies, in tree order (``page_restore`` consumes the
        same order); a 16- or 8-bit leaf's row as its uint16 / uint8
        bit patterns.  Blocking: the bytes are on the host before the
        caller frees the page (DESIGN.md §12)."""
        return [leaf[:, page].view(_HOST_VIEWS.get(leaf.dtype, leaf.dtype))
                .to("cpu", copy=True).numpy()
                for leaf in _kv_leaves(state["blocks"])]

    def page_restore(self, state, rows, dst) -> Params:
        """Host->device restore: slab ``rows[leaf][:, i]`` lands in pool
        row ``dst[i]`` of the matching KV leaf.  ``rows`` is a list of
        (n_blocks, W, page_tokens, KV, r) numpy arrays in ``read_page``'s
        tree order and dtypes; short batches arrive zero-padded with
        sentinel dst entries (one fixed W, one shape; zero bits are +0.0
        in every KV dtype).  Each leaf's rows move to the device as they
        are (``_rows_to_device``), then one mover call for the batch.  In
        place."""
        d = self._page_ids(dst, state)
        leaves = list(_kv_leaves(state["blocks"]))
        if len(rows) != len(leaves):
            raise ValueError(f"{len(rows)} row slabs for {len(leaves)} KV "
                             "leaves")
        for leaf, r in zip(leaves, rows):
            if r.dtype.itemsize != leaf.element_size():
                raise ValueError(f"{r.dtype} rows for a {leaf.dtype} pool")
        self._record("page_restore", dst, *rows)
        ops.page_restore_leaves(leaves, self._rows_to_device(rows, leaves),
                                d)
        return state

    def _rows_to_device(self, rows, leaves) -> List[torch.Tensor]:
        """A restore batch's numpy slabs on the device, one pageable copy
        per leaf (measured faster in the engine than packing every leaf
        into one page-locked buffer first; PERF.md §5), each viewed as
        its pool's dtype: bits, never values."""
        return [self._t(r).view(leaf.dtype) for leaf, r in zip(leaves, rows)]

    def plan_salt(self) -> Tuple:
        """Head-partition part of the prefix-trie salt: () on one
        device, as in the reference's LocalExecutor."""
        return ()

    def compiled_shapes(self) -> int:
        """Distinct (entry, input shapes) pairs run so far: 2 (chunk +
        decode) for any prompt-length mix, recurrent models included,
        +2 with speculation (draft + verify), +1 for the copy batch and
        +1 for the restore batch once each has run.  An adapter bank
        adds none: the ids are one fixed-width vector per step."""
        return len(self._shapes)


class ShardedExecutor(LocalExecutor):
    """Rank-balanced tensor- and expert-parallel executor of one rank
    (DESIGN.md §10), on the ``("data", "model")`` mesh of
    ``launch.mesh.make_host_mesh``.

    ``plan``: the KV-head partition; by default the one balancing the
    config's per-head widths (the identity for uniform ranks), or None
    when the degree does not divide the KV heads.  ``_place_params``
    permutes the head axes by it and keeps this rank's slices
    (``param_specs`` under ``serve_rules``, made coherent: an attention
    block's heads split only with its KV heads, the rank clamps
    ``rank_qk`` / ``rank_vo`` split with them, an MLP's or a shared
    expert's ff leaves split together or not at all, and recurrent
    (Mamba, RWKV) leaves replicate).  The adapter bank is permuted by
    ``q_perm`` and split on its head axis like the weights it scales;
    the pools are built at this rank's KV-head slice with every page
    row, the sentinel included.  Greedy streams of attention-only models
    equal tp = 1's up to summation order (the partial sums of split
    heads, ff and experts are added across ranks).  Over "data" replicas
    (d > 1) each runs its block of ``slots / d`` slots (see the module
    doc)."""

    def __init__(self, params: Params, cfg: ArchConfig, ecfg: EngineConfig,
                 mesh, *, plan=None, adapter_bank=None):
        tp = mesh.shape["model"]
        validate_kernel_parallelism(cfg, tp, mesh.device)
        self.data = mesh.shape.get("data", 1)
        if ecfg.slots % self.data:
            raise ValueError(
                f"{ecfg.slots} slots do not split over {self.data} data "
                "replicas: give EngineConfig.slots a multiple of the data "
                "extent")
        n = ecfg.slots // self.data
        self.rows = slice(mesh.coords.get("data", 0) * n,
                          (mesh.coords.get("data", 0) + 1) * n)
        self.data_group = sh.axis_group(mesh, "data")[0]
        has_attn = any(m == MIXER_ATTN for m, _ in cfg.pattern)
        if plan is None and has_attn and cfg.n_kv_heads % tp == 0:
            plan = rank_balanced_partition(head_rank_loads(cfg), tp,
                                           group=cfg.q_per_kv)
        self.mesh = self.shard = mesh
        self.plan = plan
        self.tp = tp
        # split KV heads <=> the attention heads split (kernel_axes)
        self.heads_split = sh.kernel_axes(
            mesh, batch=ecfg.slots, kv_heads=cfg.n_kv_heads)[1] is not None
        super().__init__(params, cfg, ecfg, mesh.device,
                         adapter_bank=adapter_bank)

    def serve_specs(self, params: Params) -> Params:
        """The reference's ``param_specs(params, mesh, serve_rules())``,
        made coherent for one rank's computation (see the class doc)."""
        specs = sh.param_specs(params, self.mesh, sh.serve_rules())
        rep = sh.Spec()

        def whole(tree):
            return sh.map_with_names(lambda _, s: rep, tree)

        def together(tree, names):
            """Leaves ``names`` of ``tree`` all split, or all replicated."""
            present = [n for n in names if n in tree]
            if all(sh.split_dims(tree[n]) for n in present):
                return tree
            return dict(tree, **{n: rep for n in present})

        blocks = []
        for entry in specs["blocks"]:
            entry = dict(entry)
            for name in entry:
                if name in ("mamba", "rwkv_time", "rwkv_chan"):
                    entry[name] = whole(entry[name])
                elif name == "attn":
                    attn = entry["attn"]
                    if not self.heads_split:
                        entry["attn"] = whole(attn)
                    else:
                        head = sh.Spec((None, "model"))     # (n_blocks, KV)
                        entry["attn"] = dict(attn, **{
                            n: head for n in ("rank_qk", "rank_vo")
                            if n in attn})
                elif name == "mlp":
                    entry["mlp"] = together(entry["mlp"], list(entry["mlp"]))
                elif name == "moe":
                    moe = together(entry["moe"], ("w_up", "w_gate", "w_down"))
                    entry["moe"] = together(moe, ("shared_up", "shared_gate",
                                                  "shared_down"))
            blocks.append(entry)
        return dict(specs, blocks=tuple(blocks))

    def _place_params(self, params: Params) -> Params:
        if self.plan is not None and not self.plan.identity:
            params = permute_attention_heads(params, self.cfg, self.plan)
        local = sh.shard_tree(params, self.serve_specs(params), self.mesh)
        return super()._place_params(local)

    def _place_adapters(self, bank):
        """The ``(nb, A, H, d)`` bank permuted by the plan's ``q_perm`` and
        split on its head axis when the heads are."""
        if bank is None:
            return None
        spec = sh.Spec((None, None, "model") if self.heads_split else ())
        out = []
        for entry in bank:
            if entry is not None:
                if self.plan is not None and not self.plan.identity:
                    entry = {k: v.index_select(2, torch.as_tensor(
                        self.plan.q_perm, device=v.device))
                        for k, v in entry.items()}
                entry = {k: sh.local_slice(v, spec, self.mesh)
                         for k, v in entry.items()}
            out.append(entry)
        return super()._place_adapters(tuple(out))

    def init_state(self) -> Params:
        """This rank's pools: the full state's layout planned on the meta
        device (no memory), ``serve_state_specs`` applied, zeros at the
        local shapes on the rank's device."""
        full = self._new_state(torch.device("meta"))
        self.state_specs = sh.serve_state_specs(full, self.mesh,
                                                paged=self.ecfg.paged)
        local = sh.shard_tree(full, self.state_specs, self.mesh)
        return tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype,
                                              device=self.device), local)

    # -- data replicas: each runs its slots' rows ----------------------
    local_slots = property(lambda self: self.ecfg.slots // self.data)

    def _mine(self, a):
        """This replica's rows of a host per-slot array (None stays)."""
        return None if a is None or self.data == 1 else np.asarray(a)[
            self.rows]

    def _gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every replica's rows of a per-slot tensor, in slot order."""
        return sh.all_gather_dim(t.contiguous(), 0, self.data_group,
                                 self.data)

    def _replicas(self, entry, state, per_slot, rest=()):
        """Run ``entry`` (a LocalExecutor step) on this replica's rows:
        its rows of ``per_slot`` host arrays and of the state's index,
        the other arguments as given; the logits and the new index
        gathered over "data"."""
        if self.data == 1:
            return entry(state, *per_slot, *rest)
        local = {"blocks": state["blocks"],
                 "index": state["index"][self.rows]}
        logits, new = entry(local, *(self._mine(a) for a in per_slot),
                            *rest)
        return self._gather(logits), {"blocks": new["blocks"],
                                      "index": self._gather(new["index"])}

    def prefill_chunk(self, state, tokens, lengths, fresh, resume, pages,
                      wfloor, aids=None):
        return self._replicas(super().prefill_chunk, state,
                              (tokens, lengths, fresh, resume, pages,
                               wfloor, aids))

    def decode_step(self, state, tok, fresh, resume, pages, wfloor,
                    aids=None):
        return self._replicas(super().decode_step, state,
                              (tok, fresh, resume, pages, wfloor, aids))

    def draft_step(self, state, tok, pages, wfloor, aids=None):
        return self._replicas(super().draft_step, state,
                              (tok, pages, wfloor, aids))

    def verify_chunk(self, state, tokens, lengths, pages, wfloor,
                     aids=None):
        return self._replicas(super().verify_chunk, state,
                              (tokens, lengths, pages, wfloor, aids))

    def plan_salt(self) -> Tuple:
        """The head layout, folded into the prefix-trie salt."""
        if self.plan is not None:
            return self.plan.salt()
        return ("tp", self.tp)

    def shard_load_fractions(self) -> List[float]:
        """Per-shard fraction of the total per-token KV bytes / pruned
        attention FLOPs: what the partition equalized."""
        if self.plan is None:
            return [1.0 / self.tp] * self.tp
        tot = sum(self.plan.loads) or 1.0
        return [ld / tot for ld in self.plan.loads]
