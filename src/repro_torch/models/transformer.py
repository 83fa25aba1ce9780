"""Config-driven decoder of the port — own port of
``repro/models/transformer.py`` for the attention + dense-MLP pattern,
the attention-free RWKV-6 pattern and jamba's hybrid patterns (Mamba
or attention mixers, dense or MoE MLPs; DESIGN.md §1, §5, §6).  The
modality frontends are the reference's stub: ``forward``,
``train_forward`` and ``prefill`` take precomputed (B, F, D) frame or
patch embeddings, placed before the text tokens; there is nothing to
initialise.

Parameters keep the reference's stacked layout: ``params["blocks"]`` is
a tuple with one tree per pattern position whose leaves carry a leading
``n_blocks`` axis.  The reference's ``lax.scan`` over blocks becomes a
Python loop over layers, each reading its layer's slice of the stacked
leaves.  Decode states are stacked the same way.  KV caches are updated
in place; recurrent leaves (RWKV's ``time``/``chan`` trees, Mamba's
``conv``/``ssm``) are functional, as in the reference: a step returns
new stacked tensors and leaves the old ones intact, so the executor can
keep idle slots' rows.  ``forward`` returns the MoE aux losses summed
over layers (zeros without MoE), as the reference does.

The serving steps (``prefill_chunk``, ``decode_step``, ``verify_chunk``)
take ``shard``: ``None`` on one device, or this rank's
``launch.mesh.Mesh`` under tensor parallelism (DESIGN.md §10), where the
params and state are the rank's slices (``serve.executor.
ShardedExecutor``).  ``prefill`` and ``decode_step`` also serve under
training's rules (``train.step.make_serve_step``): with ``specs`` (the
param spec tree) and ``state_specs`` (``decode_state_specs``) each
layer's FSDP-split leaves are gathered on use, as in ``train_forward``,
each rank runs its batch rows, and a dense cache split along its
sequence over "model" is served by ``layers.SeqSplit``.  Recurrent
(Mamba, RWKV) layers run whole on every "model" rank: their
model-split leaves and state are gathered and the new state re-split.
A vocab-split embedding is a masked local lookup summed over "model";
the logits are assembled by ``parallel.sharding.gather_vocab``, so
every rank holds the same bytes.

Entry points ``init_lm_params`` and ``forward`` run on ``cuda`` unless
the caller passes ``device="cpu"`` (or ``"meta"``: shapes only, for the
dry-run); the decode-state functions run where the state and params
live.

``forward`` scores under ``no_grad`` through the hand-written kernels.
``train_forward`` runs the same layer loop under autograd: each layer
under ``torch.utils.checkpoint`` with ``remat`` (the reference's
``jax.checkpoint``; ``remat_group`` g > 1 checkpoints g blocks of layers
per call when it divides ``n_blocks``), and, by its explicit
``plain_attention`` argument,
the plain attention and scans, as the reference trains through its XLA
path.  Stacked leaves are split per layer with ``unbind``, so each leaf
gets one gradient, stacked once.  Sharded training passes ``shard``
(this rank's mesh) and ``specs`` (the param spec tree of
``parallel.sharding.param_specs``): the params are this rank's slices;
each layer's FSDP-split leaves are gathered inside its remat'ed body
(so the backward gathers them again and reduce-scatters their
gradients), and every tensor-parallel region starts with
``copy_to_model``, whose backward sums the input gradient over
"model"; recurrent (Mamba, RWKV) layers run whole on every "model"
rank, their model-split leaves gathered.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from repro_torch.bridge import tree_map
from repro_torch.configs.base import (ArchConfig, MIXER_ATTN, MIXER_MAMBA,
                                      MIXER_RWKV, MLP_DENSE, MLP_MOE,
                                      MLP_RWKV)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import moe as MOE
from repro_torch.models import rwkv as R
from repro_torch.models.moe import AUX_KEYS
from repro_torch.parallel.sharding import (Spec, copy_to_model,
                                           gather_fsdp, gather_model_dims,
                                           gather_vocab, local_slice,
                                           map_with_names, model_extent,
                                           model_spec, reduce_model,
                                           seq_window)

Params = Dict[str, Any]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16,
           "float8_e4m3fn": torch.float8_e4m3fn,
           "float8_e5m2": torch.float8_e5m2}


def _dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


_PORTED = ((MIXER_ATTN, MLP_DENSE), (MIXER_RWKV, MLP_RWKV),
           (MIXER_MAMBA, MLP_DENSE), (MIXER_MAMBA, MLP_MOE),
           (MIXER_ATTN, MLP_MOE))


def _check_ported(cfg: ArchConfig) -> None:
    for mixer, mlp in cfg.pattern:
        if (mixer, mlp) not in _PORTED:
            raise NotImplementedError(
                f"{cfg.name}: pattern ({mixer}, {mlp}) is not ported yet "
                "(attention or Mamba with a dense or MoE MLP, and RWKV-6 "
                "time + channel mix)")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_lm_params(cfg: ArchConfig, seed: int = 0, *,
                   device: DeviceLike = None) -> Params:
    """Random weights from ``seed`` through the port's own
    ``torch.Generator`` — the reference's distributions (N(0, 0.02)
    embeddings, N(0, 0.01) positions, N(0, 1/fan_in) projections, unit
    norms), not its random bits."""
    _check_ported(cfg)
    dev = resolve_device(device)
    dtype = _dtype(cfg.param_dtype)
    gen = None                  # meta: shapes only, nothing to draw
    if dev.type != "meta":
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))

    def normal(shape, std):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    params: Params = {
        "embed": normal((cfg.padded_vocab, cfg.d_model), 0.02),
        "final_norm": L.init_norm(cfg, dtype=dtype, device=dev),
    }
    if cfg.learned_pos:
        params["pos_embed"] = normal((cfg.max_position, cfg.d_model), 0.01)
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(
            gen, (cfg.d_model, cfg.padded_vocab), cfg.d_model, dtype=dtype,
            device=dev)
    kw = dict(dtype=dtype, device=dev)

    def layer(mixer, mlp):
        p = {"norm1": L.init_norm(cfg, **kw), "norm2": L.init_norm(cfg, **kw)}
        if mixer == MIXER_ATTN:
            p["attn"] = L.init_attention(gen, cfg, **kw)
        elif mixer == MIXER_MAMBA:
            p["mamba"] = M.init_mamba(gen, cfg, **kw)
        else:
            p["rwkv_time"] = R.init_rwkv_timemix(gen, cfg, **kw)
        if mlp == MLP_DENSE:
            p["mlp"] = L.init_mlp(gen, cfg, **kw)
        elif mlp == MLP_MOE:
            p["moe"] = MOE.init_moe(gen, cfg, **kw)
        else:
            p["rwkv_chan"] = R.init_rwkv_chanmix(gen, cfg, **kw)
        return p

    params["blocks"] = tuple(
        _stack_built(lambda m=mixer, f=mlp: layer(m, f), cfg.n_blocks)
        for mixer, mlp in cfg.pattern)
    return params


def _stack_built(make, n: int):
    """Stack the ``n`` trees that ``make()`` returns, in call order, into
    preallocated leaves one tree at a time: the peak is the stack plus
    one tree (phi3-medium-14b's 40 layers are 55 GB).  One tree gains the
    axis as a view (one jamba period is 53 GB)."""
    first = make()
    if n == 1:
        return _stack([first])
    out = tree_map(lambda t: t.new_empty((n,) + tuple(t.shape)), first)
    tree_map(lambda d, t: d[0].copy_(t), out, first)
    del first
    for i in range(1, n):
        tree_map(lambda d, t, i=i: d[i].copy_(t), out, make())
    return out


def _stack(trees):
    """List of identical trees -> one tree with a leading stacked axis
    (a list of empty dicts -> an empty dict).  One tree gains the axis
    as a view, so a one-block model is never copied (one jamba period
    is 53 GB)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if len(trees) == 1:
        return first.unsqueeze(0)
    return torch.stack(trees)


def layer_slice(tree, i: int):
    """Block ``i``'s view of a stacked tree (no copy)."""
    return tree_map(lambda a: a[i], tree)


# ---------------------------------------------------------------------------
# layer application
# ---------------------------------------------------------------------------

def _apply_layer(lp: Params, cfg: ArchConfig, mixer: str, mlp: str,
                 x: torch.Tensor, *, positions, state: Optional[Params],
                 cache_index, pages=None, write_floor=None, plain=False,
                 rope: Optional[L.Rope] = None, draft_rank=None,
                 adapter=None, shard=None, seq=None,
                 ) -> Tuple[torch.Tensor, Params, Dict]:
    """One layer -> (x, its new recurrent state, its MoE aux losses).
    The state is ``{}`` for attention, whose KV cache is written in
    place, ``{"mamba"}`` for Mamba and ``{"time", "chan"}`` for RWKV when
    ``state`` is given (``{}`` without it); the aux dict is empty
    without MoE.  ``plain``: the plain attention and scans (training).
    ``draft_rank``: the attention's sliced draft widths (DESIGN.md §8);
    ``adapter``: this layer's per-slot SV-adapter scales (DESIGN.md
    §13); ``shard``: this rank's mesh (tensor parallelism, §10);
    ``seq``: the attention's sequence-split cache (``layers.SeqSplit``)."""
    h = L.apply_norm(lp["norm1"], cfg, x)
    new: Params = {}
    if mixer == MIXER_ATTN:
        y, _ = L.attention(lp["attn"], cfg, h, positions=positions,
                           rope=rope, kv_cache=state["kv"] if state is not None
                           else None, cache_index=cache_index,
                           page_table=pages, write_floor=write_floor,
                           draft_rank=draft_rank, adapter=adapter,
                           plain=plain, shard=shard, seq=seq)
    elif mixer == MIXER_MAMBA:
        y, ns = M.mamba_forward(
            lp["mamba"], cfg, h,
            state=state["mamba"] if state is not None else None,
            plain=plain)
        if state is not None:
            new["mamba"] = ns
    else:
        y, ns = R.rwkv_timemix_forward(
            lp["rwkv_time"], cfg, h,
            state=state["time"] if state is not None else None,
            plain=plain)
        if state is not None:
            new["time"] = ns
    x = x + y
    h = L.apply_norm(lp["norm2"], cfg, x)
    aux: Dict = {}
    if mlp == MLP_DENSE:
        y = L.apply_mlp(lp["mlp"], cfg, h, shard)
    elif mlp == MLP_MOE:
        y, aux = MOE.apply_moe(lp["moe"], cfg, h, shard)
    else:
        y, cs = R.rwkv_chanmix_forward(
            lp["rwkv_chan"], cfg, h,
            state=state["chan"] if state is not None else None)
        if state is not None:
            new["chan"] = cs
    return x + y, new, aux


def _embed(params, cfg, tokens, positions, frontend_embeds=None,
           shard=None):
    """Token embeddings, after the frontend's (B, F, D) embeddings when
    given, plus learned or (musicgen's) sinusoidal absolute positions;
    ``positions`` (B, F + S) or (1, F + S) cover both.  A vocab-split
    table (``shard``) looks up the ids in this rank's rows, zeros the
    rest and sums over "model": one rank holds each row, so the sum is
    that row exactly."""
    dtype = _dtype(cfg.compute_dtype)
    emb = params["embed"]
    n = emb.shape[0]
    if shard is not None and n != cfg.padded_vocab:
        ids = tokens.long() - shard.rank * n
        mine = (ids >= 0) & (ids < n)
        x = emb[ids.clamp(0, n - 1)].to(dtype)
        x = reduce_model(torch.where(mine[..., None], x, 0), shard)
    else:
        x = emb[tokens.long()].to(dtype)
    if frontend_embeds is not None:
        x = torch.cat([torch.as_tensor(frontend_embeds,
                                       device=x.device).to(dtype), x], dim=1)
    if cfg.learned_pos:
        # the reference's gather clamps out-of-range positions (only
        # padding columns reach them); clamp explicitly
        pos = positions.long().clamp(0, cfg.max_position - 1)
        x = x + params["pos_embed"][pos].to(dtype)
    elif not cfg.rope and cfg.family == "audio":
        x = x + L.sinusoidal_positions(positions, cfg.d_model).to(dtype)
    return x


def _logits(params, cfg, x, shard=None):
    """float32 logits over the padded vocab (padding ids masked); with
    ``shard``, this rank's columns gathered into the full vocab (a
    replicated head's logits broadcast from the first rank)."""
    head = (params["embed"].T if cfg.tie_embeddings else params["lm_head"])
    if shard is not None and head.shape[-1] != cfg.padded_vocab:
        x = copy_to_model(x, shard)             # the vocab was split
    out = (x @ head.to(x.dtype)).float()
    if shard is not None:
        out = gather_vocab(out, shard, cfg.padded_vocab)
    if cfg.padded_vocab != cfg.vocab_size:  # mask padding ids
        ids = torch.arange(cfg.padded_vocab, device=out.device)
        out = out.masked_fill(ids >= cfg.vocab_size, -1e30)
    return out


def _unstack(tree, n: int) -> list:
    """A stacked dict tree -> n per-block trees of views (``unbind``:
    under autograd each stacked leaf then gets ONE gradient, stacked
    once, instead of one full-size gradient per block)."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    return tree.unbind(0)


def _layers(params, cfg):
    """(layer params view, pattern position j, block i) in layer order."""
    per_j = [_unstack(blocks, cfg.n_blocks) for blocks in params["blocks"]]
    for i in range(cfg.n_blocks):
        for j in range(cfg.period):
            yield per_j[j][i], j, i


# ---------------------------------------------------------------------------
# full-sequence forward (scoring)
# ---------------------------------------------------------------------------

def _layer_specs(block_specs):
    """A stacked block's spec tree without its leading n_blocks axis."""
    return map_with_names(lambda _, sp: Spec(sp[1:]), block_specs)


def _gather_top(params, specs, shard):
    """The top-level leaves with their FSDP split gathered (once per
    call; each layer's are gathered in the layer loop)."""
    if specs is None:
        return params
    return dict(params, **{k: gather_fsdp(params[k], specs[k], shard)
                           for k in ("embed", "pos_embed", "lm_head")
                           if k in params})


def _gather_tree(tree, specs, shard):
    """Every leaf of a dict tree with its FSDP split gathered."""
    if isinstance(tree, dict):
        return {k: _gather_tree(v, specs[k], shard) for k, v in tree.items()}
    return gather_fsdp(tree, specs, shard)


def _run_full(params, cfg, tokens, dev, *, last_only: bool, remat: bool,
              plain: bool, frontend_embeds=None, shard=None,
              specs=None) -> Tuple[torch.Tensor, Dict]:
    """The full-sequence layer loop shared by scoring and training;
    positions run over the frontend's F positions and then the tokens'.
    ``shard`` / ``specs``: sharded training (see the module doc)."""
    tokens = torch.as_tensor(tokens, device=dev)
    B = tokens.shape[0]
    F = 0 if frontend_embeds is None else frontend_embeds.shape[1]
    S = tokens.shape[1] + F
    positions = torch.arange(S, device=dev)[None].expand(B, S)
    # the top-level leaves gathered once (outside remat); each layer's
    # inside its body
    top = _gather_top(params, specs, shard)
    layer_specs = (None if shard is None else
                   [_layer_specs(b) for b in specs["blocks"]])
    x = _embed(top, cfg, tokens, positions, frontend_embeds, shard)
    aux = {k: torch.zeros((), dtype=torch.float32, device=dev)
           for k in AUX_KEYS}
    rope = L.Rope(positions, cfg.rope_theta)
    layers = list(_layers(params, cfg))
    # remat_group g: g blocks of layers per checkpoint (the reference's
    # grouped scan), when g divides the blocks; else one layer each
    g = cfg.remat_group
    span = (g * cfg.period if remat and g > 1 and cfg.n_blocks % g == 0
            else 1)

    whole = shard is not None and model_extent(shard) > 1

    def body(x, aux, *group):
        aux = dict(aux)
        for lp, j in zip(group[0::2], group[1::2]):
            if shard is not None:
                lp = _gather_tree(lp, layer_specs[j], shard)
            if whole:       # recurrent layers run whole on every rank
                lp = dict(lp, **{k: _whole(lp[k], layer_specs[j][k], shard)
                                 for k in _RECURRENT if k in lp})
            x, _, a = _apply_layer(lp, cfg, *cfg.pattern[j], x,
                                   positions=positions, state=None,
                                   cache_index=None, plain=plain, rope=rope,
                                   shard=shard)
            for k in a:
                aux[k] = aux[k] + a[k]
        return x, aux

    for lo in range(0, len(layers), span):
        group = [e for lp, j, _ in layers[lo:lo + span] for e in (lp, j)]
        if remat:
            # full recomputation: every rank re-issues the body's
            # collectives in the same order
            with set_checkpoint_early_stop(shard is None):
                x, aux = checkpoint(body, x, aux, *group,
                                    use_reentrant=False)
        else:
            x, aux = body(x, aux, *group)
    x = L.apply_norm(params["final_norm"], cfg, x)
    if last_only:
        x = x[:, -1:]
    return _logits(top, cfg, x, shard), aux


@torch.no_grad()
def forward(params: Params, cfg: ArchConfig, tokens, *,
            frontend_embeds=None, last_only: bool = False,
            device: DeviceLike = None) -> Tuple[torch.Tensor, Dict]:
    """tokens: (B, S_tok) int (numpy or tensor); ``frontend_embeds``:
    (B, F, D) precomputed frame or patch embeddings placed before the
    tokens, or None.  Returns (logits (B, F + S_tok, V) float32 — (B,
    1, V) with ``last_only`` — and the MoE aux losses
    ``{"moe_load_balance", "moe_router_z"}`` summed over layers, float32
    scalars, zeros without MoE).  Runs on ``device`` (default ``cuda``),
    where ``params`` must live, through the hand-written kernels."""
    _check_ported(cfg)
    return _run_full(params, cfg, tokens, resolve_device(device),
                     last_only=last_only, remat=False, plain=False,
                     frontend_embeds=frontend_embeds)


def train_forward(params: Params, cfg: ArchConfig, tokens, *,
                  remat: bool, plain_attention: bool, frontend_embeds=None,
                  device: DeviceLike = None, shard=None,
                  specs=None) -> Tuple[torch.Tensor, Dict]:
    """``forward`` under autograd, for training: same outputs, with the
    graph to ``params``.  ``remat`` checkpoints each layer (memory ~ one
    layer's activations; the backward runs each layer's forward again).
    ``plain_attention`` runs the plain attention and scans (the
    reference's training path, ``kernel_impl="xla"``); the CUDA kernels
    have no backward and refuse inputs that require grad, so on the card
    training passes True.  ``shard`` / ``specs``: this rank's mesh and
    the full params' spec tree under sharded training (``params`` are
    then this rank's slices and ``tokens`` its rows); the logits are the
    full vocab's on every rank."""
    _check_ported(cfg)
    if (shard is None) != (specs is None):
        raise ValueError("sharded training needs both shard and specs")
    with torch.enable_grad():
        return _run_full(params, cfg, tokens, resolve_device(device),
                         last_only=False, remat=remat, plain=plain_attention,
                         frontend_embeds=frontend_embeds, shard=shard,
                         specs=specs)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def _state_blocks(cfg: ArchConfig, batch: int, kv_rows: Tuple[int, int],
                  dev: torch.device) -> tuple:
    """Per-pattern-position stacked state trees (leading n_blocks): KV
    caches of ``kv_rows + (KV, r)`` per attention layer, per-slot
    recurrent leaves per Mamba layer (``{"mamba": {"conv", "ssm"}}``)
    and per RWKV layer (``{"time": {"last_x", "wkv"}, "chan":
    {"last_x"}}``)."""
    kv_dtype = _dtype(cfg.kv_cache_dtype or cfg.compute_dtype)
    dtype = _dtype(cfg.compute_dtype)
    shape = (cfg.n_blocks,) + tuple(kv_rows) + (cfg.n_kv_heads,)
    blocks = []
    for mixer, _ in cfg.pattern:
        if mixer == MIXER_ATTN:
            blocks.append({"kv": {
                "k": torch.zeros(shape + (cfg.qk_dim,), dtype=kv_dtype,
                                 device=dev),
                "v": torch.zeros(shape + (cfg.vo_dim,), dtype=kv_dtype,
                                 device=dev)}})
            continue
        if mixer == MIXER_MAMBA:
            one = {"mamba": M.init_mamba_state(cfg, batch, dtype=dtype,
                                               device=dev)}
        else:
            one = R.init_rwkv_state(cfg, batch, dtype=dtype, device=dev)
        blocks.append(tree_map(lambda a: torch.zeros(
            (cfg.n_blocks,) + tuple(a.shape), dtype=a.dtype,
            device=dev), one))
    return tuple(blocks)


def init_decode_state(cfg: ArchConfig, batch: int, max_len: int, *,
                      device: DeviceLike = None) -> Params:
    """Per-pattern-position stacked state trees (leading n_blocks): KV
    caches (batch, max_len, KV, r) per attention layer, zero recurrent
    state per Mamba or RWKV layer; and a scalar ``index``."""
    _check_ported(cfg)
    dev = resolve_device(device)
    return {"blocks": _state_blocks(cfg, batch, (batch, max_len), dev),
            "index": torch.zeros((), dtype=torch.int32, device=dev)}


def init_decode_state_paged(cfg: ArchConfig, batch: int, n_pages: int,
                            page_tokens: int, *,
                            device: DeviceLike = None) -> Params:
    """Decode state whose KV caches are PAGED: one global pool
    ``(n_pages + 1, page_tokens, KV, r)`` per attention layer (stacked
    over ``n_blocks``); row ``n_pages`` is the garbage row sentinel
    page-table entries address.  Recurrent (Mamba, RWKV) leaves stay per
    slot: they are O(1) in sequence length, so paging buys them nothing.
    ``index`` is the (batch,) per-slot position vector; the (batch,
    n_p) page table is host-owned (``serve.memory.PageAllocator``) and
    passed into each step."""
    _check_ported(cfg)
    dev = resolve_device(device)
    return {"blocks": _state_blocks(cfg, batch, (n_pages + 1, page_tokens),
                                    dev),
            "index": torch.zeros((batch,), dtype=torch.int32, device=dev)}


def _capacity(state: Params) -> Optional[int]:
    """This rank's dense KV-cache positions (None: no KV leaf)."""
    kv = [entry["kv"] for entry in state["blocks"] if "kv" in entry]
    return kv[0]["k"].shape[2] if kv else None


def _check_dense_window(state: Params, width: int, paged: bool,
                        capacity: Optional[int] = None) -> None:
    """A dense cache write [index, index + width) must stay inside the
    cache: the reference's ``dynamic_update_slice`` would clamp it
    backwards over valid history, torch indexing would fault.
    ``EngineConfig.capacity`` is sized so this never fires; one host
    read per step checks it (on meta, where nothing can be read, the
    window's width against the capacity).  ``capacity``: the whole
    cache's positions where this rank holds a window of them."""
    cap = capacity or _capacity(state)
    if paged or cap is None:
        return
    idx = state["index"]
    top = width if idx.device.type == "meta" else int(idx.max()) + width
    if top > cap:
        raise ValueError(f"dense KV write reaches position {top} past the "
                         f"cache capacity {cap}")


_RECURRENT = ("mamba", "rwkv_time", "rwkv_chan")


def _whole(tree, specs, shard):
    """A layer's (or its state's) tree with every leaf's "model" split
    gathered (under autograd each rank keeps its block of the
    gradient)."""
    if isinstance(tree, dict):
        return {k: _whole(v, specs[k], shard) for k, v in tree.items()}
    return gather_model_dims(tree, specs, shard)


def _resplit(tree, specs, shard):
    """The inverse of ``_whole``: this rank's "model" slice of each
    leaf."""
    if isinstance(tree, dict):
        return {k: _resplit(v, specs[k], shard) for k, v in tree.items()}
    return local_slice(tree, model_spec(specs), shard)


@dataclass
class ServeLayout:
    """Serving under training's sharding rules: the param spec tree
    (``parallel.sharding.param_specs``) and the decode state's
    (``decode_state_specs``), with the layer-level views the loop
    reads."""
    specs: Params
    state_specs: Params

    def layer(self, j: int):
        return _layer_specs(self.specs["blocks"][j])

    def state_layer(self, j: int):
        return _layer_specs(self.state_specs["blocks"][j])

    def window(self, state: Params, shard):
        """(this rank's (lo, size) window of a dense cache split along
        its sequence over "model", or None; the whole cache's capacity,
        None without a KV leaf)."""
        cap = _capacity(state)
        for entry, sp in zip(state["blocks"], self.state_specs["blocks"]):
            if "kv" in entry:
                m = model_extent(shard) if sp["kv"]["k"][2] == "model" else 1
                if m == 1:
                    return None, cap
                return seq_window(cap * m, shard), cap * m
        return None, cap


def _run_with_state(params, cfg, x, state, positions, pages=None,
                    write_floor=None, draft_rank=None, adapters=None,
                    shard=None, layout: Optional[ServeLayout] = None,
                    seq=None):
    """-> (x, new blocks): the KV leaves written in place, each Mamba or
    RWKV layer's new recurrent state stacked into new leaves.
    ``draft_rank``: run the attention layers at the sliced draft widths
    (DESIGN.md §8).  ``adapters``: per-slot SV-adapter scales, one tree
    (or ``None``) per pattern position with a leading ``n_blocks`` axis,
    as ``params["blocks"]``; block ``i`` takes its slice (DESIGN.md
    §13).  ``shard``: this rank's mesh (tensor parallelism, §10);
    ``layout``: serving under training's rules (see the module doc),
    ``seq`` its sequence-split cache."""
    cache_index = state["index"]
    if layout is None:
        _check_dense_window(state, x.shape[1], pages is not None)
    new = [[] for _ in cfg.pattern]
    rope = L.Rope(positions, cfg.rope_theta)
    whole = layout is not None and model_extent(shard) > 1
    for lp, j, i in _layers(params, cfg):
        st = layer_slice(state["blocks"][j], i)
        if layout is not None:
            lp = _gather_tree(lp, layout.layer(j), shard)
        if whole and any(k in lp for k in _RECURRENT):
            lspec, sspec = layout.layer(j), layout.state_layer(j)
            lp = dict(lp, **{k: _whole(lp[k], lspec[k], shard)
                             for k in _RECURRENT if k in lp})
            st = _whole(st, sspec, shard)
        x, ns, _ = _apply_layer(lp, cfg, *cfg.pattern[j], x,
                                positions=positions, rope=rope,
                                state=st,
                                cache_index=cache_index, pages=pages,
                                write_floor=write_floor,
                                draft_rank=draft_rank,
                                adapter=None if adapters is None
                                or adapters[j] is None
                                else layer_slice(adapters[j], i),
                                shard=shard, seq=seq)
        if whole and ns:
            ns = _resplit(ns, layout.state_layer(j), shard)
        new[j].append(ns)
    blocks = tuple(dict(entry, **_stack(ns))
                   for entry, ns in zip(state["blocks"], new))
    return x, blocks


def _layout(shard, specs, state_specs) -> Optional[ServeLayout]:
    if specs is None and state_specs is None:
        return None
    if shard is None or specs is None or state_specs is None:
        raise ValueError("serving under training's rules needs shard, "
                         "specs and state_specs")
    return ServeLayout(specs, state_specs)


def _host_index(idx: torch.Tensor, capacity: int, S: int) -> int:
    """The replicated scalar index as a host int (one read per prefill;
    on meta the position that makes the prefill end at the cache's
    capacity, as the dry-run's do)."""
    if idx.device.type == "meta":
        return capacity - S
    return int(idx)


@torch.no_grad()
def prefill(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
            state: Params, *, frontend_embeds=None, shard=None, specs=None,
            state_specs=None) -> Tuple[torch.Tensor, Params]:
    """Run a whole prompt batch through the model at the scalar
    ``state["index"]``, filling the caches.  ``frontend_embeds`` (B, F,
    D): embeddings placed before the tokens; such a prompt starts its
    sequence, so its positions run from 0 over F + S, as the reference's
    do (a text prompt's run from ``index``).  Returns (last-position
    logits (B, V), state with ``index`` advanced by F + S).  ``shard`` /
    ``specs`` / ``state_specs``: serving under training's rules (see the
    module doc; ``tokens`` and the state are this rank's rows)."""
    B = tokens.shape[0]
    F = 0 if frontend_embeds is None else frontend_embeds.shape[1]
    S = tokens.shape[1] + F
    idx = state["index"]
    start = 0 if F else idx.long()
    positions = (start + torch.arange(S, device=tokens.device))[None]
    positions = positions.expand(B, S)
    layout = _layout(shard, specs, state_specs)
    seq = None
    if layout is not None:
        win, cap = layout.window(state, shard)
        _check_dense_window(state, S, False, cap)
        if win is not None:
            seq = L.SeqSplit(*win, _host_index(idx, cap, S))
    top = _gather_top(params, specs, shard)
    x = _embed(top, cfg, tokens, positions, frontend_embeds, shard)
    x, blocks = _run_with_state(params, cfg, x, state, positions,
                                shard=shard, layout=layout, seq=seq)
    x = L.apply_norm(params["final_norm"], cfg, x[:, -1:])
    return _logits(top, cfg, x, shard)[:, 0], {"blocks": blocks,
                                               "index": idx + S}


@torch.no_grad()
def prefill_chunk(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
                  state: Params, lengths: torch.Tensor,
                  pages: Optional[torch.Tensor] = None,
                  write_floor: Optional[torch.Tensor] = None,
                  adapters=None, shard=None,
                  ) -> Tuple[torch.Tensor, Params]:
    """Write one fixed-size prompt chunk per slot into the decode state.

    tokens: (B, C) — each slot's next window, right-padded; state: a
    per-slot ``index`` (B,) — the window lands at [index, index + C);
    lengths: (B,) in [0, C] valid tokens per slot (0 = idle, 1 = a
    riding decode token).  Returns (logits (B, V) at each slot's last
    valid position, state with ``index`` advanced by ``lengths``).
    Padding columns write garbage K/V past each slot's valid region,
    always masked or overwritten before becoming readable.  Recurrent
    (Mamba, RWKV) states advance over the FULL window, padding
    included: the scheduler gives such models only full windows, and the
    executor keeps inactive slots' old rows
    (``serve.executor._merge_inactive``).  ``pages``:
    (B, n_p) page table for paged caches; ``write_floor``: (B,) first
    writable position per slot; ``adapters``: per-slot SV-adapter scales
    (see ``_run_with_state``); ``shard``: this rank's mesh under tensor
    parallelism (params and state are its slices).
    """
    B, C = tokens.shape
    idx = state["index"]
    positions = idx.long()[:, None] + torch.arange(C, device=tokens.device)
    x = _embed(params, cfg, tokens, positions, shard=shard)
    x, blocks = _run_with_state(params, cfg, x, state, positions,
                                pages=pages, write_floor=write_floor,
                                adapters=adapters, shard=shard)
    last = (lengths.long() - 1).clamp(0, C - 1)
    x = x.gather(1, last[:, None, None].expand(B, 1, x.shape[-1]))
    x = L.apply_norm(params["final_norm"], cfg, x)
    return _logits(params, cfg, x, shard)[:, 0], {"blocks": blocks,
                                           "index": idx + lengths.to(idx.dtype)}


@torch.no_grad()
def verify_chunk(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
                 state: Params, lengths: torch.Tensor,
                 pages: Optional[torch.Tensor] = None,
                 write_floor: Optional[torch.Tensor] = None,
                 adapters=None, shard=None,
                 ) -> Tuple[torch.Tensor, Params]:
    """Multi-token VERIFY step of self-speculative decoding (DESIGN.md
    §8): the (B, W) window runs the chunked path of ``prefill_chunk``
    but returns logits at EVERY window position, (B, W, V), so the
    caller checks each draft token against the full model's argmax and
    rolls the rejected tail back.  tokens[b, 0] is slot b's pending
    (sampled, not yet cached) token, tokens[b, 1:] its draft proposals;
    lengths in {0, W}.  K/V of all W positions are written at full rank
    at [index, index + W), over whatever the draft wrote there, and
    ``index`` advances by ``lengths``; the caller rolls it back to the
    accepted prefix (stale K/V past the index is never read).
    ``write_floor``, ``adapters`` and ``shard`` as in
    ``prefill_chunk``."""
    B, W = tokens.shape
    idx = state["index"]
    positions = idx.long()[:, None] + torch.arange(W, device=tokens.device)
    x = _embed(params, cfg, tokens, positions, shard=shard)
    x, blocks = _run_with_state(params, cfg, x, state, positions,
                                pages=pages, write_floor=write_floor,
                                adapters=adapters, shard=shard)
    x = L.apply_norm(params["final_norm"], cfg, x)
    return _logits(params, cfg, x, shard), {"blocks": blocks,
                                     "index": idx + lengths.to(idx.dtype)}


def draft_params(params: Params, cfg: ArchConfig,
                 draft_rank: Tuple[int, int]) -> Params:
    """``params`` with every attention layer's weights sliced to the
    draft's widths once, contiguous; every other leaf is the same tensor.
    torch's matmuls copy a ``[..., :r]`` slice of a (D, H, r) weight on
    every call, so the executor slices once per engine; ``attention``
    slicing these again at the same widths is the identity, so the
    draft pass gives the same results on them as on ``params``."""
    r_q, r_v = draft_rank
    cut = {"wq": (r_q,), "wk": (r_q,), "wv": (r_v,), "k_t": (r_q, r_q),
           "s_qk": (r_q, r_q), "s_vo": (r_v, r_v), "wo": (r_v, None)}

    def sliced(attn):
        out = dict(attn)
        for name, widths in cut.items():
            if name in attn:
                idx = (...,) + tuple(slice(0, w) for w in widths)
                out[name] = attn[name][idx].contiguous()
        return out
    blocks = tuple(dict(entry, attn=sliced(entry["attn"]))
                   if mixer == MIXER_ATTN else entry
                   for entry, (mixer, _) in zip(params["blocks"], cfg.pattern))
    return dict(params, blocks=blocks)


@torch.no_grad()
def decode_step(params: Params, cfg: ArchConfig, token: torch.Tensor,
                state: Params, pages: Optional[torch.Tensor] = None,
                write_floor: Optional[torch.Tensor] = None,
                draft_rank: Optional[Tuple[int, int]] = None,
                adapters=None, shard=None, specs=None, state_specs=None,
                ) -> Tuple[torch.Tensor, Params]:
    """token: (B,) int.  Returns (logits (B, V), state with ``index``
    advanced by 1).  ``state["index"]`` may be a scalar (lockstep) or a
    (B,) vector (per-slot positions).  ``draft_rank``: the attention
    layers run at the sliced (r_q, r_v) widths -- the self-speculative
    DRAFT pass over the shared full-width cache (DESIGN.md §8).
    ``write_floor``, ``adapters`` and ``shard`` as in
    ``prefill_chunk``; ``specs`` / ``state_specs`` as in ``prefill``
    (a scalar index)."""
    B = token.shape[0]
    idx = state["index"]
    if idx.dim() == 1:
        positions = idx.long()[:, None]
    else:
        positions = idx.long().reshape(1, 1).expand(B, 1)
    layout = _layout(shard, specs, state_specs)
    seq = None
    if layout is not None:
        win, cap = layout.window(state, shard)
        _check_dense_window(state, 1, False, cap)
        if win is not None:
            seq = L.SeqSplit(*win)
    top = _gather_top(params, specs, shard)
    x = _embed(top, cfg, token[:, None], positions, shard=shard)
    x, blocks = _run_with_state(params, cfg, x, state, positions,
                                pages=pages, write_floor=write_floor,
                                draft_rank=draft_rank, adapters=adapters,
                                shard=shard, layout=layout, seq=seq)
    x = L.apply_norm(params["final_norm"], cfg, x)
    return _logits(top, cfg, x, shard)[:, 0], {"blocks": blocks,
                                               "index": idx + 1}
