"""Config-driven decoder of the port — own port of
``repro/models/transformer.py`` for the attention + dense-MLP patterns
(DESIGN.md §1, §6).

Parameters keep the reference's stacked layout: ``params["blocks"]`` is
a tuple with one tree per pattern position whose leaves carry a leading
``n_blocks`` axis.  The reference's ``lax.scan`` over blocks becomes a
Python loop over layers, each reading its layer's slice of the stacked
leaves.  Decode states are stacked the same way and are updated in
place.

Entry points ``init_lm_params`` and ``forward`` run on ``cuda`` unless
the caller passes ``device="cpu"``; the decode-state functions run
where the state and params live.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.bridge import tree_map
from repro_torch.configs.base import ArchConfig, MIXER_ATTN, MLP_DENSE
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L

Params = Dict[str, Any]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def _dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def _check_ported(cfg: ArchConfig) -> None:
    for mixer, mlp in cfg.pattern:
        if mixer != MIXER_ATTN or mlp != MLP_DENSE:
            raise NotImplementedError(
                f"{cfg.name}: pattern ({mixer}, {mlp}) is not ported yet "
                "(attention + dense MLP only)")
    if cfg.frontend != "none":
        raise NotImplementedError(f"{cfg.name}: {cfg.frontend} frontends "
                                  "are not ported yet")


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
    blocks = []
    for _ in cfg.pattern:
        layers = [{"norm1": L.init_norm(cfg, **kw),
                   "norm2": L.init_norm(cfg, **kw),
                   "attn": L.init_attention(gen, cfg, **kw),
                   "mlp": L.init_mlp(gen, cfg, **kw)}
                  for _ in range(cfg.n_blocks)]
        blocks.append(_stack(layers))
    params["blocks"] = tuple(blocks)
    return params


def _stack(trees):
    """List of identical trees -> one tree with a leading stacked axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def layer_slice(tree, i: int):
    """Block ``i``'s view of a stacked tree (no copy)."""
    return tree_map(lambda a: a[i], tree)


# ---------------------------------------------------------------------------
# layer application
# ---------------------------------------------------------------------------

def _apply_layer(lp: Params, cfg: ArchConfig, x: torch.Tensor, *,
                 positions, state: Optional[Params], cache_index,
                 pages=None, write_floor=None):
    h = L.apply_norm(lp["norm1"], cfg, x)
    kv = state["kv"] if state is not None else None
    y, _ = L.attention(lp["attn"], cfg, h, positions=positions,
                       kv_cache=kv, cache_index=cache_index,
                       page_table=pages, write_floor=write_floor)
    x = x + y
    h = L.apply_norm(lp["norm2"], cfg, x)
    return x + L.apply_mlp(lp["mlp"], cfg, h)


def _embed(params, cfg, tokens, positions):
    dtype = _dtype(cfg.compute_dtype)
    x = params["embed"][tokens.long()].to(dtype)
    if cfg.learned_pos:
        # the reference's gather clamps out-of-range positions (only
        # padding columns reach them); clamp explicitly
        pos = positions.long().clamp(0, cfg.max_position - 1)
        x = x + params["pos_embed"][pos].to(dtype)
    return x


def _logits(params, cfg, x):
    if cfg.tie_embeddings:
        out = (x @ params["embed"].to(x.dtype).T).float()
    else:
        out = (x @ params["lm_head"].to(x.dtype)).float()
    if cfg.padded_vocab != cfg.vocab_size:  # mask padding ids
        out[..., cfg.vocab_size:] = -1e30
    return out


def _layers(params, cfg):
    """(layer params view, pattern position j, block i) in layer order."""
    for i in range(cfg.n_blocks):
        for j in range(cfg.period):
            yield layer_slice(params["blocks"][j], i), j, i


# ---------------------------------------------------------------------------
# full-sequence forward (scoring)
# ---------------------------------------------------------------------------

@torch.no_grad()
def forward(params: Params, cfg: ArchConfig, tokens, *,
            last_only: bool = False,
            device: DeviceLike = None) -> Tuple[torch.Tensor, Dict]:
    """tokens: (B, S) int (numpy or tensor).  Returns (logits (B, S, V)
    float32 — (B, 1, V) with ``last_only`` — and an empty aux dict, the
    reference's MoE-loss slot).  Runs on ``device`` (default ``cuda``),
    where ``params`` must live."""
    _check_ported(cfg)
    dev = resolve_device(device)
    tokens = torch.as_tensor(tokens, device=dev)
    B, S = tokens.shape
    positions = torch.arange(S, device=dev)[None].expand(B, S)
    x = _embed(params, cfg, tokens, positions)
    for lp, _, _ in _layers(params, cfg):
        x = _apply_layer(lp, cfg, x, positions=positions, state=None,
                         cache_index=None)
    x = L.apply_norm(params["final_norm"], cfg, x)
    if last_only:
        x = x[:, -1:]
    return _logits(params, cfg, x), {}


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_decode_state(cfg: ArchConfig, batch: int, max_len: int, *,
                      device: DeviceLike = None) -> Params:
    """Per-pattern-position stacked KV caches (leading n_blocks) and a
    scalar ``index``."""
    _check_ported(cfg)
    dev = resolve_device(device)
    kv_dtype = _dtype(cfg.kv_cache_dtype or cfg.compute_dtype)
    shape = (cfg.n_blocks, batch, max_len, cfg.n_kv_heads)
    blocks = tuple(
        {"kv": {"k": torch.zeros(shape + (cfg.qk_dim,), dtype=kv_dtype,
                                 device=dev),
                "v": torch.zeros(shape + (cfg.vo_dim,), dtype=kv_dtype,
                                 device=dev)}}
        for _ in cfg.pattern)
    return {"blocks": blocks,
            "index": torch.zeros((), dtype=torch.int32, device=dev)}


def init_decode_state_paged(cfg: ArchConfig, batch: int, n_pages: int,
                            page_tokens: int, *,
                            device: DeviceLike = None) -> Params:
    """Decode state whose KV caches are PAGED: one global pool
    ``(n_pages + 1, page_tokens, KV, r)`` per attention layer (stacked
    over ``n_blocks``); row ``n_pages`` is the garbage row sentinel
    page-table entries address.  ``index`` is the (batch,) per-slot
    position vector; the (batch, n_p) page table is host-owned
    (``serve.memory.PageAllocator``) and passed into each step."""
    _check_ported(cfg)
    dev = resolve_device(device)
    kv_dtype = _dtype(cfg.kv_cache_dtype or cfg.compute_dtype)
    shape = (cfg.n_blocks, n_pages + 1, page_tokens, cfg.n_kv_heads)
    blocks = tuple(
        {"kv": {"k": torch.zeros(shape + (cfg.qk_dim,), dtype=kv_dtype,
                                 device=dev),
                "v": torch.zeros(shape + (cfg.vo_dim,), dtype=kv_dtype,
                                 device=dev)}}
        for _ in cfg.pattern)
    return {"blocks": blocks,
            "index": torch.zeros((batch,), dtype=torch.int32, device=dev)}


def _check_dense_window(state: Params, width: int, paged: bool) -> None:
    """A dense cache write [index, index + width) must stay inside the
    cache: the reference's ``dynamic_update_slice`` would clamp it
    backwards over valid history, torch indexing would fault.
    ``EngineConfig.capacity`` is sized so this never fires; one host
    read per step checks it."""
    if paged:
        return
    cap = state["blocks"][0]["kv"]["k"].shape[2]
    top = int(state["index"].max()) + width
    if top > cap:
        raise ValueError(f"dense KV write reaches position {top} past the "
                         f"cache capacity {cap}")


def _run_with_state(params, cfg, x, state, positions, pages=None,
                    write_floor=None):
    cache_index = state["index"]
    _check_dense_window(state, x.shape[1], pages is not None)
    for lp, j, i in _layers(params, cfg):
        x = _apply_layer(lp, cfg, x, positions=positions,
                         state=layer_slice(state["blocks"][j], i),
                         cache_index=cache_index, pages=pages,
                         write_floor=write_floor)
    return x


@torch.no_grad()
def prefill(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
            state: Params) -> Tuple[torch.Tensor, Params]:
    """Run a whole prompt batch through the model at the scalar
    ``state["index"]``, filling the caches.  Returns (last-position
    logits (B, V), state with ``index`` advanced by S)."""
    B, S = tokens.shape
    idx = state["index"]
    positions = (idx.long() + torch.arange(S, device=tokens.device))[None]
    positions = positions.expand(B, S)
    x = _embed(params, cfg, tokens, positions)
    x = _run_with_state(params, cfg, x, state, positions)
    x = L.apply_norm(params["final_norm"], cfg, x[:, -1:])
    return _logits(params, cfg, x)[:, 0], {"blocks": state["blocks"],
                                           "index": idx + S}


@torch.no_grad()
def prefill_chunk(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
                  state: Params, lengths: torch.Tensor,
                  pages: Optional[torch.Tensor] = None,
                  write_floor: Optional[torch.Tensor] = None,
                  ) -> Tuple[torch.Tensor, Params]:
    """Write one fixed-size prompt chunk per slot into the decode state.

    tokens: (B, C) — each slot's next window, right-padded; state: a
    per-slot ``index`` (B,) — the window lands at [index, index + C);
    lengths: (B,) in [0, C] valid tokens per slot (0 = idle, 1 = a
    riding decode token).  Returns (logits (B, V) at each slot's last
    valid position, state with ``index`` advanced by ``lengths``).
    Padding columns write garbage K/V past each slot's valid region,
    always masked or overwritten before becoming readable.  ``pages``:
    (B, n_p) page table for paged caches; ``write_floor``: (B,) first
    writable position per slot.
    """
    B, C = tokens.shape
    idx = state["index"]
    positions = idx.long()[:, None] + torch.arange(C, device=tokens.device)
    x = _embed(params, cfg, tokens, positions)
    x = _run_with_state(params, cfg, x, state, positions, pages=pages,
                        write_floor=write_floor)
    last = (lengths.long() - 1).clamp(0, C - 1)
    x = x.gather(1, last[:, None, None].expand(B, 1, x.shape[-1]))
    x = L.apply_norm(params["final_norm"], cfg, x)
    return _logits(params, cfg, x)[:, 0], {"blocks": state["blocks"],
                                           "index": idx + lengths.to(idx.dtype)}


@torch.no_grad()
def decode_step(params: Params, cfg: ArchConfig, token: torch.Tensor,
                state: Params, pages: Optional[torch.Tensor] = None,
                write_floor: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, Params]:
    """token: (B,) int.  Returns (logits (B, V), state with ``index``
    advanced by 1).  ``state["index"]`` may be a scalar (lockstep) or a
    (B,) vector (per-slot positions)."""
    B = token.shape[0]
    idx = state["index"]
    if idx.dim() == 1:
        positions = idx.long()[:, None]
    else:
        positions = idx.long().reshape(1, 1).expand(B, 1)
    x = _embed(params, cfg, token[:, None], positions)
    x = _run_with_state(params, cfg, x, state, positions, pages=pages,
                        write_floor=write_floor)
    x = L.apply_norm(params["final_norm"], cfg, x)
    return _logits(params, cfg, x)[:, 0], {"blocks": state["blocks"],
                                           "index": idx + 1}
