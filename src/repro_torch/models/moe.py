"""GShard-style top-k mixture of experts of the port — own port of
``repro/models/moe.py`` for one shard (DESIGN.md §1, §5).

Routing is the reference's, in float32: softmax over the router
logits (dead padding experts masked to -1e30), ``top_k`` over the
probabilities, gates renormalized to sum to 1; the Switch load-balance
and router z aux losses.  Each token's ``k`` (token, expert) slots are
flattened token-major; a slot's position in its expert is the count of
earlier slots routed there, and slots at or past the expert's capacity
are dropped (their gate weight becomes 0): the reference's routing
marks the same slots.  (Its scatter then also loses the token kept in
expert 0's first slot whenever any slot is dropped, a fault of the
reference that this port does not copy.)  Dispatch is dropless
(capacity = T) for one-token steps and when ``capacity_factor`` is 0.

The expert FFNs differ in order, not in function: the reference
gathers every expert's capacity buffer (E, C, D) — dropless that is C =
T rows per expert, E/k times the products routing needs — while here
each expert runs on the rows routed to it alone (slots sorted by
expert) and its gated output is scatter-added back to its token.  The
sums match the reference's to float32 rounding (the tests hold them to
1e-5).  Expert parallelism (the reference's mesh-sharded dispatch)
arrives with tensor parallelism.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init

Params = Dict[str, Any]

AUX_KEYS = ("moe_load_balance", "moe_router_z")


def init_moe(gen: torch.Generator, cfg, *, dtype=torch.float32,
             device=None) -> Params:
    """The reference's distributions: N(0, 1/fan_in) router (float32
    whatever ``dtype`` is), experts and shared experts."""
    D = cfg.d_model
    de = cfg.moe.d_expert or cfg.d_ff
    E = cfg.n_experts_padded
    gated = cfg.mlp_act in ("swiglu", "geglu")
    kw = dict(dtype=dtype, device=device)
    p: Params = {
        "router": dense_init(gen, (D, E), D, dtype=torch.float32,
                             device=device),
        "w_up": dense_init(gen, (E, D, de), D, **kw),
        "w_down": dense_init(gen, (E, de, D), de, **kw),
    }
    if gated:
        p["w_gate"] = dense_init(gen, (E, D, de), D, **kw)
    if cfg.moe.n_shared:
        ds = cfg.moe.n_shared * de
        p["shared_up"] = dense_init(gen, (D, ds), D, **kw)
        p["shared_down"] = dense_init(gen, (ds, D), ds, **kw)
        if gated:
            p["shared_gate"] = dense_init(gen, (D, ds), D, **kw)
    return p


def _act(cfg, gate, up):
    if cfg.mlp_act == "swiglu":
        return F.silu(gate) * up
    if cfg.mlp_act == "geglu":
        # jax.nn.gelu defaults to the tanh approximation
        return F.gelu(gate, approximate="tanh") * up
    return F.gelu(up, approximate="tanh")


def apply_moe(params: Params, cfg, x: torch.Tensor
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, D) -> (out, aux losses).  Dropless (capacity = T) when
    S == 1 (decode: exactness matters) or ``capacity_factor == 0``;
    otherwise capacity-bounded over the B * S tokens of the call."""
    B, S, D = x.shape
    dropless = (S == 1) or (cfg.moe.capacity_factor == 0)
    out, aux = _moe_tokens(params, cfg, x.reshape(B * S, D), dropless)
    return out.reshape(B, S, D), aux


def _route(params: Params, cfg, xf: torch.Tensor, dropless: bool):
    """Routing of a flat (T, D) slab -> (gates (T, k) renormalized,
    experts (T, k), keep (T, k) bool: the slot fits its expert's
    capacity, probs (T, E), logits (T, E))."""
    T = xf.shape[0]
    moe = cfg.moe
    E_real, E = moe.n_experts, cfg.n_experts_padded
    k = moe.top_k
    logits = xf.float() @ params["router"].float()
    if E != E_real:  # dead padding experts
        logits[:, E_real:] = -1e30
    probs = torch.softmax(logits, dim=-1)
    gates, experts = probs.topk(k, dim=-1)                    # (T, k)
    gates = gates / gates.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    capacity = T if dropless else max(1, int(k * T * moe.capacity_factor
                                             / E))
    e_flat = experts.reshape(T * k)                           # token-major
    onehot = F.one_hot(e_flat, E)                             # (Tk, E)
    pos = (onehot.cumsum(dim=0) - 1).gather(1, e_flat[:, None])[:, 0]
    keep = (pos < capacity).reshape(T, k)
    return gates, experts, keep, probs, logits


def _moe_tokens(params: Params, cfg, xf: torch.Tensor, dropless: bool,
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Single-shard dispatch + expert FFN over a flat (T, D) slab."""
    T, D = xf.shape
    moe = cfg.moe
    E_real, E = moe.n_experts, cfg.n_experts_padded
    k = moe.top_k
    dtype = xf.dtype
    gates, experts, keep, probs, logits = _route(params, cfg, xf, dropless)

    # aux losses
    me = probs.mean(dim=0)                                    # (E,)
    ce = F.one_hot(experts, E).float().sum(dim=1).mean(dim=0)
    aux = {"moe_load_balance": E_real * (me * ce).sum() * moe.aux_loss_coef,
           "moe_router_z": torch.logsumexp(logits, dim=-1).square().mean()
           * moe.router_z_coef}

    # expert FFNs on the rows routed to each expert; slots are sorted by
    # expert (stable, so each expert's rows stay in token order)
    e_flat = experts.reshape(T * k)
    w_flat = (gates * keep).reshape(T * k).to(dtype)
    order = torch.argsort(e_flat, stable=True)
    order = order[keep.reshape(T * k)[order]]                 # kept slots
    counts = torch.bincount(e_flat[order], minlength=E).tolist()
    out = torch.zeros((T, D), dtype=dtype, device=xf.device)
    start = 0
    for e, n in enumerate(counts):
        if n == 0:
            continue
        slots = order[start:start + n]
        start += n
        tok = slots // k
        rows = xf[tok]
        up = rows @ params["w_up"][e].to(dtype)
        gate = (rows @ params["w_gate"][e].to(dtype)
                if "w_gate" in params else None)
        h = _act(cfg, gate, up) @ params["w_down"][e].to(dtype)
        out.index_add_(0, tok, h * w_flat[slots][:, None])

    # shared experts (always on)
    if "shared_up" in params:
        sup = xf @ params["shared_up"].to(dtype)
        sgate = (xf @ params["shared_gate"].to(dtype)
                 if "shared_gate" in params else None)
        out = out + _act(cfg, sgate, sup) @ params["shared_down"].to(dtype)
    return out, aux
