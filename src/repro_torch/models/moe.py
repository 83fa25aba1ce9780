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
1e-5).

Expert parallelism (DESIGN.md §10): with ``shard`` (this rank's
``launch.mesh.Mesh``) the expert leaves hold this rank's contiguous
E / tp experts and the shared experts its ff slice.  Every rank routes
with the replicated router (the same routing and aux losses), runs only
its own experts -- the slots routed elsewhere, and the dropped ones,
contribute 0 here -- and the partial outputs are summed over "model".

On the meta device (the dry-run) the routing cannot be read: each
expert takes a static ``ceil(T * top_k / E)`` rows, the call's slots
spread evenly over the experts and none dropped (dropless).
Only the parts that were split are summed: replicated experts or shared
experts are computed whole on every rank and added after the sum.  Under
autograd the split parts' inputs (the token rows and the gates) pass
through ``copy_to_model``, so the replicated router and the layer's
input get their whole gradients; the load-balance loss is a product of
batch means, so under data parallelism (a mesh with "data" or "pod"
extents > 1) its means, and the router z-loss's, are taken over the
global batch (``reduce_batch``).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init
from repro_torch.parallel.sharding import (batch_extent, copy_to_model,
                                           reduce_batch, reduce_model)

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


def apply_moe(params: Params, cfg, x: torch.Tensor, shard=None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, D) -> (out, aux losses).  Dropless (capacity = T) when
    S == 1 (decode: exactness matters) or ``capacity_factor == 0``;
    otherwise capacity-bounded over the B * S tokens of the call.
    ``shard``: this rank's mesh under expert parallelism."""
    B, S, D = x.shape
    dropless = (S == 1) or (cfg.moe.capacity_factor == 0)
    out, aux = _moe_tokens(params, cfg, x.reshape(B * S, D), dropless,
                           shard)
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
                shard=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Dispatch + expert FFN over a flat (T, D) slab: every expert on
    one device, this rank's experts with ``shard``."""
    T, D = xf.shape
    moe = cfg.moe
    E_real, E = moe.n_experts, cfg.n_experts_padded
    k = moe.top_k
    dtype = xf.dtype
    gates, experts, keep, probs, logits = _route(params, cfg, xf, dropless)

    # aux losses
    counts_e = F.one_hot(experts, E).float().sum(dim=1)       # (T, E)
    lse2 = torch.logsumexp(logits, dim=-1).square()
    if batch_extent(shard) > 1:     # means over the global batch
        n_tok = reduce_batch(torch.tensor(float(T), device=xf.device), shard)
        me = reduce_batch(probs.sum(dim=0), shard) / n_tok    # (E,)
        ce = reduce_batch(counts_e.sum(dim=0), shard) / n_tok
        z = reduce_batch(lse2.sum(), shard) / n_tok
    else:
        me, ce, z = probs.mean(dim=0), counts_e.mean(dim=0), lse2.mean()
    aux = {"moe_load_balance": E_real * (me * ce).sum() * moe.aux_loss_coef,
           "moe_router_z": z * moe.router_z_coef}

    # expert FFNs on the rows routed to each expert; slots are sorted by
    # expert (stable, so each expert's rows stay in token order)
    e_flat = experts.reshape(T * k)
    w_flat = (gates * keep).reshape(T * k).to(dtype)
    order = torch.argsort(e_flat, stable=True)
    if xf.device.type == "meta":     # static shapes: slots spread evenly
        counts = [-(-T * k // E)] * E
        order = order.repeat(-(-sum(counts) // (T * k)))
    else:
        order = order[keep.reshape(T * k)[order]]             # kept slots
        counts = torch.bincount(e_flat[order], minlength=E).tolist()
    # this rank's experts [e0, e0 + E_local): all of them on one device
    E_local = params["w_up"].shape[0]
    split_e = shard is not None and E_local != E
    e0 = shard.rank * E_local if split_e else 0
    split_s = (shard is not None and "shared_down" in params
               and params["shared_down"].shape[0]
               != cfg.moe.n_shared * (cfg.moe.d_expert or cfg.d_ff))
    xc = copy_to_model(xf, shard) if split_e or split_s else xf
    xs = xc if split_s else xf
    if split_e:
        xf, w_flat = xc, copy_to_model(w_flat, shard)
    out = torch.zeros((T, D), dtype=dtype, device=xf.device)
    start = sum(counts[:e0])
    for e in range(e0, e0 + E_local):
        n = counts[e]
        if n == 0:
            continue
        slots = order[start:start + n]
        start += n
        tok = slots // k
        rows = xf[tok]
        up = rows @ params["w_up"][e - e0].to(dtype)
        gate = (rows @ params["w_gate"][e - e0].to(dtype)
                if "w_gate" in params else None)
        h = _act(cfg, gate, up) @ params["w_down"][e - e0].to(dtype)
        out.index_add_(0, tok, h * w_flat[slots][:, None])

    # shared experts (always on)
    shared = None
    if "shared_up" in params:
        sup = xs @ params["shared_up"].to(dtype)
        sgate = (xs @ params["shared_gate"].to(dtype)
                 if "shared_gate" in params else None)
        shared = _act(cfg, sgate, sup) @ params["shared_down"].to(dtype)
    # with a shard, the split parts are summed over "model"; a replicated
    # part is whole on every rank and is added after the sum
    if split_e and split_s:
        out, shared = reduce_model(out + shared, shard), None
    elif split_e:
        out = reduce_model(out, shard)
    elif split_s:
        shared = reduce_model(shared, shard)
    return (out if shared is None else out + shared), aux
