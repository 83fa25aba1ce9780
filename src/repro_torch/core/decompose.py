"""CLOVER cross-layer orthogonal decomposition — own port of
``repro/core/decompose.py`` for the pruning mode (DESIGN.md §2).

The Q-K and V-O pairs of each attention head are low-rank factors of
``D x D`` products; an SVD of each product (through the QR trick, never
materializing ``D x D``) re-expresses the pair in orthogonal bases
sorted by singular value, which preserves the function.  For a GQA
group the row-stack of the group's query heads shares one set of K
directions; MHA is the G = 1 case, the paper's setting.

PEFT mode (``peft=True``, CLOVER-S) keeps the factors orthonormal and
makes the singular values trainable ``d x d`` transitions inside the
layer trees: ``s_qk`` (applied to q) and ``s_vo`` (applied to the
context before ``wo``), each initialised to its group's diagonal
repeated over the group's G query heads.  MLP.Up (dense ``w_up``, RWKV
channel-mix ``wk``) is decomposed blockwise, intra-layer:
``up_u`` orthonormal and ``up_t`` the trainable ``block x block``
transition.  ``merge_clover`` folds the transitions back, keeping the
parameter count.

SVD factors are unique only up to sign and basis, so the port's factors
differ from the reference's; the spectra, the Q K^T / V O products and
the model's function agree.  The RoPE modes (intra, partial) arrive
with the RoPE configs and raise here.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import (ArchConfig, MIXER_ATTN, MLP_DENSE,
                                      MLP_RWKV)

Params = Dict[str, Any]


def svd_lowrank_product(A: torch.Tensor, B: torch.Tensor):
    """SVD of ``A @ B^T`` without materializing it (batched over
    leading dims).  A: (..., M, d), B: (..., N, d) with d << M, N.
    Returns (U (..., M, d), S (..., d) descending, Vt (..., d, N)) with
    ``A @ B^T == (U * S) @ Vt``."""
    A = A.float()
    B = B.float()
    Qa, Ra = torch.linalg.qr(A)
    Qb, Rb = torch.linalg.qr(B)
    Us, S, Vst = torch.linalg.svd(Ra @ Rb.transpose(-1, -2))
    return Qa @ Us, S, Vst @ Qb.transpose(-1, -2)


def svd_tall(W: torch.Tensor):
    """Economic SVD of tall matrices W (..., M, d), M >= d, through QR.
    Returns (U (..., M, d), S (..., d), Vt (..., d, d))."""
    Q, R = torch.linalg.qr(W.float())
    Us, S, Vt = torch.linalg.svd(R)
    return Q @ Us, S, Vt


def _group_qk(wq: torch.Tensor, wk: torch.Tensor, G: int):
    """wq (D, H, d), wk (D, KV, d) -> (Uq (KV, G, D, d), S (KV, d),
    Vk (KV, D, d)) with wq[:, g*G+j] @ wk[:, g]^T ==
    (Uq[g, j] * S[g]) @ Vk[g]^T."""
    D, H, d = wq.shape
    KV = wk.shape[1]
    A = wq.permute(1, 0, 2).reshape(KV, G * D, d)
    B = wk.permute(1, 0, 2)
    U, S, Vt = svd_lowrank_product(A, B)
    return U.reshape(KV, G, D, d), S, Vt.transpose(-1, -2)


def _group_vo(wv: torch.Tensor, wo: torch.Tensor, G: int):
    """wv (D, KV, d), wo (H, d, D) -> (Uv (KV, D, d), S (KV, d),
    Vo (KV, G, d, D)) with wv[:, g] @ wo[g*G+j] == (Uv[g] * S[g]) @
    Vo[g, j]."""
    D, KV, d = wv.shape
    A = wv.permute(1, 0, 2)
    Bt = wo.reshape(KV, G, d, D).permute(0, 1, 3, 2).reshape(KV, G * D, d)
    U, S, Vt = svd_lowrank_product(A, Bt)
    Vo = Vt.reshape(KV, d, G, D).permute(0, 2, 1, 3)
    return U, S, Vo


def qk_mode(cfg: ArchConfig) -> str:
    """How the Q-K pair may be treated (DESIGN.md §5): "cross" without
    RoPE, "partial" with partial RoPE, "intra" with full RoPE."""
    if cfg.rope_dims == 0:
        return "cross"
    if cfg.rope_dims < cfg.head_dim_:
        return "partial"
    return "intra"


def _block_up(w_up: torch.Tensor, block: int):
    """Blockwise intra-layer decomposition of MLP.Up (the paper's U-D
    pairs).  w_up (D, F), F % block == 0 -> (Uu (D, nb, block), T (nb,
    block, block)) with w_up[:, n*block:(n+1)*block] == Uu[:, n] @
    T[n]."""
    D, F = w_up.shape
    nb = F // block
    U, S, Vt = svd_tall(w_up.reshape(D, nb, block).permute(1, 0, 2))
    return U.permute(1, 0, 2).contiguous(), S[..., None] * Vt


def _repeat_diag(S: torch.Tensor, G: int) -> torch.Tensor:
    """(KV, d) spectra -> (KV*G, d, d) diagonals, group g's repeated for
    its G query heads (``jnp.repeat`` order)."""
    return torch.repeat_interleave(torch.diag_embed(S), G, dim=0).float()


def decompose_attention(attn: Params, cfg: ArchConfig, *, peft: bool
                        ) -> Tuple[Params, Params, Dict[str, torch.Tensor]]:
    """Orthogonalize one attention layer's Q-K and V-O pairs.

    Returns (new weights, trainables, spectra {"qk", "vo"} (KV, d)):
    ``peft=False`` (pruning) merges the singular values sqrt-balanced
    into both factors and has no trainables; ``peft=True`` keeps the
    factors orthonormal and returns ``s_qk`` / ``s_vo`` (H, d, d)."""
    if qk_mode(cfg) != "cross":
        raise NotImplementedError("RoPE configs are not ported yet")
    D, H, dq = attn["wq"].shape
    KV = attn["wk"].shape[1]
    dv = attn["wv"].shape[2]
    G = H // KV
    dtype = attn["wq"].dtype
    new: Params = dict(attn)
    train: Params = {}

    Uq, S, Vk = _group_qk(attn["wq"], attn["wk"], G)
    Uv, Svo, Vo = _group_vo(attn["wv"], attn["wo"], G)
    if peft:
        new["wq"] = Uq.permute(2, 0, 1, 3).reshape(D, H, dq).to(dtype)
        new["wk"] = Vk.permute(1, 0, 2).contiguous().to(dtype)
        new["wv"] = Uv.permute(1, 0, 2).contiguous().to(dtype)
        new["wo"] = Vo.reshape(H, dv, D).to(dtype)
        train["s_qk"] = _repeat_diag(S, G)
        train["s_vo"] = _repeat_diag(Svo, G)
        return new, train, {"qk": S, "vo": Svo}
    r = S.sqrt()                                               # (KV, d)
    wq = Uq * r[:, None, None, :]
    new["wq"] = wq.permute(2, 0, 1, 3).reshape(D, H, dq).to(dtype)
    new["wk"] = (Vk * r[:, None, :]).permute(1, 0, 2).contiguous().to(dtype)
    r = Svo.sqrt()
    new["wv"] = (Uv * r[:, None, :]).permute(1, 0, 2).contiguous().to(dtype)
    new["wo"] = (Vo * r[:, None, :, None]).reshape(H, dv, D).to(dtype)
    return new, train, {"qk": S, "vo": Svo}


def decompose_up(mlp: Params, cfg: ArchConfig, *, key_name: str = "w_up",
                 ) -> Tuple[Params, Params]:
    """Blockwise Up decomposition of one layer (intra-layer; PEFT mode)
    of dense-MLP ``w_up`` or the RWKV channel-mix ``wk``.  -> (new
    sub-tree with ``up_u`` in place of ``key_name``, {"up_t"}); a width
    that is not a multiple of the block passes through.  (The
    reference's ``peft=False`` form has no caller and is not ported.)"""
    W = mlp[key_name]
    block = min(cfg.clover.up_block, W.shape[1])
    if W.shape[1] % block != 0:
        return mlp, {}
    Uu, Tt = _block_up(W, block)
    new = dict(mlp)
    del new[key_name]
    new["up_u"] = Uu.to(W.dtype)
    return new, {"up_t": Tt.float()}


def _stack_layers(outs):
    """List of per-layer trees (dicts of tensors) -> stacked dict."""
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


@torch.no_grad()
def clover_decompose(params: Params, cfg: ArchConfig, *, peft: bool = False,
                     include_up: bool = True,
                     ) -> Tuple[Params, ArchConfig, list]:
    """Orthogonalize every attention layer of the stacked params (and,
    with ``peft`` and ``include_up``, every MLP.Up: dense ``w_up`` and
    the RWKV channel-mix ``wk``).

    Returns (params', cfg', extras) with extras[j] = {"spectra": {"qk":
    (n_blocks, KV, d), "vo": (n_blocks, KV, d)}} per pattern position
    ({} for positions without attention).  In PEFT mode the trainable
    transitions (``s_qk``, ``s_vo``, ``up_t``) sit inside the layer
    trees, where ``models.layers`` applies them and
    ``core.peft.partition`` finds them.  The reference vmaps over the
    stacked block axis; the port loops.
    """
    new_blocks, extras = [], []
    nb = cfg.n_blocks
    for j, (mixer, mlp) in enumerate(cfg.pattern):
        stacked = dict(params["blocks"][j])
        extra: Dict[str, Any] = {"spectra": {}}
        if mixer == MIXER_ATTN:
            attn = stacked["attn"]
            outs = [decompose_attention({k: v[i] for k, v in attn.items()},
                                        cfg, peft=peft) for i in range(nb)]
            stacked["attn"] = _stack_layers([dict(o[0], **o[1])
                                             for o in outs])
            extra["spectra"] = {name: torch.stack([o[2][name] for o in outs])
                                for name in ("qk", "vo")}
        up = {MLP_DENSE: ("mlp", "w_up"), MLP_RWKV: ("rwkv_chan", "wk")}
        if include_up and peft and mlp in up:
            name, key = up[mlp]
            sub = stacked[name]
            outs = [decompose_up({k: v[i] for k, v in sub.items()}, cfg,
                                 key_name=key) for i in range(nb)]
            stacked[name] = _stack_layers([dict(o[0], **o[1])
                                           for o in outs])
        new_blocks.append(stacked)
        extras.append(extra)
    out = dict(params)
    out["blocks"] = tuple(new_blocks)
    new_cfg = dataclasses.replace(
        cfg, clover=dataclasses.replace(cfg.clover, enabled=True,
                                        finetune_s=peft))
    return out, new_cfg, extras


def _einsum(spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """einsum with the operands promoted to one dtype, as jnp does."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(spec, a.to(dt), b.to(dt))


@torch.no_grad()
def merge_clover(params: Params, cfg: ArchConfig) -> Tuple[Params, ArchConfig]:
    """Fold the trainable transitions back into the weights (the paper:
    "reintegrated into the model without increasing its parameter
    count").  Inverse of PEFT-mode decomposition; function-preserving.
    Works on the stacked leaves (leading ``n_blocks`` axis)."""
    new_blocks = []
    for stacked in params["blocks"]:
        stacked = dict(stacked)
        if "attn" in stacked:
            attn = dict(stacked["attn"])
            if "s_qk" in attn:
                wq = attn["wq"]
                attn["wq"] = torch.einsum(
                    "bdhq,bhqr->bdhr", wq, attn.pop("s_qk").to(wq.dtype))
            if "s_vo" in attn:
                wo = attn["wo"]
                attn["wo"] = torch.einsum(
                    "bhvw,bhwd->bhvd", attn.pop("s_vo").to(wo.dtype), wo)
            stacked["attn"] = attn
        for name, wkey in (("mlp", "w_up"), ("rwkv_chan", "wk")):
            if name in stacked and "up_t" in stacked[name]:
                sub = dict(stacked[name])
                t_dtype = (sub["w_down"].dtype if "w_down" in sub
                           else torch.float32)
                W = _einsum("bdnr,bnrk->bdnk", sub.pop("up_u"),
                            sub.pop("up_t").to(t_dtype))
                sub[wkey] = W.reshape(W.shape[0], W.shape[1], -1)
                stacked[name] = sub
        new_blocks.append(stacked)
    out = dict(params)
    out["blocks"] = tuple(new_blocks)
    new_cfg = dataclasses.replace(
        cfg, clover=dataclasses.replace(cfg.clover, finetune_s=False))
    return out, new_cfg
