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

RoPE (DESIGN.md §5): with full RoPE ("intra" mode) the rotation sits
between Q and K, so the cross-layer merge is illegal; PEFT mode then
orthogonalizes ``wk`` itself (intra-layer SVD) and trains the ``d x d``
transition ``k_t = diag(S) V^T``, and the Q-K pair has no spectrum (nor
pruning).  Partial RoPE ("partial" mode) gets the cross-layer treatment
on the un-rotated tail ``[rot:]``, the rotated head kept in front.  V-O
is cross-layer in every mode.

SVD factors are unique only up to sign and basis, so the port's factors
differ from the reference's; the spectra, the Q K^T / V O products and
the model's function agree.
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


def _intra_k(wk: torch.Tensor):
    """Intra-layer K orthogonalization (the RoPE fallback).  wk (D, KV,
    d) -> (Uk (KV, D, d) col-orthonormal, T (KV, d, d) = diag(S) Vt, the
    trainable transition) with wk[:, g] == Uk[g] @ T[g]."""
    U, S, Vt = svd_tall(wk.permute(1, 0, 2))
    return U, S[..., None] * Vt


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
                        ) -> Tuple[Params, Params, Dict[str, Any]]:
    """Orthogonalize one attention layer's Q-K and V-O pairs.

    Returns (new weights, trainables, spectra {"qk", "vo"} (KV, d)):
    ``peft=False`` (pruning) merges the singular values sqrt-balanced
    into both factors and has no trainables; ``peft=True`` keeps the
    factors orthonormal and returns ``s_qk`` (H, d, d) -- or, in intra
    mode, ``k_t`` (KV, d, d) -- and ``s_vo`` (H, d, d).  In partial mode
    the Q-K spectrum covers the tail (KV, d - rot); in intra mode it is
    None."""
    D, H, dq = attn["wq"].shape
    KV = attn["wk"].shape[1]
    dv = attn["wv"].shape[2]
    G = H // KV
    dtype = attn["wq"].dtype
    mode = qk_mode(cfg)
    rot = cfg.rope_dims if mode == "partial" else 0
    new: Params = dict(attn)
    train: Params = {}
    spectra: Dict[str, Any] = {}

    # ---- Q-K pair: cross-layer on [rot:] (all of it without RoPE) ------
    if mode in ("cross", "partial"):
        d_pass = dq - rot
        Uq, S, Vk = _group_qk(attn["wq"][..., rot:], attn["wk"][..., rot:],
                              G)
        spectra["qk"] = S
        if peft:
            wq = Uq.permute(2, 0, 1, 3).reshape(D, H, d_pass)
            wk = Vk.permute(1, 0, 2)
            s_pass = _repeat_diag(S, G)
            # block_diag(eye(rot), diag(S)) per head: identity on the
            # rotated head block
            s_qk = torch.zeros((H, dq, dq), dtype=torch.float32,
                               device=S.device)
            s_qk[:, range(rot), range(rot)] = 1.0
            s_qk[:, rot:, rot:] = s_pass
            train["s_qk"] = s_qk
        else:
            r = S.sqrt()                                       # (KV, d)
            wq = (Uq * r[:, None, None, :]).permute(2, 0, 1, 3).reshape(
                D, H, d_pass)
            wk = (Vk * r[:, None, :]).permute(1, 0, 2)
        if rot:
            wq = torch.cat([attn["wq"][..., :rot], wq.to(dtype)], dim=-1)
            wk = torch.cat([attn["wk"][..., :rot], wk.to(dtype)], dim=-1)
        new["wq"] = wq.to(dtype)
        new["wk"] = wk.contiguous().to(dtype)
    else:  # intra: PEFT-only K orthogonalization; pruning illegal (§5)
        spectra["qk"] = None
        if peft:
            Uk, Tk = _intra_k(attn["wk"])
            new["wk"] = Uk.permute(1, 0, 2).contiguous().to(dtype)
            train["k_t"] = Tk.float()

    # ---- V-O pair (no nonlinearity in any config: always legal) -------
    Uv, Svo, Vo = _group_vo(attn["wv"], attn["wo"], G)
    spectra["vo"] = Svo
    if peft:
        new["wv"] = Uv.permute(1, 0, 2).contiguous().to(dtype)
        new["wo"] = Vo.reshape(H, dv, D).to(dtype)
        train["s_vo"] = _repeat_diag(Svo, G)
    else:
        r = Svo.sqrt()
        new["wv"] = (Uv * r[:, None, :]).permute(1, 0, 2).contiguous().to(
            dtype)
        new["wo"] = (Vo * r[:, None, :, None]).reshape(H, dv, D).to(dtype)
    return new, train, spectra


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


def _map_layers(stacked: Params, nb: int, fn) -> Params:
    """Apply ``fn`` (one layer's dict of tensors -> a new dict) to each of
    the ``nb`` layers of a stacked dict, writing the results into
    preallocated stacked leaves one layer at a time: the peak is the new
    leaves plus one layer's temporaries.  A leaf that ``fn`` passes
    through unchanged keeps its stacked tensor (no copy)."""
    out: Params = {}
    for i in range(nb):
        view = {k: v[i] for k, v in stacked.items()}
        for k, t in fn(view).items():
            if k in view and t is view[k]:
                out.setdefault(k, stacked[k])
                continue
            if k not in out:
                out[k] = t.new_empty((nb,) + tuple(t.shape))
            out[k][i] = t
    return out


@torch.no_grad()
def clover_decompose(params: Params, cfg: ArchConfig, *, peft: bool = False,
                     include_up: bool = True,
                     ) -> Tuple[Params, ArchConfig, list]:
    """Orthogonalize every attention layer of the stacked params (and,
    with ``peft`` and ``include_up``, every MLP.Up: dense ``w_up`` and
    the RWKV channel-mix ``wk``).

    Returns (params', cfg', extras) with extras[j] = {"spectra": {"qk":
    (n_blocks, KV, d), "vo": (n_blocks, KV, d)}} per pattern position
    ({} for positions without attention; no "qk" in intra mode, and a
    partial-RoPE "qk" covers the (d - rot) tail).  In PEFT mode the
    trainable transitions (``s_qk`` or ``k_t``, ``s_vo``, ``up_t``) sit
    inside the layer trees, where ``models.layers`` applies them and
    ``core.peft.partition`` finds them.  The reference vmaps over the
    stacked block axis; the port loops, writing each layer into the
    stacked leaves (``_map_layers``)."""
    new_blocks, extras = [], []
    nb = cfg.n_blocks
    spectra: list = []

    def attn_layer(view):
        w, train, sp = decompose_attention(view, cfg, peft=peft)
        spectra.append(sp)
        return dict(w, **train)

    def up_layer(view, key):
        w, train = decompose_up(view, cfg, key_name=key)
        return dict(w, **train)

    for j, (mixer, mlp) in enumerate(cfg.pattern):
        stacked = dict(params["blocks"][j])
        extra: Dict[str, Any] = {"spectra": {}}
        if mixer == MIXER_ATTN:
            spectra.clear()
            stacked["attn"] = _map_layers(stacked["attn"], nb, attn_layer)
            # intra mode has no Q-K spectrum: the key is left out, as the
            # reference drops None entries
            extra["spectra"] = {
                name: torch.stack([sp[name] for sp in spectra])
                for name in ("qk", "vo") if spectra[0][name] is not None}
        up = {MLP_DENSE: ("mlp", "w_up"), MLP_RWKV: ("rwkv_chan", "wk")}
        if include_up and peft and mlp in up:
            name, key = up[mlp]
            stacked[name] = _map_layers(stacked[name], nb,
                                        lambda v, k=key: up_layer(v, k))
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
            if "k_t" in attn:
                wk = attn["wk"]
                attn["wk"] = torch.einsum(
                    "bdkq,bkqr->bdkr", wk, attn.pop("k_t").to(wk.dtype))
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
