"""CLOVER cross-layer orthogonal decomposition — own port of
``repro/core/decompose.py`` for the pruning mode (DESIGN.md §2).

The Q-K and V-O pairs of each attention head are low-rank factors of
``D x D`` products; an SVD of each product (through the QR trick, never
materializing ``D x D``) re-expresses the pair in orthogonal bases
sorted by singular value, which preserves the function.  For a GQA
group the row-stack of the group's query heads shares one set of K
directions; MHA is the G = 1 case, the paper's setting.

SVD factors are unique only up to sign and basis, so the port's factors
differ from the reference's; the spectra, the Q K^T / V O products and
the model's function agree.  PEFT mode (``peft=True``), the RoPE modes
and MLP.Up decomposition arrive with the training slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig, MIXER_ATTN

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


def decompose_attention(attn: Params, cfg: ArchConfig, *, peft: bool
                        ) -> Tuple[Params, Params, Dict[str, torch.Tensor]]:
    """Orthogonalize one attention layer's Q-K and V-O pairs (pruning
    mode: singular values merged sqrt-balanced into both factors).
    Returns (new weights, trainables {} , spectra {"qk", "vo"})."""
    if peft:
        raise NotImplementedError("CLOVER PEFT mode arrives with the "
                                  "training slice")
    if qk_mode(cfg) != "cross":
        raise NotImplementedError("RoPE configs are not ported yet")
    D, H, dq = attn["wq"].shape
    KV = attn["wk"].shape[1]
    dv = attn["wv"].shape[2]
    G = H // KV
    dtype = attn["wq"].dtype
    new: Params = dict(attn)

    Uq, S, Vk = _group_qk(attn["wq"], attn["wk"], G)
    r = S.sqrt()                                               # (KV, d)
    wq = Uq * r[:, None, None, :]
    new["wq"] = wq.permute(2, 0, 1, 3).reshape(D, H, dq).to(dtype)
    new["wk"] = (Vk * r[:, None, :]).permute(1, 0, 2).contiguous().to(dtype)

    Uv, Svo, Vo = _group_vo(attn["wv"], attn["wo"], G)
    r = Svo.sqrt()
    new["wv"] = (Uv * r[:, None, :]).permute(1, 0, 2).contiguous().to(dtype)
    new["wo"] = (Vo * r[:, None, :, None]).reshape(H, dv, D).to(dtype)
    return new, {}, {"qk": S, "vo": Svo}


@torch.no_grad()
def clover_decompose(params: Params, cfg: ArchConfig, *, peft: bool = False,
                     ) -> Tuple[Params, ArchConfig, list]:
    """Orthogonalize every attention layer of the stacked params.

    Returns (params', cfg', extras) with extras[j] = {"spectra": {"qk":
    (n_blocks, KV, d), "vo": (n_blocks, KV, d)}} per pattern position.
    The reference vmaps over the stacked block axis; the port loops.
    """
    if peft:
        raise NotImplementedError("CLOVER PEFT mode arrives with the "
                                  "training slice")
    new_blocks, extras = [], []
    for j, (mixer, _) in enumerate(cfg.pattern):
        stacked = dict(params["blocks"][j])
        extra: Dict[str, Any] = {"spectra": {}}
        if mixer == MIXER_ATTN:
            attn = stacked["attn"]
            outs = [decompose_attention({k: v[i] for k, v in attn.items()},
                                        cfg, peft=False)
                    for i in range(cfg.n_blocks)]
            stacked["attn"] = {k: torch.stack([o[0][k] for o in outs])
                               for k in attn}
            extra["spectra"] = {name: torch.stack([o[2][name] for o in outs])
                                for name in ("qk", "vo")}
        new_blocks.append(stacked)
        extras.append(extra)
    out = dict(params)
    out["blocks"] = tuple(new_blocks)
    new_cfg = dataclasses.replace(
        cfg, clover=dataclasses.replace(cfg.clover, enabled=True,
                                        finetune_s=False))
    return out, new_cfg, extras
