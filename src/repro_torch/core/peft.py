"""Parameter-efficient fine-tuning: CLOVER-S and the paper's baselines
— own port of ``repro/core/peft.py`` (its training half).

CLOVER-S: after ``clover_decompose(peft=True)`` the trainable
transitions live INSIDE the param tree under ``s_qk / k_t / s_vo /
up_t``; ``partition`` splits the tree into (trainable, frozen) halves
for the optimizer (``None`` at the complementary positions) and
``merge_clover`` folds the transitions back afterwards.

Table 2's baselines (LoRA / DoRA / PiSSA) are adapter trees over the
2D-flattened target weights, keyed by the reference's
``jax.tree_util.keystr`` path strings (``['blocks'][0]['attn']['wq']``)
so that adapter trees cross the bridge under the same names;
``materialize`` produces the effective params of the forward pass.
Random draws come from an explicit ``torch.Generator`` (the
reference's distributions, not its bits).  The serving-side SV adapters
(``sv_extract``, ``sv_fold``, ``AdapterRegistry``) arrive with the
adapter-serving slice.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from repro_torch.tree import (tree_leaves, tree_leaves_with_path,
                              tree_map, tree_map_with_path)

Params = Dict[str, Any]

# Keys that clover_decompose(peft=True) marks trainable.
CLOVER_TRAIN_KEYS = ("s_qk", "k_t", "s_vo", "up_t")

# LoRA-family default targets (paper Table 3: Q, K, V, Up, Down).
LORA_TARGETS = ("wq", "wk", "wv", "w_up", "w_down")

_KEY = re.compile(r"\['([^']*)'\]")


def _keys(path: str):
    return _KEY.findall(path)


# ---------------------------------------------------------------------------
# partition / combine for CLOVER-S training
# ---------------------------------------------------------------------------

def partition(params: Params) -> Tuple[Params, Params]:
    """Split into (trainable, frozen) trees of identical structure, with
    ``None`` at the complementary positions."""
    def trainable(path):
        return any(k in CLOVER_TRAIN_KEYS for k in _keys(path))
    return (tree_map_with_path(
                lambda p, x: x if trainable(p) else None, params),
            tree_map_with_path(
                lambda p, x: None if trainable(p) else x, params))


def combine(trainable: Params, frozen: Params) -> Params:
    """Inverse of ``partition``."""
    return tree_map(lambda f, t: t if f is None else f, frozen, trainable)


def count_params(tree) -> int:
    return sum(int(x.numel()) for x in tree_leaves(tree))


# ---------------------------------------------------------------------------
# LoRA / DoRA / PiSSA baselines
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class PeftConfig:
    method: str = "lora"          # lora | dora | pissa
    rank: int = 32
    alpha: float = 32.0
    targets: Tuple[str, ...] = LORA_TARGETS

    @property
    def scale(self) -> float:
        """Nominal scale; per-adapter code uses ``alpha / r_eff``
        because ``init_adapters`` clamps the rank on narrow targets."""
        return self.alpha / self.rank


def _flat2d(w: torch.Tensor) -> torch.Tensor:
    """Flatten a stacked target weight to (n_blocks, in, out):
    (nb, D, F) unchanged (w_up / w_down), (nb, D, H, d) -> (nb, D, H*d)
    (wq / wk / wv), (nb, H, d, D) -> (nb, H*d, D) (wo)."""
    if w.dim() == 3:
        return w
    if w.dim() == 4:
        if w.shape[1] >= w.shape[3]:
            return w.reshape(w.shape[0], w.shape[1], -1)
        return w.reshape(w.shape[0], -1, w.shape[3])
    raise ValueError(tuple(w.shape))


def _principal(W: torch.Tensor, r: int):
    """Top-``r`` singular triplets of W (nb, in, out): (U (nb, in, r),
    S (nb, r) descending, Vt (nb, r, out)) -- the reference's SVD
    factors up to sign.  PiSSA needs only the top ``r``, so they come
    from the symmetric eigendecomposition of the smaller Gram matrix
    instead of a full SVD of every target (240 of up to 1600 x 6400 at
    gpt2-xl)."""
    if W.shape[1] <= W.shape[2]:
        evals, evecs = torch.linalg.eigh(W @ W.mT)
        U = evecs[..., -r:].flip(-1)
        S = evals[..., -r:].flip(-1).clamp_min(0).sqrt()
        return U, S, (U.mT @ W) / S[..., None]
    evals, evecs = torch.linalg.eigh(W.mT @ W)
    V = evecs[..., -r:].flip(-1)
    S = evals[..., -r:].flip(-1).clamp_min(0).sqrt()
    return (W @ V) / S[:, None, :], S, V.mT


def _targets(params: Params, pcfg: PeftConfig):
    """(path, leaf) of every adapter target (stacked block weights)."""
    for path, leaf in tree_leaves_with_path(params):
        keys = _keys(path)
        if leaf is not None and keys and keys[-1] in pcfg.targets \
                and leaf.dim() >= 3:
            yield path, leaf


@torch.no_grad()
def init_adapters(params: Params, pcfg: PeftConfig,
                  gen: torch.Generator) -> Params:
    """Adapter tree keyed by path string; one adapter per block (leading
    ``nb`` axis throughout), float32:

    lora:  {a (nb, r, in) ~ N(0, 1/in), b (nb, out, r) zeros, r_eff}
    dora:  lora + {m (nb, out)} column magnitudes
    pissa: {a, b} = principal SVD factors (sqrt(S) on each side); the
           params must then be replaced by ``pissa_residual`` so that
           ``materialize`` gives the original weights at init.
    ``r_eff`` (0-d float32) is the rank after clamping to the target's
    narrow side; ``materialize`` scales by ``alpha / r_eff``."""
    adapters: Params = {}
    for name, leaf in _targets(params, pcfg):
        W = _flat2d(leaf).float()                          # (nb, in, out)
        nb, n_in, n_out = W.shape
        r = min(pcfg.rank, n_in, n_out)
        if pcfg.method in ("lora", "dora"):
            a = torch.randn((nb, r, n_in), generator=gen,
                            device=gen.device).to(W.device)
            ad = {"a": a * (1.0 / n_in ** 0.5),
                  "b": torch.zeros((nb, n_out, r), device=W.device)}
            if pcfg.method == "dora":
                ad["m"] = torch.linalg.vector_norm(W, dim=1)   # (nb, out)
        elif pcfg.method == "pissa":
            U, S, Vt = _principal(W, r)
            sr = S.sqrt()                                      # (nb, r)
            ad = {"a": U.transpose(1, 2) * sr[:, :, None],
                  "b": Vt.transpose(1, 2) * sr[:, None, :]}
        else:
            raise ValueError(pcfg.method)
        ad["r_eff"] = torch.tensor(float(r), dtype=torch.float32,
                                   device=W.device)
        adapters[name] = ad
    return adapters


def _delta(ad) -> torch.Tensor:
    """(nb, in, out) low-rank update b a."""
    return torch.einsum("nor,nri->nio", ad["b"], ad["a"])


def _ad_scale(ad, pcfg: PeftConfig):
    """alpha / effective rank of ONE adapter (the nominal scale for an
    adapter without ``r_eff``); no gradient reaches ``r_eff``."""
    r_eff = ad.get("r_eff")
    if r_eff is None:
        return pcfg.scale
    return pcfg.alpha / r_eff.detach()


def materialize(params: Params, adapters: Params, pcfg: PeftConfig) -> Params:
    """Effective params for the forward pass: W' = f(W, adapter).
    Differentiable in the adapters."""
    def visit(path, leaf):
        if path not in adapters:
            return leaf
        ad = adapters[path]
        W = _flat2d(leaf).float()                          # (nb, in, out)
        if pcfg.method == "pissa":
            # params are the RESIDUAL (pissa_residual); training moves
            # the principal component itself
            Wp = W + _delta(ad)
        elif pcfg.method == "dora":
            V = W + _ad_scale(ad, pcfg) * _delta(ad)
            norm = torch.linalg.vector_norm(V, dim=1, keepdim=True)
            Wp = ad["m"][:, None, :] * V / norm.clamp_min(1e-6)
        else:
            Wp = W + _ad_scale(ad, pcfg) * _delta(ad)
        return Wp.reshape(leaf.shape).to(leaf.dtype)
    return tree_map_with_path(visit, params)


@torch.no_grad()
def pissa_residual(params: Params, adapters: Params,
                   pcfg: PeftConfig) -> Params:
    """Subtract the initial principal component, so that
    ``materialize(residual, adapters)`` == the original params at init."""
    def visit(path, leaf):
        if path not in adapters:
            return leaf
        W = _flat2d(leaf).float() - _delta(adapters[path])
        return W.reshape(leaf.shape).to(leaf.dtype)
    return tree_map_with_path(visit, params)


@torch.no_grad()
def merge_adapters(params: Params, adapters: Params,
                   pcfg: PeftConfig) -> Params:
    """Fold adapters into the weights (post-training)."""
    return materialize(params, adapters, pcfg)
