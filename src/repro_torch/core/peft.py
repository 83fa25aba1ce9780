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
reference's distributions, not its bits).

SV adapters (DESIGN.md §13), the serving side of CLOVER-S:
``sv_extract`` / ``sv_fold`` read and write the diagonals of the
``s_qk`` / ``s_vo`` transitions, and ``AdapterRegistry`` keeps
per-tenant multiplicative scales of them, stacked by ``bank()`` into
the gather buffers the serving executor selects per slot.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

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


# ---------------------------------------------------------------------------
# SV adapters: per-tenant diagonal scalings of the CLOVER transitions
# (serving-side counterpart of CLOVER-S; DESIGN.md §13)
# ---------------------------------------------------------------------------

# (transition key in the layer tree, diagonal key in the adapter tree)
SV_ADAPTER_KEYS = (("s_qk", "s_qk_diag"), ("s_vo", "s_vo_diag"))


def sv_extract(params: Params) -> Tuple[Dict[str, torch.Tensor], ...]:
    """The rank-space diagonals of the CLOVER SV transitions, one dict
    per pattern position: ``s_qk_diag`` (nb, H, dq) / ``s_vo_diag`` (nb,
    H, dv), copies.  A key is absent where the position has no such
    transition (full-RoPE Q-K, non-attention mixers, an undecomposed
    model)."""
    out = []
    for stacked in params["blocks"]:
        attn = stacked.get("attn", {})
        out.append({dst: torch.diagonal(attn[src], dim1=-2,
                                        dim2=-1).clone()
                    for src, dst in SV_ADAPTER_KEYS if src in attn})
    return tuple(out)


def sv_fold(params: Params, adapter) -> Params:
    """Write an SV-adapter tree's diagonals back into the transitions:
    the exact inverse of ``sv_extract`` (``sv_fold(p, sv_extract(p))`` is
    ``p`` bit for bit).  Only diagonal entries change; off-diagonal
    content (the partial-RoPE identity block) and every other key
    (``k_t`` / ``up_t`` included) pass through as the same tensors."""
    new_blocks = []
    for stacked, entry in zip(params["blocks"], adapter):
        stacked = dict(stacked)
        if entry and "attn" in stacked:
            attn = dict(stacked["attn"])
            for src, dst in SV_ADAPTER_KEYS:
                if dst in entry:
                    mat = attn[src]
                    eye = torch.eye(mat.shape[-1], dtype=torch.bool,
                                    device=mat.device)
                    diag = torch.as_tensor(entry[dst], device=mat.device)
                    attn[src] = torch.where(eye, diag[..., :, None].to(
                        mat.dtype), mat)
            stacked["attn"] = attn
        new_blocks.append(stacked)
    return dict(params, blocks=tuple(new_blocks))


class AdapterRegistry:
    """Host-side, versioned registry of per-tenant SV adapters.

    Stores MULTIPLICATIVE per-head rank-space scale trees shaped like
    ``sv_extract``'s output, on the params' device.  Id 0 is always the
    identity (all ones): the engine multiplies the scales into the
    ``s_qk`` / ``s_vo`` outputs, and ``x * 1.0 == x`` makes identity
    streams bit for bit the base model's.  Ids are dense ``0..n-1``, so
    every adapter stacks into one fixed-shape gather bank (DESIGN.md
    §13)."""

    def __init__(self, params: Params):
        self._base = sv_extract(params)
        if not any(self._base):
            raise ValueError(
                "AdapterRegistry needs clover_decompose(peft=True) params "
                "(no s_qk/s_vo transitions found)")
        identity = tuple({k: torch.ones_like(v) for k, v in entry.items()}
                         for entry in self._base)
        self._scales = [identity]
        self._versions = [0]
        self.generation = 0

    def __len__(self) -> int:
        return len(self._scales)

    @property
    def n_adapters(self) -> int:
        return len(self._scales)

    def _validated(self, scales):
        scales = tuple(dict(entry) for entry in scales)
        if len(scales) != len(self._base):
            raise ValueError(
                f"adapter has {len(scales)} pattern positions, "
                f"base has {len(self._base)}")
        out = []
        for entry, base in zip(scales, self._base):
            if set(entry) != set(base):
                raise ValueError(
                    f"adapter keys {sorted(entry)} != base {sorted(base)}")
            for k, v in entry.items():
                if tuple(v.shape) != tuple(base[k].shape):
                    raise ValueError(
                        f"{k}: adapter shape {tuple(v.shape)} != "
                        f"base {tuple(base[k].shape)}")
            # float32, as the reference's arrays are (JAX runs without
            # float64)
            out.append({k: torch.as_tensor(v, device=base[k].device).float()
                        for k, v in entry.items()})
        return tuple(out)

    def scales_from_finetuned(self, diags):
        """A fine-tuned ``sv_extract`` tree (absolute singular values) ->
        the multiplicative scales the engine applies, ``finetuned /
        base``, with pruned (zero) base entries left at 1."""
        return tuple(
            {k: torch.where(base[k] != 0,
                            torch.as_tensor(v, device=base[k].device)
                            / base[k],
                            torch.ones_like(base[k])).float()
             for k, v in entry.items()}
            for entry, base in zip(diags, self._base))

    def register(self, scales) -> int:
        """Add an adapter (multiplicative scale tree); -> its id."""
        self._scales.append(self._validated(scales))
        self._versions.append(0)
        self.generation += 1
        return len(self._scales) - 1

    def update(self, adapter_id: int, scales) -> int:
        """Replace an adapter in place; -> its bumped version."""
        if adapter_id == 0:
            raise ValueError("adapter id 0 is the reserved identity")
        self._scales[adapter_id] = self._validated(scales)
        self._versions[adapter_id] += 1
        self.generation += 1
        return self._versions[adapter_id]

    def get(self, adapter_id: int):
        return self._scales[adapter_id]

    def version(self, adapter_id: int) -> int:
        return self._versions[adapter_id]

    def folded(self, params: Params, adapter_id: int) -> Params:
        """``params`` with adapter ``adapter_id`` merged into the
        ``s_qk`` / ``s_vo`` diagonals: the single-tenant model every
        multi-tenant stream is gated against.  Identity folds back bit
        for bit."""
        scaled = tuple(
            {k: base[k] * entry[k] for k in base}
            for base, entry in zip(self._base, self._scales[adapter_id]))
        return sv_fold(params, scaled)

    def bank(self) -> Tuple[Optional[Dict[str, torch.Tensor]], ...]:
        """Every adapter stacked into per-position gather buffers: one
        dict per pattern position mapping ``a_qk`` / ``a_vo`` to (nb, A,
        H, d) float32 tensors (A adapters, the id indexes axis 1), or
        ``None`` where the position has no SV transitions.  The bank's
        shape is fixed for an engine's lifetime, so the per-slot
        selection is data, not a new step shape (DESIGN.md §13)."""
        bank_keys = {"s_qk_diag": "a_qk", "s_vo_diag": "a_vo"}
        out = []
        for j, base in enumerate(self._base):
            if not base:
                out.append(None)
                continue
            out.append({bank_keys[dst]: torch.stack(
                [sc[j][dst].float() for sc in self._scales], dim=1)
                for dst in base})
        return tuple(out)
