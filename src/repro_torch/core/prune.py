"""CLOVER pruning planner — own port of ``repro/core/prune.py``
(DESIGN.md §3, §4, §14): uniform pruning, threshold planning and
spectrum-planned rank budgets, and the vanilla magnitude-pruning
baseline of Table 1.

After ``clover_decompose`` every head's factors are sorted by singular
value, so structured pruning is a static slice ``[..., :r]`` at the same
rate in every layer (the paper's setting).  The KV cache then stores K
at rank ``r_qk`` and V at rank ``r_vo``.  Kept ranks snap UP to
``cfg.clover.rank_multiple``.  A ``RankBudget`` spends one global rank
budget non-uniformly across layers and heads by singular-value energy
(§14); ``draft_ranks`` sizes the self-speculative draft (§8).
``vanilla_prune`` is the paper's baseline: per-dimension
magnitude pruning of the raw, unorthogonalized weights.  For
tensor-parallel serving (§10) ``rank_balanced_partition`` plans which
shard owns which KV heads so every shard carries about the same pruned
rank load, and ``permute_attention_heads`` lays the heads out so each
shard's heads are one contiguous slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, MIXER_ATTN
from repro_torch.core.analytics import energy_blocks, host_array
from repro_torch.core.decompose import qk_mode

Params = Dict[str, Any]

# nested per-plan rank table: [pattern position][stacked block][kv head]
RankTable = Tuple[Tuple[Tuple[int, ...], ...], ...]


def snap_rank(r: int, multiple: int, d: int) -> int:
    """Snap a kept rank UP to ``multiple``, capped at d."""
    if multiple <= 1:
        return max(1, min(r, d))
    return max(multiple, min(d, ((r + multiple - 1) // multiple) * multiple))


def plan_ranks(cfg: ArchConfig, qk_ratio: float, vo_ratio: float
               ) -> Tuple[int, int]:
    """Kept per-head widths (qk_keep, vo_keep) for a pruning ratio."""
    d = cfg.head_dim_
    m = cfg.clover.rank_multiple
    mode = qk_mode(cfg)
    if mode == "cross":
        qk_keep = snap_rank(round(d * (1.0 - qk_ratio)), m, d)
    elif mode == "partial":
        rot = cfg.rope_dims
        tail = d - rot
        qk_keep = rot + snap_rank(round(tail * (1.0 - qk_ratio)), m, tail)
    else:  # intra (full RoPE): Q-K pruning illegal (paper §5)
        qk_keep = d
    vo_keep = snap_rank(round(d * (1.0 - vo_ratio)), m, d)
    return qk_keep, vo_keep


def draft_ranks(cfg: ArchConfig, ratio: float) -> Tuple[int, int]:
    """Per-head (qk, vo) widths of the self-speculative DRAFT model
    (DESIGN.md §8): the same weights with the last orthogonal directions
    of every head sliced off.  ``ratio`` applies to the CURRENT widths
    (which may already be pruned).  As in ``plan_ranks``, partial-RoPE
    mode shrinks only the NoPE tail (slicing inside the rotated block
    would break RoPE's dim pairing) and intra mode (full RoPE) never
    slices Q-K, only V-O.  Widths snap UP to ``rank_multiple``."""
    dq, dv = cfg.qk_dim, cfg.vo_dim
    m = cfg.clover.rank_multiple
    mode = qk_mode(cfg)
    if mode == "cross":
        r_q = snap_rank(round(dq * (1.0 - ratio)), m, dq)
    elif mode == "partial":
        rot = min(cfg.rope_dims, dq)
        tail = dq - rot
        r_q = rot + (snap_rank(round(tail * (1.0 - ratio)), m, tail)
                     if tail > 0 else 0)
    else:  # intra (full RoPE): Q-K slicing illegal (paper §5)
        r_q = dq
    r_v = snap_rank(round(dv * (1.0 - ratio)), m, dv)
    return r_q, r_v


def _set_ranks(cfg: ArchConfig, qk_keep: int, vo_keep: int) -> ArchConfig:
    d = cfg.head_dim_
    return dataclasses.replace(
        cfg, clover=dataclasses.replace(
            cfg.clover, enabled=True,
            qk_rank=0 if qk_keep == d else qk_keep,
            vo_rank=0 if vo_keep == d else vo_keep))


def _prune_attn_clover(attn: Params, cfg: ArchConfig,
                       qk_keep: int, vo_keep: int) -> Params:
    """Slice the sorted factors of stacked attention params:
    wq (nb, D, H, dq), wk (nb, D, KV, dq), wv (nb, D, KV, dv),
    wo (nb, H, dv, D), and a peft tree's transitions s_qk / s_vo (nb,
    H, d, d) (CLOVER-dagger: S stays trainable after the prune).  In
    intra mode Q-K is never sliced, so ``k_t`` keeps its width.  The
    slices are copied out contiguous, so the full-width weights can be
    freed."""
    new = dict(attn)
    d = cfg.head_dim_
    if qk_keep < d and qk_mode(cfg) != "intra":
        new["wq"] = attn["wq"][..., :qk_keep].contiguous()
        new["wk"] = attn["wk"][..., :qk_keep].contiguous()
        if "s_qk" in attn:
            new["s_qk"] = attn["s_qk"][..., :qk_keep, :qk_keep].contiguous()
    if vo_keep < d:
        new["wv"] = attn["wv"][..., :vo_keep].contiguous()
        new["wo"] = attn["wo"][..., :vo_keep, :].contiguous()
        if "s_vo" in attn:
            new["s_vo"] = attn["s_vo"][..., :vo_keep, :vo_keep].contiguous()
    return new


@torch.no_grad()
def clover_prune(params: Params, cfg: ArchConfig, *,
                 qk_ratio: float = 0.0, vo_ratio: float = 0.0,
                 ) -> Tuple[Params, ArchConfig]:
    """Prune a CLOVER-decomposed model.  Returns (params', cfg') with
    cfg'.clover ranks set so the weights and KV caches shrink."""
    if not cfg.clover.enabled:
        raise ValueError("clover_prune requires a decomposed model "
                         "(run clover_decompose first)")
    qk_keep, vo_keep = plan_ranks(cfg, qk_ratio, vo_ratio)
    new_blocks = []
    for j, (mixer, _) in enumerate(cfg.pattern):
        stacked = dict(params["blocks"][j])
        if mixer == MIXER_ATTN:
            stacked["attn"] = _prune_attn_clover(stacked["attn"], cfg,
                                                 qk_keep, vo_keep)
        new_blocks.append(stacked)
    out = dict(params)
    out["blocks"] = tuple(new_blocks)
    return out, _set_ranks(cfg, qk_keep, vo_keep)


# ---------------------------------------------------------------------------
# Vanilla magnitude pruning baseline (no orthogonalization)
# ---------------------------------------------------------------------------

def _top_sorted(imp: torch.Tensor, keep: int) -> torch.Tensor:
    """Indices of the ``keep`` largest entries of each row, ascending.
    Ties go to the lower index, as ``jax.lax.top_k`` breaks them."""
    order = torch.sort(imp, dim=-1, descending=True, stable=True).indices
    return order[..., :keep].sort(dim=-1).values


def _prune_attn_vanilla(attn: Params, cfg: ArchConfig,
                        qk_keep: int, vo_keep: int) -> Params:
    """Per-head top-r magnitude pruning of ONE layer's raw weights.

    wq (D,H,dq), wk (D,KV,dq), wv (D,KV,dv), wo (H,dv,D); the importance
    of a shared K/V dim is summed over its group's query heads.  A RoPE
    block ([:rot]) would always be kept."""
    D, H, d = attn["wq"].shape
    KV = attn["wk"].shape[1]
    G = H // KV
    rot = min(cfg.rope_dims, d)
    new = dict(attn)

    if qk_keep < d and qk_mode(cfg) != "intra":
        nq = torch.linalg.vector_norm(attn["wq"], dim=0)        # (H, d)
        nk = torch.linalg.vector_norm(attn["wk"], dim=0)        # (KV, d)
        imp = (nq.reshape(KV, G, d) * nk[:, None, :]).sum(1)    # (KV, d)
        idx = _top_sorted(imp[:, rot:], qk_keep - rot) + rot
        if rot:
            idx = torch.cat([torch.arange(rot, device=idx.device)[None]
                             .expand(KV, rot), idx], -1)
        idx_h = torch.repeat_interleave(idx, G, dim=0)          # (H, keep)
        new["wq"] = attn["wq"].gather(
            2, idx_h[None].expand(D, H, qk_keep))
        new["wk"] = attn["wk"].gather(
            2, idx[None].expand(D, KV, qk_keep))

    if vo_keep < d:
        nv = torch.linalg.vector_norm(attn["wv"], dim=0)        # (KV, d)
        no = torch.linalg.vector_norm(attn["wo"], dim=2)        # (H, d)
        imp = (no.reshape(KV, G, d) * nv[:, None, :]).sum(1)    # (KV, d)
        idx = _top_sorted(imp, vo_keep)                         # (KV, keep)
        idx_h = torch.repeat_interleave(idx, G, dim=0)
        new["wv"] = attn["wv"].gather(2, idx[None].expand(D, KV, vo_keep))
        Dout = attn["wo"].shape[2]
        new["wo"] = attn["wo"].gather(
            1, idx_h[:, :, None].expand(H, vo_keep, Dout))
    return new


@torch.no_grad()
def vanilla_prune(params: Params, cfg: ArchConfig, *,
                  qk_ratio: float = 0.0, vo_ratio: float = 0.0,
                  ) -> Tuple[Params, ArchConfig]:
    """Magnitude pruning WITHOUT CLOVER orthogonalization (the paper's
    baseline): at the same kept ranks as ``clover_prune``, each head
    keeps the dims with the largest products of L2 norms."""
    qk_keep, vo_keep = plan_ranks(cfg, qk_ratio, vo_ratio)
    new_blocks = []
    for j, (mixer, _) in enumerate(cfg.pattern):
        stacked = dict(params["blocks"][j])
        if mixer == MIXER_ATTN:
            attn = stacked["attn"]
            outs = [_prune_attn_vanilla({k: v[i] for k, v in attn.items()},
                                        cfg, qk_keep, vo_keep)
                    for i in range(cfg.n_blocks)]
            stacked["attn"] = {k: torch.stack([o[k] for o in outs])
                               for k in outs[0]}
        new_blocks.append(stacked)
    out = dict(params)
    out["blocks"] = tuple(new_blocks)
    return out, _set_ranks(cfg, qk_keep, vo_keep)


# ---------------------------------------------------------------------------
# Threshold planning (paper §4.4: training-free pruning by magnitude cutoff)
# ---------------------------------------------------------------------------

def threshold_ratios(extras, cfg: ArchConfig, *,
                     qk_thresh: float, vo_thresh: float) -> Dict[str, Any]:
    """From decomposition spectra, the kept ranks implied by a
    singular-value threshold.

    The uniform summary (``qk_keep``/``vo_keep``/``*_ratio``) takes the
    max over heads and layers, so ``clover_prune`` keeps every head
    lossless at one static shape.  The per-head keeps the threshold
    implies are returned alongside as ``qk_head_keeps`` /
    ``vo_head_keeps``: nested tuples ``[pattern position][stacked
    block][kv head]`` of snapped ranks (empty tuples for non-attention
    positions), the raw material of a non-uniform ``RankBudget``."""
    d = cfg.head_dim_
    m = cfg.clover.rank_multiple
    mode = qk_mode(cfg)
    d_qk = (d - cfg.rope_dims) if mode == "partial" else d
    rot = cfg.rope_dims if mode == "partial" else 0
    qk_keep, vo_keep = 0, 0
    qk_heads, vo_heads = [], []
    for ex in extras:
        sp = ex["spectra"] if "spectra" in ex else {}
        if "qk" in sp:
            counts = (host_array(sp["qk"]) >= qk_thresh).sum(-1)
            qk_keep = max(qk_keep, int(counts.max()))
            qk_heads.append(tuple(
                tuple(rot + snap_rank(max(int(c), 1), m, d_qk)
                      for c in row) for row in counts))
        else:
            qk_heads.append(())
        if "vo" in sp:
            counts = (host_array(sp["vo"]) >= vo_thresh).sum(-1)
            vo_keep = max(vo_keep, int(counts.max()))
            vo_heads.append(tuple(
                tuple(snap_rank(max(int(c), 1), m, d)
                      for c in row) for row in counts))
        else:
            vo_heads.append(())
    qk_keep = snap_rank(max(qk_keep, 1), m, d_qk) if mode != "intra" else d
    vo_keep = snap_rank(max(vo_keep, 1), m, d)
    return {
        "qk_keep": qk_keep, "vo_keep": vo_keep,
        "qk_ratio": 1.0 - qk_keep / d_qk if mode != "intra" else 0.0,
        "vo_ratio": 1.0 - vo_keep / d,
        "qk_head_keeps": tuple(qk_heads),
        "vo_head_keeps": tuple(vo_heads),
    }


# ---------------------------------------------------------------------------
# Spectrum-driven rank budgets (non-uniform pruning, DESIGN.md §14)
# ---------------------------------------------------------------------------
#
# The orthogonalized spectra are not uniform: some layers and heads
# concentrate their energy in far fewer directions than others.  The
# planner water-fills one global rank budget across every (pattern
# position, stacked block, kv head, family) by greedy allocation over
# singular-value energy in ``rank_multiple``-wide blocks, taken in
# descending energy order until the budget is met.  Each head's
# spectrum is sorted, so its block energies are monotone and the greedy
# order always extends prefixes; among all prefix allocations of the
# same total rank (the uniform plan is one) it keeps the most energy.


@dataclasses.dataclass(frozen=True)
class RankBudget:
    """A serializable non-uniform rank plan (DESIGN.md §14).

    ``qk_ranks[j][b][h]`` / ``vo_ranks[j][b][h]`` are the kept ranks of
    kv head ``h`` in stacked block ``b`` of pattern position ``j``
    (empty tuples for non-attention positions), already snapped to
    ``rank_multiple`` and respecting §5 applicability.  Arrays are
    sliced to the plan's global max widths (``qk_width``/``vo_width``:
    one static shape per plan); each head's remainder is zero-padded
    (``mask_head_ranks``) and skipped by the decode kernels' per-head
    rank clamp."""
    head_dim: int                       # original per-head width d
    rank_multiple: int
    total_rank: int                     # sum of every kept qk+vo rank
    budget: int                         # the requested total (pre-clamp)
    qk_ranks: RankTable
    vo_ranks: RankTable

    @property
    def qk_width(self) -> int:
        """Global max kept qk rank: the static array/cache width."""
        return max((r for j in self.qk_ranks for b in j for r in b),
                   default=self.head_dim)

    @property
    def vo_width(self) -> int:
        return max((r for j in self.vo_ranks for b in j for r in b),
                   default=self.head_dim)

    def head_loads(self) -> np.ndarray:
        """(KV,) per-kv-head rank load summed over all layers (what a
        tensor-parallel head partition balances)."""
        kv = max(len(b) for j in self.qk_ranks for b in j)
        loads = np.zeros(kv, np.float64)
        for table in (self.qk_ranks, self.vo_ranks):
            for j in table:
                for b in j:
                    loads += np.asarray(b, np.float64)
        return loads

    def layer_ranks(self, j: int) -> Tuple[np.ndarray, np.ndarray]:
        """Pattern position ``j``'s ((n_blocks, KV) qk, (n_blocks, KV)
        vo) kept-rank arrays (int32), for ``mask_head_ranks`` and the
        ``rank_qk``/``rank_vo`` param leaves."""
        return (np.asarray(self.qk_ranks[j], np.int32),
                np.asarray(self.vo_ranks[j], np.int32))

    def salt(self) -> Tuple:
        """Folds the plan into the prefix trie's salt: pages written
        under another rank plan live in another basis and must never
        alias."""
        return (("budget", self.head_dim, self.rank_multiple,
                 self.total_rank)
                + tuple(r for j in self.qk_ranks for b in j for r in b)
                + tuple(r for j in self.vo_ranks for b in j for r in b))


def plan_rank_budget(extras, cfg: ArchConfig, *,
                     budget: Optional[float] = None,
                     total_rank: Optional[int] = None) -> RankBudget:
    """Water-fill a global rank budget across layers and heads by
    singular-value energy (DESIGN.md §14).

    ``extras`` comes from ``clover_decompose`` (``extras[j]["spectra"]``
    holds the descending per-head spectra, torch or numpy).  Give either
    ``budget``, the fraction of total rank capacity to keep, or
    ``total_rank``, the absolute kept total.  Partial-RoPE rotated
    blocks and intra-mode Q-K widths are mandatory allocations; every
    head keeps at least one ``rank_multiple`` block.  The kept total
    lands within one block width above the target unless the target is
    below the mandatory floor or above capacity (then it clamps).

    Energies are float64 host numpy and candidates sort by ``(-energy,
    family, j, b, h, i)`` over Python floats, as in the reference, so
    the same spectra give the same plan bit for bit."""
    d = cfg.head_dim_
    m = max(1, cfg.clover.rank_multiple)
    mode = qk_mode(cfg)
    rot = cfg.rope_dims if mode == "partial" else 0

    def blocks_of(width: int):
        """[(offset, block width)] tiling of a prunable width."""
        return [(o, min(m, width - o)) for o in range(0, width, m)]

    qk_tab: list = []
    vo_tab: list = []
    capacity = 0
    floor_total = 0
    candidates = []          # (energy, family, j, b, h, block idx, width)
    for j, ex in enumerate(extras):
        sp = ex.get("spectra", {}) if isinstance(ex, dict) else {}
        if "vo" not in sp:                     # non-attention position
            qk_tab.append(())
            vo_tab.append(())
            continue
        vo_e = energy_blocks(sp["vo"], m)       # (nb, KV, n_blk)
        nb, kv = vo_e.shape[:2]
        capacity += nb * kv * 2 * d
        qk_j = np.zeros((nb, kv), np.int64)
        vo_j = np.zeros((nb, kv), np.int64)
        if mode == "intra" or "qk" not in sp:  # Q-K pruning illegal (§5)
            qk_j[:] = d
            floor_total += nb * kv * d
        else:
            d_eff = sp["qk"].shape[-1]              # prunable NoPE width
            qk_e = energy_blocks(sp["qk"], m)
            qk_blocks = blocks_of(d_eff)
            for b in range(nb):
                for h in range(kv):
                    qk_j[b, h] = rot + qk_blocks[0][1]   # snap_rank floor
                    floor_total += rot + qk_blocks[0][1]
                    for i, (_, w) in enumerate(qk_blocks[1:], 1):
                        candidates.append(
                            (float(qk_e[b, h, i]), 0, j, b, h, i, w))
        vo_blocks = blocks_of(d)
        for b in range(nb):
            for h in range(kv):
                vo_j[b, h] = vo_blocks[0][1]
                floor_total += vo_blocks[0][1]
                for i, (_, w) in enumerate(vo_blocks[1:], 1):
                    candidates.append(
                        (float(vo_e[b, h, i]), 1, j, b, h, i, w))
        qk_tab.append(qk_j)
        vo_tab.append(vo_j)

    if (budget is None) == (total_rank is None):
        raise ValueError("plan_rank_budget: give exactly one of "
                         "budget (keep fraction) or total_rank")
    target = (int(total_rank) if total_rank is not None
              else int(round(float(budget) * capacity)))
    if not 0 < target or (budget is not None and not 0 < budget <= 1):
        raise ValueError(
            f"plan_rank_budget: budget={budget} total_rank={total_rank} "
            f"must select a positive kept total (capacity {capacity})")
    target = min(max(target, floor_total), capacity)

    # descending energy, ties broken by position: a deterministic order
    candidates.sort(key=lambda c: (-c[0], c[1], c[2], c[3], c[4], c[5]))
    kept = floor_total
    for _, fam, j, b, h, _, w in candidates:
        if kept >= target:
            break
        tab = qk_tab if fam == 0 else vo_tab
        tab[j][b, h] += w
        kept += w

    def freeze(t):
        return () if isinstance(t, tuple) else tuple(
            tuple(int(r) for r in row) for row in t)

    return RankBudget(
        head_dim=d, rank_multiple=m, total_rank=int(kept), budget=target,
        qk_ranks=tuple(freeze(t) for t in qk_tab),
        vo_ranks=tuple(freeze(t) for t in vo_tab))


def budget_kept_energy(extras, plan: RankBudget) -> float:
    """Total squared singular mass the plan keeps: the spectral quality
    proxy.  At matched total kept rank the greedy plan's is >= any
    uniform plan's (DESIGN.md §14).  Rotated/intra blocks carry no
    spectrum entries and cancel in comparisons."""
    total = 0.0
    for j, ex in enumerate(extras):
        sp = ex.get("spectra", {}) if isinstance(ex, dict) else {}
        if "qk" in sp and plan.qk_ranks[j]:
            sq = np.square(np.asarray(host_array(sp["qk"]), np.float64))
            rot = plan.head_dim - sq.shape[-1]
            for b, row in enumerate(plan.qk_ranks[j]):
                for h, r in enumerate(row):
                    total += float(sq[b, h, :max(r - rot, 0)].sum())
        if "vo" in sp and plan.vo_ranks[j]:
            sq = np.square(np.asarray(host_array(sp["vo"]), np.float64))
            for b, row in enumerate(plan.vo_ranks[j]):
                for h, r in enumerate(row):
                    total += float(sq[b, h, :r].sum())
    return total


@torch.no_grad()
def apply_rank_budget(params: Params, cfg: ArchConfig,
                      plan: RankBudget) -> Tuple[Params, ArchConfig]:
    """Realize a ``RankBudget`` on a decomposed model (DESIGN.md §14):
    (1) slice every attention stack to the plan's global max widths
    (one step shape per plan), (2) zero-pad each head's tail past its
    own kept rank (``mask_head_ranks``: the padded model is the
    per-head-truncated model), (3) add the per-layer kept ranks as
    ``rank_qk``/``rank_vo`` (n_blocks, KV) int32 leaves on the weights'
    device; ``models.layers.attention`` hands each layer's (KV,) row to
    the decode kernels' per-head rank clamp.

    Returns (params', cfg') with cfg'.clover ranks set to the plan's
    max widths (the KV-cache/page-pool width)."""
    if not cfg.clover.enabled:
        raise ValueError("apply_rank_budget requires a decomposed model "
                         "(run clover_decompose first)")
    dq_max, dv_max = plan.qk_width, plan.vo_width
    new_blocks = []
    for j, (mixer, _) in enumerate(cfg.pattern):
        stacked = dict(params["blocks"][j])
        if mixer == MIXER_ATTN:
            attn = _prune_attn_clover(stacked["attn"], cfg, dq_max, dv_max)
            dev = attn["wq"].device
            qk_j, vo_j = plan.layer_ranks(j)
            attn["rank_qk"] = torch.from_numpy(qk_j).to(dev)
            attn["rank_vo"] = torch.from_numpy(vo_j).to(dev)
            stacked["attn"] = attn
        new_blocks.append(stacked)
    out = dict(params)
    out["blocks"] = tuple(new_blocks)
    cfg1 = _set_ranks(cfg, dq_max, dv_max)
    attn_j = [j for j, (mx, _) in enumerate(cfg.pattern) if mx == MIXER_ATTN]
    qk_per_j = {j: plan.layer_ranks(j)[0] for j in attn_j}
    vo_per_j = {j: plan.layer_ranks(j)[1] for j in attn_j}
    return mask_head_ranks(out, cfg1, qk_per_j, vo_per_j), cfg1


@torch.no_grad()
def mask_head_ranks(params: Params, cfg: ArchConfig,
                    qk_ranks, vo_ranks) -> Params:
    """Ragged per-head ranks, realized as zero-padding: head ``h``
    keeps its leading ``qk_ranks[h]`` / ``vo_ranks[h]`` directions and
    the tail up to the array width is zeroed in every factor that
    touches it, by multiplying with 0/1 masks.  Zeroed rank dims add
    exactly 0 to the Q·K logits and the V·O context, while all shapes
    stay static.

    ``qk_ranks``/``vo_ranks`` are flat (KV,) vectors (one rank per
    head, shared by every layer) or mappings ``{pattern position j:
    (n_blocks, KV) array}`` (a ``RankBudget`` plan, DESIGN.md §14)."""
    kv = cfg.n_kv_heads
    G = cfg.q_per_kv

    def norm(ranks, j):
        """Rank array for pattern position ``j``: (KV,) or (nb, KV)."""
        if isinstance(ranks, dict):
            r = np.asarray(host_array(ranks[j]), np.int64)
            if r.ndim != 2 or r.shape[-1] != kv:
                raise ValueError(f"ranks[{j}] {r.shape}: need (n_blocks, "
                                 f"{kv})")
        else:
            r = np.asarray(host_array(ranks), np.int64)
            if r.shape != (kv,):
                raise ValueError(f"ranks {r.shape}: need ({kv},)")
        return r

    def rank_mask(r, width, per_q: bool, device):
        if per_q:
            r = np.repeat(r, G, axis=-1)
        # (..., heads, width): a leading block axis (if any) broadcasts
        return torch.from_numpy(
            np.arange(width)[None, :] < r[..., :, None]).to(device)

    new_blocks = []
    for j, (mixer, _) in enumerate(cfg.pattern):
        stacked = dict(params["blocks"][j])
        if mixer == MIXER_ATTN:
            attn = dict(stacked["attn"])
            dev = attn["wq"].device
            qk = norm(qk_ranks, j)
            vo = norm(vo_ranks, j)
            dq = attn["wq"].shape[-1]
            dv = attn["wv"].shape[-1]
            mq = rank_mask(qk, dq, True, dev)          # (..., H, dq)
            mk = rank_mask(qk, dq, False, dev)         # (..., KV, dq)
            mv = rank_mask(vo, dv, False, dev)         # (..., KV, dv)
            mo = rank_mask(vo, dv, True, dev)          # (..., H, dv)

            # wq/wk/wv (..., D, heads, r): the embed axis sits between
            # the block axis and the head axis, so per-block masks gain
            # a broadcast dim for it; flat masks broadcast as they are
            def emb(msk):
                return msk[:, None] if msk.dim() == 3 else msk

            attn["wq"] = attn["wq"] * emb(mq)
            attn["wk"] = attn["wk"] * emb(mk)
            attn["wv"] = attn["wv"] * emb(mv)
            attn["wo"] = attn["wo"] * mo[..., :, :, None]
            # a peft tree's transitions: rows AND columns masked (s_vo
            # per query head; the reference's KV-head mask there fails
            # to broadcast for 1 < KV < H)
            for key, m in (("s_qk", mq), ("k_t", mk), ("s_vo", mo)):
                if key in attn:
                    attn[key] = (attn[key] * m[..., :, :, None]
                                 * m[..., :, None, :])
            stacked["attn"] = attn
        new_blocks.append(stacked)
    out = dict(params)
    out["blocks"] = tuple(new_blocks)
    return out


# ---------------------------------------------------------------------------
# Rank-balanced head partitioning (tensor-parallel serving, DESIGN.md §10)
# ---------------------------------------------------------------------------
#
# Per-head pruning (threshold or budget plans) leaves heads of different
# ranks, so an even contiguous head split can hand one shard more pruned
# work than another, and the slowest shard sets the step time.  The
# partition below gives every shard the same NUMBER of KV heads (each
# shard's slices must have one extent) with the per-head rank LOADS
# bin-packed.  A GQA group's query heads live with their KV head.


@dataclasses.dataclass(frozen=True)
class HeadPartition:
    """A head -> shard plan: ``kv_assign[s]`` is the tuple of KV-head
    ids shard ``s`` owns (each shard owns ``KV / n_shards``).  Realized
    by PERMUTING the head axes so shard ``s`` holds the contiguous slice
    ``[s * per, (s + 1) * per)``: attention sums over heads, so a
    consistent permutation of wq / wk / wv / wo (and of the cache
    written through them) is exact."""
    n_shards: int
    group: int                                # query heads per KV head
    kv_assign: Tuple[Tuple[int, ...], ...]
    loads: Tuple[float, ...]                  # per-shard rank load

    @property
    def kv_perm(self) -> Tuple[int, ...]:
        """KV-head permutation: new position -> old KV-head id."""
        return tuple(h for shard in self.kv_assign for h in shard)

    @property
    def q_perm(self) -> Tuple[int, ...]:
        """Query-head permutation implied by ``kv_perm`` (GQA groups
        move with their KV head)."""
        return tuple(kv * self.group + g for kv in self.kv_perm
                     for g in range(self.group))

    @property
    def identity(self) -> bool:
        return self.kv_perm == tuple(range(len(self.kv_perm)))

    @property
    def balance(self) -> float:
        """max / min per-shard rank load (1.0 = perfectly balanced)."""
        lo = min(self.loads)
        return float(max(self.loads)) / float(lo) if lo > 0 else float("inf")

    def salt(self) -> Tuple:
        """Folds the plan into the prefix trie's salt: pages written
        under another head layout must never alias."""
        return ("tp", self.n_shards, self.group) + self.kv_perm


def head_rank_loads(cfg: ArchConfig, qk_ranks=None,
                    vo_ranks=None) -> np.ndarray:
    """(KV,) per-KV-head rank load: cached bytes and attention FLOPs per
    token both scale with ``r_qk + r_vo``.  Defaults to the config's
    uniform widths; pass per-head rank vectors for a heterogeneous
    plan."""
    kv = cfg.n_kv_heads
    qk = np.asarray([cfg.qk_dim] * kv if qk_ranks is None else qk_ranks,
                    np.float64)
    vo = np.asarray([cfg.vo_dim] * kv if vo_ranks is None else vo_ranks,
                    np.float64)
    assert qk.shape == (kv,) and vo.shape == (kv,), (qk.shape, vo.shape, kv)
    return qk + vo


def rank_balanced_partition(loads, n_shards: int,
                            group: int = 1) -> HeadPartition:
    """Greedy LPT bin-packing of per-KV-head loads into ``n_shards``
    equal-cardinality bins.

    Heads sorted by descending load each go to the least-loaded bin
    that still has a free slot (ties: lowest bin, then lowest head id:
    deterministic).  All-equal loads take the contiguous identity split,
    so the uniform-rank path keeps the unsharded head order.  Raises
    ``ValueError`` when ``n_shards`` does not divide the head count."""
    loads = [float(x) for x in loads]
    H = len(loads)
    if n_shards < 1 or H % n_shards != 0:
        raise ValueError(
            f"{H} kv heads do not split over {n_shards} shards: the "
            "tensor-parallel degree must divide the kv-head count")
    per = H // n_shards
    if len(set(loads)) <= 1:          # uniform ranks: identity split
        assign = tuple(tuple(range(s * per, (s + 1) * per))
                       for s in range(n_shards))
        return HeadPartition(n_shards, group, assign,
                             tuple(sum(loads[s * per:(s + 1) * per])
                                   for s in range(n_shards)))
    bins: list = [[] for _ in range(n_shards)]
    totals = [0.0] * n_shards
    for h in sorted(range(H), key=lambda h: (-loads[h], h)):
        s = min((s for s in range(n_shards) if len(bins[s]) < per),
                key=lambda s: (totals[s], s))
        bins[s].append(h)
        totals[s] += loads[h]
    return HeadPartition(n_shards, group,
                         tuple(tuple(sorted(b)) for b in bins),
                         tuple(totals))


# leaf name -> (permutation, head axis counted from the END of the shape):
# wq / wo / s_qk / s_vo by the query-head permutation; wk / wv / k_t and
# the (n_blocks, KV) rank clamps by the KV-head one, so the decode
# kernels' per-head clamp stays aligned with its head
HEAD_AXES = {"wq": ("q", 2), "wk": ("kv", 2), "wv": ("kv", 2),
             "wo": ("q", 3), "s_qk": ("q", 3), "s_vo": ("q", 3),
             "k_t": ("kv", 3), "rank_qk": ("kv", 1), "rank_vo": ("kv", 1)}


def permute_attention_heads(params: Params, cfg: ArchConfig,
                            plan: HeadPartition) -> Params:
    """Reorder every attention block's head axes by ``plan`` so shard
    ``s`` owns the contiguous head slice the partition assigned it
    (stacked leaves, end-relative axes; ``index_select`` copies).  Exact:
    each head's factors move together.  The KV cache needs no
    permutation: it starts empty and is only written through the
    permuted projections.  The identity plan returns ``params``."""
    if plan.identity:
        return params
    perms = {"q": plan.q_perm, "kv": plan.kv_perm}
    blocks = []
    for entry, (mixer, _) in zip(params["blocks"], cfg.pattern):
        if mixer == MIXER_ATTN:
            attn = dict(entry["attn"])
            for name, (which, ax) in HEAD_AXES.items():
                if name in attn:
                    leaf = attn[name]
                    idx = torch.as_tensor(perms[which], dtype=torch.long,
                                          device=leaf.device)
                    attn[name] = leaf.index_select(leaf.dim() - ax, idx)
            entry = dict(entry, attn=attn)
        blocks.append(entry)
    return dict(params, blocks=tuple(blocks))
