"""Engine configuration of the port — own copy of
``repro/serve/config.py`` (knobs of DESIGN.md §6).

Fields that select features the port does not have yet (speculation
§8, tensor parallelism §10) keep their names and defaults and raise
``NotImplementedError`` when set.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.core.prune import RankBudget


@dataclass(frozen=True)
class EngineConfig:
    slots: int = 4                      # concurrent sequences
    max_len: int = 512                  # KV capacity per slot
    eos_id: int = -1                    # -1: never stop on token
    prefill_chunk: int = 64             # prompt tokens consumed per chunk step
    # -- paged KV cache (DESIGN.md §6) --------------------------------
    paged: bool = False
    page_tokens: int = 8
    # pool size in pages; 0 -> slots * table_pages (no memory pressure).
    # Smaller overcommits: admission gates on free pages and exhaustion
    # preempts the youngest sequence.
    n_pages: int = 0
    # -- automatic prefix caching (DESIGN.md §9, requires paged) ------
    # share KV pages across requests with a common page-aligned token
    # prefix: a host-side trie indexes published full-page runs,
    # admission maps hits read-only and skips their prefill chunks, and
    # a write into a shared page copies it first (kernels/page_copy.py)
    prefix_cache: bool = False
    # -- host-RAM spill tier (DESIGN.md §12, requires prefix_cache) ---
    # > 0: trie eviction copies each dropped page device->host (keyed
    # by its chain hash) before freeing it, and admission restores
    # host-tier hits into the slot's fresh pages instead of
    # re-prefilling.  0 disables.
    host_pages: int = 0
    # -- spectrum-planned rank budget (DESIGN.md §14) ------------------
    # the engine's non-uniform per-layer/per-head kept ranks.  The engine
    # does NOT apply it (callers run ``core.prune.apply_rank_budget`` on
    # the weights first; the engine checks the plan's widths against
    # cfg.qk_dim/vo_dim) and folds ``plan.salt()`` into the prefix-trie
    # salt so caches never cross budgets.  None -> uniform ranks.
    rank_budget: Optional[RankBudget] = None
    # -- not ported yet ------------------------------------------------
    spec_k: int = 0
    tp: int = 1

    def __post_init__(self):
        missing = [name for name, on in (
            ("spec_k", self.spec_k != 0),
            ("tp", self.tp != 1)) if on]
        if missing:
            raise NotImplementedError(
                f"EngineConfig: {', '.join(missing)} not ported yet "
                "(dense, paged, prefix-cached and rank-budget serving "
                "only)")
        if not (self.rank_budget is None
                or isinstance(self.rank_budget, RankBudget)):
            raise TypeError("EngineConfig.rank_budget must be a "
                            "core.prune.RankBudget (bridge.budget_from_"
                            f"fields converts the reference's), got "
                            f"{type(self.rank_budget).__name__}")
        if self.slots < 1 or self.max_len < 1 or self.page_tokens < 1:
            raise ValueError("EngineConfig: slots, max_len and page_tokens "
                             "must be >= 1")
        if self.prefix_cache and not self.paged:
            raise ValueError("EngineConfig.prefix_cache requires paged=True: "
                             "only pages can be shared across sequences")
        if self.host_pages < 0:
            raise ValueError(
                f"EngineConfig.host_pages={self.host_pages}: must be "
                ">= 0 (0 disables the host spill tier)")
        if self.host_pages > 0 and not self.prefix_cache:
            raise ValueError(
                f"EngineConfig.host_pages={self.host_pages} requires "
                "prefix_cache=True: the host tier spills and restores "
                "prefix-trie pages")

    @property
    def chunk(self) -> int:
        """Effective chunk size — the ONE clamp both the Scheduler's
        planning and the Engine's capacity/page-table sizing use."""
        return max(1, min(self.prefill_chunk, self.max_len))

    @property
    def capacity(self) -> int:
        """Per-slot KV capacity: max_len rounded up to a chunk multiple
        plus one spare chunk, so every window write [index, index + C)
        with index <= max_len stays in bounds.  The spare tail is beyond
        every causal horizon, hence never readable."""
        C = self.chunk
        return (self.max_len + C - 1) // C * C + C

    @property
    def table_pages(self) -> int:
        """Static per-slot page-table width (paged mode)."""
        pt = self.page_tokens
        return (self.capacity + pt - 1) // pt

    @property
    def pool_pages(self) -> int:
        """Resolved pool size: ``n_pages``, or the no-pressure default
        where every slot can reach full capacity."""
        return self.n_pages or self.slots * self.table_pages
