"""Engine configuration of the port — own copy of
``repro/serve/config.py`` (knobs of DESIGN.md §6, §8, §9, §10, §11,
§12, §14).
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
    # -- self-speculative decoding (DESIGN.md §8) ---------------------
    # 0 disables; k > 0: every pure-decode step, a rank-sliced DRAFT
    # pass over the SAME weights proposes k tokens per slot and one
    # (slots, k+1) verify step accepts a greedy prefix, up to k+1 tokens
    # per step instead of 1.  Greedy streams stay token-identical to the
    # non-speculative engine; attention-only architectures only
    # (recurrent state cannot roll back).
    spec_k: int = 0
    # fraction of every head's CURRENT rank the draft slices off (the
    # leading directions are kept: CLOVER's factors are sorted, so the
    # draft reads cache[..., :r] of the one shared cache)
    draft_rank_ratio: float = 0.5
    # -- robustness (DESIGN.md §11) -----------------------------------
    # A failed step (raised, or returned non-finite logits) is retried
    # with the same inputs up to step_retries times; then the active
    # slots are quarantined for quarantine_steps engine steps and their
    # requests requeued (exact continuation: generated tokens fold into
    # the effective prompt).  The watchdog sheds the lowest-priority
    # request when no slot makes progress for watchdog_steps
    # consecutive steps (0 disables).
    step_retries: int = 2
    quarantine_steps: int = 8
    watchdog_steps: int = 64
    # -- tensor parallelism (DESIGN.md §10) ---------------------------
    # > 1: the engine runs on one rank of an initialised torch.distributed
    # group of tp ranks and its ShardedExecutor computes that rank's
    # heads / ff / experts / vocab slice (launch.serve.serve_tp spawns
    # the ranks on one host)
    tp: int = 1
    # > 1: the group holds data * tp ranks, ``data`` replicas of the tp
    # shards, each serving its block of slots / data slots
    # (launch.serve.serve_tp(..., data=) sets it)
    data: int = 1

    def __post_init__(self):
        if self.tp < 1:
            raise ValueError(f"EngineConfig.tp={self.tp}: the tensor-"
                             "parallel degree must be >= 1")
        if self.data < 1:
            raise ValueError(f"EngineConfig.data={self.data}: the number "
                             "of data replicas must be >= 1")
        if self.spec_k < 0:
            raise ValueError(f"EngineConfig.spec_k={self.spec_k}: must be "
                             ">= 0 (0 disables speculation)")
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
        for name in ("step_retries", "quarantine_steps", "watchdog_steps"):
            if getattr(self, name) < 0:
                raise ValueError(f"EngineConfig.{name}="
                                 f"{getattr(self, name)}: must be >= 0")

    @property
    def chunk(self) -> int:
        """Effective chunk size — the ONE clamp both the Scheduler's
        planning and the Engine's capacity/page-table sizing use."""
        return max(1, min(self.prefill_chunk, self.max_len))

    @property
    def spec_window(self) -> int:
        """Verify-step window width (pending token + k drafts)."""
        return self.spec_k + 1

    @property
    def capacity(self) -> int:
        """Per-slot KV capacity: max_len rounded up to a chunk multiple
        plus spare room, so every window write [index, index + W) with
        index <= max_len stays in bounds.  W is the chunk or, with
        speculation, the (k+1)-wide verify window whose rejected tail
        overhangs the committed length.  The spare tail is beyond every
        causal horizon, hence never readable."""
        C = self.chunk
        spare = max(C, self.spec_window if self.spec_k > 0 else 1)
        return ((self.max_len + C - 1) // C * C
                + (spare + C - 1) // C * C)

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
