"""Engine configuration of the port — own copy of
``repro/serve/config.py`` (knobs of DESIGN.md §6).

Fields that select features this slice does not have yet (prefix
caching §9, the host tier §12, speculation §8, tensor parallelism §10,
rank budgets §14) keep their names and defaults and raise
``NotImplementedError`` when set.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional


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
    # -- not ported yet ------------------------------------------------
    prefix_cache: bool = False
    host_pages: int = 0
    spec_k: int = 0
    tp: int = 1
    rank_budget: Optional[Any] = None

    def __post_init__(self):
        missing = [name for name, on in (
            ("prefix_cache", self.prefix_cache),
            ("host_pages", self.host_pages != 0),
            ("spec_k", self.spec_k != 0),
            ("tp", self.tp != 1),
            ("rank_budget", self.rank_budget is not None)) if on]
        if missing:
            raise NotImplementedError(
                f"EngineConfig: {', '.join(missing)} not ported yet "
                "(dense and paged serving only)")
        if self.slots < 1 or self.max_len < 1 or self.page_tokens < 1:
            raise ValueError("EngineConfig: slots, max_len and page_tokens "
                             "must be >= 1")

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
