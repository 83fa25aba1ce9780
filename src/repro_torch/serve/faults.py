"""Deterministic fault injection at the engine's host boundaries — own
copy of ``repro/serve/faults.py`` (DESIGN.md §11).

A ``FaultPlan`` is a SEEDED schedule of failures the engine consults at
five injection sites — the places a production serving host actually
fails:

  * ``"alloc"``     — ``PageAllocator.ensure`` reports exhaustion even
                      though pages are free (a racing co-tenant, a
                      fragmented device heap);
  * ``"step"``      — a step raises before producing output (a device
                      OOM, a preempted device, a CUDA runtime error);
  * ``"nan"``       — a step RETURNS, but its logits are
                      non-finite (silent numerical corruption — the
                      one failure mode that would poison streams if it
                      weren't detected at the boundary);
  * ``"page_copy"`` — a COW page-content clone batch fails before
                      executing;
  * ``"host_copy"`` — a host->device restore batch (hierarchical KV's
                      spill tier, DESIGN.md §12) fails before
                      executing.  Recovery is BOUNDED by construction:
                      the engine gives up on the remaining host-tier
                      hits and falls back to re-prefilling those
                      tokens — strictly more work, never a wrong
                      token, allocator and trie untouched.

Determinism is the whole point: decision ``i`` at site ``s`` is a pure
function of ``(seed, s, i)`` — a per-site counter drives a
counter-mode RNG, so the same plan over the same trace injects the
same faults in the same order, every run, and the same plan injects
the same faults into this engine and the reference's.  That is what
lets the chaos tests assert EXACT properties under failure: surviving
streams token-identical to a fault-free replay, pool conservation,
every request terminal.

Injection happens in ``Engine`` BEFORE the step runs or, for
``"nan"``, by corrupting the returned logits host-side.  The port's
steps write K/V in place, so a ``"nan"`` step has already written its
window; the retry writes the same K/V at the same positions (recurrent
leaves are new tensors each step), so recovery (bounded same-input
retry, then slot quarantine + requeue) stays exact, and the same code
handles a REAL failure of the same shape, where re-admission rebuilds
the slot from the request's prompt + generated tokens.
"""
from __future__ import annotations

import collections
import zlib
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

# the engine's injection sites, in the order they appear in a step
SITES = ("alloc", "step", "nan", "page_copy", "host_copy")


class FaultError(RuntimeError):
    """A recoverable step failure: injected by a ``FaultPlan``, or a
    genuinely detected one (non-finite logits).  The engine retries the
    step with the same inputs up to ``EngineConfig.step_retries`` times
    before quarantining the slots and requeueing their requests."""


@dataclass
class FaultPlan:
    """Seeded, deterministic fault schedule.

    ``rates`` maps a site name (see ``SITES``) to a per-decision
    probability; absent sites never fire.  ``max_faults`` caps the
    TOTAL number of injected faults across all sites (None = no cap) —
    useful for "fail hard, then recover" tests.  ``injected`` counts
    what actually fired, per site.
    """
    seed: int = 0
    rates: Dict[str, float] = field(default_factory=dict)
    max_faults: Optional[int] = None

    def __post_init__(self):
        unknown = set(self.rates) - set(SITES)
        if unknown:
            raise ValueError(
                f"FaultPlan.rates: unknown sites {sorted(unknown)}; "
                f"expected a subset of {SITES}")
        for site, rate in self.rates.items():
            if not 0.0 <= rate <= 1.0:
                raise ValueError(
                    f"FaultPlan.rates[{site!r}]={rate}: must be in [0, 1]")
        self._calls = collections.Counter()
        self.injected = collections.Counter()

    @classmethod
    def chaos(cls, seed: int, intensity: float = 0.05,
              max_faults: Optional[int] = None) -> "FaultPlan":
        """Uniform pressure on every site — the soak-test default."""
        return cls(seed=seed, rates={s: intensity for s in SITES},
                   max_faults=max_faults)

    def fire(self, site: str) -> bool:
        """One injection decision at ``site``.  Counter-mode: decision
        ``i`` depends only on ``(seed, site, i)``, never on wall clock
        or global RNG state."""
        self._calls[site] += 1
        rate = self.rates.get(site, 0.0)
        if rate <= 0.0:
            return False
        if (self.max_faults is not None
                and self.total_injected >= self.max_faults):
            return False
        u = np.random.default_rng(
            [self.seed, zlib.crc32(site.encode()), self._calls[site]]
        ).random()
        if u < rate:
            self.injected[site] += 1
            return True
        return False

    @property
    def total_injected(self) -> int:
        return sum(self.injected.values())

    def summary(self) -> Dict[str, int]:
        """{site: injected count} for ``Engine.stats()`` reporting."""
        return {s: self.injected.get(s, 0) for s in SITES
                if self.rates.get(s, 0.0) > 0.0}
