"""Per-request / per-priority-class serving metrics — own copy of
``repro/serve/metrics.py`` (DESIGN.md §11).

The engine records two clocks for every request:

  * DETERMINISTIC steps — ``Request.submit_step`` / ``token_steps`` /
    ``finish_step`` are engine step indices.  TTFT/ITL in steps are
    bit-reproducible across runs and machines, which is what the
    overload benchmark gates on (high-priority p95 TTFT strictly
    better than low-priority under the same trace).
  * WALL time — ``t_submit`` / ``token_times`` (seconds), reported
    alongside but never gated.

``ServeMetrics`` aggregates per priority class at request TERMINATION
(any terminal status: DONE, SHED, TIMED_OUT, CANCELLED), so a single
``snapshot()`` at drain sees every request exactly once.
"""
from __future__ import annotations

import collections
from typing import Dict, Optional

import numpy as np


def _pct(xs, q):
    return float(np.percentile(np.asarray(xs, dtype=np.float64), q))


class ServeMetrics:
    """Terminal-event aggregator behind ``Engine.stats()``."""

    def __init__(self):
        # lifecycle counters: done/shed/timed_out/cancelled plus event
        # counters the engine bumps directly (retries, quarantines,
        # watchdog_sheds, faults_recovered, and the host spill tier's
        # host_restored_pages / host_restore_fallbacks — DESIGN.md §12)
        self.counters = collections.Counter()
        # priority -> per-class latency samples
        self.classes: Dict[int, Dict[str, list]] = {}

    def _cls(self, priority: int) -> Dict[str, list]:
        return self.classes.setdefault(priority, {
            "ttft_steps": [], "itl_steps": [],
            "ttft_s": [], "itl_s": [],
        })

    def bump(self, name: str, n: int = 1) -> None:
        self.counters[name] += n

    def on_terminal(self, req) -> None:
        """Record a request reaching a terminal status.  Latencies are
        only defined for requests that emitted tokens; shed-at-admission
        requests contribute counters only."""
        self.counters[req.status.lower()] += 1
        cls = self._cls(req.priority)
        if req.token_steps:
            cls["ttft_steps"].append(req.token_steps[0] - req.submit_step)
            cls["itl_steps"].extend(np.diff(req.token_steps).tolist())
        if req.token_times:
            cls["ttft_s"].append(req.token_times[0] - req.t_submit)
            cls["itl_s"].extend(np.diff(req.token_times).tolist())

    @property
    def n_terminal(self) -> int:
        return sum(self.counters[k] for k in
                   ("done", "shed", "timed_out", "cancelled"))

    def snapshot(self) -> dict:
        """Counters + per-class p50/p95 latency summary."""
        out = {"counters": dict(self.counters), "classes": {}}
        for prio in sorted(self.classes):
            cls, row = self.classes[prio], {}
            for key in ("ttft_steps", "itl_steps", "ttft_s", "itl_s"):
                xs = cls[key]
                if xs:
                    row[f"{key}_p50"] = _pct(xs, 50)
                    row[f"{key}_p95"] = _pct(xs, 95)
                    row[f"n_{key}"] = len(xs)
            out["classes"][prio] = row
        return out

    def ttft_p95_steps(self, priority: int) -> Optional[float]:
        """Deterministic p95 TTFT for one class (None if no samples) —
        the quantity the overload gate compares across classes."""
        xs = self.classes.get(priority, {}).get("ttft_steps", [])
        return _pct(xs, 95) if xs else None
