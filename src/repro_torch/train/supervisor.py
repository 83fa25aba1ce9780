"""Fault-tolerance supervisor: restart-on-failure, straggler watchdog —
own port of ``repro/train/supervisor.py``.

``Supervisor.run`` drives the training loop with:

  * periodic checkpoints (async, atomic — see checkpoint.py);
  * restart-on-failure: a step raising ``WorkerFailure`` (tests inject
    it; on real clusters a missing-heartbeat callback raises it) rolls
    back to the last committed checkpoint and replays — the data stream
    is counter-addressed so replay is bit-exact;
  * straggler watchdog: per-step wall time tracked with a running
    mean/variance (Welford); steps slower than mu + k*sigma are recorded
    and surfaced to the caller (on a real cluster this feeds the
    reshard/evict decision);
  * elastic restarts: ``restore`` maps the checkpoint onto whatever mesh
    the new incarnation runs with (checkpoint.py's reshard path).

On a mesh every rank runs the loop and fails at the same step; the
rollback waits for rank 0's commit (``CheckpointManager.wait``: join,
then a barrier) before it reads ``latest_step``.  ``save_kw`` /
``restore_kw`` pass the layout (``specs``, ``mesh``) to the manager.
As in the reference, a failure before the first checkpoint replays
from ``start_step`` with the state it failed in (ROADMAP C).
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from repro_torch.train.checkpoint import CheckpointManager


class WorkerFailure(RuntimeError):
    """A (simulated) worker failure: node loss, preemption, hang."""


@dataclass
class StragglerStats:
    n: int = 0
    mean: float = 0.0
    m2: float = 0.0
    flagged: List[Dict[str, float]] = field(default_factory=list)

    def update(self, step: int, dt: float, k: float = 3.0) -> bool:
        # Welford running moments; flag AFTER a warmup of 8 steps
        self.n += 1
        d = dt - self.mean
        self.mean += d / self.n
        self.m2 += d * (dt - self.mean)
        if self.n >= 8:
            sigma = math.sqrt(self.m2 / max(1, self.n - 1))
            if dt > self.mean + k * sigma and sigma > 0:
                self.flagged.append({"step": step, "dt": dt,
                                     "mean": self.mean, "sigma": sigma})
                return True
        return False


@dataclass
class SupervisorReport:
    steps_run: int = 0
    restarts: int = 0
    stragglers: List[Dict[str, float]] = field(default_factory=list)
    final_step: int = 0
    metrics_history: List[Dict[str, float]] = field(default_factory=list)


class Supervisor:
    def __init__(self, ckpt: CheckpointManager, *,
                 ckpt_every: int = 50,
                 max_restarts: int = 8,
                 straggler_k: float = 3.0,
                 save_kw: Optional[Dict[str, Any]] = None,
                 restore_kw: Optional[Dict[str, Any]] = None):
        self.ckpt = ckpt
        self.ckpt_every = ckpt_every
        self.max_restarts = max_restarts
        self.straggler_k = straggler_k
        self.save_kw = dict(save_kw or {})
        self.restore_kw = dict(restore_kw or {})

    def run(self, *,
            state: Dict[str, Any],
            step_fn: Callable[[Dict[str, Any], int], Dict[str, Any]],
            save_tree: Callable[[Dict[str, Any]], Any],
            restore_tree: Callable[[Any, Dict], Dict[str, Any]],
            start_step: int,
            total_steps: int,
            metrics_cb: Optional[Callable[[int, Dict], None]] = None,
            ) -> SupervisorReport:
        """Run to ``total_steps`` with checkpoint/restart.

        state: opaque mutable training state (params/opt/data-iter...).
        step_fn(state, step) -> (state, metrics); may raise WorkerFailure.
        save_tree(state) -> (tree, extra) for the checkpointer.
        restore_tree(tree, extra) -> state after a rollback.
        """
        rep = SupervisorReport()
        stats = StragglerStats()
        step = start_step
        restarts = 0
        while step < total_steps:
            try:
                t0 = time.perf_counter()
                state, metrics = step_fn(state, step)
                dt = time.perf_counter() - t0
                if stats.update(step, dt, self.straggler_k):
                    rep.stragglers.append(stats.flagged[-1])
                if metrics_cb:
                    metrics_cb(step, metrics)
                rep.metrics_history.append(
                    {k: float(v) for k, v in metrics.items()})
                rep.steps_run += 1
                step += 1
                if step % self.ckpt_every == 0 or step == total_steps:
                    tree, extra = save_tree(state)
                    extra = dict(extra, step=step)
                    self.ckpt.save(step, tree, extra, **self.save_kw)
            except WorkerFailure:
                restarts += 1
                rep.restarts += 1
                if restarts > self.max_restarts:
                    raise
                self.ckpt.wait()
                last = self.ckpt.latest_step()
                if last is None:       # no checkpoint yet: replay from 0
                    step = start_step
                    continue
                tree, extra = save_tree(state)  # structure template
                restored, rextra = self.ckpt.restore(last, tree,
                                                     **self.restore_kw)
                state = restore_tree(restored, rextra)
                step = int(rextra.get("step", last))
        self.ckpt.wait()
        rep.final_step = step
        return rep
