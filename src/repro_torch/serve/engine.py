"""Engine of the port: chunked-prefill continuous batching over
CLOVER-rank KV caches, dense or paged — own port of
``repro/serve/engine.py`` (DESIGN.md §6).

Each engine step every slot is either decoding one token or consuming
a fixed-size chunk of its prompt, so prefill interleaves with decode
and the executor runs exactly TWO step shapes whatever the prompt-length
mix.  ``scheduler.Scheduler`` decides WHAT happens (admission, phases,
preemption, retirement), ``memory.PageAllocator`` WHERE paged K/V lives,
``executor.LocalExecutor`` HOW a planned step runs on the device.
Greedy streams are token-identical to the isolated whole-prompt
reference ``greedy_reference``.

Left out until their slices: prefix caching, the host tier,
speculation, tensor parallelism, SV adapters and fault injection.  A
step whose active logits are not finite raises.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.bridge import tree_map
from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as T
from repro_torch.serve.config import EngineConfig
from repro_torch.serve.executor import LocalExecutor
from repro_torch.serve.memory import PageAllocator
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.scheduler import Request, Scheduler

Params = Dict[str, Any]


def greedy_reference(params: Params, cfg: ArchConfig, prompt, n: int, *,
                     device: DeviceLike = None) -> List[int]:
    """Isolated whole-prompt greedy decode via the full forward pass —
    the exactness oracle engine streams are checked against."""
    seq = [int(t) for t in prompt]
    gen = []
    for _ in range(n):
        logits, _ = T.forward(params, cfg, np.asarray([seq], np.int64),
                              last_only=True, device=device)
        tok = int(torch.argmax(logits[0, -1]))
        gen.append(tok)
        seq.append(tok)
    return gen


class Engine:
    def __init__(self, params: Params, cfg: ArchConfig, ecfg: EngineConfig,
                 *, device: DeviceLike = None, seed: int = 0):
        """Serve ``params`` (moved to ``device``, default ``cuda``, if
        they live elsewhere).  ``seed`` drives temperature sampling."""
        self.device = resolve_device(device)
        self.cfg = cfg
        self.ecfg = ecfg
        self.rng = np.random.default_rng(seed)
        params = tree_map(lambda t: t.to(self.device), params)
        self.exe = LocalExecutor(params, cfg, ecfg, self.device)
        self.state = self.exe.init_state()
        self.alloc: Optional[PageAllocator] = (
            PageAllocator(ecfg.pool_pages, ecfg.page_tokens, ecfg.slots,
                          ecfg.table_pages) if ecfg.paged else None)
        self.metrics = ServeMetrics()
        self.sched = Scheduler(ecfg, self.alloc, metrics=self.metrics)
        # host mirror of state["index"] (tokens written per slot this
        # tenure) — drives page coverage without device round-trips
        self.written = np.zeros(ecfg.slots, np.int64)
        self.steps = 0
        self.max_active = 0
        self.peak_page_util = 0.0

    # ------------------------------------------------------------------
    def submit(self, req: Request):
        self.sched.submit(req)

    def compiled_shapes(self) -> int:
        return self.exe.compiled_shapes()

    def stats(self) -> dict:
        out = self.metrics.snapshot()
        out["steps"] = self.steps
        out["max_active"] = self.max_active
        out["preemptions"] = self.sched.preemptions
        if self.alloc is not None:
            out["page_util"] = self.alloc.utilization()
            out["peak_page_util"] = self.peak_page_util
            out["free_pages"] = self.alloc.free_pages
        return out

    def _sample(self, logits: np.ndarray, temp: float) -> int:
        if temp <= 0:
            return int(np.argmax(logits))
        z = logits.astype(np.float64) / temp
        p = np.exp(z - z.max())
        return int(self.rng.choice(len(p), p=p / p.sum()))

    def _emit(self, slots: List[int], logits: np.ndarray):
        now = time.monotonic()
        for s in slots:
            req = self.sched.slot_req[s]
            tok = self._sample(logits[s], req.temperature)
            req.generated.append(tok)
            req.token_times.append(now)
            req.token_steps.append(self.steps)
            self.sched.last_token[s] = tok

    def _run(self, name: str, active: np.ndarray, fn, *args):
        # one profiler span per step ("engine.prefill_chunk" /
        # "engine.decode_step"), the host wait for its logits included;
        # free when no profiler is running
        with torch.profiler.record_function(f"engine.{name}"):
            logits, state = fn(*args)
            logits = logits.float().cpu().numpy()
        if not np.isfinite(logits[active]).all():
            raise FloatingPointError(f"non-finite logits from {name}")
        return logits, state

    # -- paged page coverage / preemption ------------------------------
    def _ensure_pages(self):
        """Cover every active slot's upcoming writes with pages, oldest
        sequence first; on pool exhaustion preempt-and-requeue the
        YOUNGEST active sequence and retry."""
        sched, alloc = self.sched, self.alloc
        take = sched.planned_writes()
        order = sorted((s for s in range(self.ecfg.slots)
                        if sched.slot_req[s] is not None),
                       key=lambda s: sched.slot_seq[s])
        for s in order:
            while sched.slot_req[s] is not None:
                if take[s] <= 0 or alloc.ensure(
                        s, int(self.written[s] + take[s])):
                    break
                victims = [v for v in range(self.ecfg.slots)
                           if sched.slot_req[v] is not None]
                victim = max(victims, key=lambda v: sched.slot_seq[v])
                if victim == s and len(victims) == 1:
                    # admission guarantees a lone sequence always fits
                    raise RuntimeError(
                        f"page pool exhausted: slot {s} needs "
                        f"{alloc.pages_for(int(self.written[s] + take[s]))}"
                        f" pages, pool has {alloc.n_pages}")
                sched.preempt(victim)

    # ------------------------------------------------------------------
    def _step_inner(self) -> int:
        sched = self.sched
        pages = wfloor = None
        # freshly admitted rows start their tenure at position 0 (the
        # first uncached position once a prefix cache exists); IDLE rows
        # are pinned at 0 through the same fresh-reset: decode advances
        # every row's index, so a long-idle row would otherwise run past
        # its page table
        active_rows = np.array([r is not None for r in sched.slot_req])
        self.written[sched.fresh & active_rows] = 0
        self.written[~active_rows] = 0
        resume = np.zeros(self.ecfg.slots, np.int32)
        if self.alloc is not None:
            self._ensure_pages()
            pages = self.alloc.table_array()
            wfloor = resume
            self.peak_page_util = max(self.peak_page_util,
                                      self.alloc.utilization())
        # recompute after _ensure_pages: preemption may have idled slots
        active = np.array([r is not None for r in sched.slot_req])
        self.max_active = max(self.max_active, int(active.sum()))
        if sched.has_chunk_work():
            tokens, lengths, fresh = sched.plan_chunk()
            logits, self.state = self._run(
                "prefill_chunk", lengths > 0, self.exe.prefill_chunk,
                self.state, tokens, lengths, fresh | ~active, resume,
                pages, wfloor)
            self.written += lengths
            self._emit(sched.advance_chunk(lengths), logits)
        elif active.any():
            tokens, fresh = sched.plan_decode()
            logits, self.state = self._run(
                "decode_step", active, self.exe.decode_step, self.state,
                tokens, fresh | ~active, resume, pages, wfloor)
            self.written += 1
            self._emit(sched.advance_decode(), logits)
        else:
            return 0
        sched.retire()
        return len([r for r in sched.slot_req if r is not None])

    def step(self) -> int:
        """One engine step: advance the step clock, admit, run one step.
        Returns the number of active slots."""
        sched = self.sched
        sched.now_step = self.steps
        sched.admit()
        n_active = self._step_inner()
        self.steps += 1
        return n_active

    def run(self, requests: List[Request], max_steps: int = 100000,
            ) -> List[Request]:
        for r in requests:
            self.submit(r)
        steps = 0
        while self.sched.busy and steps < max_steps:
            self.step()
            steps += 1
        return requests
