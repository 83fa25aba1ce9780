"""Scheduling policy of the port: admission, chunk planning,
preemption, retirement — own copy of ``repro/serve/scheduler.py``
(DESIGN.md §6, §11) for attention-only models without a prefix cache.

Everything here is HOST-side numpy bookkeeping; the device sees only
the fixed step shapes the executor runs.  Request lifecycle::

    QUEUED --admit--> RUNNING --retire--> DONE
                         \\--preempt--> QUEUED

Left out until their slices: prefix-trie admission and publishing
(§9), host-tier restore (§12), adapter keys (§13), the recurrent TAIL
phase, and the overload policy (§11: deadlines, cancellation,
shedding, fault-recovery requeue).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.serve.config import EngineConfig
from repro_torch.serve.memory import PageAllocator

# slot phases
PREFILL = "prefill"     # prompt tokens remain; consumed chunk-wise
DECODE = "decode"       # generating one token per engine step

# request statuses
QUEUED = "QUEUED"
RUNNING = "RUNNING"
DONE = "DONE"


@dataclass
class Request:
    uid: int
    prompt: np.ndarray                  # (len,) int32
    max_new_tokens: int = 16
    temperature: float = 0.0            # 0 = greedy
    priority: int = 0                   # higher admits first
    # filled by the engine:
    status: str = QUEUED
    generated: List[int] = field(default_factory=list)
    t_submit: float = 0.0
    token_times: List[float] = field(default_factory=list)
    submit_step: int = -1
    token_steps: List[int] = field(default_factory=list)
    finish_step: int = -1
    _seq: int = field(default=0, repr=False, compare=False)

    def __post_init__(self):
        p = np.asarray(self.prompt)
        if p.ndim != 1 or p.size == 0:
            raise ValueError(
                f"Request.prompt (uid={self.uid}): expected a non-empty "
                f"1-D token array, got shape {p.shape}")
        if not np.issubdtype(p.dtype, np.integer):
            raise ValueError(
                f"Request.prompt (uid={self.uid}): expected integer "
                f"tokens, got dtype {p.dtype}")
        if self.max_new_tokens < 1:
            raise ValueError(
                f"Request.max_new_tokens (uid={self.uid})="
                f"{self.max_new_tokens}: must be >= 1")
        if self.temperature < 0.0:
            raise ValueError(
                f"Request.temperature (uid={self.uid})="
                f"{self.temperature}: must be >= 0")
        if not isinstance(self.priority, (int, np.integer)) \
                or self.priority < 0:
            raise ValueError(
                f"Request.priority (uid={self.uid})={self.priority!r}: "
                "must be an int >= 0")

    @property
    def done(self) -> bool:
        return self.status == DONE


class Scheduler:
    """Admission / chunking / preemption / retirement with per-slot
    phases.  With a ``PageAllocator`` (paged mode) admission gates on
    free pages for the effective prompt and ``preempt`` requeues a
    sequence at the head of its priority class with its generated
    tokens folded into the effective prompt (greedy continuation is
    exact).  Admission takes the highest priority first, FIFO within a
    class, and keeps head-of-line blocking on page exhaustion."""

    def __init__(self, ecfg: EngineConfig,
                 allocator: Optional[PageAllocator] = None, metrics=None):
        self.ecfg = ecfg
        self.chunk = ecfg.chunk
        self.alloc = allocator
        self.metrics = metrics
        self.queue: List[Request] = []
        n = ecfg.slots
        self.slot_req: List[Optional[Request]] = [None] * n
        self.slot_prompt: List[Optional[np.ndarray]] = [None] * n
        self.phase: List[Optional[str]] = [None] * n
        self.pos = np.zeros(n, np.int64)        # prompt tokens consumed
        self.fresh = np.zeros(n, bool)          # needs state reset
        self.last_token = np.zeros(n, np.int32)
        self.slot_seq = np.zeros(n, np.int64)   # admission order (age)
        self.now_step = 0
        self._admit_counter = 0
        self._submit_counter = 0
        self._requeue_counter = -1
        self.preemptions = 0

    # -- admission -----------------------------------------------------
    def submit(self, req: Request):
        L = len(np.asarray(req.prompt))
        if L + req.max_new_tokens > self.ecfg.max_len:
            raise ValueError(
                f"Request.prompt (uid={req.uid}): prompt length {L} + "
                f"max_new_tokens {req.max_new_tokens} exceeds "
                f"EngineConfig.max_len={self.ecfg.max_len}")
        if self.alloc is not None:
            need = self.alloc.pages_for(L + req.max_new_tokens)
            if need > self.alloc.n_pages:
                raise ValueError(
                    f"Request.prompt (uid={req.uid}): needs {need} KV "
                    f"pages (prompt {L} + max_new_tokens "
                    f"{req.max_new_tokens}) but the pool only has "
                    f"{self.alloc.n_pages}")
        req.t_submit = time.monotonic()
        req.submit_step = self.now_step
        req.status = QUEUED
        req._seq = self._submit_counter
        self._submit_counter += 1
        self.queue.append(req)

    def _next_candidate(self) -> Optional[Request]:
        if not self.queue:
            return None
        return min(self.queue, key=lambda r: (-r.priority, r._seq))

    def admit(self):
        free = [s for s in range(self.ecfg.slots) if self.slot_req[s] is None]
        for s in free:
            req = self._next_candidate()
            if req is None:
                break
            eff = (req.prompt if not req.generated else
                   np.concatenate([np.asarray(req.prompt, np.int32),
                                   np.asarray(req.generated, np.int32)]))
            L = len(eff)
            remaining = req.max_new_tokens - len(req.generated)
            assert L > 0 and L + remaining <= self.ecfg.max_len
            if self.alloc is not None:
                assert self.alloc.pages_for(L + remaining) \
                    <= self.alloc.n_pages
                if not self.alloc.ensure(s, L):
                    # head-of-line: the best candidate waits for pages
                    self.alloc.release(s)
                    break
            self.queue.remove(req)
            req.status = RUNNING
            self.slot_req[s] = req
            self.slot_prompt[s] = eff
            self.pos[s] = 0
            self.fresh[s] = True
            self.slot_seq[s] = self._admit_counter
            self._admit_counter += 1
            self.phase[s] = PREFILL

    def _terminal(self, req: Request, status: str):
        req.status = status
        req.finish_step = self.now_step
        if self.metrics is not None:
            self.metrics.on_terminal(req)

    # -- planning ------------------------------------------------------
    def has_chunk_work(self) -> bool:
        return any(p == PREFILL for p in self.phase)

    def planned_writes(self) -> np.ndarray:
        """(slots,) KV positions the NEXT step writes per active slot."""
        n, C = self.ecfg.slots, self.chunk
        take = np.zeros(n, np.int64)
        chunk_step = self.has_chunk_work()
        for s, req in enumerate(self.slot_req):
            if req is None:
                continue
            if chunk_step:
                if self.phase[s] == PREFILL:
                    take[s] = min(C, len(self.slot_prompt[s])
                                  - int(self.pos[s]))
                else:
                    take[s] = 1
            else:
                take[s] = 1
        return take

    def plan_chunk(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The (slots, C) window batch: PREFILL slots consume up to C
        prompt tokens, DECODE slots ride with length 1, idle rows 0."""
        n, C = self.ecfg.slots, self.chunk
        tokens = np.zeros((n, C), np.int32)
        lengths = np.zeros(n, np.int32)
        for s, req in enumerate(self.slot_req):
            if req is None:
                continue
            if self.phase[s] == PREFILL:
                prompt = self.slot_prompt[s]
                take = min(C, len(prompt) - int(self.pos[s]))
                tokens[s, :take] = prompt[self.pos[s]:self.pos[s] + take]
                lengths[s] = take
            else:
                tokens[s, 0] = self.last_token[s]
                lengths[s] = 1
        fresh = self.fresh & (lengths > 0)
        self.fresh &= ~fresh
        return tokens, lengths, fresh

    def plan_decode(self) -> Tuple[np.ndarray, np.ndarray]:
        """One token per slot: each DECODE slot's last sampled token."""
        n = self.ecfg.slots
        tokens = np.zeros(n, np.int32)
        active = np.zeros(n, bool)
        for s, req in enumerate(self.slot_req):
            if req is None:
                continue
            active[s] = True
            tokens[s] = self.last_token[s]
        fresh = self.fresh & active
        self.fresh &= ~fresh
        return tokens, fresh

    # -- post-step transitions ----------------------------------------
    def advance_chunk(self, lengths: np.ndarray) -> List[int]:
        """Apply a chunk step's progress; returns the slots whose logits
        row is a real next-token distribution."""
        sample = []
        for s, req in enumerate(self.slot_req):
            if req is None or lengths[s] == 0:
                continue
            if self.phase[s] == PREFILL:
                self.pos[s] += int(lengths[s])
                if self.pos[s] == len(self.slot_prompt[s]):
                    self.phase[s] = DECODE
                    sample.append(s)
            else:
                sample.append(s)
        return sample

    def advance_decode(self) -> List[int]:
        return [s for s, req in enumerate(self.slot_req) if req is not None]

    # -- preemption / retirement --------------------------------------
    def preempt(self, s: int):
        """Release slot ``s`` and requeue its request at the head of its
        priority class; generated tokens join the effective prompt on
        re-admission, so the re-prefill continues the stream exactly."""
        req = self.slot_req[s]
        assert req is not None
        if self.alloc is not None:
            self.alloc.release(s)
        self.slot_req[s] = None
        self.slot_prompt[s] = None
        self.phase[s] = None
        req.status = QUEUED
        req._seq = self._requeue_counter
        self._requeue_counter -= 1
        self.queue.append(req)
        self.preemptions += 1

    def retire(self):
        """Retire finished DECODE slots (max_new_tokens or EOS)."""
        for s, req in enumerate(self.slot_req):
            if req is None or self.phase[s] != DECODE:
                continue
            if (len(req.generated) >= req.max_new_tokens
                    or (self.ecfg.eos_id >= 0 and req.generated
                        and req.generated[-1] == self.ecfg.eos_id)):
                if self.alloc is not None:
                    self.alloc.release(s)
                self.slot_req[s] = None
                self.slot_prompt[s] = None
                self.phase[s] = None
                self._terminal(req, DONE)

    @property
    def busy(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.slot_req)
