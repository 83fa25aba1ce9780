"""Scheduling policy of the port: admission, chunk planning,
preemption, retirement — own copy of ``repro/serve/scheduler.py``
(DESIGN.md §6, §9, §11, §12).

Everything here is HOST-side numpy bookkeeping; the device sees only
the fixed step shapes the executor runs.  Request lifecycle::

    QUEUED --admit--> RUNNING --retire--> DONE
       |                 |  \\--preempt/requeue--> QUEUED
       |                 +--cancel--> CANCELLED
       |                 +--deadline--> TIMED_OUT
       +--cancel--> CANCELLED
       +--provably-unmeetable deadline--> SHED

The three non-DONE terminal states release the slot's pages through
the same decref path preemption uses but never publish into the prefix
trie: a shed, cancelled or timed-out request leaves the allocator, trie
and refcounts as if it had never run (DESIGN.md §11).

With a prefix cache, admission maps the longest cached page run of
the effective prompt read-only and resumes prefill after it; prefill
completion, preemption and retirement publish the sequence's full-page
run back into the trie.  With a host tier under the trie, admission
also restores spilled pages through the engine's ``restore`` hook.

Recurrent models (RWKV, Mamba) carry per-slot state that a padded
window would corrupt: their chunk windows are exactly C prompt tokens,
a prompt with fewer than C tokens left enters the TAIL phase and feeds
them one per decode step, and DECODE slots do not ride chunk steps.

With speculation (``spec_k > 0``, DESIGN.md §8) a decode step writes
a (k+1)-wide window: admission and the page planning leave room for
the rejected tail's overhang.

Multi-tenant SV adapters (DESIGN.md §13): ``Request.adapter_id`` keys
every trie ``match`` / ``insert`` / ``chain_hashes`` call and the host
tier (``_trie_extra``), so cached K/V never crosses tenants; adapter 0
keys the plain namespace, byte-identical to a registry-free engine's.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.serve.config import EngineConfig
from repro_torch.serve.memory import PageAllocator, PrefixCache

# slot phases
PREFILL = "prefill"     # prompt tokens remain; consumed chunk-wise
TAIL = "tail"           # recurrent models: < C prompt tokens remain,
                        # fed one by one through the decode step
DECODE = "decode"       # generating one token per engine step

# request statuses
QUEUED = "QUEUED"
RUNNING = "RUNNING"
DONE = "DONE"           # ran to completion (max_new_tokens or EOS)
SHED = "SHED"           # dropped by policy: unmeetable deadline / watchdog
TIMED_OUT = "TIMED_OUT"  # running past its deadline; partial stream kept
CANCELLED = "CANCELLED"  # client cancel via Engine.cancel(uid)
TERMINAL = frozenset({DONE, SHED, TIMED_OUT, CANCELLED})


@dataclass
class Request:
    uid: int
    prompt: np.ndarray                  # (len,) int32
    max_new_tokens: int = 16
    temperature: float = 0.0            # 0 = greedy
    # scheduling class: higher admits first; under overload the
    # watchdog and the deadline shedder sacrifice lower priorities first
    priority: int = 0
    # SV-adapter tenant (DESIGN.md §13): an AdapterRegistry id.  0 is the
    # reserved identity adapter -- bit for bit the base model -- and the
    # only valid id on an engine built without a registry.
    adapter_id: int = 0
    # deadline in ENGINE STEPS after submission (None = none): the
    # request must reach a terminal state within this many steps or it
    # is timed out (running) / shed (queued and provably unmeetable)
    deadline_steps: Optional[int] = None
    # filled by the engine:
    status: str = QUEUED
    generated: List[int] = field(default_factory=list)
    # prefix-cache hit size at the LAST admission: prompt tokens whose
    # K/V came from shared or restored pages (their prefill skipped)
    cached_tokens: int = 0
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
        if self.deadline_steps is not None and self.deadline_steps < 1:
            raise ValueError(
                f"Request.deadline_steps (uid={self.uid})="
                f"{self.deadline_steps}: must be None or >= 1")
        if not isinstance(self.adapter_id, (int, np.integer)) \
                or self.adapter_id < 0:
            raise ValueError(
                f"Request.adapter_id (uid={self.uid})="
                f"{self.adapter_id!r}: must be an int >= 0")

    @property
    def _trie_extra(self) -> Tuple:
        """Prefix-trie key extension (DESIGN.md §13): adapter 0 maps to
        ``()``, so identity-tenant caches hash as a registry-free
        engine's do."""
        return (self.adapter_id,) if self.adapter_id else ()

    @property
    def done(self) -> bool:
        """True once the request reached ANY terminal state (``status``
        tells DONE from SHED / TIMED_OUT / CANCELLED)."""
        return self.status in TERMINAL


class Scheduler:
    """Admission / chunking / preemption / retirement with per-slot
    phases.  With a ``PageAllocator`` (paged mode) admission gates on
    free pages for the effective prompt and ``preempt`` requeues a
    sequence at the head of its priority class with its generated
    tokens folded into the effective prompt (greedy continuation is
    exact).  Admission takes the highest priority first, FIFO within a
    class, and keeps head-of-line blocking on page exhaustion.

    With a ``PrefixCache`` admission maps the longest cached prefix
    READ-ONLY into the slot's table and resumes chunked prefill at the
    first uncached token (``resume``); with the engine's ``restore``
    hook (host tier) the resume point also advances over pages copied
    back from host RAM.  ``recurrent``: the model carries per-slot
    state (the TAIL phase and full-window chunks)."""

    def __init__(self, ecfg: EngineConfig, recurrent: bool,
                 allocator: Optional[PageAllocator] = None,
                 prefix: Optional[PrefixCache] = None, metrics=None):
        self.ecfg = ecfg
        self.chunk = ecfg.chunk
        self.recurrent = recurrent
        self.alloc = allocator
        self.prefix = prefix
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
        # prefix-cache resume point per slot: the first position THIS
        # tenure writes (0 without a hit); positions below it are
        # served by read-only shared pages
        self.resume = np.zeros(n, np.int64)
        # slots benched after fault-retry exhaustion: not admittable
        # until the engine step clock reaches the recorded value
        self.quarantined = np.zeros(n, np.int64)
        # engine step clock (refreshed by the engine every step)
        self.now_step = 0
        self._admit_counter = 0
        self._submit_counter = 0
        self._requeue_counter = -1
        self.preemptions = 0
        self.requeues = 0
        self.prefix_hits = 0
        self.prefix_hit_tokens = 0
        # host-tier restore hook, installed by the engine: ``(slot,
        # eff_prompt, hit_pages, trie_extra) -> n_restored`` copies
        # spilled pages beyond the trie hit into the slot's freshly
        # ensured pages.  None = no host tier.
        self.restore = None

    # -- admission -----------------------------------------------------
    def submit(self, req: Request):
        L = len(np.asarray(req.prompt))
        if L + req.max_new_tokens > self.ecfg.max_len:
            raise ValueError(
                f"Request.prompt (uid={req.uid}): prompt length {L} + "
                f"max_new_tokens {req.max_new_tokens} exceeds "
                f"EngineConfig.max_len={self.ecfg.max_len}")
        if self.alloc is not None:
            need = self.alloc.pages_for(
                L + req.max_new_tokens + self.ecfg.spec_k)
            if need > self.alloc.n_pages:
                raise ValueError(
                    f"Request.prompt (uid={req.uid}): needs {need} KV "
                    f"pages (prompt {L} + max_new_tokens "
                    f"{req.max_new_tokens} + spec overhang "
                    f"{self.ecfg.spec_k}) but the pool only has "
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
        free = [s for s in range(self.ecfg.slots)
                if self.slot_req[s] is None
                and self.now_step >= self.quarantined[s]]
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
            resume = 0
            if self.alloc is not None:
                # speculative verify windows overhang the committed
                # length by up to spec_k tokens
                assert (self.alloc.pages_for(L + remaining
                                             + self.ecfg.spec_k)
                        <= self.alloc.n_pages)
                hit_pages = 0
                if self.prefix is not None:
                    pages = self.prefix.match(eff, extra=req._trie_extra)
                    if pages and self.alloc.map_shared(s, pages):
                        # at least one token must remain to prefill
                        # (its logits seed generation): a FULL hit
                        # resumes at L-1, and the rewrite of that
                        # position copies the shared last page first
                        hit_pages = len(pages)
                        resume = min(hit_pages * self.alloc.page_tokens,
                                     L - 1)
                ok = self.alloc.ensure(s, L)
                if not ok and self.prefix is not None:
                    # cached-but-idle prefixes are reclaimable: evict
                    # LRU trie pages nobody maps and retry (the matched
                    # pages are slot-mapped now, so never THIS hit)
                    short = (self.alloc.pages_for(L)
                             - len(self.alloc.tables[s])
                             - self.alloc.free_pages)
                    if short > 0 and self.prefix.evict(short) > 0:
                        ok = self.alloc.ensure(s, L)
                if not ok:
                    # head-of-line: the best candidate waits for pages
                    # (undo the shared mapping so the trie can evict)
                    self.alloc.release(s)
                    break
                if self.restore is not None:
                    # pages beyond the trie hit may survive in the host
                    # tier: ensure() just allocated the slot's own pages
                    # for them, so their bytes can be copied back
                    n_rest = self.restore(s, eff, hit_pages,
                                          req._trie_extra)
                    if n_rest > 0:
                        resume = min((hit_pages + n_rest)
                                     * self.alloc.page_tokens, L - 1)
            self.queue.remove(req)
            req.cached_tokens = resume
            req.status = RUNNING
            if resume > 0:
                self.prefix_hits += 1
                self.prefix_hit_tokens += resume
            self.slot_req[s] = req
            self.slot_prompt[s] = eff
            self.pos[s] = resume
            self.resume[s] = resume
            self.fresh[s] = True
            self.slot_seq[s] = self._admit_counter
            self._admit_counter += 1
            self.phase[s] = self._prefill_phase(L, resume)

    def _prefill_phase(self, L: int, pos: int) -> str:
        if self.recurrent and L - pos < self.chunk:
            return TAIL          # a padded window would corrupt the state
        return PREFILL

    # -- deadlines / cancellation / shedding (DESIGN.md §11) ----------
    def _min_steps(self, req: Request) -> int:
        """LOWER bound on the engine steps ``req`` needs if admitted now:
        best-case prefill (a full prefix hit skips all but one chunk)
        plus best-case decode (EOS may stop after the first token;
        speculation commits up to spec_window per step).  Used to prove
        infeasibility only: it sheds nothing that had any chance."""
        L = len(req.prompt) + len(req.generated)
        C = self.chunk
        if self.prefix is not None:
            prefill = 1
        elif self.recurrent:
            full, tail = divmod(L, C)
            prefill = full + tail if tail else full
        else:
            prefill = -(-L // C)
        min_new = 1 if self.ecfg.eos_id >= 0 else \
            req.max_new_tokens - len(req.generated)
        W = self.ecfg.spec_window if self.ecfg.spec_k > 0 else 1
        return prefill + -(-max(0, min_new - 1) // W)

    def _terminal(self, req: Request, status: str):
        req.status = status
        req.finish_step = self.now_step
        if self.metrics is not None:
            self.metrics.on_terminal(req)

    def _vacate(self, s: int) -> Request:
        """Decref slot ``s``'s pages and empty it; -> its request."""
        req = self.slot_req[s]
        assert req is not None
        if self.alloc is not None:
            self.alloc.release(s)
        self.slot_req[s] = None
        self.slot_prompt[s] = None
        self.phase[s] = None
        return req

    def _finish_slot(self, s: int, status: str):
        """Retire a RUNNING slot into a non-DONE terminal state: pages
        decref'd through the preemption path, NOTHING published."""
        self._terminal(self._vacate(s), status)

    def enforce_deadlines(self):
        """Once per engine step, before admission: time out running
        slots past their deadline, and shed queued requests whose
        deadline is PROVABLY unmeetable while strictly-higher-priority
        work is pending (an uncontended doomed request runs to its
        deadline and keeps a partial stream)."""
        now = self.now_step
        for s, req in enumerate(self.slot_req):
            if req is None or req.deadline_steps is None:
                continue
            if now >= req.submit_step + req.deadline_steps:
                self._finish_slot(s, TIMED_OUT)
        pending = self.queue + [r for r in self.slot_req if r is not None]
        pmax = max((r.priority for r in pending), default=0)
        doomed = [r for r in self.queue
                  if r.deadline_steps is not None
                  and r.priority < pmax
                  and now + self._min_steps(r) - 1
                  >= r.submit_step + r.deadline_steps]
        for req in doomed:
            self.queue.remove(req)
            self._terminal(req, SHED)

    def cancel(self, uid: int) -> bool:
        """Client cancellation: a queued request leaves the queue, a
        running slot retires through the no-publish decref path.  False
        when ``uid`` is unknown or already terminal."""
        for req in self.queue:
            if req.uid == uid:
                self.queue.remove(req)
                self._terminal(req, CANCELLED)
                return True
        for s, req in enumerate(self.slot_req):
            if req is not None and req.uid == uid:
                self._finish_slot(s, CANCELLED)
                return True
        return False

    def shed(self, uid_or_slot: Tuple[str, int]):
        """Watchdog shedding: ('queue', uid) or ('slot', s)."""
        kind, key = uid_or_slot
        if kind == "queue":
            for req in self.queue:
                if req.uid == key:
                    self.queue.remove(req)
                    self._terminal(req, SHED)
                    return
        else:
            self._finish_slot(key, SHED)

    def _requeue_front(self, req: Request):
        """Back to the queue at the head of its priority class."""
        req.status = QUEUED
        req._seq = self._requeue_counter
        self._requeue_counter -= 1
        self.queue.append(req)

    def requeue(self, s: int, quarantine_until: int):
        """Fault recovery: bench slot ``s`` until the step clock reaches
        ``quarantine_until`` and requeue its request at the head of its
        class.  No publish: after a fault the slot's pages are suspect,
        so re-admission re-prefills from the host-held token stream."""
        self._requeue_front(self._vacate(s))
        self.quarantined[s] = quarantine_until
        self.requeues += 1

    # -- planning ------------------------------------------------------
    def has_chunk_work(self) -> bool:
        return any(p == PREFILL for p in self.phase)

    def planned_writes(self, decode_width: int = 1) -> np.ndarray:
        """(slots,) KV positions the NEXT step writes per active slot.
        TAIL and PREFILL writes land inside the prompt coverage made at
        admission; only decode growth can demand pages.  ``decode_width``
        > 1 is a speculative round: every decoding slot writes a
        (k+1)-wide draft + verify window."""
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
                elif self.phase[s] == DECODE and not self.recurrent:
                    take[s] = 1
            else:
                take[s] = decode_width
        return take

    def plan_chunk(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The (slots, C) window batch: PREFILL slots consume up to C
        prompt tokens (recurrent models: exactly C, which the phase
        guarantees), DECODE slots ride with length 1 on attention-only
        models; every other row idles with length 0."""
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
            elif self.phase[s] == DECODE and not self.recurrent:
                tokens[s, 0] = self.last_token[s]
                lengths[s] = 1
        fresh = self.fresh & (lengths > 0)
        self.fresh &= ~fresh
        return tokens, lengths, fresh

    def plan_decode(self) -> Tuple[np.ndarray, np.ndarray]:
        """One token per slot: TAIL slots feed their next prompt token,
        DECODE slots their last sampled token."""
        n = self.ecfg.slots
        tokens = np.zeros(n, np.int32)
        active = np.zeros(n, bool)
        for s, req in enumerate(self.slot_req):
            if req is None:
                continue
            active[s] = True
            if self.phase[s] == TAIL:
                tokens[s] = self.slot_prompt[s][self.pos[s]]
            else:
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
                    # the prompt's K/V is fully written: publish its
                    # full-page run so concurrent requests with the
                    # same prefix already share it
                    self._publish(s, len(self.slot_prompt[s]))
                    sample.append(s)
                else:
                    self.phase[s] = self._prefill_phase(
                        len(self.slot_prompt[s]), int(self.pos[s]))
            else:                                   # riding decode slot
                sample.append(s)
        return sample

    def advance_decode(self) -> List[int]:
        """Apply a decode step's progress: a TAIL slot consumed one
        prompt token (its logits are sampled once the prompt is done);
        every DECODE slot samples."""
        sample = []
        for s, req in enumerate(self.slot_req):
            if req is None:
                continue
            if self.phase[s] == TAIL:
                self.pos[s] += 1
                if self.pos[s] == len(self.slot_prompt[s]):
                    self.phase[s] = DECODE
                    sample.append(s)
            else:
                sample.append(s)
        return sample

    # -- preemption / retirement --------------------------------------
    def _publish(self, s: int, n_valid: int):
        """Publish slot ``s``'s first ``n_valid`` cached positions into
        the prefix trie, rounded DOWN to full pages, keyed on the
        sequence's token stream (prompt + generated): content-addressed,
        so right for any sampling temperature and preemption history."""
        if self.prefix is None:
            return
        req = self.slot_req[s]
        stream = np.asarray(req.prompt, np.int32)
        if req.generated:
            stream = np.concatenate(
                [stream, np.asarray(req.generated, np.int32)])
        n_full = int(n_valid) // self.alloc.page_tokens
        if n_full > 0:
            self.prefix.insert(stream, self.alloc.tables[s][:n_full],
                               extra=req._trie_extra)

    def preempt(self, s: int, n_valid: int = 0):
        """Release slot ``s`` and requeue its request at the head of its
        priority class; generated tokens join the effective prompt on
        re-admission, so the re-prefill continues the stream exactly.
        With a prefix cache the committed full-page run (``n_valid``
        positions) is published first, so re-admission resumes from the
        trie: pages are decref'd, not freed."""
        if self.alloc is not None:
            self._publish(s, n_valid)
        self._requeue_front(self._vacate(s))
        self.preemptions += 1

    def retire(self, written: Optional[np.ndarray] = None):
        """Retire finished DECODE slots (max_new_tokens or EOS).
        ``written`` (the engine's host mirror of per-slot committed
        cache lengths) bounds what the prefix trie may index."""
        for s, req in enumerate(self.slot_req):
            if req is None or self.phase[s] != DECODE:
                continue
            if (len(req.generated) >= req.max_new_tokens
                    or (self.ecfg.eos_id >= 0 and req.generated
                        and req.generated[-1] == self.ecfg.eos_id)):
                if self.alloc is not None and written is not None:
                    self._publish(s, int(written[s]))
                self._terminal(self._vacate(s), DONE)

    @property
    def busy(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.slot_req)
