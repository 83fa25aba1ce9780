"""Engine of the port: chunked-prefill continuous batching over
CLOVER-rank KV caches, dense or paged — own port of
``repro/serve/engine.py`` (DESIGN.md §6, §8, §9, §11, §12, §14).

Each engine step every slot is either decoding one token or consuming
a fixed-size chunk of its prompt, so prefill interleaves with decode
and the executor runs exactly TWO step shapes whatever the prompt-length
mix.  ``scheduler.Scheduler`` decides WHAT happens (admission, phases,
preemption, retirement), ``memory.PageAllocator`` WHERE paged K/V lives,
``executor.LocalExecutor`` HOW a planned step runs on the device.
Greedy streams are token-identical to the isolated whole-prompt
reference ``greedy_reference``.

Paged mode optionally shares pages across sequences by page-aligned
token prefix (``prefix_cache``, DESIGN.md §9: a write into a shared
page clones it first through the ``page_copy`` kernel), backed by a
host-RAM spill tier (``host_pages``, DESIGN.md §12: trie eviction
copies page bytes device->host before freeing them, admission restores
them through the ``page_restore`` kernel instead of re-prefilling).
The copy, restore and spill calls run inside ``engine.page_copy``,
``engine.page_restore`` and ``engine.spill`` profiler spans.

Under a spectrum-planned ``RankBudget`` (``EngineConfig.rank_budget``,
DESIGN.md §14) the engine only validates the plan's widths and salts
the prefix trie with it: the weights carry the plan (``core.prune.
apply_rank_budget``), and their ``rank_qk``/``rank_vo`` leaves route
every decode step through the rank-clamped kernels.  The rank vectors
are parameters, not step inputs, so the step shapes stay two.

Recurrent models (RWKV-6; jamba, whose Mamba layers sit beside a KV
cache for its attention layer) keep O(1) state per slot: the scheduler
feeds them full chunk windows and a token-at-a-time TAIL, and the
executor zeroes fresh rows and keeps idle rows' state.
Their state is not page-addressable and cannot roll back, so
``prefix_cache`` and ``spec_k`` raise on them, as in the reference;
``paged=True`` allocates pages that hold no KV leaves.

SELF-SPECULATIVE DECODING (``spec_k``, DESIGN.md §8): when no slot has
prompt left to chunk and every active request is greedy, a step is a
round: the rank-sliced draft (``draft_step``, the decode kernels
reading ``cache[..., :r]`` through the cache's row stride) proposes k
tokens per slot, one (slots, k+1) ``verify_chunk`` scores them with the
full model, each slot commits its longest matching prefix plus the
target token, and the per-slot index rolls back over the rejected tail.

ROBUSTNESS (DESIGN.md §11): every step, draft, verify, page copy and
restore runs behind a guard that injects the faults of an optional
``FaultPlan`` and always checks that the active logits are finite.  A
failed step is retried with the same inputs (sound: host bookkeeping
changes only after a step succeeds, and a step run again writes the
same K/V at the same positions, see ``executor``); when the retries
are spent the step aborts, the active slots are quarantined and their
requests requeued for an exact re-prefill continuation.  A failed
restore falls back to re-prefilling.  A progress watchdog sheds the
lowest-priority request when nothing moves for ``watchdog_steps``
steps, and deadlines time out or shed requests through the scheduler.
Surviving streams under any fault schedule equal the fault-free ones.

MULTI-TENANT SV ADAPTERS (``adapters=AdapterRegistry``, DESIGN.md §13):
one base model's singular values rescaled per tenant.  The engine
stacks the registry into one gather bank at construction, passes every
chunk, decode, draft and verify step the (slots,) adapter ids of its
slots (0, the identity, for idle rows), and keys the prefix trie and
the host tier by adapter id, so cached K/V never crosses tenants.
Adapter 0 is bit for bit the base model, and the bank adds no step
shape.

TENSOR PARALLELISM (``EngineConfig.tp > 1``, DESIGN.md §10): run one
engine per rank inside an initialised ``torch.distributed`` group of
``tp`` ranks (``launch.serve.serve_tp`` does it on one host).  Each
engine builds a ``ShardedExecutor`` on ``launch.mesh.make_host_mesh``;
under a rank budget the head partition balances the plan's per-head
loads.  Every rank sees the same logits bytes, so every rank schedules,
pages and caches identically and emits the same streams.  A group of
``data * tp`` ranks (``EngineConfig.data``, which ``launch.serve.
serve_tp(..., data=)`` sets) serves ``data`` replicas of the ``tp``
shards, each running its block of ``slots / data`` slots; the executor
gathers their logits, so every rank's engine still sees every slot.
"""
from __future__ import annotations

import collections
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.peft import AdapterRegistry
from repro_torch.core.prune import rank_balanced_partition
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import transformer as T
from repro_torch.serve.config import EngineConfig
from repro_torch.serve.executor import (LocalExecutor, ShardedExecutor,
                                        is_recurrent,
                                        validate_kernel_parallelism)
from repro_torch.serve.faults import FaultError, FaultPlan
from repro_torch.serve.memory import HostTier, PageAllocator, PrefixCache
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.scheduler import DONE, Request, Scheduler

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


def _bank_size(bank) -> int:
    """Tenants in an executor's adapter bank (0 without one)."""
    for entry in bank or ():
        if entry is not None:
            return next(iter(entry.values())).shape[1]
    return 0


class _StepAbort(Exception):
    """A step failed after exhausting its retries: unwind to recovery
    (quarantine + requeue) without touching host bookkeeping."""


class Engine:
    def __init__(self, params: Params, cfg: ArchConfig, ecfg: EngineConfig,
                 *, device: DeviceLike = None, seed: int = 0,
                 faults: Optional[FaultPlan] = None,
                 adapters: Optional[AdapterRegistry] = None,
                 executor: Optional[LocalExecutor] = None):
        """Serve ``params`` (moved to ``device``, default ``cuda``, if
        they live elsewhere; with ``tp > 1`` this rank's slices go to
        its card, ``cuda:{rank % device_count}``).  ``seed`` drives
        temperature sampling; ``faults`` injects a deterministic fault
        schedule (DESIGN.md §11); ``adapters``: the SV-adapter registry
        whose tenants requests name by ``adapter_id`` (DESIGN.md §13).
        Its bank is taken here: tenants registered or updated later are
        not served by this engine.  ``executor``: a pre-built executor
        (e.g. a ``ShardedExecutor`` with an explicit head plan) that
        holds its own params, instead of the one ``ecfg`` selects."""
        self.device = resolve_device(device)
        # impossible (kernel path, parallelism, arch) combinations fail
        # here, before any executor state exists
        validate_kernel_parallelism(cfg, ecfg.tp, self.device)
        if ecfg.rank_budget is not None:
            plan = ecfg.rank_budget
            if (plan.qk_width != cfg.qk_dim
                    or plan.vo_width != cfg.vo_dim):
                raise ValueError(
                    f"EngineConfig.rank_budget widths ({plan.qk_width}, "
                    f"{plan.vo_width}) do not match cfg ({cfg.qk_dim}, "
                    f"{cfg.vo_dim}): run core.prune.apply_rank_budget on "
                    "the weights first and serve its returned cfg — the "
                    "engine validates plans, it does not apply them")
        recurrent = is_recurrent(cfg)
        if ecfg.spec_k > 0 and recurrent:
            raise ValueError(
                "speculative decoding requires an attention-only "
                "architecture: recurrent (mamba/rwkv) state cannot roll "
                "back rejected draft tokens")
        if ecfg.prefix_cache and recurrent:
            raise ValueError(
                "prefix caching requires an attention-only architecture: "
                "recurrent (mamba/rwkv) state is not page-addressable, so "
                "a cached page run cannot reconstruct it")
        self.cfg = cfg
        self.ecfg = ecfg
        self.rng = np.random.default_rng(seed)
        self.faults = faults
        self.adapters = adapters
        # the tenants in the executor's bank: ids past it would index
        # beyond the gather's adapter axis
        self.n_adapters = 1 if adapters is None else len(adapters)
        if executor is None:
            bank = adapters.bank() if adapters is not None else None
            if ecfg.tp > 1 or ecfg.data > 1:
                mesh = make_host_mesh(data=ecfg.data, model=ecfg.tp,
                                      device=self.device)
                # under a rank budget the shards balance the PLANNED
                # per-head ranks, not the uniform widths (DESIGN.md §14)
                part = None
                if (ecfg.rank_budget is not None
                        and cfg.n_kv_heads % ecfg.tp == 0):
                    part = rank_balanced_partition(
                        ecfg.rank_budget.head_loads(), ecfg.tp,
                        group=cfg.q_per_kv)
                executor = ShardedExecutor(params, cfg, ecfg, mesh,
                                           plan=part, adapter_bank=bank)
            else:
                executor = LocalExecutor(params, cfg, ecfg, self.device,
                                         adapter_bank=bank)
        elif adapters is not None and _bank_size(executor.abank) != len(
                adapters):
            raise ValueError(
                "adapters beside a pre-built executor must be the registry "
                "whose bank the executor was built with (adapter_bank="
                "adapters.bank()): the gather bank is placed at executor "
                "construction")
        self.exe = executor
        self.device = executor.device
        self.state = self.exe.init_state()
        self.alloc: Optional[PageAllocator] = (
            PageAllocator(ecfg.pool_pages, ecfg.page_tokens, ecfg.slots,
                          ecfg.table_pages) if ecfg.paged else None)
        self.prefix: Optional[PrefixCache] = None
        self.host: Optional[HostTier] = None
        if ecfg.prefix_cache:
            # the trie key folds in the rank plan and the executor's
            # head partition (empty on one device): caches under another
            # prune ratio / CLOVER rank / page size / head layout never
            # alias.  Same tuple as the reference, so the
            # chain hashes are byte-identical.
            salt = (cfg.name, cfg.qk_dim, cfg.vo_dim, cfg.clover.enabled,
                    cfg.clover.qk_rank, cfg.clover.vo_rank,
                    ecfg.page_tokens) + tuple(self.exe.plan_salt())
            if ecfg.rank_budget is not None:
                # budgets zero different rank tails per head: pages
                # written under one plan are garbage under another even
                # at identical global widths
                salt = salt + tuple(ecfg.rank_budget.salt())
            self.prefix = PrefixCache(self.alloc, salt=salt)
            if ecfg.host_pages > 0:
                # eviction spills through page_reader (a BLOCKING
                # device->host read of the live pool); admission
                # restores through the scheduler hook installed below
                self.host = HostTier(ecfg.host_pages)
                self.prefix.host = self.host
                self.prefix.page_reader = self._spill_read
        self.metrics = ServeMetrics()
        self.sched = Scheduler(ecfg, recurrent, self.alloc, self.prefix,
                               metrics=self.metrics)
        if self.host is not None:
            self.sched.restore = self._restore_pages
        # host mirror of state["index"] (tokens written per slot this
        # tenure) — drives page coverage, COW detection and the
        # speculative rollback without device round-trips
        self.written = np.zeros(ecfg.slots, np.int64)
        # deterministic engine step clock (never resets across run()s)
        self.steps = 0
        # progress watchdog: monotone work counters and the last step
        # any of them moved
        self._tokens_committed = 0
        self._prefill_consumed = 0
        self._last_progress = 0
        self.watchdog_sheds = 0
        self._alloc_fault = False
        self.max_active = 0
        self.peak_page_util = 0.0
        # speculative rounds: {tokens emitted in a slot-round: count}
        self.spec_rounds = 0
        self.accept_hist: Dict[int, int] = collections.defaultdict(int)
        # per-adapter serving stats (DESIGN.md §13)
        self.adapter_tokens: Dict[int, int] = collections.defaultdict(int)
        self.adapter_done: Dict[int, int] = collections.defaultdict(int)
        if adapters is not None:
            # count completions per tenant where every terminal
            # transition already funnels through
            base = self.metrics.on_terminal

            def _on_terminal(req):
                if req.status == DONE:
                    self.adapter_done[req.adapter_id] += 1
                base(req)
            self.metrics.on_terminal = _on_terminal

    # ------------------------------------------------------------------
    def submit(self, req: Request):
        n = self.n_adapters
        if req.adapter_id >= n:
            raise ValueError(
                f"Request.adapter_id (uid={req.uid})={req.adapter_id}: "
                + (f"the engine's bank holds {n} adapters (tenants "
                   "registered after construction are not served)"
                   if self.adapters is not None else
                   "engine built without an AdapterRegistry (only the "
                   "identity adapter 0 exists)"))
        self.sched.submit(req)

    def cancel(self, uid: int) -> bool:
        """Client cancellation: terminal state CANCELLED, pages freed
        through the preemption decref path, nothing published.  False
        when ``uid`` is unknown or already terminal."""
        return self.sched.cancel(uid)

    def compiled_shapes(self) -> int:
        return self.exe.compiled_shapes()

    def stats(self) -> dict:
        """Serving metrics snapshot: lifecycle and fault counters,
        per-priority-class TTFT / ITL percentiles, scheduler and pool
        counters."""
        out = self.metrics.snapshot()
        out["steps"] = self.steps
        out["max_active"] = self.max_active
        out["preemptions"] = self.sched.preemptions
        out["requeues"] = self.sched.requeues
        out["watchdog_sheds"] = self.watchdog_sheds
        if self.prefix is not None:
            out["prefix_hits"] = self.sched.prefix_hits
            out["prefix_hit_tokens"] = self.sched.prefix_hit_tokens
        if self.host is not None:
            out["host_spills"] = self.host.spills
            out["host_restores"] = self.host.restores
            out["host_dropped"] = self.host.dropped
            out["host_hit_rate"] = self.host.hit_rate
            out["host_pages_used"] = len(self.host)
        if self.alloc is not None:
            out["page_util"] = self.alloc.utilization()
            out["peak_page_util"] = self.peak_page_util
            out["free_pages"] = self.alloc.free_pages
        if self.ecfg.spec_k > 0:
            out["accepted_per_round"] = self.accepted_per_round
        if self.adapters is not None:
            out["adapter_tokens"] = dict(sorted(
                self.adapter_tokens.items()))
            out["adapter_done"] = dict(sorted(self.adapter_done.items()))
        if self.faults is not None:
            out["faults_injected"] = self.faults.summary()
        return out

    def _slot_aids(self) -> Optional[np.ndarray]:
        """(slots,) adapter ids for the next step: each active slot's
        tenant, the identity (0) for idle rows; None without a registry,
        so the executor's steps take no ids (DESIGN.md §13)."""
        if self.adapters is None:
            return None
        return np.asarray([0 if r is None else r.adapter_id
                           for r in self.sched.slot_req], np.int32)

    def _sample(self, logits: np.ndarray, temp: float) -> int:
        if temp <= 0:
            return int(np.argmax(logits))
        z = logits.astype(np.float64) / temp
        p = np.exp(z - z.max())
        return int(self.rng.choice(len(p), p=p / p.sum()))

    def _commit(self, req: Request, tok: int, now: float):
        req.generated.append(tok)
        req.token_times.append(now)
        req.token_steps.append(self.steps)
        self._tokens_committed += 1
        self.adapter_tokens[req.adapter_id] += 1

    def _emit(self, slots: List[int], logits: np.ndarray):
        now = time.monotonic()
        for s in slots:
            req = self.sched.slot_req[s]
            tok = self._sample(logits[s], req.temperature)
            self._commit(req, tok, now)
            self.sched.last_token[s] = tok

    # -- fault guards (DESIGN.md §11) ----------------------------------
    def _fire(self, site: str) -> bool:
        return self.faults is not None and self.faults.fire(site)

    def _guarded(self, name: str, active: np.ndarray, fn, *args):
        """Run a step entry behind the fault boundary: inject scheduled
        failures, ALWAYS check that the active logits rows are finite,
        retry with the same inputs on failure.  One profiler span per
        attempt (``engine.<name>``), the host wait for its logits
        included.  Raises ``_StepAbort`` when the retries are spent."""
        retries = self.ecfg.step_retries
        err = None
        for attempt in range(retries + 1):
            try:
                if self._fire("step"):
                    raise FaultError(f"injected {name} failure")
                with torch.profiler.record_function(f"engine.{name}"):
                    logits, state = fn(*args)
                    logits = logits.float().cpu().numpy()
                if self._fire("nan"):
                    logits = np.full_like(logits, np.nan)
                if not np.isfinite(logits[active]).all():
                    raise FaultError(f"non-finite logits from {name}")
                if attempt > 0:
                    self.metrics.bump("faults_recovered")
                return logits, state
            except FaultError as e:
                err = e
                if attempt < retries:
                    self.metrics.bump("retries")
        raise _StepAbort(f"{name}: {err}")

    def _guarded_copy(self, src: np.ndarray, dst: np.ndarray):
        """One copy-on-write batch behind the same retry discipline."""
        for attempt in range(self.ecfg.step_retries + 1):
            if self._fire("page_copy"):
                if attempt < self.ecfg.step_retries:
                    self.metrics.bump("retries")
                continue
            with torch.profiler.record_function("engine.page_copy"):
                self.state = self.exe.page_copy(self.state, src, dst)
            if attempt > 0:
                self.metrics.bump("faults_recovered")
            return
        raise _StepAbort("page_copy: injected failure persisted")

    def _guarded_restore(self, rows, dst: np.ndarray) -> bool:
        """One fixed-width restore batch behind the fault boundary.
        Never raises: restore runs inside admission, outside ``step()``'s
        abort scope, and giving up is always safe (the caller
        re-prefills what the batch would have restored)."""
        for attempt in range(self.ecfg.step_retries + 1):
            if self._fire("host_copy"):
                if attempt < self.ecfg.step_retries:
                    self.metrics.bump("retries")
                continue
            with torch.profiler.record_function("engine.page_restore"):
                self.state = self.exe.page_restore(self.state, rows, dst)
            if attempt > 0:
                self.metrics.bump("faults_recovered")
            return True
        self.metrics.bump("host_restore_fallbacks")
        return False

    # -- host tier: spill and restore (DESIGN.md §12) ------------------
    def _spill_read(self, page: int) -> List[np.ndarray]:
        """The trie's page_reader: a blocking device->host copy of pool
        row ``page`` of every KV leaf, made before the page is freed."""
        with torch.profiler.record_function("engine.spill"):
            return self.exe.read_page(self.state, page)

    def _restore_pages(self, s: int, eff: np.ndarray, hit_pages: int,
                       extra: Tuple = ()) -> int:
        """Admission restore hook (``Scheduler.restore``): probe the
        host tier for the pages of ``eff`` beyond the trie hit and copy
        every CONSECUTIVE hit into the slot's own pages (``ensure``
        just allocated them, refcount 1, so no COW), in fixed-width
        batches, then publish the restored run into the trie again.
        Returns the pages restored: 0 on a miss, fewer when a
        ``host_copy`` fault spends its retries (the rest re-prefills).
        ``extra`` is the admitting request's adapter key: the probe and
        the re-publish both carry it, so spilled pages partition by
        tenant as the trie they fell out of does (DESIGN.md §13)."""
        host, alloc = self.host, self.alloc
        pt = alloc.page_tokens
        n_full = len(eff) // pt
        if n_full <= hit_pages:
            return 0
        hashes = self.prefix.chain_hashes(eff, n_full, extra=extra)
        hits = []
        for i in range(hit_pages, n_full):
            rows = host.get(hashes[i])
            if rows is None:
                break               # restores must stay consecutive
            hits.append(rows)
        if not hits:
            return 0
        # fixed-width batches, like _copy_pages: ONE shape.  dst padding
        # repeats the sentinel and rows padding is zero slabs, so the
        # duplicate target receives identical bytes.
        W = max(1, self.ecfg.slots)
        snt = alloc.sentinel
        restored = 0
        while restored < len(hits):
            batch = hits[restored:restored + W]
            dst = [alloc.tables[s][hit_pages + restored + j]
                   for j in range(len(batch))]
            dst += [snt] * (W - len(batch))
            rows = [np.stack(list(slabs) + [np.zeros_like(slabs[0])]
                             * (W - len(batch)), axis=1)
                    for slabs in zip(*batch)]
            if not self._guarded_restore(rows, np.asarray(dst, np.int32)):
                break
            restored += len(batch)
        if restored > 0:
            host.restores += restored
            self.metrics.bump("host_restored_pages", restored)
            self.prefix.insert(eff, alloc.tables[s][:hit_pages + restored],
                               extra=extra)
        return restored

    def _recover(self):
        """Retry-exhausted step: quarantine every active slot until the
        step clock passes the bench window and requeue its request (no
        publish; the re-prefill from host-held tokens is an exact
        continuation, as after a preemption)."""
        until = self.steps + 1 + self.ecfg.quarantine_steps
        for s in range(self.ecfg.slots):
            if self.sched.slot_req[s] is not None:
                self.sched.requeue(s, until)
        self.metrics.bump("quarantines")

    def _watchdog_shed(self):
        """No counter moved for ``watchdog_steps`` steps while work was
        pending: shed the lowest-priority (then youngest) request,
        queued victims before running ones."""
        sched = self.sched
        if sched.queue:
            victim = min(sched.queue, key=lambda r: (r.priority, -r._seq))
            sched.shed(("queue", victim.uid))
        else:
            cands = [s for s in range(self.ecfg.slots)
                     if sched.slot_req[s] is not None]
            if not cands:
                return
            victim = min(cands, key=lambda s: (
                sched.slot_req[s].priority, -sched.slot_seq[s]))
            sched.shed(("slot", victim))
        self.watchdog_sheds += 1
        self.metrics.bump("watchdog_sheds")

    # -- paged page coverage / COW / preemption ------------------------
    def _cover_writes(self, s: int, take_s: int, pairs: List) -> bool:
        """Page-cover slot ``s``'s next write window [written, written +
        take) AND copy-on-write any SHARED page inside it (a prefix-hit
        resume rewriting the last cached position): the slot's entry is
        repointed to a fresh page and (src, dst) joins ``pairs`` for
        the device copy, so the shared original is never mutated.
        False -> the pool ran out mid-way (or an injected ``alloc``
        fault said so); the caller reclaims and retries (completed COWs
        stay valid)."""
        alloc = self.alloc
        if take_s <= 0:
            return True
        if self._fire("alloc"):
            # injected transient exhaustion: report failure WITHOUT
            # touching the allocator, so the caller's retry is free
            self._alloc_fault = True
            return False
        start = int(self.written[s])
        end = start + take_s
        if not alloc.ensure(s, end):
            return False
        if self.prefix is None:
            return True         # sharing is impossible without the trie
        pt = alloc.page_tokens
        for idx in range(start // pt, (end - 1) // pt + 1):
            page = alloc.tables[s][idx]
            if alloc.refcount[page] > 1:
                if not alloc.free_pages:
                    return False
                pairs.append(alloc.cow(s, idx))
        return True

    def _copy_pages(self, pairs: List[Tuple[int, int]]):
        """Clone page contents src -> dst across every KV leaf in
        fixed-width batches (ONE shape; short batches pad with
        sentinel -> sentinel self-copies).  Pairs run in list order: a
        page freed after serving as a src may be reallocated as a later
        dst, never the reverse, and the kernel keeps that order."""
        W = max(1, self.ecfg.slots)
        snt = self.alloc.sentinel
        for i in range(0, len(pairs), W):
            batch = list(pairs[i:i + W])
            batch += [(snt, snt)] * (W - len(batch))
            self._guarded_copy(np.asarray([p[0] for p in batch], np.int32),
                               np.asarray([p[1] for p in batch], np.int32))

    def _ensure_pages(self, decode_width: int = 1):
        """Cover every active slot's upcoming writes with pages (COW
        faults included), oldest sequence first.  On pool exhaustion the
        reclaim ladder is: retry an INJECTED exhaustion up to
        ``step_retries`` times, then evict LRU unmapped prefix-cache
        pages (spilling them to the host tier if there is one), then
        preempt-and-requeue the YOUNGEST active sequence, and retry."""
        sched, alloc = self.sched, self.alloc
        take = sched.planned_writes(decode_width)
        order = sorted((s for s in range(self.ecfg.slots)
                        if sched.slot_req[s] is not None),
                       key=lambda s: sched.slot_seq[s])
        pairs: List[Tuple[int, int]] = []
        for s in order:
            streak = 0
            while sched.slot_req[s] is not None:
                if self._cover_writes(s, int(take[s]), pairs):
                    break
                if self._alloc_fault:
                    self._alloc_fault = False
                    if streak < self.ecfg.step_retries:
                        streak += 1
                        self.metrics.bump("retries")
                        continue
                    # persistent injected exhaustion: escalate to the
                    # real reclaim ladder (it keeps streams exact)
                # coverage may be short several pages (a COW fault on
                # top needs at most one more)
                short = max(1, alloc.pages_for(
                    int(self.written[s] + take[s]))
                    - len(alloc.tables[s]) - alloc.free_pages + 1)
                if self.prefix is not None and self.prefix.evict(short):
                    continue
                victims = [v for v in range(self.ecfg.slots)
                           if sched.slot_req[v] is not None]
                victim = max(victims, key=lambda v: sched.slot_seq[v])
                if victim == s and len(victims) == 1:
                    if self.faults is not None:
                        # only injected exhaustion gets here (admission
                        # guarantees a lone sequence fits): abort the
                        # step and requeue instead of dying
                        raise _StepAbort(
                            "injected allocator exhaustion persisted")
                    raise RuntimeError(
                        f"page pool exhausted: slot {s} needs "
                        f"{alloc.pages_for(int(self.written[s] + take[s]))}"
                        f" pages, pool has {alloc.n_pages}")
                sched.preempt(victim, n_valid=int(self.written[victim]))
        if pairs:
            self._copy_pages(pairs)

    # -- speculative round (DESIGN.md §8) ------------------------------
    def _spec_due(self) -> bool:
        """A speculative round replaces the plain decode step when the
        engine has a draft, no slot has prompt tokens left to chunk, and
        every active request is greedy (the acceptance rule is exact
        only for argmax sampling)."""
        sched = self.sched
        if not self.exe.spec_enabled or sched.has_chunk_work():
            return False
        reqs = [r for r in sched.slot_req if r is not None]
        return bool(reqs) and all(r.temperature <= 0 for r in reqs)

    def _spec_round(self, pages, wfloor) -> None:
        """One speculative round over all active slots (all in DECODE):
        the rank-sliced draft proposes ``k`` tokens per slot, then ONE
        (slots, k+1) verify window scores every position with the full
        model.  Each slot commits its longest draft prefix matching the
        full model's argmaxes plus the target token (1 to k+1 tokens,
        never leaving the non-speculative greedy stream), and the
        per-slot index rolls back over the rejected tail.  The draft
        steps start from the pre-draft state, as in the reference; their
        K/V writes land in the shared cache in place, and the verify
        rewrites all k+1 positions at full rank before anything reads
        them."""
        sched, ecfg = self.sched, self.ecfg
        k, W = ecfg.spec_k, ecfg.spec_window
        slots = ecfg.slots
        active = np.array([r is not None for r in sched.slot_req])
        aids = self._slot_aids()
        n0 = self.written.copy()
        tok = sched.last_token.copy()
        drafts = np.zeros((slots, k), np.int32)
        dstate = self.state
        for j in range(k):
            logits, dstate = self._guarded(
                "draft_step", active, self.exe.draft_step, dstate, tok,
                pages, wfloor, aids)
            tok = np.argmax(logits, axis=-1).astype(np.int32)
            drafts[:, j] = tok
        tokens = np.zeros((slots, W), np.int32)
        tokens[:, 0] = sched.last_token        # pending, not yet cached
        tokens[:, 1:] = drafts
        lengths = np.where(active, W, 0).astype(np.int32)
        logits, self.state = self._guarded(
            "verify_chunk", active, self.exe.verify_chunk, self.state,
            tokens, lengths, pages, wfloor, aids)
        targets = np.argmax(logits, axis=-1)                   # (slots, W)
        now = time.monotonic()
        self.spec_rounds += 1
        for s in range(slots):
            if not active[s]:
                continue
            req = sched.slot_req[s]
            a = 0
            while a < k and drafts[s, a] == targets[s, a]:
                a += 1
            out = [int(t) for t in drafts[s, :a]] + [int(targets[s, a])]
            # stop at max_new_tokens / eos as the one-token path would:
            # the slot retires this step, so the over-committed cache
            # tail is unreachable
            out = out[:req.max_new_tokens - len(req.generated)]
            if ecfg.eos_id >= 0 and ecfg.eos_id in out:
                out = out[:out.index(ecfg.eos_id) + 1]
            for t in out:
                self._commit(req, t, now)
            self.accept_hist[len(out)] += 1
            sched.last_token[s] = targets[s, a]
            self.written[s] = n0[s] + a + 1
        # roll back: commit per-slot lengths (idle slots at 0)
        self.state = self.exe.commit_index(self.state, self.written)

    @property
    def accepted_per_round(self) -> float:
        """Mean tokens emitted per speculative slot-round (>= 1.0; 1.0 =
        nothing ever accepted, k+1 = every draft accepted)."""
        n = sum(self.accept_hist.values())
        return (sum(a * c for a, c in self.accept_hist.items()) / n
                if n else 0.0)

    # ------------------------------------------------------------------
    def _step_inner(self) -> int:
        """Plan, run one step (or speculative round) behind the fault
        boundary, apply its progress, retire.  Raises ``_StepAbort``
        with NO host bookkeeping applied for the aborted call."""
        sched = self.sched
        spec = self._spec_due()
        pages = wfloor = None
        # freshly admitted rows start their tenure at their resume point
        # (0, or the first uncached position on a prefix hit); IDLE rows
        # are pinned at 0 through the same fresh-reset: decode advances
        # every row's index, so a long-idle row would otherwise run past
        # its page table
        active_rows = np.array([r is not None for r in sched.slot_req])
        fresh_rows = sched.fresh & active_rows
        self.written[fresh_rows] = sched.resume[fresh_rows]
        self.written[~active_rows] = 0
        resume = np.where(active_rows, sched.resume, 0).astype(np.int32)
        if self.alloc is not None:
            self._ensure_pages(self.ecfg.spec_window if spec else 1)
            pages = self.alloc.table_array()
            # writes below each slot's resume point are rerouted to the
            # garbage row on the device: a shared cached prefix is never
            # written even if the host bookkeeping were wrong
            wfloor = resume
            self.peak_page_util = max(self.peak_page_util,
                                      self.alloc.utilization())
        # recompute after _ensure_pages: preemption may have idled slots
        active = np.array([r is not None for r in sched.slot_req])
        aids = self._slot_aids()
        self.max_active = max(self.max_active, int(active.sum()))
        if sched.has_chunk_work():
            tokens, lengths, fresh = sched.plan_chunk()
            logits, self.state = self._guarded(
                "prefill_chunk", lengths > 0, self.exe.prefill_chunk,
                self.state, tokens, lengths, fresh | ~active, resume,
                pages, wfloor, aids)
            self.written += lengths
            self._prefill_consumed += int(lengths.sum())
            self._emit(sched.advance_chunk(lengths), logits)
        elif spec and active.any():
            self._spec_round(pages, wfloor)
        elif active.any():
            tokens, fresh = sched.plan_decode()
            logits, self.state = self._guarded(
                "decode_step", active, self.exe.decode_step, self.state,
                tokens, fresh | ~active, resume, pages, wfloor, aids)
            self.written += 1
            self._emit(sched.advance_decode(), logits)
        else:
            return 0
        sched.retire(self.written)
        return len([r for r in sched.slot_req if r is not None])

    def _progress_marker(self) -> Tuple[int, int, int]:
        return (self._tokens_committed, self._prefill_consumed,
                self.metrics.n_terminal)

    def step(self) -> int:
        """One engine step: advance the step clock, enforce deadlines,
        admit, run one step behind the fault boundary, recover from an
        aborted step, feed the watchdog.  Returns the number of active
        slots after the step."""
        sched = self.sched
        sched.now_step = self.steps
        sched.enforce_deadlines()
        sched.admit()
        before = self._progress_marker()
        try:
            n_active = self._step_inner()
        except _StepAbort:
            self._recover()
            n_active = 0
        if self._progress_marker() != before:
            self._last_progress = self.steps
        elif (self.ecfg.watchdog_steps > 0 and sched.busy
              and self.steps - self._last_progress
              >= self.ecfg.watchdog_steps):
            self._watchdog_shed()
            self._last_progress = self.steps
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
