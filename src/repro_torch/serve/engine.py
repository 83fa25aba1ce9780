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
Their state is not page-addressable, so ``prefix_cache`` raises on
them, as in the reference; ``paged=True`` allocates pages that hold no
KV leaves.  (Speculation, which the reference refuses on them too, is
refused for every model by ``EngineConfig``.)

Left out until their slices: speculation, tensor parallelism, SV
adapters and fault injection.  A step whose active logits are not
finite raises, and so does a failed copy or restore: it is never
turned into a re-prefill.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.bridge import tree_map
from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as T
from repro_torch.serve.config import EngineConfig
from repro_torch.serve.executor import LocalExecutor, is_recurrent
from repro_torch.serve.memory import HostTier, PageAllocator, PrefixCache
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
        if ecfg.prefix_cache and recurrent:
            raise ValueError(
                "prefix caching requires an attention-only architecture: "
                "recurrent (mamba/rwkv) state is not page-addressable, so "
                "a cached page run cannot reconstruct it")
        self.cfg = cfg
        self.ecfg = ecfg
        self.rng = np.random.default_rng(seed)
        params = tree_map(lambda t: t.to(self.device), params)
        self.exe = LocalExecutor(params, cfg, ecfg, self.device)
        self.state = self.exe.init_state()
        self.alloc: Optional[PageAllocator] = (
            PageAllocator(ecfg.pool_pages, ecfg.page_tokens, ecfg.slots,
                          ecfg.table_pages) if ecfg.paged else None)
        self.prefix: Optional[PrefixCache] = None
        self.host: Optional[HostTier] = None
        if ecfg.prefix_cache:
            # the trie key folds in the rank plan (and, in the
            # reference, the tp head partition — empty on one device):
            # caches under another prune ratio / CLOVER rank / page
            # size never alias.  Same tuple as the reference, so the
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
        Returns the pages restored."""
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
        for start in range(0, len(hits), W):
            batch = hits[start:start + W]
            dst = [alloc.tables[s][hit_pages + start + j]
                   for j in range(len(batch))]
            dst += [snt] * (W - len(batch))
            rows = [np.stack(list(slabs) + [np.zeros_like(slabs[0])]
                             * (W - len(batch)), axis=1)
                    for slabs in zip(*batch)]
            with torch.profiler.record_function("engine.page_restore"):
                self.state = self.exe.page_restore(
                    self.state, rows, np.asarray(dst, np.int32))
        host.restores += len(hits)
        self.metrics.bump("host_restored_pages", len(hits))
        self.prefix.insert(eff, alloc.tables[s][:hit_pages + len(hits)],
                           extra=extra)
        return len(hits)

    # -- paged page coverage / COW / preemption ------------------------
    def _cover_writes(self, s: int, take_s: int, pairs: List) -> bool:
        """Page-cover slot ``s``'s next write window [written, written +
        take) AND copy-on-write any SHARED page inside it (a prefix-hit
        resume rewriting the last cached position): the slot's entry is
        repointed to a fresh page and (src, dst) joins ``pairs`` for
        the device copy, so the shared original is never mutated.
        False -> the pool ran out mid-way; the caller reclaims and
        retries (completed COWs stay valid)."""
        alloc = self.alloc
        if take_s <= 0:
            return True
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
            src = np.asarray([p[0] for p in batch], np.int32)
            dst = np.asarray([p[1] for p in batch], np.int32)
            with torch.profiler.record_function("engine.page_copy"):
                self.state = self.exe.page_copy(self.state, src, dst)

    def _ensure_pages(self):
        """Cover every active slot's upcoming writes with pages (COW
        faults included), oldest sequence first.  On pool exhaustion
        the reclaim ladder is: evict LRU unmapped prefix-cache pages
        (spilling them to the host tier if there is one), then
        preempt-and-requeue the YOUNGEST active sequence, and retry."""
        sched, alloc = self.sched, self.alloc
        take = sched.planned_writes()
        order = sorted((s for s in range(self.ecfg.slots)
                        if sched.slot_req[s] is not None),
                       key=lambda s: sched.slot_seq[s])
        pairs: List[Tuple[int, int]] = []
        for s in order:
            while sched.slot_req[s] is not None:
                if self._cover_writes(s, int(take[s]), pairs):
                    break
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
                    # admission guarantees a lone sequence always fits
                    raise RuntimeError(
                        f"page pool exhausted: slot {s} needs "
                        f"{alloc.pages_for(int(self.written[s] + take[s]))}"
                        f" pages, pool has {alloc.n_pages}")
                sched.preempt(victim, n_valid=int(self.written[victim]))
        if pairs:
            self._copy_pages(pairs)

    # ------------------------------------------------------------------
    def _step_inner(self) -> int:
        sched = self.sched
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
            self._ensure_pages()
            pages = self.alloc.table_array()
            # writes below each slot's resume point are rerouted to the
            # garbage row on the device: a shared cached prefix is never
            # written even if the host bookkeeping were wrong
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
        sched.retire(self.written)
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
