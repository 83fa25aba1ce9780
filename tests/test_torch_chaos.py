"""Overload safety in the port against the JAX package (DESIGN.md §11):
``FaultPlan`` decisions, a seeded chaos soak in lockstep with the JAX
engine under the same plan, cancellation, deadlines and the watchdog,
and the retry soundness of the port's in-place K/V writes.

Weights: a reduced gpt2-xl (2 layers, d_model 128) decomposed and pruned
0.5 / 0.5 by the reference and bridged to the port, so both engines run
the same numbers; rwkv6-1.6b reduced for the recurrent retry case.
Lockstep means phases, page tables, free lists, refcounts, trie nodes,
request statuses and fault counters identical after every step, and
identical streams.  The retry test compares decode states bit for bit,
with one CPU thread (threaded CPU GEMMs may split sums differently from
call to call).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the xdist workers already fill the CPUs, and a
# torch thread pool per worker oversubscribes them many times over
torch.set_num_threads(1)

import jax  # noqa: E402

from repro import serve as JS  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import clover_decompose as jax_decompose  # noqa: E402
from repro.core import clover_prune as jax_prune  # noqa: E402
from repro.models import init_lm_params as jax_init  # noqa: E402
from repro.serve import faults as jfaults  # noqa: E402
from repro_torch import serve as S  # noqa: E402
from repro_torch.bridge import from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.prune import _set_ranks  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve import faults  # noqa: E402

CPU = "cpu"


@pytest.fixture(scope="module")
def model():
    """(jax params, jax cfg, port params, port cfg), pruned 0.5."""
    jcfg = jax_config("gpt2-xl").reduced()
    jp = jax_init(jcfg, jax.random.PRNGKey(5))
    jd, jdc, _ = jax_decompose(jp, jcfg, peft=False)
    jpp, jpc = jax_prune(jd, jdc, qk_ratio=0.5, vo_ratio=0.5)
    cfg = get_config("gpt2-xl").reduced()
    cfg = dataclasses.replace(
        _set_ranks(cfg, jpc.qk_dim, jpc.vo_dim),
        clover=dataclasses.replace(cfg.clover, **dataclasses.asdict(
            jpc.clover)))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jpc)
    return jpp, jpc, from_numpy(jax.tree.map(np.asarray, jpp), CPU), cfg


# ---------------------------------------------------------------------------
# FaultPlan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 20260807])
def test_fault_plan_decisions_match_reference(seed):
    """Decision i at site s is the same pure function of (seed, s, i):
    interleaved calls, a cap on the total and ``summary`` as the
    reference's."""
    for kw in (dict(rates={s: 0.3 for s in faults.SITES}),
               dict(rates={"step": 0.5, "nan": 0.2}, max_faults=9)):
        mine, ref = faults.FaultPlan(seed=seed, **kw), \
            jfaults.FaultPlan(seed=seed, **kw)
        order = np.random.default_rng(seed).choice(faults.SITES, 300)
        assert [mine.fire(s) for s in order] == [ref.fire(s) for s in order]
        assert mine.summary() == ref.summary()
        assert mine.total_injected == ref.total_injected > 0
    a, b = faults.FaultPlan.chaos(seed, 0.06), \
        jfaults.FaultPlan.chaos(seed, 0.06)
    assert [a.fire("alloc") for _ in range(100)] == \
        [b.fire("alloc") for _ in range(100)]
    with pytest.raises(ValueError, match="unknown sites"):
        faults.FaultPlan(rates={"disk": 0.1})
    with pytest.raises(ValueError, match="must be in"):
        faults.FaultPlan(rates={"step": 1.5})


def test_engine_config_robustness_fields_match_reference():
    for name in ("step_retries", "quarantine_steps", "watchdog_steps"):
        assert getattr(S.EngineConfig(), name) == \
            getattr(JS.EngineConfig(), name)
        with pytest.raises(ValueError, match=name):
            S.EngineConfig(**{name: -1})
    with pytest.raises(ValueError, match="Request.deadline_steps"):
        S.Request(uid=0, prompt=np.arange(3, dtype=np.int32),
                  deadline_steps=0)


# ---------------------------------------------------------------------------
# lockstep helpers
# ---------------------------------------------------------------------------

def _specs(seed, n, prefix=None):
    """Seeded request fields as the reference's chaos tests draw them.
    With ``prefix`` (two pages), uid % 3 == 0 prompts are the prefix
    alone (a full trie hit: the rewrite of its last position copies the
    shared page) and uid % 3 == 1 prompts start with it."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        p = rng.integers(0, 512, int(rng.integers(3, 9))).astype(np.int32)
        if prefix is not None and i % 3 < 2:
            p = prefix.copy() if i % 3 == 0 else np.concatenate([prefix, p])
        out.append(dict(
            uid=i, prompt=p, max_new_tokens=int(rng.integers(2, 7)),
            priority=int(rng.integers(0, 3)),
            deadline_steps=(int(rng.integers(15, 40))
                            if rng.random() < 0.3 else None)))
    return out


def _check_same(teng, jeng, step):
    assert list(teng.sched.phase) == list(jeng.sched.phase), step
    assert [None if r is None else r.uid for r in teng.sched.slot_req] == \
        [None if r is None else r.uid for r in jeng.sched.slot_req], step
    assert [r.uid for r in teng.sched.queue] == \
        [r.uid for r in jeng.sched.queue], step
    assert list(teng.sched.quarantined) == \
        list(jeng.sched.quarantined), step
    assert teng.metrics.counters == jeng.metrics.counters, step
    if teng.alloc is not None:
        teng.alloc.assert_consistent(teng.prefix, context=f"{step}")
        assert teng.alloc.tables == jeng.alloc.tables, step
        assert teng.alloc.free_list == jeng.alloc.free_list, step
        assert teng.alloc.refcount == jeng.alloc.refcount, step
    if teng.prefix is not None:
        assert teng.prefix.nodes == jeng.prefix.nodes, step


def _drive(jeng, teng, specs, arrive, cancels, max_steps):
    """Submit ``specs`` at their arrival steps, cancel at the pinned
    steps, step both engines together until both drain."""
    jreqs = [JS.Request(**s) for s in specs]
    treqs = [S.Request(**s) for s in specs]
    nxt = 0
    for step in range(max_steps):
        while nxt < len(specs) and arrive[nxt] <= step:
            jeng.submit(jreqs[nxt])
            teng.submit(treqs[nxt])
            nxt += 1
        if step in cancels:
            assert teng.cancel(cancels[step]) == jeng.cancel(cancels[step])
        jeng.step()
        teng.step()
        _check_same(teng, jeng, step)
        if nxt == len(specs) and not (jeng.sched.busy or teng.sched.busy):
            break
    assert nxt == len(specs) and not teng.sched.busy, "did not drain"
    assert [r.status for r in treqs] == [r.status for r in jreqs]
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    assert teng.steps == jeng.steps
    assert teng.watchdog_sheds == jeng.watchdog_sheds
    assert all(r.done for r in treqs)
    assert teng.metrics.n_terminal == len(treqs)
    return treqs


def _replay(tp, cfg, specs, max_len=48):
    """Fault-free, uncontended replay (no priorities, deadlines or page
    pressure): the oracle every surviving stream must match."""
    eng = S.Engine(tp, cfg, S.EngineConfig(slots=4, max_len=max_len,
                                           prefill_chunk=4), device=CPU)
    reqs = [S.Request(uid=s["uid"], prompt=s["prompt"],
                      max_new_tokens=s["max_new_tokens"]) for s in specs]
    eng.run(reqs)
    assert all(r.status == S.DONE for r in reqs)
    return {r.uid: r.generated for r in reqs}


def _soak(model, seed, intensity, n=12, max_steps=400, spec_k=0):
    jp, jcfg, tp, cfg = model
    rng = np.random.default_rng(seed + 100)
    prefix = rng.integers(0, 512, 8).astype(np.int32)
    specs = _specs(seed, n, prefix)
    arrive = sorted(int(rng.integers(0, max_steps // 6)) for _ in specs)
    cancels = {arrive[u] + int(rng.integers(0, 4)): int(u)
               for u in rng.choice(n, size=2, replace=False)}
    kw = dict(slots=3, max_len=48, prefill_chunk=4, paged=True,
              page_tokens=4, n_pages=12, prefix_cache=True, host_pages=24,
              step_retries=1, quarantine_steps=2, watchdog_steps=16,
              spec_k=spec_k)
    plans = [None, None]
    if intensity is not None:
        plans = [jfaults.FaultPlan.chaos(seed, intensity),
                 faults.FaultPlan.chaos(seed, intensity)]
    jeng = JS.Engine(jp, jcfg, JS.EngineConfig(**kw), faults=plans[0])
    teng = S.Engine(tp, cfg, S.EngineConfig(**kw), device=CPU,
                    faults=plans[1])
    reqs = _drive(jeng, teng, specs, arrive, cancels, max_steps)
    if plans[1] is not None:
        assert plans[1].summary() == plans[0].summary()
    oracle = _replay(tp, cfg, specs)
    for r in reqs:
        want = oracle[r.uid]
        if r.status == S.DONE:
            assert r.generated == want, (seed, r.uid)
        else:
            assert r.generated == want[:len(r.generated)], (seed, r.uid)
    teng.prefix.evict(teng.alloc.n_pages)
    teng.alloc.assert_consistent(teng.prefix, context="drain")
    assert teng.alloc.free_pages == teng.alloc.n_pages
    return teng, plans[1], reqs


# ---------------------------------------------------------------------------
# the soak
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec_k", [0, 2])
def test_chaos_soak_lockstep_with_jax(model, spec_k):
    """Every site under pressure (page copies through COW hits, restores
    through the host tier), in lockstep with the JAX engine; surviving
    streams equal the fault-free uncontended replay."""
    eng, plan, reqs = _soak(model, seed=3, intensity=0.1, spec_k=spec_k)
    fired = plan.summary()
    assert all(fired[s] > 0 for s in ("alloc", "step", "nan", "page_copy"))
    c = eng.stats()["counters"]
    assert c.get("retries", 0) > 0 and c.get("quarantines", 0) > 0
    assert eng.sched.requeues > 0 and eng.host.spills > 0
    assert {r.status for r in reqs} >= {S.DONE, S.CANCELLED}
    assert (eng.spec_rounds > 0) == (spec_k > 0)


@pytest.mark.parametrize("rate", [0.0, 1.0])
def test_host_copy_faults_fall_back_to_prefill_lockstep(model, rate):
    """A system prompt's pages spill to the host tier under churn; the
    next request with it restores them (rate 0) or, with every restore
    batch failing (rate 1), re-prefills them: same streams either way,
    in lockstep with the JAX engine."""
    rng = np.random.default_rng(9)
    sys_p = rng.integers(0, 512, 8).astype(np.int32)
    prompts = [np.concatenate([sys_p, rng.integers(0, 512, 3)]),
               rng.integers(0, 512, 13), rng.integers(0, 512, 13),
               np.concatenate([sys_p, rng.integers(0, 512, 2)])]
    specs = [dict(uid=i, prompt=p.astype(np.int32), max_new_tokens=4)
             for i, p in enumerate(prompts)]
    plans = (jfaults.FaultPlan(seed=1, rates={"host_copy": rate}),
             faults.FaultPlan(seed=1, rates={"host_copy": rate}))
    jeng, teng = _engines(model, plans, slots=1, max_len=32,
                          prefill_chunk=4, paged=True, page_tokens=4,
                          n_pages=6, prefix_cache=True, host_pages=16,
                          step_retries=1)
    reqs = _drive(jeng, teng, specs, [0, 0, 0, 0], {}, 300)
    c = teng.stats()["counters"]
    assert teng.host.spills > 0
    if rate:
        assert plans[1].summary()["host_copy"] == 2
        assert teng.host.restores == 0
        assert c["host_restore_fallbacks"] == 1
    else:
        assert teng.host.restores == 2 and c["host_restored_pages"] == 2
    oracle = _replay(model[2], model[3], specs)
    assert [r.generated for r in reqs] == [oracle[i] for i in range(4)]


def test_chaos_zero_intensity_matches_fault_free(model):
    """A zero-rate plan injects nothing and changes nothing: the same
    histories, statuses and streams as the engine without a plan."""
    eng0, plan, reqs0 = _soak(model, seed=3, intensity=0.0, n=8)
    eng1, _, reqs1 = _soak(model, seed=3, intensity=None, n=8)
    assert plan.total_injected == 0
    assert eng0.stats()["counters"].get("quarantines", 0) == 0
    assert [(r.status, r.generated, r.token_steps) for r in reqs0] == \
        [(r.status, r.generated, r.token_steps) for r in reqs1]
    assert eng0.steps == eng1.steps


# ---------------------------------------------------------------------------
# cancellation, deadlines, watchdog
# ---------------------------------------------------------------------------

def _engines(model, faults_pair=(None, None), **kw):
    jp, jcfg, tp, cfg = model
    return (JS.Engine(jp, jcfg, JS.EngineConfig(**kw),
                      faults=faults_pair[0]),
            S.Engine(tp, cfg, S.EngineConfig(**kw), device=CPU,
                     faults=faults_pair[1]))


def test_cancel_queued_and_running_lockstep(model):
    jeng, teng = _engines(model, slots=1, max_len=32, prefill_chunk=4,
                          paged=True, page_tokens=4, n_pages=8)
    specs = [dict(uid=i, prompt=np.arange(5, dtype=np.int32) + 7 * i,
                  max_new_tokens=6) for i in range(3)]
    reqs = _drive(jeng, teng, specs, [0, 0, 0], {2: 0, 3: 2}, 200)
    assert [r.status for r in reqs] == [S.CANCELLED, S.DONE, S.CANCELLED]
    assert teng.alloc.free_pages == teng.alloc.n_pages
    assert teng.cancel(1) is False and teng.cancel(99) is False


def test_deadlines_time_out_and_shed_lockstep(model):
    """A running request past its deadline times out with a partial
    stream; a low-priority queued one whose deadline cannot be met
    under higher-priority contention is shed."""
    jeng, teng = _engines(model, slots=1, max_len=32, prefill_chunk=4)
    specs = [dict(uid=0, prompt=np.arange(6, dtype=np.int32) + 1,
                  max_new_tokens=12, deadline_steps=6),
             dict(uid=1, prompt=np.arange(4, dtype=np.int32) + 9,
                  max_new_tokens=4, priority=2),
             dict(uid=2, prompt=np.arange(7, dtype=np.int32) + 3,
                  max_new_tokens=8, deadline_steps=9)]
    reqs = _drive(jeng, teng, specs, [0, 1, 1], {}, 200)
    assert [r.status for r in reqs] == [S.TIMED_OUT, S.DONE, S.SHED]
    assert 0 < len(reqs[0].generated) < 12 and reqs[2].generated == []


def test_watchdog_sheds_a_wedged_engine_lockstep(model):
    """Rate-1.0 step faults wedge every step: the watchdog drains the
    engine by shedding, as the reference's does."""
    plans = (jfaults.FaultPlan(seed=0, rates={"step": 1.0}),
             faults.FaultPlan(seed=0, rates={"step": 1.0}))
    jeng, teng = _engines(model, plans, slots=2, max_len=32,
                          prefill_chunk=4, step_retries=1,
                          quarantine_steps=2, watchdog_steps=8)
    specs = [dict(uid=i, prompt=np.arange(4, dtype=np.int32) + 5 * i,
                  max_new_tokens=4) for i in range(3)]
    reqs = _drive(jeng, teng, specs, [0, 0, 0], {}, 2000)
    assert all(r.status == S.SHED for r in reqs)
    assert teng.watchdog_sheds == 3 and teng.steps < 2000
    assert teng.stats()["counters"]["shed"] == 3


# ---------------------------------------------------------------------------
# retry soundness of the in-place writes
# ---------------------------------------------------------------------------

def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


@pytest.mark.parametrize("case", ["dense-spec", "paged", "rwkv6"])
def test_retried_step_state_bitwise_equals_unfaulted(model, case):
    """``nan`` faults fire AFTER a step wrote its K/V in place; the retry
    runs the step again on the same input state.  After every engine
    step the faulted engine's decode state equals the unfaulted one's
    bit for bit, so the executor need not donate-protect its state
    (``donates_state`` stays False)."""
    _, _, tp, cfg = model
    kw = dict(slots=2, max_len=32, prefill_chunk=4, step_retries=8)
    if case == "dense-spec":
        kw.update(spec_k=2)
    elif case == "paged":
        kw.update(paged=True, page_tokens=4, n_pages=10)
    else:
        cfg = get_config("rwkv6-1.6b").reduced()
        tp = T.init_lm_params(cfg, 0, device=CPU)
    prompts = [np.arange(7, dtype=np.int32) + 3,
               np.arange(10, dtype=np.int32) + 40,
               np.arange(5, dtype=np.int32) + 90]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        plan = faults.FaultPlan(seed=2, rates={"nan": 0.4})
        engs = [S.Engine(tp, cfg, S.EngineConfig(**kw), device=CPU,
                         faults=f) for f in (plan, None)]
        assert not engs[0].exe.donates_state
        reqs = [[S.Request(uid=i, prompt=p, max_new_tokens=6)
                 for i, p in enumerate(prompts)] for _ in engs]
        for e, rs in zip(engs, reqs):
            for r in rs:
                e.submit(r)
        while engs[1].sched.busy:
            for e in engs:
                e.step()
            a, b = (list(_leaves(e.state)) for e in engs)
            assert all(torch.equal(x, y) for x, y in zip(a, b)), engs[0].steps
    finally:
        torch.set_num_threads(threads)
    assert not engs[0].sched.busy
    c = engs[0].stats()["counters"]
    assert c["retries"] > 0 and c["faults_recovered"] > 0
    assert c.get("quarantines", 0) == 0
    assert [r.generated for r in reqs[0]] == [r.generated for r in reqs[1]]
