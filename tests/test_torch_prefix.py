"""The port's prefix caching and host spill tier against the JAX
package's: the page-mover plain versions against the reference's
oracles and its Pallas kernels in interpret mode (exact: they are
copies), the trie and host tier against the reference classes under
one operation sequence (identical matches, nodes, eviction order, chain
hashes and LRU drops), and prefix-cached engines in lockstep with the
reference engine on the same numpy-bridged weights at a reduced
gpt2-xl (identical allocator and trie state every step, identical
streams, spills and restores)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the xdist workers already fill the CPUs, and a
# torch thread pool per worker oversubscribes them many times over
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import serve as JS  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import clover_decompose as jax_decompose  # noqa: E402
from repro.core import clover_prune as jax_prune  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import init_lm_params as jax_init  # noqa: E402
from repro.serve import memory as JM  # noqa: E402
from repro_torch import serve as S  # noqa: E402
from repro_torch.bridge import from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.decompose import clover_decompose  # noqa: E402
from repro_torch.core.prune import clover_prune  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels.page_copy import page_copy, page_restore  # noqa: E402
from repro_torch.serve import memory as M  # noqa: E402

CPU = "cpu"


# ---------------------------------------------------------------------------
# page movers: plain versions vs the reference oracles and Pallas kernels
# ---------------------------------------------------------------------------

def _pool(rng, nb, N, pt, KV, r):
    return rng.standard_normal((nb, N, pt, KV, r)).astype(np.float32)


def _in_order_copy(pool, src, dst):
    """The CUDA kernel's algorithm in numpy: pairs moved one at a time,
    in order (each thread of the kernel walks them so)."""
    out = pool.copy()
    for s, d in zip(src, dst):
        out[:, d] = out[:, s]
    return out


COPY_CASES = {
    # (nb, N, pt, KV, r), src, dst; N - 1 is the sentinel row
    "pairs+sentinel-padding": ((3, 9, 4, 2, 16), [0, 3, 8, 8], [2, 1, 8, 8]),
    # pair 0 reads page 5, pair 2 overwrites it: in order, pair 0 must
    # still clone the ORIGINAL page 5
    "in-order-hazard": ((2, 10, 4, 2, 8), [5, 1, 3, 9], [0, 6, 5, 9]),
    # pt*KV*r*4 = 60 bytes: not a multiple of 16 (the scalar kernel)
    "odd-row-bytes": ((1, 6, 3, 1, 5), [0, 4, 2], [3, 1, 5]),
    "m=7": ((2, 12, 2, 3, 4), [0, 1, 2, 3, 4, 11, 11],
            [5, 6, 7, 8, 9, 11, 11]),
}


@pytest.mark.parametrize("case", sorted(COPY_CASES))
def test_page_copy_ref_matches_jax(case):
    shape, src, dst = COPY_CASES[case]
    pool = _pool(np.random.default_rng(0), *shape)
    s, d = np.asarray(src, np.int32), np.asarray(dst, np.int32)
    got = ref.page_copy_ref(torch.from_numpy(pool.copy()),
                            torch.from_numpy(s), torch.from_numpy(d)).numpy()
    want = np.asarray(jref.page_copy_ref(jnp.asarray(pool), s, d))
    pallas = np.asarray(jops.page_copy(jnp.asarray(pool), jnp.asarray(s),
                                       jnp.asarray(d), impl="interpret"))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, _in_order_copy(pool, s, d))
    untouched = [i for i in range(shape[1]) if i not in set(dst)]
    np.testing.assert_array_equal(got[:, untouched], pool[:, untouched])
    for a, b in zip(s, d):
        if a not in d[:list(d).index(b)]:
            np.testing.assert_array_equal(got[:, b], pool[:, a])


@pytest.mark.parametrize("shape,dst,n_real", [
    ((3, 9, 4, 2, 16), [4, 1, 8, 8], 2),      # two zero-slab pads
    ((1, 6, 3, 1, 5), [2, 0, 5], 2),          # odd row bytes, one pad
    ((2, 7, 2, 2, 8), [6, 3, 0, 1], 4),       # no padding
])
def test_page_restore_ref_matches_jax(shape, dst, n_real):
    rng = np.random.default_rng(1)
    pool = _pool(rng, *shape)
    rows = rng.standard_normal(
        (shape[0], len(dst)) + shape[2:]).astype(np.float32)
    rows[:, n_real:] = 0.0                    # padding carries zero slabs
    d = np.asarray(dst, np.int32)
    got = ref.page_restore_ref(torch.from_numpy(pool.copy()),
                               torch.from_numpy(rows),
                               torch.from_numpy(d)).numpy()
    want = np.asarray(jref.page_restore_ref(jnp.asarray(pool), rows, d))
    pallas = np.asarray(jops.page_restore(jnp.asarray(pool),
                                          jnp.asarray(rows), jnp.asarray(d),
                                          impl="interpret"))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pallas)
    for i, p in enumerate(dst):
        np.testing.assert_array_equal(got[:, p], rows[:, i])
    untouched = [i for i in range(shape[1]) if i not in set(dst)]
    np.testing.assert_array_equal(got[:, untouched], pool[:, untouched])


def test_ops_dispatch_page_movers_cpu_to_plain_versions():
    """CPU tensors reach the plain versions (counted, in place), never a
    kernel launch; the kernel wrappers refuse CPU tensors before any
    build is attempted."""
    rng = np.random.default_rng(2)
    pool = torch.from_numpy(_pool(rng, 2, 5, 2, 1, 4))
    src = torch.tensor([0, 4], dtype=torch.int32)
    dst = torch.tensor([3, 4], dtype=torch.int32)
    rows = torch.ones(2, 2, 2, 1, 4)
    before = (ref.page_copy_ref.calls, ref.page_restore_ref.calls,
              page_copy.launches, page_restore.launches)
    want = pool[:, 0].clone()
    assert ops.page_copy(pool, src, dst) is pool
    assert torch.equal(pool[:, 3], want)
    assert ops.page_restore(pool, rows, dst) is pool
    assert torch.equal(pool[:, 3], rows[:, 0])
    assert (ref.page_copy_ref.calls, ref.page_restore_ref.calls,
            page_copy.launches, page_restore.launches) == (
        before[0] + 1, before[1] + 1, before[2], before[3])
    with pytest.raises(ValueError, match="CUDA"):
        page_copy(pool, src, dst)
    with pytest.raises(ValueError, match="CUDA"):
        page_restore(pool, rows, dst)
    assert _build._lib is None
    assert set(_build.SIGNATURES) >= {"clover_page_copy",
                                      "clover_page_restore"}


# ---------------------------------------------------------------------------
# trie + host tier vs the reference classes, one operation sequence
# ---------------------------------------------------------------------------

def _trie_walk(mod, seed, n_ops=400):
    """Drive ``mod``'s allocator / PrefixCache / HostTier through a
    seeded sequence of admissions (match + map_shared + ensure +
    insert), releases, probes and evictions with a spill reader
    attached.  Returns the log of every result and state snapshot."""
    rng = np.random.default_rng(seed)
    a = mod.PageAllocator(n_pages=14, page_tokens=2, slots=3,
                          table_pages=8)
    t = mod.PrefixCache(a, salt=("gpt2-xl", 16, 16, True, 16, 16, 2))
    t.host = mod.HostTier(5)
    spilled = []

    def reader(page):
        assert page not in a.free_list
        spilled.append(page)
        return ("rows", page)

    t.page_reader = reader
    log = []
    for _ in range(n_ops):
        op = int(rng.integers(0, 5))
        s = int(rng.integers(0, 3))
        if op == 0 and not a.tables[s]:
            toks = rng.integers(0, 2, int(rng.integers(1, 13))).astype(
                np.int32)
            pages = t.match(toks)
            ok = a.map_shared(s, pages) and a.ensure(s, len(toks))
            if not ok:
                a.release(s)
            else:
                t.insert(toks, a.tables[s])
            keys = t.chain_hashes(toks, len(toks) // 2)
            log.append(("admit", pages, ok, keys,
                        [t.host.get(k) for k in keys]))
        elif op == 1:
            log.append(("release", a.release(s)))
        elif op == 2:
            toks = rng.integers(0, 2, 8).astype(np.int32)
            log.append(("match", t.match(toks)))
        else:
            log.append(("evict", t.evict(int(rng.integers(1, 4))),
                        list(spilled)))
        a.assert_consistent(t)
        log.append((list(a.free_list), list(a.refcount),
                    [list(x) for x in a.tables], dict(t.nodes),
                    list(t.host._slots.items()), t.host.spills,
                    t.host.dropped, t.host.hits, t.host.misses,
                    t.evicted, t.inserted))
    return log


@pytest.mark.parametrize("seed", range(3))
def test_prefix_cache_and_host_tier_match_jax(seed):
    got, want = _trie_walk(M, seed), _trie_walk(JM, seed)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"entry {i}"
    # the walk exercised sharing, eviction, spills and LRU drops
    final = got[-1]
    assert final[5] > 0 and final[6] > 0
    assert any(e[0] == "admit" and e[1] for e in got
               if isinstance(e[0], str))


def test_chain_hashes_and_extra_match_jax():
    toks = np.arange(24, dtype=np.int32) * 7
    salt = ("gpt2-xl", 32, 32, True, 32, 32, 16)
    t = M.PrefixCache(M.PageAllocator(4, 4, 1, 8), salt=salt)
    jt = JM.PrefixCache(JM.PageAllocator(4, 4, 1, 8), salt=salt)
    assert t.chain_hashes(toks, 6) == jt.chain_hashes(toks, 6)
    assert t.chain_hashes(toks, 6, extra=(3,)) == \
        jt.chain_hashes(toks, 6, extra=(3,))
    assert t.chain_hashes(toks, 6) == t.chain_hashes(toks, 6, extra=())
    assert t.chain_hashes(toks, 6) != t.chain_hashes(toks, 6, extra=(3,))


# ---------------------------------------------------------------------------
# engines in lockstep with the reference engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    """{prune ratio: (jax params, jax cfg, port params, port cfg)} on
    the same weights; 0.5 is decomposed and pruned on each side."""
    jcfg = jax_config("gpt2-xl").reduced()
    cfg = get_config("gpt2-xl").reduced()
    jp = jax_init(jcfg, jax.random.PRNGKey(3))
    tp = from_numpy(jax.tree.map(np.asarray, jp), CPU)
    jd, jdc, _ = jax_decompose(jp, jcfg, peft=False)
    jpp, jpc = jax_prune(jd, jdc, qk_ratio=0.5, vo_ratio=0.5)
    td, tdc, _ = clover_decompose(tp, cfg)
    tpp, tpc = clover_prune(td, tdc, qk_ratio=0.5, vo_ratio=0.5)
    return {0.0: (jp, jcfg, tp, cfg), 0.5: (jpp, jpc, tpp, tpc)}


def _toks(rng, n):
    return rng.integers(0, 512, n).astype(np.int32)


def _check_same(jeng, teng, where):
    teng.alloc.assert_consistent(teng.prefix, context=where)
    jeng.alloc.assert_consistent(jeng.prefix, context=where)
    assert teng.alloc.tables == jeng.alloc.tables, where
    assert teng.alloc.free_list == jeng.alloc.free_list, where
    assert teng.alloc.refcount == jeng.alloc.refcount, where
    assert teng.prefix.pages() == jeng.prefix.pages(), where
    assert teng.prefix.nodes == jeng.prefix.nodes, where


def _drain(jeng, teng, prompts, max_new, uid0, on_step=None):
    """Submit one burst to both engines and step them together until
    both are idle, checking allocator and trie state after every step."""
    jreqs = [JS.Request(uid=uid0 + i, prompt=p, max_new_tokens=max_new)
             for i, p in enumerate(prompts)]
    treqs = [S.Request(uid=uid0 + i, prompt=p, max_new_tokens=max_new)
             for i, p in enumerate(prompts)]
    for j, t in zip(jreqs, treqs):
        jeng.submit(j)
        teng.submit(t)
    steps = 0
    while jeng.sched.busy or teng.sched.busy:
        jeng.step()
        teng.step()
        steps += 1
        assert steps < 400
        _check_same(jeng, teng, f"uid {uid0} step {steps}")
        if on_step is not None:
            on_step()
    assert all(r.done for r in treqs)
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    assert [r.cached_tokens for r in treqs] == \
        [r.cached_tokens for r in jreqs]
    assert teng.steps == jeng.steps
    return treqs


@pytest.mark.parametrize("prune", [0.0, 0.5])
def test_prefix_engine_matches_jax_engine(models, prune):
    """Shared-prefix trace with a page-aligned full hit (copy-on-write
    of the last shared page) on an undersized pool (preemption, then
    re-admission from the sequence's own published pages)."""
    jp, jcfg, tp, cfg = models[prune]
    kw = dict(slots=3, max_len=48, prefill_chunk=8, paged=True,
              page_tokens=4, n_pages=16, prefix_cache=True)
    jeng = JS.Engine(jp, jcfg, JS.EngineConfig(**kw))
    teng = S.Engine(tp, cfg, S.EngineConfig(**kw), device=CPU)
    assert teng.prefix._root == jeng.prefix._root
    rng = np.random.default_rng(5)
    sys_p = _toks(rng, 12)                      # 3 full pages
    assert teng.prefix.chain_hashes(sys_p, 3) == \
        jeng.prefix.chain_hashes(sys_p, 3)
    _drain(jeng, teng, [sys_p], 6, 0)           # publish the prefix
    burst = [np.concatenate([sys_p, _toks(rng, n)]) for n in (9, 13, 5)]
    burst += [sys_p.copy(), _toks(rng, 19), _toks(rng, 25)]
    reqs = _drain(jeng, teng, burst, 8, 10)
    assert teng.sched.preemptions == jeng.sched.preemptions > 0
    assert teng.sched.prefix_hits == jeng.sched.prefix_hits >= 4
    assert reqs[3].cached_tokens == 11          # full hit resumes at L-1
    # the last prompt is unique: it was preempted and re-admitted, and
    # its hit can only come from the pages it published itself
    assert reqs[5].cached_tokens > 0
    assert teng.compiled_shapes() == jeng.compiled_shapes() == 3
    assert teng.stats()["prefix_hit_tokens"] == \
        jeng.stats()["prefix_hit_tokens"]
    for r, p in zip(reqs[:4], burst):
        assert r.generated == S.greedy_reference(tp, cfg, p, 8, device=CPU)


def test_host_tier_engine_matches_jax_engine(models):
    """Seed, burst, churn, burst: the churn overflows the pool, the trie
    spills the idle system-prompt pages to the host tier, and the second
    burst restores them.  Spills, restores and streams match the
    reference engine; every restored page holds exactly the bytes it
    had before eviction."""
    jp, jcfg, tp, cfg = models[0.5]
    kw = dict(slots=2, max_len=48, prefill_chunk=8, paged=True,
              page_tokens=4, n_pages=14, prefix_cache=True, host_pages=56)
    jeng = JS.Engine(jp, jcfg, JS.EngineConfig(**kw))
    teng = S.Engine(tp, cfg, S.EngineConfig(**kw), device=CPU)
    rng = np.random.default_rng(7)
    sys_p = _toks(rng, 16)                      # 4 full pages
    # the system prompt alone is a page-aligned full hit: copy-on-write
    burst = [np.concatenate([sys_p, _toks(rng, n)]) for n in (3, 6)]
    burst.append(sys_p.copy())
    _drain(jeng, teng, [sys_p], 4, 0)
    _drain(jeng, teng, burst, 4, 10)
    # probe both tries alike: a match is an LRU touch
    hit = teng.prefix.match(sys_p)
    assert hit == jeng.prefix.match(sys_p) and len(hit) == 4
    before = [teng.exe.read_page(teng.state, p) for p in hit]
    _drain(jeng, teng, [_toks(rng, 30) for _ in range(4)], 6, 20)
    assert teng.prefix.match(sys_p) == jeng.prefix.match(sys_p) == []
    assert teng.host.spills == jeng.host.spills >= 4

    restored = []
    real_restore = teng.exe.page_restore

    def checked_restore(state, rows, dst):
        state = real_restore(state, rows, dst)
        for i, p in enumerate(dst):
            if p != teng.alloc.sentinel:
                got = teng.exe.read_page(state, int(p))
                for leaf_rows, leaf_got in zip(rows, got):
                    np.testing.assert_array_equal(leaf_rows[:, i], leaf_got)
                restored.append(int(p))
        return state

    teng.exe.page_restore = checked_restore
    reqs = _drain(jeng, teng, burst, 4, 30)
    assert teng.host.restores == jeng.host.restores >= 4
    assert teng.host.dropped == jeng.host.dropped
    assert restored
    hit = teng.prefix.match(sys_p)
    assert hit == jeng.prefix.match(sys_p) and len(hit) == 4
    after = [teng.exe.read_page(teng.state, p) for p in hit]
    for old, new in zip(before, after):
        for a, b in zip(old, new):
            np.testing.assert_array_equal(a, b)
    assert teng.compiled_shapes() == jeng.compiled_shapes() == 4
    st, jst = teng.stats(), jeng.stats()
    for key in ("host_spills", "host_restores", "host_dropped",
                "host_hit_rate", "host_pages_used", "prefix_hits"):
        assert st[key] == jst[key], key
    assert st["counters"]["host_restored_pages"] == \
        jst["counters"]["host_restored_pages"]
    for r, p in zip(reqs, burst):
        assert r.generated == S.greedy_reference(tp, cfg, p, 4, device=CPU)


def test_executor_refuses_page_ids_outside_the_pool(models):
    _, _, tp, cfg = models[0.0]
    eng = S.Engine(tp, cfg, S.EngineConfig(slots=1, max_len=16, paged=True,
                                           page_tokens=4, n_pages=4,
                                           prefix_cache=True), device=CPU)
    with pytest.raises(ValueError, match="outside"):
        eng.exe.page_copy(eng.state, np.asarray([0]), np.asarray([5]))
    with pytest.raises(ValueError, match="outside"):
        eng.exe.page_restore(eng.state, [], np.asarray([-1]))
