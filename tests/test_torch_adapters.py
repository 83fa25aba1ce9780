"""Multi-tenant SV adapters in the port against the JAX package
(DESIGN.md §13), on the same (numpy-bridged) weights at reduced size:
``sv_extract`` / ``sv_fold`` on gpt2-xl ("cross"), stablelm-3b
("partial") and phi3-medium-14b ("intra") peft trees, the
``AdapterRegistry`` contract and its bank, ``attention(adapter=...)`` on
every path, and adapter engines in lockstep with the JAX engine under
one registry (the identity and two tenants, serve_bench scenario 8 in
small).

Tolerances: extraction, folding and the bank are bit for bit; the
attention paths within 1e-5 of the largest |value| (float32 matmuls
summed in another order); engines step for step identical (phases,
positions, page tables, streams).
"""
import dataclasses

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
from repro.core import AdapterRegistry as JRegistry  # noqa: E402
from repro.core import clover_decompose as jax_decompose  # noqa: E402
from repro.core import sv_extract as jax_sv_extract  # noqa: E402
from repro.core import sv_fold as jax_sv_fold  # noqa: E402
from repro.models import init_lm_params as jax_init  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch import serve as S  # noqa: E402
from repro_torch.bridge import from_numpy, to_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (SV_ADAPTER_KEYS, AdapterRegistry,  # noqa: E402
                              sv_extract, sv_fold)
from repro_torch.core.decompose import clover_decompose  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve.executor import _select_adapters  # noqa: E402
from repro_torch.tree import tree_leaves_with_path  # noqa: E402

CPU = "cpu"
RTOL = 1e-5
NAMES = ("gpt2-xl", "stablelm-3b", "phi3-medium-14b")
MODE = {"gpt2-xl": "cross", "stablelm-3b": "partial",
        "phi3-medium-14b": "intra"}


def _peft_pair(name, seed):
    """The reference's ``clover_decompose(peft=True)`` of seeded weights
    and the same tree bridged to the port (with the port's cfg from its
    own decompose, which must equal the reference's), plus the raw
    weights in the port and the port's own peft tree of them."""
    jcfg = jax_config(name).reduced()
    cfg = get_config(name).reduced()
    jp = jax_init(jcfg, jax.random.PRNGKey(seed))
    jd, jdc, _ = jax_decompose(jp, jcfg, peft=True)
    tp = from_numpy(jax.tree.map(np.asarray, jp), CPU)
    own, tdc, _ = clover_decompose(tp, cfg, peft=True)
    assert dataclasses.asdict(tdc) == dataclasses.asdict(jdc)
    td = from_numpy(jax.tree.map(np.asarray, jd), CPU)
    return jd, jdc, td, tdc, tp, own


@pytest.fixture(scope="module")
def models():
    return {name: _peft_pair(name, i + 11) for i, name in enumerate(NAMES)}


def _bitwise(a, b):
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    b = b.numpy() if torch.is_tensor(b) else np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _trees_bitwise(got, want):
    g = dict(tree_leaves_with_path(got))
    w = dict(tree_leaves_with_path(want))
    assert g.keys() == w.keys()
    for path in g:
        if g[path] is None:
            assert w[path] is None, path
        else:
            assert torch.equal(g[path], w[path]), path


def _rel_close(got, want, rtol=RTOL):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.max(np.abs(got.astype(np.float64) - want)))
    assert err <= rtol * max(float(np.max(np.abs(want))), 1e-30), err


def _uniform_scales(template, rng, lo=0.8, hi=1.25):
    """One numpy float32 scale tree shaped like ``template``."""
    return tuple({k: rng.uniform(lo, hi, tuple(v.shape)).astype(np.float32)
                  for k, v in entry.items()} for entry in template)


# ---------------------------------------------------------------------------
# sv_extract / sv_fold
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_sv_extract_and_fold_match_jax(models, name):
    jd, _, td, _, _, own = models[name]
    got, want = sv_extract(td), jax_sv_extract(jd)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)                 # absent keys match
        for k in g:
            _bitwise(g[k], w[k])
    # intra mode has no Q-K transition; every mode has V-O
    keys = set().union(*got)
    assert ("s_qk_diag" in keys) == (MODE[name] != "intra")
    assert "s_vo_diag" in keys
    # the exact inverse, on the bridged tree and on the port's own
    # decomposition (partial-RoPE identity block, k_t, up_t untouched)
    _trees_bitwise(sv_fold(td, sv_extract(td)), td)
    _trees_bitwise(sv_fold(own, sv_extract(own)), own)
    # folding new diagonals: bit for bit the reference's fold
    new = _uniform_scales(got, np.random.default_rng(5), 0.5, 2.0)
    folded = sv_fold(td, new)
    jfolded = jax_sv_fold(jd, tuple({k: jnp.asarray(v) for k, v in e.items()}
                                    for e in new))
    g = dict(tree_leaves_with_path(to_numpy(folded)))
    for path, leaf in tree_leaves_with_path(
            jax.tree.map(np.asarray, jfolded)):
        _bitwise(g[path], leaf)
    # only the diagonals moved
    for src, _ in SV_ADAPTER_KEYS:
        if src not in td["blocks"][0]["attn"]:
            continue
        a, b = folded["blocks"][0]["attn"][src], td["blocks"][0]["attn"][src]
        off = ~torch.eye(a.shape[-1], dtype=torch.bool)
        assert torch.equal(a[..., off], b[..., off])
    for key in ("k_t", "up_t", "wq", "wo"):
        for j, stacked in enumerate(td["blocks"]):
            for sub in ("attn", "mlp"):
                if key in stacked.get(sub, {}):
                    assert folded["blocks"][j][sub][key] is stacked[sub][key]


# ---------------------------------------------------------------------------
# AdapterRegistry
# ---------------------------------------------------------------------------

def test_registry_identity_and_validation(models):
    _, _, td, _, tp, _ = models["gpt2-xl"]
    reg = AdapterRegistry(td)
    assert len(reg) == 1 and reg.n_adapters == 1
    for entry in reg.get(0):
        for v in entry.values():
            assert v.dtype == torch.float32 and torch.all(v == 1)
    # id 0 folds back to the base model bit for bit (x * 1.0 == x)
    _trees_bitwise(reg.folded(td, 0), td)
    with pytest.raises(ValueError, match="keys"):
        reg.register(tuple({} for _ in reg.get(0)))
    with pytest.raises(ValueError, match="positions"):
        reg.register(reg.get(0) + reg.get(0))
    with pytest.raises(ValueError, match="shape"):
        reg.register(tuple({k: v[..., :1] for k, v in e.items()}
                           for e in reg.get(0)))
    with pytest.raises(ValueError, match="identity"):
        reg.update(0, reg.get(0))
    # undecomposed params have no transitions: refused, as the reference
    with pytest.raises(ValueError, match="peft"):
        AdapterRegistry(tp)
    with pytest.raises(ValueError):
        JRegistry(jax.tree.map(jnp.asarray, to_numpy(tp)))
    assert len(reg) == 1 and reg.generation == 0


def test_registry_scales_versions_fold_and_bank_match_jax(models):
    jd, _, td, _, _, _ = models["stablelm-3b"]
    # a pruned (zero) base entry: its scale stays 1
    attn = dict(td["blocks"][0]["attn"])
    attn["s_vo"] = attn["s_vo"].clone()
    attn["s_vo"][0, 1, 2, 2] = 0.0
    td = dict(td, blocks=({**td["blocks"][0], "attn": attn},))
    jattn = dict(jd["blocks"][0]["attn"])
    jattn["s_vo"] = jattn["s_vo"].at[0, 1, 2, 2].set(0.0)
    jd = dict(jd, blocks=({**jd["blocks"][0], "attn": jattn},))
    reg, jreg = AdapterRegistry(td), JRegistry(jd)

    rng = np.random.default_rng(7)
    tuned = _uniform_scales(sv_extract(td), rng, 0.5, 2.0)
    tuned[0]["s_vo_diag"][0, 1, 2] = 5.0
    got = reg.scales_from_finetuned(tuned)
    want = jreg.scales_from_finetuned(tuple(
        {k: jnp.asarray(v) for k, v in e.items()} for e in tuned))
    for g, w in zip(got, want):
        for k in g:
            _bitwise(g[k], w[k])
    assert float(got[0]["s_vo_diag"][0, 1, 2]) == 1.0
    # an all-equal fine-tune is the identity
    for e in reg.scales_from_finetuned(sv_extract(td)):
        for v in e.values():
            assert torch.all(v == 1)

    scales = [got, _uniform_scales(sv_extract(td), rng)]
    for sc in scales:
        aid = reg.register(sc)
        assert aid == jreg.register(tuple(
            {k: jnp.asarray(np.asarray(v)) for k, v in e.items()}
            for e in sc))
    assert len(reg) == len(jreg) == 3 and reg.generation == 2
    assert reg.version(1) == 0
    assert reg.update(1, scales[1]) == 1 and reg.generation == 3
    jreg.update(1, tuple({k: jnp.asarray(v) for k, v in e.items()}
                         for e in scales[1]))
    assert reg.version(1) == jreg.version(1) == 1
    for aid in range(len(reg)):
        g = dict(tree_leaves_with_path(to_numpy(reg.folded(td, aid))))
        for path, leaf in tree_leaves_with_path(
                jax.tree.map(np.asarray, jreg.folded(jd, aid))):
            _bitwise(g[path], leaf)
    bank, jbank = reg.bank(), jreg.bank()
    assert len(bank) == len(jbank)
    for b, jb in zip(bank, jbank):
        assert (b is None) == (jb is None)
        if b is not None:
            assert set(b) == set(jb) == {"a_qk", "a_vo"}
            for k in b:
                assert b[k].shape[1] == len(reg)
                _bitwise(b[k], jb[k])
    # the executor's gather: (nb, A, H, d) -> (nb, B, H, d) by id
    ids = torch.tensor([2, 0, 1, 2])
    sel = _select_adapters(bank, ids)
    for b, s in zip(bank, sel):
        for k in b:
            for row, aid in enumerate(ids.tolist()):
                assert torch.equal(s[k][:, row], b[k][:, aid])


# ---------------------------------------------------------------------------
# attention(adapter=...) on every path
# ---------------------------------------------------------------------------

def _layer0(tree):
    return {k: v[0] for k, v in tree["blocks"][0]["attn"].items()}


@pytest.mark.parametrize("path", ["full", "dense", "chunk", "paged",
                                  "draft", "paged_draft"])
@pytest.mark.parametrize("name", ["gpt2-xl", "stablelm-3b"])
def test_attention_adapter_matches_jax(models, name, path):
    jd, jdc, td, tdc, _, _ = models[name]
    jattn = {k: v[0] for k, v in jd["blocks"][0]["attn"].items()}
    tattn = _layer0(td)
    rng = np.random.default_rng(17)
    B, H, KV, D = 3, tdc.n_heads, tdc.n_kv_heads, tdc.d_model
    dq, dv = tdc.qk_dim, tdc.vo_dim
    S = {"full": 6, "chunk": 4}.get(path, 1)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    adapter = {"a_qk": rng.uniform(0.6, 1.5, (B, H, dq)).astype(np.float32),
               "a_vo": rng.uniform(0.6, 1.5, (B, H, dv)).astype(np.float32)}
    kw, jkw = {}, {}
    if path.endswith("draft"):
        kw["draft_rank"] = jkw["draft_rank"] = (dq // 2, dv // 2)
    index = np.asarray([5, 0, 9], np.int32)
    positions = (index[:, None] + np.arange(S)[None]).astype(np.int32)
    if path == "full":
        positions = np.broadcast_to(np.arange(S, dtype=np.int32),
                                    (B, S)).copy()
    elif path.startswith("paged"):
        N, pt, n_p = 16, 4, 4
        cache = {"k": rng.standard_normal((N, pt, KV, dq)).astype(
                     np.float32),
                 "v": rng.standard_normal((N, pt, KV, dv)).astype(
                     np.float32)}
        table = np.asarray([[3, 7, 1, 0], [2, 9, 4, 5], [11, 6, 8, 12]],
                           np.int32)
        kw.update(page_table=torch.from_numpy(table))
        jkw.update(page_table=jnp.asarray(table))
    else:
        cache = {"k": rng.standard_normal((B, 16, KV, dq)).astype(np.float32),
                 "v": rng.standard_normal((B, 16, KV, dv)).astype(np.float32)}
    if path != "full":
        kw.update(kv_cache={k: torch.from_numpy(v.copy())
                            for k, v in cache.items()},
                  cache_index=torch.from_numpy(index))
        jkw.update(kv_cache={k: jnp.asarray(v) for k, v in cache.items()},
                   cache_index=jnp.asarray(index))
    got, gcache = L.attention(
        tattn, tdc, torch.from_numpy(x), positions=torch.from_numpy(positions),
        adapter={k: torch.from_numpy(v) for k, v in adapter.items()}, **kw)
    want, wcache = JL.attention(
        jattn, jdc, jnp.asarray(x), positions=jnp.asarray(positions),
        attn_impl="xla", adapter={k: jnp.asarray(v)
                                  for k, v in adapter.items()}, **jkw)
    _rel_close(got, want)
    if path != "full":
        for k in ("k", "v"):
            _rel_close(gcache[k], wcache[k])
    # the scales are live on this path: without them the output moves
    if path != "full":
        kw["kv_cache"] = {k: torch.from_numpy(v.copy())
                          for k, v in cache.items()}
    base, _ = L.attention(tattn, tdc, torch.from_numpy(x),
                          positions=torch.from_numpy(positions), **kw)
    assert not torch.allclose(base, got, atol=1e-4)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_identity_adapter_decode_step_is_bitwise(models, layout):
    """``decode_step`` with an all-ones adapter tree gives the logits and
    the caches of the call without one, bit for bit."""
    _, _, td, tdc, _, _ = models["gpt2-xl"]
    B = 3
    ones = AdapterRegistry(td).bank()
    ids = torch.zeros(B, dtype=torch.long)
    tok = torch.as_tensor(np.random.default_rng(3).integers(0, 512, (B, 6)))
    runs = []
    for adapters in (None, _select_adapters(ones, ids)):
        if layout == "paged":
            st = T.init_decode_state_paged(tdc, B, 12, 4, device=CPU)
            pages = torch.arange(12, dtype=torch.int32).reshape(B, 4)
        else:
            st = T.init_decode_state(tdc, B, 16, device=CPU)
            st["index"] = torch.zeros(B, dtype=torch.int32)
            pages = None
        _, st = T.prefill_chunk(td, tdc, tok[:, :5], st,
                                torch.full((B,), 5, dtype=torch.int32),
                                pages=pages, adapters=adapters)
        logits, st = T.decode_step(td, tdc, tok[:, 5], st, pages=pages,
                                   adapters=adapters)
        runs.append((logits, st))
    (a, sa), (b, sb) = runs
    assert torch.equal(a, b)
    for (p, x), (_, y) in zip(tree_leaves_with_path(sa),
                              tree_leaves_with_path(sb)):
        assert torch.equal(x, y), p


# ---------------------------------------------------------------------------
# engines in lockstep with the JAX engine under one registry
# ---------------------------------------------------------------------------

SYS_TOKENS = 8        # two pages of 4: the tenants' shared system prompt
WAVES = 2
WAVE_GAP = 14
MAX_NEW = 5


def _registries(jd, td, n_tenants=2, seed=9):
    reg, jreg = AdapterRegistry(td), JRegistry(jd)
    rng = np.random.default_rng(seed)
    for _ in range(n_tenants):
        sc = _uniform_scales(reg.get(0), rng)
        reg.register(sc)
        jreg.register(tuple({k: jnp.asarray(v) for k, v in e.items()}
                            for e in sc))
    return reg, jreg


def _trace(n_adapters, vocab=512):
    """Scenario 8 in small: WAVES waves of one request per tenant, a
    shared page-aligned system prompt with tails of 3 + aid tokens."""
    sys_prompt = ((np.arange(SYS_TOKENS) * 5 + 2) % vocab).astype(np.int32)
    specs, arrivals = [], {}
    for wave in range(WAVES):
        for aid in range(n_adapters):
            uid = wave * n_adapters + aid
            tail = ((np.arange(3 + aid) + 7 * (uid + 1)) % vocab).astype(
                np.int32)
            specs.append((uid, aid, np.concatenate([sys_prompt, tail])))
            arrivals[uid] = wave * WAVE_GAP
    return sys_prompt, specs, arrivals


def _run_trace(eng, specs, arrivals, jeng=None, with_ids=True):
    """Submit at the arrival steps and step to the end; with ``jeng``,
    the JAX engine takes the same trace and both are compared after
    every step.  -> the port's requests by uid."""
    reqs, jreqs = {}, {}
    step = 0
    while True:
        for uid, aid, prompt in specs:
            if arrivals[uid] == step:
                kw = dict(uid=uid, prompt=prompt, max_new_tokens=MAX_NEW,
                          adapter_id=aid if with_ids else 0)
                reqs[uid] = S.Request(**kw)
                eng.submit(reqs[uid])
                if jeng is not None:
                    jreqs[uid] = JS.Request(**kw)
                    jeng.submit(jreqs[uid])
        pending = step < max(arrivals.values())
        if not (pending or eng.sched.busy
                or (jeng is not None and jeng.sched.busy)):
            break
        eng.step()
        if jeng is not None:
            jeng.step()
            assert list(eng.sched.phase) == list(jeng.sched.phase), step
            np.testing.assert_array_equal(eng.state["index"].numpy(),
                                          np.asarray(jeng.state["index"]))
            assert eng.spec_rounds == jeng.spec_rounds, step
            np.testing.assert_array_equal(eng._slot_aids(),
                                          jeng._slot_aids())
            if eng.alloc is not None:
                eng.alloc.assert_consistent(eng.prefix,
                                            context=f"step {step}")
                assert eng.alloc.tables == jeng.alloc.tables, step
                assert eng.alloc.free_list == jeng.alloc.free_list, step
                assert eng.alloc.refcount == jeng.alloc.refcount, step
            assert ({u: r.generated for u, r in reqs.items()}
                    == {u: r.generated for u, r in jreqs.items()}), step
        step += 1
        assert step < 200
    if jeng is not None:
        assert eng.stats()["adapter_tokens"] == jeng.stats()[
            "adapter_tokens"]
        assert eng.stats()["adapter_done"] == jeng.stats()["adapter_done"]
        assert ([r.cached_tokens for r in reqs.values()]
                == [r.cached_tokens for r in jreqs.values()])
    return reqs


LAYOUTS = {
    "dense": dict(slots=3, max_len=32, prefill_chunk=4),
    "paged": dict(slots=3, max_len=32, prefill_chunk=4, paged=True,
                  page_tokens=4, n_pages=24),
    "prefix": dict(slots=3, max_len=32, prefill_chunk=4, paged=True,
                   page_tokens=4, n_pages=24, prefix_cache=True),
}


@pytest.fixture(scope="module")
def served(models):
    jd, jdc, td, tdc, _, _ = models["gpt2-xl"]
    reg, jreg = _registries(jd, td)
    sys_prompt, specs, arrivals = _trace(len(reg))
    # single-tenant replay oracles: tenant 0 on the base params, the
    # others on their folded params, one tenant per engine
    refs = {}
    for aid in range(len(reg)):
        p = td if aid == 0 else reg.folded(td, aid)
        eng = S.Engine(p, tdc, S.EngineConfig(**LAYOUTS["dense"]),
                       device=CPU)
        rs = [S.Request(uid=u, prompt=pr, max_new_tokens=MAX_NEW)
              for u, a, pr in specs if a == aid]
        eng.run(rs)
        refs.update({r.uid: r.generated for r in rs})
    return jd, jdc, td, tdc, reg, jreg, sys_prompt, specs, arrivals, refs


@pytest.mark.parametrize("layout,k", [("dense", 0), ("paged", 0),
                                      ("dense", 2), ("prefix", 2)])
def test_adapter_engine_lockstep_with_jax(served, layout, k):
    jd, jdc, td, tdc, reg, jreg, sys_prompt, specs, arrivals, refs = served
    kw = dict(LAYOUTS[layout], spec_k=k, draft_rank_ratio=0.5)
    eng = S.Engine(td, tdc, S.EngineConfig(**kw), device=CPU, adapters=reg)
    jeng = JS.Engine(jd, jdc, JS.EngineConfig(kernel_impl="xla", **kw),
                     adapters=jreg)
    reqs = _run_trace(eng, specs, arrivals, jeng)
    # every stream is its own tenant's single-tenant replay
    for uid, r in reqs.items():
        assert r.done and r.generated == refs[uid], uid
    assert len({tuple(refs[u]) for u in refs}) > 1    # tenants differ
    st = eng.stats()
    n = len(reg)
    assert st["adapter_done"] == {a: WAVES for a in range(n)}
    assert st["adapter_tokens"] == {a: WAVES * MAX_NEW for a in range(n)}
    assert eng.compiled_shapes() == jeng.compiled_shapes()
    if k:
        assert eng.spec_rounds > 0
    if layout == "prefix":
        # each tenant cached the same system prompt under its own key:
        # non-empty, pairwise-disjoint page sets, tenant 0 in the plain
        # namespace; every later-wave request hit its own tenant's pages
        psets = [set(eng.prefix.match(sys_prompt, extra=(a,) if a else ()))
                 for a in range(n)]
        jsets = [set(jeng.prefix.match(sys_prompt,
                                       extra=(a,) if a else ()))
                 for a in range(n)]
        assert psets == jsets
        assert all(psets)
        assert all(psets[i].isdisjoint(psets[j]) for i in range(n)
                   for j in range(i + 1, n))
        assert all(r.cached_tokens > 0 for u, r in reqs.items()
                   if arrivals[u] > 0)
    else:
        # the same trace without a registry runs the same step shapes:
        # the bank gather is data, not shape
        plain = S.Engine(td, tdc, S.EngineConfig(**kw), device=CPU)
        _run_trace(plain, specs, arrivals, with_ids=False)
        assert eng.compiled_shapes() == plain.compiled_shapes()


@pytest.mark.parametrize("layout", ["dense", "prefix"])
def test_identity_traffic_is_bitwise_the_plain_engine(served, layout):
    """Adapter-0 traffic on a registry engine: the streams, the shapes
    and the final KV state of an engine without a registry, bit for
    bit; stats carry the per-adapter counters only with a registry."""
    _, _, td, tdc, reg, _, _, specs, arrivals, _ = served
    kw = LAYOUTS[layout]
    eng = S.Engine(td, tdc, S.EngineConfig(**kw), device=CPU, adapters=reg)
    plain = S.Engine(td, tdc, S.EngineConfig(**kw), device=CPU)
    got = _run_trace(eng, specs, arrivals, with_ids=False)
    want = _run_trace(plain, specs, arrivals, with_ids=False)
    assert ({u: r.generated for u, r in got.items()}
            == {u: r.generated for u, r in want.items()})
    assert eng.compiled_shapes() == plain.compiled_shapes()
    for (p, a), (_, b) in zip(tree_leaves_with_path(eng.state),
                              tree_leaves_with_path(plain.state)):
        assert torch.equal(a, b), p
    assert eng.stats()["adapter_done"] == {0: len(specs)}
    assert "adapter_done" not in plain.stats()
    if layout == "prefix":
        assert eng.prefix.nodes.keys() == plain.prefix.nodes.keys()


def test_adapter_host_tier_keys_by_tenant(served):
    """A spilled tenant prefix restores only for its own tenant: after
    the trie is evicted through the host tier, a tenant-1 replay
    restores tenant 1's pages and a tenant-2 request with the same
    prompt restores none of them; both streams stay their replays."""
    _, _, td, tdc, reg, _, sys_prompt, _, _, _ = served
    kw = dict(LAYOUTS["prefix"], host_pages=32)
    eng = S.Engine(td, tdc, S.EngineConfig(**kw), device=CPU, adapters=reg)
    prompt = np.concatenate([sys_prompt, np.arange(4, dtype=np.int32) + 1])
    first = S.Request(uid=0, prompt=prompt, max_new_tokens=3, adapter_id=1)
    eng.run([first])
    eng.prefix.evict(len(eng.prefix))
    assert eng.host.spills > 0 and len(eng.prefix) == 0
    again = S.Request(uid=1, prompt=prompt, max_new_tokens=3, adapter_id=1)
    eng.run([again])
    restored = eng.host.restores
    assert restored > 0 and again.cached_tokens > 0
    other = S.Request(uid=2, prompt=prompt, max_new_tokens=3, adapter_id=2)
    eng.run([other])
    assert eng.host.restores == restored and other.cached_tokens == 0
    for r in (first, again):
        assert r.generated == S.greedy_reference(reg.folded(td, 1), tdc,
                                                 prompt, 3, device=CPU)
    assert other.generated == S.greedy_reference(reg.folded(td, 2), tdc,
                                                 prompt, 3, device=CPU)


def test_adapter_submit_and_constructor_validation(served):
    _, _, td, tdc, reg, _, _, _, _, _ = served
    for bad in (-1, 1.5, "1"):
        with pytest.raises(ValueError, match="adapter_id"):
            S.Request(uid=0, prompt=np.arange(3, dtype=np.int32),
                      max_new_tokens=2, adapter_id=bad)
    ecfg = S.EngineConfig(slots=1, max_len=16)
    eng = S.Engine(td, tdc, ecfg, device=CPU, adapters=reg)
    with pytest.raises(ValueError, match="adapter"):
        eng.submit(S.Request(uid=0, prompt=np.arange(3, dtype=np.int32),
                             max_new_tokens=2, adapter_id=len(reg)))
    # without a registry only the identity id is accepted
    plain = S.Engine(td, tdc, ecfg, device=CPU)
    with pytest.raises(ValueError, match="adapter"):
        plain.submit(S.Request(uid=1, prompt=np.arange(3, dtype=np.int32),
                               max_new_tokens=2, adapter_id=1))
    plain.submit(S.Request(uid=2, prompt=np.arange(3, dtype=np.int32),
                           max_new_tokens=2, adapter_id=0))
    # a tenant registered after construction is not in the engine's
    # bank: submit refuses it rather than gather past the bank
    late = AdapterRegistry(td)
    late.register(reg.get(1))
    leng = S.Engine(td, tdc, ecfg, device=CPU, adapters=late)
    late.register(reg.get(2))
    with pytest.raises(ValueError, match="bank holds 2"):
        leng.submit(S.Request(uid=3, prompt=np.arange(3, dtype=np.int32),
                              max_new_tokens=2, adapter_id=2))
    leng.submit(S.Request(uid=4, prompt=np.arange(3, dtype=np.int32),
                          max_new_tokens=2, adapter_id=1))
    # the executor's ids: None without a bank, zeros when none are given
    assert plain.exe._aids(None) is None
    assert torch.equal(eng.exe._aids(None), torch.zeros(1, dtype=torch.long))
    # a pre-built executor holds its own bank: a registry beside an
    # executor built without it raises
    with pytest.raises(ValueError, match="pre-built executor"):
        S.Engine(td, tdc, ecfg, device=CPU, adapters=reg,
                 executor=plain.exe)
    # tensor parallelism needs an initialised process group of tp ranks
    with pytest.raises(ValueError, match="process group"):
        S.Engine(td, tdc, S.EngineConfig(slots=1, max_len=16, tp=2),
                 device=CPU, adapters=reg)
