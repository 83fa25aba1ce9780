"""The port's serving engine against the JAX package's, on the same
weights (numpy-bridged) at a reduced gpt2-xl: dense and paged engines
stepped in lockstep must emit token-identical greedy streams, keep
identical page-allocator histories (with ``assert_consistent`` holding
every step) and run exactly two step shapes; both must equal the port's
``greedy_reference``."""
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
from repro_torch import serve as S  # noqa: E402
from repro_torch.bridge import from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.decompose import clover_decompose  # noqa: E402
from repro_torch.core.prune import clover_prune  # noqa: E402
from repro_torch.serve.executor import LocalExecutor  # noqa: E402

CPU = "cpu"


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


def _prompts(lens, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, n).astype(np.int32) for n in lens]


def _lockstep(jeng, teng, prompts, max_new):
    """Step both engines together over the same trace; compare the
    allocator state after every step."""
    jreqs = [JS.Request(uid=i, prompt=p, max_new_tokens=max_new)
             for i, p in enumerate(prompts)]
    treqs = [S.Request(uid=i, prompt=p, max_new_tokens=max_new)
             for i, p in enumerate(prompts)]
    for r in jreqs:
        jeng.submit(r)
    for r in treqs:
        teng.submit(r)
    steps = 0
    while jeng.sched.busy or teng.sched.busy:
        jeng.step()
        teng.step()
        steps += 1
        assert steps < 500
        if teng.alloc is not None:
            teng.alloc.assert_consistent(context=f"step {steps}")
            assert teng.alloc.tables == jeng.alloc.tables, steps
            assert teng.alloc.free_list == jeng.alloc.free_list, steps
            assert teng.alloc.refcount == jeng.alloc.refcount, steps
    assert all(r.done for r in treqs)
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    assert teng.steps == jeng.steps
    return treqs


@pytest.mark.parametrize("layout,prune", [
    ("dense", 0.0), ("dense", 0.5), ("paged", 0.0), ("paged", 0.5)])
def test_engine_matches_jax_engine_and_reference(models, layout, prune):
    jp, jcfg, tp, cfg = models[prune]
    kw = dict(slots=3, max_len=48, prefill_chunk=8)
    if layout == "paged":
        kw.update(paged=True, page_tokens=4, n_pages=14)   # preempts
    jeng = JS.Engine(jp, jcfg, JS.EngineConfig(**kw))
    teng = S.Engine(tp, cfg, S.EngineConfig(**kw), device=CPU)
    prompts = _prompts((3, 17, 9, 30, 5, 12))
    reqs = _lockstep(jeng, teng, prompts, max_new=6)
    assert teng.compiled_shapes() == 2
    assert jeng.compiled_shapes() == 2
    if layout == "paged":
        assert teng.sched.preemptions == jeng.sched.preemptions > 0
        assert teng.alloc.used_pages() == 0
        if prune:
            # the pools really hold K/V at the pruned rank
            assert teng.state["blocks"][0]["kv"]["k"].shape[-1] == 16
    for r, p in zip(reqs, prompts):
        assert r.generated == S.greedy_reference(tp, cfg, p, 6, device=CPU)


def test_engine_matches_jax_interpret_kernels(models):
    """One small trace against the JAX engine running its Pallas decode
    kernel in interpret mode (paged, undersized pool)."""
    jp, jcfg, tp, cfg = models[0.5]
    kw = dict(slots=2, max_len=24, prefill_chunk=4, paged=True,
              page_tokens=4, n_pages=6)
    jeng = JS.Engine(jp, jcfg, JS.EngineConfig(kernel_impl="interpret",
                                               **kw))
    teng = S.Engine(tp, cfg, S.EngineConfig(**kw), device=CPU)
    _lockstep(jeng, teng, _prompts((6, 11, 3), seed=2), max_new=4)
    assert teng.compiled_shapes() == 2


def test_compiled_shapes_stay_two_for_any_length_mix(models):
    jp, jcfg, tp, cfg = models[0.0]
    for lens in ((1, 2, 3), (8, 16, 24, 9, 40)):
        eng = S.Engine(tp, cfg, S.EngineConfig(slots=2, max_len=48,
                                               prefill_chunk=8), device=CPU)
        eng.run([S.Request(uid=i, prompt=p, max_new_tokens=3)
                 for i, p in enumerate(_prompts(lens))])
        assert eng.compiled_shapes() == 2


def test_chunk_step_leaves_idle_rows_unchanged(models):
    """A chunk step must leave rows with lengths == 0 as they were:
    their index and every cache position they can read."""
    _, _, tp, cfg = models[0.0]
    exe = LocalExecutor(tp, cfg, S.EngineConfig(slots=2, max_len=32,
                                                prefill_chunk=8),
                        torch.device(CPU))
    st = exe.init_state()
    toks = _prompts((8, 8), seed=4)
    _, st = exe.prefill_chunk(st, np.stack(toks), np.asarray([8, 5]),
                              np.asarray([True, True]), np.zeros(2),
                              None, None)
    before = [leaf.clone() for e in st["blocks"] for leaf in e["kv"].values()]
    _, st = exe.prefill_chunk(st, np.stack(toks), np.asarray([8, 0]),
                              np.asarray([False, False]), np.zeros(2),
                              None, None)
    np.testing.assert_array_equal(st["index"].numpy(), [16, 5])
    after = [leaf for e in st["blocks"] for leaf in e["kv"].values()]
    for a, b in zip(after, before):
        assert torch.equal(a[:, 1, :5], b[:, 1, :5])


def test_temperature_sampling_is_seeded(models):
    """temperature > 0 samples from the softmax with the engine's seeded
    generator: the same seed replays the same streams."""
    _, _, tp, cfg = models[0.0]

    def run(seed):
        eng = S.Engine(tp, cfg, S.EngineConfig(slots=2, max_len=32,
                                               prefill_chunk=8),
                       device=CPU, seed=seed)
        reqs = [S.Request(uid=i, prompt=p, max_new_tokens=5,
                          temperature=1.0)
                for i, p in enumerate(_prompts((4, 9)))]
        eng.run(reqs)
        return eng, [r.generated for r in reqs]

    eng, first = run(0)
    assert run(0)[1] == first
    assert all(0 <= t < cfg.vocab_size for g in first for t in g)
    stats = eng.stats()
    assert stats["counters"]["done"] == 2 and stats["steps"] == eng.steps


def test_engine_config_refuses_unported_features():
    # tensor parallelism is ported: any degree >= 1 builds, below raises
    assert S.EngineConfig(tp=2).tp == 2
    with pytest.raises(ValueError, match="tp=0"):
        S.EngineConfig(tp=0)
    # speculation is ported: spec_k builds and sizes like the reference
    ecfg = S.EngineConfig(spec_k=2, max_len=100, prefill_chunk=1)
    jcfg = JS.EngineConfig(spec_k=2, max_len=100, prefill_chunk=1)
    assert (ecfg.spec_window, ecfg.capacity) == \
        (jcfg.spec_window, jcfg.capacity)
    # rank budgets are ported: anything but the port's RankBudget raises
    with pytest.raises(TypeError, match="RankBudget"):
        S.EngineConfig(rank_budget=object())
    # the ported features' guards, as the reference's
    for kw, match in ((dict(prefix_cache=True), "paged"),
                      (dict(paged=True, host_pages=4), "prefix_cache"),
                      (dict(paged=True, prefix_cache=True, host_pages=-1),
                       ">= 0")):
        with pytest.raises(ValueError, match=match):
            S.EngineConfig(**kw)
    S.EngineConfig(paged=True, prefix_cache=True, host_pages=4)
    ecfg = S.EngineConfig(max_len=100, prefill_chunk=64)
    jcfg = JS.EngineConfig(max_len=100, prefill_chunk=64)
    assert (ecfg.capacity, ecfg.table_pages, ecfg.pool_pages) == \
        (jcfg.capacity, jcfg.table_pages, jcfg.pool_pages)


def test_engine_capacity_guard(models):
    _, _, tp, cfg = models[0.0]
    eng = S.Engine(tp, cfg, S.EngineConfig(slots=1, max_len=8), device=CPU)
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(S.Request(uid=0, prompt=np.arange(6, dtype=np.int32),
                             max_new_tokens=6))
    eng = S.Engine(tp, cfg, S.EngineConfig(slots=1, max_len=32, paged=True,
                                           page_tokens=4, n_pages=2),
                   device=CPU)
    with pytest.raises(ValueError, match="pages"):
        eng.submit(S.Request(uid=0, prompt=np.arange(6, dtype=np.int32),
                             max_new_tokens=6))
