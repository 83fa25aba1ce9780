"""16- and 8-bit KV pools on every page path of the port, against the
JAX package on the same (numpy-bridged) weights at a reduced gpt2-xl.

- The plain page movers on bfloat16 and float8_e4m3fn pools against the
  reference's oracles and its Pallas kernels in interpret mode, at the
  shapes of ``test_torch_prefix.py``'s cases: exact, as bit patterns.
- The host-tier engine trace of ``test_torch_prefix.py`` (seed, a burst
  with a full hit: copy-on-write, a churn burst that spills, the burst
  again: restores) with the pool stored in those dtypes, in lockstep
  with the reference engine: allocator, trie and host counters equal
  every step, the same streams, and every spilled page's bytes equal to
  the reference executor's ``read_page`` bytes: float8 bit for bit,
  bfloat16 up to rare rounding-boundary flips (``FLIP_SHARE``).  The
  port's host tier holds a 16- or 8-bit pool's rows as uint16 / uint8
  views; the reference's as ml_dtypes arrays, compared here through the
  same views.
- A bfloat16-compute model (its cache at the compute dtype) through the
  same trace: restored pages byte-identical, streams equal to the same
  engine without a host tier.
- A float8 cache through the two paths that hand cache rows to a
  collective: the data-replica paged engine (every layer's new K/V rows
  all-gathered over "data") and the sequence-split cache's second
  prefill (the earlier windows all-gathered over "model"), each on two
  gloo ranks, streams equal to one rank's.
"""
import dataclasses

import ml_dtypes
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
from repro_torch import serve as S  # noqa: E402
from repro_torch.bridge import from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.decompose import clover_decompose  # noqa: E402
from repro_torch.core.prune import clover_prune  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels.page_copy import (POOL_DTYPES,  # noqa: E402
                                           page_copy, page_restore)
from repro_torch.launch.serve import (ServeRun, StepRun,  # noqa: E402
                                      run_steps, serve_step_ranks,
                                      serve_tp, serve_waves)
from repro_torch.tree import tree_map  # noqa: E402

CPU = "cpu"
NARROW = ("bfloat16", "float8_e4m3fn")
RANK_TIMEOUT = 240.0


def _bits(a) -> np.ndarray:
    """The bit patterns of a numpy array or a CPU tensor, as unsigned
    integers of the element's width."""
    if torch.is_tensor(a):
        a = a.contiguous()
        if a.element_size() < 4:
            a = a.view(torch.uint16 if a.element_size() == 2
                       else torch.uint8)
        a = a.numpy()
    a = np.asarray(a)
    return a.view(f"u{a.dtype.itemsize}")


def _narrow(x: np.ndarray, dtype: str) -> np.ndarray:
    """float32 ``x`` rounded to ``dtype`` (an ml_dtypes array)."""
    return np.asarray(jnp.asarray(x, jnp.float32).astype(dtype))


def _to_torch(a: np.ndarray) -> torch.Tensor:
    return from_numpy({"a": a}, CPU)["a"]


# ---------------------------------------------------------------------------
# plain movers on narrow pools vs the reference oracles and Pallas kernels
# ---------------------------------------------------------------------------

# test_torch_prefix.py's cases: (nb, N, pt, KV, r), src, dst; row N - 1
# is the sentinel.  (1, 6, 3, 1, 5) has rows of 30 bytes in bfloat16 and
# 15 in float8: the CUDA kernel's 2- and 1-byte accesses
COPY_CASES = {
    "pairs+sentinel-padding": ((3, 9, 4, 2, 16), [0, 3, 8, 8], [2, 1, 8, 8]),
    "in-order-hazard": ((2, 10, 4, 2, 8), [5, 1, 3, 9], [0, 6, 5, 9]),
    "odd-row-bytes": ((1, 6, 3, 1, 5), [0, 4, 2], [3, 1, 5]),
    "m=7": ((2, 12, 2, 3, 4), [0, 1, 2, 3, 4, 11, 11],
            [5, 6, 7, 8, 9, 11, 11]),
}
RESTORE_CASES = {
    "two-zero-slab-pads": ((3, 9, 4, 2, 16), [4, 1, 8, 8], 2),
    "odd-row-bytes": ((1, 6, 3, 1, 5), [2, 0, 5], 2),
    "no-padding": ((2, 7, 2, 2, 8), [6, 3, 0, 1], 4),
}


@pytest.mark.parametrize("case", sorted(COPY_CASES))
@pytest.mark.parametrize("dtype", NARROW)
def test_page_copy_ref_on_narrow_pools_matches_jax(dtype, case):
    shape, src, dst = COPY_CASES[case]
    pool = _narrow(np.random.default_rng(0).standard_normal(shape), dtype)
    s, d = np.asarray(src, np.int32), np.asarray(dst, np.int32)
    got = ref.page_copy_ref(_to_torch(pool.copy()), torch.from_numpy(s),
                            torch.from_numpy(d))
    assert got.dtype == getattr(torch, dtype)
    want = jref.page_copy_ref(jnp.asarray(pool), s, d)
    pallas = jops.page_copy(jnp.asarray(pool), jnp.asarray(s),
                            jnp.asarray(d), impl="interpret")
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(got), _bits(pallas))
    # the CUDA kernel's in-order walk, on the bit patterns
    in_order = _bits(pool).copy()
    for a, b in zip(s, d):
        in_order[:, b] = in_order[:, a]
    np.testing.assert_array_equal(_bits(got), in_order)


@pytest.mark.parametrize("case", sorted(RESTORE_CASES))
@pytest.mark.parametrize("dtype", NARROW)
def test_page_restore_ref_on_narrow_pools_matches_jax(dtype, case):
    shape, dst, n_real = RESTORE_CASES[case]
    rng = np.random.default_rng(1)
    pool = _narrow(rng.standard_normal(shape), dtype)
    rows = rng.standard_normal((shape[0], len(dst)) + shape[2:])
    rows[:, n_real:] = 0.0                    # padding carries zero slabs
    rows = _narrow(rows, dtype)
    d = np.asarray(dst, np.int32)
    got = ref.page_restore_ref(_to_torch(pool.copy()), _to_torch(rows),
                               torch.from_numpy(d))
    want = jref.page_restore_ref(jnp.asarray(pool), jnp.asarray(rows), d)
    pallas = jops.page_restore(jnp.asarray(pool), jnp.asarray(rows),
                               jnp.asarray(d), impl="interpret")
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(got), _bits(pallas))
    for i, p in enumerate(dst):
        np.testing.assert_array_equal(_bits(got)[:, p], _bits(rows)[:, i])
    untouched = [i for i in range(shape[1]) if i not in set(dst)]
    np.testing.assert_array_equal(_bits(got)[:, untouched],
                                  _bits(pool)[:, untouched])


@pytest.mark.parametrize("dtype", ["float64", "int8", "int32", "uint8"])
def test_kernel_movers_refuse_other_pool_dtypes(dtype):
    """The CUDA movers take the KV cache dtypes only; each of those
    passes the dtype check and is then refused on the CPU (no kernel
    build is attempted)."""
    src = torch.tensor([0], dtype=torch.int32)
    pool = torch.zeros((1, 2, 1, 1, 4), dtype=getattr(torch, dtype))
    with pytest.raises(TypeError, match="KV cache dtype"):
        page_copy(pool, src, src)
    with pytest.raises(TypeError, match="KV cache dtype"):
        page_restore(pool, pool[:, :1].clone(), src)
    for ok in POOL_DTYPES:
        pool = torch.zeros((1, 2, 1, 1, 4), dtype=ok)
        with pytest.raises(ValueError, match="CUDA"):
            page_copy(pool, src, src)
        with pytest.raises(ValueError, match="CUDA"):
            page_restore(pool, pool[:, :1].clone(), src)
    assert _build._lib is None


# ---------------------------------------------------------------------------
# the host-tier engine on narrow pools, in lockstep with the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pruned():
    """(jax params, jax cfg, port params, port cfg): the reduced gpt2-xl
    decomposed and pruned 0.5 by the reference, its pruned weights
    bridged to the port (each package's own decomposition differs in the
    last float32 bits, which a 16- or 8-bit cache can round a quantum
    apart); the port's config from its own decomposition and pruning."""
    jcfg = jax_config("gpt2-xl").reduced()
    cfg = get_config("gpt2-xl").reduced()
    jp = jax_init(jcfg, jax.random.PRNGKey(3))
    jd, jdc, _ = jax_decompose(jp, jcfg, peft=False)
    jpp, jpc = jax_prune(jd, jdc, qk_ratio=0.5, vo_ratio=0.5)
    td, tdc, _ = clover_decompose(from_numpy(jax.tree.map(np.asarray, jp),
                                             CPU), cfg)
    _, tpc = clover_prune(td, tdc, qk_ratio=0.5, vo_ratio=0.5)
    return jpp, jpc, from_numpy(jax.tree.map(np.asarray, jpp), CPU), tpc


HOST_KW = dict(slots=2, max_len=48, prefill_chunk=8, paged=True,
               page_tokens=4, n_pages=14, prefix_cache=True, host_pages=56)


def _trace():
    """test_torch_prefix.py's host-tier trace: a 16-token system prompt
    (4 full pages) alone, a burst that shares it (the prompt alone is a
    page-aligned full hit: copy-on-write), a churn burst of 4 x 30
    tokens (spills), the burst again (restores)."""
    rng = np.random.default_rng(7)

    def toks(n):
        return rng.integers(0, 512, n).astype(np.int32)

    sys_p = toks(16)
    burst = [np.concatenate([sys_p, toks(n)]) for n in (3, 6)]
    burst.append(sys_p.copy())
    churn = [toks(30) for _ in range(4)]
    return sys_p, [[sys_p], burst, churn, burst]


# the share of spilled elements that may sit one rounding boundary apart
# from the reference's, per cache dtype: float8 matched bit for bit;
# bfloat16 showed 10 single elements apart over 136 spilled leaf pages
FLIP_SHARE = {"bfloat16": 1e-3, "float8_e4m3fn": 0.0}


def _count_flips(got: np.ndarray, want: np.ndarray, msg: str) -> int:
    """The port's spilled bit patterns ``got`` against the reference's
    ``want`` (an ml_dtypes array) -> how many elements differ.  The two
    packages compute K/V in float32 in another summation order (~1e-7
    apart), so a value on a rounding boundary of the cache dtype may be
    stored one quantum apart, and a later layer's K/V move by what that
    quantum moved its input: each differing element is held within one
    quantum at the page's largest magnitude (``eps`` x max |want|); the
    caller bounds their share (``FLIP_SHARE``)."""
    assert got.dtype == _bits(want).dtype, msg
    g = got.view(want.dtype).astype(np.float32)
    w = want.astype(np.float32)
    eps = float(ml_dtypes.finfo(want.dtype).eps)
    np.testing.assert_allclose(g, w, rtol=0,
                               atol=eps * float(np.abs(w).max()),
                               err_msg=msg)
    return int((got != _bits(want)).sum())


def _host_state(eng):
    h = eng.host
    return (list(eng.alloc.free_list), list(eng.alloc.refcount),
            [list(t) for t in eng.alloc.tables], eng.prefix.pages(),
            dict(eng.prefix.nodes), h.spills, h.restores, h.dropped, h.hits,
            h.misses)


def _submit(mod, eng, wave, uid0, new):
    reqs = [mod.Request(uid=uid0 + i, prompt=p, max_new_tokens=new)
            for i, p in enumerate(wave)]
    for r in reqs:
        eng.submit(r)
    return reqs


@pytest.mark.parametrize("dtype", NARROW)
def test_narrow_host_tier_engine_matches_jax_engine(pruned, dtype):
    """Spills, restores, copy-on-write and streams equal the reference
    engine's with the pool in ``dtype``; every spilled page holds the
    reference's bytes; every restored page the bytes it was spilled
    with."""
    jp, jcfg, tp_, cfg = pruned
    jcfg = dataclasses.replace(jcfg, kv_cache_dtype=dtype)
    cfg = dataclasses.replace(cfg, kv_cache_dtype=dtype)
    jeng = JS.Engine(jp, jcfg, JS.EngineConfig(**HOST_KW))
    teng = S.Engine(tp_, cfg, S.EngineConfig(**HOST_KW), device=CPU)
    assert teng.state["blocks"][0]["kv"]["k"].dtype == getattr(torch, dtype)
    spilled = {"jax": [], "port": []}
    for name, eng in (("jax", jeng), ("port", teng)):
        def reader(page, _f=eng.prefix.page_reader, _log=spilled[name]):
            rows = _f(page)
            _log.append((page, rows))
            return rows
        eng.prefix.page_reader = reader
    restored = []
    real_restore = teng.exe.page_restore

    def checked_restore(state, rows, dst):
        assert all(r.dtype == np.dtype(f"u{r.dtype.itemsize}")
                   for r in rows)
        state = real_restore(state, rows, dst)
        for i, p in enumerate(dst):
            if p != teng.alloc.sentinel:
                for leaf_rows, leaf_got in zip(
                        rows, teng.exe.read_page(state, int(p))):
                    np.testing.assert_array_equal(leaf_rows[:, i], leaf_got)
                restored.append(int(p))
        return state

    teng.exe.page_restore = checked_restore
    sys_p, waves = _trace()
    uid = 0
    for new, wave in zip((4, 4, 6, 4), waves):
        if wave is waves[2]:                   # before the churn
            hit = teng.prefix.match(sys_p)
            assert hit == jeng.prefix.match(sys_p) and len(hit) == 4
            before = [teng.exe.read_page(teng.state, p) for p in hit]
        jreqs = _submit(JS, jeng, wave, uid, new)
        treqs = _submit(S, teng, wave, uid, new)
        uid += len(wave)
        steps = 0
        while jeng.sched.busy or teng.sched.busy:
            jeng.step()
            teng.step()
            steps += 1
            assert steps < 400
            teng.alloc.assert_consistent(teng.prefix)
            assert _host_state(teng) == _host_state(jeng), (uid, steps)
        assert [r.generated for r in treqs] == [r.generated for r in jreqs]
        assert [r.cached_tokens for r in treqs] == \
            [r.cached_tokens for r in jreqs]
    assert teng.host.spills == jeng.host.spills >= 4
    assert teng.host.restores == jeng.host.restores >= 4
    assert teng.sched.prefix_hits == jeng.sched.prefix_hits > 0
    assert restored
    assert [p for p, _ in spilled["port"]] == [p for p, _ in spilled["jax"]]
    flips = n_elems = 0
    for (p, got), (_, want) in zip(spilled["port"], spilled["jax"]):
        for g, w in zip(got, want):
            flips += _count_flips(g, w, f"page {p}")
            n_elems += g.size
    assert flips <= FLIP_SHARE[dtype] * n_elems, (flips, n_elems)
    hit = teng.prefix.match(sys_p)
    assert hit == jeng.prefix.match(sys_p) and len(hit) == 4
    for old, new in zip(before, [teng.exe.read_page(teng.state, p)
                                 for p in hit]):
        for a, b in zip(old, new):
            np.testing.assert_array_equal(a, b)
    assert teng.compiled_shapes() == jeng.compiled_shapes() == 4


@pytest.mark.parametrize("dtype", NARROW + ("float32",))
def test_executor_moves_host_rows_as_bits(pruned, dtype):
    """``read_page`` hands out a row's bit patterns (uint16 / uint8 for a
    16- / 8-bit pool, float32 rows as they are) and ``page_restore``
    puts them back bit for bit; rows of another width are refused."""
    _, _, tp_, cfg = pruned
    cfg = dataclasses.replace(cfg, kv_cache_dtype=dtype)
    eng = S.Engine(tp_, cfg, S.EngineConfig(**HOST_KW), device=CPU)
    gen = torch.Generator().manual_seed(0)
    for entry in eng.state["blocks"]:
        for leaf in entry["kv"].values():
            leaf.copy_(torch.randn(leaf.shape, generator=gen))
    rows = eng.exe.read_page(eng.state, 3)
    width = torch.finfo(getattr(torch, dtype)).bits // 8
    for r, leaf in zip(rows, (entry["kv"][k] for entry in
                              eng.state["blocks"] for k in "kv")):
        assert r.dtype == (np.float32 if dtype == "float32"
                           else np.dtype(f"u{width}"))
        np.testing.assert_array_equal(_bits(r), _bits(leaf[:, 3]))
    dst = np.asarray([5, eng.alloc.sentinel], np.int32)
    slabs = [np.stack([r, np.zeros_like(r)], axis=1) for r in rows]
    eng.exe.page_restore(eng.state, slabs, dst)
    for a, b in zip(eng.exe.read_page(eng.state, 5), rows):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    wrong = [s.view(np.uint8) if width > 1 else s.astype(np.uint16)
             for s in slabs]
    with pytest.raises(ValueError, match="rows for a"):
        eng.exe.page_restore(eng.state, wrong, dst)


def _serve_trace(params, cfg, host_pages):
    """The trace on a port engine -> (engine, streams, restored pages
    each checked byte-identical to its spilled rows)."""
    eng = S.Engine(params, cfg, S.EngineConfig(**dict(
        HOST_KW, host_pages=host_pages)), device=CPU)
    restored = []
    real_restore = eng.exe.page_restore

    def checked_restore(state, rows, dst):
        state = real_restore(state, rows, dst)
        for i, p in enumerate(dst):
            if p != eng.alloc.sentinel:
                for leaf_rows, leaf_got in zip(
                        rows, eng.exe.read_page(state, int(p))):
                    np.testing.assert_array_equal(leaf_rows[:, i], leaf_got)
                restored.append(int(p))
        return state

    eng.exe.page_restore = checked_restore
    _, waves = _trace()
    streams, uid = [], 0
    for new, wave in zip((4, 4, 6, 4), waves):
        reqs = _submit(S, eng, wave, uid, new)
        uid += len(wave)
        while eng.sched.busy:
            eng.step()
            eng.alloc.assert_consistent(eng.prefix)
        streams.append([r.generated for r in reqs])
    return eng, streams, restored


def test_bf16_compute_host_tier_engine(pruned):
    """A bfloat16-compute model (weights cast once, the cache at the
    compute dtype) serves the trace: it spills and restores, and its
    streams equal the same engine's without a host tier."""
    _, _, tp_, cfg = pruned
    cfg = dataclasses.replace(cfg, param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    params = tree_map(lambda t: t.to(torch.bfloat16), tp_)
    eng, streams, restored = _serve_trace(params, cfg, 56)
    assert eng.state["blocks"][0]["kv"]["k"].dtype == torch.bfloat16
    assert eng.host.spills >= 4 and eng.host.restores >= 4 and restored
    assert eng.sched.prefix_hits > 0
    assert eng.compiled_shapes() == 4
    cold, cold_streams, none = _serve_trace(params, cfg, 0)
    assert cold.host is None and not none
    assert streams == cold_streams


# ---------------------------------------------------------------------------
# float8 cache rows through the collectives, on two gloo ranks
# ---------------------------------------------------------------------------

def test_fp8_cache_data_replicas_match_one_rank(pruned, tmp_path):
    """(data 2): each replica runs one slot; every layer's new K/V rows,
    already float8, are all-gathered so both replicas hold the whole
    pool; the host tier spills and restores those rows.  Streams,
    per-step records and shapes equal one rank's."""
    _, _, tp_, cfg = pruned
    cfg = dataclasses.replace(cfg, kv_cache_dtype="float8_e4m3fn")
    _, waves = _trace()
    waves = [[dict(prompt=p, max_new_tokens=new) for p in wave]
             for new, wave in zip((4, 4, 6, 4), waves)]
    run = ServeRun("fp8", tp_, cfg, S.EngineConfig(**HOST_KW), waves,
                   trace=True)
    want = serve_waves(run, device=CPU)
    assert want["stats"]["host_restores"] > 0
    got = serve_tp([run], tp=1, data=2, backend="gloo", device=CPU,
                   timeout=RANK_TIMEOUT, threads=1, workdir=str(tmp_path))
    for rank, (g,) in enumerate(got):
        assert (g["data"], g["replica"]) == (2, rank)
        assert g["collectives"]["all_gather"] > 0
        assert g["streams"] == want["streams"], rank
        assert g["trace"] == want["trace"], rank
        assert g["compiled_shapes"] == want["compiled_shapes"]
        assert g["stats"]["host_restores"] == want["stats"]["host_restores"]


def test_fp8_cache_sequence_split_prefill_matches_one_rank(pruned,
                                                           tmp_path):
    """(1, 2): the dense cache splits along its sequence; the second
    prefill (at index 12) all-gathers both float8 windows.  Every rank's
    streams equal one rank's."""
    _, _, tp_, cfg = pruned
    cfg = dataclasses.replace(cfg, kv_cache_dtype="float8_e4m3fn")
    rng = np.random.default_rng(11)
    batch = {"prompts": rng.integers(0, 512, (4, 12)).astype(np.int32),
             "more": rng.integers(0, 512, (4, 5)).astype(np.int32),
             "new": 5, "max_len": 32}
    want = run_steps(StepRun("one", tp_, cfg, (1, 1), [batch]), device=CPU)
    got = serve_step_ranks([StepRun("split", tp_, cfg, (1, 2), [batch])],
                           world=2, backend="gloo", device=CPU,
                           timeout=RANK_TIMEOUT, threads=1,
                           workdir=str(tmp_path))
    for rank, (g,) in enumerate(got):
        assert g["streams"] == want["streams"], rank
        assert g["collectives"]["all_gather"] > 0
