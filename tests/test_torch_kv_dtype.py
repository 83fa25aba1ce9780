"""KV caches stored in another dtype than the compute dtype, and trees of
16- and 8-bit floats across the weight bridge.

The port against the JAX package on the same weights (numpy-bridged) at
a reduced gpt2-xl (2 layers, d_model 128, 4 heads of 32): prefill, then
six decode steps, with the dense cache and the paged pool stored in
bfloat16, float8_e4m3fn and float8_e5m2.  Both packages write K/V
rounded to the cache dtype and attend over it at float32 (the reference
casts the cache before its kernels, the port's decode kernels convert
each element as they read it).  Tolerance on logits: atol 1e-4, float32 math
summed in another order through two layers.  The two sides round K/V
values that agree to ~1e-6 with the same round-to-nearest-even, so they
store the same quanta (a value on a rounding boundary could land one
quantum apart; the cache check allows 1% of such elements).
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
from repro.models import init_lm_params as jax_init  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve.memory import PageAllocator  # noqa: E402
from repro_torch import serve as S  # noqa: E402
from repro_torch.bridge import from_numpy, to_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

CPU = "cpu"
ATOL = 1e-4
KV_DTYPES = ("bfloat16", "float8_e4m3fn", "float8_e5m2")
STEPS = 6


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_config("gpt2-xl").reduced()
    jparams = jax_init(jcfg, jax.random.PRNGKey(0))
    return jparams, from_numpy(jax.tree.map(np.asarray, jparams), CPU)


def _configs(kv_dtype):
    return (dataclasses.replace(jax_config("gpt2-xl").reduced(),
                                kv_cache_dtype=kv_dtype),
            dataclasses.replace(get_config("gpt2-xl").reduced(),
                                kv_cache_dtype=kv_dtype))


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, 512, shape).astype(
        np.int32)


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_dense_cache_prefill_and_decode_match_jax(weights, kv_dtype):
    jparams, tparams = weights
    jcfg, cfg = _configs(kv_dtype)
    B, L, cap = 2, 12, 32
    jst = JT.init_decode_state(jcfg, B, cap)
    tst = T.init_decode_state(cfg, B, cap, device=CPU)
    ck = tst["blocks"][0]["kv"]["k"]
    assert ck.dtype == getattr(torch, kv_dtype)
    assert str(jst["blocks"][0]["kv"]["k"].dtype) == kv_dtype
    toks = _tokens((B, L), 1)
    jl, jst = JT.prefill(jparams, jcfg, jnp.asarray(toks), jst)
    tl, tst = T.prefill(tparams, cfg, torch.from_numpy(toks), tst)
    _close(tl, jl, ATOL)
    for i in range(STEPS):
        tok = _tokens((B,), 10 + i)
        jl, jst = JT.decode_step(jparams, jcfg, jnp.asarray(tok), jst)
        tl, tst = T.decode_step(tparams, cfg, torch.from_numpy(tok), tst)
        assert tl.dtype == torch.float32
        _close(tl, jl, ATOL)
    assert int(tst["index"]) == int(jst["index"]) == L + STEPS
    # the stored caches hold the same quanta, up to rounding-boundary
    # flips
    for t_leaf, j_leaf in ((tst["blocks"][0]["kv"][n],
                            jst["blocks"][0]["kv"][n]) for n in "kv"):
        assert t_leaf.dtype == getattr(torch, kv_dtype)
        got = t_leaf.float().numpy()
        want = np.asarray(j_leaf.astype(jnp.float32))
        assert np.mean(got == want) > 0.99


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_paged_pool_prefill_and_decode_match_jax(weights, kv_dtype):
    jparams, tparams = weights
    jcfg, cfg = _configs(kv_dtype)
    B, L, pt, n_pages = 2, 12, 4, 12
    alloc = PageAllocator(n_pages, pt, B, table_pages=5)
    assert alloc.ensure(0, L) and alloc.ensure(1, L)
    jst = JT.init_decode_state_paged(jcfg, B, n_pages, pt)
    tst = T.init_decode_state_paged(cfg, B, n_pages, pt, device=CPU)
    assert tst["blocks"][0]["kv"]["k"].dtype == getattr(torch, kv_dtype)
    index = np.zeros(B, np.int32)
    jst["index"] = jnp.asarray(index)
    tst["index"] = torch.from_numpy(index)
    lengths = np.full(B, L, np.int32)
    toks = _tokens((B, L), 2)
    tab = alloc.table_array()
    jl, jst = JT.prefill_chunk(jparams, jcfg, jnp.asarray(toks), jst,
                               jnp.asarray(lengths), pages=jnp.asarray(tab))
    tl, tst = T.prefill_chunk(tparams, cfg, torch.from_numpy(toks), tst,
                              torch.from_numpy(lengths),
                              pages=torch.from_numpy(tab))
    _close(tl, jl, ATOL)
    for i in range(STEPS):
        assert alloc.ensure(0, L + i + 1) and alloc.ensure(1, L + i + 1)
        tab = alloc.table_array()
        tok = _tokens((B,), 20 + i)
        jl, jst = JT.decode_step(jparams, jcfg, jnp.asarray(tok), jst,
                                 pages=jnp.asarray(tab))
        tl, tst = T.decode_step(tparams, cfg, torch.from_numpy(tok), tst,
                                pages=torch.from_numpy(tab))
        _close(tl, jl, ATOL)
    np.testing.assert_array_equal(tst["index"].numpy(),
                                  np.asarray(jst["index"]))


def test_dense_engine_stream_at_bfloat16_equals_jax_engine(weights):
    jparams, tparams = weights
    jcfg, cfg = _configs("bfloat16")
    kw = dict(slots=2, max_len=48, prefill_chunk=8)
    prompts = [np.random.default_rng(3).integers(0, 512, n).astype(np.int32)
               for n in (5, 17, 11)]
    jeng = JS.Engine(jparams, jcfg, JS.EngineConfig(**kw))
    teng = S.Engine(tparams, cfg, S.EngineConfig(**kw), device=CPU)
    jreqs = [JS.Request(uid=i, prompt=p, max_new_tokens=6)
             for i, p in enumerate(prompts)]
    treqs = [S.Request(uid=i, prompt=p, max_new_tokens=6)
             for i, p in enumerate(prompts)]
    jeng.run(jreqs)
    teng.run(treqs)
    assert teng.state["blocks"][0]["kv"]["k"].dtype == torch.bfloat16
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    assert teng.steps == jeng.steps
    assert teng.compiled_shapes() == 2


# -- the bridge ---------------------------------------------------------

def _bits(a):
    a = np.asarray(a)
    return a.view(f"u{a.dtype.itemsize}")


def test_bfloat16_tree_crosses_the_bridge_bit_for_bit():
    """A JAX ``param_dtype="bfloat16"`` tree (bf16 weights beside the
    float32 leaves the init keeps) into torch and back, every bit kept,
    and the torch leaves hold the same values."""
    jcfg = dataclasses.replace(jax_config("gpt2-xl").reduced(),
                               param_dtype="bfloat16")
    nparams = jax.tree.map(np.asarray, jax_init(jcfg,
                                                jax.random.PRNGKey(1)))
    leaves = jax.tree.leaves(nparams)
    assert any(a.dtype == ml_dtypes.bfloat16 for a in leaves)
    tparams = from_numpy(nparams, CPU)
    back = to_numpy(tparams)
    for a, t, b in zip(leaves, jax.tree.leaves(tparams),
                       jax.tree.leaves(back)):
        assert b.dtype == a.dtype and b.shape == a.shape
        np.testing.assert_array_equal(_bits(b), _bits(a))
        if a.dtype == ml_dtypes.bfloat16:
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(t.float().numpy(),
                                          a.astype(np.float32))


@pytest.mark.parametrize("name", ["bfloat16", "float8_e4m3fn",
                                  "float8_e5m2"])
def test_narrow_float_leaves_cross_both_ways(name):
    """Every bit pattern of the type (NaNs, infinities and -0 among
    them) crosses numpy -> torch -> numpy unchanged, and torch's value
    of each finite pattern is numpy's."""
    np_dtype = getattr(ml_dtypes, name)
    width = np.dtype(np_dtype).itemsize
    bits = np.arange(1 << (8 * width), dtype=f"u{width}")
    arr = bits.view(np_dtype).reshape(-1, 16)
    t = from_numpy({"w": arr}, CPU)["w"]
    assert t.dtype == getattr(torch, name)
    back = to_numpy({"w": t})["w"]
    assert back.dtype == np_dtype
    np.testing.assert_array_equal(_bits(back), _bits(arr))
    want = arr.astype(np.float32)
    finite = np.isfinite(want)
    np.testing.assert_array_equal(t.float().numpy()[finite], want[finite])
