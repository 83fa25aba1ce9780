"""The port's RWKV-6 path against the JAX package at a reduced
rwkv6-1.6b (d_model 128, 2 layers, 4 wkv heads of 32): the plain wkv6
against the JAX oracle and the Pallas kernel (interpret mode), the
time- and channel-mix, the model's logits and decode states on the same
(numpy-bridged) weights, and the serving engine in lockstep with the
JAX engine (multi-chunk prompts, TAIL, slot reuse, paged with
preemption).

Tolerances: the port's wkv6 is the sequential recurrence, the JAX
model's default path the chunked parallel form (pairwise log-space
decays), so float32 sums differ in order: 2e-5 on the kernel function
at unit-scale inputs (scaled by the output's magnitude where the state
grows), 1e-4 on mixer outputs and logits.
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
from repro.core import clover_decompose as jax_decompose  # noqa: E402
from repro.core import clover_prune as jax_prune  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.models import init_lm_params as jax_init  # noqa: E402
from repro.models import rwkv as JR  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import serve as S  # noqa: E402
from repro_torch.bridge import from_numpy, to_numpy, tree_map  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.decompose import clover_decompose  # noqa: E402
from repro_torch.core.prune import clover_prune  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.wkv6 import wkv6 as wkv6_kernel  # noqa: E402
from repro_torch.models import rwkv as R  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

CPU = "cpu"
TOL = 2e-5          # wkv6 function, unit-scale inputs
MODEL_TOL = 1e-4    # mixers and logits: sequential vs chunked sums


@pytest.fixture(scope="module")
def model():
    """(jax params, jax cfg, port params, port cfg) on the same
    weights."""
    jcfg = jax_config("rwkv6-1.6b").reduced()
    cfg = get_config("rwkv6-1.6b").reduced()
    jp = jax_init(jcfg, jax.random.PRNGKey(7))
    return jp, jcfg, from_numpy(jax.tree.map(np.asarray, jp), CPU), cfg


def _close(got, want, atol):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=atol, rtol=0)


def _wkv_inputs(B, H, T, d, seed, logw_edge=None):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, H, T, d)).astype(np.float32)
               for _ in range(3))
    if logw_edge is None:
        logw = np.clip(-np.exp(rng.standard_normal((B, H, T, d))),
                       -10.0, -1e-4).astype(np.float32)
    else:
        logw = np.full((B, H, T, d), logw_edge, np.float32)
    u = (rng.standard_normal((H, d)) * 0.5).astype(np.float32)
    s0 = rng.standard_normal((B, H, d, d)).astype(np.float32)
    return r, k, v, logw, u, s0


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
        return out
    return {prefix: tree}


# -- the kernel function ------------------------------------------------

@pytest.mark.parametrize("T_", [1, 7, 33, 64])
@pytest.mark.parametrize("with_s0", [False, True])
def test_wkv6_plain_matches_jax_oracle_and_pallas(T_, with_s0):
    r, k, v, logw, u, s0 = _wkv_inputs(2, 3, T_, 16, seed=T_)
    s0 = s0 if with_s0 else None
    got_o, got_s = ops.wkv6(*(torch.from_numpy(a) for a in (r, k, v, logw,
                                                             u)),
                            None if s0 is None else torch.from_numpy(s0))
    want_o, want_s = jax_ref.wkv6_ref(r, k, v, logw, u, s0)
    scale = max(1.0, float(np.abs(want_o).max()))
    _close(got_o, want_o, TOL * scale)
    _close(got_s, want_s, TOL * max(1.0, float(np.abs(want_s).max())))
    pal_o, pal_s = jax_ops.wkv6(r, k, v, logw, u, s0, impl="interpret",
                                chunk=16)
    _close(got_o, pal_o, TOL * scale)
    _close(got_s, pal_s, TOL * max(1.0, float(np.abs(want_s).max())))


@pytest.mark.parametrize("edge", [-10.0, -1e-4])
def test_wkv6_plain_at_the_decay_clip_edges(edge):
    """logw at the model's clip bounds: decay ~ 0 forgets at once, decay
    ~ 1 lets the state grow over T (the tolerance follows the scale)."""
    r, k, v, logw, u, s0 = _wkv_inputs(1, 2, 48, 32, seed=5, logw_edge=edge)
    got_o, got_s = ref.wkv6_ref(*(torch.from_numpy(a)
                                  for a in (r, k, v, logw, u, s0)))
    want_o, want_s = jax_ref.wkv6_ref(r, k, v, logw, u, s0)
    pal_o, pal_s = jax_ops.wkv6(r, k, v, logw, u, s0, impl="interpret",
                                chunk=16)
    for want, pal, got in ((want_o, pal_o, got_o), (want_s, pal_s, got_s)):
        tol = TOL * max(1.0, float(np.abs(want).max()))
        _close(got, want, tol)
        _close(got, pal, tol)


def test_wkv6_chained_calls_equal_one_call():
    """The engine's chunk -> TAIL handoff: T1 steps, then T2 steps from
    S_end, equal one call over T1 + T2."""
    r, k, v, logw, u, s0 = (torch.from_numpy(a)
                            for a in _wkv_inputs(2, 2, 21, 32, seed=9))
    o, s = ops.wkv6(r, k, v, logw, u, s0)
    o1, s1 = ops.wkv6(r[:, :, :13].contiguous(), k[:, :, :13].contiguous(),
                      v[:, :, :13].contiguous(),
                      logw[:, :, :13].contiguous(), u, s0)
    o2, s2 = ops.wkv6(r[:, :, 13:].contiguous(), k[:, :, 13:].contiguous(),
                      v[:, :, 13:].contiguous(),
                      logw[:, :, 13:].contiguous(), u, s1)
    scale = max(1.0, float(o.abs().max()))
    _close(torch.cat([o1, o2], dim=2), o.numpy(), TOL * scale)
    _close(s2, s.numpy(), TOL * max(1.0, float(s.abs().max())))


def test_wkv6_dispatch_and_kernel_guard():
    """CPU tensors reach the plain version (never the kernel); the
    kernel wrapper refuses CPU tensors before building anything."""
    args = [torch.from_numpy(a) for a in _wkv_inputs(1, 1, 3, 32, seed=2)]
    before, launches = ref.wkv6_ref.calls, wkv6_kernel.launches
    ops.wkv6(*args)
    assert ref.wkv6_ref.calls == before + 1
    assert wkv6_kernel.launches == launches
    with pytest.raises(ValueError, match="CUDA"):
        wkv6_kernel(*args)


# -- mixers, model, decode states ---------------------------------------

def _layer(tree, i=0):
    return jax.tree.map(lambda a: a[i], tree)


@pytest.mark.parametrize("with_state", [False, True])
def test_mixers_match_jax(model, with_state):
    jp, jcfg, tp, cfg = model
    rng = np.random.default_rng(11)
    B, L, D = 2, 7, cfg.d_model
    H, d = cfg.rwkv_n_heads, cfg.rwkv_head_dim
    x = rng.standard_normal((B, L, D)).astype(np.float32)
    tstate = cstate = None
    if with_state:
        tstate = {"last_x": rng.standard_normal((B, D)).astype(np.float32),
                  "wkv": (rng.standard_normal((B, H, d, d)) * 0.3)
                  .astype(np.float32)}
        cstate = {"last_x": rng.standard_normal((B, D)).astype(np.float32)}
    blocks = jp["blocks"][0]
    for jfn, tfn, name, st in (
            (JR.rwkv_timemix_forward, R.rwkv_timemix_forward, "rwkv_time",
             tstate),
            (JR.rwkv_chanmix_forward, R.rwkv_chanmix_forward, "rwkv_chan",
             cstate)):
        jy, jst = jfn(_layer(blocks[name]), jcfg, jnp.asarray(x),
                      state=st)
        ty, tst = tfn(tree_map(lambda a: a[0], tp["blocks"][0][name]), cfg,
                      torch.from_numpy(x),
                      state=None if st is None else from_numpy(st, CPU))
        _close(ty, jy, MODEL_TOL)
        assert (tst is None) == (jst is None)
        if st is not None:
            for key, leaf in _flat(to_numpy(tst)).items():
                _close(leaf, _flat(jax.tree.map(np.asarray, jst))[key],
                       MODEL_TOL)


def test_init_params_tree_matches_jax(model):
    jp, jcfg, _, cfg = model
    mine = _flat(to_numpy(T.init_lm_params(cfg, 0, device=CPU)))
    ref_tree = _flat(jax.tree.map(np.asarray, jp))
    assert sorted(mine) == sorted(ref_tree)
    for key, leaf in mine.items():
        assert leaf.shape == ref_tree[key].shape, key
        assert leaf.dtype == ref_tree[key].dtype, key
        name = key.rsplit("/", 1)[-1]
        if name.startswith("mix_") or name in ("w0", "ln_x_scale",
                                               "ln_x_bias"):
            np.testing.assert_array_equal(leaf, ref_tree[key], err_msg=key)
    assert sum(a.size for a in mine.values()) == cfg.n_params()


def test_forward_logits_match_jax(model):
    jp, jcfg, tp, cfg = model
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 64))
    got, _ = T.forward(tp, cfg, toks, device=CPU)
    want, _ = JT.forward(jp, jcfg, jnp.asarray(toks))
    _close(got, want, MODEL_TOL)


def test_decode_state_and_steps_match_jax(model):
    jp, jcfg, tp, cfg = model
    B, C = 2, 8
    jst = JT.init_decode_state(jcfg, B, 16)
    tst = T.init_decode_state(cfg, B, 16, device=CPU)
    jflat = _flat(jax.tree.map(np.asarray, jst))
    tflat = _flat(to_numpy(tst))
    assert sorted(tflat) == sorted(jflat)
    for key in jflat:
        assert tflat[key].shape == jflat[key].shape, key
        assert tflat[key].dtype == jflat[key].dtype, key
    jst["index"] = jnp.zeros((B,), jnp.int32)
    tst["index"] = torch.zeros((B,), dtype=torch.int32)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, (B, C)).astype(np.int32)
    lens = np.asarray([C, C], np.int32)
    jl, jst = JT.prefill_chunk(jp, jcfg, jnp.asarray(toks), jst,
                               jnp.asarray(lens))
    tl, tst = T.prefill_chunk(tp, cfg, torch.from_numpy(toks).long(), tst,
                              torch.from_numpy(lens))
    _close(tl, jl, MODEL_TOL)
    for _ in range(3):
        tok = rng.integers(0, cfg.vocab_size, (B,)).astype(np.int32)
        jl, jst = JT.decode_step(jp, jcfg, jnp.asarray(tok), jst)
        tl, tst = T.decode_step(tp, cfg, torch.from_numpy(tok).long(), tst)
        _close(tl, jl, MODEL_TOL)
    jflat = _flat(jax.tree.map(np.asarray, jst))
    for key, leaf in _flat(to_numpy(tst)).items():
        _close(leaf, jflat[key], MODEL_TOL)


# -- serving ------------------------------------------------------------

def _prompts(lens, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, n).astype(np.int32) for n in lens]


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_engine_lockstep_with_jax_engine(model, layout):
    """Prompts of several chunks plus a TAIL, TAIL-only prompts, and
    more requests than slots (state isolation on slot reuse); paged
    with a pool small enough to preempt.  Phases, positions and (paged)
    page tables equal every step; streams token-identical to the JAX
    engine's and to greedy_reference; 2 step shapes."""
    jp, jcfg, tp, cfg = model
    kw = dict(slots=2, max_len=32, prefill_chunk=4)
    if layout == "paged":
        kw.update(paged=True, page_tokens=4, n_pages=7)
    jeng = JS.Engine(jp, jcfg, JS.EngineConfig(**kw))
    teng = S.Engine(tp, cfg, S.EngineConfig(**kw), device=CPU)
    prompts = _prompts((11, 3, 17, 5, 9, 2))
    new = 5
    jreqs = [JS.Request(uid=i, prompt=p, max_new_tokens=new)
             for i, p in enumerate(prompts)]
    treqs = [S.Request(uid=i, prompt=p, max_new_tokens=new)
             for i, p in enumerate(prompts)]
    for jr, tr in zip(jreqs, treqs):
        jeng.submit(jr)
        teng.submit(tr)
    phases = set()
    steps = 0
    while jeng.sched.busy or teng.sched.busy:
        jeng.step()
        teng.step()
        steps += 1
        assert steps < 300
        assert teng.sched.phase == jeng.sched.phase, steps
        np.testing.assert_array_equal(teng.sched.pos, jeng.sched.pos)
        assert [r.generated for r in treqs] == [r.generated for r in jreqs]
        phases.update(p for p in teng.sched.phase if p is not None)
        if layout == "paged":
            assert teng.alloc.tables == jeng.alloc.tables, steps
            teng.alloc.assert_consistent(context=f"step {steps}")
    assert phases == {"prefill", "tail", "decode"}
    assert teng.steps == jeng.steps
    assert teng.compiled_shapes() == jeng.compiled_shapes() == 2
    if layout == "paged":
        assert teng.sched.preemptions == jeng.sched.preemptions > 0
        assert not any("kv" in entry for entry in teng.state["blocks"])
    for r, p in zip(treqs, prompts):
        assert r.done
        assert r.generated == S.greedy_reference(tp, cfg, p, new,
                                                 device=CPU)


def test_engine_validation_matches_jax(model):
    jp, jcfg, tp, cfg = model
    kw = dict(slots=2, max_len=32, paged=True, prefix_cache=True)
    with pytest.raises(ValueError, match="attention-only"):
        JS.Engine(jp, jcfg, JS.EngineConfig(**kw))
    with pytest.raises(ValueError, match="attention-only"):
        S.Engine(tp, cfg, S.EngineConfig(**kw), device=CPU)
    # both refuse speculation on recurrent archs at Engine construction
    with pytest.raises(ValueError, match="recurrent"):
        JS.Engine(jp, jcfg, JS.EngineConfig(slots=2, max_len=32, spec_k=2))
    with pytest.raises(ValueError, match="recurrent"):
        S.Engine(tp, cfg, S.EngineConfig(slots=2, max_len=32, spec_k=2),
                 device=CPU)


def test_unported_patterns_and_peft_path_raise(model):
    _, _, tp, cfg = model
    for pattern in ((("rwkv", "moe"),), (("attn", "rwkv_ffn"),)):
        bad = dataclasses.replace(cfg, pattern=pattern)
        with pytest.raises(NotImplementedError, match="not ported"):
            T.init_lm_params(bad, 0, device=CPU)
    # the channel-mix's CLOVER MLP.Up path is ported: the decomposed key
    # projection (up_u, up_t) gives the reference's output
    jp, jcfg = model[0], model[1]
    jd, _, _ = jax_decompose(jp, jcfg, peft=True)
    chan = tree_map(lambda a: a[0], from_numpy(
        jax.tree.map(np.asarray, jd["blocks"][0]["rwkv_chan"]), CPU))
    assert {"up_u", "up_t"} <= set(chan) and "wk" not in chan
    x = np.random.default_rng(3).normal(size=(2, 5, cfg.d_model)).astype(
        np.float32)
    got, _ = R.rwkv_chanmix_forward(chan, cfg, torch.as_tensor(x))
    want, _ = JR.rwkv_chanmix_forward(
        jax.tree.map(lambda a: a[0], jd["blocks"][0]["rwkv_chan"]), jcfg,
        jnp.asarray(x))
    _close(got, want, 1e-5)
    plain, _ = R.rwkv_chanmix_forward(
        tree_map(lambda a: a[0], tp["blocks"][0]["rwkv_chan"]), cfg,
        torch.as_tensor(x))
    _close(got, plain, 1e-5)


def test_clover_decompose_and_prune_pass_rwkv_through(model):
    """No attention pairs: decompose and prune leave every leaf as it
    was and only flip the config, as in the reference."""
    jp, jcfg, tp, cfg = model
    jd, jdc, jex = jax_decompose(jp, jcfg, peft=False)
    td, tdc, tex = clover_decompose(tp, cfg)
    assert tdc.clover.enabled and jdc.clover.enabled
    assert tex == [{"spectra": {}}] == jax.tree.map(np.asarray, jex)
    for key, leaf in _flat(to_numpy(td)).items():
        np.testing.assert_array_equal(leaf, _flat(to_numpy(tp))[key])
    jpp, jpc = jax_prune(jd, jdc, qk_ratio=0.5, vo_ratio=0.5)
    tpp, tpc = clover_prune(td, tdc, qk_ratio=0.5, vo_ratio=0.5)
    assert (tpc.qk_dim, tpc.vo_dim) == (jpc.qk_dim, jpc.vo_dim)
    jflat = _flat(jax.tree.map(np.asarray, jpp))
    for key, leaf in _flat(to_numpy(tpp)).items():
        np.testing.assert_array_equal(leaf, jflat[key])
    # same weights, so the same function; compared with a tolerance
    # because threaded CPU GEMMs may split their sums differently per run
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (1, 9))
    _close(T.forward(tpp, tpc, toks, device=CPU)[0],
           T.forward(tp, cfg, toks, device=CPU)[0].numpy(), 1e-6)
