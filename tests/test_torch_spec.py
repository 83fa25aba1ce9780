"""Self-speculative decoding in the port against the JAX package
(DESIGN.md §8), on the same (numpy-bridged) weights at reduced size:
gpt2-xl ("cross" CLOVER mode), stablelm-3b ("partial": only the NoPE
tail of Q-K is sliced) and phi3-medium-14b ("intra": only V-O is
sliced), each decomposed and pruned 0.5 / 0.5 by the reference.

Tolerances: atol 1e-4 on logits and caches (float32 matmuls summed in
another order through two layers, as ``tests/test_torch_rope.py``);
1e-6 on the verify oracle against the jnp one (one softmax, float32);
the plain decode versions on strided views are compared with their
results on contiguous copies of the same views bit for bit (the same
plain code on the same values).  Engines run in lockstep with the JAX
engine: streams, ``accept_hist``, ``spec_rounds``, the per-slot index,
page tables, free lists and refcounts identical after every step.
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
from repro.core import prune as jprune  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import init_lm_params as jax_init  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import serve as S  # noqa: E402
from repro_torch.bridge import budget_from_fields, from_numpy, to_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import prune  # noqa: E402
from repro_torch.core.decompose import clover_decompose  # noqa: E402
from repro_torch.core.prune import clover_prune, draft_ranks  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.decode_attention import row_stride  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

CPU = "cpu"
ATOL = 1e-4
ORACLE_TOL = 1e-6
NAMES = ("gpt2-xl", "stablelm-3b", "phi3-medium-14b")
MODE = {"gpt2-xl": "cross", "stablelm-3b": "partial",
        "phi3-medium-14b": "intra"}


def _pair(name, seed, prune_ratio):
    """The reference's weights (decomposed and pruned by the reference
    when ``prune_ratio``), bridged to the port: both sides run the same
    numbers.  The port's cfg comes from its own decompose and prune and
    must equal the reference's."""
    jcfg = jax_config(name).reduced()
    cfg = get_config(name).reduced()
    jp = jax_init(jcfg, jax.random.PRNGKey(seed))
    tp = from_numpy(jax.tree.map(np.asarray, jp), CPU)
    if not prune_ratio:
        return jp, jcfg, tp, cfg
    jd, jdc, _ = jax_decompose(jp, jcfg, peft=False)
    jpp, jpc = jax_prune(jd, jdc, qk_ratio=prune_ratio, vo_ratio=prune_ratio)
    td, tdc, _ = clover_decompose(tp, cfg)
    _, tpc = clover_prune(td, tdc, qk_ratio=prune_ratio,
                          vo_ratio=prune_ratio)
    assert dataclasses.asdict(tpc) == dataclasses.asdict(jpc)
    return jpp, jpc, from_numpy(jax.tree.map(np.asarray, jpp), CPU), tpc


@pytest.fixture(scope="module")
def models():
    """{(name, prune): (jax params, jax cfg, port params, port cfg)}."""
    out = {(name, 0.5): _pair(name, i + 3, 0.5)
           for i, name in enumerate(NAMES)}
    out[("gpt2-xl", 0.0)] = _pair("gpt2-xl", 3, 0.0)
    return out


def _tokens(shape, seed=0, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _close(got, want, atol=ATOL):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=0)


# ---------------------------------------------------------------------------
# draft widths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ratio", [0.0, 0.25, 0.5, 0.75, 0.9])
@pytest.mark.parametrize("name", NAMES)
def test_draft_ranks_match_reference(name, ratio):
    """Full-size and reduced configs, unpruned and pruned: the port's
    widths equal the reference's, and each mode slices only what it
    may."""
    for jc, c in ((jax_config(name), get_config(name)),
                  (jax_config(name).reduced(), get_config(name).reduced())):
        for keep in (None, 0.5):
            if keep is not None:
                jqk, jvo = jprune.plan_ranks(jc, keep, keep)
                jc = jprune._set_ranks(jc, jqk, jvo)
                c = prune._set_ranks(c, jqk, jvo)
            got = draft_ranks(c, ratio)
            assert got == jprune.draft_ranks(jc, ratio), (jc.qk_dim,
                                                          jc.vo_dim)
            r_q, r_v = got
            rot = min(c.rope_dims, c.qk_dim)
            if MODE[name] == "intra":
                assert r_q == c.qk_dim
            elif MODE[name] == "partial":
                assert rot <= r_q <= c.qk_dim
            assert 0 < r_v <= c.vo_dim


# ---------------------------------------------------------------------------
# the verify oracle and the plain decode versions on strided views
# ---------------------------------------------------------------------------

def _verify_case(rng, B, W, T_, H, KV, dq, dv, lens):
    q = rng.standard_normal((B, W, H, dq)).astype(np.float32)
    k = rng.standard_normal((B, T_, KV, dq)).astype(np.float32)
    v = rng.standard_normal((B, T_, KV, dv)).astype(np.float32)
    return q, k, v, np.asarray(lens, np.int32)


@pytest.mark.parametrize("B,W,T_,H,KV,dq,dv,lens", [
    (2, 3, 16, 4, 2, 8, 6, [3, 16]),
    (3, 5, 24, 4, 1, 16, 16, [5, 9, 24]),
    (1, 1, 12, 2, 2, 4, 8, [7])])
def test_verify_ref_matches_jax_oracle(B, W, T_, H, KV, dq, dv, lens):
    rng = np.random.default_rng(B * 10 + W)
    q, k, v, lengths = _verify_case(rng, B, W, T_, H, KV, dq, dv, lens)
    scale = 1.0 / np.sqrt(dq)
    got = ref.verify_decode_attention_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(lengths), scale=scale)
    want = jref.verify_decode_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(lengths), scale=scale)
    _close(got, want, ORACLE_TOL)


def test_verify_ref_reduces_to_decode_and_ignores_rolled_back_tail():
    """W == 1 is the decode oracle; K/V past ``lengths`` (a rolled-back
    draft tail) never count."""
    rng = np.random.default_rng(7)
    q, k, v, lengths = _verify_case(rng, 2, 1, 16, 4, 2, 8, 8, [5, 16])
    args = [torch.from_numpy(a) for a in (q, k, v, lengths)]
    one = ref.verify_decode_attention_ref(*args, scale=0.3)
    dec = ref.decode_attention_ref(args[0][:, 0], *args[1:], scale=0.3)
    _close(one[:, 0], dec.numpy(), ORACLE_TOL)
    q, k, v, lengths = _verify_case(rng, 2, 4, 20, 4, 2, 8, 8, [9, 13])
    args = [torch.from_numpy(a) for a in (q, k, v, lengths)]
    base = ref.verify_decode_attention_ref(*args, scale=0.3)
    k2, v2 = args[1].clone(), args[2].clone()
    for b, n in enumerate(lengths):
        k2[b, n:] = 1e3
        v2[b, n:] = -1e3
    tail = ref.verify_decode_attention_ref(args[0], k2, v2, args[3],
                                           scale=0.3)
    assert torch.equal(base, tail)


def test_row_stride_accepts_slices_and_refuses_other_layouts():
    cache = torch.zeros(3, 10, 4, 32)
    assert row_stride("k", cache) == 32
    assert row_stride("k", cache[..., :16]) == 32
    assert row_stride("k", torch.zeros(3, 10, 1, 24)[..., :7]) == 24
    for bad in (cache.transpose(1, 2), cache[:, ::2], cache[..., ::2],
                cache[:, :, :2]):
        with pytest.raises(ValueError):
            row_stride("k", bad)


@pytest.mark.parametrize("ranked", [False, True])
@pytest.mark.parametrize("paged", [False, True])
def test_plain_decode_on_strided_views_equals_contiguous(paged, ranked):
    """The plain versions take ``cache[..., :r]`` views as they are;
    their results equal those on contiguous copies of the views."""
    rng = np.random.default_rng(11)
    B, H, KV, dq_c, dv_c, r_q, r_v = 3, 8, 2, 32, 24, 16, 8
    q = torch.from_numpy(rng.standard_normal((B, H, r_q)).astype(
        np.float32))
    lengths = torch.tensor([0, 9, 40], dtype=torch.int32)
    kw = {}
    if ranked:
        kw = dict(qk_ranks=torch.tensor([16, 5], dtype=torch.int32),
                  vo_ranks=torch.tensor([3, 8], dtype=torch.int32))
    if paged:
        N, pt = 12, 4
        kc = torch.from_numpy(rng.standard_normal((N, pt, KV, dq_c)).astype(
            np.float32))
        vc = torch.from_numpy(rng.standard_normal((N, pt, KV, dv_c)).astype(
            np.float32))
        table = torch.from_numpy(rng.integers(0, N, (B, 10)).astype(
            np.int32))
        fn = lambda k, v: ops.paged_decode_attention(  # noqa: E731
            q, k, v, table, lengths, scale=0.2, **kw)
    else:
        kc = torch.from_numpy(rng.standard_normal((B, 40, KV, dq_c)).astype(
            np.float32))
        vc = torch.from_numpy(rng.standard_normal((B, 40, KV, dv_c)).astype(
            np.float32))
        fn = lambda k, v: ops.decode_attention(  # noqa: E731
            q, k, v, lengths, scale=0.2, **kw)
    ks, vs = kc[..., :r_q], vc[..., :r_v]
    assert not ks.is_contiguous() and row_stride("k", ks) == dq_c
    got = fn(ks, vs)
    want = fn(ks.contiguous(), vs.contiguous())
    assert torch.equal(got, want)
    assert torch.equal(got[0], torch.zeros_like(got[0]))   # length 0


# ---------------------------------------------------------------------------
# model entry points: verify_chunk and the draft decode step
# ---------------------------------------------------------------------------

def _states(jcfg, cfg, B, cap, index):
    jst = JT.init_decode_state(jcfg, B, cap)
    jst["index"] = jnp.asarray(index, jnp.int32)
    tst = T.init_decode_state(cfg, B, cap, device=CPU)
    tst["index"] = torch.tensor(index, dtype=torch.int32)
    return jst, tst


def _prefilled(jp, jcfg, tp, cfg, B=3, C=8, cap=32):
    """Both states after one chunk of per-slot lengths (8, 5, 0)."""
    jst, tst = _states(jcfg, cfg, B, cap, [0, 0, 0])
    lengths = np.asarray([8, 5, 0], np.int32)
    toks = _tokens((B, C), 1)
    _, jst = JT.prefill_chunk(jp, jcfg, jnp.asarray(toks), jst,
                              jnp.asarray(lengths))
    _, tst = T.prefill_chunk(tp, cfg, torch.from_numpy(toks), tst,
                             torch.from_numpy(lengths))
    return jst, tst


def _blocks_close(tst, jst):
    for a, b in zip(jax.tree.leaves(to_numpy(tst["blocks"])),
                    jax.tree.leaves(jst["blocks"])):
        _close(a, b)


@pytest.mark.parametrize("name", NAMES)
def test_verify_chunk_matches_jax(models, name):
    """Logits at every window position and the K/V written for all W
    positions at full rank; ``index`` advances by ``lengths``."""
    jp, jcfg, tp, cfg = models[(name, 0.5)]
    jst, tst = _prefilled(jp, jcfg, tp, cfg)
    W = 4
    toks = _tokens((3, W), 2)
    lengths = np.asarray([W, W, 0], np.int32)
    jl, jst = JT.verify_chunk(jp, jcfg, jnp.asarray(toks), jst,
                              jnp.asarray(lengths))
    tl, tst = T.verify_chunk(tp, cfg, torch.from_numpy(toks), tst,
                             torch.from_numpy(lengths))
    assert tl.shape == (3, W, cfg.padded_vocab)
    _close(tl[:2], np.asarray(jl)[:2])
    np.testing.assert_array_equal(tst["index"].numpy(), [12, 9, 0])
    _blocks_close(tst, jst)


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_draft_decode_step_matches_jax(models, name, paged):
    """The draft step at ``draft_ranks(cfg, 0.5)``: logits as the
    reference's, K/V written zero-padded to the cache width, and the
    same on the once-sliced ``draft_params``."""
    jp, jcfg, tp, cfg = models[(name, 0.5)]
    dr = draft_ranks(cfg, 0.5)
    assert dr == jprune.draft_ranks(jcfg, 0.5)
    tok = _tokens((3,), 3)
    if paged:
        N, pt = 10, 4
        jst = JT.init_decode_state_paged(jcfg, 3, N, pt)
        jst["index"] = jnp.asarray([5, 9, 0], jnp.int32)
        tst = T.init_decode_state_paged(cfg, 3, N, pt, device=CPU)
        tst["index"] = torch.tensor([5, 9, 0], dtype=torch.int32)
        rng = np.random.default_rng(4)
        fill = [rng.standard_normal(np.shape(x)).astype(np.float32)
                for x in jax.tree.leaves(jst["blocks"])]
        jst["blocks"] = jax.tree.unflatten(
            jax.tree.structure(jst["blocks"]),
            [jnp.asarray(f) for f in fill])
        tst["blocks"] = from_numpy(jax.tree.map(np.asarray, jst["blocks"]),
                                   CPU)
        table = np.asarray([[0, 1, 2, N], [3, 4, 5, 6], [N] * 4], np.int32)
        jl, jst = JT.decode_step(jp, jcfg, jnp.asarray(tok), jst,
                                 pages=jnp.asarray(table), draft_rank=dr)
        kw = dict(pages=torch.from_numpy(table))
    else:
        jst, tst = _prefilled(jp, jcfg, tp, cfg)
        jl, jst = JT.decode_step(jp, jcfg, jnp.asarray(tok), jst,
                                 draft_rank=dr)
        kw = {}
    before = to_numpy(tst["blocks"])
    dparams = T.draft_params(tp, cfg, dr)
    sliced, _ = T.decode_step(dparams, cfg, torch.from_numpy(tok),
                              {"blocks": from_numpy(before, CPU),
                               "index": tst["index"].clone()},
                              draft_rank=dr, **kw)
    tl, tst = T.decode_step(tp, cfg, torch.from_numpy(tok), tst,
                            draft_rank=dr, **kw)
    _close(tl, jl)
    _close(sliced, tl.numpy(), 1e-6)
    np.testing.assert_array_equal(tst["index"].numpy(),
                                  np.asarray(jst["index"]))
    _blocks_close(tst, jst)
    # the written rows hold zeros past the draft widths
    k = tst["blocks"][0]["kv"]["k"]
    v = tst["blocks"][0]["kv"]["v"]
    if paged:
        for page, off in ((1, 1), (5, 1)):   # slot 0 pos 5, slot 1 pos 9
            assert torch.all(k[:, page, off, :, dr[0]:] == 0)
            assert torch.all(v[:, page, off, :, dr[1]:] == 0)
    else:
        for b, pos in ((0, 8), (1, 5)):
            assert torch.all(k[:, b, pos, :, dr[0]:] == 0)
            assert torch.all(v[:, b, pos, :, dr[1]:] == 0)


def test_full_width_draft_is_the_model(models):
    jp, jcfg, tp, cfg = models[("gpt2-xl", 0.5)]
    _, tst = _prefilled(jp, jcfg, tp, cfg)
    tok = torch.from_numpy(_tokens((3,), 5))
    st2 = {"blocks": from_numpy(to_numpy(tst["blocks"]), CPU),
           "index": tst["index"].clone()}
    a, _ = T.decode_step(tp, cfg, tok, tst)
    b, _ = T.decode_step(tp, cfg, tok, st2,
                         draft_rank=(cfg.qk_dim, cfg.vo_dim))
    _close(a, b.numpy(), 1e-6)


# ---------------------------------------------------------------------------
# engines in lockstep with the JAX engine
# ---------------------------------------------------------------------------

def _prompts(lens, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, n).astype(np.int32) for n in lens]


def _lockstep(jeng, teng, prompts, max_new, **req_kw):
    jreqs = [JS.Request(uid=i, prompt=p, max_new_tokens=max_new, **req_kw)
             for i, p in enumerate(prompts)]
    treqs = [S.Request(uid=i, prompt=p, max_new_tokens=max_new, **req_kw)
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
        assert list(teng.sched.phase) == list(jeng.sched.phase), steps
        np.testing.assert_array_equal(teng.state["index"].numpy(),
                                      np.asarray(jeng.state["index"]))
        assert teng.spec_rounds == jeng.spec_rounds, steps
        assert dict(teng.accept_hist) == dict(jeng.accept_hist), steps
        if teng.alloc is not None:
            teng.alloc.assert_consistent(context=f"step {steps}")
            assert teng.alloc.tables == jeng.alloc.tables, steps
            assert teng.alloc.free_list == jeng.alloc.free_list, steps
            assert teng.alloc.refcount == jeng.alloc.refcount, steps
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    assert teng.steps == jeng.steps
    return treqs


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("prune_ratio", [0.0, 0.5])
@pytest.mark.parametrize("k", [2, 4])
def test_spec_engine_lockstep_with_jax(models, k, prune_ratio, layout):
    jp, jcfg, tp, cfg = models[("gpt2-xl", prune_ratio)]
    kw = dict(slots=3, max_len=40, prefill_chunk=8, spec_k=k,
              draft_rank_ratio=0.5)
    if layout == "paged":
        kw.update(paged=True, page_tokens=4, n_pages=12)    # preempts
    jeng = JS.Engine(jp, jcfg, JS.EngineConfig(**kw))
    teng = S.Engine(tp, cfg, S.EngineConfig(**kw), device=CPU)
    prompts = _prompts((3, 17, 9, 22))
    reqs = _lockstep(jeng, teng, prompts, 8)
    assert teng.spec_rounds > 0 and teng.accepted_per_round >= 1.0
    assert teng.compiled_shapes() == jeng.compiled_shapes() <= 4
    if layout == "paged":
        assert teng.sched.preemptions == jeng.sched.preemptions > 0
    nonspec = S.Engine(tp, cfg, S.EngineConfig(**dict(kw, spec_k=0)),
                       device=CPU)
    plain = [S.Request(uid=i, prompt=p, max_new_tokens=8)
             for i, p in enumerate(prompts)]
    nonspec.run(plain)
    assert [r.generated for r in reqs] == [r.generated for r in plain]


@pytest.mark.parametrize("name", ["stablelm-3b", "phi3-medium-14b"])
def test_spec_engine_rope_modes_lockstep(models, name):
    """partial (stablelm) and intra (phi3) drafts, dense, k = 3."""
    jp, jcfg, tp, cfg = models[(name, 0.5)]
    kw = dict(slots=2, max_len=32, prefill_chunk=8, spec_k=3)
    jeng = JS.Engine(jp, jcfg, JS.EngineConfig(**kw))
    teng = S.Engine(tp, cfg, S.EngineConfig(**kw), device=CPU)
    assert teng.exe.draft_rank == jeng.exe.draft_rank
    reqs = _lockstep(jeng, teng, _prompts((5, 11, 7), seed=2), 6)
    for r, p in zip(reqs, _prompts((5, 11, 7), seed=2)):
        assert r.generated == S.greedy_reference(tp, cfg, p, 6, device=CPU)


def test_spec_engine_full_rank_draft_accepts_everything(models):
    jp, jcfg, tp, cfg = models[("gpt2-xl", 0.5)]
    prompt = np.arange(6, dtype=np.int32) + 3
    k = 3
    kw = dict(slots=1, max_len=32, prefill_chunk=4, spec_k=k,
              draft_rank_ratio=0.0)
    teng = S.Engine(tp, cfg, S.EngineConfig(**kw), device=CPU)
    assert teng.exe.draft_rank is None
    jeng = JS.Engine(jp, jcfg, JS.EngineConfig(**kw))
    reqs = _lockstep(jeng, teng, [prompt], 1 + 2 * (k + 1))
    assert reqs[0].generated == S.greedy_reference(tp, cfg, prompt,
                                                   1 + 2 * (k + 1),
                                                   device=CPU)
    assert teng.accepted_per_round == k + 1
    assert dict(teng.accept_hist) == {k + 1: 2}


def test_spec_engine_eos_mid_round_truncates(models):
    jp, jcfg, tp, cfg = models[("gpt2-xl", 0.5)]
    prompt = np.arange(8, dtype=np.int32) + 17
    want = S.greedy_reference(tp, cfg, prompt, 8, device=CPU)
    eos = next(t for i, t in enumerate(want) if i >= 1
               and t not in want[:i])
    stop = want.index(eos) + 1
    kw = dict(slots=1, max_len=32, prefill_chunk=4, eos_id=eos, spec_k=4,
              draft_rank_ratio=0.0)
    jeng = JS.Engine(jp, jcfg, JS.EngineConfig(**kw))
    teng = S.Engine(tp, cfg, S.EngineConfig(**kw), device=CPU)
    reqs = _lockstep(jeng, teng, [prompt], 8)
    assert reqs[0].done and reqs[0].generated == want[:stop]


def test_spec_engine_near_capacity(models):
    """The stream ends at max_len: the verify window's rejected tail
    overhangs the committed length inside the capacity's spare room."""
    jp, jcfg, tp, cfg = models[("gpt2-xl", 0.5)]
    prompt = np.arange(10, dtype=np.int32) + 2
    for paged in (False, True):
        kw = dict(slots=1, max_len=16, prefill_chunk=4, spec_k=5,
                  draft_rank_ratio=0.0)
        if paged:
            kw.update(paged=True, page_tokens=4)
        jeng = JS.Engine(jp, jcfg, JS.EngineConfig(**kw))
        teng = S.Engine(tp, cfg, S.EngineConfig(**kw), device=CPU)
        reqs = _lockstep(jeng, teng, [prompt], 6)       # 10 + 6 = 16
        assert reqs[0].generated == S.greedy_reference(tp, cfg, prompt, 6,
                                                       device=CPU)


def test_spec_engine_temperature_falls_back(models):
    _, _, tp, cfg = models[("gpt2-xl", 0.5)]
    eng = S.Engine(tp, cfg, S.EngineConfig(slots=1, max_len=32,
                                           prefill_chunk=4, spec_k=3),
                   device=CPU)
    req = S.Request(uid=0, prompt=np.arange(4, dtype=np.int32) + 5,
                    max_new_tokens=5, temperature=0.8)
    eng.run([req])
    assert req.done and len(req.generated) == 5
    assert eng.spec_rounds == 0


@pytest.mark.parametrize("name", ["rwkv6-1.6b", "jamba-v0.1-52b"])
def test_spec_refused_on_recurrent_arch(name):
    cfg = get_config(name).reduced()
    params = T.init_lm_params(cfg, 0, device=CPU)
    with pytest.raises(ValueError, match="attention-only"):
        S.Engine(params, cfg, S.EngineConfig(slots=1, max_len=16,
                                             spec_k=2), device=CPU)
    with pytest.raises(ValueError, match="attention-only"):
        JS.Engine(jax_init(jax_config(name).reduced(),
                           jax.random.PRNGKey(0)),
                  jax_config(name).reduced(),
                  JS.EngineConfig(slots=1, max_len=16, spec_k=2))


def test_spec_engine_rank_budget_lockstep(models):
    """A spectrum plan (the reference's, on shared spectra) applied by
    each side, served with spec_k = 2 on a paged engine: the draft
    clamps the plan's ranks to its widths, in lockstep with the JAX
    engine."""
    jp, jcfg, _, cfg = models[("gpt2-xl", 0.0)]
    attn = dict(jp["blocks"][0]["attn"])
    i, h = np.meshgrid(np.arange(2), np.arange(4), indexing="ij")
    damp = jnp.asarray(np.where((i + h) % 2, 0.25, 1.0), jnp.float32)
    attn["wq"] = attn["wq"] * damp[:, None, :, None]
    attn["wv"] = attn["wv"] * damp[:, None, :, None]
    jp = {**jp, "blocks": ({**jp["blocks"][0], "attn": attn},)}
    jd, jdc, jex = jax_decompose(jp, jcfg, peft=False)
    shared = [{"spectra": {k: np.asarray(v) for k, v in
                           ex["spectra"].items()}} for ex in jex]
    jplan = jprune.plan_rank_budget(shared, jdc, budget=0.5)
    plan = budget_from_fields(jplan.head_dim, jplan.rank_multiple,
                              jplan.total_rank, jplan.budget,
                              jplan.qk_ranks, jplan.vo_ranks)
    bjp, bjc = jprune.apply_rank_budget(jd, jdc, jplan)
    tdc = dataclasses.replace(cfg, clover=dataclasses.replace(
        cfg.clover, enabled=True))
    btp, btc = prune.apply_rank_budget(
        from_numpy(jax.tree.map(np.asarray, jd), CPU), tdc, plan)
    kw = dict(slots=2, max_len=24, prefill_chunk=4, paged=True,
              page_tokens=4, spec_k=2)
    jeng = JS.Engine(bjp, bjc, JS.EngineConfig(rank_budget=jplan, **kw))
    teng = S.Engine(btp, btc, S.EngineConfig(rank_budget=plan, **kw),
                    device=CPU)
    prompts = _prompts((6, 11, 3), seed=2)
    reqs = _lockstep(jeng, teng, prompts, 6)
    assert teng.spec_rounds > 0
    for r, p in zip(reqs, prompts):
        assert r.generated == S.greedy_reference(btp, btc, p, 6, device=CPU)
