"""RoPE and the dense GQA configs in the port against the JAX package, on
the same (numpy-bridged) weights at reduced size (2 layers, d_model 128,
head_dim 32): stablelm-3b (partial RoPE, 8 of 32 dims rotated, "partial"
CLOVER mode), phi3-medium-14b (full RoPE, G = 4, "intra" mode),
minitron-4b held at G = 3 and deepseek-coder-33b at G = 7 (theta 1e5)
through ``reduced`` overrides.

Tolerances: 1e-6 on the rotary tables and rotations (float32
elementwise); atol 1e-4 on logits and caches (float32 matmuls summed in
another order through two layers, as ``tests/test_torch_model.py``);
1e-5 on spectra and on the Q K^T / V O products; 1e-4 relative on the
train step's losses and merged weights (as ``tests/test_torch_train.
py``).  SVD factors agree only up to sign, so ``k_t`` is compared by
its row norms (the singular values, 1e-5), its Gram matrix ``k_t^T k_t
= wk^T wk`` (1e-5) and its absolute values (1e-4).
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

from repro import optim as JO  # noqa: E402
from repro import serve as JS  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import clover_decompose as jax_decompose  # noqa: E402
from repro.core import clover_prune as jax_prune  # noqa: E402
from repro.core import merge_clover as jax_merge  # noqa: E402
from repro.core import prune as jprune  # noqa: E402
from repro.core.decompose import qk_mode as jax_qk_mode  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.models import init_lm_params as jax_init  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.train import step as JST  # noqa: E402
from repro_torch import optim as O  # noqa: E402
from repro_torch import serve as S  # noqa: E402
from repro_torch.bridge import budget_from_fields, from_numpy, to_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import peft, prune  # noqa: E402
from repro_torch.core.decompose import (clover_decompose,  # noqa: E402
                                        decompose_attention, merge_clover,
                                        qk_mode)
from repro_torch.core.prune import clover_prune  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.train import step as ST  # noqa: E402
from repro_torch.tree import tree_leaves_with_path  # noqa: E402

CPU = "cpu"
ROPE_TOL = 1e-6
ATOL = 1e-4
SPEC_TOL = 1e-5
RTOL = 1e-4

# reduced() gives n_kv_heads = max(1, 4 * KV // H): minitron's G = 3 and
# deepseek's G = 7 would both become G = 4, so they are held by overrides
OVER = {"stablelm-3b": {}, "phi3-medium-14b": {},
        "minitron-4b": dict(n_heads=6, n_kv_heads=2),
        "deepseek-coder-33b": dict(n_heads=7, n_kv_heads=1)}
# (qk_mode, rope_dims, G) at reduced size
SHAPE = {"stablelm-3b": ("partial", 8, 1), "phi3-medium-14b": ("intra", 32, 4),
         "minitron-4b": ("intra", 32, 3),
         "deepseek-coder-33b": ("intra", 32, 7)}


def _pair(name, seed):
    jcfg = jax_config(name).reduced(**OVER[name])
    cfg = get_config(name).reduced(**OVER[name])
    jp = jax_init(jcfg, jax.random.PRNGKey(seed))
    return jp, jcfg, from_numpy(jax.tree.map(np.asarray, jp), CPU), cfg


@pytest.fixture(scope="module")
def models():
    """{name: (jax params, jax cfg, port params, port cfg)}."""
    return {name: _pair(name, i + 1) for i, name in enumerate(OVER)}


def _tokens(shape, seed=0, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _close(got, want, atol=ATOL):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=0)


def _rel_close(got, want, rtol):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.max(np.abs(want))), 1e-30)
    assert float(np.max(np.abs(got.astype(np.float64) - want))) <= \
        rtol * scale


def _logits(params, cfg, toks):
    return T.forward(params, cfg, toks, device=CPU)[0]


def _jlogits(params, cfg, toks):
    return JT.forward(params, cfg, jnp.asarray(toks))[0]


# ---------------------------------------------------------------------------
# configs and the rotation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(OVER))
def test_config_copies_match_reference(name):
    for reduce in (False, True):
        jcfg, cfg = jax_config(name), get_config(name)
        if reduce:
            jcfg, cfg = (c.reduced(**OVER[name]) for c in (jcfg, cfg))
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert (qk_mode(cfg), cfg.rope_dims, cfg.q_per_kv) == \
            (jax_qk_mode(jcfg), jcfg.rope_dims, jcfg.q_per_kv)
        # the port's count is exact; the reference's leaves out the final
        # norm and the layernorm biases
        norm = 2 if cfg.norm == "layernorm" else 1
        missed = cfg.d_model * (norm + (2 * cfg.n_layers if norm == 2
                                        else 0))
        assert cfg.n_params() == jcfg.n_params() + missed
    assert SHAPE[name] == (qk_mode(cfg), cfg.rope_dims, cfg.q_per_kv)
    leaves = jax.tree.leaves(jax_init(jcfg, jax.random.PRNGKey(0)))
    assert cfg.n_params() == sum(int(a.size) for a in leaves)


@pytest.mark.parametrize("rot,theta", [(8, 1e4), (32, 1e4), (32, 1e5)])
def test_rope_tables_and_rotation_match(rot, theta):
    """Per-slot (B, S) positions; rot 8 of 32 passes a 24-dim tail
    through, rot 32 rotates all of it."""
    rng = np.random.default_rng(rot)
    pos = rng.integers(0, 3000, (3, 5)).astype(np.int32)
    x = rng.standard_normal((3, 5, 4, 32)).astype(np.float32)
    jc, js = JL.rope_tables(jnp.asarray(pos), rot, theta)
    tc, ts = L.rope_tables(torch.from_numpy(pos).long(), rot, theta)
    assert tc.shape == (3, 5, rot // 2) and tc.dtype == torch.float32
    _close(tc, jc, ROPE_TOL)
    _close(ts, js, ROPE_TOL)
    got = L.apply_rope(torch.from_numpy(x), tc, ts, rot)
    _close(got, JL.apply_rope(jnp.asarray(x), jc, js, rot), ROPE_TOL)
    assert torch.equal(got[..., rot:], torch.from_numpy(x)[..., rot:])


@pytest.mark.parametrize("name", list(OVER))
def test_forward_logits_match(models, name):
    jp, jcfg, tp, cfg = models[name]
    toks = _tokens((2, 40), 3)
    got = _logits(tp, cfg, toks)
    _close(got, _jlogits(jp, jcfg, toks))
    # RoPE is live: scoring depends on where the tokens sit
    shifted = T.forward(tp, cfg, toks[:, 1:], device=CPU)[0]
    assert not torch.allclose(shifted[:, 0], got[:, 1], atol=1e-3)


@pytest.mark.parametrize("name", ["stablelm-3b", "phi3-medium-14b"])
def test_chunk_and_decode_states_match(models, name):
    """Per-slot chunk windows (full, partial, idle) then a decode step on
    a dense cache: logits and every cache row agree (K post-RoPE)."""
    jp, jcfg, tp, cfg = models[name]
    B, C, cap = 3, 8, 32
    jst = JT.init_decode_state(jcfg, B, cap)
    jst["index"] = jnp.asarray([0, 5, 2], jnp.int32)
    tst = T.init_decode_state(cfg, B, cap, device=CPU)
    tst["index"] = torch.tensor([0, 5, 2], dtype=torch.int32)
    lengths = np.asarray([8, 3, 0], np.int32)
    toks = _tokens((B, C), 1)
    jl, jst = JT.prefill_chunk(jp, jcfg, jnp.asarray(toks), jst,
                               jnp.asarray(lengths))
    tl, tst = T.prefill_chunk(tp, cfg, torch.from_numpy(toks), tst,
                              torch.from_numpy(lengths))
    _close(tl.numpy()[:2], np.asarray(jl)[:2])
    tok = _tokens((B,), 2)
    jl, jst = JT.decode_step(jp, jcfg, jnp.asarray(tok), jst)
    tl, tst = T.decode_step(tp, cfg, torch.from_numpy(tok), tst)
    _close(tl, jl)
    for a, b in zip(jax.tree.leaves(to_numpy(tst["blocks"])),
                    jax.tree.leaves(jst["blocks"])):
        _close(a, b)


# ---------------------------------------------------------------------------
# decompose / merge / prune
# ---------------------------------------------------------------------------

def _attn0(tree):
    return {k: np.asarray(v, np.float64) for k, v in
            to_numpy(tree["blocks"][0]["attn"]).items()} \
        if isinstance(tree["blocks"][0]["attn"]["wq"], torch.Tensor) else \
        {k: np.asarray(v, np.float64) for k, v in
         tree["blocks"][0]["attn"].items()}


def _products(attn):
    """Per-head Q K^T (with the transitions folded) and V O products."""
    wq, wk, wv, wo = (attn[k] for k in ("wq", "wk", "wv", "wo"))
    if "s_qk" in attn:
        wq = np.einsum("ldhq,lhqr->ldhr", wq, attn["s_qk"])
    if "k_t" in attn:
        wk = np.einsum("ldkq,lkqr->ldkr", wk, attn["k_t"])
    if "s_vo" in attn:
        wo = np.einsum("lhvw,lhwd->lhvd", attn["s_vo"], wo)
    G = wq.shape[2] // wk.shape[2]
    qk = np.einsum("ldhq,lehq->lhde", wq, np.repeat(wk, G, axis=2))
    vo = np.einsum("ldhv,lhve->lhde", np.repeat(wv, G, axis=2), wo)
    return qk, vo


@pytest.mark.parametrize("peft_mode", [False, True])
@pytest.mark.parametrize("name", ["stablelm-3b", "phi3-medium-14b"])
def test_decompose_and_merge_match(models, name, peft_mode):
    jp, jcfg, tp, cfg = models[name]
    mode, rot, G = SHAPE[name]
    jd, jdc, jex = jax_decompose(jp, jcfg, peft=peft_mode)
    td, tdc, tex = clover_decompose(tp, cfg, peft=peft_mode)
    assert dataclasses.asdict(tdc) == dataclasses.asdict(jdc)
    # spectra: partial covers the (32 - 8) tail; intra has no Q-K one
    assert set(tex[0]["spectra"]) == set(jex[0]["spectra"]) == \
        ({"vo"} if mode == "intra" else {"qk", "vo"})
    for fam, sp in tex[0]["spectra"].items():
        _close(sp, jex[0]["spectra"][fam], SPEC_TOL)
    if mode == "partial":
        assert tex[0]["spectra"]["qk"].shape == (2, 4, 32 - rot)
    layer0 = {k: v[0] for k, v in tp["blocks"][0]["attn"].items()}
    assert (decompose_attention(layer0, cfg, peft=peft_mode)[2]["qk"]
            is None) == (mode == "intra")

    toks = _tokens((2, 24), 7)
    base = _logits(tp, cfg, toks)
    got = _logits(td, tdc, toks)
    _close(got, base)                       # the function is preserved
    _close(got, _jlogits(jd, jdc, toks))
    tq, tv = _products(_attn0(td))
    jq, jv = _products(_attn0(jd))
    _close(tq, jq, SPEC_TOL)
    _close(tv, jv, SPEC_TOL)

    ta, ja = td["blocks"][0]["attn"], jd["blocks"][0]["attn"]
    if not peft_mode:
        if mode == "intra":     # Q-K untouched: no spectrum, no pruning
            assert ta["wq"] is tp["blocks"][0]["attn"]["wq"]
            assert ta["wk"] is tp["blocks"][0]["attn"]["wk"]
        return
    if mode == "partial":
        s = ta["s_qk"]                               # (nb, H, 32, 32)
        eye = torch.eye(rot).expand(2, 4, rot, rot)
        assert torch.equal(s[..., :rot, :rot], eye)
        assert not s[..., :rot, rot:].any() and not s[..., rot:, :rot].any()
        tail = tex[0]["spectra"]["qk"].repeat_interleave(G, dim=1)
        _close(torch.diagonal(s[..., rot:, rot:], dim1=-2, dim2=-1), tail,
               0.0)
        _close(s, ja["s_qk"], SPEC_TOL)
        # the rotated head block of wq / wk passes through bitwise
        for w in ("wq", "wk"):
            assert torch.equal(ta[w][..., :rot],
                               tp["blocks"][0]["attn"][w][..., :rot])
    else:
        assert "s_qk" not in ta and "k_t" in ta
        assert ta["wq"] is tp["blocks"][0]["attn"]["wq"]   # wq untouched
        kt = ta["k_t"].double()
        assert kt.shape == (2, 1, 32, 32)
        jkt = np.asarray(ja["k_t"], np.float64)
        # rows are S_i v_i: their norms are wk's singular values; the
        # directions of near-equal singular values are less well
        # conditioned, so the entries are held at the logits' ATOL
        _close(kt.norm(dim=-1), np.linalg.norm(jkt, axis=-1), SPEC_TOL)
        _close(kt.abs(), np.abs(jkt), ATOL)
        wk = tp["blocks"][0]["attn"]["wk"].double()
        gram = torch.einsum("lkqr,lkqs->lkrs", kt, kt)
        _close(gram, torch.einsum("ldkr,ldks->lkrs", wk, wk), SPEC_TOL)
    # merge_clover folds the transitions (k_t into wk) back: the base's
    # function and its exact parameter count
    tm, tmc = merge_clover(td, tdc)
    jm, jmc = jax_merge(jd, jdc)
    assert dataclasses.asdict(tmc) == dataclasses.asdict(jmc)
    assert not {"s_qk", "k_t", "s_vo"} & set(tm["blocks"][0]["attn"])
    assert peft.count_params(tm) == peft.count_params(tp) == cfg.n_params()
    _close(_logits(tm, tmc, toks), base)
    if mode == "intra":     # wk @ k_t is the base's wk again
        _close(tm["blocks"][0]["attn"]["wk"], tp["blocks"][0]["attn"]["wk"],
               SPEC_TOL)


@pytest.mark.parametrize("name", ["stablelm-3b", "phi3-medium-14b"])
def test_prune_keeps_what_rope_needs(models, name):
    """Partial: the rotated block [:rot] is kept bitwise and only the
    tail shrinks; intra: Q-K keeps its full width, V-O is pruned."""
    jp, jcfg, tp, cfg = models[name]
    mode, rot, _ = SHAPE[name]
    jd, jdc, _ = jax_decompose(jp, jcfg, peft=False)
    td, tdc, _ = clover_decompose(tp, cfg)
    jpp, jpc = jax_prune(jd, jdc, qk_ratio=0.5, vo_ratio=0.5)
    tpp, tpc = clover_prune(td, tdc, qk_ratio=0.5, vo_ratio=0.5)
    assert dataclasses.asdict(tpc) == dataclasses.asdict(jpc)
    a, a0 = tpp["blocks"][0]["attn"], tp["blocks"][0]["attn"]
    if mode == "partial":
        assert (tpc.qk_dim, tpc.vo_dim) == (rot + 16, 16)
        for w in ("wq", "wk"):
            assert torch.equal(a[w][..., :rot], a0[w][..., :rot])
    else:
        assert (tpc.qk_dim, tpc.vo_dim) == (32, 16)
        assert torch.equal(a["wq"], a0["wq"])
        assert torch.equal(a["wk"], a0["wk"])
    toks = _tokens((2, 24), 8)
    _close(_logits(tpp, tpc, toks), _jlogits(jpp, jpc, toks))


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pruned(models):
    """{name: (jax, jax cfg, port, port cfg)} decomposed and pruned
    0.5 / 0.5 on each side."""
    out = {}
    for name in ("stablelm-3b", "phi3-medium-14b"):
        jp, jcfg, tp, cfg = models[name]
        jd, jdc, _ = jax_decompose(jp, jcfg, peft=False)
        td, tdc, _ = clover_decompose(tp, cfg)
        out[name] = (*jax_prune(jd, jdc, qk_ratio=0.5, vo_ratio=0.5),
                     *clover_prune(td, tdc, qk_ratio=0.5, vo_ratio=0.5))
    return out


def _prompts(lens, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, n).astype(np.int32) for n in lens]


def _lockstep(jeng, teng, prompts, max_new, uid0=0):
    """Step both engines together; allocator (and trie) histories and
    phase/position histories identical every step."""
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
        assert list(teng.sched.phase) == list(jeng.sched.phase), steps
        assert list(teng.sched.pos) == list(jeng.sched.pos), steps
        if teng.alloc is not None:
            teng.alloc.assert_consistent(teng.prefix, context=f"{steps}")
            assert teng.alloc.tables == jeng.alloc.tables, steps
            assert teng.alloc.free_list == jeng.alloc.free_list, steps
            assert teng.alloc.refcount == jeng.alloc.refcount, steps
        if teng.prefix is not None:
            assert teng.prefix.nodes == jeng.prefix.nodes, steps
    assert all(r.done for r in treqs)
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    assert teng.steps == jeng.steps
    return treqs


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("name", ["stablelm-3b", "phi3-medium-14b"])
def test_engine_matches_jax_engine_and_reference(pruned, name, layout):
    jp, jcfg, tp, cfg = pruned[name]
    kw = dict(slots=3, max_len=40, prefill_chunk=8)
    if layout == "paged":
        kw.update(paged=True, page_tokens=4, n_pages=8)    # preempts
    jeng = JS.Engine(jp, jcfg, JS.EngineConfig(**kw))
    teng = S.Engine(tp, cfg, S.EngineConfig(**kw), device=CPU)
    prompts = _prompts((3, 17, 9, 22))
    reqs = _lockstep(jeng, teng, prompts, 5)
    assert teng.compiled_shapes() == jeng.compiled_shapes() == 2
    # caches hold K at the pruned Q-K width: 8 + 16 (partial), 32 (intra)
    width = teng.state["blocks"][0]["kv"]["k"].shape[-1]
    assert width == cfg.qk_dim == (24 if name == "stablelm-3b" else 32)
    if layout == "paged":
        assert teng.sched.preemptions == jeng.sched.preemptions > 0
    for r, p in zip(reqs, prompts):
        assert r.generated == S.greedy_reference(tp, cfg, p, 5, device=CPU)


def test_prefix_engine_matches_jax_engine(pruned):
    """stablelm: a shared system prompt at the same absolute positions
    (so its post-RoPE pages stay valid), a page-aligned full hit
    (copy-on-write), an undersized pool."""
    jp, jcfg, tp, cfg = pruned["stablelm-3b"]
    kw = dict(slots=3, max_len=48, prefill_chunk=8, paged=True,
              page_tokens=4, n_pages=16, prefix_cache=True)
    jeng = JS.Engine(jp, jcfg, JS.EngineConfig(**kw))
    teng = S.Engine(tp, cfg, S.EngineConfig(**kw), device=CPU)
    rng = np.random.default_rng(5)
    sys_p = rng.integers(0, 512, 12).astype(np.int32)     # 3 full pages
    _lockstep(jeng, teng, [sys_p], 6)
    burst = [np.concatenate([sys_p, rng.integers(0, 512, n).astype(
        np.int32)]) for n in (9, 13, 5)] + [sys_p.copy()]
    reqs = _lockstep(jeng, teng, burst, 8, uid0=10)
    assert teng.sched.prefix_hits == jeng.sched.prefix_hits >= 4
    assert [r.cached_tokens for r in reqs][3] == 11   # full hit: L - 1
    assert teng.compiled_shapes() == jeng.compiled_shapes() == 3
    for r, p in zip(reqs, burst):
        assert r.generated == S.greedy_reference(tp, cfg, p, 8, device=CPU)


def _bitwise(tree, jtree):
    """Port and JAX trees equal leaf for leaf, matched by keystr path."""
    want = {jax.tree_util.keystr(p): np.asarray(x) for p, x in
            jax.tree_util.tree_flatten_with_path(jtree)[0]}
    got = dict(tree_leaves_with_path(to_numpy(tree)))
    assert set(got) == set(want)
    for path, a in got.items():
        assert np.array_equal(a, want[path]), path


def test_partial_rope_rank_budget_engine(models):
    """A half-capacity plan on stablelm's partial-RoPE spectra (planned
    by the reference, on shared spectra): every Q-K rank keeps the
    rotated block; applied by each side to the same JAX-decomposed
    weights (bitwise), served by a dense engine in lockstep with the JAX
    engine and equal to the budgeted model's greedy_reference."""
    jp, jcfg, _, cfg = models["stablelm-3b"]
    rot = cfg.rope_dims
    # random weights have flat spectra (every plan uniform): damp head h
    # of layer i by 0.25 in wq and wv where i + h is odd
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
    qk = [r for b in jplan.qk_ranks[0] for r in b]
    assert min(qk) >= rot + 1 and len(set(qk)) > 1     # non-uniform
    plan = budget_from_fields(jplan.head_dim, jplan.rank_multiple,
                              jplan.total_rank, jplan.budget,
                              jplan.qk_ranks, jplan.vo_ranks)
    assert prune.plan_rank_budget(shared, jdc, budget=0.5) == plan
    bjp, bjc = jprune.apply_rank_budget(jd, jdc, jplan)
    tdc = dataclasses.replace(cfg, clover=dataclasses.replace(
        cfg.clover, enabled=True))
    btp, btc = prune.apply_rank_budget(
        from_numpy(jax.tree.map(np.asarray, jd), CPU), tdc, plan)
    assert dataclasses.asdict(btc) == dataclasses.asdict(bjc)
    _bitwise(btp, bjp)
    # on a CLOVER-S tree the transitions are masked too (rows and
    # columns): bitwise the reference's
    jpd, jpdc, _ = jax_decompose(jp, jcfg, peft=True)
    tpd = from_numpy(jax.tree.map(np.asarray, jpd), CPU)
    tpdc = dataclasses.replace(tdc, clover=dataclasses.replace(
        tdc.clover, finetune_s=True))
    _bitwise(prune.apply_rank_budget(tpd, tpdc, plan)[0],
             jprune.apply_rank_budget(jpd, jpdc, jplan)[0])
    kw = dict(slots=2, max_len=24, prefill_chunk=4)
    jeng = JS.Engine(bjp, bjc, JS.EngineConfig(rank_budget=jplan, **kw))
    teng = S.Engine(btp, btc, S.EngineConfig(rank_budget=plan, **kw),
                    device=CPU)
    prompts = _prompts((6, 11, 3), seed=2)
    reqs = _lockstep(jeng, teng, prompts, 4)
    for r, p in zip(reqs, prompts):
        assert r.generated == S.greedy_reference(btp, btc, p, 4, device=CPU)


def test_intra_rank_budget_masks_peft_tree_per_query_head():
    """phi3 held at 8 heads over 2 (G = 4, intra): the reference cannot mask a CLOVER-S tree's
    ``s_vo`` for 1 < KV < H, so the port masks it per query head, each
    head by its KV head's kept rank.  The mask is held to an explicit
    repeat of the KV-head ranks, and the masked CLOVER-S tree, merged,
    gives the logits of the masked plain decomposition (ATOL)."""
    cfg = get_config("phi3-medium-14b").reduced(n_heads=8, n_kv_heads=2)
    tp = T.init_lm_params(cfg, seed=7, device=CPU)
    G = cfg.q_per_kv
    # damp V-O of KV head k of layer i by 0.25 where i + k is odd (random
    # weights have flat spectra: every plan would be uniform)
    attn = dict(tp["blocks"][0]["attn"])
    nb, KV = attn["wv"].shape[0], cfg.n_kv_heads
    damp = torch.tensor(np.where(np.add.outer(np.arange(nb),
                                              np.arange(KV)) % 2, 0.25, 1.0),
                        dtype=torch.float32)
    attn["wv"] = attn["wv"] * damp[:, None, :, None]
    tp = {**tp, "blocks": ({**tp["blocks"][0], "attn": attn},)}
    dp, dcfg, ex = clover_decompose(tp, cfg, peft=False)
    # intra Q-K is a mandatory full-width allocation (half the capacity)
    plan = prune.plan_rank_budget(ex, dcfg, budget=0.75)
    vo = np.asarray(plan.vo_ranks[0])                       # (nb, KV)
    assert len(set(vo.ravel().tolist())) > 1                # non-uniform
    assert {r for b in plan.qk_ranks[0] for r in b} == {cfg.head_dim_}
    bp, bcfg = prune.apply_rank_budget(dp, dcfg, plan)
    sp, scfg, _ = clover_decompose(tp, cfg, peft=True)
    bsp, bscfg = prune.apply_rank_budget(sp, scfg, plan)
    s_vo = bsp["blocks"][0]["attn"]["s_vo"].numpy()         # (nb, H, d, d)
    keep = np.arange(s_vo.shape[-1]) < np.repeat(vo, G, axis=1)[..., None]
    want = (sp["blocks"][0]["attn"]["s_vo"].numpy()[..., :s_vo.shape[-1],
                                                   :s_vo.shape[-1]]
            * keep[..., :, None] * keep[..., None, :])
    assert np.array_equal(s_vo, want)
    merged, mcfg = merge_clover(bsp, bscfg)
    toks = _tokens((2, 9), seed=5, vocab=cfg.vocab_size)
    _close(_logits(merged, mcfg, toks), _logits(bp, bcfg, toks))


# ---------------------------------------------------------------------------
# CLOVER-S training with the intra-layer K transition
# ---------------------------------------------------------------------------

def _batch(cfg, i):
    rng = np.random.default_rng(20 + i)
    return {k: rng.integers(0, cfg.vocab_size, (4, 10)).astype(np.int32)
            for k in ("tokens", "labels")}


def test_clover_s_step_with_k_t(models):
    """phi3 (intra): three CLOVER-S steps from the reference's peft
    decomposition; ``k_t`` and ``s_vo`` (and ``up_t``) move, every other
    leaf stays bitwise; losses and the merged weights match."""
    jp, jcfg, _, cfg = models["phi3-medium-14b"]
    jd, jdc, _ = jax_decompose(jp, jcfg, peft=True)
    td = from_numpy(jax.tree.map(np.asarray, jd), CPU)
    dcfg = dataclasses.replace(cfg, clover=dataclasses.replace(
        cfg.clover, enabled=True, finetune_s=True))
    assert dataclasses.asdict(dcfg) == dataclasses.asdict(jdc)
    ocfg = dict(lr=3e-3, weight_decay=0.1, grad_clip=1.0)
    kw = dict(warmup_steps=1, total_steps=3, remat=True, peft_mode=True)
    jstep, _ = JST.make_train_step(
        jdc, JST.TrainConfig(optimizer=JO.AdamWConfig(**ocfg), **kw),
        make_host_mesh())
    jstep = jax.jit(jstep)
    tstep = ST.make_train_step(
        dcfg, ST.TrainConfig(optimizer=O.AdamWConfig(**ocfg), **kw),
        device=CPU)
    jo = JST.make_opt_state(jd, peft_mode=True)
    to = ST.make_opt_state(td, peft_mode=True)
    tp = td
    for i in range(3):
        b = _batch(cfg, i)
        jd, jo, jm = jstep(jd, jo, {k: jnp.asarray(v) for k, v in b.items()})
        tp, to, tm = tstep(tp, to, b)
        for k in ("loss", "grad_norm"):
            _rel_close(tm[k], jm[k], RTOL)
    before = dict(tree_leaves_with_path(td))
    moved = {p for p, leaf in tree_leaves_with_path(tp)
             if not torch.equal(leaf, before[p])}
    assert moved == {p for p in before
                     if any(f"['{k}']" in p for k in ("k_t", "s_vo",
                                                      "up_t"))}
    assert any("['k_t']" in p for p in moved)
    tm_, _ = merge_clover(tp, dcfg)
    jm_, _ = jax_merge(jd, jdc)
    want = {jax.tree_util.keystr(p): np.asarray(x) for p, x in
            jax.tree_util.tree_flatten_with_path(jm_)[0]}
    got = dict(tree_leaves_with_path(tm_))
    assert set(got) == set(want)
    for path, leaf in got.items():
        _rel_close(leaf, want[path], RTOL)
