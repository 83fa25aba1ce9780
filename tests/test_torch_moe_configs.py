"""The RoPE MoEs qwen2-moe-a2.7b and granite-moe-1b-a400m in the port
against the JAX package, the config copies of the last four reference
configs, and ``configs/shapes.py``.

Reduced sizes (2 layers, d_model 128, head_dim 32): qwen2 at 4 heads over
4 KV heads (G = 1) with 4 experts top-2 and 1 shared expert, granite at
4 heads over 2 (G = 2) with 4 experts top-2, tied embeddings; both full
RoPE ("intra" CLOVER mode).  ``reduced()`` cuts every MoE to 4 experts
top-2, so the routing is also held at the PUBLISHED expert counts on a
narrow width: qwen2's 60 routed experts (padded to 64: 4 dead ones) top-4
with 4 shared, granite's 32 top-8.  Weights cross as numpy arrays through
the port's bridge.  The engines are dropless (``capacity_factor`` 0, as
the reference's own MoE engine tests run them).

Tolerances: 1e-5 on the MoE output and aux losses (experts run on
gathered rows instead of capacity buffers: float32 sums in another
order), atol 1e-4 on logits and caches (float32 through two layers,
summed in another order), 1e-5 on the Q K^T / V O products.
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

from repro import configs as JC  # noqa: E402
from repro import serve as JS  # noqa: E402
from repro.core import clover_decompose as jax_decompose  # noqa: E402
from repro.core import clover_prune as jax_prune  # noqa: E402
from repro.core.decompose import qk_mode as jax_qk_mode  # noqa: E402
from repro.models import init_lm_params as jax_init  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import configs as C  # noqa: E402
from repro_torch import serve as S  # noqa: E402
from repro_torch.bridge import from_numpy, to_numpy  # noqa: E402
from repro_torch.core.decompose import clover_decompose, qk_mode  # noqa: E402
from repro_torch.core.prune import clover_prune  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

CPU = "cpu"
ATOL = 1e-4
MOE_TOL = 1e-5
SPEC_TOL = 1e-5

MOES = ("qwen2-moe-a2.7b", "granite-moe-1b-a400m")
NEW = MOES + ("musicgen-large", "internvl2-2b")
# the port's exact parameter counts at full size
N_PARAMS = {"qwen2-moe-a2.7b": 15_146_256_384,
            "granite-moe-1b-a400m": 1_334_628_352,
            "musicgen-large": 2_424_705_024,
            "internvl2-2b": 1_889_146_880}
# (qk_mode, G) at reduced size
SHAPE = {"qwen2-moe-a2.7b": ("intra", 1), "granite-moe-1b-a400m": ("intra", 2)}
# the published routing: (routed experts, top-k, shared experts, padded)
PUBLISHED = {"qwen2-moe-a2.7b": (60, 4, 4, 64),
             "granite-moe-1b-a400m": (32, 8, 0, 32)}


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=atol, rtol=0)


def _dropless(cfg):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=0.0))


def _pair(name, seed, **over):
    jcfg = JC.get_config(name).reduced(**over)
    cfg = C.get_config(name).reduced(**over)
    jp = jax_init(jcfg, jax.random.PRNGKey(seed))
    return jp, jcfg, from_numpy(jax.tree.map(np.asarray, jp), CPU), cfg


@pytest.fixture(scope="module")
def models():
    """{name: (jax params, jax cfg, port params, port cfg)}, dropless."""
    out = {}
    for i, name in enumerate(MOES):
        jp, jcfg, tp, cfg = _pair(name, 10 + i)
        out[name] = (jp, _dropless(jcfg), tp, _dropless(cfg))
    return out


def _tokens(shape, seed=0, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


# ---------------------------------------------------------------------------
# configs and shapes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NEW)
def test_config_copies_match_reference(name):
    for reduce in (False, True):
        jcfg, cfg = JC.get_config(name), C.get_config(name)
        if reduce:
            jcfg, cfg = jcfg.reduced(), cfg.reduced()
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert (qk_mode(cfg), cfg.q_per_kv, cfg.padded_vocab) == \
            (jax_qk_mode(jcfg), jcfg.q_per_kv, jcfg.padded_vocab)
        if cfg.moe is not None:
            assert cfg.n_experts_padded == JMOE.n_padded_experts(jcfg)
    assert C.get_config(name).n_params() == N_PARAMS[name]
    # the exact count is the size of the reference's init tree
    jcfg = JC.get_config(name).reduced()
    leaves = jax.tree.leaves(jax_init(jcfg, jax.random.PRNGKey(0)))
    assert C.get_config(name).reduced().n_params() == \
        sum(int(a.size) for a in leaves)


def test_registry_and_shapes_match_reference():
    """Every reference config is registered and equal to the reference's;
    ``SHAPES`` and ``cell_applicable`` agree for every arch x shape."""
    for name, jcfg in JC.all_configs().items():
        assert dataclasses.asdict(C.get_config(name)) == \
            dataclasses.asdict(jcfg)
    with pytest.raises(KeyError):
        C.get_config("no-such-arch")
    assert {k: dataclasses.asdict(v) for k, v in C.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JC.SHAPES.items()}
    assert C.SHAPES["train_4k"] == C.ShapeConfig("train_4k", 4096, 256,
                                                 "train")
    cells = {}
    for name in JC.all_configs():
        for shape in C.SHAPES:
            got = C.cell_applicable(C.get_config(name), C.SHAPES[shape])
            assert got == JC.cell_applicable(JC.get_config(name),
                                             JC.SHAPES[shape])
            cells[name, shape] = got
    # long_500k runs on the sub-quadratic archs only
    assert {n for (n, s), ok in cells.items() if s == "long_500k" and ok} \
        == {"rwkv6-1.6b", "jamba-v0.1-52b"}
    assert sum(cells.values()) == 3 * 11 + 2


# ---------------------------------------------------------------------------
# logits and decode states
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", MOES)
def test_forward_logits_and_aux_match(models, name):
    jp, jcfg, tp, cfg = models[name]
    toks = _tokens((2, 24), 3)
    got, aux = T.forward(tp, cfg, toks, device=CPU)
    want, jaux = JT.forward(jp, jcfg, jnp.asarray(toks))
    _close(got, want)
    for key in MOE.AUX_KEYS:
        _close(aux[key], jaux[key], MOE_TOL)
    if cfg.tie_embeddings:
        assert "lm_head" not in tp


@pytest.mark.parametrize("name", MOES)
def test_chunk_and_decode_states_match(models, name):
    """Per-slot chunk windows (full, partial, idle) then a decode step on
    a dense cache: logits and every cache row agree."""
    jp, jcfg, tp, cfg = models[name]
    B, C_, cap = 3, 8, 32
    jst = JT.init_decode_state(jcfg, B, cap)
    jst["index"] = jnp.asarray([0, 5, 2], jnp.int32)
    tst = T.init_decode_state(cfg, B, cap, device=CPU)
    tst["index"] = torch.tensor([0, 5, 2], dtype=torch.int32)
    lengths = np.asarray([8, 3, 0], np.int32)
    toks = _tokens((B, C_), 1)
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
# routing at the published expert counts
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def published():
    """{name: (jax moe params, jax cfg, port moe params, port cfg)}: one
    MoE layer at d_model 64, d_expert 32 with the published routing."""
    out = {}
    for i, name in enumerate(MOES):
        E, k, shared, _ = PUBLISHED[name]
        over = dict(n_layers=1, d_model=64)
        jcfg = JC.get_config(name).reduced(**over)
        cfg = C.get_config(name).reduced(**over)
        moe = dict(n_experts=E, top_k=k, n_shared=shared, d_expert=32)
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe,
                                                                 **moe))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **moe))
        jmp = JMOE.init_moe(jax.random.PRNGKey(20 + i), jcfg, jnp.float32)
        out[name] = (jmp, jcfg, from_numpy(jax.tree.map(np.asarray, jmp),
                                           CPU), cfg)
    return out


def _with_cf(cfg, cf):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf))


def _reference_keep(jmp, jcfg, x, dropless):
    """The reference's kept slots, by its own routing steps
    (``repro/models/moe.py: _moe_tokens``), over the padded experts."""
    T_, k = x.shape[0], jcfg.moe.top_k
    E, E_real = JMOE.n_padded_experts(jcfg), jcfg.moe.n_experts
    logits = jnp.asarray(x) @ jmp["router"]
    logits = jnp.where(jnp.arange(E) >= E_real, -1e30, logits)
    _, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    cap = T_ if dropless else max(1, int(k * T_ * jcfg.moe.capacity_factor
                                         / E))
    e_flat = np.asarray(idx).reshape(T_ * k)
    onehot = np.eye(E, dtype=np.int64)[e_flat]
    pos = (np.cumsum(onehot, axis=0) - 1)[np.arange(T_ * k), e_flat]
    return np.asarray(idx), (pos < cap).reshape(T_, k)


@pytest.mark.parametrize("cf", [0.0, 1.0])
@pytest.mark.parametrize("name", MOES)
def test_routing_at_published_counts_matches_jax(published, name, cf):
    """Dropless, and capacity-bounded at cf 1.0 (capacity int(k * 48 /
    E): 3 slots of qwen2's 64 experts, 12 of granite's 32, binding on
    48 tokens).  The port routes to the reference's experts with its
    renormalised gates, never to a dead padded expert, keeps exactly the
    slots the reference keeps, and its output and aux losses equal the
    reference's.  With a binding capacity the reference also overwrites
    the token kept in expert 0's first slot whenever a slot is dropped
    (``moe.py: e_c``/``pos_c``; tests/test_torch_mamba.py): that token's
    output is the port's minus exactly that slot's contribution."""
    jmp, jcfg, tmp, cfg = published[name]
    jcfg, cfg = _with_cf(jcfg, cf), _with_cf(cfg, cf)
    E_real, k, _, E = PUBLISHED[name]
    x = np.random.default_rng(5).standard_normal((48, 64)).astype(np.float32)
    dropless = cf == 0.0
    gates, experts, keep, probs, _ = MOE._route(tmp, cfg,
                                                torch.from_numpy(x), dropless)
    assert probs.shape == (48, E) and gates.shape == (48, k)
    assert int(experts.max()) < E_real                  # dead experts unused
    assert not probs[:, E_real:].any()
    _close(gates.sum(-1), np.ones(48), 1e-6)
    top = probs.topk(k + 1, dim=-1).values
    assert float((top[:, -2] - top[:, -1]).min()) > 1e-6   # no router tie
    jidx, want_keep = _reference_keep(jmp, jcfg, x, dropless)
    np.testing.assert_array_equal(experts.numpy(), jidx)
    np.testing.assert_array_equal(keep.numpy(), want_keep)

    jout, jaux = JMOE._moe_tokens(jmp, jcfg, jnp.asarray(x), dropless)
    tout, taux = MOE._moe_tokens(tmp, cfg, torch.from_numpy(x), dropless)
    for key in MOE.AUX_KEYS:
        _close(taux[key], jaux[key], MOE_TOL)
    if dropless:
        assert keep.all()
        _close(tout, jout, MOE_TOL)
        return
    assert (~keep).sum() > 0
    first = torch.nonzero(experts == 0)
    if not len(first):          # expert 0 holds no slot: nothing is lost
        _close(tout, jout, MOE_TOL)
        return
    t0, s0 = (int(i) for i in first[0])
    xt = torch.from_numpy(x[t0])
    lost = (torch.nn.functional.silu(xt @ tmp["w_gate"][0])
            * (xt @ tmp["w_up"][0])) @ tmp["w_down"][0] * gates[t0, s0]
    rows = np.arange(48) != t0
    _close(tout[rows], _np(jout)[rows], MOE_TOL)
    _close(tout[t0] - lost, _np(jout)[t0], MOE_TOL)


@pytest.mark.parametrize("name", MOES)
def test_apply_moe_decode_is_dropless_at_published_counts(published, name):
    """Single-token steps dispatch dropless whatever the capacity factor
    (here 0.25, which would bind on a chunk), as the reference does."""
    jmp, jcfg, tmp, cfg = published[name]
    jcfg, cfg = _with_cf(jcfg, 0.25), _with_cf(cfg, 0.25)
    xb = np.random.default_rng(6).standard_normal((5, 1, 64)).astype(
        np.float32)
    jout, jaux = JMOE.apply_moe(jmp, jcfg, jnp.asarray(xb))
    tout, taux = MOE.apply_moe(tmp, cfg, torch.from_numpy(xb))
    _close(tout, jout, MOE_TOL)
    for key in MOE.AUX_KEYS:
        _close(taux[key], jaux[key], MOE_TOL)


# ---------------------------------------------------------------------------
# decompose and prune (intra mode at G = 1 and G = 2)
# ---------------------------------------------------------------------------

def _products(attn):
    """Per-head Q K^T (with k_t folded) and V O products, float64."""
    a = {k: np.asarray(_np(v), np.float64) for k, v in attn.items()}
    wq, wk, wv, wo = (a[k] for k in ("wq", "wk", "wv", "wo"))
    if "k_t" in a:
        wk = np.einsum("ldkq,lkqr->ldkr", wk, a["k_t"])
    G = wq.shape[2] // wk.shape[2]
    qk = np.einsum("ldhq,lehq->lhde", wq, np.repeat(wk, G, axis=2))
    vo = np.einsum("ldhv,lhve->lhde", np.repeat(wv, G, axis=2), wo)
    return qk, vo


@pytest.mark.parametrize("name", MOES)
def test_decompose_and_prune_match(models, name):
    """Intra mode: no Q-K spectrum, wq / wk untouched; V-O decomposed
    per KV group and pruned to half; the function preserved and the
    pruned logits equal the reference's; the MoE leaves pass through."""
    jp, jcfg, tp, cfg = models[name]
    mode, G = SHAPE[name]
    assert (qk_mode(cfg), cfg.q_per_kv) == (mode, G)
    jd, jdc, jex = jax_decompose(jp, jcfg, peft=False)
    td, tdc, tex = clover_decompose(tp, cfg)
    assert dataclasses.asdict(tdc) == dataclasses.asdict(jdc)
    assert set(tex[0]["spectra"]) == set(jex[0]["spectra"]) == {"vo"}
    _close(tex[0]["spectra"]["vo"], jex[0]["spectra"]["vo"], SPEC_TOL)
    a0, ta = tp["blocks"][0]["attn"], td["blocks"][0]["attn"]
    assert ta["wq"] is a0["wq"] and ta["wk"] is a0["wk"]
    assert td["blocks"][0]["moe"]["w_up"] is tp["blocks"][0]["moe"]["w_up"]
    tq, tv = _products(ta)
    jq, jv = _products(jd["blocks"][0]["attn"])
    _close(tq, jq, SPEC_TOL)
    _close(tv, jv, SPEC_TOL)
    toks = _tokens((2, 24), 7)
    base = T.forward(tp, cfg, toks, device=CPU)[0]
    _close(T.forward(td, tdc, toks, device=CPU)[0], base)

    jpp, jpc = jax_prune(jd, jdc, qk_ratio=0.0, vo_ratio=0.5)
    tpp, tpc = clover_prune(td, tdc, qk_ratio=0.0, vo_ratio=0.5)
    assert dataclasses.asdict(tpc) == dataclasses.asdict(jpc)
    assert (tpc.qk_dim, tpc.vo_dim) == (32, 16)
    _close(T.forward(tpp, tpc, toks, device=CPU)[0],
           JT.forward(jpp, jpc, jnp.asarray(toks))[0])


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _prompts(lens, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, n).astype(np.int32) for n in lens]


def _lockstep(jeng, teng, prompts, max_new):
    """Step both engines together: phase, position, allocator histories
    identical every step; the same streams and step counts."""
    jreqs = [JS.Request(uid=i, prompt=p, max_new_tokens=max_new)
             for i, p in enumerate(prompts)]
    treqs = [S.Request(uid=i, prompt=p, max_new_tokens=max_new)
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
    assert all(r.done for r in treqs)
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    assert teng.steps == jeng.steps
    return treqs


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("name", MOES)
def test_engine_matches_jax_engine_and_reference(models, name, layout):
    """Pruned V-O 0.5 (intra mode keeps Q-K), dropless."""
    jp, jcfg, tp, cfg = models[name]
    jd, jdc, _ = jax_decompose(jp, jcfg, peft=False)
    jpp, jpc = jax_prune(jd, jdc, qk_ratio=0.0, vo_ratio=0.5)
    td, tdc, _ = clover_decompose(tp, cfg)
    tpp, tpc = clover_prune(td, tdc, qk_ratio=0.0, vo_ratio=0.5)
    kw = dict(slots=3, max_len=40, prefill_chunk=8)
    if layout == "paged":
        kw.update(paged=True, page_tokens=4, n_pages=8)    # preempts
    jeng = JS.Engine(jpp, jpc, JS.EngineConfig(**kw))
    teng = S.Engine(tpp, tpc, S.EngineConfig(**kw), device=CPU)
    prompts = _prompts((3, 17, 9, 22))
    reqs = _lockstep(jeng, teng, prompts, 5)
    assert teng.compiled_shapes() == jeng.compiled_shapes() == 2
    assert teng.state["blocks"][0]["kv"]["v"].shape[-1] == tpc.vo_dim == 16
    if layout == "paged":
        assert teng.sched.preemptions == jeng.sched.preemptions > 0
    for r, p in zip(reqs, prompts):
        assert r.generated == S.greedy_reference(tpp, tpc, p, 5, device=CPU)


def test_moe_layer_params_bridge_both_ways(models):
    """The padded-expert MoE tree crosses the bridge bit for bit."""
    jp, _, tp, _ = models["qwen2-moe-a2.7b"]
    moe = tp["blocks"][0]["moe"]
    assert moe["shared_up"].shape == (2, 128, 64)       # 1 shared of 64
    back = to_numpy(tp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        assert np.array_equal(a, np.asarray(b))
