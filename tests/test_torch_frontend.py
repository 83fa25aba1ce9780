"""The frontend configs musicgen-large and internvl2-2b in the port
against the JAX package, musicgen's sinusoidal positions, the frontend
path (``forward`` / ``prefill`` / ``loss_fn`` / the train step with
``frontend_embeds``) and the attention logit softcap.

Reduced sizes (2 layers, d_model 128, head_dim 32, frontends of 8
positions of width 128): musicgen at 4 heads over 4 KV heads (MHA, no
RoPE: sinusoidal positions, "cross" CLOVER mode, layernorm, GELU),
internvl2 at 4 heads over 2 (G = 2, full RoPE: "intra" mode).  The
frontend embeddings, weights and tokens are made with numpy from seeds
and cross as numpy arrays through the port's bridge.  The softcap is
held on internvl2 with ``attn_logit_softcap=30.0`` and ``wq`` scaled by
40, so the attention logits reach far past the cap (unscaled random
weights give logits of ~1, where the cap is nearly the identity).

Tolerances: 1e-6 on the sinusoidal table (float32 sin / cos of the same
float32 angles); atol 1e-4 on logits and caches (float32 through two
layers, summed in another order); 1e-5 on spectra and on the Q K^T /
V O products; 1e-4 relative on losses and grad norms (as
``tests/test_torch_train.py``).
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
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.models import init_lm_params as jax_init  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.train import step as JST  # noqa: E402
from repro_torch import optim as O  # noqa: E402
from repro_torch import serve as S  # noqa: E402
from repro_torch.bridge import from_numpy, to_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.decompose import clover_decompose, qk_mode  # noqa: E402
from repro_torch.core.prune import clover_prune  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.train import step as ST  # noqa: E402

CPU = "cpu"
SIN_TOL = 1e-6
ATOL = 1e-4
SPEC_TOL = 1e-5
RTOL = 1e-4

NAMES = ("musicgen-large", "internvl2-2b")
# (qk_mode, G, pruned widths at qk / vo ratios 0.5 / 0.5) at reduced size
SHAPE = {"musicgen-large": ("cross", 1, (16, 16)),
         "internvl2-2b": ("intra", 2, (32, 16))}
CAP = 30.0
CAP_GAIN = 40.0


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=atol, rtol=0)


def _rel_close(got, want, rtol=RTOL):
    got, want = np.float64(_np(got)), np.asarray(want, np.float64)
    assert abs(got - want) <= rtol * max(abs(want), 1e-30), (got, want)


def _bridge(jp):
    return from_numpy(jax.tree.map(np.asarray, jp), CPU)


@pytest.fixture(scope="module")
def models():
    """{name: (jax params, jax cfg, port params, port cfg)}."""
    out = {}
    for i, name in enumerate(NAMES):
        jcfg, cfg = jax_config(name).reduced(), get_config(name).reduced()
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        jp = jax_init(jcfg, jax.random.PRNGKey(30 + i))
        out[name] = (jp, jcfg, _bridge(jp), cfg)
    return out


def _tokens(shape, seed=0, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _frontend(cfg, B, seed=0):
    """(B, F, D) float32 frame / patch embeddings of unit scale."""
    return np.random.default_rng(100 + seed).standard_normal(
        (B, cfg.frontend_len, cfg.frontend_dim)).astype(np.float32)


# ---------------------------------------------------------------------------
# sinusoidal positions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d_model", [128, 2048])
def test_sinusoidal_positions_match(d_model):
    pos = np.random.default_rng(d_model).integers(0, 3000, (3, 7)).astype(
        np.int32)
    got = L.sinusoidal_positions(torch.from_numpy(pos), d_model)
    assert got.shape == (3, 7, d_model) and got.dtype == torch.float32
    _close(got, JL.sinusoidal_positions(jnp.asarray(pos), d_model), SIN_TOL)
    # sin half then cos half: position 0 is (0, ..., 0, 1, ..., 1)
    zero = L.sinusoidal_positions(torch.zeros(1, dtype=torch.long), d_model)
    assert torch.equal(zero[0], torch.cat([torch.zeros(d_model // 2),
                                           torch.ones(d_model // 2)]))


def test_sinusoidal_positions_only_on_audio_without_rope(models):
    """musicgen's embeddings carry the positions; internvl2's (RoPE) do
    not, and a text model scores a shifted sequence differently only
    where its positions enter."""
    for name in NAMES:
        _, _, tp, cfg = models[name]
        toks = torch.from_numpy(_tokens((1, 5), 4))
        pos = torch.arange(5)[None] + 3
        emb = T._embed(tp, cfg, toks, pos)
        plain = tp["embed"][toks.long()]
        if name == "musicgen-large":
            _close(emb - plain, L.sinusoidal_positions(pos, cfg.d_model),
                   1e-6)
        else:
            assert torch.equal(emb, plain)


# ---------------------------------------------------------------------------
# the frontend path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_forward_with_frontend_matches(models, name):
    """Logits over F + S_tok positions, with and without the frontend;
    the frontend changes the text positions' logits."""
    jp, jcfg, tp, cfg = models[name]
    toks = _tokens((2, 12), 3)
    fe = _frontend(cfg, 2)
    got, _ = T.forward(tp, cfg, toks, frontend_embeds=fe, device=CPU)
    assert got.shape == (2, cfg.frontend_len + 12, cfg.padded_vocab)
    _close(got, JT.forward(jp, jcfg, jnp.asarray(toks),
                           frontend_embeds=jnp.asarray(fe))[0])
    text, _ = T.forward(tp, cfg, toks, device=CPU)
    _close(text, JT.forward(jp, jcfg, jnp.asarray(toks))[0])
    assert not torch.allclose(got[:, -12:], text, atol=1e-3)
    last, _ = T.forward(tp, cfg, toks, frontend_embeds=torch.from_numpy(fe),
                        last_only=True, device=CPU)
    _close(last[:, 0], got[:, -1])


@pytest.mark.parametrize("name", NAMES)
def test_prefill_with_frontend_then_decode_matches(models, name):
    """``prefill(frontend_embeds=...)`` from index 0, then three decode
    steps: logits and every cache row equal the reference's, and each
    step's logits equal the full forward on the extended sequence."""
    jp, jcfg, tp, cfg = models[name]
    B, cap, n = 2, 32, 3
    toks = _tokens((B, 6), 5)
    fe = _frontend(cfg, B, 1)
    jst = JT.init_decode_state(jcfg, B, cap)
    tst = T.init_decode_state(cfg, B, cap, device=CPU)
    jl, jst = JT.prefill(jp, jcfg, jnp.asarray(toks), jst,
                         frontend_embeds=jnp.asarray(fe))
    tl, tst = T.prefill(tp, cfg, torch.from_numpy(toks), tst,
                        frontend_embeds=torch.from_numpy(fe))
    assert int(tst["index"]) == int(jst["index"]) == cfg.frontend_len + 6
    _close(tl, jl)
    seq = toks
    for i in range(n):
        tok = tl.argmax(-1).to(torch.int32)
        seq = np.concatenate([seq, tok.numpy()[:, None]], axis=1)
        jl, jst = JT.decode_step(jp, jcfg, jnp.asarray(tok.numpy()), jst)
        tl, tst = T.decode_step(tp, cfg, tok, tst)
        _close(tl, jl)
        full, _ = T.forward(tp, cfg, seq, frontend_embeds=fe,
                            last_only=True, device=CPU)
        _close(tl, full[:, 0])
    for a, b in zip(jax.tree.leaves(to_numpy(tst["blocks"])),
                    jax.tree.leaves(jst["blocks"])):
        _close(a, b)


@pytest.mark.parametrize("name", NAMES)
def test_frontend_prefill_positions_start_at_zero(models, name):
    """A frontend prompt starts its sequence: at a non-zero ``index`` the
    cache is written from ``index`` on, but the positions (RoPE angles,
    musicgen's sinusoids) run from 0, as the reference's do."""
    jp, jcfg, tp, cfg = models[name]
    toks, fe = _tokens((2, 5), 12), _frontend(cfg, 2, 4)
    jst = JT.init_decode_state(jcfg, 2, 24)
    jst["index"] = jnp.asarray(3, jnp.int32)
    tst = T.init_decode_state(cfg, 2, 24, device=CPU)
    tst["index"] = torch.tensor(3, dtype=torch.int32)
    jl, jst = JT.prefill(jp, jcfg, jnp.asarray(toks), jst,
                         frontend_embeds=jnp.asarray(fe))
    tl, tst = T.prefill(tp, cfg, torch.from_numpy(toks), tst,
                        frontend_embeds=torch.from_numpy(fe))
    _close(tl, jl)
    assert int(tst["index"]) == int(jst["index"]) == 3 + cfg.frontend_len + 5
    for a, b in zip(jax.tree.leaves(to_numpy(tst["blocks"])),
                    jax.tree.leaves(jst["blocks"])):
        _close(a, b)


def test_text_prefill_keeps_its_index_offset(models):
    """Without a frontend the port's prefill still starts at ``index``:
    two halves give the logits and caches of one whole prefill
    (musicgen: the sinusoidal positions follow the index)."""
    _, _, tp, cfg = models["musicgen-large"]
    toks = torch.from_numpy(_tokens((2, 10), 6))
    whole = T.init_decode_state(cfg, 2, 16, device=CPU)
    lw, whole = T.prefill(tp, cfg, toks, whole)
    halves = T.init_decode_state(cfg, 2, 16, device=CPU)
    _, halves = T.prefill(tp, cfg, toks[:, :4], halves)
    lh, halves = T.prefill(tp, cfg, toks[:, 4:], halves)
    _close(lh, lw)
    assert int(halves["index"]) == int(whole["index"]) == 10
    for a, b in zip(jax.tree.leaves(to_numpy(halves["blocks"])),
                    jax.tree.leaves(to_numpy(whole["blocks"]))):
        _close(a, b)


@pytest.mark.parametrize("name", NAMES)
def test_loss_fn_with_frontend_matches(models, name):
    """The frontend positions carry no labels: the loss is over the
    text positions only, as the reference's."""
    jp, jcfg, tp, cfg = models[name]
    toks = _tokens((2, 10), 7)
    labels = _tokens((2, 10), 8)
    labels[0, :3] = -1                                      # masked
    fe = _frontend(cfg, 2, 2)
    jt, jm = JST.loss_fn(jp, jcfg, jnp.asarray(toks), jnp.asarray(labels),
                         frontend_embeds=jnp.asarray(fe), remat=False)
    tt, tm = ST.loss_fn(tp, cfg, toks, labels, frontend_embeds=fe,
                        remat=False, device=CPU)
    _rel_close(tt, jt)
    _rel_close(tm["loss"], jm["loss"])
    # by hand: cross entropy of the text positions' logits
    logits, _ = T.forward(tp, cfg, toks, frontend_embeds=fe, device=CPU)
    logp = torch.log_softmax(logits[:, cfg.frontend_len:], -1)
    lab = torch.from_numpy(labels).long()
    nll = -logp.gather(-1, lab.clamp_min(0)[..., None])[..., 0]
    _rel_close(tm["loss"], float(nll[lab >= 0].mean()))


def test_clover_s_step_with_frontend_batch(models):
    """internvl2 (intra, G = 2): two CLOVER-S steps on batches that carry
    ``frontend_embeds``, against the reference's step on the same
    decomposition; only ``k_t``, ``s_vo`` and ``up_t`` move."""
    jp, jcfg, _, cfg = models["internvl2-2b"]
    jd, jdc, _ = jax_decompose(jp, jcfg, peft=True)
    td = _bridge(jd)
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
    for i in range(2):
        rng = np.random.default_rng(40 + i)
        b = {k: rng.integers(0, cfg.vocab_size, (2, 10)).astype(np.int32)
             for k in ("tokens", "labels")}
        b["frontend_embeds"] = _frontend(cfg, 2, 10 + i)
        jd, jo, jm = jstep(jd, jo, {k: jnp.asarray(v) for k, v in b.items()})
        tp, to, tm = tstep(tp, to, b)
        assert np.isfinite(float(tm["loss"]))
        for k in ("loss", "grad_norm"):
            _rel_close(tm[k], jm[k])
    moved = {k for blk, b0 in zip(tp["blocks"], td["blocks"])
             for sub in blk for k in blk[sub]
             if not torch.equal(blk[sub][k], b0[sub][k])}
    assert moved == {"k_t", "s_vo", "up_t"}


# ---------------------------------------------------------------------------
# decompose and prune: cross mode (musicgen), intra at G = 2 (internvl2)
# ---------------------------------------------------------------------------

def _products(attn):
    """Per-head Q K^T (with the transitions folded) and V O products."""
    a = {k: np.asarray(_np(v), np.float64) for k, v in attn.items()}
    wq, wk, wv, wo = (a[k] for k in ("wq", "wk", "wv", "wo"))
    if "k_t" in a:
        wk = np.einsum("ldkq,lkqr->ldkr", wk, a["k_t"])
    G = wq.shape[2] // wk.shape[2]
    qk = np.einsum("ldhq,lehq->lhde", wq, np.repeat(wk, G, axis=2))
    vo = np.einsum("ldhv,lhve->lhde", np.repeat(wv, G, axis=2), wo)
    return qk, vo


@pytest.mark.parametrize("name", NAMES)
def test_decompose_and_prune_match(models, name):
    """Spectra, products, config and logits (on a frontend input) equal
    the reference's; the function is preserved; pruning 0.5 / 0.5 cuts
    both sides in cross mode and only V-O in intra mode."""
    jp, jcfg, tp, cfg = models[name]
    mode, G, widths = SHAPE[name]
    assert (qk_mode(cfg), cfg.q_per_kv) == (mode, G)
    jd, jdc, jex = jax_decompose(jp, jcfg, peft=False)
    td, tdc, tex = clover_decompose(tp, cfg)
    assert dataclasses.asdict(tdc) == dataclasses.asdict(jdc)
    fams = {"qk", "vo"} if mode == "cross" else {"vo"}
    assert set(tex[0]["spectra"]) == set(jex[0]["spectra"]) == fams
    for fam in fams:
        _close(tex[0]["spectra"][fam], jex[0]["spectra"][fam], SPEC_TOL)
    tq, tv = _products(td["blocks"][0]["attn"])
    jq, jv = _products(jd["blocks"][0]["attn"])
    _close(tq, jq, SPEC_TOL)
    _close(tv, jv, SPEC_TOL)
    toks, fe = _tokens((2, 8), 9), _frontend(cfg, 2, 3)
    base, _ = T.forward(tp, cfg, toks, frontend_embeds=fe, device=CPU)
    _close(T.forward(td, tdc, toks, frontend_embeds=fe, device=CPU)[0], base)

    jpp, jpc = jax_prune(jd, jdc, qk_ratio=0.5, vo_ratio=0.5)
    tpp, tpc = clover_prune(td, tdc, qk_ratio=0.5, vo_ratio=0.5)
    assert dataclasses.asdict(tpc) == dataclasses.asdict(jpc)
    assert (tpc.qk_dim, tpc.vo_dim) == widths
    _close(T.forward(tpp, tpc, toks, frontend_embeds=fe, device=CPU)[0],
           JT.forward(jpp, jpc, jnp.asarray(toks),
                      frontend_embeds=jnp.asarray(fe))[0])


# ---------------------------------------------------------------------------
# serving (text only: neither package's Engine takes a frontend)
# ---------------------------------------------------------------------------

def _prompts(lens, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, n).astype(np.int32) for n in lens]


def _lockstep(jeng, teng, prompts, max_new):
    """Step both engines together: phase, position and allocator
    histories identical every step; the same streams."""
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
    assert all(r.done for r in treqs)
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    assert teng.steps == jeng.steps
    return treqs


def _engines(jp, jcfg, tp, cfg, layout, prompts, new=5):
    kw = dict(slots=3, max_len=40, prefill_chunk=8)
    if layout == "paged":
        kw.update(paged=True, page_tokens=4, n_pages=8)    # preempts
    jeng = JS.Engine(jp, jcfg, JS.EngineConfig(**kw))
    teng = S.Engine(tp, cfg, S.EngineConfig(**kw), device=CPU)
    reqs = _lockstep(jeng, teng, prompts, new)
    assert teng.compiled_shapes() == jeng.compiled_shapes() == 2
    if layout == "paged":
        assert teng.sched.preemptions == jeng.sched.preemptions > 0
    for r, p in zip(reqs, prompts):
        assert r.generated == S.greedy_reference(tp, cfg, p, new, device=CPU)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_musicgen_engine_matches_jax_engine(models, layout):
    """Pruned 16/16 (cross mode): the sinusoidal positions at each slot's
    own index on the chunk and decode paths."""
    jp, jcfg, tp, cfg = models["musicgen-large"]
    jd, jdc, _ = jax_decompose(jp, jcfg, peft=False)
    td, tdc, _ = clover_decompose(tp, cfg)
    _engines(*jax_prune(jd, jdc, qk_ratio=0.5, vo_ratio=0.5),
             *clover_prune(td, tdc, qk_ratio=0.5, vo_ratio=0.5), layout,
             _prompts((3, 17, 9, 22)))


# ---------------------------------------------------------------------------
# the attention logit softcap
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def capped(models):
    """internvl2 with the softcap at 30 and wq scaled by 40 (the same
    weights in both packages); -> (jax params, jax cfg, port params,
    port cfg, port params uncapped cfg)."""
    jp, jcfg, _, cfg = models["internvl2-2b"]
    attn = dict(jp["blocks"][0]["attn"])
    attn["wq"] = attn["wq"] * CAP_GAIN
    jp = {**jp, "blocks": ({**jp["blocks"][0], "attn": attn},)}
    jcfg = dataclasses.replace(jcfg, attn_logit_softcap=CAP)
    return jp, jcfg, _bridge(jp), dataclasses.replace(
        cfg, attn_logit_softcap=CAP), cfg


def _plain_calls():
    return (ref.attention_ref.calls, ref.flash_attention_ref.calls,
            ref.window_attention_ref.calls, ref.decode_attention_ref.calls,
            ref.paged_decode_attention_ref.calls)


def test_softcap_forward_matches_and_bypasses_the_kernels(capped):
    """Scoring and training logits equal the reference's capped einsum
    path; the cap bites (logits move against the uncapped model); no
    kernel entry runs, not even its plain version, on a capped config."""
    jp, jcfg, tp, cfg, uncapped = capped
    toks = _tokens((2, 16), 11)
    calls = _plain_calls()
    got, _ = T.forward(tp, cfg, toks, device=CPU)
    trained, _ = T.train_forward(tp, cfg, toks, remat=False,
                                 plain_attention=True, device=CPU)
    assert _plain_calls() == calls
    want = JT.forward(jp, jcfg, jnp.asarray(toks))[0]
    _close(got, want)
    _close(trained, want)
    free, _ = T.forward(tp, uncapped, toks, device=CPU)
    assert float((free - got).abs().max()) > 1e-2
    # tanh(l / c) * c on the plain attention, by hand on layer 0's q, k
    q = torch.randn(1, 5, 4, 32) * 8
    k = torch.randn(1, 5, 2, 32) * 8
    v = torch.randn(1, 5, 2, 32)
    mask = torch.ones(1, 5, 5, dtype=torch.bool).tril()
    ctx = L._masked_attention(q, k, v, mask, 1.0, 2, CAP)
    logits = torch.einsum("bshq,bthq->bhst", q, k.repeat_interleave(2, 2))
    logits = (torch.tanh(logits / CAP) * CAP).masked_fill(~mask, -1e30)
    want = torch.einsum("bhst,bthv->bshv", torch.softmax(logits, -1),
                        v.repeat_interleave(2, 2))
    _close(ctx, want, 1e-6)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_softcap_engine_matches_jax_engine(capped, layout):
    """Chunked prefill and one-token decode through the dense cache and
    the page pool, capped, in lockstep with the reference's engine; no
    decode kernel entry runs."""
    jp, jcfg, tp, cfg, _ = capped
    calls = _plain_calls()
    _engines(jp, jcfg, tp, cfg, layout, _prompts((3, 17, 9, 22), seed=2))
    assert _plain_calls() == calls
