"""The port's PEFT half against the JAX package: CLOVER-S
(``clover_decompose(peft=True)`` with the MLP.Up path, G = 1 and G = 4,
reduced gpt2-xl and reduced rwkv6), ``merge_clover``, a peft-mode tree
served through ``decode_step``, and the LoRA / DoRA / PiSSA baselines
(``init_adapters``, ``materialize``, ``pissa_residual`` and 5
adapter-training steps).

SVD factors are unique only up to sign (and basis within equal singular
values), so the two packages' factors are compared only through spectra,
products and logits; the adapter runs start from JAX's own adapters,
bridged as numpy.  Tolerances: 1e-4 relative on logits and trained
adapters (float32 through the layers, summed in another order), 1e-5
relative on spectra and products.
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

from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import clover_decompose as jax_decompose  # noqa: E402
from repro.core import merge_clover as jax_merge  # noqa: E402
from repro.core import peft as JP  # noqa: E402
from repro.models import init_lm_params as jax_init  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim import AdamWConfig as JAdamW  # noqa: E402
from repro.optim import adamw_init as jadamw_init  # noqa: E402
from repro.optim import adamw_update as jadamw_update  # noqa: E402
from repro_torch.bridge import from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import peft as P  # noqa: E402
from repro_torch.core.decompose import (clover_decompose,  # noqa: E402
                                        merge_clover)
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.train.step import make_adapter_step  # noqa: E402
from repro_torch.tree import tree_leaves_with_path  # noqa: E402

CPU = "cpu"
RTOL = 1e-4
SVD_RTOL = 1e-5


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _rel_close(got, want, rtol):
    got, want = _np(got).astype(np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.max(np.abs(got - want)))
    assert err <= rtol * max(float(np.max(np.abs(want))), 1e-30), err


def _tokens(cfg, shape=(2, 12), seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


# reduced gpt2-xl (MHA, G = 1), the same with one KV head (G = 4), and
# reduced rwkv6 (no attention: only the channel-mix Up path)
CASES = {"gpt2-G1": ("gpt2-xl", {}),
         "gpt2-G4": ("gpt2-xl", {"n_kv_heads": 1}),
         "rwkv6": ("rwkv6-1.6b", {})}


@pytest.fixture(scope="module", params=list(CASES))
def decomposed(request):
    name, over = CASES[request.param]
    jcfg, cfg = jax_config(name).reduced(**over), \
        get_config(name).reduced(**over)
    jp = jax_init(jcfg, jax.random.PRNGKey(11))
    tp = from_numpy(jax.tree.map(np.asarray, jp), CPU)
    jd, jdcfg, jex = jax_decompose(jp, jcfg, peft=True)
    td, tdcfg, tex = clover_decompose(tp, cfg, peft=True)
    return dict(jp=jp, jcfg=jcfg, tp=tp, cfg=cfg, jd=jd, jdcfg=jdcfg,
                jex=jex, td=td, tdcfg=tdcfg, tex=tex)


def test_peft_decompose_logits_and_layout(decomposed):
    m = decomposed
    assert dataclasses.asdict(m["tdcfg"]) == dataclasses.asdict(m["jdcfg"])
    assert m["tdcfg"].clover.finetune_s
    toks = _tokens(m["cfg"])
    want, _ = JT.forward(m["jd"], m["jdcfg"], jnp.asarray(toks))
    got, _ = T.forward(m["td"], m["tdcfg"], toks, device=CPU)
    _rel_close(got, want, RTOL)
    base, _ = T.forward(m["tp"], m["cfg"], toks, device=CPU)
    _rel_close(got, base, RTOL)          # function preserved
    jshapes = {jax.tree_util.keystr(p): x.shape for p, x in
               jax.tree_util.tree_flatten_with_path(m["jd"])[0]}
    tshapes = {p: tuple(x.shape) for p, x in
               tree_leaves_with_path(m["td"])}
    assert tshapes == jshapes
    blk = m["td"]["blocks"][0]
    sub = blk.get("mlp", blk.get("rwkv_chan"))
    assert "up_u" in sub and "up_t" in sub
    assert sub["up_t"].dtype == torch.float32


def test_transition_diagonals_are_the_spectra(decomposed):
    m = decomposed
    attn = m["td"]["blocks"][0].get("attn")
    if attn is None:             # rwkv: no attention pairs, no spectra
        assert m["tex"] == [{"spectra": {}}]
        return
    G = m["cfg"].q_per_kv
    for key, name in (("s_qk", "qk"), ("s_vo", "vo")):
        S_t = m["tex"][0]["spectra"][name]            # (nb, KV, d)
        _rel_close(S_t, m["jex"][0]["spectra"][name], SVD_RTOL)
        s = attn[key]                                 # (nb, H, d, d)
        diag = torch.diagonal(s, dim1=-2, dim2=-1)
        assert torch.equal(diag, torch.repeat_interleave(S_t, G, dim=1))
        assert torch.equal(s, torch.diag_embed(diag))
        _rel_close(s, m["jd"]["blocks"][0]["attn"][key], SVD_RTOL)


def _up_product(sub):
    """(nb, D, F) Up weight of a decomposed sub-tree: up_u @ up_t."""
    u, t = _np(sub["up_u"]), _np(sub["up_t"])
    W = np.einsum("bdnr,bnrk->bdnk", u, t)
    return W.reshape(W.shape[0], W.shape[1], -1)


def test_up_blocks_reproduce_the_weight(decomposed):
    m = decomposed
    name, key = (("mlp", "w_up") if "mlp" in m["tp"]["blocks"][0]
                 else ("rwkv_chan", "wk"))
    want = _np(m["tp"]["blocks"][0][name][key])
    _rel_close(_up_product(m["td"]["blocks"][0][name]), want, SVD_RTOL)
    _rel_close(_up_product(jax.tree.map(np.asarray,
                                        m["jd"]["blocks"][0][name])),
               want, SVD_RTOL)
    u = _np(m["td"]["blocks"][0][name]["up_u"])       # orthonormal blocks
    gram = np.einsum("bdnr,bdns->bnrs", u, u)
    np.testing.assert_allclose(gram, np.broadcast_to(
        np.eye(u.shape[-1]), gram.shape), atol=1e-5)


def test_merge_clover_matches(decomposed):
    m = decomposed
    tm, tmcfg = merge_clover(m["td"], m["tdcfg"])
    jm, jmcfg = jax_merge(m["jd"], m["jdcfg"])
    assert dataclasses.asdict(tmcfg) == dataclasses.asdict(jmcfg)
    assert P.count_params(tm) == JP.count_params(jm) == \
        P.count_params(m["tp"])
    toks = _tokens(m["cfg"], seed=3)
    got, _ = T.forward(tm, tmcfg, toks, device=CPU)
    _rel_close(got, JT.forward(jm, jmcfg, jnp.asarray(toks))[0], RTOL)
    _rel_close(got, T.forward(m["tp"], m["cfg"], toks, device=CPU)[0], RTOL)
    assert not any("s_qk" in p or "up_t" in p
                   for p, _ in tree_leaves_with_path(tm))


def test_peft_tree_decode_matches(decomposed):
    """A peft-mode tree serves unmerged: prefill + 4 decode steps with the
    transitions applied to q and to the context, against JAX's."""
    m = decomposed
    td = from_numpy(jax.tree.map(np.asarray, m["jd"]), CPU)
    cfg, jcfg = m["tdcfg"], m["jdcfg"]
    toks = _tokens(cfg, (2, 9), seed=5)
    js = JT.init_decode_state(jcfg, 2, 16)
    ts = T.init_decode_state(cfg, 2, 16, device=CPU)
    jl, js = JT.prefill(m["jd"], jcfg, jnp.asarray(toks[:, :5]), js)
    tl, ts = T.prefill(td, cfg, torch.as_tensor(toks[:, :5]), ts)
    _rel_close(tl, jl, RTOL)
    for i in range(5, 9):
        jl, js = JT.decode_step(m["jd"], jcfg, jnp.asarray(toks[:, i]), js)
        tl, ts = T.decode_step(td, cfg, torch.as_tensor(toks[:, i]), ts)
        _rel_close(tl, jl, RTOL)


# ---------------------------------------------------------------------------
# LoRA / DoRA / PiSSA
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def base():
    jcfg, cfg = jax_config("gpt2-xl").reduced(), get_config("gpt2-xl").reduced()
    jp = jax_init(jcfg, jax.random.PRNGKey(4))
    return jp, jcfg, from_numpy(jax.tree.map(np.asarray, jp), CPU), cfg


METHODS = {"lora": dict(rank=16, alpha=16.0),
           "dora": dict(rank=16, alpha=16.0),
           "pissa": dict(rank=16, alpha=1.0)}


def _adapters_pair(jp, method):
    jpc = JP.PeftConfig(method=method, **METHODS[method])
    tpc = P.PeftConfig(method=method, **METHODS[method])
    ja = JP.init_adapters(jp, jpc, jax.random.PRNGKey(42))
    if method != "pissa":        # b = 0 at init: move it, so the test sees
        ja = {n: dict(ad, b=ad["b"] + 0.05 * jax.random.normal(  # a delta
            jax.random.PRNGKey(i), ad["b"].shape))
            for i, (n, ad) in enumerate(sorted(ja.items()))}
    return jpc, tpc, ja, from_numpy(jax.tree.map(np.asarray, ja), CPU)


@pytest.mark.parametrize("method", list(METHODS))
def test_materialize_and_residual_given_jax_adapters(base, method):
    jp, jcfg, tp, cfg = base
    jpc, tpc, ja, ta = _adapters_pair(jp, method)
    assert set(ta) == set(ja)
    assert all(float(ta[n]["r_eff"]) == float(ja[n]["r_eff"]) for n in ta)
    frozen_j = JP.pissa_residual(jp, ja, jpc) if method == "pissa" else jp
    frozen_t = P.pissa_residual(tp, ta, tpc) if method == "pissa" else tp
    for f_t, f_j in ((frozen_t, frozen_j),
                     (P.materialize(frozen_t, ta, tpc),
                      JP.materialize(frozen_j, ja, jpc))):
        jl = {jax.tree_util.keystr(p): x for p, x in
              jax.tree_util.tree_flatten_with_path(f_j)[0]}
        for path, leaf in tree_leaves_with_path(f_t):
            _rel_close(leaf, jl[path], 1e-5)
    toks = _tokens(cfg, seed=6)
    got, _ = T.forward(P.merge_adapters(frozen_t, ta, tpc), cfg, toks,
                       device=CPU)
    want, _ = JT.forward(JP.merge_adapters(frozen_j, ja, jpc), jcfg,
                         jnp.asarray(toks))
    _rel_close(got, want, RTOL)


@pytest.mark.parametrize("method", list(METHODS))
def test_init_adapters_match(base, method):
    """The port's own init: names, shapes and ranks as JAX's; LoRA
    materializes to the base bit for bit (b = 0), DoRA to within
    rounding (m * W / ||W||); DoRA magnitudes and the PiSSA principal
    product b a as JAX's; PiSSA's residual + materialize gives the base
    back."""
    jp, jcfg, tp, cfg = base
    jpc, tpc = (JP.PeftConfig(method=method, **METHODS[method]),
                P.PeftConfig(method=method, **METHODS[method]))
    ja = JP.init_adapters(jp, jpc, jax.random.PRNGKey(0))
    ta = P.init_adapters(tp, tpc, torch.Generator().manual_seed(0))
    assert set(ta) == set(ja)
    for n in ta:
        assert {k: tuple(v.shape) for k, v in ta[n].items()} == \
            {k: v.shape for k, v in ja[n].items()}
        if method == "dora":
            _rel_close(ta[n]["m"], ja[n]["m"], 1e-6)
        if method == "pissa":
            _rel_close(torch.einsum("nor,nri->nio", ta[n]["b"], ta[n]["a"]),
                       jnp.einsum("nor,nri->nio", ja[n]["b"], ja[n]["a"]),
                       SVD_RTOL * 10)
    if method == "pissa":
        eff = P.materialize(P.pissa_residual(tp, ta, tpc), ta, tpc)
        for (p, got), (_, want) in zip(tree_leaves_with_path(eff),
                                       tree_leaves_with_path(tp)):
            _rel_close(got, want, 1e-5)
    else:
        eff = P.materialize(tp, ta, tpc)
        for (p, got), (_, want) in zip(tree_leaves_with_path(eff),
                                       tree_leaves_with_path(tp)):
            if method == "lora":
                assert torch.equal(got, want), p
            else:
                _rel_close(got, want, 1e-6)


def _jax_adapter_run(jp, jcfg, jpc, ja, batches, lr):
    """``benchmarks/table2_peft.py``'s ``_train_adapters`` loop, from
    the given adapters."""
    frozen = JP.pissa_residual(jp, ja, jpc) if jpc.method == "pissa" else jp
    opt = jadamw_init(ja)
    ocfg = JAdamW(lr=lr, weight_decay=0.0)

    def loss_fn(ad, tokens, labels):
        eff = JP.materialize(frozen, ad, jpc)
        logits, aux = JT.forward(eff, jcfg, tokens)
        logp = jax.nn.log_softmax(logits.astype(jnp.float32), -1)
        nll = -jnp.take_along_axis(logp, labels[..., None], -1)[..., 0]
        return jnp.mean(nll) + sum(aux.values())

    @jax.jit
    def step(ad, opt, tokens, labels):
        loss_val, g = jax.value_and_grad(loss_fn)(ad, tokens, labels)
        ad, opt, _ = jadamw_update(g, opt, ad, ocfg)
        return ad, opt, loss_val

    losses = []
    for b in batches:
        ja, opt, lv = step(ja, opt, jnp.asarray(b[0]), jnp.asarray(b[1]))
        losses.append(float(lv))
    return ja, losses


@pytest.mark.parametrize("method", list(METHODS))
def test_adapter_training_matches(base, method):
    """5 steps from JAX's adapters: each step's loss, then the trained
    adapters through what they do -- the materialized weights and the
    merged model's logits -- within 1e-4.  Not leaf by leaf: Adam's first
    step is g / (|g| + eps), so an entry whose gradient is rounding noise
    (|g| ~ 1e-10 here, one entry of 4096) moves by a different fraction
    of lr in each package."""
    jp, jcfg, tp, cfg = base
    jpc, tpc, ja, ta = _adapters_pair(jp, method)
    lr = 2e-3 if method != "pissa" else 1e-4
    batches = [(_tokens(cfg, (2, 10), seed=20 + i),
                _tokens(cfg, (2, 10), seed=40 + i)) for i in range(5)]
    ja1, jlosses = _jax_adapter_run(jp, jcfg, jpc, ja, batches, lr)
    frozen = P.pissa_residual(tp, ta, tpc) if method == "pissa" else tp
    step = make_adapter_step(cfg, tpc, frozen,
                             AdamWConfig(lr=lr, weight_decay=0.0),
                             device=CPU)
    opt = adamw_init(ta)
    for (toks, labels), jl in zip(batches, jlosses):
        ta, opt, loss = step(ta, opt, toks, labels)
        assert abs(float(loss) - jl) <= RTOL * abs(jl)
    assert P.count_params(ta) == JP.count_params(ja1)
    frozen_j = JP.pissa_residual(jp, ja, jpc) if method == "pissa" else jp
    eff_t = P.merge_adapters(frozen, ta, tpc)
    eff_j = JP.merge_adapters(frozen_j, ja1, jpc)
    jl = {jax.tree_util.keystr(p): x for p, x in
          jax.tree_util.tree_flatten_with_path(eff_j)[0]}
    for path, leaf in tree_leaves_with_path(eff_t):
        _rel_close(leaf, jl[path], RTOL)
    toks = _tokens(cfg, seed=9)
    _rel_close(T.forward(eff_t, cfg, toks, device=CPU)[0],
               JT.forward(eff_j, jcfg, jnp.asarray(toks))[0], RTOL)
