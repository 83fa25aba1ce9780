"""The port's decoder, decode states, decomposition and pruning against
the JAX package on the same weights (numpy-bridged), at a reduced
gpt2-xl (2 layers, d_model 128, 4 heads, head_dim 32), float32.
Tolerance: atol 1e-4 on logits and cache contents (float32 matmuls
summed in another order through two layers)."""
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
from repro.core import clover_prune as jax_prune  # noqa: E402
from repro.models import init_lm_params as jax_init  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve.memory import PageAllocator  # noqa: E402
from repro_torch.bridge import from_numpy, to_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.decompose import clover_decompose  # noqa: E402
from repro_torch.core.prune import clover_prune, plan_ranks  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

ATOL = 1e-4
CPU = "cpu"


@pytest.fixture(scope="module")
def model():
    jcfg = jax_config("gpt2-xl").reduced()
    cfg = get_config("gpt2-xl").reduced()
    jparams = jax_init(jcfg, jax.random.PRNGKey(0))
    nparams = jax.tree.map(np.asarray, jparams)
    return jcfg, cfg, jparams, nparams, from_numpy(nparams, CPU)


def _tokens(shape, seed=0, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


def test_config_copy_matches_reference():
    for reduce in (False, True):
        jcfg, cfg = jax_config("gpt2-xl"), get_config("gpt2-xl")
        if reduce:
            jcfg, cfg = jcfg.reduced(), cfg.reduced()
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert (cfg.qk_dim, cfg.vo_dim, cfg.q_per_kv) == \
            (jcfg.qk_dim, jcfg.vo_dim, jcfg.q_per_kv)
    # the RoPE configs are ported: phi3's copy matches the reference too
    for reduce in (False, True):
        jcfg, cfg = jax_config("phi3-medium-14b"), get_config(
            "phi3-medium-14b")
        if reduce:
            jcfg, cfg = jcfg.reduced(), cfg.reduced()
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert (cfg.rope_dims, cfg.q_per_kv) == (jcfg.rope_dims,
                                                 jcfg.q_per_kv)
    # every reference config is ported: only an unknown name raises
    with pytest.raises(KeyError):
        get_config("no-such-arch")


def test_bridge_round_trip(model):
    jcfg, cfg, _, nparams, tparams = model
    back = to_numpy(tparams)
    assert jax.tree.structure(back) == jax.tree.structure(nparams)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(nparams)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # the stacked layout: one tree per pattern position, leading n_blocks
    assert isinstance(tparams["blocks"], tuple)
    assert tparams["blocks"][0]["attn"]["wq"].shape == (cfg.n_blocks, 128, 4,
                                                        32)
    n = sum(a.size for a in jax.tree.leaves(nparams))
    assert n == cfg.n_params()


def test_init_distributions():
    """The port's own seeded init: reference shapes and distributions."""
    cfg = get_config("gpt2-xl").reduced()
    p = T.init_lm_params(cfg, 7, device=CPU)
    q = T.init_lm_params(cfg, 7, device=CPU)
    assert torch.equal(p["embed"], q["embed"])
    assert abs(p["embed"].std().item() - 0.02) < 2e-3
    assert abs(p["pos_embed"].std().item() - 0.01) < 1e-3
    wq = p["blocks"][0]["attn"]["wq"]
    assert wq.shape == (2, 128, 4, 32)
    assert abs(wq.std().item() - 128 ** -0.5) < 5e-3
    assert torch.equal(p["final_norm"]["scale"], torch.ones(128))


def test_forward_logits_match(model):
    jcfg, cfg, jparams, _, tparams = model
    toks = _tokens((2, 40))
    want, want_aux = JT.forward(jparams, jcfg, jnp.asarray(toks))
    got, aux = T.forward(tparams, cfg, toks, device=CPU)
    assert got.shape == (2, 40, cfg.vocab_size)
    # no MoE: the aux losses are the reference's zeros, under its keys
    assert sorted(aux) == sorted(want_aux)
    assert all(float(aux[k]) == float(want_aux[k]) == 0.0 for k in aux)
    _close(got, want)
    last, _ = T.forward(tparams, cfg, toks, last_only=True, device=CPU)
    _close(last[:, 0], got[:, -1], atol=1e-5)


def _kv(state):
    return [np.asarray(leaf) for leaf in jax.tree.leaves(state["blocks"])]


def test_prefill_chunk_and_decode_dense(model):
    """Per-slot chunk windows (full, partial, idle rows) then one decode
    step: logits and every cache row a slot can read agree."""
    jcfg, cfg, jparams, _, tparams = model
    B, C, cap = 3, 8, 32
    jst = JT.init_decode_state(jcfg, B, cap)
    jst["index"] = jnp.asarray([0, 5, 2], jnp.int32)
    tst = T.init_decode_state(cfg, B, cap, device=CPU)
    tst["index"] = torch.tensor([0, 5, 2], dtype=torch.int32)
    lengths = np.asarray([8, 3, 0], np.int32)
    toks = _tokens((B, C), 1)
    jl, jst = JT.prefill_chunk(jparams, jcfg, jnp.asarray(toks), jst,
                               jnp.asarray(lengths))
    tl, tst = T.prefill_chunk(tparams, cfg, torch.from_numpy(toks), tst,
                              torch.from_numpy(lengths))
    live = lengths > 0
    _close(tl.numpy()[live], np.asarray(jl)[live])
    np.testing.assert_array_equal(tst["index"].numpy(), [8, 8, 2])
    np.testing.assert_array_equal(np.asarray(jst["index"]), [8, 8, 2])
    tok = _tokens((B,), 2)
    jl, jst = JT.decode_step(jparams, jcfg, jnp.asarray(tok), jst)
    tl, tst = T.decode_step(tparams, cfg, torch.from_numpy(tok), tst)
    _close(tl, jl)
    # the whole caches agree, padding writes included
    for a, b in zip(_kv(tst), _kv(jst)):
        _close(a, b)


def test_prefill_scalar_index(model):
    jcfg, cfg, jparams, _, tparams = model
    toks = _tokens((2, 12), 3)
    jl, jst = JT.prefill(jparams, jcfg, jnp.asarray(toks),
                         JT.init_decode_state(jcfg, 2, 16))
    tl, tst = T.prefill(tparams, cfg, torch.from_numpy(toks),
                        T.init_decode_state(cfg, 2, 16, device=CPU))
    _close(tl, jl)
    assert int(tst["index"]) == int(jst["index"]) == 12
    for a, b in zip(_kv(tst), _kv(jst)):
        _close(a, b)
    tok = _tokens((2,), 4)
    jl, _ = JT.decode_step(jparams, jcfg, jnp.asarray(tok), jst)
    tl, _ = T.decode_step(tparams, cfg, torch.from_numpy(tok), tst)
    _close(tl, jl)


def test_dense_window_past_capacity_raises(model):
    _, cfg, _, _, tparams = model
    st = T.init_decode_state(cfg, 2, 8, device=CPU)
    st["index"] = torch.tensor([0, 6], dtype=torch.int32)
    with pytest.raises(ValueError, match="capacity"):
        T.prefill_chunk(tparams, cfg, torch.zeros(2, 4, dtype=torch.long),
                        st, torch.tensor([4, 4], dtype=torch.int32))


def test_paged_states_match(model):
    """Paged chunk + decode through page tables with sentinel entries,
    a write floor, and an idle slot whose index runs past its table:
    logits and every pool row but the garbage row agree."""
    jcfg, cfg, jparams, _, tparams = model
    B, C, pt, n_pages = 3, 8, 4, 12
    alloc = PageAllocator(n_pages, pt, B, table_pages=5)
    assert alloc.ensure(0, 8) and alloc.ensure(1, 11)
    tab = alloc.table_array()
    jst = JT.init_decode_state_paged(jcfg, B, n_pages, pt)
    tst = T.init_decode_state_paged(cfg, B, n_pages, pt, device=CPU)
    index = np.asarray([0, 3, 19], np.int32)     # slot 2 idles past its table
    jst["index"] = jnp.asarray(index)
    tst["index"] = torch.from_numpy(index)
    lengths = np.asarray([8, 8, 0], np.int32)
    floor = np.asarray([0, 3, 0], np.int32)
    toks = _tokens((B, C), 5)
    jl, jst = JT.prefill_chunk(jparams, jcfg, jnp.asarray(toks), jst,
                               jnp.asarray(lengths), pages=jnp.asarray(tab),
                               write_floor=jnp.asarray(floor))
    tl, tst = T.prefill_chunk(tparams, cfg, torch.from_numpy(toks), tst,
                              torch.from_numpy(lengths),
                              pages=torch.from_numpy(tab),
                              write_floor=torch.from_numpy(floor))
    live = lengths > 0
    _close(tl.numpy()[live], np.asarray(jl)[live])
    assert alloc.ensure(0, 9) and alloc.ensure(1, 12)
    tab = alloc.table_array()
    tok = _tokens((B,), 6)
    jl, jst = JT.decode_step(jparams, jcfg, jnp.asarray(tok), jst,
                             pages=jnp.asarray(tab),
                             write_floor=jnp.asarray(floor))
    tl, tst = T.decode_step(tparams, cfg, torch.from_numpy(tok), tst,
                            pages=torch.from_numpy(tab),
                            write_floor=torch.from_numpy(floor))
    _close(tl.numpy()[:2], np.asarray(jl)[:2])
    np.testing.assert_array_equal(tst["index"].numpy(),
                                  np.asarray(jst["index"]))
    # the garbage row takes colliding writes in either order
    for a, b in zip(_kv(tst), _kv(jst)):
        _close(a[:, :n_pages], b[:, :n_pages])


def _qk_vo_products(attn):
    """Per-head Q K^T and V O products of stacked attention weights."""
    wq, wk, wv, wo = (np.asarray(attn[k], np.float64)
                      for k in ("wq", "wk", "wv", "wo"))
    G = wq.shape[2] // wk.shape[2]
    qk = np.einsum("ldhq,lehq->lhde", wq, np.repeat(wk, G, axis=2))
    vo = np.einsum("ldhv,lhve->lhde", np.repeat(wv, G, axis=2), wo)
    return qk, vo


def test_decompose_and_prune_match(model):
    """SVD factors agree only up to sign and basis: compare spectra,
    the Q K^T / V O products, and logits."""
    jcfg, cfg, jparams, _, tparams = model
    jd, jdcfg, jex = jax_decompose(jparams, jcfg, peft=False)
    td, tdcfg, tex = clover_decompose(tparams, cfg)
    assert dataclasses.asdict(tdcfg) == dataclasses.asdict(jdcfg)
    for name in ("qk", "vo"):
        _close(tex[0]["spectra"][name], jex[0]["spectra"][name], atol=1e-5)
    toks = _tokens((2, 24), 7)
    base, _ = T.forward(tparams, cfg, toks, device=CPU)
    got, _ = T.forward(td, tdcfg, toks, device=CPU)
    _close(got, base)                       # decomposition preserves logits
    _close(got, JT.forward(jd, jdcfg, jnp.asarray(toks))[0])
    for stage in ("decomposed", "pruned"):
        if stage == "pruned":
            jd, jdcfg = jax_prune(jd, jdcfg, qk_ratio=0.5, vo_ratio=0.5)
            td, tdcfg = clover_prune(td, tdcfg, qk_ratio=0.5, vo_ratio=0.5)
            assert (tdcfg.qk_dim, tdcfg.vo_dim) == (16, 16)
            assert dataclasses.asdict(tdcfg) == dataclasses.asdict(jdcfg)
            assert td["blocks"][0]["attn"]["wk"].is_contiguous()
            got, _ = T.forward(td, tdcfg, toks, device=CPU)
            _close(got, JT.forward(jd, jdcfg, jnp.asarray(toks))[0])
        tqk, tvo = _qk_vo_products(to_numpy(td["blocks"][0]["attn"]))
        jqk, jvo = _qk_vo_products(jax.tree.map(np.asarray,
                                                jd["blocks"][0]["attn"]))
        _close(tqk, jqk, atol=1e-5)
        _close(tvo, jvo, atol=1e-5)


def test_plan_ranks_and_unported_modes(model):
    _, cfg, _, _, tparams = model
    full = get_config("gpt2-xl")
    assert plan_ranks(full, 0.5, 0.5) == (32, 32)
    assert plan_ranks(cfg, 0.5, 0.25) == (16, 24)
    with pytest.raises(ValueError, match="decomposed"):
        clover_prune(tparams, cfg, qk_ratio=0.5)
    # PEFT mode (CLOVER-S) is ported: the decomposed tree scores as the
    # reference's does on the same weights
    jparams, jcfg = model[2], model[0]
    toks = _tokens((2, 8))
    td, tdcfg, _ = clover_decompose(tparams, cfg, peft=True)
    jd, jdcfg, _ = jax_decompose(jparams, jcfg, peft=True)
    assert dataclasses.asdict(tdcfg) == dataclasses.asdict(jdcfg)
    assert {"s_qk", "s_vo"} <= set(td["blocks"][0]["attn"])
    got, _ = T.forward(td, tdcfg, toks, device=CPU)
    _close(got, JT.forward(jd, jdcfg, jnp.asarray(toks))[0])
    # RoPE is ported: the same weights under full RoPE score as the
    # reference's
    rope, jrope = (dataclasses.replace(c, rope=True, learned_pos=False)
                   for c in (cfg, jcfg))
    toks = _tokens((2, 12))
    got, _ = T.forward(tparams, rope, toks, device=CPU)
    _close(got, JT.forward(jparams, jrope, jnp.asarray(toks))[0])
