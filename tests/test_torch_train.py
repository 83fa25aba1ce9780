"""The port's training half against the JAX package on the same
(numpy-bridged) weights and data: ``SyntheticLM`` batches, AdamW and its
schedules, ``loss_fn`` and its per-leaf gradients (reduced gpt2-xl, and
reduced jamba for the MoE aux losses), ``make_train_step`` full and in
``peft_mode`` with 1 and 2 microbatches, remat, and the training
attention's explicit plain path.

Tolerances: bitwise on the data; 1e-6 relative on AdamW (float32
elementwise, the global norm summed in another order); 1e-4 relative on
losses, gradients and trained weights (float32 through the layers,
summed in another order), each leaf against its own largest magnitude.
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
from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import clover_decompose as jax_decompose  # noqa: E402
from repro.data import SyntheticConfig as JSynthConfig  # noqa: E402
from repro.data import SyntheticLM as JSynthLM  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.models import init_lm_params as jax_init  # noqa: E402
from repro.train import step as JS  # noqa: E402
from repro_torch import optim as O  # noqa: E402
from repro_torch.bridge import from_numpy, to_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import peft  # noqa: E402
from repro_torch.data import SyntheticConfig, SyntheticLM  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.train import step as S  # noqa: E402
from repro_torch.tree import tree_leaves_with_path, tree_map  # noqa: E402

CPU = "cpu"
ADAM_RTOL = 1e-6
RTOL = 1e-4


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _rel_close(got, want, rtol):
    """|got - want| <= rtol * max(|want|) leafwise (and shapes equal)."""
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.max(np.abs(want))) if want.size else 0.0, 1e-30)
    err = float(np.max(np.abs(got.astype(np.float64) - want))) \
        if want.size else 0.0
    assert err <= rtol * scale, (err, rtol * scale)


def _flat(tree):
    return {p: x for p, x in tree_leaves_with_path(tree)}


def _jflat(tree):
    return {jax.tree_util.keystr(p): x for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _trees_close(got, want, rtol):
    g, w = _flat(to_numpy(got)), _jflat(jax.tree.map(np.asarray, want))
    g = {p: x for p, x in g.items() if x is not None}
    assert set(g) == set(w), set(g) ^ set(w)   # jax drops None leaves
    for path, leaf in g.items():
        _rel_close(leaf, w[path], rtol)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seq,batch,seed", [(64, 16, 0), (17, 3, 99),
                                             (1024, 2, 0)])
def test_synthetic_batches_bitwise(seq, batch, seed):
    kw = dict(vocab_size=512 if seq < 1024 else 50257, seq_len=seq,
              global_batch=batch, seed=seed)
    ours, theirs = SyntheticLM(SyntheticConfig(**kw)), \
        JSynthLM(JSynthConfig(**kw))
    assert np.array_equal(ours.patterns, theirs.patterns)
    for step in (0, 1, 1000, 10_003):
        a, b = ours.batch_at(step), theirs.batch_at(step)
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype == np.int32
            assert np.array_equal(a[k], b[k])
    for _ in range(3):
        a, b = next(ours), next(theirs)
        assert np.array_equal(a["tokens"], b["tokens"])
    assert ours.state_dict() == theirs.state_dict() == {"step": 3,
                                                         "seed": seed}


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def _adam_tree(rng):
    """Leaves of ndim 0..3, a stacked (n_blocks, D) norm scale and a
    ``None`` (frozen) leaf, as a peft split has."""
    return {"blocks": ({"norm1": {"scale": rng.normal(size=(3, 8))},
                        "w": rng.normal(size=(3, 8, 5))},),
            "final_norm": {"scale": rng.normal(size=(8,))},
            "embed": rng.normal(size=(6, 8)),
            "frozen": None}


def _cast(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


@pytest.mark.parametrize("grad_clip", [0.5, 0.0])
def test_adamw_five_steps_match(grad_clip):
    rng = np.random.default_rng(3)
    params = _cast(_adam_tree(rng))
    ocfg = dict(lr=1e-2, weight_decay=0.1, grad_clip=grad_clip)
    jp, jo = jax.tree.map(jnp.asarray, params), None
    tp = from_numpy(params, CPU)
    jo, to = JO.adamw_init(jp), O.adamw_init(tp)
    assert to["m"]["frozen"] is None and to["step"].dtype == torch.int32
    for i in range(5):
        grads = _cast(_adam_tree(rng))
        jscale = JO.warmup_cosine(jo["step"], warmup=2, total=5)
        tscale = O.warmup_cosine(to["step"], warmup=2, total=5)
        _rel_close(tscale, jscale, ADAM_RTOL)
        jp, jo, jgn = JO.adamw_update(jax.tree.map(jnp.asarray, grads), jo,
                                      jp, JO.AdamWConfig(**ocfg), jscale)
        tp, to, tgn = O.adamw_update(from_numpy(grads, CPU), to, tp,
                                     O.AdamWConfig(**ocfg), tscale)
        _rel_close(tgn, jgn, ADAM_RTOL)
        assert int(to["step"]) == int(jo["step"]) == i + 1
        for got, want in ((tp, jp), (to["m"], jo["m"]), (to["v"], jo["v"])):
            _trees_close(got, want, ADAM_RTOL)


def test_adamw_decay_rule_copies_the_reference():
    """``ndim >= 2`` decides weight decay in both packages: the stacked
    (n_blocks, D) norm scale is decayed, ``final_norm`` (D,) is not."""
    p = {"blocks": ({"scale": torch.ones((2, 4))},),
         "final_norm": {"scale": torch.ones(4)}}
    g = {"blocks": ({"scale": torch.zeros((2, 4))},),
         "final_norm": {"scale": torch.zeros(4)}}
    cfg = O.AdamWConfig(lr=0.1, weight_decay=0.5, grad_clip=0.0)
    new, _, _ = O.adamw_update(g, O.adamw_init(p), p, cfg)
    assert torch.allclose(new["blocks"][0]["scale"], torch.full((2, 4),
                                                                0.95))
    assert torch.equal(new["final_norm"]["scale"], torch.ones(4))
    jnew, _, _ = JO.adamw_update(jax.tree.map(lambda t: jnp.asarray(_np(t)),
                                              g),
                                 JO.adamw_init(jax.tree.map(
                                     lambda t: jnp.asarray(_np(t)), p)),
                                 jax.tree.map(lambda t: jnp.asarray(_np(t)),
                                              p),
                                 JO.AdamWConfig(lr=0.1, weight_decay=0.5,
                                                grad_clip=0.0))
    _trees_close(new, jnew, ADAM_RTOL)


def test_schedules_match():
    for warmup, total in ((0, 10), (3, 10), (100, 10_000), (5, 5)):
        for step in (0, 1, 2, 3, 4, 5, 7, 10, 11, 5000, 20_000):
            js = jnp.asarray(step, jnp.int32)
            ts = torch.tensor(step, dtype=torch.int32)
            _rel_close(O.warmup_cosine(ts, warmup=warmup, total=total),
                       JO.warmup_cosine(js, warmup=warmup, total=total),
                       ADAM_RTOL)
            _rel_close(O.warmup_linear(ts, warmup=warmup, total=total),
                       JO.warmup_linear(js, warmup=warmup, total=total),
                       ADAM_RTOL)
    # the first update of a train step has lr 0
    assert float(O.warmup_cosine(torch.tensor(0), warmup=2, total=4)) == 0.0


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

def _dropless(cfg):
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=0.0))


def _pair(name, seed, **over):
    jcfg = jax_config(name).reduced(**over)
    cfg = get_config(name).reduced(**over)
    if cfg.moe is not None:
        jcfg, cfg = _dropless(jcfg), _dropless(cfg)
    jp = jax_init(jcfg, jax.random.PRNGKey(seed))
    return jp, jcfg, from_numpy(jax.tree.map(np.asarray, jp), CPU), cfg


def _batch(cfg, B=2, S=12, seed=0, masked=True):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    if masked:
        labels[0, -3:] = -1          # padding: masked from the loss
    return {"tokens": tokens, "labels": labels}


@pytest.mark.parametrize("name", ["gpt2-xl", "jamba-v0.1-52b"])
def test_loss_and_grads_match(name):
    over = {"n_layers": 8} if name.startswith("jamba") else {}
    jp, jcfg, tp, cfg = _pair(name, 1, **over)
    b = _batch(cfg)
    (jl, jm), jg = jax.value_and_grad(JS.loss_fn, has_aux=True)(
        jp, jcfg, jnp.asarray(b["tokens"]), jnp.asarray(b["labels"]),
        remat=True)
    (tl, tm), tg = S._value_and_grad(
        lambda p: S.loss_fn(p, cfg, b["tokens"], b["labels"], remat=True,
                            device=CPU), tp)
    _rel_close(tl, jl, RTOL)
    for k in jm:
        _rel_close(tm[k], jm[k], RTOL)
    if cfg.moe is not None:   # the aux losses are in the total
        assert float(tm["moe_load_balance"]) > 0
        _rel_close(tl, sum(float(v) for v in tm.values()), 1e-6)
    _trees_close(tg, jg, RTOL)


def test_remat_on_and_off_agree():
    _, _, tp, cfg = _pair("gpt2-xl", 2)
    b = _batch(cfg, seed=4)
    outs = [S._value_and_grad(
        lambda p, r=remat: S.loss_fn(p, cfg, b["tokens"], b["labels"],
                                     remat=r, device=CPU), tp)
        for remat in (True, False)]
    (l1, _), g1 = outs[0]
    (l2, _), g2 = outs[1]
    assert abs(float(l1) - float(l2)) <= 1e-6 * abs(float(l2))
    f1, f2 = _flat(g1), _flat(g2)
    for k in f1:
        assert torch.allclose(f1[k], f2[k], rtol=0,
                              atol=1e-6 * float(f2[k].abs().max()) + 1e-12)


def test_forward_scores_without_a_graph():
    _, _, tp, cfg = _pair("gpt2-xl", 2)
    tp = {**tp, "embed": tp["embed"].requires_grad_(True)}
    logits, _ = T.forward(tp, cfg, _batch(cfg)["tokens"], device=CPU)
    assert not logits.requires_grad
    logits, _ = T.train_forward(tp, cfg, _batch(cfg)["tokens"], remat=False,
                                plain_attention=True, device=CPU)
    assert logits.requires_grad


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def step_model():
    """Reduced gpt2-xl, and its JAX CLOVER-S (peft) decomposition with
    the Up path, on the same weights in both packages."""
    jp, jcfg, tp, cfg = _pair("gpt2-xl", 7)
    jd, jdcfg, _ = jax_decompose(jp, jcfg, peft=True)
    td = from_numpy(jax.tree.map(np.asarray, jd), CPU)
    dcfg = dataclasses.replace(cfg, clover=dataclasses.replace(
        cfg.clover, enabled=True, finetune_s=True))
    assert dataclasses.asdict(dcfg) == dataclasses.asdict(jdcfg)
    return (jp, jcfg, tp, cfg), (jd, jdcfg, td, dcfg)


@pytest.mark.parametrize("peft_mode", [False, True])
@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_five_steps_match(step_model, peft_mode, microbatches):
    (jp, jcfg, tp, cfg) = step_model[1] if peft_mode else step_model[0]
    ocfg = dict(lr=3e-3, weight_decay=0.1, grad_clip=1.0)
    kw = dict(warmup_steps=2, total_steps=5, remat=True, peft_mode=peft_mode,
              microbatches=microbatches)
    jstep, _ = JS.make_train_step(
        jcfg, JS.TrainConfig(optimizer=JO.AdamWConfig(**ocfg), **kw),
        make_host_mesh())
    jstep = jax.jit(jstep)
    tstep = S.make_train_step(
        cfg, S.TrainConfig(optimizer=O.AdamWConfig(**ocfg), **kw),
        device=CPU)
    jo = JS.make_opt_state(jp, peft_mode=peft_mode)
    to = S.make_opt_state(tp, peft_mode=peft_mode)
    t0 = tp
    for i in range(5):
        b = _batch(cfg, B=4, S=10, seed=10 + i, masked=(i == 2))
        jp, jo, jm = jstep(jp, jo, {k: jnp.asarray(v) for k, v in b.items()})
        tp, to, tm = tstep(tp, to, b)
        for k in ("loss", "grad_norm", "lr_scale"):
            _rel_close(tm[k], jm[k], RTOL)
    _trees_close(tp, jp, RTOL)
    _trees_close(to["m"], jo["m"], RTOL)
    if peft_mode:   # only the CLOVER-S transitions moved, the rest bitwise
        train, _ = peft.partition(tp)
        for path, leaf in _flat(tp).items():
            before = _flat(t0)[path]
            if _flat(train)[path] is None:
                assert leaf is before or torch.equal(leaf, before), path
            else:
                assert not torch.equal(leaf, before), path


# ---------------------------------------------------------------------------
# the training attention is explicit
# ---------------------------------------------------------------------------

def test_kernels_refuse_inputs_that_require_grad(monkeypatch):
    """On the card (faked: ``_on_cuda`` says yes) the kernel wrappers
    refuse inputs that require grad -- they have no backward -- and
    ``plain=True`` runs the plain version under autograd."""
    monkeypatch.setattr(ops, "_on_cuda", lambda t: True)
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 4, 2, 8), generator=g).requires_grad_(True)
               for _ in range(3))
    with pytest.raises(RuntimeError, match="no backward"):
        ops.clover_attention(q, k, v, scale=0.3)
    out = ops.clover_attention(q, k, v, scale=0.3, plain=True)
    out.sum().backward()
    assert q.grad is not None
    r, kk, vv, w = (torch.randn((1, 2, 3, 4), generator=g) for _ in range(4))
    u = torch.randn((2, 4), generator=g).requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.wkv6(r, kk, vv, w, u)
    dt, x = torch.rand((1, 3, 4)).requires_grad_(True), torch.randn((1, 3, 4))
    A, Bm, C = torch.rand((4, 2)), torch.randn((1, 3, 2)), torch.randn(
        (1, 3, 2))
    with pytest.raises(RuntimeError, match="no backward"):
        ops.mamba_scan(dt, A, Bm, C, x)
    assert ops.mamba_scan(dt, A, Bm, C, x, plain=True)[0].requires_grad
    # the training forward names the plain path, so it runs there too
    _, _, tp, cfg = _pair("gpt2-xl", 2)
    tp = tree_map(lambda a: a.requires_grad_(True), tp)
    logits, _ = T.train_forward(tp, cfg, _batch(cfg)["tokens"], remat=True,
                                plain_attention=True, device=CPU)
    assert logits.requires_grad
    with pytest.raises(RuntimeError, match="no backward"):
        T.train_forward(tp, cfg, _batch(cfg)["tokens"], remat=False,
                        plain_attention=False, device=CPU)
