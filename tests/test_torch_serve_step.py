"""Serving under training's rules in the port against the JAX package:
``train.step.make_serve_step`` (FSDP weights gathered per layer, the
batch over "data", the dense cache split along its sequence over
"model"), the long cached prefill, bfloat16 compute through the kernels'
16-bit forms, ``remat_group`` and the plain decode's log-sum-exp.

The reference's ``prefill_step`` / ``decode_fn`` run unjitted on one
device with the JAX package's own init, bridged to the port.  Rank
groups of 2 and 4 processes are spawned under gloo on the CPU once per
module (``launch.serve.serve_step_ranks``, one torch thread each): the
2-rank group runs (data 2, model 1) and (1, 2), the 4-rank group (2, 2).
Every rank's greedy streams must equal the JAX run's and every step's
logits of its rows be within RTOL of it.

Tolerances: RTOL 1e-4 relative to the largest |logit| (float32 summed in
another order, as ``test_torch_dist_train.py``'s RTOL); bfloat16 compute
2e-2 relative (as the smoke's bfloat16-cache check; the two packages
round differently between the bfloat16 products); ``remat_group``
gradients bit for bit against g = 1 and within RTOL of the JAX step's;
the lse within 1e-5 of a float64 log-sum-exp.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import init_decode_state as jax_state  # noqa: E402
from repro.models import init_lm_params as jax_init  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.train import step as JS  # noqa: E402
from repro_torch.bridge import from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch.serve import (StepRun, run_steps,  # noqa: E402
                                      serve_step_ranks)
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.parallel import sharding as sh  # noqa: E402
from repro_torch.train import step as S  # noqa: E402
from repro_torch.tree import tree_leaves_with_path  # noqa: E402

CPU = "cpu"
RTOL = 1e-4
BF16_RTOL = 2e-2
RANK_TIMEOUT = 300.0
MODELS = ("gpt2-xl", "musicgen-large", "jamba-v0.1-52b", "rwkv6-1.6b",
          "qwen2-moe-a2.7b")
MESHES = {2: ((2, 1), (1, 2)), 4: ((2, 2),)}
NEW = 5


def _cfgs(name, **kw):
    """Reduced port and JAX configs (MoEs dropless: a capacity bound
    counts the tokens of one rank's rows, the reference's the global
    batch's)."""
    cfg, jcfg = (dataclasses.replace(c.reduced(), **kw)
                 for c in (get_config(name), jax_config(name)))
    if cfg.moe is not None:
        cfg, jcfg = (dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=0.0)) for c in (cfg, jcfg))
    return cfg, jcfg


def _params(jcfg, seed):
    jp = jax_init(jcfg, jax.random.PRNGKey(seed))
    return jp, from_numpy(jax.tree.map(np.asarray, jp), CPU)


def _batch(cfg, seed, B=4, S=12, more=5, cap=32):
    rng = np.random.default_rng(seed)
    return {"prompts": rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32),
        "more": None if not more else rng.integers(
            0, cfg.vocab_size, (B, more)).astype(np.int32),
        "new": NEW, "max_len": cap}


def _jax_greedy(jp, jcfg, batch):
    """The reference's ``make_serve_step`` steps, unjitted -> (streams,
    every step's logits).  The port's second prefill (positions from
    index S) is held to the reference's one prefill of the concatenated
    prompt: the reference's ``prefill`` numbers every prompt's positions
    from 0, so its own second prefill would not continue the sequence."""
    prefill, decode, _ = JS.make_serve_step(jcfg, None)
    prompts = batch["prompts"]
    B = prompts.shape[0]
    lg, state = prefill(jp, jnp.asarray(prompts),
                        jax_state(jcfg, B, batch["max_len"]))
    logits = [np.asarray(lg, np.float32)]
    if batch["more"] is not None:
        lg, state = prefill(jp, jnp.asarray(np.concatenate(
            [prompts, batch["more"]], 1)), jax_state(jcfg, B,
                                                     batch["max_len"]))
        logits.append(np.asarray(lg, np.float32))
    toks = [np.asarray(jnp.argmax(lg, -1))]
    for _ in range(batch["new"] - 1):
        lg, state = decode(jp, jnp.asarray(toks[-1]), state)
        logits.append(np.asarray(lg, np.float32))
        toks.append(np.asarray(jnp.argmax(lg, -1)))
    return np.stack(toks, 1).tolist(), logits


def _rel_close(got, want, rtol=RTOL, msg=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape, msg)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (msg, err, rtol * scale)


@pytest.fixture(scope="module")
def models():
    out = {}
    for i, name in enumerate(MODELS):
        cfg, jcfg = _cfgs(name)
        jp, tp_ = _params(jcfg, i)
        out[name] = (jp, jcfg, tp_, cfg, _batch(cfg, 10 + i))
    return out


@pytest.fixture(scope="module")
def jax_runs(models):
    return {name: _jax_greedy(jp, jcfg, batch)
            for name, (jp, jcfg, _, _, batch) in models.items()}


@pytest.fixture(scope="module")
def bf16_split():
    """gpt2-xl at bfloat16 params and compute for the sequence-split
    cache: a prefill of 40 <= ATTN_CHUNK tokens, then a second of 24 at
    index 40, over a capacity of 96 (windows of 48 at model 2: the
    second prefill spans both)."""
    cfg, jcfg = _cfgs("gpt2-xl", param_dtype="bfloat16",
                      compute_dtype="bfloat16")
    jp, tp_ = _params(jcfg, 13)
    return jp, jcfg, tp_, cfg, _batch(cfg, 14, B=2, S=40, more=24, cap=96)


@pytest.fixture(scope="module")
def rank_groups(models, bf16_split, tmp_path_factory):
    """One group per world size, each running every model on its
    meshes; the 2-rank group also ``bf16_split`` at (1, 2)."""
    out = {}
    for world, meshes in MESHES.items():
        runs = [StepRun(f"{name} {mesh}", tp_, cfg, mesh, [batch],
                        logits=True)
                for name, (_, _, tp_, cfg, batch) in models.items()
                for mesh in meshes]
        if world == 2:
            _, _, tp_, cfg, batch = bf16_split
            runs.append(StepRun("bf16 split", tp_, cfg, (1, 2), [batch],
                                logits=True))
        per_rank = serve_step_ranks(
            runs, world=world, backend="gloo", device=CPU,
            timeout=RANK_TIMEOUT, threads=1,
            workdir=str(tmp_path_factory.mktemp(f"steps{world}")))
        for i, r in enumerate(runs):
            out[r.label] = [per_rank[k][i] for k in range(world)]
    return out


def _check(got, want_streams, want_logits, mesh, rank, msg):
    assert got["streams"] == [want_streams], msg
    data = mesh[0]
    d = rank // mesh[1]
    for i, (a, b) in enumerate(zip(got["logits"], want_logits)):
        n = b.shape[0] // data
        _rel_close(a, b[d * n:(d + 1) * n], msg=f"{msg} step {i}")


@pytest.mark.parametrize("name", MODELS)
def test_one_device_matches_jax(models, jax_runs, name):
    _, _, tp_, cfg, batch = models[name]
    got = run_steps(StepRun(name, tp_, cfg, (1, 1), [batch], logits=True),
                    device=CPU)
    _check(got, *jax_runs[name], (1, 1), 0, name)
    assert sum(got["collectives"][k] for k in ("all_reduce", "all_gather",
                                               "reduce_scatter")) == 0


@pytest.mark.parametrize("mesh", [m for ms in MESHES.values() for m in ms],
                         ids=str)
@pytest.mark.parametrize("name", MODELS)
def test_ranks_match_jax(rank_groups, jax_runs, name, mesh):
    """Every rank's streams and its rows' logits; at model 2 the cache
    splits along its sequence (capacity 32: rank 1's window [16, 32) is
    empty until the second prefill and decode reach it)."""
    ranks = rank_groups[f"{name} {mesh}"]
    for rank, got in enumerate(ranks):
        _check(got, *jax_runs[name], mesh, rank, f"{name} {mesh} r{rank}")
        c = got["collectives"]
        if mesh[0] > 1:     # FSDP: every layer's weights gathered
            assert c["all_gather"] > 0
        if mesh[1] > 1 and name != "rwkv6-1.6b":   # lse combines
            assert c["all_reduce"] > 0


def test_long_prefill_and_second_prefill_match_jax():
    """A whole-batch prefill of 600 > ATTN_CHUNK tokens (the flash path
    over the live window; the reference's chunked path), then a second
    prefill of 520 at index 600."""
    cfg, jcfg = _cfgs("stablelm-3b")
    jp, tp_ = _params(jcfg, 7)
    rng = np.random.default_rng(3)
    batch = {"prompts": rng.integers(0, 512, (2, 600)).astype(np.int32),
             "more": rng.integers(0, 512, (2, 520)).astype(np.int32),
             "new": 3, "max_len": 1124}
    streams, logits = _jax_greedy(jp, jcfg, batch)
    got = run_steps(StepRun("long", tp_, cfg, (1, 1), [batch], logits=True),
                    device=CPU)
    _check(got, streams, logits, (1, 1), 0, "long prefill")


def test_bf16_compute_matches_jax_bf16():
    """bfloat16 params and compute: the decode kernels and the flash
    kernel's scoring pass take bfloat16 operands (the TPU kernels' 16-bit
    function), the cache windows the window form on bfloat16 operands
    (the reference's XLA attention there)."""
    cfg, jcfg = _cfgs("gpt2-xl", param_dtype="bfloat16",
                      compute_dtype="bfloat16")
    jp, tp_ = _params(jcfg, 5)
    batch = _batch(cfg, 6)
    _, want = _jax_greedy(jp, jcfg, batch)
    got = run_steps(StepRun("bf16", tp_, cfg, (1, 1), [batch], logits=True),
                    device=CPU)
    # the first steps' logits (greedy streams may part at a bf16 near-tie)
    for i in range(2):
        _rel_close(got["logits"][i], want[i], BF16_RTOL, f"bf16 step {i}")


def test_bf16_long_prefill_and_second_prefill_match_jax():
    """bfloat16 compute over the cache windows: gpt2-xl reduced to 2
    narrow layers, a whole-batch prefill of 600 > ATTN_CHUNK tokens, then
    a second of 520 at index 600, through the window form (its plain
    version once a layer a prefill, never ``attention_ref``), against the
    JAX ``make_serve_step`` at bfloat16: the first steps' logits within
    BF16_RTOL."""
    cfg, jcfg = _cfgs("gpt2-xl", n_layers=2, param_dtype="bfloat16",
                      compute_dtype="bfloat16")
    jp, tp_ = _params(jcfg, 11)
    rng = np.random.default_rng(12)
    batch = {"prompts": rng.integers(0, cfg.vocab_size, (2, 600)).astype(
        np.int32),
        "more": rng.integers(0, cfg.vocab_size, (2, 520)).astype(np.int32),
        "new": 3, "max_len": 1124}
    _, want = _jax_greedy(jp, jcfg, batch)
    before = (ref.window_attention_ref.calls, ref.attention_ref.calls)
    got = run_steps(StepRun("bf16 long", tp_, cfg, (1, 1), [batch],
                            logits=True), device=CPU)
    assert (ref.window_attention_ref.calls - before[0],
            ref.attention_ref.calls - before[1]) == (2 * cfg.n_layers, 0)
    for i in range(2):
        _rel_close(got["logits"][i], want[i], BF16_RTOL,
                   f"bf16 long step {i}")


def test_bf16_sequence_split_matches_jax_bf16(rank_groups, bf16_split):
    """bfloat16 compute over the sequence-split cache at (1, 2): each
    rank's prefill windows go through the window form (the masked path's
    scale order at these lengths; its plain version once a layer a
    prefill, ``attention_ref`` never), and the first steps' logits are
    within BF16_RTOL of the JAX ``make_serve_step`` at bfloat16."""
    jp, jcfg, _, cfg, batch = bf16_split
    _, want = _jax_greedy(jp, jcfg, batch)
    for rank, got in enumerate(rank_groups["bf16 split"]):
        n = got["launches"]
        assert (n["window_attention_ref"], n["attention_ref"]) == (
            2 * cfg.n_layers, 0), (rank, n)
        for i in range(2):
            _rel_close(got["logits"][i], want[i], BF16_RTOL,
                       f"bf16 split r{rank} step {i}")


def _grads(cfg, params, tokens, labels):
    (_, _), g = S._value_and_grad(
        lambda tr: S.loss_fn(tr, cfg, tokens, labels, remat=True,
                             device=CPU), params)
    return {p: x for p, x in tree_leaves_with_path(g) if x is not None}


def test_remat_group_matches_g1_and_jax():
    """remat_group 2 over 4 blocks: the loss's gradients bit for bit
    g = 1's and within RTOL of the JAX step's (its grouped scan)."""
    cfg, jcfg = _cfgs("stablelm-3b", n_layers=4, remat_group=2)
    jp, tp_ = _params(jcfg, 2)
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, 512, (2, 16)).astype(np.int32)
    labels = rng.integers(0, 512, (2, 16)).astype(np.int32)
    g2 = _grads(cfg, tp_, torch.as_tensor(tokens), labels)
    g1 = _grads(dataclasses.replace(cfg, remat_group=1), tp_,
                torch.as_tensor(tokens), labels)
    assert g1.keys() == g2.keys()
    for p in g1:
        assert torch.equal(g1[p], g2[p]), p
    jg = jax.grad(lambda p: JS.loss_fn(p, jcfg, jnp.asarray(tokens),
                                       jnp.asarray(labels))[0])(jp)
    jleaves = {p: np.asarray(x) for p, x in
               jax.tree_util.tree_leaves_with_path(jg)}
    jleaves = {jax.tree_util.keystr(p): x for p, x in jleaves.items()}
    for p, x in g2.items():
        _rel_close(x.numpy(), jleaves[p], msg=p)


def test_chunked_training_attention_matches_jax():
    """The training forward at S = 640 > ATTN_CHUNK: the chunked plain
    attention, each block checkpointed, against the reference's chunked
    XLA path; its gradient against the unchunked plain attention's."""
    cfg, jcfg = _cfgs("stablelm-3b", n_layers=1)
    jp, tp_ = _params(jcfg, 8)
    tokens = np.random.default_rng(9).integers(0, 512, (1, 640)).astype(
        np.int32)
    got, _ = T.train_forward(tp_, cfg, torch.as_tensor(tokens), remat=True,
                             plain_attention=True, device=CPU)
    want, _ = JT.forward(jp, jcfg, jnp.asarray(tokens))
    _rel_close(got.detach().numpy(), np.asarray(want), msg="logits")
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 600, 4, 8, generator=g, requires_grad=True)
               for _ in range(3))
    a = L._causal_attention_chunked(q, k, v, 0.3)
    b = ref.attention_ref(q, k, v, scale=0.3)
    _rel_close(a.detach().numpy(), b.detach().numpy(), msg="chunked")
    ga = torch.autograd.grad(a.square().sum(), (q, k, v))
    gb = torch.autograd.grad(b.square().sum(), (q, k, v))
    for x, y in zip(ga, gb):
        _rel_close(x.numpy(), y.numpy(), msg="chunked grad")


def test_plain_lse_matches_float64():
    g = torch.Generator().manual_seed(1)
    B, T, KV, G, d = 3, 40, 2, 2, 8
    q = torch.randn(B, KV * G, d, generator=g)
    k = torch.randn(B, T, KV, d, generator=g) * 3
    v = torch.randn(B, T, KV, d, generator=g)
    lengths = torch.tensor([40, 17, 0], dtype=torch.int32)
    out, lse = ref.decode_attention_ref(q, k, v, lengths, scale=0.5,
                                        return_lse=True)
    assert torch.equal(out, ref.decode_attention_ref(q, k, v, lengths,
                                                     scale=0.5))
    logits = torch.einsum("bkgd,btkd->bkgt", q.double().reshape(B, KV, G, d),
                          k.double()) * 0.5
    for b, n in enumerate(lengths.tolist()):
        if n == 0:
            assert torch.isinf(lse[b]).all() and (lse[b] < 0).all()
            assert torch.equal(out[b], torch.zeros_like(out[b]))
            continue
        want = torch.logsumexp(logits[b, ..., :n], -1).reshape(-1)
        np.testing.assert_allclose(lse[b].double(), want, rtol=0, atol=1e-5)


def test_combine_of_windows_equals_one_call():
    """Two windows' (out, lse) merged as ``combine_seq_partials`` merges
    them over "model" equal one call over the whole cache."""
    g = torch.Generator().manual_seed(2)
    B, T, KV, G, d = 2, 64, 2, 2, 8
    q = torch.randn(B, KV * G, d, generator=g)
    k = torch.randn(B, T, KV, d, generator=g)
    v = torch.randn(B, T, KV, d, generator=g)
    lengths = torch.tensor([50, 20], dtype=torch.int32)
    whole = ref.decode_attention_ref(q, k, v, lengths, scale=0.4)
    parts = []
    for lo in (0, 32):
        ln = (lengths - lo).clamp(0, 32).to(torch.int32)
        parts.append(ref.decode_attention_ref(
            q, k[:, lo:lo + 32], v[:, lo:lo + 32], ln, scale=0.4,
            return_lse=True))
    lse = torch.stack([p[1] for p in parts])
    mx = lse.max(0).values
    w = torch.exp(lse - mx)
    got = (w[..., None] * torch.stack([p[0] for p in parts])).sum(0) / \
        w.sum(0)[..., None]
    np.testing.assert_allclose(got, whole, rtol=0, atol=1e-6)
    assert sh.combine_seq_partials(whole, lse[0], None) is whole
