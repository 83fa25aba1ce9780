"""The paper's training-free results in the port against the JAX
package: ``vanilla_prune``, Fig. 2's curves (``qk_curves``,
``vo_curves``, ``energy_topk``) on seeded weights, and the gate on
trained weights -- ``benchmarks.common.pretrain_base()`` (a tiny GPT-2
trained 300 steps by the JAX package), bridged as numpy: both packages'
no-fine-tune CLOVER and vanilla perplexities at Table 1's ratios,
``fig3_trainfree.py``'s threshold plan and checks, and the trained row of
``fig2_spectrum.py``.  The adapter analytics of Figs. 4-6
(``projection_mass``, ``coverage``, ``delta_spectrum``,
``effective_rank``, ``intruder_dims``) against the JAX package's on
seeded inputs, and ``fig4_projection.py``'s and ``fig56_rank.py``'s
procedures and checks run by the port on the trained weights.

Tolerances: vanilla pruning gathers the same entries (bitwise weights
when the importance order agrees); 1e-4 relative on logits and
perplexities, 1e-5 relative on spectra, energy fractions and
coverages; counts exactly.
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

from benchmarks import common as BC  # noqa: E402
from benchmarks import fig2_spectrum as BF2  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import analytics as JA  # noqa: E402
from repro.core.decompose import \
    svd_lowrank_product as jax_lowrank  # noqa: E402
from repro.core import clover_decompose as jax_decompose  # noqa: E402
from repro.core import clover_prune as jax_prune  # noqa: E402
from repro.core import threshold_ratios as jax_threshold  # noqa: E402
from repro.core import vanilla_prune as jax_vanilla  # noqa: E402
from repro.models import init_lm_params as jax_init  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.bridge import from_numpy, to_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import analytics as A  # noqa: E402
from repro_torch.core.decompose import (clover_decompose,  # noqa: E402
                                        merge_clover, svd_lowrank_product)
from repro_torch.core.peft import (PeftConfig, init_adapters,  # noqa: E402
                                   materialize)
from repro_torch.core.prune import (clover_prune,  # noqa: E402
                                    threshold_ratios, vanilla_prune)
from repro_torch.data import SyntheticConfig, SyntheticLM  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.train import (TrainConfig, make_adapter_step,  # noqa: E402
                               make_opt_state, make_train_step)

CPU = "cpu"
RTOL = 1e-4
SVD_RTOL = 1e-5
RATIOS = (0.25, 0.5, 0.75)        # benchmarks/table1_pruning.py


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _rel_close(got, want, rtol):
    got, want = _np(got).astype(np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.max(np.abs(got - want)))
    assert err <= rtol * max(float(np.max(np.abs(want))), 1e-30), err


CASES = {"G1": {}, "G4": {"n_kv_heads": 1}}


@pytest.fixture(scope="module", params=list(CASES))
def seeded(request):
    over = CASES[request.param]
    jcfg = jax_config("gpt2-xl").reduced(**over)
    cfg = get_config("gpt2-xl").reduced(**over)
    jp = jax_init(jcfg, jax.random.PRNGKey(21))
    return jp, jcfg, from_numpy(jax.tree.map(np.asarray, jp), CPU), cfg


@pytest.mark.parametrize("qk_ratio,vo_ratio", [(0.5, 0.5), (0.25, 0.75),
                                               (0.0, 0.5)])
def test_vanilla_prune_matches(seeded, qk_ratio, vo_ratio):
    jp, jcfg, tp, cfg = seeded
    jv, jvcfg = jax_vanilla(jp, jcfg, qk_ratio=qk_ratio, vo_ratio=vo_ratio)
    tv, tvcfg = vanilla_prune(tp, cfg, qk_ratio=qk_ratio, vo_ratio=vo_ratio)
    assert dataclasses.asdict(tvcfg) == dataclasses.asdict(jvcfg)
    got = to_numpy(tv["blocks"][0]["attn"])
    want = jax.tree.map(np.asarray, jv["blocks"][0]["attn"])
    for k in want:                   # the same entries, gathered
        assert np.array_equal(got[k], want[k]), k
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 12))
    _rel_close(T.forward(tv, tvcfg, toks, device=CPU)[0],
               JT.forward(jv, jvcfg, jnp.asarray(toks))[0], RTOL)


def test_vanilla_topk_breaks_ties_like_lax():
    from repro_torch.core.prune import _top_sorted
    imp = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0]])
    assert _top_sorted(imp, 2).tolist() == [[1, 2]]
    _, idx = jax.lax.top_k(jnp.asarray(imp.numpy()), 2)
    assert sorted(np.asarray(idx)[0].tolist()) == [1, 2]


def test_curves_and_energy_match(seeded):
    jp, jcfg, tp, cfg = seeded
    G = cfg.q_per_kv
    for i in range(cfg.n_blocks):
        jattn = jax.tree.map(lambda a: a[i], jp["blocks"][0]["attn"])
        tattn = {k: v[i] for k, v in tp["blocks"][0]["attn"].items()}
        for jf, tf in ((JA.qk_curves, A.qk_curves),
                       (JA.vo_curves, A.vo_curves)):
            (jS, jvan), (tS, tvan) = jf(jattn, G), tf(tattn, G)
            _rel_close(tS, jS, SVD_RTOL)
            _rel_close(tvan, jvan, SVD_RTOL)
            for k in (1, 8, cfg.head_dim_ // 4):
                _rel_close(A.energy_topk(tS, k), JA.energy_topk(jS, k),
                           SVD_RTOL)
                _rel_close(A.energy_topk(tvan, k), JA.energy_topk(jvan, k),
                           SVD_RTOL)


# ---------------------------------------------------------------------------
# the gate: Table 1 (no fine-tune), Fig. 3 and Fig. 2 on trained weights
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trained():
    """``pretrain_base()``'s tiny GPT-2 (300 JAX steps), in both
    packages, with the same held-out data stream."""
    jp, jcfg, jdata = BC.pretrain_base()
    cfg = get_config("gpt2-xl").reduced(
        n_layers=4, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
        d_ff=256, vocab_size=512)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    data = SyntheticLM(SyntheticConfig(**dataclasses.asdict(jdata.cfg)))
    return jp, jcfg, jdata, from_numpy(jax.tree.map(np.asarray, jp), CPU), \
        cfg, data


def perplexity(params, cfg, data, *, n_batches=8, start=10_000):
    """``benchmarks.common.perplexity`` on the port: eval PPL on held-out
    stream positions."""
    tot, cnt = 0.0, 0
    for i in range(n_batches):
        b = data.batch_at(start + i)
        logits, _ = T.forward(params, cfg, b["tokens"], device=CPU)
        logp = torch.log_softmax(logits.float(), -1)
        nll = -logp.gather(-1, torch.as_tensor(b["labels"]).long()[..., None])
        tot += float(nll.double().sum())
        cnt += nll.numel()
    return float(np.exp(tot / cnt))


def test_table1_no_finetune_perplexities(trained):
    jp, jcfg, jdata, tp, cfg, data = trained
    base = perplexity(tp, cfg, data)
    _rel_close(base, BC.perplexity(jp, jcfg, jdata), RTOL)
    jd, jdcfg, _ = jax_decompose(jp, jcfg, peft=False)
    td, tdcfg, _ = clover_decompose(tp, cfg)
    for ratio in RATIOS:
        jc, jccfg = jax_prune(jd, jdcfg, qk_ratio=ratio, vo_ratio=ratio)
        tc, tccfg = clover_prune(td, tdcfg, qk_ratio=ratio, vo_ratio=ratio)
        jv, jvcfg = jax_vanilla(jp, jcfg, qk_ratio=ratio, vo_ratio=ratio)
        tv, tvcfg = vanilla_prune(tp, cfg, qk_ratio=ratio, vo_ratio=ratio)
        clover, vanilla = perplexity(tc, tccfg, data), \
            perplexity(tv, tvcfg, data)
        _rel_close(clover, BC.perplexity(jc, jccfg, jdata), RTOL)
        _rel_close(vanilla, BC.perplexity(jv, jvcfg, jdata), RTOL)
        # table1_pruning.py's ordering: CLOVER below vanilla at every ratio
        assert clover < vanilla, (ratio, clover, vanilla)


def test_fig3_trainfree_checks(trained):
    """``fig3_trainfree.py`` on the port: the threshold plan from the
    spectra, CLOVER nearly unchanged, vanilla at the same ratios worse;
    the plan and perplexities as the JAX package's."""
    jp, jcfg, jdata, tp, cfg, data = trained
    base = perplexity(tp, cfg, data)
    dp, dcfg, extras = clover_decompose(tp, cfg)
    s, s_vo = (_np(extras[0]["spectra"][k]) for k in ("qk", "vo"))
    qk_t = float(np.quantile(s, 0.45))
    vo_t = float(np.quantile(s_vo, 0.30))
    plan = threshold_ratios(extras, dcfg, qk_thresh=qk_t, vo_thresh=vo_t)
    _, jdcfg, jex = jax_decompose(jp, jcfg, peft=False)
    jplan = jax_threshold(jex, jdcfg,
                          qk_thresh=float(jnp.quantile(
                              jex[0]["spectra"]["qk"], 0.45)),
                          vo_thresh=float(jnp.quantile(
                              jex[0]["spectra"]["vo"], 0.30)))
    for k in ("qk_keep", "vo_keep", "qk_ratio", "vo_ratio"):
        assert plan[k] == jplan[k], k
    cp, ccfg = clover_prune(dp, dcfg, qk_ratio=plan["qk_ratio"],
                            vo_ratio=plan["vo_ratio"])
    vp, vcfg = vanilla_prune(tp, cfg, qk_ratio=plan["qk_ratio"],
                             vo_ratio=plan["vo_ratio"])
    ppl_c, ppl_v = perplexity(cp, ccfg, data), perplexity(vp, vcfg, data)
    assert plan["qk_ratio"] > 0.1                 # some_pruning_happened
    assert ppl_c < 1.6 * base                     # clover_nearly_unchanged
    assert ppl_v > ppl_c                          # vanilla_degrades_more


def test_fig2_trained_row(trained):
    """``fig2_spectrum.py``'s trained row: the energy in the top 25% of
    the Q-K and V-O curves of the first attention layer, as JAX's, and
    the trained gap."""
    jp, jcfg, _, tp, cfg, _ = trained
    G, k = cfg.q_per_kv, max(1, cfg.head_dim_ // 4)
    tattn = {n: v[0] for n, v in tp["blocks"][0]["attn"].items()}
    jattn = BF2._first_attn(jcfg, jp)
    row = {}
    for name, tf, jf in (("qk", A.qk_curves, JA.qk_curves),
                         ("vo", A.vo_curves, JA.vo_curves)):
        (tS, tvan), (jS, jvan) = tf(tattn, G), jf(jattn, G)
        for kind, t, j in (("clover", tS, jS), ("vanilla", tvan, jvan)):
            got = float(A.energy_topk(t, k).mean())
            _rel_close(got, float(jnp.mean(JA.energy_topk(j, k))), SVD_RTOL)
            row[f"{name}_{kind}_top25"] = got
    assert row["qk_clover_top25"] >= row["qk_vanilla_top25"] - 1e-6
    assert row["qk_clover_top25"] > row["qk_vanilla_top25"]   # trained_gap


# ---------------------------------------------------------------------------
# Figs. 4-6: the adapter analytics
# ---------------------------------------------------------------------------

def _pair_arrays(*shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("weighted", [False, True])
def test_projection_mass_and_coverage_match(weighted):
    X = _pair_arrays(40, 24, seed=1)
    dirs = _pair_arrays(24, 6, seed=2)
    w = np.abs(_pair_arrays(6, seed=3)) if weighted else None
    got = A.projection_mass(torch.from_numpy(X), torch.from_numpy(dirs),
                            None if w is None else torch.from_numpy(w))
    want = JA.projection_mass(jnp.asarray(X), jnp.asarray(dirs),
                              None if w is None else jnp.asarray(w))
    _rel_close(got, want, SVD_RTOL)
    assert abs(float(got.sum()) - 1.0) < 1e-6
    for r in (1, 6):
        cov = A.coverage(torch.from_numpy(X), torch.from_numpy(dirs[:, :r]))
        assert isinstance(cov, float)
        _rel_close(cov, JA.coverage(jnp.asarray(X), jnp.asarray(
            dirs[:, :r])), SVD_RTOL)
    # a complete basis covers everything
    full = np.linalg.qr(_pair_arrays(24, 24, seed=4))[0]
    assert abs(A.coverage(torch.from_numpy(X), torch.from_numpy(full))
               - 1.0) < 1e-5


@pytest.mark.parametrize("shape", [(24, 16), (16, 40), (20, 3, 8),
                                   (6, 4, 30)])
def test_delta_spectrum_rank_and_intruders_match(shape):
    W0 = _pair_arrays(*shape, seed=5)
    W1 = W0 + 0.05 * _pair_arrays(*shape, seed=6)
    got = A.delta_spectrum(torch.from_numpy(W0), torch.from_numpy(W1))
    want = JA.delta_spectrum(jnp.asarray(W0), jnp.asarray(W1))
    _rel_close(got, want, SVD_RTOL)
    # a rank-2 update: two singular values above the tolerance
    lo = W0 + np.outer(_pair_arrays(W0.shape[0], seed=7),
                       _pair_arrays(int(np.prod(W0.shape[1:])), seed=8)
                       ).reshape(W0.shape) \
        + np.outer(_pair_arrays(W0.shape[0], seed=9),
                   _pair_arrays(int(np.prod(W0.shape[1:])), seed=10)
                   ).reshape(W0.shape)
    s = A.delta_spectrum(torch.from_numpy(W0), torch.from_numpy(lo))
    js = JA.delta_spectrum(jnp.asarray(W0), jnp.asarray(lo))
    for tol in (1e-3, 1e-2, 0.3):
        r = A.effective_rank(s, tol)
        assert isinstance(r, int) and r == JA.effective_rank(js, tol)
    if len(shape) == 2 and shape[0] >= shape[1]:
        assert A.effective_rank(s, 1e-3) == 2
    if len(shape) == 2:
        for W, k, tau in ((W1, 4, 0.6), (lo, 8, 0.6), (lo, 8, 0.95)):
            n = A.intruder_dims(torch.from_numpy(W0), torch.from_numpy(W),
                                k=k, tau=tau)
            assert isinstance(n, int)
            assert n == JA.intruder_dims(jnp.asarray(W0), jnp.asarray(W),
                                         k=k, tau=tau)
        # flipping singular-vector signs changes nothing: |cos|
        assert A.intruder_dims(torch.from_numpy(W0), torch.from_numpy(-W0),
                               k=4) == 0


def test_fig4_projection_checks(trained):
    """``fig4_projection.py`` on the port: rank 4, 16 samples of
    ``batch_at(5000)`` entering the first attention layer, head 0's
    ``svd_lowrank_product`` basis, random directions by QR of a seeded
    ``torch.Generator``; the PiSSA / CLOVER coverages and the principal
    shares as the JAX package's on the same weights, the LoRA coverage
    as JAX's on JAX's own random directions, and every check."""
    jp, jcfg, jdata, tp, cfg, data = trained
    rank = 4
    toks = data.batch_at(5000)["tokens"][:16]
    pos = np.broadcast_to(np.arange(toks.shape[1]), toks.shape).copy()
    lp = T.layer_slice(tp["blocks"][0], 0)
    X = L.apply_norm(lp["norm1"], cfg, T._embed(
        tp, cfg, torch.as_tensor(toks), torch.as_tensor(pos))).reshape(
            -1, cfg.d_model)
    D, H, d = lp["attn"]["wq"].shape
    U, S, _ = svd_lowrank_product(
        lp["attn"]["wq"].permute(1, 0, 2).reshape(H, D, d)[0],
        lp["attn"]["wk"].permute(1, 0, 2)[0])
    gen = torch.Generator().manual_seed(0)
    rand = torch.linalg.qr(torch.randn((cfg.d_model, rank),
                                       generator=gen))[0]
    res = {"lora_coverage": A.coverage(X, rand),
           "pissa_coverage": A.coverage(X, U[:, :rank]),
           "clover_coverage": A.coverage(X, U),
           "principal_share_unscaled": float(A.projection_mass(X, U)[0]),
           "principal_share_scaled": float(
               A.projection_mass(X, U, weights=S)[0])}
    # the reference's computation on its own weights and data
    jl = jax.tree.map(lambda a: a[0], jp["blocks"][0])
    jX = JL.apply_norm(jl["norm1"], jcfg, JT._embed(
        jp, jcfg, jnp.asarray(toks), jnp.asarray(pos), None)).reshape(
            -1, jcfg.d_model)
    _rel_close(X, jX, RTOL)
    jU, jS, _ = jax_lowrank(
        jl["attn"]["wq"].transpose(1, 0, 2).reshape(H, D, d)[0],
        jl["attn"]["wk"].transpose(1, 0, 2)[0])
    jrand = jnp.linalg.qr(jax.random.normal(jax.random.PRNGKey(0),
                                            (jcfg.d_model, rank)))[0]
    want = {"pissa_coverage": JA.coverage(jX, jU[:, :rank]),
            "clover_coverage": JA.coverage(jX, jU),
            "principal_share_unscaled": float(JA.projection_mass(jX, jU)[0]),
            "principal_share_scaled": float(
                JA.projection_mass(jX, jU, weights=jS)[0])}
    for k, v in want.items():
        _rel_close(res[k], v, SVD_RTOL)
    _rel_close(A.coverage(X, torch.from_numpy(np.asarray(jrand))),
               JA.coverage(jX, jrand), SVD_RTOL)
    checks = {
        "scaling_amplifies_principal": res["principal_share_scaled"]
        > res["principal_share_unscaled"],
        "lora_misses_most": res["lora_coverage"] < 0.5,
        "pissa_partial": res["pissa_coverage"] < 0.9,
        "clover_covers_most": res["clover_coverage"]
        >= res["pissa_coverage"]}
    assert all(checks.values()), (res, checks)


def _wq0(tree):
    w = tree["blocks"][0]["attn"]["wq"][0]
    return w.reshape(w.shape[0], -1)


def test_fig56_rank_and_intruder_checks(trained):
    """``fig56_rank.py`` on the port, on ``data_for(seed=99)``: LoRA at
    rank 2 on ``wq`` (60 steps, lr 5e-3, alpha 16), CLOVER-S (60 steps,
    lr 5e-3) then ``merge_clover``, full fine-tuning (60 steps, lr
    1e-3); the rank of each ``wq`` update and its intruder dimensions
    against the base, and every check."""
    _, _, jdata, tp, cfg, _ = trained
    rank = 2
    new = SyntheticLM(SyntheticConfig(**dict(
        dataclasses.asdict(jdata.cfg), seed=99)))
    W0 = _wq0(tp)

    pcfg = PeftConfig(method="lora", rank=rank, alpha=16.0, targets=("wq",))
    ad = init_adapters(tp, pcfg, torch.Generator().manual_seed(42))
    step = make_adapter_step(cfg, pcfg, tp, AdamWConfig(
        lr=5e-3, weight_decay=0.0), device=CPU)
    opt = adamw_init(ad)
    for i in range(60):
        b = new.batch_at(i)
        ad, opt, _ = step(ad, opt, b["tokens"], b["labels"])
    with torch.no_grad():
        W_lora = _wq0(materialize(tp, ad, pcfg))

    def train(params, c, steps, lr, peft_mode=False):
        tstep = make_train_step(c, TrainConfig(
            optimizer=AdamWConfig(lr=lr, weight_decay=0.0),
            warmup_steps=max(2, steps // 10), total_steps=steps,
            remat=False, peft_mode=peft_mode), device=CPU)
        opt = make_opt_state(params, peft_mode=peft_mode)
        for i in range(steps):
            params, opt, _ = tstep(params, opt, new.batch_at(i))
        return params

    p2, cfg2, _ = clover_decompose(tp, cfg, peft=True)
    merged, _ = merge_clover(train(p2, cfg2, 60, 5e-3, peft_mode=True),
                             cfg2)
    W_clover = _wq0(merged)
    W_full = _wq0(train(tp, cfg, 60, 1e-3))
    res = {}
    for name, W1 in (("lora", W_lora), ("clover", W_clover),
                     ("full_ft", W_full)):
        s = A.delta_spectrum(W0, W1)
        res[name] = {"delta_rank": A.effective_rank(s, tol=1e-2),
                     "intruders": A.intruder_dims(W0, W1, k=8, tau=0.6)}
    checks = {
        "lora_low_rank": res["lora"]["delta_rank"] <= rank + 1,
        "clover_high_rank": res["clover"]["delta_rank"]
        > 4 * res["lora"]["delta_rank"],
        "full_high_rank": res["full_ft"]["delta_rank"]
        > 4 * res["lora"]["delta_rank"],
        "clover_no_extra_intruders": res["clover"]["intruders"]
        <= res["full_ft"]["intruders"] + 1}
    assert all(checks.values()), (res, checks)
