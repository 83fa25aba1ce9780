"""The paper's training-free results in the port against the JAX
package: ``vanilla_prune``, Fig. 2's curves (``qk_curves``,
``vo_curves``, ``energy_topk``) on seeded weights, and the gate on
trained weights -- ``benchmarks.common.pretrain_base()`` (a tiny GPT-2
trained 300 steps by the JAX package), bridged as numpy: both packages'
no-fine-tune CLOVER and vanilla perplexities at Table 1's ratios,
``fig3_trainfree.py``'s threshold plan and checks, and the trained row of
``fig2_spectrum.py``.

Tolerances: vanilla pruning gathers the same entries (bitwise weights
when the importance order agrees); 1e-4 relative on logits and
perplexities, 1e-5 relative on spectra and energy fractions.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from benchmarks import common as BC  # noqa: E402
from benchmarks import fig2_spectrum as BF2  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import analytics as JA  # noqa: E402
from repro.core import clover_decompose as jax_decompose  # noqa: E402
from repro.core import clover_prune as jax_prune  # noqa: E402
from repro.core import threshold_ratios as jax_threshold  # noqa: E402
from repro.core import vanilla_prune as jax_vanilla  # noqa: E402
from repro.models import init_lm_params as jax_init  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.bridge import from_numpy, to_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import analytics as A  # noqa: E402
from repro_torch.core.decompose import clover_decompose  # noqa: E402
from repro_torch.core.prune import (clover_prune,  # noqa: E402
                                    threshold_ratios, vanilla_prune)
from repro_torch.data import SyntheticConfig, SyntheticLM  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

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
