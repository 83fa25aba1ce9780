"""Spectrum-planned rank budgets in the port (DESIGN.md §14) against the
JAX package, on a reduced gpt2-xl whose attention heads are damped
checkerboard-wise (head ``h`` of layer ``i`` scaled by 0.25 in ``wq``
and ``wv`` where ``i + h`` is odd), so the plans are non-uniform inside
a layer.

On shared spectra (the JAX ``extras`` through numpy) the port's planner
must give the reference's plan field for field; on each side's own
decomposition (torch and LAPACK SVDs differ in the last bits) the kept
energies agree within rtol 1e-5.  ``apply_rank_budget`` and
``mask_head_ranks`` on the same bridged JAX-decomposed weights give
bitwise-equal leaves (slices and 0/1 masks are exact).  The ranked plain
decode versions agree with the jnp oracle and the Pallas kernels in
interpret mode within atol 1e-5 (float32 sums in another order), and
budget engines stepped in lockstep with the JAX engine emit identical
tokens with identical allocator histories."""
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
from repro.core import analytics as janalytics  # noqa: E402
from repro.core import clover_decompose as jax_decompose  # noqa: E402
from repro.core import prune as jprune  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import init_lm_params as jax_init  # noqa: E402
from repro.serve import memory as jmemory  # noqa: E402
from repro_torch import serve as S  # noqa: E402
from repro_torch.bridge import budget_from_fields, from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import analytics, prune  # noqa: E402
from repro_torch.core.decompose import clover_decompose  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.serve.memory import rank_pool_bytes  # noqa: E402

CPU = "cpu"
ATOL = 1e-5
SCALE = 1.0 / np.sqrt(32)


def checkerboard(nb: int, H: int) -> np.ndarray:
    """(nb, H) head scales: 0.25 where layer + head is odd, else 1."""
    i, h = np.meshgrid(np.arange(nb), np.arange(H), indexing="ij")
    return np.where((i + h) % 2 == 1, 0.25, 1.0).astype(np.float32)


def _damped(params):
    """numpy params with wq/wv head h of layer i damped checkerboard-wise."""
    attn = dict(params["blocks"][0]["attn"])
    nb, _, H, _ = attn["wq"].shape
    s = checkerboard(nb, H)[:, None, :, None]
    attn["wq"] = attn["wq"] * s
    attn["wv"] = attn["wv"] * s[:, :, :attn["wv"].shape[2]]
    return {**params, "blocks": ({**params["blocks"][0], "attn": attn},)}


def _fields(plan):
    return (plan.head_dim, plan.rank_multiple, plan.total_rank, plan.budget,
            plan.qk_ranks, plan.vo_ranks)


def _port_plan(jplan):
    return budget_from_fields(*_fields(jplan))


def _np_extras(extras):
    return [{"spectra": {k: np.asarray(v) for k, v in
                         ex.get("spectra", {}).items()}} for ex in extras]


@pytest.fixture(scope="module")
def model():
    """The same damped weights decomposed by each side, the JAX extras
    as numpy (the shared spectra) and the JAX-decomposed weights bridged
    to the port."""
    jcfg = jax_config("gpt2-xl").reduced()
    cfg = get_config("gpt2-xl").reduced()
    raw = _damped(jax.tree.map(np.asarray, jax_init(jcfg,
                                                    jax.random.PRNGKey(5))))
    jd, jdc, jextras = jax_decompose(jax.tree.map(jnp.asarray, raw), jcfg,
                                     peft=False)
    td, tdc, textras = clover_decompose(from_numpy(raw, CPU), cfg)
    return dict(jcfg=jcfg, cfg=cfg, jd=jd, jdc=jdc, jextras=jextras,
                shared=_np_extras(jextras), td=td, tdc=tdc, textras=textras,
                bridged=from_numpy(jax.tree.map(np.asarray, jd), CPU))


def _uniform(extras, d, m, keep):
    """The uniform plan as a (JAX) RankBudget with the planner's table
    shapes."""
    nb, kv = np.shape(extras[0]["spectra"]["vo"])[:2]
    row = tuple(tuple(keep for _ in range(kv)) for _ in range(nb))
    total = nb * kv * 2 * keep
    return jprune.RankBudget(head_dim=d, rank_multiple=m, total_rank=total,
                             budget=total, qk_ranks=(row,),
                             vo_ranks=(row,))


@pytest.mark.parametrize("multiple", [1, 5, 8])
def test_energy_blocks_match_jax(model, multiple):
    for fam in ("qk", "vo"):
        s = model["shared"][0]["spectra"][fam]
        want = janalytics.energy_blocks(s, multiple)
        for given in (s, torch.from_numpy(s.copy())):
            got = analytics.energy_blocks(given, multiple)
            assert got.dtype == np.float64
            np.testing.assert_array_equal(got, want)


def _synthetic(cfg, seed=0):
    """Descending spectra for a partial/intra config (the planner never
    runs the model): one attention position and one spectra-free one."""
    rng = np.random.default_rng(seed)
    d = cfg.head_dim_
    d_eff = d - (cfg.rope_dims if 0 < cfg.rope_dims < d else 0)
    scale = checkerboard(2, 4).astype(np.float64)[..., None]

    def spec(width):
        s = np.sort(rng.uniform(0.1, 1.0, (2, 4, width)), -1)[..., ::-1]
        return np.ascontiguousarray(s * scale)
    sp = {"vo": spec(d)}
    if cfg.rope_dims < d:
        sp["qk"] = spec(d_eff)
    return [{"spectra": sp}, {}]


@pytest.mark.parametrize("mode,kw", [
    ("cross", dict(budget=0.5)),
    ("cross", dict(budget=0.3)),
    ("cross", dict(budget=1.0)),
    ("cross", dict(total_rank=256)),        # the uniform 16/16 total
    ("cross", dict(total_rank=1)),          # clamps at the floor
    ("cross", dict(total_rank=10 ** 6)),    # clamps at capacity
    ("partial", dict(budget=0.5)),
    ("partial", dict(total_rank=100)),
    ("intra", dict(budget=0.6)),
])
def test_plan_matches_jax_on_shared_spectra(model, mode, kw):
    """Identical plans field for field (and every derived quantity) on
    the JAX spectra; partial and intra through a RoPE variant of the
    config on synthetic spectra."""
    jcfg, cfg = model["jdc"], model["tdc"]
    extras = model["shared"]
    if mode != "cross":
        pct = 0.5 if mode == "partial" else 1.0
        jcfg = dataclasses.replace(jcfg, rope=True, rotary_pct=pct)
        cfg = dataclasses.replace(cfg, rope=True, rotary_pct=pct)
        extras = _synthetic(cfg)
    jplan = jprune.plan_rank_budget(extras, jcfg, **kw)
    plan = prune.plan_rank_budget(extras, cfg, **kw)
    assert _fields(plan) == _fields(jplan)
    assert plan == _port_plan(jplan)
    assert plan.salt() == jplan.salt()
    assert (plan.qk_width, plan.vo_width) == (jplan.qk_width, jplan.vo_width)
    np.testing.assert_array_equal(plan.head_loads(), jplan.head_loads())
    for a, b in zip(plan.layer_ranks(0), jplan.layer_ranks(0)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == np.int32
    assert (prune.budget_kept_energy(extras, plan)
            == jprune.budget_kept_energy(extras, jplan))
    # torch spectra give the same plan as their numpy copies
    textras = [{"spectra": {k: torch.from_numpy(np.array(v))
                            for k, v in ex.get("spectra", {}).items()}}
               for ex in extras]
    assert prune.plan_rank_budget(textras, cfg, **kw) == plan


def test_planner_invariants_on_the_port_spectra(model):
    """Monotone in the budget, conserved within one block, and at the
    uniform plan's total it keeps at least the uniform energy with ranks
    that differ inside a layer."""
    cfg, extras = model["tdc"], model["textras"]
    d, m = cfg.head_dim_, cfg.clover.rank_multiple
    nb, kv = extras[0]["spectra"]["vo"].shape[:2]
    floor, capacity = nb * kv * 2 * m, nb * kv * 2 * d
    prev = None
    for target in range(floor, capacity + 1, m):
        plan = prune.plan_rank_budget(extras, cfg, total_rank=target)
        assert target <= plan.total_rank < target + m
        flat = [r for t in (plan.qk_ranks, plan.vo_ranks) for j in t
                for b in j for r in b]
        assert plan.total_rank == sum(flat)
        if prev is not None:
            assert all(a <= b for a, b in zip(prev, flat))
        prev = flat
    uniform = _uniform(extras, d, m, d // 2)
    planned = prune.plan_rank_budget(extras, cfg,
                                     total_rank=uniform.total_rank)
    assert planned.total_rank == uniform.total_rank
    assert (prune.budget_kept_energy(extras, planned)
            >= prune.budget_kept_energy(extras, uniform))
    assert any(len(set(row)) > 1 for t in (planned.qk_ranks[0],
                                           planned.vo_ranks[0])
               for row in t)


@pytest.mark.parametrize("kw", [dict(budget=0.5), dict(total_rank=256),
                                dict(budget=0.75)])
def test_kept_energy_on_own_decompositions(model, kw):
    """Each side plans on its own SVD: kept energies agree within rtol
    1e-5 (the spectra agree to float32 rounding; the plans may differ
    where two block energies are that close)."""
    jplan = jprune.plan_rank_budget(model["jextras"], model["jdc"], **kw)
    plan = prune.plan_rank_budget(model["textras"], model["tdc"], **kw)
    assert plan.total_rank == jplan.total_rank
    np.testing.assert_allclose(
        prune.budget_kept_energy(model["textras"], plan),
        jprune.budget_kept_energy(model["jextras"], jplan), rtol=1e-5)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("form", ["plan", "flat", "per_layer"])
def test_apply_and_mask_bitwise_on_bridged_params(model, form):
    """The same plan (or rank vectors) on the same JAX-decomposed
    weights: every leaf bitwise equal, dtypes kept, rank leaves int32."""
    jplan = jprune.plan_rank_budget(model["shared"], model["jdc"],
                                    budget=0.5)
    if form == "plan":
        jout, jc = jprune.apply_rank_budget(model["jd"], model["jdc"], jplan)
        tout, tc = prune.apply_rank_budget(model["bridged"], model["tdc"],
                                           _port_plan(jplan))
        assert (tc.qk_dim, tc.vo_dim) == (jc.qk_dim, jc.vo_dim)
        assert tout["blocks"][0]["attn"]["rank_qk"].dtype == torch.int32
    else:
        if form == "flat":
            qk, vo = np.array([8, 24, 32, 16]), np.array([32, 8, 16, 24])
        else:
            qk, vo = ({0: r} for r in jplan.layer_ranks(0))
        jout = jprune.mask_head_ranks(model["jd"], model["jdc"], qk, vo)
        tout = prune.mask_head_ranks(model["bridged"], model["tdc"], qk, vo)
    want = dict(_leaves(jax.tree.map(np.asarray, jout)))
    got = dict(_leaves(tout))
    assert got.keys() == want.keys()
    for name, t in got.items():
        a = t.numpy()
        assert a.dtype == want[name].dtype, name
        assert a.shape == want[name].shape, name
        assert a.tobytes() == want[name].tobytes(), name


@pytest.mark.parametrize("pt,n_pages", [(16, 48), (4, 14)])
def test_rank_pool_bytes_match_jax(model, pt, n_pages):
    jplan = jprune.plan_rank_budget(model["shared"], model["jdc"],
                                    budget=0.5)
    got = rank_pool_bytes(_port_plan(jplan), page_tokens=pt, n_pages=n_pages)
    assert got == jmemory.rank_pool_bytes(jplan, page_tokens=pt,
                                          n_pages=n_pages)
    assert got["kept"] < got["allocated"]


@pytest.mark.parametrize("qk_t,vo_t", [(0.5, 0.5), (0.9, 0.3), (2.0, 0.05)])
def test_threshold_ratios_match_jax(model, qk_t, vo_t):
    """Equal on shared spectra, given as numpy or as torch tensors."""
    want = jprune.threshold_ratios(model["shared"], model["jdc"],
                                   qk_thresh=qk_t, vo_thresh=vo_t)
    as_torch = [{"spectra": {k: torch.from_numpy(v.copy())
                             for k, v in ex["spectra"].items()}}
                for ex in model["shared"]]
    for extras in (model["shared"], as_torch):
        assert prune.threshold_ratios(extras, model["tdc"], qk_thresh=qk_t,
                                      vo_thresh=vo_t) == want


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("layout,B,H,KV,dq,dv,lens,rq,rv,block_ranks", [
    # ragged ranks that are not multiples of 8, a rank of 0 and a full
    # rank: held to the jnp oracle only (its per-dim mask)
    ("dense", 4, 4, 2, 32, 24, [0, 1, 31, 64], [13, 32], [0, 24], False),
    ("paged", 4, 2, 2, 32, 32, [0, 7, 16, 33], [5, 0], [32, 17], False),
    # block multiples: the Pallas rank_block skip agrees exactly
    ("dense", 3, 8, 4, 32, 24, [5, 37, 64], [8, 16, 32, 24],
     [24, 8, 16, 24], True),
    ("paged", 3, 8, 4, 32, 24, [5, 37, 64], [8, 16, 32, 24],
     [24, 8, 16, 24], True),
    ("paged", 2, 4, 4, 16, 16, [9, 40], [8, 16, 0, 8], [16, 8, 8, 0], True),
])
def test_ranked_plain_versions_match_jax(layout, B, H, KV, dq, dv, lens, rq,
                                         rv, block_ranks):
    """Finite garbage past each row's length and past each head's rank
    (never zero-padded here), G of 1 and 2, dq != dv, sentinel pages."""
    rng = np.random.default_rng(7)
    lengths = np.asarray(lens, np.int32)
    rq, rv = np.asarray(rq, np.int32), np.asarray(rv, np.int32)
    q = _randn(rng, B, H, dq)
    kw = dict(scale=SCALE, qk_ranks=torch.from_numpy(rq),
              vo_ranks=torch.from_numpy(rv))
    jkw = dict(scale=SCALE, qk_ranks=rq, vo_ranks=rv)
    if layout == "dense":
        T = 64
        k, v = _randn(rng, B, T, KV, dq), _randn(rng, B, T, KV, dv)
        past = np.arange(T)[None, :] >= lengths[:, None]
        k[past], v[past] = 50.0, -50.0
        got = ref.decode_attention_ref(*map(torch.from_numpy,
                                            (q, k, v, lengths)), **kw)
        want = jref.decode_attention_ref(q, k, v, lengths, **jkw)
        args = (q, k, v, lengths)
        kernel = jops.decode_attention
        kargs = dict(block_t=16)
    else:
        pt, n_pages, n_p = 8, 30, 8
        kp = _randn(rng, n_pages + 1, pt, KV, dq)
        vp = _randn(rng, n_pages + 1, pt, KV, dv)
        kp[n_pages], vp[n_pages] = 50.0, -50.0
        perm = rng.permutation(n_pages)
        tab = np.full((B, n_p), n_pages, np.int32)
        nxt = 0
        for b, n in enumerate(lens):
            used = -(-n // pt)
            tab[b, :used] = perm[nxt:nxt + used]
            nxt += used
        got = ref.paged_decode_attention_ref(
            *map(torch.from_numpy, (q, kp, vp, tab, lengths)), **kw)
        want = jref.paged_decode_attention_ref(q, kp, vp, tab, lengths,
                                               **jkw)
        args = (q, kp, vp, tab, lengths)
        kernel = jops.paged_decode_attention
        kargs = {}
    got = got.numpy()
    live = lengths > 0
    np.testing.assert_allclose(got[live], np.asarray(want)[live],
                               atol=ATOL, rtol=0)
    assert np.all(got[~live] == 0.0)
    G = H // KV
    for h in range(KV):                 # dims past a head's V rank: 0
        assert np.all(got[:, h * G:(h + 1) * G, rv[h]:] == 0.0)
    if block_ranks:
        pallas = np.asarray(kernel(*map(jnp.asarray, args), **jkw,
                                   rank_block=8, impl="interpret", **kargs))
        np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=0)


@pytest.fixture(scope="module")
def budgeted(model):
    """The damped model under a half-capacity plan, applied by each side
    to the same JAX-decomposed weights."""
    jplan = jprune.plan_rank_budget(model["shared"], model["jdc"],
                                    budget=0.5)
    jp, jc = jprune.apply_rank_budget(model["jd"], model["jdc"], jplan)
    plan = _port_plan(jplan)
    tp, tc = prune.apply_rank_budget(model["bridged"], model["tdc"], plan)
    return jp, jc, jplan, tp, tc, plan


def _prompts(lens, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, n).astype(np.int32) for n in lens]


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_budget_engine_matches_jax_engine_in_lockstep(budgeted, layout):
    """The JAX engine runs its ranked Pallas kernels in interpret mode;
    the port's CPU path runs the ranked plain versions.  Token-identical
    streams, identical allocator histories, 2 step shapes each, and the
    streams equal the port's greedy_reference."""
    jp, jc, jplan, tp, tc, plan = budgeted
    kw = dict(slots=2, max_len=24, prefill_chunk=4)
    if layout == "paged":
        kw.update(paged=True, page_tokens=4, n_pages=6)     # preempts
    jeng = JS.Engine(jp, jc, JS.EngineConfig(kernel_impl="interpret",
                                             rank_budget=jplan, **kw))
    teng = S.Engine(tp, tc, S.EngineConfig(rank_budget=plan, **kw),
                    device=CPU)
    prompts = _prompts((6, 11, 3), seed=2)
    jreqs = [JS.Request(uid=i, prompt=p, max_new_tokens=4)
             for i, p in enumerate(prompts)]
    treqs = [S.Request(uid=i, prompt=p, max_new_tokens=4)
             for i, p in enumerate(prompts)]
    for a, b in zip(jreqs, treqs):
        jeng.submit(a)
        teng.submit(b)
    before = ref.decode_attention_ref.calls + \
        ref.paged_decode_attention_ref.calls
    steps = 0
    while jeng.sched.busy or teng.sched.busy:
        jeng.step()
        teng.step()
        steps += 1
        assert steps < 200
        if teng.alloc is not None:
            teng.alloc.assert_consistent(context=f"step {steps}")
            assert teng.alloc.tables == jeng.alloc.tables, steps
            assert teng.alloc.free_list == jeng.alloc.free_list, steps
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    assert teng.compiled_shapes() == jeng.compiled_shapes() == 2
    if layout == "paged":
        assert teng.sched.preemptions == jeng.sched.preemptions > 0
    assert ref.decode_attention_ref.calls + \
        ref.paged_decode_attention_ref.calls > before
    for r, p in zip(treqs, prompts):
        assert r.generated == S.greedy_reference(tp, tc, p, 4, device=CPU)


def test_prefix_salt_under_a_plan_matches_jax(budgeted):
    """The plan folds into the trie salt: chain hashes byte-identical to
    the JAX engine's under the same plan, and disjoint from another
    plan's at the same widths."""
    jp, jc, jplan, tp, tc, plan = budgeted
    kw = dict(slots=2, max_len=24, prefill_chunk=4, paged=True,
              page_tokens=4, prefix_cache=True)
    jeng = JS.Engine(jp, jc, JS.EngineConfig(rank_budget=jplan, **kw))
    teng = S.Engine(tp, tc, S.EngineConfig(rank_budget=plan, **kw),
                    device=CPU)
    tokens = np.arange(12, dtype=np.int32)
    assert (teng.prefix.chain_hashes(tokens, 3)
            == jeng.prefix.chain_hashes(tokens, 3))
    # the same widths and total, heads' qk ranks swapped within a layer
    other = dataclasses.replace(plan, qk_ranks=tuple(
        tuple(row[::-1] for row in j) for j in plan.qk_ranks))
    assert other != plan
    oeng = S.Engine(tp, tc, S.EngineConfig(rank_budget=other, **kw),
                    device=CPU)
    assert set(oeng.prefix.chain_hashes(tokens, 3)).isdisjoint(
        teng.prefix.chain_hashes(tokens, 3))


def test_engine_config_checks_the_plan(budgeted, model):
    """The engine validates plans, it does not apply them: widths that
    do not match the served cfg raise, as in the reference."""
    jp, jc, jplan, tp, tc, plan = budgeted
    narrow = _uniform(model["shared"], 32, 8, 16)
    with pytest.raises(ValueError, match="apply_rank_budget"):
        S.Engine(tp, tc, S.EngineConfig(rank_budget=_port_plan(narrow)),
                 device=CPU)
    with pytest.raises(ValueError, match="apply_rank_budget"):
        JS.Engine(jp, jc, JS.EngineConfig(rank_budget=narrow))
    with pytest.raises(TypeError, match="RankBudget"):
        S.EngineConfig(rank_budget=jplan)
