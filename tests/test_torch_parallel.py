"""Tensor- and expert-parallel serving in the port against the JAX
package (DESIGN.md §10), on the same (numpy-bridged) weights at reduced
size.

Three layers: the pure planning functions (``rank_balanced_partition``
/ ``HeadPartition`` / ``head_rank_loads``, ``permute_attention_heads``,
``param_specs`` / ``serve_state_specs`` / ``kernel_axes`` under
``serve_rules``) equal the reference's on the same inputs; the
``ShardedExecutor`` at tp = 1 equals the ``LocalExecutor`` step for step
(logits bit for bit); and engines of tp = 2 and tp = 4 ranks, spawned
under gloo on the CPU (``launch.serve.serve_tp``), equal the JAX
``LocalExecutor`` engine: every rank's streams, per-step scheduling
records (phases, positions, page tables, free lists, refcounts,
speculative rounds) and compiled shapes, with every step's logits within
ATOL of the reference's.  The reference's own sharded path fails on this
JAX (ROADMAP C), so tp = 1 of the reference is the oracle, as DESIGN.md
§10 promises token-identical streams for attention-only models.

Tolerances: ATOL 1e-4 on logits (float32 partial sums added across
ranks in another order than one device's matmul, through two layers, as
the port's other engine tests); the planning functions and the shard
slices exactly.  Each rank group rendezvouses on a ``file://`` path
under ``tmp_path`` and is stopped after RANK_TIMEOUT seconds.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the xdist workers already fill the CPUs, and a
# torch thread pool per worker oversubscribes them many times over
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec  # noqa: E402

from repro import serve as JS  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import clover_decompose as jax_decompose  # noqa: E402
from repro.core import clover_prune as jax_prune  # noqa: E402
from repro.core import prune as jprune  # noqa: E402
from repro.models import init_lm_params as jax_init  # noqa: E402
from repro.parallel import sharding as jsh  # noqa: E402
from repro_torch import serve as S  # noqa: E402
from repro_torch.bridge import budget_from_fields, from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import AdapterRegistry, sv_extract  # noqa: E402
from repro_torch.core import prune  # noqa: E402
from repro_torch.core.decompose import clover_decompose  # noqa: E402
from repro_torch.core.prune import clover_prune  # noqa: E402
from repro_torch.launch.mesh import axis_size, batch_axes, make_host_mesh  # noqa: E402
from repro_torch.launch.serve import (ServeRun, record_logits,  # noqa: E402
                                      serve_tp, serve_waves, step_record)
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.parallel import sharding as sh  # noqa: E402
from repro_torch.serve.executor import (ShardedExecutor,  # noqa: E402
                                        validate_kernel_parallelism)

CPU = "cpu"
ATOL = 1e-4
RANK_TIMEOUT = 240.0
SPEC_MODELS = ("musicgen-large", "granite-moe-1b-a400m", "phi3-medium-14b")


def _stand_in(tp):
    """What ``ShardingRules.spec`` reads of a mesh: its shape."""
    return types.SimpleNamespace(shape={"data": 1, "model": tp})


def _spec_leaves(tree, path=""):
    """{keystr path: spec tuple} of a spec tree (the port's ``Spec`` or
    the reference's ``PartitionSpec`` leaves)."""
    if isinstance(tree, (sh.Spec, PartitionSpec)):
        return {path: tuple(tree)}
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_spec_leaves(v, f"{path}[{k!r}]"))
    else:
        for i, v in enumerate(tree):
            out.update(_spec_leaves(v, f"{path}[{i}]"))
    return out


def _arrays(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_arrays(v, f"{path}[{k!r}]"))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_arrays(v, f"{path}[{i}]"))
        return out
    return {path: np.asarray(tree.numpy() if torch.is_tensor(tree)
                             else tree)}


def _pruned(name, seed, ratio=0.5, adapt=None):
    """The reference's seeded weights, decomposed and pruned by it, and
    the same tree bridged to the port (the port's cfg from its own
    decompose and prune, equal to the reference's)."""
    jcfg, cfg = jax_config(name).reduced(), get_config(name).reduced()
    if adapt is not None:
        jcfg, cfg = adapt(jcfg), adapt(cfg)
    jp = jax_init(jcfg, jax.random.PRNGKey(seed))
    tp = from_numpy(jax.tree.map(np.asarray, jp), CPU)
    if not ratio:
        return jp, jcfg, tp, cfg
    jd, jdc, _ = jax_decompose(jp, jcfg, peft=False)
    jpp, jpc = jax_prune(jd, jdc, qk_ratio=ratio, vo_ratio=ratio)
    td, tdc, _ = clover_decompose(tp, cfg)
    _, tpc = clover_prune(td, tdc, qk_ratio=ratio, vo_ratio=ratio)
    assert dataclasses.asdict(tpc) == dataclasses.asdict(jpc)
    return jpp, jpc, from_numpy(jax.tree.map(np.asarray, jpp), CPU), tpc


def _budgeted(seed=4):
    """musicgen reduced with heads damped so a rank budget plans them
    differently: the reference's plan and ``apply_rank_budget`` on each
    side -> (jax params, jax cfg, jax plan, port params, port cfg, port
    plan)."""
    jcfg, cfg = (jax_config("musicgen-large").reduced(),
                 get_config("musicgen-large").reduced())
    jp = jax_init(jcfg, jax.random.PRNGKey(seed))
    attn = dict(jp["blocks"][0]["attn"])
    i, h = np.meshgrid(np.arange(jcfg.n_blocks), np.arange(jcfg.n_heads),
                       indexing="ij")
    damp = jnp.asarray(np.where(h % 4 == 0, 0.25, 1.0), jnp.float32)
    attn["wq"] = attn["wq"] * damp[:, None, :, None]
    attn["wv"] = attn["wv"] * damp[:, None, :, None]
    jp = {**jp, "blocks": ({**jp["blocks"][0], "attn": attn},)}
    jd, jdc, jex = jax_decompose(jp, jcfg, peft=False)
    shared = [{"spectra": {k: np.asarray(v) for k, v in
                           ex["spectra"].items()}} for ex in jex]
    jplan = jprune.plan_rank_budget(shared, jdc, budget=0.5)
    plan = budget_from_fields(jplan.head_dim, jplan.rank_multiple,
                              jplan.total_rank, jplan.budget,
                              jplan.qk_ranks, jplan.vo_ranks)
    bjp, bjc = jprune.apply_rank_budget(jd, jdc, jplan)
    tdc = dataclasses.replace(cfg, clover=dataclasses.replace(
        cfg.clover, enabled=True))
    btp, btc = prune.apply_rank_budget(
        from_numpy(jax.tree.map(np.asarray, jd), CPU), tdc, plan)
    return bjp, bjc, jplan, btp, btc, plan


# ---------------------------------------------------------------------------
# the partitioner (pure host logic)
# ---------------------------------------------------------------------------

def _loads_cases():
    rng = np.random.default_rng(0)
    cases = [("uniform", [48.0] * 8, 2, 1),
             ("one-head-per-shard", [4.0, 1.0, 3.0, 2.0], 4, 1),
             ("ties", [9.0, 5.0, 7.0, 3.0, 9.0, 1.0, 2.0, 2.0], 4, 2)]
    for n in (2, 4):
        for g in (1, 2):
            cases.append((f"heterogeneous-{n}-{g}",
                          (rng.integers(2, 9, 16) * 8).astype(float).tolist(),
                          n, g))
    return cases


@pytest.mark.parametrize("label,loads,n,group", _loads_cases(),
                         ids=[c[0] for c in _loads_cases()])
def test_partition_matches_reference(label, loads, n, group):
    got = prune.rank_balanced_partition(loads, n, group=group)
    want = jprune.rank_balanced_partition(list(loads), n, group=group)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for attr in ("kv_perm", "q_perm", "identity", "balance"):
        assert getattr(got, attr) == getattr(want, attr), attr
    assert got.salt() == want.salt()
    assert got.identity == (label == "uniform")


def test_partition_rejects_nondivisible_and_loads_match():
    for mod in (prune, jprune):
        with pytest.raises(ValueError, match="do not split"):
            mod.rank_balanced_partition([1.0, 2.0, 3.0], 2)
    cfg, jcfg = get_config("phi3-medium-14b"), jax_config("phi3-medium-14b")
    np.testing.assert_array_equal(prune.head_rank_loads(cfg),
                                  jprune.head_rank_loads(jcfg))
    qk, vo = [8, 16] * 5, [32] * 10
    np.testing.assert_array_equal(prune.head_rank_loads(cfg, qk, vo),
                                  jprune.head_rank_loads(jcfg, qk, vo))


@pytest.mark.parametrize("tree", ["budget", "peft-cross", "peft-intra"])
def test_permute_attention_heads_matches_reference(tree):
    """Every moved leaf (wq / wk / wv / wo, s_qk / s_vo, k_t, and the
    budget's rank_qk / rank_vo clamps) equals the reference's array."""
    if tree == "budget":
        jp, jcfg, jplan, tp_, cfg, _ = _budgeted()
        loads = jplan.head_loads()
    else:
        name = "musicgen-large" if tree == "peft-cross" else "phi3-medium-14b"
        if name == "phi3-medium-14b":
            adapt = dict(n_kv_heads=2)     # G = 2, two KV heads to move
            jcfg = jax_config(name).reduced(**adapt)
            cfg = get_config(name).reduced(**adapt)
        else:
            jcfg, cfg = jax_config(name).reduced(), get_config(name).reduced()
        jraw = jax_init(jcfg, jax.random.PRNGKey(2))
        jp, jcfg, _ = jax_decompose(jraw, jcfg, peft=True)
        tp_ = from_numpy(jax.tree.map(np.asarray, jp), CPU)
        _, cfg, _ = clover_decompose(
            from_numpy(jax.tree.map(np.asarray, jraw), CPU), cfg, peft=True)
        loads = np.arange(jcfg.n_kv_heads, dtype=float) + 1.0
    plan = prune.rank_balanced_partition(loads, 2, group=cfg.q_per_kv)
    jplan_ = jprune.rank_balanced_partition(loads, 2, group=jcfg.q_per_kv)
    assert not plan.identity
    got = _arrays(prune.permute_attention_heads(tp_, cfg, plan))
    want = _arrays(jax.tree.map(
        np.asarray, jprune.permute_attention_heads(jp, jcfg, jplan_)))
    assert got.keys() == want.keys()
    moved = [p for p in got if any(f"['{n}']" in p
                                   for n in prune.HEAD_AXES)]
    assert moved and any("rank_qk" in p for p in moved) == (tree == "budget")
    for p in got:
        np.testing.assert_array_equal(got[p], want[p], err_msg=p)


# ---------------------------------------------------------------------------
# the serving sharding rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name", SPEC_MODELS)
def test_param_and_state_specs_match_reference(name, tp):
    """Split / replicate decisions leaf for leaf, on plain and CLOVER-S
    trees and on the dense and paged serving states."""
    jcfg, cfg = jax_config(name).reduced(), get_config(name).reduced()
    jp = jax_init(jcfg, jax.random.PRNGKey(1))
    jd, _, _ = jax_decompose(jp, jcfg, peft=True)
    mesh = _stand_in(tp)
    for tree in (jp, jd):
        got = _spec_leaves(sh.param_specs(
            from_numpy(jax.tree.map(np.asarray, tree), CPU), mesh,
            sh.serve_rules()))
        want = _spec_leaves(jsh.param_specs(tree, mesh, jsh.serve_rules()))
        assert got == want
    if name == "phi3-medium-14b":       # one KV head: wk / wv replicate
        assert got["['blocks'][0]['attn']['wk']"] == (None,) * 4
    for paged in (False, True):
        kw = dict(slots=4, max_len=32, prefill_chunk=8, paged=paged,
                  page_tokens=4)
        jst = JS.LocalExecutor(jp, jcfg, JS.EngineConfig(**kw)).init_state()
        tst = S.LocalExecutor(from_numpy(jax.tree.map(np.asarray, jp), CPU),
                              cfg, S.EngineConfig(**kw),
                              torch.device(CPU)).init_state()
        got = _spec_leaves(sh.serve_state_specs(tst, mesh, paged=paged))
        want = _spec_leaves(jsh.serve_state_specs(jst, mesh, paged=paged))
        assert got == want
    for batch, kv in ((4, cfg.n_kv_heads), (3, 8), (8, 6)):
        assert sh.kernel_axes(mesh, batch=batch, kv_heads=kv) == \
            jsh.kernel_axes(mesh, batch=batch, kv_heads=kv)
    assert sh.kernel_axes(None, batch=4, kv_heads=4) == (None, None)


@pytest.mark.parametrize("rank", [0, 1])
def test_shard_tree_equals_reference_slices(rank):
    """``permute_attention_heads`` + ``shard_tree`` on a bridged budget
    tree equal the numpy slices the reference's permutation and
    ``param_specs`` give; under the sharded executor's coherent rules the
    rank clamps split with their KV heads."""
    jp, jcfg, jplan, tp_, cfg, _ = _budgeted()
    loads = jplan.head_loads()
    plan = prune.rank_balanced_partition(loads, 2, group=cfg.q_per_kv)
    jperm = jax.tree.map(np.asarray, jprune.permute_attention_heads(
        jp, jcfg, jprune.rank_balanced_partition(loads, 2,
                                                 group=jcfg.q_per_kv)))
    jspecs = _spec_leaves(jsh.param_specs(jp, _stand_in(2),
                                          jsh.serve_rules()))
    mesh = types.SimpleNamespace(shape={"data": 1, "model": 2},
                                 coords={"data": 0, "model": rank})
    perm = prune.permute_attention_heads(tp_, cfg, plan)
    got = _arrays(sh.shard_tree(perm, sh.param_specs(perm, mesh,
                                                     sh.serve_rules()), mesh))
    want = _arrays(jperm)
    split = 0
    for p, a in want.items():
        for d, m in enumerate(jspecs[p]):
            if m == "model":
                n = a.shape[d] // 2
                a = np.take(a, np.arange(rank * n, (rank + 1) * n), axis=d)
                split += 1
        np.testing.assert_array_equal(got[p], a, err_msg=p)
    assert split >= 6
    # the executor's placement: the same slices, with the rank clamps
    # (n_blocks, KV), replicated by the reference's rules, split on KV
    # with their heads
    exe_mesh = types.SimpleNamespace(**vars(mesh),
                                     device=torch.device(CPU), rank=rank)
    exe = ShardedExecutor(tp_, cfg, S.EngineConfig(slots=2, max_len=16),
                          exe_mesh, plan=plan)
    placed = _arrays(exe.params)
    assert placed.keys() == got.keys()
    for p, a in got.items():
        if "['rank_" in p:
            n = a.shape[-1] // 2
            a = a[..., rank * n:(rank + 1) * n]
        np.testing.assert_array_equal(placed[p], a, err_msg=p)


def test_mesh_and_kernel_path_validation():
    mesh = make_host_mesh(device=CPU)
    assert mesh.shape == {"data": 1, "model": 1} and mesh.rank == 0
    assert mesh.device == torch.device(CPU) and mesh.group is None
    assert axis_size(mesh, "model") == 1 and axis_size(mesh, "pod") == 1
    assert batch_axes(mesh) == ("data",)
    with pytest.raises(ValueError, match="process group"):
        make_host_mesh(model=2, device=CPU)
    with pytest.raises(ValueError, match=">= 1"):
        make_host_mesh(model=0, device=CPU)
    for name in ("rwkv6-1.6b", "jamba-v0.1-52b"):
        cfg = get_config(name).reduced()
        with pytest.raises(ValueError, match="recurrent"):
            validate_kernel_parallelism(cfg, 2, torch.device("cuda"))
        validate_kernel_parallelism(cfg, 1, torch.device("cuda"))
        validate_kernel_parallelism(cfg, 2, torch.device(CPU))
        # the sharded executor refuses before touching its device
        stand = types.SimpleNamespace(shape={"data": 1, "model": 2},
                                      device=torch.device("cuda"))
        with pytest.raises(ValueError, match="recurrent"):
            ShardedExecutor({}, cfg, S.EngineConfig(tp=2), stand)
    validate_kernel_parallelism(get_config("gpt2-xl"), 4,
                                torch.device("cuda"))
    with pytest.raises(ValueError, match="process group"):
        cfg = get_config("gpt2-xl").reduced()
        S.Engine(T.init_lm_params(cfg, 0, device=CPU), cfg,
                 S.EngineConfig(tp=2, slots=1, max_len=16), device=CPU)


# ---------------------------------------------------------------------------
# ShardedExecutor at tp = 1: the whole sharded path on one process
# ---------------------------------------------------------------------------

def _prompts(lens, seed=7, vocab=512):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


def _waves(prompts, new):
    return [[dict(prompt=p, max_new_tokens=new) for p in prompts]]


@pytest.fixture(scope="module")
def musicgen():
    return _pruned("musicgen-large", 0)


@pytest.mark.parametrize("layout", ["dense", "prefix"])
def test_sharded_executor_tp1_matches_local(musicgen, layout):
    _, _, tp_, cfg = musicgen
    kw = dict(slots=2, max_len=32, prefill_chunk=4, spec_k=2)
    if layout == "prefix":
        kw.update(paged=True, page_tokens=4, prefix_cache=True)
    ecfg = S.EngineConfig(**kw)
    waves = _waves(_prompts((3, 9, 5)), 4) * 2       # the replay hits
    local = serve_waves(ServeRun("local", tp_, cfg, ecfg, waves, trace=True,
                                 trace_logits=True), device=CPU)
    plan = prune.rank_balanced_partition(prune.head_rank_loads(cfg), 1)
    sharded = serve_waves(ServeRun("tp1", tp_, cfg, ecfg, waves, plan=plan,
                                   trace=True, trace_logits=True),
                          device=CPU)
    assert sharded["streams"] == local["streams"]
    assert sharded["trace"] == local["trace"]
    assert [n for n, _ in sharded["logits"]] == [n for n, _ in
                                                 local["logits"]]
    for (_, a), (_, b) in zip(sharded["logits"], local["logits"]):
        np.testing.assert_array_equal(a, b)
    assert sharded["compiled_shapes"] == local["compiled_shapes"]
    assert sharded["shard_load_fractions"] == [1.0]
    assert sharded["kv_perm"] == tuple(range(cfg.n_kv_heads))
    assert sharded["collectives"]["all_reduce"] == 0
    if layout == "prefix":
        assert sharded["salt"][-len(plan.salt()):] == plan.salt()
        assert "tp" not in local["salt"]
        assert sum(sharded["cached_tokens"][1]) > 0


# ---------------------------------------------------------------------------
# tp = 2 and tp = 4 ranks under gloo against the JAX engine
# ---------------------------------------------------------------------------

LAYOUTS = {
    "dense": dict(slots=2, max_len=32, prefill_chunk=4),
    "paged": dict(slots=3, max_len=32, prefill_chunk=4, paged=True,
                  page_tokens=4, n_pages=8),                  # preempts
    "prefix": dict(slots=2, max_len=32, prefill_chunk=4, paged=True,
                   page_tokens=4, n_pages=14, prefix_cache=True,
                   host_pages=8),
}


def _layout_waves(layout):
    """dense / paged: one burst that preempts on the small pool; prefix:
    a page-aligned system prompt, a warm burst (hits), the system prompt
    alone (a full hit: copy-on-write), a churn burst that spills the
    system prompt's pages to the host tier, and the warm burst again
    (restored)."""
    if layout != "prefix":
        return _waves(_prompts((9, 8, 7, 6, 11)), 6)
    rng = np.random.default_rng(5)
    sys_p = rng.integers(0, 512, 8).astype(np.int32)
    warm = [np.concatenate([sys_p, rng.integers(0, 512, 1 + i).astype(
        np.int32)]) for i in range(3)]
    churn = [rng.integers(0, 512, 14).astype(np.int32) for _ in range(3)]
    return [[dict(prompt=p, max_new_tokens=4) for p in wave]
            for wave in ([sys_p], warm, [sys_p.copy()], churn, warm)]


CASES = [(layout, k) for layout in LAYOUTS for k in (0, 2)]
MOE_CASES = [("granite", "dense"), ("granite", "paged"), ("qwen2", "dense")]


def _jax_serve(jp, jcfg, kw, waves, jreg=None):
    """The JAX engine on the same waves -> streams, per-step records,
    every entry's logits, shapes and stats (what ``serve_waves``
    returns)."""
    eng = JS.Engine(jp, jcfg, JS.EngineConfig(**kw), adapters=jreg)
    logits, trace, out, uid = [], [], [], 0
    record_logits(eng.exe, logits)
    for wave in waves:
        reqs = [JS.Request(uid=uid + i, **w) for i, w in enumerate(wave)]
        uid += len(reqs)
        for r in reqs:
            eng.submit(r)
        while eng.sched.busy:
            eng.step()
            trace.append(step_record(eng))
        out.append([list(r.generated) for r in reqs])
    return {"streams": out, "trace": trace, "logits": logits,
            "compiled_shapes": eng.compiled_shapes(), "stats": eng.stats()}


def _check(got_ranks, want, name):
    """Every rank equals the JAX engine: streams, records, shapes, each
    entry's logits within ATOL; the ranks equal each other bit for bit."""
    for rank, got in enumerate(got_ranks):
        assert got["streams"] == want["streams"], (name, rank)
        assert got["trace"] == want["trace"], (name, rank)
        assert got["compiled_shapes"] == want["compiled_shapes"], name
        assert [n for n, _ in got["logits"]] == [n for n, _ in
                                                 want["logits"]], name
        for i, ((_, a), (_, b)) in enumerate(zip(got["logits"],
                                                 want["logits"])):
            np.testing.assert_allclose(a, b, atol=ATOL, rtol=0,
                                       err_msg=f"{name} rank {rank} #{i}")
        for (_, a), (_, b) in zip(got["logits"], got_ranks[0]["logits"]):
            assert a.tobytes() == b.tobytes(), (name, rank)


def _musicgen_runs(musicgen, tp):
    _, _, tp_, cfg = musicgen
    plan = prune.rank_balanced_partition(
        np.arange(cfg.n_kv_heads, dtype=float) + 1.0, tp)
    assert not plan.identity
    return [ServeRun(f"{layout} k{k}", tp_, cfg,
                     S.EngineConfig(tp=tp, spec_k=k, **LAYOUTS[layout]),
                     _layout_waves(layout), plan=plan, trace=True,
                     trace_logits=True)
            for layout, k in CASES]


@pytest.fixture(scope="module")
def extra():
    """Models of the tp = 2 group beyond musicgen: phi3 (one KV head:
    heads replicate, plan None), granite-moe (2 of 4 experts and 1 of 2
    KV heads per rank, tied vocab split) and qwen2-moe (2 of 4 experts
    and its shared expert's ff split: both partial sums reduced at once;
    both MoEs dropless, as the reference's capacity-bounded dispatch has
    a known fault, ROADMAP C), a rank budget (the engine's own non-identity partition, clamps
    permuted and split) and two SV-adapter tenants on a CLOVER-S tree
    under an explicit non-identity plan."""
    def dropless(c):
        return dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=0.0))
    out = {"phi3": _pruned("phi3-medium-14b", 1, ratio=0.0),
           "granite": _pruned("granite-moe-1b-a400m", 2, ratio=0.5,
                              adapt=dropless),
           "qwen2": _pruned("qwen2-moe-a2.7b", 3, ratio=0.5,
                            adapt=dropless),
           "budget": _budgeted()}
    jcfg, cfg = (jax_config("musicgen-large").reduced(),
                 get_config("musicgen-large").reduced())
    jraw = jax_init(jcfg, jax.random.PRNGKey(6))
    td, tdc, _ = clover_decompose(
        from_numpy(jax.tree.map(np.asarray, jraw), CPU), cfg, peft=True)
    reg = AdapterRegistry(td)
    rng = np.random.default_rng(9)
    for _ in range(2):
        reg.register(tuple({k: torch.from_numpy(rng.uniform(
            0.5, 2.0, tuple(v.shape)).astype(np.float32))
            for k, v in e.items()} for e in sv_extract(td)))
    out["adapters"] = (td, tdc, reg)
    return out


def _extra_runs(extra):
    jp, jcfg, tp_, cfg = extra["phi3"]
    runs = [ServeRun("phi3", tp_, cfg, S.EngineConfig(
        tp=2, **LAYOUTS["dense"]), _waves(_prompts((3, 6)), 3),
        trace=True, trace_logits=True)]
    for name, layout in MOE_CASES:
        _, _, tp_, cfg = extra[name]
        runs.append(ServeRun(f"{name} {layout}", tp_, cfg, S.EngineConfig(
            tp=2, **LAYOUTS[layout]), _layout_waves(layout), trace=True,
            trace_logits=True))
    _, _, _, btp, bcfg, plan = extra["budget"]
    for layout in ("dense", "paged"):
        runs.append(ServeRun(f"budget {layout}", btp, bcfg, S.EngineConfig(
            tp=2, rank_budget=plan, spec_k=2, **LAYOUTS[layout]),
            _layout_waves(layout), trace=True, trace_logits=True))
    td, tdc, reg = extra["adapters"]
    part = prune.rank_balanced_partition([1.0, 2.0, 3.0, 4.0], 2)
    waves = [[dict(prompt=p, max_new_tokens=4, adapter_id=i % 3)
              for i, p in enumerate(_prompts((5, 9, 4, 7), seed=3))]]
    runs.append(ServeRun("adapters", td, tdc, S.EngineConfig(
        tp=2, **LAYOUTS["prefix"]), waves, plan=part, adapters=reg,
        trace=True))
    return runs


@pytest.fixture(scope="module")
def tp_groups(musicgen, extra, tmp_path_factory):
    """One rank group per degree: tp = 2 serves musicgen's six cases and
    the extra models, tp = 4 musicgen's six cases."""
    out = {}
    for tp in (2, 4):
        runs = _musicgen_runs(musicgen, tp)
        if tp == 2:
            runs += _extra_runs(extra)
        per_rank = serve_tp(runs, tp=tp, backend="gloo", device=CPU,
                            timeout=RANK_TIMEOUT, threads=1,
                            workdir=str(tmp_path_factory.mktemp(f"tp{tp}")))
        out[tp] = {r.label: [per_rank[k][i] for k in range(tp)]
                   for i, r in enumerate(runs)}
    return out


@pytest.fixture(scope="module")
def jax_musicgen(musicgen):
    jp, jcfg, _, _ = musicgen
    return {f"{layout} k{k}": _jax_serve(jp, jcfg, dict(
        spec_k=k, **LAYOUTS[layout]), _layout_waves(layout))
        for layout, k in CASES}


@pytest.mark.parametrize("layout,k", CASES, ids=[f"{a}-k{b}" for a, b in
                                                 CASES])
@pytest.mark.parametrize("tp", [2, 4])
def test_tp_streams_match_jax(tp_groups, jax_musicgen, tp, layout, k):
    """musicgen reduced, pruned 0.5, a non-identity head plan: every
    rank's streams, scheduling records and shapes equal the JAX
    engine's, every step's logits within ATOL."""
    name = f"{layout} k{k}"
    got, want = tp_groups[tp][name], jax_musicgen[name]
    _check(got, want, f"tp{tp} {name}")
    for rank, g in enumerate(got):
        assert g["rank"] == rank and g["tp"] == tp
        assert g["collectives"]["all_reduce"] > 0
        assert g["kv_perm"] != tuple(range(4))
        # the plain decode versions ran on every rank (CPU tensors)
        assert g["launches"]["decode_attention_ref"] + \
            g["launches"]["paged_decode_attention_ref"] > 0
    st = got[0]["stats"]
    if layout == "paged":
        assert st["preemptions"] == want["stats"]["preemptions"] > 0
    if layout == "prefix":
        assert st["prefix_hits"] == want["stats"]["prefix_hits"] > 0
        assert st["host_spills"] == want["stats"]["host_spills"] > 0
        assert st["host_restores"] == want["stats"]["host_restores"] > 0
        assert got[0]["launches"]["page_copy_ref"] > 0
        assert got[0]["launches"]["page_restore_ref"] > 0
        assert got[0]["salt"][-len(got[0]["plan_salt"]):] == \
            got[0]["plan_salt"]
    if k:
        assert st["accepted_per_round"] == \
            want["stats"]["accepted_per_round"]


def test_tp2_nondivisible_heads_replicate(tp_groups, extra):
    """phi3 reduced has one KV head: no plan, heads and pools replicate;
    only the ff and vocab leaves split."""
    jp, jcfg, _, _ = extra["phi3"]
    want = _jax_serve(jp, jcfg, LAYOUTS["dense"], _waves(_prompts((3, 6)),
                                                         3))
    got = tp_groups[2]["phi3"]
    _check(got, want, "phi3")
    assert got[0]["kv_perm"] is None
    assert got[0]["shard_load_fractions"] == [0.5, 0.5]


@pytest.mark.parametrize("name,layout", MOE_CASES,
                         ids=[f"{a}-{b}" for a, b in MOE_CASES])
def test_tp2_expert_parallel_matches_jax(tp_groups, extra, name, layout):
    jp, jcfg, _, cfg = extra[name]
    assert cfg.n_experts_padded % 2 == 0
    assert cfg.tie_embeddings == (name == "granite")
    assert bool(cfg.moe.n_shared) == (name == "qwen2")
    want = _jax_serve(jp, jcfg, LAYOUTS[layout], _layout_waves(layout))
    _check(tp_groups[2][f"{name} {layout}"], want, f"{name} {layout}")


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_tp2_rank_budget_matches_jax(tp_groups, extra, layout):
    """The engine plans the partition from the budget's head loads (not
    the identity) and the rank clamps follow their heads."""
    bjp, bjc, jplan, _, _, plan = extra["budget"]
    part = prune.rank_balanced_partition(plan.head_loads(), 2, group=1)
    assert not part.identity
    want = _jax_serve(bjp, bjc, dict(rank_budget=jplan, spec_k=2,
                                     **LAYOUTS[layout]),
                      _layout_waves(layout))
    got = tp_groups[2][f"budget {layout}"]
    _check(got, want, f"budget {layout}")
    assert got[0]["kv_perm"] == part.kv_perm


def test_tp2_adapters_match_folded_references(tp_groups, extra):
    """Two SV-adapter tenants and the identity at tp = 2 under a
    non-identity plan (the bank permuted and split with the heads):
    each stream equals ``greedy_reference`` on its tenant's folded
    model."""
    td, tdc, reg = extra["adapters"]
    got = tp_groups[2]["adapters"]
    prompts = _prompts((5, 9, 4, 7), seed=3)
    want = [S.greedy_reference(reg.folded(td, i % 3), tdc, p, 4,
                               device=CPU) for i, p in enumerate(prompts)]
    for g in got:
        assert g["streams"] == [want]
        assert g["trace"] == got[0]["trace"]
        assert g["kv_perm"] != tuple(range(4))


# ---------------------------------------------------------------------------
# data replicas: (data 2) and (data 2, model 2) against the JAX engine
# ---------------------------------------------------------------------------

# slots split over the replicas: every layout holds a multiple of 2
DATA_LAYOUTS = {"dense": LAYOUTS["dense"],
                "paged": dict(LAYOUTS["paged"], slots=4),        # preempts
                "prefix": LAYOUTS["prefix"]}
DATA_CASES = [("dense", 0), ("paged", 0), ("prefix", 0), ("prefix", 2)]


@pytest.fixture(scope="module")
def data_groups(musicgen, tmp_path_factory):
    """musicgen's data cases on (data 2, model 1) -- the engine builds
    the ShardedExecutor itself -- and on (data 2, model 2) under a
    non-identity head plan."""
    _, _, tp_, cfg = musicgen
    out = {}
    for tp in (1, 2):
        plan = None if tp == 1 else prune.rank_balanced_partition(
            np.arange(cfg.n_kv_heads, dtype=float) + 1.0, tp)
        runs = [ServeRun(f"{layout} k{k}", tp_, cfg,
                         S.EngineConfig(tp=tp, spec_k=k,
                                        **DATA_LAYOUTS[layout]),
                         _layout_waves(layout), plan=plan, trace=True,
                         trace_logits=True)
                for layout, k in DATA_CASES]
        per_rank = serve_tp(runs, tp=tp, data=2, backend="gloo", device=CPU,
                            timeout=RANK_TIMEOUT, threads=1,
                            workdir=str(tmp_path_factory.mktemp(
                                f"data2tp{tp}")))
        out[tp] = {r.label: [per_rank[k][i] for k in range(2 * tp)]
                   for i, r in enumerate(runs)}
    return out


@pytest.mark.parametrize("layout,k", DATA_CASES,
                         ids=[f"{a}-k{b}" for a, b in DATA_CASES])
@pytest.mark.parametrize("tp", [1, 2])
def test_data_replicas_match_jax(data_groups, musicgen, tp, layout, k):
    """Two data replicas, each serving its half of the slots, in
    lockstep with the JAX engine at tp = 1: every rank's streams,
    records (the page tables and free lists of the whole pool, which
    every replica holds) and shapes, each step's logits within ATOL.
    The prefix case's warm burst hits pages the system prompt's request
    wrote in slot 0, from slot 1 -- the other replica's."""
    jp, jcfg, _, _ = musicgen
    name = f"{layout} k{k}"
    want = _jax_serve(jp, jcfg, dict(spec_k=k, **DATA_LAYOUTS[layout]),
                      _layout_waves(layout))
    got = data_groups[tp][name]
    for rank, g in enumerate(got):
        assert (g["data"], g["replica"], g["tp"]) == (2, rank // tp, tp)
        assert g["collectives"]["all_gather"] > 0
    _check(got, want, f"data2 tp{tp} {name}")
    st = got[0]["stats"]
    if layout == "paged":
        assert st["preemptions"] == want["stats"]["preemptions"] > 0
    if layout == "prefix":
        assert st["prefix_hits"] == want["stats"]["prefix_hits"] > 0
        assert st["host_restores"] == want["stats"]["host_restores"] > 0
        # the warm burst's second request sat in slot 1 (replica 1)
        assert got[0]["cached_tokens"][1][1] > 0
        assert got[-1]["launches"]["page_restore_ref"] > 0


def test_data_replicas_refuse_uneven_slots():
    cfg = get_config("gpt2-xl").reduced()
    stand = types.SimpleNamespace(shape={"data": 2, "model": 1},
                                  coords={"data": 0, "model": 0},
                                  device=torch.device(CPU))
    with pytest.raises(ValueError, match="data replicas"):
        ShardedExecutor({}, cfg, S.EngineConfig(slots=3, max_len=16), stand)


def test_engine_data_extent_is_explicit():
    """The data extent is ``EngineConfig.data``, never inferred from the
    process group: without a group of data * tp ranks an engine at
    data 2 refuses to build, and ``serve_tp`` refuses a run configured
    for another extent."""
    with pytest.raises(ValueError, match="data replicas"):
        S.EngineConfig(data=0)
    cfg = get_config("gpt2-xl").reduced()
    with pytest.raises(ValueError, match="needs 2 ranks"):
        S.Engine({}, cfg, S.EngineConfig(data=2, slots=2, max_len=16),
                 device=CPU)
    run = ServeRun("x", {}, cfg, S.EngineConfig(data=4), [])
    with pytest.raises(ValueError, match="data=2"):
        serve_tp([run], tp=1, data=2, backend="gloo", device=CPU)
