"""The port's page movers over every KV leaf of a batch (``csrc/
page_copy.cu``: one launch per batch), checked on the CPU.

* The multi-leaf plain versions equal the reference's ``page_copy`` /
  ``page_restore`` on each leaf (its oracle and its Pallas kernel in
  interpret mode), bit for bit, on float32, bfloat16 and float8 pools
  with K and V of different widths.
* The executor makes one mover call per batch, and its pools equal the
  reference executor's after a copy-on-write and a restore batch; it
  hands the mover a restore's slabs as bits; it refuses a copy batch
  whose in-order and gather-then-scatter results could differ.
* The host planner (``kernels.page_copy.plan_movers``): the leaf cap,
  the route by alignment, shared memory per block, pairs per group,
  and an emulation of the bulk kernel's walk over the plan's blocks
  equal to the plain version (every byte of every ``dst`` row written,
  every other byte kept).
* The meta route's cost report: the same bytes as one report per leaf.
"""
import math

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
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import init_lm_params as jax_init  # noqa: E402
from repro.serve.executor import _is_kv  # noqa: E402
from repro_torch import serve as S  # noqa: E402
from repro_torch.bridge import from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import page_copy as PC  # noqa: E402
from repro_torch.models.transformer import init_lm_params  # noqa: E402
from repro_torch.serve.executor import check_copy_order  # noqa: E402

CPU = "cpu"
DTYPES = ("float32", "bfloat16", "float8_e4m3fn")
# K and V leaves of different widths (the ranked decode's 32 and 56),
# cut to (n_blocks, N, page_tokens, KV): row N - 1 is the sentinel
KV_WIDTHS = (32, 56)
GEOM = (3, 9, 4, 2)
SNT = GEOM[1] - 1


def _cast(x: np.ndarray, dtype: str) -> np.ndarray:
    """float64 ``x`` rounded to ``dtype`` (an ml_dtypes array for the
    narrow ones), writable."""
    return np.array(jnp.asarray(x, jnp.float32).astype(dtype))


def _pools(rng, dtype):
    """K and V pools of ``GEOM`` at the two widths, of ``dtype``."""
    return [_cast(rng.standard_normal(GEOM + (r,)), dtype)
            for r in KV_WIDTHS]


def _t(a: np.ndarray) -> torch.Tensor:
    return from_numpy({"a": a}, CPU)["a"]


def _bits(a) -> np.ndarray:
    """Bit patterns of a numpy array or a CPU tensor as unsigned ints."""
    if torch.is_tensor(a):
        a = a.contiguous()
        if a.element_size() < 4:
            a = a.view(torch.uint16 if a.element_size() == 2
                       else torch.uint8)
        a = a.numpy()
    a = np.asarray(a)
    return a.view(f"u{a.dtype.itemsize}")


# ---------------------------------------------------------------------------
# the multi-leaf plain versions vs the reference, leaf by leaf
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_leaves_ref_match_jax_per_leaf(dtype):
    """One call of each multi-leaf plain version on K and V of widths 32
    and 56 equals the reference's oracle and its Pallas kernel
    (interpret mode) on each leaf, bit for bit: a copy batch with a
    source that a LATER pair overwrites and sentinel padding, and a
    restore batch with zero-slab padding."""
    rng = np.random.default_rng(11)
    src, dst = [5, 1, 3, SNT], [0, 6, 5, SNT]
    pools = _pools(rng, dtype)
    tpools = [_t(p.copy()) for p in pools]
    calls = (ref.page_copy_leaves_ref.calls, ref.page_copy_ref.calls)
    out = ref.page_copy_leaves_ref(tpools, torch.tensor(src),
                                   torch.tensor(dst))
    assert out is tpools
    assert (ref.page_copy_leaves_ref.calls, ref.page_copy_ref.calls) == (
        calls[0] + 1, calls[1] + len(pools))
    s, d = np.asarray(src, np.int32), np.asarray(dst, np.int32)
    for got, pool in zip(tpools, pools):
        want = np.asarray(jref.page_copy_ref(jnp.asarray(pool), s, d))
        pallas = np.asarray(jops.page_copy(jnp.asarray(pool), jnp.asarray(s),
                                           jnp.asarray(d), impl="interpret"))
        np.testing.assert_array_equal(_bits(got), _bits(want))
        np.testing.assert_array_equal(_bits(got), _bits(pallas))

    W, n_real = 4, 2
    rdst = np.asarray([4, 2, SNT, SNT], np.int32)
    rows = []
    for p in pools:
        r = _cast(rng.standard_normal((GEOM[0], W) + p.shape[2:]), dtype)
        r[:, n_real:] = 0
        rows.append(r)
    tpools = [_t(p.copy()) for p in pools]
    calls = ref.page_restore_leaves_ref.calls
    ref.page_restore_leaves_ref(tpools, [_t(r) for r in rows],
                                torch.from_numpy(rdst))
    assert ref.page_restore_leaves_ref.calls == calls + 1
    for got, pool, r in zip(tpools, pools, rows):
        want = np.asarray(jref.page_restore_ref(jnp.asarray(pool),
                                                jnp.asarray(r), rdst))
        pallas = np.asarray(jops.page_restore(
            jnp.asarray(pool), jnp.asarray(r), jnp.asarray(rdst),
            impl="interpret"))
        np.testing.assert_array_equal(_bits(got), _bits(want))
        np.testing.assert_array_equal(_bits(got), _bits(pallas))
        keep = [i for i in range(GEOM[1]) if i not in set(rdst.tolist())]
        np.testing.assert_array_equal(_bits(got)[:, keep],
                                      _bits(pool)[:, keep])


def test_ops_dispatch_leaves_on_cpu_and_refuse_past_the_cap():
    """CPU pools reach the multi-leaf plain versions (counted, in place,
    no build); the kernel wrappers refuse CPU tensors and more leaves
    than the table holds before any build."""
    rng = np.random.default_rng(3)
    pools = [_t(p) for p in _pools(rng, "float32")]
    src, dst = torch.tensor([0, 3]), torch.tensor([2, 4])
    want = [p[:, [0, 3]].clone() for p in pools]
    before = (ref.page_copy_leaves_ref.calls, PC.page_copy.launches)
    ops.page_copy_leaves(pools, src, dst)
    for p, w in zip(pools, want):
        assert torch.equal(p[:, [2, 4]], w)
    assert (ref.page_copy_leaves_ref.calls, PC.page_copy.launches) == (
        before[0] + 1, before[1])
    with pytest.raises(ValueError, match="CUDA"):
        PC.page_copy_leaves(pools, src.int(), dst.int())
    with pytest.raises(ValueError, match="table holds 16"):
        PC.page_copy_leaves(pools * 9, src.int(), dst.int())
    with pytest.raises(ValueError, match="table holds 16"):
        PC.page_restore_leaves(pools * 9, pools * 9, dst.int())
    assert _build._lib is None


# ---------------------------------------------------------------------------
# the executor: one mover call per batch, pools equal to the reference's
# ---------------------------------------------------------------------------

ECFG = dict(slots=2, max_len=16, prefill_chunk=4, paged=True,
            page_tokens=4, n_pages=6, prefix_cache=True, host_pages=4)


def _jax_kv(state):
    out = []
    jax.tree_util.tree_map_with_path(
        lambda path, leaf: out.append(np.asarray(leaf)) if _is_kv(path)
        else None, state["blocks"])
    return out


def _with_jax_kv(state, leaves):
    it = iter(leaves)
    blocks = jax.tree_util.tree_map_with_path(
        lambda path, leaf: jnp.asarray(next(it)) if _is_kv(path) else leaf,
        state["blocks"])
    return dict(state, blocks=blocks)


@pytest.mark.parametrize("dtype", DTYPES)
def test_executor_one_call_per_batch_matches_jax_executor(dtype):
    """The port's executor moves a copy-on-write batch and a restore
    batch with one plain-version call each (one per-leaf call per KV
    leaf inside it), and its pools then equal the reference executor's,
    bit for bit, from the same pools."""
    import dataclasses
    jcfg = dataclasses.replace(jax_config("gpt2-xl").reduced(),
                               kv_cache_dtype=dtype)
    cfg = dataclasses.replace(get_config("gpt2-xl").reduced(),
                              kv_cache_dtype=dtype)
    jexe = JS.LocalExecutor(jax_init(jcfg, jax.random.PRNGKey(0)), jcfg,
                            JS.EngineConfig(**ECFG))
    texe = S.LocalExecutor(init_lm_params(cfg, 0, device=CPU), cfg,
                           S.EngineConfig(**ECFG), torch.device(CPU))
    jstate, tstate = jexe.init_state(), texe.init_state()
    rng = np.random.default_rng(5)
    leaves = [_cast(rng.standard_normal(a.shape), dtype)
              for a in _jax_kv(jstate)]
    assert len(leaves) == 2
    jstate = _with_jax_kv(jstate, leaves)
    tleaves = list(S.executor._kv_leaves(tstate["blocks"]))
    for t, a in zip(tleaves, leaves):
        t.copy_(_t(a))
    snt = tleaves[0].shape[1] - 1
    src, dst = np.asarray([1, 3], np.int32), np.asarray([4, 0], np.int32)
    rows = [_cast(rng.standard_normal((a.shape[0], 2) + a.shape[2:]), dtype)
            for a in leaves]
    for r in rows:
        r[:, 1] = 0
    rdst = np.asarray([2, snt], np.int32)
    calls = (ref.page_copy_leaves_ref.calls, ref.page_copy_ref.calls,
             ref.page_restore_leaves_ref.calls, ref.page_restore_ref.calls)
    tstate = texe.page_copy(tstate, src, dst)
    tstate = texe.page_restore(tstate, [_bits(r) if r.dtype.itemsize < 4
                                        else r for r in rows], rdst)
    assert (ref.page_copy_leaves_ref.calls, ref.page_copy_ref.calls,
            ref.page_restore_leaves_ref.calls,
            ref.page_restore_ref.calls) == (calls[0] + 1, calls[1] + 2,
                                            calls[2] + 1, calls[3] + 2)
    jstate = jexe.page_copy(jstate, src, dst)
    jstate = jexe.page_restore(jstate, rows, rdst)
    for got, want in zip(S.executor._kv_leaves(tstate["blocks"]),
                         _jax_kv(jstate)):
        np.testing.assert_array_equal(_bits(got), _bits(want))
    assert texe.compiled_shapes() == 2


def test_engine_moves_each_batch_with_one_call():
    """A prefix-cached paged engine with a host tier over a trace that
    copies on write, spills and restores: the multi-leaf plain versions
    run exactly once per executor batch, never per leaf."""
    cfg = get_config("gpt2-xl").reduced()
    eng = S.Engine(init_lm_params(cfg, 0, device=CPU), cfg, S.EngineConfig(
        slots=2, max_len=48, prefill_chunk=8, paged=True, page_tokens=4,
        n_pages=14, prefix_cache=True, host_pages=56), device=CPU)
    batches = {"page_copy": 0, "page_restore": 0}
    for name in batches:
        def counted(*args, _f=getattr(eng.exe, name), _n=name):
            batches[_n] += 1
            return _f(*args)
        setattr(eng.exe, name, counted)
    rng = np.random.default_rng(7)
    sys_p = rng.integers(0, 512, 16).astype(np.int32)
    burst = [np.concatenate([sys_p, rng.integers(0, 512, n).astype(
        np.int32)]) for n in (3, 6)] + [sys_p.copy()]
    churn = [rng.integers(0, 512, 30).astype(np.int32) for _ in range(4)]
    before = (ref.page_copy_leaves_ref.calls,
              ref.page_restore_leaves_ref.calls)
    uid = 0
    for new, wave in zip((4, 4, 6, 4), ([sys_p], burst, churn, burst)):
        for p in wave:
            eng.submit(S.Request(uid=uid, prompt=p, max_new_tokens=new))
            uid += 1
        while eng.sched.busy:
            eng.step()
    assert batches["page_copy"] >= 1 and batches["page_restore"] >= 1
    assert (ref.page_copy_leaves_ref.calls - before[0],
            ref.page_restore_leaves_ref.calls - before[1]) == (
        batches["page_copy"], batches["page_restore"])
    assert eng.compiled_shapes() == 4


@pytest.mark.parametrize("src,dst,refused", [
    ([1, 2, 5, 5], [3, 4, 5, 5], None),          # distinct + sentinel pads
    ([3, 2, 5, 5], [4, 3, 5, 5], None),          # a source a LATER pair writes
    ([1, 3, 5, 5], [3, 4, 5, 5], "chained"),     # pair 1 reads what 0 wrote
    ([1, 2, 5, 5], [3, 3, 5, 5], "twice"),       # one row from two sources
    ([5, 5, 1, 5], [5, 5, 5, 5], "twice"),       # a real pair onto a pad's
    ([2, 4, 4, 5], [4, 1, 4, 5], "chained"),     # a self-copy of a written row
])
def test_copy_order_guard(src, dst, refused):
    """``check_copy_order`` passes every batch on which reading every
    source first equals moving the pairs in order (the reference's
    kernel, interpret mode) and refuses the others; the executor's page
    ids go through it."""
    s, d = np.asarray(src, np.int32), np.asarray(dst, np.int32)
    if refused:
        with pytest.raises(ValueError, match=refused):
            check_copy_order(s, d)
        return
    check_copy_order(s, d)
    pool = np.random.default_rng(1).standard_normal(
        (2, 6, 2, 1, 4)).astype(np.float32)
    got = ref.page_copy_ref(torch.from_numpy(pool.copy()),
                            torch.from_numpy(s), torch.from_numpy(d))
    want = jops.page_copy(jnp.asarray(pool), jnp.asarray(s), jnp.asarray(d),
                          impl="interpret")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_executor_refuses_a_chained_copy_batch():
    cfg = get_config("gpt2-xl").reduced()
    exe = S.LocalExecutor(init_lm_params(cfg, 0, device=CPU), cfg,
                          S.EngineConfig(**ECFG), torch.device(CPU))
    state = exe.init_state()
    calls = ref.page_copy_leaves_ref.calls
    with pytest.raises(ValueError, match="chained copy batch"):
        exe.page_copy(state, np.asarray([1, 3]), np.asarray([3, 4]))
    assert ref.page_copy_leaves_ref.calls == calls
    exe.page_copy(state, np.asarray([1, 3]), np.asarray([4, 1]))
    assert ref.page_copy_leaves_ref.calls == calls + 1


@pytest.mark.parametrize("dtype", DTYPES)
def test_executor_restore_slabs_keep_their_bits(dtype):
    """The executor hands the mover each leaf's slabs as the host tier
    holds them (a 16- or 8-bit pool's as its unsigned bit patterns),
    viewed as the pool's dtype: the same bits, never converted
    values."""
    import dataclasses
    cfg = dataclasses.replace(get_config("gpt2-xl").reduced(),
                              kv_cache_dtype=dtype)
    exe = S.LocalExecutor(init_lm_params(cfg, 0, device=CPU), cfg,
                          S.EngineConfig(**ECFG), torch.device(CPU))
    leaves = list(S.executor._kv_leaves(exe.init_state()["blocks"]))
    rng = np.random.default_rng(8)
    rows = [_bits(_cast(rng.standard_normal((p.shape[0], 2)
                                            + tuple(p.shape[2:])), dtype))
            for p in leaves]
    slabs = exe._rows_to_device(rows, leaves)
    for s, r, p in zip(slabs, rows, leaves):
        assert s.dtype == p.dtype and tuple(s.shape) == r.shape
        np.testing.assert_array_equal(_bits(s), r)


# ---------------------------------------------------------------------------
# the host planner, and an emulation of the kernels' walk over its plan
# ---------------------------------------------------------------------------

def _leaf(ptr, shape, itemsize, rows=0):
    nb, N = shape[:2]
    return (ptr, rows, nb, N, math.prod(shape[2:]) * itemsize)


MAIN = (48, 49, 16, 25)       # gpt2-xl's pool, pruned 32/32 (and 56 wide)


def test_plan_leaf_cap():
    leaf = _leaf(1 << 20, MAIN + (32,), 4)
    assert len(PC.plan_movers([leaf] * PC.MAX_LEAVES, 4).table) == 16
    with pytest.raises(ValueError, match="table holds 16"):
        PC.plan_movers([leaf] * (PC.MAX_LEAVES + 1), 4)


@pytest.mark.parametrize("row_bytes,skew,rows_skew,route,access", [
    (51200, 0, None, "bulk", 16),         # gpt2-xl float32: every pool served
    (12800, 0, None, "bulk", 16),         # its float8 pool
    (12800, 0, 0, "bulk", 16),            # a restore's packed slabs
    (51200, 8, None, "bytes", 8),         # a pool 8 bytes off 16
    (51200, 0, 4, "bytes", 4),            # slabs 4 bytes off 16
    (60, 0, None, "bytes", 4),            # odd rows: the byte route
    (24, 0, 0, "bytes", 8),
    (30, 0, None, "bytes", 2),
    (15, 0, 0, "bytes", 1),
])
def test_plan_route_by_alignment(row_bytes, skew, rows_skew, route, access):
    """The route and access width follow every leaf's row bytes and
    every pointer: the pools' and, for a restore, its slabs'."""
    base = 1 << 20
    rows = (lambda k: 0) if rows_skew is None else (
        lambda k: base * k + rows_skew)
    leaves = [(base + skew, rows(2), 48, 49, row_bytes),
              (base * 4, rows(8), 48, 49, 16 * 25 * 56)]
    plan = PC.plan_movers(leaves, 4)
    assert (plan.route, plan.access) == (route, access)
    if route == "bytes":
        assert plan.chunk == PC.THREADS * access and plan.smem == 0
    else:
        assert plan.group == 4 and plan.smem == PC.BAR_BYTES + 4 * plan.chunk


@pytest.mark.parametrize("itemsize", [4, 2, 1])
@pytest.mark.parametrize("m", [4, 90, 7, 0])
def test_plan_chunks_groups_and_shared_memory(itemsize, m):
    """Chunks are multiples of 16 of at most ``CHUNK_BYTES`` that cut
    the widest row near-evenly (never a power of two on gpt2-xl's rows),
    the shared memory of a block stays within the H100's 227 KB, the
    pairs run in groups of at most what it holds, and the table's blocks
    tile the grid."""
    leaves = [_leaf(1 << 20, MAIN + (r,), itemsize) for r in KV_WIDTHS]
    plan = PC.plan_movers(leaves, m)
    widest = 16 * 25 * 56 * itemsize
    assert plan.route == "bulk" and plan.chunk % 16 == 0
    assert plan.chunk <= PC.CHUNK_BYTES
    n = math.ceil(widest / plan.chunk)
    assert n == math.ceil(widest / PC.CHUNK_BYTES)
    assert widest - (n - 1) * plan.chunk >= plan.chunk - 16 * n
    assert plan.chunk & (plan.chunk - 1)
    assert plan.smem == PC.BAR_BYTES + plan.group * plan.chunk
    assert plan.smem <= PC.SMEM_MAX == 227 * 1024
    assert plan.group == max(1, min(m, (PC.SMEM_MAX - PC.BAR_BYTES)
                                    // plan.chunk))
    start = 0
    for pool, rows, nb, N, row, n_chunks, cta_start in plan.table:
        assert (n_chunks - 1) * plan.chunk < row <= n_chunks * plan.chunk
        assert cta_start == start
        start += nb * n_chunks
    assert plan.ctas == (start if m else 0)
    if m == 90:
        assert plan.group < m               # more pairs than one group


def _emulate(plan, pools, src, dst, slabs=None):
    """The kernels' walk over ``plan`` on byte arrays (n_blocks, N, row)
    per leaf: each block finds its leaf, pool block and chunk as
    ``place`` does; the bulk route reads every pair of a group before it
    writes any (a copy skips self-copies), the byte route moves pair by
    pair.  Returns how many
    times each byte was written."""
    written = [np.zeros(p.shape, np.int64) for p in pools]
    m = len(dst)
    for cta in range(plan.ctas):
        li = max(i for i, lf in enumerate(plan.table) if lf[6] <= cta)
        lf = plan.table[li]
        block, c = divmod(cta - lf[6], lf[5])
        off = c * plan.chunk
        end = min(lf[4], off + plan.chunk)
        layer = pools[li][block]
        group = plan.group if plan.route == "bulk" else 1
        for g0 in range(0, m, group):
            pairs = [i for i in range(g0, min(m, g0 + group))
                     if slabs is not None or src[i] != dst[i]]
            staged = [(slabs[li][block, i] if slabs is not None
                       else layer[src[i]])[off:end].copy() for i in pairs]
            for i, data in zip(pairs, staged):
                layer[dst[i], off:end] = data
                written[li][block, dst[i], off:end] += 1
    return written


@pytest.mark.parametrize("kind", ["copy", "restore", "restore groups",
                                  "copy groups", "copy bytes"])
def test_emulated_walk_equals_plain_version(kind):
    """The kernels' index arithmetic over the planner's table, emulated
    on K / V byte pools of different widths: every ``dst`` byte written
    (a copy's padding not at all), nothing else touched, and the pools
    equal to the plain version's (every read sees the input pool)."""
    rng = np.random.default_rng(4)
    N, W = 40, 6
    # rows of 2 and 3 chunks, the last one short
    rows_b = [16 * 4 * 2 * 40, 16 * 4 * 2 * 72]
    if kind == "copy bytes":
        rows_b = [4 * 15, 4 * 9]
    pools = [rng.integers(0, 256, (3, N, r), dtype=np.uint8)
             for r in rows_b]
    snt = N - 1
    src = [7, 2, 30, 2, snt, snt]
    dst = [12, 7, 31, 33, snt, snt]
    leaves = [(1 << 20, 0, 3, N, r) for r in rows_b]
    slabs = None
    if kind.startswith("restore"):
        dst = [12, 7, 31, 33, snt, snt]
        slabs = [rng.integers(0, 256, (3, W, r), dtype=np.uint8)
                 for r in rows_b]
        for s in slabs:
            s[:, 4:] = 0
        leaves = [(1 << 20, 1 << 21, 3, N, r) for r in rows_b]
    plan = PC.plan_movers(leaves, len(dst))
    if kind.endswith("groups"):
        plan = PC.MoverPlan(plan.route, plan.access, plan.chunk, 2,
                            PC.BAR_BYTES + 2 * plan.chunk, plan.table,
                            plan.ctas)
    assert plan.route == ("bytes" if kind == "copy bytes" else "bulk")
    if plan.route == "bulk":
        assert [lf[5] for lf in plan.table] == [2, 3]
    want = [torch.from_numpy(p.copy()) for p in pools]
    if slabs is None:
        ref.page_copy_leaves_ref(want, torch.tensor(src), torch.tensor(dst))
    else:
        ref.page_restore_leaves_ref(want, [torch.from_numpy(s)
                                           for s in slabs],
                                    torch.tensor(dst))
    got = [p.copy() for p in pools]
    written = _emulate(plan, got, src, dst, slabs)
    for g, w, p, n in zip(got, want, pools, written):
        np.testing.assert_array_equal(g, w.numpy())
        real = sorted({d for s_, d in zip(src, dst)
                       if slabs is not None or s_ != d})
        assert (n[:, real] >= 1).all()
        other = [i for i in range(N) if i not in real]
        assert (n[:, other] == 0).all()
        if kind == "copy":
            assert (n[:, real] == 1).all()


# ---------------------------------------------------------------------------
# the meta route's cost report
# ---------------------------------------------------------------------------

def test_meta_reports_the_bytes_of_one_report_per_leaf():
    """The multi-leaf entries report, in one report per batch, the bytes
    that one single-leaf report per leaf gives: the dry-run's numbers do
    not move."""
    pools = [torch.empty(MAIN + (r,), device="meta") for r in KV_WIDTHS]
    src = torch.empty((4,), dtype=torch.int32, device="meta")
    rows = [torch.empty((48, 4) + MAIN[2:] + (r,), device="meta")
            for r in KV_WIDTHS]
    for multi, single, args in (
            (ops.page_copy_leaves, ops.page_copy, (src, src)),
            (ops.page_restore_leaves, ops.page_restore, None)):
        one, many = [], []
        with ops.kernel_costs(lambda *r: many.append(r)):
            if args:
                multi(pools, *args)
            else:
                multi(pools, rows, src)
        with ops.kernel_costs(lambda *r: one.append(r)):
            for j, p in enumerate(pools):
                single(p, *(args or (rows[j], src)))
        assert len(many) == 1 and len(one) == len(pools)
        assert many[0][0] == one[0][0]
        assert many[0][1:] == (0.0, sum(r[2] for r in one))
