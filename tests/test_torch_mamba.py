"""The port's jamba path against the JAX package at a reduced
jamba-v0.1-52b (16 layers = 2 periods, d_model 128, 4 heads over 1 KV
head of 32 (G = 4), 4 experts top-2, dI 256, dS 16): the plain Mamba
selective scan against the JAX oracle and the reference's XLA scan, the
Mamba block stateless and stateful, the MoE dispatch dropless and
capacity-bounded, the GQA CLOVER decompose and prune, the init tree,
logits and decode states on the same (numpy-bridged) weights, and the
serving engines in lockstep with the JAX engine.

The reference's Pallas mamba kernel does not run under the installed
JAX (``pl.store`` is gone), so the port is held to
``repro.kernels.ref.mamba_scan_ref``, the XLA ``_selective_scan`` and
``mamba_forward`` on its XLA path.  The engines are dropless
(``capacity_factor`` 0, as the reference's own jamba tests run them):
with a capacity bound a prefill chunk drops tokens depending on which
other slots share the step, in the reference as in the port.

Tolerances: 2e-5 x max(1, max |want|) on the scan (the state sums S
decayed updates; the XLA scan sums in another order), 1e-5 on the MoE
output and aux losses (experts run on gathered rows instead of capacity
buffers), 1e-4 on Mamba blocks, logits and states (float32 through up
to 16 layers, summed in another order).
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

from repro import serve as JS  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import clover_decompose as jax_decompose  # noqa: E402
from repro.core import clover_prune as jax_prune  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.models import init_lm_params as jax_init  # noqa: E402
from repro.models import mamba as JM  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import serve as S  # noqa: E402
from repro_torch.bridge import from_numpy, to_numpy, tree_map  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import jamba_pattern  # noqa: E402
from repro_torch.core.decompose import clover_decompose  # noqa: E402
from repro_torch.core.prune import clover_prune  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels.mamba_scan import mamba_scan as scan_kernel  # noqa: E402
from repro_torch.models import mamba as M  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

CPU = "cpu"
TOL = 2e-5          # scan function, scaled by max(1, max |want|)
MOE_TOL = 1e-5      # MoE output and aux losses
MODEL_TOL = 1e-4    # Mamba blocks, logits, decode states


def _dropless(cfg):
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=0.0))


@pytest.fixture(scope="module")
def model():
    """(jax params, jax cfg, port params, port cfg) on the same weights,
    dropless."""
    jcfg = _dropless(jax_config("jamba-v0.1-52b").reduced())
    cfg = _dropless(get_config("jamba-v0.1-52b").reduced())
    jp = jax_init(jcfg, jax.random.PRNGKey(5))
    return jp, jcfg, from_numpy(jax.tree.map(np.asarray, jp), CPU), cfg


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _close(got, want, atol):
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=atol, rtol=0)


def _scaled(got, want, tol=TOL):
    want = np.asarray(want)
    _close(got, want, tol * max(1.0, float(np.abs(want).max())))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
        return out
    return {prefix: tree}


def _layer(tree, i=0):
    return jax.tree.map(lambda a: a[i], tree)


# -- config ---------------------------------------------------------------

def test_config_copy_matches_reference():
    """The port's jamba config equals the reference's field for field
    (full and reduced); ``n_params`` is exact where the reference's is
    approximate (one Mamba vector of three, no final norm)."""
    from repro.configs.base import jamba_pattern as jax_pattern
    for reduce in (False, True):
        jcfg, cfg = jax_config("jamba-v0.1-52b"), get_config("jamba-v0.1-52b")
        if reduce:
            jcfg, cfg = jcfg.reduced(), cfg.reduced()
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert (cfg.mamba_d_inner, cfg.mamba_dt_rank_, cfg.q_per_kv) == \
            (jcfg.mamba_d_inner, jcfg.mamba_dt_rank_, jcfg.q_per_kv)
    assert jamba_pattern() == jax_pattern()
    period = dataclasses.replace(get_config("jamba-v0.1-52b"), n_layers=8)
    jperiod = dataclasses.replace(jax_config("jamba-v0.1-52b"), n_layers=8)
    assert period.n_params() == 13_295_235_072
    dI, D = period.mamba_d_inner, period.d_model
    assert period.n_params() - jperiod.n_params() == 7 * 2 * dI + D


# -- the scan function ----------------------------------------------------

def _scan_inputs(B, S_, dI, dS, seed, h0="random"):
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((B, S_, dI)) - 2.0)
                  ).astype(np.float32)
    x = rng.standard_normal((B, S_, dI)).astype(np.float32)
    Bm = rng.standard_normal((B, S_, dS)).astype(np.float32)
    C = rng.standard_normal((B, S_, dS)).astype(np.float32)
    A = (np.arange(1, dS + 1, dtype=np.float32)[None, :]
         * np.exp2(rng.uniform(-1, 1, (dI, 1)))).astype(np.float32)
    state = {"none": None, "zero": np.zeros((B, dI, dS), np.float32),
             "random": rng.standard_normal((B, dI, dS)).astype(np.float32)
             }[h0]
    return dt, A, Bm, C, x, state


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("S_", [1, 7, 130, 256])
@pytest.mark.parametrize("h0", ["none", "zero", "random"])
def test_mamba_scan_plain_matches_jax_oracle_and_xla_scan(S_, h0):
    """S = 130 is no multiple of the reference's 128-step chunk (its XLA
    scan then runs one chunk of S), S = 256 two chunks."""
    dt, A, Bm, C, x, h = _scan_inputs(2, S_, 48, 16, seed=S_, h0=h0)
    got_y, got_h = ops.mamba_scan(*(_t(a) for a in (dt, A, Bm, C, x, h)))
    want_y, want_h = jax_ref.mamba_scan_ref(dt, A, Bm, C, x, h)
    _scaled(got_y, want_y)
    _scaled(got_h, want_h)
    h_xla = np.zeros((2, 48, 16), np.float32) if h is None else h
    xla_y, xla_h = JM._selective_scan(jnp.asarray(dt), jnp.asarray(A),
                                      jnp.asarray(Bm), jnp.asarray(C),
                                      jnp.asarray(x), jnp.asarray(h_xla))
    _scaled(got_y, xla_y)
    _scaled(got_h, xla_h)


def test_mamba_scan_chained_calls_equal_one_call():
    """The engine's chunk -> TAIL handoff: S1 steps, then S2 from
    h_end, equal one call over S1 + S2; h0 is never written."""
    dt, A, Bm, C, x, h = (_t(a) for a in _scan_inputs(2, 21, 40, 16, 9))
    before = h.clone()
    y, hN = ops.mamba_scan(dt, A, Bm, C, x, h)
    y1, h1 = ops.mamba_scan(dt[:, :13], A, Bm[:, :13], C[:, :13],
                            x[:, :13], h)
    y2, h2 = ops.mamba_scan(dt[:, 13:], A, Bm[:, 13:], C[:, 13:],
                            x[:, 13:], h1)
    _scaled(torch.cat([y1, y2], dim=1), _np(y))
    _scaled(h2, _np(hN))
    assert torch.equal(h, before)


def test_mamba_scan_dispatch_and_kernel_guard():
    """CPU tensors reach the plain version (never the kernel); the
    kernel wrapper refuses CPU tensors and state sizes it has no
    instance for before building anything."""
    args = [_t(a) for a in _scan_inputs(1, 3, 8, 16, seed=2)]
    before, launches = ref.mamba_scan_ref.calls, scan_kernel.launches
    ops.mamba_scan(*args)
    assert ref.mamba_scan_ref.calls == before + 1
    assert scan_kernel.launches == launches
    with pytest.raises(ValueError, match="CUDA"):
        scan_kernel(*args)
    with pytest.raises(ValueError, match="dS=8"):
        scan_kernel(*[_t(a) for a in _scan_inputs(1, 3, 8, 8, seed=2)])
    assert _build._lib is None


# -- the Mamba block --------------------------------------------------------

@pytest.mark.parametrize("S_", [1, 2, 64])
@pytest.mark.parametrize("with_state", [False, True])
def test_mamba_forward_matches_jax(model, S_, with_state):
    """Stateless (the reference's XLA scan) and stateful (its step
    loop), with the conv state at S = 1, S < dconv - 1 and S = 64."""
    jp, jcfg, tp, cfg = model
    rng = np.random.default_rng(S_)
    B, D = 2, cfg.d_model
    x = rng.standard_normal((B, S_, D)).astype(np.float32)
    st = None
    if with_state:
        st = {"conv": rng.standard_normal(
                  (B, cfg.mamba_d_conv - 1, cfg.mamba_d_inner)
              ).astype(np.float32),
              "ssm": (rng.standard_normal(
                  (B, cfg.mamba_d_inner, cfg.mamba_d_state)) * 0.3
              ).astype(np.float32)}
    jy, jst = JM.mamba_forward(_layer(jp["blocks"][0]["mamba"]), jcfg,
                               jnp.asarray(x), state=st)
    ty, tst = M.mamba_forward(tree_map(lambda a: a[0],
                                       tp["blocks"][0]["mamba"]), cfg,
                              torch.from_numpy(x),
                              state=None if st is None else from_numpy(st,
                                                                       CPU))
    _close(ty, jy, MODEL_TOL)
    assert (tst is None) == (jst is None)
    if with_state:
        for key in ("conv", "ssm"):
            assert tst[key].shape == jst[key].shape
            assert tst[key].dtype == torch.float32
            _close(tst[key], jst[key], MODEL_TOL)


# -- MoE ------------------------------------------------------------------

def _moe_case(model, cf, T_=24, seed=3):
    jp, jcfg, tp, cfg = model
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, capacity_factor=cf))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf))
    x = np.random.default_rng(seed).standard_normal(
        (T_, cfg.d_model)).astype(np.float32)
    return (_layer(jp["blocks"][1]["moe"]), jcfg,
            tree_map(lambda a: a[0], tp["blocks"][1]["moe"]), cfg, x)


def _reference_keep(jmp, jcfg, x, dropless):
    """The reference's kept slots, by its own routing steps
    (``repro/models/moe.py: _moe_tokens``)."""
    T_, k, E = x.shape[0], jcfg.moe.top_k, jcfg.moe.n_experts
    probs = jax.nn.softmax(jnp.asarray(x) @ jmp["router"], axis=-1)
    _, idx = jax.lax.top_k(probs, k)
    cap = T_ if dropless else max(1, int(k * T_ * jcfg.moe.capacity_factor
                                         / E))
    e_flat = np.asarray(idx).reshape(T_ * k)
    onehot = np.eye(E, dtype=np.int64)[e_flat]
    pos = (np.cumsum(onehot, axis=0) - 1)[np.arange(T_ * k), e_flat]
    return (pos < cap).reshape(T_, k)


@pytest.mark.parametrize("cf", [0.0, 0.5])
def test_moe_tokens_match_jax(model, cf):
    """Dropless, and capacity-bounded with the bound binding: at cf =
    0.5 each of the 4 experts holds int(2 * 24 * 0.5 / 4) = 6 slots of
    the 48, so at least half are dropped.  The port keeps exactly the
    slots whose position in their expert is below the capacity, as the
    reference's routing steps compute them; its output and aux losses
    equal the reference's, and the capacity output differs from the
    dropless one exactly at the tokens that lost a slot.  The router's
    smallest top-2 margin on these inputs is ~4e-4, far from a tie.

    One difference is the reference's fault, not the port's: its
    dropped slots are redirected to (expert 0, position 0) and scattered
    there (``moe.py: e_c``/``pos_c``), which overwrites the token kept
    in that slot with "empty" and gate 0 whenever any slot is dropped.
    That token's output is the port's minus exactly that slot's
    contribution."""
    jmp, jcfg, tmp, cfg, x = _moe_case(model, cf)
    dropless = cf == 0.0
    jout, jaux = JMOE._moe_tokens(jmp, jcfg, jnp.asarray(x), dropless)
    tout, taux = MOE._moe_tokens(tmp, cfg, torch.from_numpy(x), dropless)
    for key in MOE.AUX_KEYS:
        _close(taux[key], jaux[key], MOE_TOL)
    gates, experts, keep, probs, _ = MOE._route(
        tmp, cfg, torch.from_numpy(x), dropless)
    top = probs.topk(cfg.moe.top_k + 1, dim=-1).values
    margin = float((top[:, -2] - top[:, -1]).min())
    assert margin > 1e-4
    want_keep = _reference_keep(jmp, jcfg, x, dropless)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    if dropless:
        assert keep.all()
        _close(tout, jout, MOE_TOL)
        return
    assert (~keep).sum() >= x.shape[0]
    # the slot the reference's dropped slots overwrite: expert 0's first
    t0, s0 = (int(i) for i in torch.nonzero(experts == 0)[0])
    xt = torch.from_numpy(x[t0])
    lost = (torch.nn.functional.silu(xt @ tmp["w_gate"][0])
            * (xt @ tmp["w_up"][0])) @ tmp["w_down"][0] * gates[t0, s0]
    rows = np.arange(x.shape[0]) != t0
    _close(tout[rows], np.asarray(jout)[rows], MOE_TOL)
    _close(tout[t0] - lost, np.asarray(jout)[t0], MOE_TOL)
    assert float(lost.abs().max()) > 1e-2
    free, _ = MOE._moe_tokens(tmp, cfg, torch.from_numpy(x), True)
    dropped = ~keep.all(dim=1)
    diff = (free - tout).abs().max(dim=1).values
    assert bool((diff[dropped] > 1e-3).all())
    assert bool((diff[~dropped] <= MOE_TOL).all())


def test_apply_moe_single_token_steps_are_dropless(model):
    """S == 1 (decode) dispatches dropless whatever the capacity factor,
    as the reference does."""
    jmp, jcfg, tmp, cfg, x = _moe_case(model, 0.5, T_=6)
    xb = x[:, None, :]                                     # (B, 1, D)
    jout, jaux = JMOE.apply_moe(jmp, jcfg, jnp.asarray(xb))
    tout, taux = MOE.apply_moe(tmp, cfg, torch.from_numpy(xb))
    _close(tout, jout, MOE_TOL)
    for key in MOE.AUX_KEYS:
        _close(taux[key], jaux[key], MOE_TOL)
    free, _ = MOE._moe_tokens(tmp, cfg, torch.from_numpy(x), True)
    _close(tout[:, 0], _np(free), 0.0)


# -- GQA decompose and prune ----------------------------------------------

def _qk_vo_products(attn):
    """Per-head Q K^T and V O products of stacked attention weights
    (KV head g serves query heads g*G .. g*G + G-1)."""
    wq, wk, wv, wo = (np.asarray(attn[k], np.float64)
                      for k in ("wq", "wk", "wv", "wo"))
    G = wq.shape[2] // wk.shape[2]
    qk = np.einsum("ldhq,lehq->lhde", wq, np.repeat(wk, G, axis=2))
    vo = np.einsum("ldhv,lhve->lhde", np.repeat(wv, G, axis=2), wo)
    return qk, vo


def test_gqa_decompose_and_prune_match(model):
    """G = 4 (4 query heads over 1 KV head): spectra, the Q K^T / V O
    products and logits after decompose and after prune equal the
    reference's; Mamba and MoE leaves pass through by reference (never
    copied: one full-width period is 53 GB)."""
    jp, jcfg, tp, cfg = model
    assert cfg.q_per_kv == 4
    A = cfg.pattern.index(("attn", "dense"))
    jd, jdcfg, jex = jax_decompose(jp, jcfg, peft=False)
    td, tdcfg, tex = clover_decompose(tp, cfg)
    assert dataclasses.asdict(tdcfg) == dataclasses.asdict(jdcfg)
    for j, (mixer, _) in enumerate(cfg.pattern):
        if mixer != "attn":
            assert tex[j] == {"spectra": {}}
            continue
        for name in ("qk", "vo"):
            _close(tex[j]["spectra"][name], jex[j]["spectra"][name], 1e-5)
    for j, entry in enumerate(td["blocks"]):
        for name in ("mamba", "moe", "mlp"):
            for key, leaf in entry.get(name, {}).items():
                assert leaf is tp["blocks"][j][name][key]
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 24))
    base, _ = T.forward(tp, cfg, toks, device=CPU)
    got, _ = T.forward(td, tdcfg, toks, device=CPU)
    _close(got, _np(base), MODEL_TOL)
    _close(got, JT.forward(jd, jdcfg, jnp.asarray(toks))[0], MODEL_TOL)
    for stage in ("decomposed", "pruned"):
        if stage == "pruned":
            jd, jdcfg = jax_prune(jd, jdcfg, qk_ratio=0.5, vo_ratio=0.5)
            td, tdcfg = clover_prune(td, tdcfg, qk_ratio=0.5, vo_ratio=0.5)
            assert (tdcfg.qk_dim, tdcfg.vo_dim) == (16, 16)
            assert dataclasses.asdict(tdcfg) == dataclasses.asdict(jdcfg)
            got, _ = T.forward(td, tdcfg, toks, device=CPU)
            _close(got, JT.forward(jd, jdcfg, jnp.asarray(toks))[0],
                   MODEL_TOL)
        tqk, tvo = _qk_vo_products(to_numpy(td["blocks"][A]["attn"]))
        jqk, jvo = _qk_vo_products(jax.tree.map(np.asarray,
                                                jd["blocks"][A]["attn"]))
        _close(tqk, jqk, 1e-5)
        _close(tvo, jvo, 1e-5)


# -- init tree, logits, decode states -------------------------------------

_FIXED = ("A_log", "D", "dt_bias", "conv_b", "scale")


def test_init_params_tree_matches_jax(model):
    jp, jcfg, _, cfg = model
    mine = _flat(to_numpy(T.init_lm_params(cfg, 0, device=CPU)))
    ref_tree = _flat(jax.tree.map(np.asarray, jp))
    assert sorted(mine) == sorted(ref_tree)
    for key, leaf in mine.items():
        assert leaf.shape == ref_tree[key].shape, key
        assert leaf.dtype == ref_tree[key].dtype, key
        if key.rsplit("/", 1)[-1] in _FIXED:
            # A_log = log(1..dS): torch's and XLA's log may differ by 1 ulp
            np.testing.assert_allclose(leaf, ref_tree[key], rtol=2e-7,
                                       atol=0, err_msg=key)
    assert sum(a.size for a in mine.values()) == cfg.n_params()


def test_init_dtypes_match_jax_in_bfloat16():
    """With bfloat16 parameters, ``A_log``, ``D`` and the router stay
    float32 in both inits; the JAX tree crosses the bridge with those
    dtypes and comes back bit for bit, and the leaves both inits fix
    (``A_log``, ``D``, ``dt_bias``, ``conv_b``, norm scales) hold the
    same values."""
    jcfg = dataclasses.replace(jax_config("jamba-v0.1-52b").reduced(),
                               param_dtype="bfloat16")
    cfg = dataclasses.replace(get_config("jamba-v0.1-52b").reduced(),
                              param_dtype="bfloat16")
    jtree = _flat(jax.tree.map(np.asarray,
                               jax_init(jcfg, jax.random.PRNGKey(0))))
    want = {k: (tuple(v.shape), str(v.dtype)) for k, v in jtree.items()}
    port = _flat(T.init_lm_params(cfg, 0, device=CPU))
    mine = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in port.items()}
    assert mine == want
    assert {want[k][1] for k in want
            if k.rsplit("/", 1)[-1] in ("A_log", "D", "router")} == \
        {"float32"}
    bridged = {k: from_numpy(v, CPU) for k, v in jtree.items()}
    for key, leaf in jtree.items():
        assert bridged[key].dtype == port[key].dtype, key
        back = to_numpy(bridged[key])
        assert back.dtype == leaf.dtype, key
        np.testing.assert_array_equal(
            back.view(f"u{leaf.itemsize}"), leaf.view(f"u{leaf.itemsize}"),
            err_msg=key)
        np.testing.assert_array_equal(bridged[key].float().numpy(),
                                      leaf.astype(np.float32), err_msg=key)
        if key.rsplit("/", 1)[-1] in _FIXED:
            # A_log = log(1..dS): torch's and XLA's log may differ by 1 ulp
            np.testing.assert_allclose(
                port[key].float().numpy(), leaf.astype(np.float32),
                rtol=2e-7, atol=0, err_msg=key)


def test_forward_logits_and_aux_match_jax(model):
    jp, jcfg, tp, cfg = model
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 40))
    got, aux = T.forward(tp, cfg, toks, device=CPU)
    want, jaux = JT.forward(jp, jcfg, jnp.asarray(toks))
    _close(got, want, MODEL_TOL)
    assert sorted(aux) == sorted(jaux)
    for key in aux:
        assert float(aux[key]) > 0
        _close(aux[key], jaux[key], MOE_TOL)


@pytest.mark.parametrize("paged", [False, True])
def test_decode_state_and_steps_match_jax(model, paged):
    """State trees (KV caches or pools for the attention layer, per-slot
    Mamba leaves), then a prefill chunk and decode steps: logits and
    every state leaf (the KV rows each step wrote) against the
    reference's."""
    jp, jcfg, tp, cfg = model
    B, C = 2, 8
    if paged:
        jst = JT.init_decode_state_paged(jcfg, B, 6, 4)
        tst = T.init_decode_state_paged(cfg, B, 6, 4, device=CPU)
        table = np.asarray([[0, 2, 4], [1, 3, 5]], np.int32)
        jpg, tpg = jnp.asarray(table), torch.from_numpy(table)
    else:
        jst = JT.init_decode_state(jcfg, B, 16)
        tst = T.init_decode_state(cfg, B, 16, device=CPU)
        jpg = tpg = None
    jflat = _flat(jax.tree.map(np.asarray, jst))
    tflat = _flat(to_numpy(tst))
    assert sorted(tflat) == sorted(jflat)
    for key in jflat:
        assert tflat[key].shape == jflat[key].shape, key
        assert tflat[key].dtype == jflat[key].dtype, key
    jst["index"] = jnp.zeros((B,), jnp.int32)
    tst["index"] = torch.zeros((B,), dtype=torch.int32)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, (B, C)).astype(np.int32)
    lens = np.asarray([C, C], np.int32)
    jl, jst = JT.prefill_chunk(jp, jcfg, jnp.asarray(toks), jst,
                               jnp.asarray(lens), pages=jpg)
    tl, tst = T.prefill_chunk(tp, cfg, torch.from_numpy(toks).long(), tst,
                              torch.from_numpy(lens), pages=tpg)
    _close(tl, jl, MODEL_TOL)
    for _ in range(3):
        tok = rng.integers(0, cfg.vocab_size, (B,)).astype(np.int32)
        jl, jst = JT.decode_step(jp, jcfg, jnp.asarray(tok), jst, pages=jpg)
        tl, tst = T.decode_step(tp, cfg, torch.from_numpy(tok).long(), tst,
                                pages=tpg)
        _close(tl, jl, MODEL_TOL)
    jflat = _flat(jax.tree.map(np.asarray, jst))
    for key, leaf in _flat(to_numpy(tst)).items():
        _close(leaf, jflat[key], MODEL_TOL)


# -- serving ----------------------------------------------------------------

def _prompts(lens, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, n).astype(np.int32) for n in lens]


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_engine_lockstep_with_jax_engine(model, layout):
    """Prompts of several chunks plus a TAIL, TAIL-only prompts, and
    more requests than slots (slot reuse); paged with a pool small
    enough to preempt.  Phases, positions and (paged) page tables equal
    every step; streams token-identical to the JAX engine's and to
    greedy_reference; 2 step shapes."""
    jp, jcfg, tp, cfg = model
    kw = dict(slots=2, max_len=32, prefill_chunk=4)
    if layout == "paged":
        kw.update(paged=True, page_tokens=4, n_pages=7)
    jeng = JS.Engine(jp, jcfg, JS.EngineConfig(kernel_impl="xla", **kw))
    teng = S.Engine(tp, cfg, S.EngineConfig(**kw), device=CPU)
    prompts = _prompts((11, 3, 17, 5, 9, 2))
    new = 5
    jreqs = [JS.Request(uid=i, prompt=p, max_new_tokens=new)
             for i, p in enumerate(prompts)]
    treqs = [S.Request(uid=i, prompt=p, max_new_tokens=new)
             for i, p in enumerate(prompts)]
    for jr, tr in zip(jreqs, treqs):
        jeng.submit(jr)
        teng.submit(tr)
    phases = set()
    steps = 0
    while jeng.sched.busy or teng.sched.busy:
        jeng.step()
        teng.step()
        steps += 1
        assert steps < 300
        assert teng.sched.phase == jeng.sched.phase, steps
        np.testing.assert_array_equal(teng.sched.pos, jeng.sched.pos)
        assert [r.generated for r in treqs] == [r.generated for r in jreqs]
        phases.update(p for p in teng.sched.phase if p is not None)
        if layout == "paged":
            assert teng.alloc.tables == jeng.alloc.tables, steps
            teng.alloc.assert_consistent(context=f"step {steps}")
    assert phases == {"prefill", "tail", "decode"}
    assert teng.steps == jeng.steps
    assert teng.compiled_shapes() == jeng.compiled_shapes() == 2
    if layout == "paged":
        assert teng.sched.preemptions == jeng.sched.preemptions > 0
    for r, p in zip(treqs, prompts):
        assert r.done
        assert r.generated == S.greedy_reference(tp, cfg, p, new,
                                                 device=CPU)


def test_engine_refuses_prefix_cache(model):
    jp, jcfg, tp, cfg = model
    kw = dict(slots=2, max_len=32, paged=True, prefix_cache=True)
    with pytest.raises(ValueError, match="attention-only"):
        JS.Engine(jp, jcfg, JS.EngineConfig(**kw))
    with pytest.raises(ValueError, match="attention-only"):
        S.Engine(tp, cfg, S.EngineConfig(**kw), device=CPU)
