"""The numerical and structural premises of the port's two scan kernels,
checked on the CPU before any card runs them.

* ``wkv6`` (``csrc/wkv6.cu``): a plain float32 emulation of the kernel's
  arithmetic order -- ``w = exp(logw)``, ``r * w`` and the bonus scalar
  ``beta_t = r_t . (u * k_t)`` staged once per step (beta summed over the
  staged float4s by the kernel's shuffle tree), each state column's rows
  split over 8 lanes that accumulate ``(r_i w_i) S_ie`` against the old
  state while updating ``S_ie = fma(k_i, v_e, w_i S_ie)``, and the lanes'
  partial sums joined in the kernel's reduce-scatter order for the 1 and
  4 columns per thread it is built for.
* ``mamba_scan`` (``csrc/mamba_scan.cu``): the decay as ``2^(dt * (-A
  log2 e))`` with the factor prescaled in float32 (the exponential itself
  correctly rounded here; the card's MUFU.EX2 is held by chip_smoke.py),
  ``h = fma(decay, h, (dt x) B)``, each lane's states summed into y in
  order and the lanes joined by the kernel's butterfly.

Both are held to the port's plain versions (``repro_torch.kernels.ref``)
and to the JAX oracles (``repro.kernels.ref``) within the kernels' parity
tolerance, 2e-5 x max(1, max |want|), at the decay clip edges, T = S = 1
and across a chained handoff.  The thread-to-state maps the emulations
walk (the kernels' index arithmetic) are held to covering every state
entry exactly once under each tile the wrappers' planners can pick.
"""
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the xdist workers already fill the CPUs, and a
# torch thread pool per worker oversubscribes them many times over
torch.set_num_threads(1)

from repro.kernels import ref as jax_ref  # noqa: E402
from repro_torch.kernels import mamba_scan as M  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import wkv6 as W  # noqa: E402

TOL = 2e-5              # WKV_TOL / MAMBA_TOL of chip_smoke.py
LANES = 8               # wkv6: lanes per state column
SMS = 132               # H100 SXM
F32 = np.float32


def _fma(a, b, c):
    """float32 fma: the exact product and sum, rounded once (through
    float64, whose 53 bits hold a float32 product exactly)."""
    return (np.float64(1) * a * b + c).astype(F32)


def _butterfly(v, offs, lane=0):
    """The value ``lane`` ends with after xor-shuffle levels ``offs`` over
    axis 0, each adding the partner's value to its own (own first)."""
    for off in offs:
        v = (v + v[np.arange(v.shape[0]) ^ off]).astype(F32)
    return v[lane]


# -- wkv6 -----------------------------------------------------------------

def wkv6_thread_entries(d, config, block, tid):
    """The (row, column) state entries that thread ``tid`` of column block
    ``block`` keeps in registers, in its walk order, as csrc/wkv6.cu
    assigns them: lane ``tid % lanes`` holds rows 4 (lane + lanes g) + m
    (quarter m outer, float4 group g inner) of the thread's ``cc``
    consecutive columns."""
    lanes, cc, cols, _ = W.plan(d, config=config)
    lane, e0 = tid % lanes, block * cols + (tid // lanes) * cc
    return [(4 * (lane + lanes * g) + m, e0 + c)
            for m in range(4) for g in range(d // lanes // 4)
            for c in range(cc)]


def wkv6_threads(d, config):
    """Threads per block: ``cols / cc`` column groups of ``lanes``."""
    lanes, cc, cols, _ = W.plan(d, config=config)
    return cols // cc * lanes


def _writer_lane(cc, col):
    """The lane that writes column ``col`` of a thread's ``cc`` (1 or 4)
    columns: reduce-scatter levels at offsets 4 and 2 pick the kept
    halves."""
    return 4 * (col >> 1) + 2 * (col & 1) if cc == 4 else 0


def wkv6_design(r, k, v, logw, u, s0, cc):
    """The kernel's arithmetic on numpy float32 arrays (B, H, T, d);
    ``cc`` columns per thread.  -> (out, S_end)."""
    B, H, T, d = r.shape
    q4 = d // 4
    S = (np.zeros((B, H, d, d), F32) if s0 is None else s0.astype(F32)
         ).copy()
    out = np.zeros((B, H, T, d), F32)
    # lane l's rows in its walk order (the rows of its first column; every
    # column of every thread has the same row split)
    config = next(c for c in W.CONFIGS[d] if c[1] == cc)
    rows = [[i for i, e in wkv6_thread_entries(d, config, 0, lane)
             if e == 0] for lane in range(LANES)]
    writer = np.array([_writer_lane(cc, e % cc) for e in range(d)])
    uk_off = [q4 // 2 >> i for i in range(int(np.log2(q4)))]
    for t in range(T):
        rt, kt, vt = r[:, :, t], k[:, :, t], v[:, :, t]
        w = np.exp(logw[:, :, t].astype(F32)).astype(F32)
        rw = (rt * w).astype(F32)
        # beta: each float4 q summed as the kernel's fma chain, then the
        # butterfly over the q's of the row (lane q = 0 writes it)
        uk = (u[None] * kt).astype(F32)
        p = (rt[..., 0::4] * uk[..., 0::4]).astype(F32)
        for m in (1, 2, 3):
            p = _fma(rt[..., m::4], uk[..., m::4], p)
        beta = _butterfly(np.moveaxis(p, -1, 0), uk_off)     # (B, H)
        # each lane's partial sums over its rows, against the old state
        part = np.zeros((LANES, B, H, d), F32)
        for lane in range(LANES):
            for i in rows[lane]:
                part[lane] = _fma(rw[..., i:i + 1], S[:, :, i], part[lane])
                S[:, :, i] = _fma(kt[..., i:i + 1], vt,
                                  (w[..., i:i + 1] * S[:, :, i]).astype(F32))
        o = np.empty((B, H, d), F32)
        for e in range(d):
            o[..., e] = _butterfly(part[..., e], (4, 2, 1), writer[e])
        out[:, :, t] = _fma(beta[..., None], vt, o)
    return out, S


def _wkv_inputs(B, H, T, d, seed, edge=None, s0=True):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, H, T, d)).astype(F32)
               for _ in range(3))
    if edge is None:
        logw = np.clip(-np.exp(rng.standard_normal((B, H, T, d))), -10.0,
                       -1e-4).astype(F32)
    else:
        logw = np.full((B, H, T, d), edge, F32)
    u = (rng.standard_normal((H, d)) * 0.5).astype(F32)
    state = rng.standard_normal((B, H, d, d)).astype(F32) if s0 else None
    return r, k, v, logw, u, state


def _close(got, want):
    want = np.asarray(want)
    tol = TOL * max(1.0, float(np.abs(want).max()) if want.size else 0.0)
    np.testing.assert_allclose(np.asarray(got), want, atol=tol, rtol=0)


@pytest.mark.parametrize("cc", sorted({c[1] for c in W.CONFIGS[64]}))
@pytest.mark.parametrize("d,T,edge,s0", [
    (64, 1, None, True),            # the decode / TAIL step
    (64, 40, None, True),           # past one 32-step stage round
    (32, 33, None, False),
    (32, 48, -10.0, True),          # decay ~ 0: forgets at once
    (64, 48, -1e-4, True),          # decay ~ 1: the state grows over T
])
def test_wkv6_design_matches_plain_and_jax(cc, d, T, edge, s0):
    args = _wkv_inputs(2, 2, T, d, seed=T + d + cc, edge=edge, s0=s0)
    got_o, got_s = wkv6_design(*args, cc=cc)
    want_o, want_s = ref.wkv6_ref(
        *(None if a is None else torch.from_numpy(a) for a in args))
    _close(got_o, want_o.numpy())
    _close(got_s, want_s.numpy())
    jax_o, jax_s = jax_ref.wkv6_ref(*args)
    _close(got_o, jax_o)
    _close(got_s, jax_s)


def test_wkv6_design_chained_handoff_is_bitwise():
    """T1 steps, then T2 from S_end: the same arithmetic per step, so the
    same bits as one call over T1 + T2."""
    r, k, v, logw, u, s0 = _wkv_inputs(1, 2, 21, 32, seed=9)
    whole = wkv6_design(r, k, v, logw, u, s0, cc=4)
    o1, s1 = wkv6_design(r[:, :, :13], k[:, :, :13], v[:, :, :13],
                         logw[:, :, :13], u, s0, cc=4)
    o2, s2 = wkv6_design(r[:, :, 13:], k[:, :, 13:], v[:, :, 13:],
                         logw[:, :, 13:], u, s1, cc=4)
    assert np.array_equal(np.concatenate([o1, o2], axis=2), whole[0])
    assert np.array_equal(s2, whole[1])


@pytest.mark.parametrize("d", W.WIDTHS)
def test_wkv6_plan_covers_every_state_entry_once(d):
    for config in W.CONFIGS[d]:
        lanes, cc, cols, blocks = W.plan(d, config=config)
        assert lanes == LANES and d % cols == 0 and blocks == d // cols
        n = wkv6_threads(d, config)
        assert n % 32 == 0
        seen = Counter(e for b in range(blocks) for t in range(n)
                       for e in wkv6_thread_entries(d, config, b, t))
        assert len(seen) == d * d and set(seen.values()) == {1}, config


def test_wkv6_plan_takes_the_large_tile_while_it_covers_the_sms():
    # B = 4, H = 32 (the engine): one 64-column block per head; B = 2 and
    # B = 1 (greedy_reference): 4 blocks of 16 columns per head
    assert W.plan(64, 4 * 32, SMS)[:3] == (8, 4, 64)
    assert W.plan(64, 2 * 32, SMS)[:3] == (8, 1, 16)
    assert W.plan(64, 1 * 32, SMS)[:3] == (8, 1, 16)
    assert W.plan(32, 1000, SMS)[:3] == (8, 4, 32)
    assert W.plan(64, 4 * 32, SMS, config=(8, 1, 16))[:3] == (8, 1, 16)
    with pytest.raises(ValueError, match="not built"):
        W.plan(64, config=(4, 1, 16))
    with pytest.raises(ValueError, match="head widths"):
        W.plan(48)


# -- mamba_scan -----------------------------------------------------------

def mamba_thread_states(dI, dS, config, block, tid):
    """The (channel, state) pairs that thread ``tid`` of channel block
    ``block`` keeps in registers, as csrc/mamba_scan.cu assigns them:
    lane ``tid % lanes`` of channel ``tid // lanes`` holds states ``lane
    dS / lanes`` onwards (none past dI, in a ragged last block)."""
    lanes, channels, _ = M.plan(dI, config=config)
    per = dS // lanes
    i = block * channels + tid // lanes
    return [] if i >= dI else [(i, (tid % lanes) * per + k)
                               for k in range(per)]


def mamba_threads(config):
    """Threads per block."""
    lanes, channels, _ = M.plan(1, config=config)
    return channels * lanes


def mamba_design(dt, A, Bm, C, x, h0, lanes):
    """The kernel's arithmetic on numpy float32 arrays: dt, x (B, S, dI),
    A (dI, dS), Bm, C (B, S, dS), h0 (B, dI, dS) or None.
    -> (y, h_end)."""
    Bn, S, dI = x.shape
    dS = A.shape[1]
    neg_a2 = (-A * F32(np.log2(np.e))).astype(F32)             # (dI, dS)
    h = (np.zeros((Bn, dI, dS), F32) if h0 is None else h0.astype(F32)
         ).copy()
    y = np.zeros((Bn, S, dI), F32)
    offs = [lanes // 2 >> i for i in range(int(np.log2(lanes)))]
    # each lane's states, as the kernel's map gives them for channel 0
    config = next(c for c in M.CONFIGS if c[0] == lanes)
    states = [[s for _, s in mamba_thread_states(dI, dS, config, 0, lane)]
              for lane in range(lanes)]
    for t in range(S):
        d = dt[:, t, :, None]                                 # (B, dI, 1)
        arg = (d * neg_a2[None]).astype(F32)
        decay = np.exp2(arg.astype(np.float64)).astype(F32)
        dx = (dt[:, t] * x[:, t]).astype(F32)[..., None]
        bx = (dx * Bm[:, t, None, :]).astype(F32)
        h = _fma(decay, h, bx)
        part = np.zeros((lanes, Bn, dI), F32)
        for lane in range(lanes):
            for s in states[lane]:
                part[lane] = _fma(h[..., s], C[:, t, None, s], part[lane])
        y[:, t] = _butterfly(part, offs)
    return y, h


def _mamba_inputs(B, S, dI, seed, dt=None, h0=True, dS=16):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, dI)).astype(F32)
    Bm, C = (rng.standard_normal((B, S, dS)).astype(F32) for _ in range(2))
    u = rng.random((B, S, dI))
    if dt == "small":
        dtv = 1e-5 + 9e-5 * u
    elif dt == "large":
        dtv = 20.0 + 10.0 * u
    else:
        dtv = np.log1p(np.exp(rng.standard_normal((B, S, dI)) - 2.0))
    scale = 2.0 ** (2.0 * rng.random((dI, 1)) - 1.0)
    A = (np.arange(1, dS + 1)[None, :] * scale).astype(F32)
    state = rng.standard_normal((B, dI, dS)).astype(F32) if h0 else None
    return dtv.astype(F32), A, Bm, C, x, state


@pytest.mark.parametrize("lanes", sorted({c[0] for c in M.CONFIGS}))
@pytest.mark.parametrize("S,dt,h0", [
    (1, None, True),                # the decode / TAIL step
    (40, None, True),               # past one 16-step stage round
    (37, None, False),
    (60, "small", True),            # dt ~ 1e-5: decay ~ 1
    (20, "large", True),            # dt ~ 25: decay ~ 0 (or below 2^-126)
])
def test_mamba_design_matches_plain_and_jax(lanes, S, dt, h0):
    args = _mamba_inputs(2, S, 24, seed=S + lanes, dt=dt, h0=h0)
    got_y, got_h = mamba_design(*args, lanes=lanes)
    want_y, want_h = ref.mamba_scan_ref(
        *(None if a is None else torch.from_numpy(a) for a in args))
    _close(got_y, want_y.numpy())
    _close(got_h, want_h.numpy())
    jax_y, jax_h = jax_ref.mamba_scan_ref(*args)
    _close(got_y, jax_y)
    _close(got_h, jax_h)


def test_mamba_prescaled_exp2_stays_close_to_exp():
    """2^(float32(dt * float32(-A log2 e))) against exp(-dt A) in float64,
    over dt and A from the clip edges to the model's range: the two
    roundings of the argument stay within ~|dt A| 2^-23 relative."""
    rng = np.random.default_rng(3)
    dt = np.concatenate([1e-5 + 9e-5 * rng.random(2000),
                         np.log1p(np.exp(rng.standard_normal(2000) - 2.0)),
                         20.0 + 10.0 * rng.random(2000)]).astype(F32)
    A = (rng.random(dt.size) * 32.0 + 0.5).astype(F32)
    neg_a2 = (-A * F32(np.log2(np.e))).astype(F32)
    got = np.exp2((dt * neg_a2).astype(F32).astype(np.float64))
    want = np.exp(-(dt.astype(np.float64) * A))
    arg = dt.astype(np.float64) * A
    ok = want > 1e-30
    rel = np.abs(got[ok] - want[ok]) / want[ok]
    assert np.all(rel <= (np.abs(arg[ok]) + 1.0) * 2.0 ** -22)


def test_mamba_design_chained_handoff_is_bitwise():
    dt, A, Bm, C, x, h0 = _mamba_inputs(1, 21, 16, seed=11)
    whole = mamba_design(dt, A, Bm, C, x, h0, lanes=2)
    y1, h1 = mamba_design(dt[:, :13], A, Bm[:, :13], C[:, :13], x[:, :13],
                          h0, lanes=2)
    y2, h2 = mamba_design(dt[:, 13:], A, Bm[:, 13:], C[:, 13:], x[:, 13:],
                          h1, lanes=2)
    assert np.array_equal(np.concatenate([y1, y2], axis=1), whole[0])
    assert np.array_equal(h2, whole[1])


@pytest.mark.parametrize("dI", [33, 96, 1000, 8190])
def test_mamba_plan_covers_every_channel_state_once(dI):
    for config in M.CONFIGS:
        lanes, channels, blocks = M.plan(dI, config=config)
        assert blocks * channels >= dI > (blocks - 1) * channels
        n = mamba_threads(config)
        assert n % 32 == 0
        seen = Counter(e for b in range(blocks) for t in range(n)
                       for e in mamba_thread_states(dI, 16, config, b, t))
        assert len(seen) == dI * 16 and set(seen.values()) == {1}, config


def test_mamba_plan_picks_by_warps_per_sm_and_refuses():
    # B = 4 (the engine): 2 lanes in 64-channel blocks; B = 1
    # (greedy_reference): 4 lanes
    assert M.plan(8192, 4, SMS)[:2] == (2, 64)
    assert M.plan(8192, 1, SMS)[:2] == (4, 32)
    assert M.plan(96, 1, SMS)[:2] == M.CONFIGS[-1]
    assert M.plan(8192, 4, SMS, config=(4, 32))[:2] == (4, 32)
    with pytest.raises(ValueError, match="not built"):
        M.plan(8192, config=(8, 32))
