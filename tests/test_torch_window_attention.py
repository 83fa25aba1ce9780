"""The window form of the flash kernel: the port's plain version
(``repro_torch.kernels.ref.window_attention_ref``, what the CUDA window
kernel is held to on the card) against the JAX package's XLA attention
over a cache window, in bfloat16 and float16.

Over a cache window the reference runs XLA attention at the compute
dtype, not its Pallas kernel: beyond ``ATTN_CHUNK`` queries
``repro.models.layers._causal_attention_chunked`` (the logits leave the
einsum in the compute dtype, are cast to float32 and scaled; the
normalised p is rounded to V's dtype before P.V), within them the masked
path of ``repro.models.layers.attention`` (the same, but the scale
multiplies the 16-bit logits before the cast), transcribed here as
``_jax_masked``.  ``scale_first`` picks between the two.

Tolerance: at least 99% of the outputs bit for bit, and every output
within one ulp of the dtype at its (b, s, h) row's largest |output|.
In float16 over the longest window (520 queries over 1120 keys) the JAX
function's own float32 dot decides the rest: XLA's CPU dot sums in an
order of its own (it differs by shape), and its logits rounded to
float16 differ from any other order's on ~1e-3 of the pairs, which over
a thousand keys reaches most rows (0.9853 bit for bit; an exactly
rounded dot gives 0.9885, not 0.99).  There the plain version is held
to the same rule on the reference's own rounded logits
(``test_float16_rests_on_the_reference_logits``), and end to end to
DOT_ORDER_SHARE bit for bit and the same one ulp.

Also here: the ``ops`` routing and call counts, the wrapper's refusals,
a strided cache window against a contiguous copy and the meta route's
FLOPs.  The shares of the routes the port took before at the two long
windows are ``tests/test_torch_attention_16bit.py``'s.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the xdist workers already fill the CPUs
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as JL  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels.clover_attention import \
    window_attention  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

SHARE = 0.99
DTYPES = {"bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float16": (torch.float16, jnp.float16)}
# (B, S, T, H, KV, dq, dv, gain)
CASES = {
    "S=T=600": (1, 600, 600, 4, 2, 32, 32, 1.0),
    "S520 T1120": (1, 520, 1120, 4, 4, 64, 64, 1.0),
    "G3 7/5": (2, 50, 50, 6, 2, 7, 5, 1.0),
    "S24 T224": (1, 24, 224, 4, 2, 32, 32, 1.0),
    "T300 not a 128 multiple": (2, 100, 300, 4, 2, 32, 32, 1.0),
    "inputs x8": (1, 200, 200, 4, 4, 32, 32, 8.0),
}
# float16 over the longest window: the reference's float32 dot order decides
# the share (0.9853 measured; see the module doc)
DOT_ORDER_BOUND = {("S520 T1120", "float16")}
DOT_ORDER_SHARE = 0.98
ORDERS = {"chunked": False, "masked": True}


def _inputs(seed, B, S, T, H, KV, dq, dv, gain, dtype):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(
        gain * rng.standard_normal(shape).astype(np.float32)).to(dtype)
        for shape in ((B, S, H, dq), (B, T, KV, dq), (B, T, KV, dv)))


def _jnp(x, jdtype):
    return jnp.asarray(x.float().numpy()).astype(jdtype)


def _jax_masked(q, k, v, scale):
    """The reference's masked attention (``repro/models/layers.py``, the
    cached path within ATTN_CHUNK queries) over a window of T keys, the
    S queries ending it."""
    B, S, H, dq = q.shape
    T, KV = k.shape[1], k.shape[2]
    qg = q.reshape(B, S, KV, H // KV, dq)
    logits = jnp.einsum("bskgq,btkq->bkgst", qg, k) * scale
    logits = logits.astype(jnp.float32)
    qpos = (T - S) + jnp.arange(S, dtype=jnp.int32)
    mask = jnp.arange(T, dtype=jnp.int32)[None, :] <= qpos[:, None]
    logits = jnp.where(mask[None, None, None], logits,
                       jnp.finfo(jnp.float32).min)
    probs = jax.nn.softmax(logits, axis=-1).astype(q.dtype)
    return jnp.einsum("bkgst,btkv->bskgv", probs, v).reshape(
        B, S, H, v.shape[-1])


def _jax_window(q, k, v, scale, scale_first, jdtype):
    jq, jk, jv = (_jnp(x, jdtype) for x in (q, k, v))
    if scale_first:
        return _jax_masked(jq, jk, jv, scale)
    return JL._causal_attention_chunked(jq, jk, jv, scale,
                                        q_offset=k.shape[1] - q.shape[1])


def _agreement(got, want, dtype):
    """(share of outputs bit for bit, worst error in ulps of ``dtype`` at
    each row's largest |want|)."""
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want).astype(jnp.float32))
    fi = torch.finfo(dtype)
    top = np.maximum(np.abs(w).max(axis=-1, keepdims=True), fi.tiny)
    ulp = np.exp2(np.floor(np.log2(top))) * fi.eps
    return float(np.mean(g == w)), float(np.max(np.abs(g - w) / ulp))


@pytest.mark.parametrize("order", sorted(ORDERS))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_version_matches_jax(case, dtype, order):
    td, jd = DTYPES[dtype]
    B, S, T, H, KV, dq, dv, gain = CASES[case]
    q, k, v = _inputs(3, *CASES[case], td)
    scale = 1.0 / math.sqrt(dq)
    calls = ref.window_attention_ref.calls
    got = ops.window_attention(q, k, v, scale=scale,
                               scale_first=ORDERS[order])
    assert ref.window_attention_ref.calls == calls + 1
    want = _jax_window(q, k, v, scale, ORDERS[order], jd)
    assert got.dtype == td and tuple(got.shape) == tuple(want.shape)
    share, worst = _agreement(got, want, td)
    print(f"window {case} {dtype} {order}: {share:.4f} bit for bit, "
          f"worst {worst:.2f} ulp at the row's max")
    least = DOT_ORDER_SHARE if (case, dtype) in DOT_ORDER_BOUND else SHARE
    assert share >= least and worst <= 1.0, (share, worst)


def _reference_logits(q, k, scale_first, jdtype):
    """The reference's own logits x = dot(q, k), rounded to ``jdtype``,
    as (B, KV, G, S, T) float32: its einsum on the chunked path's query
    blocks (``_pick_block(S, ATTN_CHUNK)``) or on the whole window (the
    masked path)."""
    B, S, H, dq = q.shape
    KV = k.shape[2]
    jq = _jnp(q, jdtype).reshape(B, S, KV, H // KV, dq)
    jk = _jnp(k, jdtype)
    bq = S if scale_first else JL._pick_block(S, JL.ATTN_CHUNK)
    parts = [jnp.einsum("bskgq,btkq->bkgst", jq[:, i:i + bq], jk)
             for i in range(0, S, bq)]
    x = jnp.concatenate(parts, axis=3).astype(jnp.float32)
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("order", sorted(ORDERS))
@pytest.mark.parametrize("case", sorted(c for c, _ in DOT_ORDER_BOUND))
def test_float16_rests_on_the_reference_logits(case, order, monkeypatch):
    """float16 over the longest window: the rounded logits agree with the
    reference's on >= 99.9% of the pairs, and with the reference's own
    logits put in place of the tensor-core dot the plain version's
    softmax, rounding and P.V hold the module's rule."""
    td, jd = DTYPES["float16"]
    B, S, T, H, KV, dq, dv, gain = CASES[case]
    q, k, v = _inputs(3, *CASES[case], td)
    scale, first = 1.0 / math.sqrt(dq), ORDERS[order]
    xj = _reference_logits(q, k, first, jd)
    qg = q.reshape(B, S, KV, H // KV, dq).permute(0, 2, 3, 1, 4).float()
    kt = k.permute(0, 2, 3, 1).float()[:, :, None]
    mine = ref._mma_chain(qg, kt).to(td).float()
    assert float((mine == xj).float().mean()) >= 0.999
    chain, rows = ref._mma_chain, iter(range(0, S, ref.FLASH_ROWS))

    def logits_of_the_reference(a, b):
        if a.shape[-1] != dq:              # P.V: the kernel's chains
            return chain(a, b)
        r0 = next(rows)
        return xj[..., r0:r0 + a.shape[-2], :b.shape[-1]]
    monkeypatch.setattr(ref, "_mma_chain", logits_of_the_reference)
    got = ref.window_attention_ref(q, k, v, scale=scale, scale_first=first)
    share, worst = _agreement(got, _jax_window(q, k, v, scale, first, jd),
                              td)
    print(f"window {case} float16 {order} on the reference's logits: "
          f"{share:.4f} bit for bit, worst {worst:.2f} ulp")
    assert share >= SHARE and worst <= 1.0, (share, worst)


def test_layers_route_windows_by_dtype():
    """``_causal_window(window=True)``: a 16-bit dtype takes the window
    form on its own q / K / V (the scale order by S, as the reference's
    two paths split), float32 the flash kernel's float32 form, a softcap
    its plain chunked / masked route; the scoring pass the 16-bit flash
    form."""
    q, k, v = _inputs(4, 1, 40, 60, 4, 2, 16, 8, 1.0, torch.bfloat16)
    names = ("window_attention_ref", "attention_ref", "flash_attention_ref")

    def grew(fn):
        before = ops.launch_counts()
        out = fn()
        after = ops.launch_counts()
        return out, tuple(after[n] - before[n] for n in names)
    out, d = grew(lambda: L._causal_window(q, k, v, 0.25, 0.0, 2,
                                           torch.bfloat16, window=True))
    assert d == (1, 0, 0)
    assert torch.equal(out, ref.window_attention_ref(
        q, k, v, scale=0.25, scale_first=True))
    long_q = _inputs(5, 1, 520, 530, 2, 2, 8, 8, 1.0, torch.bfloat16)
    out, d = grew(lambda: L._causal_window(*long_q, 0.25, 0.0, 1,
                                           torch.bfloat16, window=True))
    assert d == (1, 0, 0)
    assert torch.equal(out, ref.window_attention_ref(
        *long_q, scale=0.25, scale_first=False))
    f32 = [x.float() for x in (q, k, v)]
    _, d = grew(lambda: L._causal_window(*f32, 0.25, 0.0, 2, torch.float32,
                                         window=True))
    assert d == (0, 1, 0)
    _, d = grew(lambda: L._causal_window(q, k, v, 0.25, 30.0, 2,
                                         torch.bfloat16, window=True))
    assert d == (0, 0, 0)
    _, d = grew(lambda: L._causal_window(q, k, v, 0.25, 0.0, 2,
                                         torch.bfloat16))
    assert d == (0, 0, 1)


def test_strided_window_equals_a_contiguous_copy():
    """A window ``cache[:, :end, :, :d]`` of a wider cache reaches the
    plain version as it lies and gives the bits of a contiguous copy."""
    g = torch.Generator().manual_seed(7)
    ck = torch.randn(2, 90, 2, 12, generator=g).half()
    cv = torch.randn(2, 90, 2, 10, generator=g).half()
    q = torch.randn(2, 30, 4, 8, generator=g).half()
    kw, vw = ck[:, :70, :, :8], cv[:, :70, :, :6]
    assert not kw.is_contiguous()
    for first in (False, True):
        assert torch.equal(
            ops.window_attention(q, kw, vw, scale=0.3, scale_first=first),
            ops.window_attention(q, kw.contiguous(), vw.contiguous(),
                                 scale=0.3, scale_first=first))


def test_scale_orders_differ_where_the_scale_rounds():
    """The masked path multiplies the 16-bit logits by the scale rounded
    to the dtype (JAX's weak-typed Python float) and rounds again: at a
    scale bfloat16 cannot hold the two orders give other bits, each the
    reference's own path's."""
    td, jd = DTYPES["bfloat16"]
    q, k, v = _inputs(8, 1, 64, 64, 2, 2, 20, 12, 2.0, td)
    scale = 1.0 / math.sqrt(20)
    a = ref.window_attention_ref(q, k, v, scale=scale, scale_first=False)
    b = ref.window_attention_ref(q, k, v, scale=scale, scale_first=True)
    assert not torch.equal(a, b)
    for got, first in ((a, False), (b, True)):
        share, worst = _agreement(got, _jax_window(q, k, v, scale, first,
                                                   jd), td)
        assert share >= SHARE and worst <= 1.0, (first, share, worst)


def test_wrapper_refuses_other_dtypes_and_cpu_tensors():
    """q, K and V all in bfloat16 or all in float16: float32, 8-bit and
    mixed dtypes raise TypeError, CPU tensors ValueError, before anything
    is built."""
    x = torch.zeros(1, 4, 2, 8)
    for q, k, v in (
            (x, x, x),
            (x.bfloat16(), x, x),
            (x.bfloat16(), x.bfloat16(), x.half()),
            (x.half(), x.bfloat16(), x.half()),
            (x.to(torch.float8_e4m3fn),) * 3,
            (x.bfloat16(), x.to(torch.float8_e4m3fn),
             x.to(torch.float8_e4m3fn)),
            (x.double(),) * 3):
        with pytest.raises(TypeError, match="window kernel takes"):
            window_attention(q, k, v, scale=0.5, scale_first=False)
        with pytest.raises(TypeError):
            ops.window_attention(q, k, v, scale=0.5, scale_first=False)
    for dt in (torch.bfloat16, torch.float16):
        with pytest.raises(ValueError, match="CUDA"):
            window_attention(x.to(dt), x.to(dt), x.to(dt), scale=0.5,
                             scale_first=True)
    assert _build._lib is None


def test_meta_route_reports_two_sweeps_and_pv():
    """On meta tensors (the dry-run) the form reports its work under its
    own name: 2 (2 dq + dv) FLOPs a causal pair (two Q.K sweeps and
    P.V), each input byte read once and the output written once."""
    B, S, T, H, KV, dq, dv = 2, 30, 50, 6, 2, 16, 8
    q = torch.empty(B, S, H, dq, dtype=torch.bfloat16, device="meta")
    k = torch.empty(B, T, KV, dq, dtype=torch.bfloat16, device="meta")
    v = torch.empty(B, T, KV, dv, dtype=torch.bfloat16, device="meta")
    seen = []
    with ops.kernel_costs(lambda *a: seen.append(a)):
        out = ops.window_attention(q, k, v, scale=0.1, scale_first=False)
    pairs = B * H * (S * (T - S) + S * (S + 1) // 2)
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + B * S * H * dv)
    assert seen == [("window_attention", float(pairs * 2 * (2 * dq + dv)),
                     nbytes)]
    assert out.shape == (B, S, H, dv) and out.dtype == torch.bfloat16
