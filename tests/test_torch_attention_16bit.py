"""``flash_attention`` in the TPU kernel's 16-bit form: the port's plain
version (``repro_torch.kernels.ref.flash_attention_ref``, what the CUDA
kernel's 16-bit form is held to on the card) against the JAX package's
Pallas ``flash_attention`` in interpret mode, in bfloat16 and float16.

The reference's kernel takes q, K and V in the compute dtype, takes each
logit as ``dot * scale`` in float32, walks the keys in blocks of 128
(one block of T when T <= 128) with one running max per block, rounds p
to V's dtype before P.V (``l`` sums the unrounded p) and rounds the
output once.  The port reaches the plain version through
``kernels.ops.clover_attention`` on CPU tensors, as the layers call it.

Tolerance: at least 99% of the outputs bit for bit, and every output
within one ulp of the dtype at its (b, s, h) row's largest |output| (a
p rounded the other way moves a near-zero output by many of its own
ulps, never by more than the row's).  S < T cases are those where the
reference's padding (``ops._clover_body``) leaves ``T - S`` unchanged:
S <= 128 with T <= 128 or T a multiple of 128.

Also here: the wrapper's refusals, the routes' distances at the cache
windows (where the reference runs XLA's chunked attention instead, and
the port the window form, ``tests/test_torch_window_attention.py``), and
a bfloat16 model scored through both packages' ``forward``.
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

from repro.configs import get_config as jax_config  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import init_lm_params as jax_init  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.bridge import from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels.clover_attention import flash_attention  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

SCALE = 0.125
SHARE = 0.99
BF16_RTOL = 2e-2        # tests/test_torch_serve_step.py's bfloat16 bound
DTYPES = {"bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float16": (torch.float16, jnp.float16)}
# (B, S, T, H, KV, dq, dv, gain)
CASES = {
    "gqa two blocks": (2, 256, 256, 4, 2, 64, 48, 1.0),
    "T200 not a block multiple": (1, 200, 200, 8, 1, 20, 12, 1.0),
    "odd widths G3": (2, 130, 130, 6, 3, 7, 5, 1.0),
    "S<T one block": (2, 37, 100, 4, 2, 64, 48, 1.0),
    "S<T two blocks": (2, 100, 256, 8, 2, 32, 32, 1.0),
    "inputs x8": (2, 64, 64, 4, 4, 32, 32, 8.0),
}


def _inputs(seed, B, S, T, H, KV, dq, dv, gain, dtype):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(
        gain * rng.standard_normal(shape).astype(np.float32)).to(dtype)
        for shape in ((B, S, H, dq), (B, T, KV, dq), (B, T, KV, dv)))


def _jnp(x, jdtype):
    return jnp.asarray(x.float().numpy()).astype(jdtype)


def _agreement(got, want, dtype):
    """(share of outputs bit for bit, worst error in ulps of ``dtype`` at
    each row's largest |want|)."""
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want).astype(jnp.float32))
    fi = torch.finfo(dtype)
    top = np.maximum(np.abs(w).max(axis=-1, keepdims=True), fi.tiny)
    ulp = np.exp2(np.floor(np.log2(top))) * fi.eps
    return float(np.mean(g == w)), float(np.max(np.abs(g - w) / ulp))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_version_matches_jax_pallas(case, dtype):
    td, jd = DTYPES[dtype]
    q, k, v = _inputs(3, *CASES[case], td)
    calls = ref.flash_attention_ref.calls
    got = ops.clover_attention(q, k, v, scale=SCALE)
    assert ref.flash_attention_ref.calls == calls + 1
    want = jops.clover_attention(_jnp(q, jd), _jnp(k, jd), _jnp(v, jd),
                                 scale=SCALE, impl="interpret")
    assert got.dtype == td and tuple(got.shape) == tuple(want.shape)
    share, worst = _agreement(got, want, td)
    assert share >= SHARE and worst <= 1.0, (share, worst)


def test_ops_routes_by_dtype():
    """A 16-bit CPU call takes the blockwise plain version, a float32 one
    and ``plain=True`` (training) the float32-softmax one."""
    q, k, v = _inputs(4, 1, 20, 20, 2, 1, 16, 8, 1.0, torch.bfloat16)
    before = ref.flash_attention_ref.calls, ref.attention_ref.calls
    ops.clover_attention(q, k, v, scale=SCALE)
    ops.clover_attention(q, k, v, scale=SCALE, plain=True)
    ops.clover_attention(q.float(), k.float(), v.float(), scale=SCALE)
    assert (ref.flash_attention_ref.calls - before[0],
            ref.attention_ref.calls - before[1]) == (1, 2)


def test_blocks_are_the_reference_blocks():
    """The plain version's p rounds against the running max of 128-key
    blocks: the same rows over 256 keys give other bits than one block
    of 256 (the running max moves once), both within BF16_RTOL of the
    float32 softmax's largest |output|."""
    q, k, v = _inputs(5, 1, 256, 256, 2, 2, 16, 16, 3.0, torch.bfloat16)
    blocked = ref.flash_attention_ref(q, k, v, scale=SCALE)
    saved = ref.FLASH_BLOCK
    try:
        ref.FLASH_BLOCK = 256
        whole = ref.flash_attention_ref(q, k, v, scale=SCALE)
    finally:
        ref.FLASH_BLOCK = saved
    assert not torch.equal(blocked, whole)
    f32 = ref.attention_ref(q.float(), k.float(), v.float(), scale=SCALE)
    for got in (blocked, whole):
        torch.testing.assert_close(got.float(), f32, rtol=0,
                                   atol=BF16_RTOL * f32.abs().max().item())


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_mma_chain_is_within_its_truncation_of_the_exact_sum(dtype):
    """``ref._mma_chain`` (the kernel's tensor-core sums) on 16-bit values:
    within 2^-20 of sum |a_k b_k| of the exact dot per step of 16 (a step
    drops, from each of its 17 terms, what lies below 2^-25 of its largest
    exponent, and rounds toward 0), not the float32 sum in general, and
    the same bits whatever the batch it is computed in."""
    td = DTYPES[dtype][0]
    rng = np.random.default_rng(7)
    a = torch.from_numpy(rng.standard_normal((3, 5, 64))).to(td).float()
    b = torch.from_numpy(rng.standard_normal((3, 64, 6))).to(td).float()
    got = ref._mma_chain(a, b)
    exact = a.double() @ b.double()
    bound = 4 * 2.0 ** -20 * (a.double().abs() @ b.double().abs())
    assert torch.all((got.double() - exact).abs() <= bound)
    assert not torch.equal(got, a @ b)
    assert torch.equal(ref._mma_chain(a[1:2], b[1:2]), got[1:2])


def test_wrapper_refuses_mixed_and_8bit_dtypes():
    """q, K and V in float32, or all in one 16-bit dtype: anything else
    raises TypeError before the device check, and nothing is built or
    cast."""
    x = torch.zeros(1, 4, 2, 8)
    for q, k, v in (
            (x.bfloat16(), x, x),
            (x.bfloat16(), x.bfloat16(), x.half()),
            (x.half(), x.half(), x.bfloat16()),
            (x.to(torch.float8_e4m3fn),) * 3,
            (x.bfloat16(), x.to(torch.float8_e4m3fn),
             x.to(torch.float8_e4m3fn)),
            (x.double(),) * 3):
        with pytest.raises(TypeError, match="the kernel takes"):
            flash_attention(q, k, v, scale=SCALE)
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        with pytest.raises(ValueError, match="CUDA"):
            flash_attention(x.to(dt), x.to(dt), x.to(dt), scale=SCALE)
    assert _build._lib is None


@pytest.mark.parametrize("B,S,T,H,KV,dq,dv", [
    (1, 600, 600, 4, 2, 32, 32),     # a long prefill from position 0
    (1, 520, 1120, 4, 4, 64, 64),    # a second prefill at index 600
])
def test_window_routes_against_the_reference_chunked_attention(
        B, S, T, H, KV, dq, dv):
    """Over a cache window the reference runs XLA's chunked attention at
    bfloat16 (``repro/models/layers.py: _causal_attention_chunked``),
    which rounds the logits and the normalised p; the window form
    (``ref.window_attention_ref``) computes that function, the two routes
    the port took before it (float32 then one rounding; the 16-bit
    kernel) are each a rounding of p away from it.  Prints the distances
    of those three and of the port's own plain
    ``layers._causal_attention_chunked`` (torch's einsum sums; ``-s``),
    holds the window form to at least 99% bit for bit and to at least
    both old routes' shares, and the port's window sites to the window
    form.  The scoring site takes the 16-bit kernel's function."""
    q, k, v = _inputs(6, B, S, T, H, KV, dq, dv, 1.0, torch.bfloat16)
    want = JL._causal_attention_chunked(
        *(_jnp(x, jnp.bfloat16) for x in (q, k, v)), SCALE, q_offset=T - S)
    f32 = ref.attention_ref(q.float(), k.float(), v.float(),
                            scale=SCALE).to(torch.bfloat16)
    k16 = ref.flash_attention_ref(q, k, v, scale=SCALE)
    form = ref.window_attention_ref(q, k, v, scale=SCALE,
                                    scale_first=S <= L.ATTN_CHUNK)
    routes = {"window form": _agreement(form, want, torch.bfloat16),
              "float32, one rounding": _agreement(f32, want, torch.bfloat16),
              "16-bit kernel": _agreement(k16, want, torch.bfloat16),
              "torch chunked": _agreement(L._causal_attention_chunked(
                  q, k, v, SCALE, q_offset=T - S), want, torch.bfloat16)}
    for name, (share, worst) in routes.items():
        print(f"window B{B} S{S} T{T} H{H} KV{KV} {dq}/{dv}, {name}: "
              f"{share:.4f} bit for bit with the reference's chunked "
              f"attention, worst {worst:.2f} ulp at the row's max")
    assert routes["window form"][0] >= SHARE
    assert routes["window form"][0] >= max(
        routes["float32, one rounding"][0], routes["16-bit kernel"][0])
    window = L._causal_window(q, k, v, SCALE, 0.0, H // KV, torch.bfloat16,
                              window=True)
    assert torch.equal(window, form)
    scoring = L._causal_window(q, k, v, SCALE, 0.0, H // KV,
                               torch.bfloat16)
    assert torch.equal(scoring, k16)


def test_bf16_model_scoring_matches_jax_pallas():
    """A bfloat16 gpt2-shaped model of 2 narrow layers scores the same
    tokens through the port's ``forward`` (the 16-bit plain version, once
    a layer) and the JAX ``forward`` with its Pallas kernel in interpret
    mode: logits within BF16_RTOL of the largest |logit|."""
    kw = dict(n_layers=2, param_dtype="bfloat16", compute_dtype="bfloat16")
    cfg = get_config("gpt2-xl").reduced(**kw)
    jcfg = dataclasses.replace(jax_config("gpt2-xl").reduced(**kw),
                               kernel_impl="interpret")
    jp = jax_init(jcfg, jax.random.PRNGKey(8))
    tp = from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    toks = np.random.default_rng(9).integers(0, cfg.vocab_size, (2, 160))
    want = np.asarray(JT.forward(jp, jcfg, jnp.asarray(toks))[0]
                      .astype(jnp.float32))
    calls = ref.flash_attention_ref.calls, ref.attention_ref.calls
    got = T.forward(tp, cfg, toks, device="cpu")[0].float().numpy()
    assert (ref.flash_attention_ref.calls - calls[0],
            ref.attention_ref.calls - calls[1]) == (cfg.n_layers, 0)
    err = np.abs(got - want).max()
    assert err <= BF16_RTOL * np.abs(want).max(), err
