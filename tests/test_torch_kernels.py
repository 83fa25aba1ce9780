"""The port's plain attention versions (``repro_torch.kernels.ref``,
what the CUDA kernels are held to on the card) against the JAX
package's oracles and its Pallas kernels in interpret mode, on the same
numpy-seeded float32 inputs.  Tolerance: atol 1e-5 (float32 sums in
another order).  The CUDA kernels themselves run only on the card:
``chip_smoke.py`` holds them to these versions there."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the xdist workers already fill the CPUs, and a
# torch thread pool per worker oversubscribes them many times over
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels.clover_attention import flash_attention  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    flash_decode, flash_decode_ranked)
from repro_torch.kernels.paged_decode_attention import (  # noqa: E402
    paged_flash_decode, paged_flash_decode_ranked)

ATOL = 1e-5
SCALE = 1.0 / np.sqrt(64)      # the original head_dim's scale, as served


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("B,S,T,H,KV,dq,dv,pallas", [
    (2, 64, 64, 4, 2, 32, 24, True),      # GQA G=2, dq != dv
    (1, 40, 40, 4, 4, 32, 32, True),      # MHA G=1
    (2, 37, 100, 4, 2, 64, 48, True),     # S < T: queries end-aligned
    # one query against 5 keys: the reference pads S and T to 8 in
    # ops._clover_body, which moves q_offset to 0, so its Pallas path
    # disagrees with its own jnp oracle there; hold this case to the
    # oracle only
    (3, 1, 5, 2, 1, 16, 8, False),
])
def test_attention_ref_matches_jax(B, S, T, H, KV, dq, dv, pallas):
    rng = np.random.default_rng(0)
    q, k, v = _randn(rng, B, S, H, dq), _randn(rng, B, T, KV, dq), \
        _randn(rng, B, T, KV, dv)
    got = ref.attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), scale=SCALE).numpy()
    want = np.asarray(jref.attention_ref(q, k, v, scale=SCALE))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    if pallas:
        kernel = np.asarray(jops.clover_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=SCALE,
            impl="interpret"))
        np.testing.assert_allclose(got, kernel, atol=ATOL, rtol=0)


def _decode_case(rng, B, T, H, KV, dq, dv, lens):
    q, k, v = _randn(rng, B, H, dq), _randn(rng, B, T, KV, dq), \
        _randn(rng, B, T, KV, dv)
    lengths = np.asarray(lens, np.int32)
    past = np.arange(T)[None, :] >= lengths[:, None]
    k[past] = 50.0                 # finite garbage past each row's length
    v[past] = -50.0
    return q, k, v, lengths


@pytest.mark.parametrize("B,T,H,KV,dq,dv,lens", [
    (6, 64, 4, 2, 32, 24, [0, 1, 15, 16, 33, 64]),   # G=2, dq != dv
    (3, 40, 2, 2, 16, 16, [0, 7, 40]),               # G=1
])
def test_decode_ref_matches_jax(B, T, H, KV, dq, dv, lens):
    rng = np.random.default_rng(1)
    q, k, v, lengths = _decode_case(rng, B, T, H, KV, dq, dv, lens)
    got = ref.decode_attention_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(lengths), scale=SCALE).numpy()
    # the jnp oracle's all-masked softmax is NaN at length 0; the
    # kernels (and the port's plain version) give 0 there
    live = lengths > 0
    want = np.asarray(jref.decode_attention_ref(q, k, v, lengths,
                                                scale=SCALE))
    np.testing.assert_allclose(got[live], want[live], atol=ATOL, rtol=0)
    assert np.all(got[~live] == 0.0)
    pallas = np.asarray(jops.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(lengths), scale=SCALE, block_t=16, impl="interpret"))
    np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=0)


def _paged_case(rng, B, H, KV, dq, dv, pt, n_pages, n_p, lens):
    """Pool with the garbage row ``n_pages`` full of finite garbage;
    row b maps ceil(len/pt) distinct pages, the rest of its table is
    the sentinel id."""
    q = _randn(rng, B, H, dq)
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
    return q, kp, vp, tab, np.asarray(lens, np.int32)


@pytest.mark.parametrize("B,H,KV,dq,dv,pt,lens", [
    (6, 4, 2, 32, 24, 8, [0, 1, 7, 8, 9, 40]),   # mid-page and page edges
    (3, 2, 2, 16, 16, 16, [0, 16, 33]),
])
def test_paged_ref_matches_jax(B, H, KV, dq, dv, pt, lens):
    rng = np.random.default_rng(2)
    n_p = 6
    q, kp, vp, tab, lengths = _paged_case(rng, B, H, KV, dq, dv, pt, 30,
                                          n_p, lens)
    got = ref.paged_decode_attention_ref(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(tab), torch.from_numpy(lengths),
        scale=SCALE).numpy()
    live = lengths > 0
    want = np.asarray(jref.paged_decode_attention_ref(
        q, kp, vp, tab, lengths, scale=SCALE))
    np.testing.assert_allclose(got[live], want[live], atol=ATOL, rtol=0)
    assert np.all(got[~live] == 0.0)
    pallas = np.asarray(jops.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tab),
        jnp.asarray(lengths), scale=SCALE, impl="interpret"))
    np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=0)


def test_ops_dispatch_cpu_to_plain_versions():
    """A CPU tensor goes to the plain version (counted), never to a
    kernel launch."""
    rng = np.random.default_rng(3)
    q, k, v, lengths = _decode_case(rng, 2, 16, 2, 1, 8, 8, [5, 16])
    qt, kt, vt, lt = map(torch.from_numpy, (q, k, v, lengths))
    before = (ref.decode_attention_ref.calls, flash_decode.launches)
    out = ops.decode_attention(qt, kt, vt, lt, scale=SCALE)
    assert out.shape == (2, 2, 8)
    assert ref.decode_attention_ref.calls == before[0] + 1
    assert flash_decode.launches == before[1]
    before = ref.attention_ref.calls
    ops.clover_attention(torch.from_numpy(_randn(rng, 1, 4, 2, 8)),
                         torch.from_numpy(_randn(rng, 1, 4, 1, 8)),
                         torch.from_numpy(_randn(rng, 1, 4, 1, 8)),
                         scale=SCALE)
    assert ref.attention_ref.calls == before + 1


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_ops_routes_rank_vectors_on_the_cpu(layout):
    """With no rank vectors the unranked plain version runs unchanged;
    with one the other defaults to full width.  The calls counters show
    which version ran, and no kernel launches on CPU tensors."""
    rng = np.random.default_rng(4)
    q, k, v, lengths = _decode_case(rng, 2, 16, 4, 2, 8, 8, [5, 16])
    qt, kt, vt, lt = map(torch.from_numpy, (q, k, v, lengths))
    if layout == "dense":
        fn, plain = ops.decode_attention, ref.decode_attention_ref
        args = (qt, kt, vt, lt)
    else:
        fn, plain = ops.paged_decode_attention, ref.paged_decode_attention_ref
        tab = torch.arange(2, dtype=torch.int32)[:, None]   # 1 page of 16
        args = (qt, kt, vt, tab, lt)
    launches = (flash_decode.launches, flash_decode_ranked.launches,
                paged_flash_decode.launches,
                paged_flash_decode_ranked.launches)
    calls = plain.calls
    full = fn(*args, scale=SCALE)
    assert plain.calls == calls + 1
    rq = torch.tensor([3, 8], dtype=torch.int32)
    out = fn(*args, scale=SCALE, qk_ranks=rq)
    want = fn(*args, scale=SCALE, qk_ranks=rq,
              vo_ranks=torch.full((2,), 8, dtype=torch.int32))
    assert plain.calls == calls + 3
    assert torch.equal(out, want) and not torch.equal(out, full)
    # full-width vectors are the unranked result
    assert torch.equal(fn(*args, scale=SCALE, qk_ranks=torch.full(
        (2,), 8, dtype=torch.int32)), full)
    assert launches == (flash_decode.launches, flash_decode_ranked.launches,
                        paged_flash_decode.launches,
                        paged_flash_decode_ranked.launches)


def test_ranked_wrappers_refuse_what_the_kernels_do_not_take():
    """Rank vectors must be contiguous (KV,) int32 CUDA tensors; CPU
    tensors raise (no silent plain path), before any build."""
    q = torch.zeros(2, 4, 8)
    k = torch.zeros(2, 16, 2, 8)
    lengths = torch.zeros(2, dtype=torch.int32)
    tab = torch.zeros(2, 1, dtype=torch.int32)
    good = torch.zeros(2, dtype=torch.int32)
    for bad, err, match in (
            (torch.zeros(2, dtype=torch.int64), TypeError, "int32"),
            (torch.zeros(3, dtype=torch.int32), ValueError, r"\(2,\)"),
            (torch.zeros(1, 2, dtype=torch.int32), ValueError, r"\(2,\)"),
            (good, ValueError, "CUDA")):
        with pytest.raises(err, match=match):
            flash_decode_ranked(q, k, k, lengths, good, bad, scale=SCALE)
        with pytest.raises(err, match=match):
            paged_flash_decode_ranked(q, k, k, tab, lengths, bad, good,
                                      scale=SCALE)
    assert _build._lib is None


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take():
    """The kernel wrappers raise on CPU tensors (no silent plain path)
    and before any build is attempted; the decode wrappers take q in a
    16-bit compute dtype over a narrow cache as it lies, so such a pair
    passes their dtype check and meets the device check (the pairs they
    refuse: ``test_torch_decode_16bit.py``)."""
    q = torch.zeros(2, 4, 8)
    k = torch.zeros(2, 16, 2, 8)
    lengths = torch.zeros(2, dtype=torch.int32)
    fp8 = k.to(torch.float8_e4m3fn)
    with pytest.raises(ValueError, match="CUDA"):
        flash_decode(q.to(torch.bfloat16), fp8, fp8, lengths, scale=SCALE)
    with pytest.raises(ValueError, match="CUDA"):
        paged_flash_decode(q.to(torch.float16), k, k,
                           torch.zeros(2, 3, dtype=torch.int32), lengths,
                           scale=SCALE)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(torch.zeros(1, 4, 2, 8), k[:1], k[:1], scale=SCALE)
    assert _build._lib is None


def test_build_needs_nvcc(monkeypatch, tmp_path):
    """Without nvcc the build fails loudly; the library name carries a
    hash of the sources."""
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()
    name = _build.library_path().name
    assert name.startswith("libclover_kernels_") and name.endswith(".so")
    assert sorted(p.name for p in _build.CSRC.glob("*.cu")) == [
        "clover_attention.cu", "decode_attention.cu", "mamba_scan.cu",
        "page_copy.cu", "wkv6.cu"]
