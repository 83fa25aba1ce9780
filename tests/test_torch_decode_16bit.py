"""The port's decode plain versions (``repro_torch.kernels.ref``, what the
CUDA decode kernels are held to on the card) in 16-bit compute, against
the JAX package's Pallas decode kernels in interpret mode.

The reference's call sites cast the cache to the compute dtype
(``repro/models/layers.py``: ``astype(x.dtype)``) and its kernels round
each ``p`` to V's dtype before P.V, against the running max of the
blocks walked so far (256 positions dense, one page paged).  The port
gets q in the compute dtype and K/V in their storage dtype, on the CPU
through ``kernels.ops`` as the engine calls it.

Tolerance: at least 99% of the outputs bit for bit, and every output
within one ulp of the compute dtype at its (b, h) row's largest |output|
(a p rounded the other way moves a near-zero output by many of its own
ulps, never by more than the row's).  The port's path before the decode
kernels took 16-bit operands -- float32 compute, one rounding at the end
-- misses this: on this file's inputs 31.9% (dense) and 20.3% (paged)
of the bfloat16 outputs differ from the Pallas kernel's
(``test_float32_then_one_rounding_misses_the_criterion`` prints them
under ``-s``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the xdist workers already fill the CPUs, and a
# torch thread pool per worker oversubscribes them many times over
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import decode_attention as jdec  # noqa: E402
from repro.kernels import paged_decode_attention as jpaged  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    flash_decode, flash_decode_ranked)
from repro_torch.kernels.paged_decode_attention import (  # noqa: E402
    paged_flash_decode)

SCALE = 0.125
SHARE = 0.99
COMPUTE = {"bfloat16": (torch.bfloat16, jnp.bfloat16),
           "float16": (torch.float16, jnp.float16)}
STORAGE = ("same", "float32", "float8_e4m3fn", "float8_e5m2")
# dense: 4 rows of a 600-position cache (not a multiple of the 256-position
# block), GQA G = 2, dq != dv, a row of length 0; paged: G = 1 (the
# kernels' four score chains), pages of 16, a mid-page length
DENSE = dict(B=4, T=600, H=8, KV=4, dq=32, dv=24, lens=[600, 300, 0, 257])
PAGED = dict(B=4, H=4, KV=4, dq=32, dv=16, pt=16, n_pages=30, n_p=8,
             lens=[128, 0, 17, 100])
RANKS = ([32, 13, 7, 30], [24, 5, 16, 11])   # ragged, zero-padded past


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _zero_past(x, ranks):
    """x (..., KV, d) with dims >= ranks[kv] zeroed (the mask_head_ranks
    convention the rank-clamped kernels agree under)."""
    keep = np.arange(x.shape[-1])[None, :] < np.asarray(ranks)[:, None]
    return np.where(keep, x, 0.0).astype(np.float32)


def _case(layout, ranked, seed):
    """float32 numpy q, k, v (dense cache or pools), lengths, page table
    (paged) and ranks (ranked)."""
    rng = np.random.default_rng(seed)
    c = DENSE if layout == "dense" else PAGED
    B, H, KV, dq, dv = c["B"], c["H"], c["KV"], c["dq"], c["dv"]
    q = _randn(rng, B, H, dq)
    lens = np.asarray(c["lens"], np.int32)
    if layout == "dense":
        k, v = _randn(rng, B, c["T"], KV, dq), _randn(rng, B, c["T"], KV, dv)
        past = np.arange(c["T"])[None, :] >= lens[:, None]
        k[past], v[past] = 50.0, -50.0        # finite garbage
        tab = None
    else:
        N, pt = c["n_pages"] + 1, c["pt"]
        k, v = _randn(rng, N, pt, KV, dq), _randn(rng, N, pt, KV, dv)
        k[N - 1], v[N - 1] = 50.0, -50.0     # the sentinel row
        perm = rng.permutation(N - 1)
        tab = np.full((B, c["n_p"]), N - 1, np.int32)
        nxt = 0
        for b, n in enumerate(lens):
            used = -(-int(n) // pt)
            tab[b, :used] = perm[nxt:nxt + used]
            nxt += used
    ranks = None
    if ranked:
        ranks = tuple(np.asarray(r, np.int32) for r in RANKS)
        G = H // KV
        q = _zero_past(q.reshape(B, KV, G, dq).transpose(0, 2, 1, 3),
                       ranks[0]).transpose(0, 2, 1, 3).reshape(B, H, dq)
        k, v = _zero_past(k, ranks[0]), _zero_past(v, ranks[1])
    return q, k, v, lens, tab, ranks


def _port(q, k, v, lens, tab, ranks, cd, storage):
    """The port on the CPU, as the engine calls it: q in the compute
    dtype, the cache in its storage dtype."""
    sd = cd if storage == "same" else getattr(torch, storage)
    qt = torch.from_numpy(q).to(cd)
    kt, vt = torch.from_numpy(k).to(sd), torch.from_numpy(v).to(sd)
    kw = dict(scale=SCALE)
    if ranks is not None:
        kw.update(qk_ranks=torch.from_numpy(ranks[0]),
                  vo_ranks=torch.from_numpy(ranks[1]))
    if tab is None:
        return ops.decode_attention(qt, kt, vt, torch.from_numpy(lens), **kw)
    return ops.paged_decode_attention(qt, kt, vt, torch.from_numpy(tab),
                                      torch.from_numpy(lens), **kw)


def _pad(x, axis, multiple):
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, -x.shape[axis] % multiple)
    return jnp.pad(x, pad)


def _jax(q, k, v, lens, tab, ranks, cd, jcd, storage):
    """The JAX Pallas kernel in interpret mode on the same values: the
    cache stored in its dtype, then cast to the compute dtype as the
    reference's call sites cast it, at the blocks ``repro/kernels/ops.py``
    picks (``block_t`` 256 padded to at least 8; ``rank_block`` 128 at
    most)."""
    sd = cd if storage == "same" else getattr(torch, storage)
    jq = jnp.asarray(torch.from_numpy(q).to(cd).float().numpy()).astype(jcd)
    jk, jv = (jnp.asarray(torch.from_numpy(x).to(sd).float().numpy())
              .astype(jcd) for x in (k, v))
    jl = jnp.asarray(lens)
    dq, dv = q.shape[-1], v.shape[-1]
    rb = min(128, max(8, max(dq, dv)))
    if tab is None:
        bt = min(256, max(8, k.shape[1]))
        jk, jv = _pad(jk, 1, bt), _pad(jv, 1, bt)
        if ranks is None:
            return jdec.flash_decode(jq, jk, jv, jl, scale=SCALE,
                                     block_t=bt, interpret=True)
        out = jdec.flash_decode_ranked(
            _pad(jq, -1, rb), _pad(jk, -1, rb), _pad(jv, -1, rb), jl,
            jnp.asarray(ranks[0]), jnp.asarray(ranks[1]), scale=SCALE,
            block_t=bt, rank_block=rb, interpret=True)
        return out[..., :dv]
    jt = jnp.asarray(tab)
    if ranks is None:
        return jpaged.paged_flash_decode(jq, jk, jv, jt, jl, scale=SCALE,
                                         interpret=True)
    out = jpaged.paged_flash_decode_ranked(
        _pad(jq, -1, rb), _pad(jk, -1, rb), _pad(jv, -1, rb), jt, jl,
        jnp.asarray(ranks[0]), jnp.asarray(ranks[1]), scale=SCALE,
        rank_block=rb, interpret=True)
    return out[..., :dv]


def _agreement(got, want, cd):
    """(share of outputs bit for bit, worst error in ulps of the compute
    dtype at each (b, h) row's largest |want|)."""
    g = got.float().numpy()
    w = np.asarray(want.astype(jnp.float32))
    fi = torch.finfo(cd)
    top = np.maximum(np.abs(w).max(axis=-1, keepdims=True), fi.tiny)
    ulp = np.exp2(np.floor(np.log2(top))) * fi.eps
    return float(np.mean(g == w)), float(np.max(np.abs(g - w) / ulp))


@pytest.mark.parametrize("storage", STORAGE)
@pytest.mark.parametrize("compute", sorted(COMPUTE))
@pytest.mark.parametrize("ranked", [False, True])
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_decode_16bit_matches_jax_pallas(layout, ranked, compute, storage):
    cd, jcd = COMPUTE[compute]
    q, k, v, lens, tab, ranks = _case(layout, ranked, seed=11)
    got = _port(q, k, v, lens, tab, ranks, cd, storage)
    want = _jax(q, k, v, lens, tab, ranks, cd, jcd, storage)
    assert got.dtype == cd and tuple(got.shape) == tuple(want.shape)
    share, worst = _agreement(got, want, cd)
    assert share >= SHARE and worst <= 1.0, (share, worst)
    empty = lens == 0
    assert np.all(got.float().numpy()[empty] == 0.0)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_float32_then_one_rounding_misses_the_criterion(layout):
    """The path before 16-bit operands: float32 compute over float32
    copies, the output rounded once to bfloat16.  On the same inputs it
    leaves the tolerance the 16-bit form meets."""
    q, k, v, lens, tab, _ = _case(layout, False, seed=11)
    q16 = torch.from_numpy(q).to(torch.bfloat16)
    k16, v16 = (torch.from_numpy(x).to(torch.bfloat16) for x in (k, v))
    old = _port(q16.float().numpy(), k16.float().numpy(),
                v16.float().numpy(), lens, tab, None, torch.float32,
                "same").to(torch.bfloat16)
    want = _jax(q, k, v, lens, tab, None, torch.bfloat16, jnp.bfloat16,
                "same")
    share, worst = _agreement(old, want, torch.bfloat16)
    print(f"{layout}: float32 compute, one rounding: {1 - share:.4f} of the "
          f"bfloat16 outputs differ from the Pallas kernel, worst "
          f"{worst:.2f} ulp")
    assert share < SHARE, share


@pytest.mark.parametrize("storage", ["bfloat16", "float8_e4m3fn"])
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_float32_compute_over_narrow_cache_is_the_float32_copy(layout,
                                                                storage):
    """At float32 compute the 16-bit rounding is the identity: a bfloat16
    or float8 cache gives bit for bit the result of its float32 copy."""
    q, k, v, lens, tab, ranks = _case(layout, True, seed=12)
    sd = getattr(torch, storage)
    k8, v8 = (torch.from_numpy(x).to(sd).float().numpy() for x in (k, v))
    got = _port(q, k, v, lens, tab, ranks, torch.float32, storage)
    want = _port(q, k8, v8, lens, tab, ranks, torch.float32, "same")
    assert got.dtype == torch.float32 and torch.equal(got, want)


def test_wrappers_refuse_dtype_pairs_they_do_not_take():
    """q in float32 / bfloat16 / float16 and K and V in one KV cache
    dtype: anything else raises TypeError before any device check, and
    nothing is cast."""
    lengths = torch.zeros(2, dtype=torch.int32)
    k = torch.zeros(2, 16, 2, 8, dtype=torch.bfloat16)
    for q, kk, vv in (
            (torch.zeros(2, 4, 8, dtype=torch.float64), k, k),
            (torch.zeros(2, 4, 8, dtype=torch.float8_e4m3fn), k, k),
            (torch.zeros(2, 4, 8), k, k.to(torch.float16)),
            (torch.zeros(2, 4, 8), k.to(torch.int8), k.to(torch.int8))):
        with pytest.raises(TypeError, match="the kernels take"):
            flash_decode(q, kk, vv, lengths, scale=SCALE)
        with pytest.raises(TypeError, match="the kernels take"):
            paged_flash_decode(q, kk, vv, torch.zeros(2, 1, dtype=torch.int32),
                               lengths, scale=SCALE)
    ranks = torch.full((2,), 8, dtype=torch.int32)
    with pytest.raises(TypeError, match="the kernels take"):
        flash_decode_ranked(torch.zeros(2, 4, 8), k, k.float(), lengths,
                            ranks, ranks, scale=SCALE)


def test_plain_version_rounds_p_per_block():
    """The 16-bit plain version's p is rounded against the running max of
    the blocks so far: the same inputs under one block (a shorter cache
    reaches the same positions) give other bits than under 256-position
    blocks, and float32 compute is unchanged by the block."""
    rng = np.random.default_rng(5)
    B, H, dq = 2, 2, 16
    q = torch.from_numpy(_randn(rng, B, H, dq) * 3)
    k = torch.from_numpy(_randn(rng, B, 600, H, dq))
    v = torch.from_numpy(_randn(rng, B, 600, H, dq))
    lengths = torch.tensor([600, 520], dtype=torch.int32)
    q16, k16, v16 = (x.to(torch.bfloat16) for x in (q, k, v))
    blocked = ref.decode_attention_ref(q16, k16, v16, lengths, scale=SCALE)
    one = ref._decode(q16, k16, v16, lengths, SCALE, 600)
    assert not torch.equal(blocked, one)
    assert torch.equal(ref._decode(q, k, v, lengths, SCALE, 256),
                       ref._decode(q, k, v, lengths, SCALE, 600))


def test_attention_16bit_gap():
    """The witness of ``flash_attention``'s route before its 16-bit form:
    float32 compute and the context rounded once, while the reference's
    Pallas kernel rounds p per 128-key block.  Prints the share of
    bfloat16 outputs that differ from the JAX kernel (interpret mode; run
    with ``-s``), holds that route within one ulp of the compute dtype at
    each row's largest |output|, and shows that it misses the 99% bit-for-
    bit criterion the 16-bit form meets
    (``tests/test_torch_attention_16bit.py``)."""
    from repro.kernels import ops as jops
    rng = np.random.default_rng(13)
    B, S, H, KV, dq, dv = 2, 256, 4, 2, 64, 48
    q, k, v = (torch.from_numpy(_randn(rng, B, S, n, d)).to(torch.bfloat16)
               for n, d in ((H, dq), (KV, dq), (KV, dv)))
    port = ref.attention_ref(q.float(), k.float(), v.float(),
                             scale=SCALE).to(torch.bfloat16)
    want = jops.clover_attention(
        *(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
          for x in (q, k, v)), scale=SCALE, impl="interpret")
    share, worst = _agreement(port, want, torch.bfloat16)
    print(f"flash_attention, bfloat16 (B{B} S=T{S} H{H} KV{KV} {dq}/{dv}):"
          f" {1 - share:.4f} of the outputs differ from the Pallas kernel,"
          f" worst {worst:.2f} ulp")
    assert worst <= 1.0
    assert share < SHARE, share
