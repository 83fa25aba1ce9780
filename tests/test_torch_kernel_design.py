"""The numerical and structural premises of the port's attention kernels,
checked on the CPU before any card runs them.

* The split planner of the decode kernels (``plan_splits``): every
  position below the capacity is covered by exactly one split, a paged
  split is whole pages, the block count reaches its target where the
  capacity allows, and nothing in it (or in the decode wrappers) reads
  ``lengths`` back to the host.
* A plain emulation of split-K flash-decoding: per-split (m, l, acc)
  over the positions below each row's length only, then the combine the
  CUDA kernel runs, held to ``ref.decode_attention_ref`` and
  ``ref.paged_decode_attention_ref`` within 1e-6 (float32, sums in
  another order).  Garbage past the lengths and in unmapped pages is NaN,
  so a read of it would show.
* A plain emulation of 3xTF32: ``cvt.rna.tf32.f32`` by bit arithmetic on
  float32, products of TF32 values exact in float32.  Three passes keep
  attention within the 2e-5 parity the kernels are held to; one pass
  does not.
"""
import inspect
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the xdist workers already fill the CPUs, and a
# torch thread pool per worker oversubscribes them many times over
torch.set_num_threads(1)

from repro_torch.kernels import decode_attention, paged_decode_attention  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    BLOCKS_PER_SM, MIN_SPAN, plan_splits)

SCALE = 1.0 / np.sqrt(64)
SMS = 132                       # H100 SXM


# -- the planner --------------------------------------------------------

@pytest.mark.parametrize("page_tokens", [1, 4, 16, 64])
@pytest.mark.parametrize("rows", [1, 4, 32, 100, 264, 1000])
def test_splits_cover_every_position_once(rows, page_tokens):
    for capacity in (1, 5, 31, 32, 33, 100, 576, 1000, 4096, 32768):
        n_split, span = plan_splits(capacity, rows, SMS, page_tokens)
        assert n_split >= 1 and span % page_tokens == 0
        assert span >= MIN_SPAN and span % MIN_SPAN == 0
        # split s covers [s * span, (s + 1) * span): each position below
        # the capacity in exactly one, and no split is empty of them
        owner = np.arange(capacity) // span
        assert owner.max() == n_split - 1
        assert np.all(np.bincount(owner, minlength=n_split) > 0)
        unit = math.lcm(MIN_SPAN, page_tokens)
        if -(-capacity // unit) >= -(-BLOCKS_PER_SM * SMS // rows):
            # the capacity allows it
            assert rows * n_split >= BLOCKS_PER_SM * SMS
        assert rows * n_split >= min(2 * SMS, rows * -(-capacity // unit))


def test_main_path_plans():
    # gpt2-xl: 4 slots x 25 KV heads against a 576-position cache or 36
    # pages of 16; jamba: 4 x 8 KV heads
    assert plan_splits(576, 100, SMS) == (6, 96)
    assert plan_splits(36 * 16, 100, SMS, 16) == (6, 96)
    assert plan_splits(576, 32, SMS) == (18, 32)
    assert plan_splits(36 * 16, 32, SMS, 16) == (18, 32)


def test_planner_and_wrappers_never_read_lengths():
    params = list(inspect.signature(plan_splits).parameters)
    assert params == ["capacity", "rows", "sms", "page_tokens"]
    for mod in (decode_attention, paged_decode_attention):
        src = Path(mod.__file__).read_text()
        for host_read in (".item(", ".tolist(", ".cpu(", "int(lengths",
                          ".numpy("):
            assert host_read not in src, (mod.__name__, host_read)


# -- split-K flash-decoding, emulated -----------------------------------

def _split_decode(q, rows_of, lengths, span, n_split, KV, dv, qk_ranks=None,
                  vo_ranks=None):
    """The kernels' algorithm on the CPU.  ``rows_of(b, lo, hi)`` ->
    (K, V) rows of positions [lo, hi) of row b, (n, KV, d) each."""
    B, H, dq = q.shape
    G = H // KV
    out = torch.zeros(B, H, dv)
    for b in range(B):
        parts = []
        for s in range(n_split):
            lo, hi = s * span, min((s + 1) * span, int(lengths[b]))
            if lo >= hi:
                parts.append(None)           # m = -inf, l = 0
                continue
            k, v = rows_of(b, lo, hi)
            k = ref._rank_mask(k, qk_ranks)
            v = ref._rank_mask(v, vo_ranks)
            qg = q[b].reshape(KV, G, dq) * SCALE
            logits = torch.einsum("kgd,tkd->kgt", qg, k)
            m = logits.amax(-1)
            p = torch.exp(logits - m[..., None])
            parts.append((m, p.sum(-1), torch.einsum("kgt,tkd->kgd", p, v)))
        live = [p for p in parts if p is not None]
        if not live:
            continue                         # exactly 0
        M = torch.stack([m for m, _, _ in live]).amax(0)
        L = sum(torch.exp(m - M) * l for m, l, _ in live)
        acc = sum(torch.exp(m - M)[..., None] * a for m, _, a in live)
        out[b] = (acc / L.clamp_min(1e-30)[..., None]).reshape(H, dv)
    return out


def _garbage_past(x, lengths):
    past = torch.arange(x.shape[1])[None, :] >= lengths[:, None]
    return torch.where(past[..., None, None], float("nan"), x)


def _zero_pad(x, ranks):
    return ref._rank_mask(x, ranks)


DENSE_CASES = [
    # B, T, H, KV, dq, dv, lengths, rows (B * KV) picked for the planner
    (4, 576, 4, 4, 32, 32, [0, 1, 192, 576]),      # split boundary, full
    (3, 100, 16, 1, 16, 8, [0, 33, 100]),          # G = 16
    (2, 80, 8, 2, 24, 12, [80, 45]),               # G = 4, dq != dv
    (5, 64, 2, 2, 8, 8, [1, 31, 32, 63, 64]),      # capacity near one tile
]


@pytest.mark.parametrize("B,T,H,KV,dq,dv,lens", DENSE_CASES)
def test_split_decode_emulation_matches_ref_dense(B, T, H, KV, dq, dv, lens):
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((B, H, dq)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((B, T, KV, dq)).astype(
        np.float32))
    v = torch.from_numpy(rng.standard_normal((B, T, KV, dv)).astype(
        np.float32))
    lengths = torch.tensor(lens, dtype=torch.int32)
    want = ref.decode_attention_ref(q, k, v, lengths, scale=SCALE)
    kg, vg = _garbage_past(k, lengths), _garbage_past(v, lengths)
    for sms in (SMS, 1):                    # many splits, and few
        n_split, span = plan_splits(T, B * KV, sms)
        got = _split_decode(q, lambda b, lo, hi: (kg[b, lo:hi], vg[b, lo:hi]),
                            lengths, span, n_split, KV, dv)
        torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
        assert torch.equal(got[lengths == 0], torch.zeros_like(
            got[lengths == 0]))


@pytest.mark.parametrize("pt", [1, 8, 16])
def test_split_decode_emulation_matches_ref_paged(pt):
    rng = np.random.default_rng(1)
    B, H, KV, dq, dv, n_p = 4, 16, 1, 32, 24, 12
    capacity = n_p * pt
    lens = [0, 1, capacity, min(capacity, 2 * pt + 3)]
    n_pages = sum(-(-n // pt) for n in lens)
    N = n_pages + 1
    q = torch.from_numpy(rng.standard_normal((B, H, dq)).astype(np.float32))
    kp = torch.from_numpy(rng.standard_normal((N, pt, KV, dq)).astype(
        np.float32))
    vp = torch.from_numpy(rng.standard_normal((N, pt, KV, dv)).astype(
        np.float32))
    perm = rng.permutation(n_pages)
    table = torch.full((B, n_p), n_pages, dtype=torch.int32)
    nxt = 0
    for b, n in enumerate(lens):
        used = -(-n // pt)
        table[b, :used] = torch.from_numpy(perm[nxt:nxt + used].astype(
            np.int32))
        nxt += used
    lengths = torch.tensor(lens, dtype=torch.int32)
    want = ref.paged_decode_attention_ref(q, kp, vp, table, lengths,
                                          scale=SCALE)
    kg, vg = kp.clone(), vp.clone()
    kg[n_pages] = float("nan")              # the sentinel row: never read
    vg[n_pages] = float("nan")

    def rows_of(b, lo, hi):
        t = torch.arange(lo, hi)
        # only pages below ceil(lengths[b] / pt) are dereferenced
        assert int(t.max()) // pt < -(-int(lengths[b]) // pt)
        page = table[b, t // pt].long()
        return kg[page, t % pt], vg[page, t % pt]

    n_split, span = plan_splits(capacity, B * KV, SMS, pt)
    assert span % pt == 0
    got = _split_decode(q, rows_of, lengths, span, n_split, KV, dv)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)


def test_split_decode_emulation_ranked_zero_padded():
    """Ranked splits on zero-padded data: the rank-clamped emulation
    equals the ranked plain version, and the zero columns come out 0."""
    rng = np.random.default_rng(2)
    B, T, H, KV, d = 4, 576, 8, 8, 56
    rq = torch.tensor([8, 16, 24, 32, 40, 48, 56, 0], dtype=torch.int32)
    rv = torch.tensor([56, 48, 8, 0, 16, 24, 32, 40], dtype=torch.int32)
    q = torch.from_numpy(rng.standard_normal((B, H, d)).astype(np.float32))
    q = _zero_pad(q, rq)                    # G = 1
    k = _zero_pad(torch.from_numpy(rng.standard_normal(
        (B, T, KV, d)).astype(np.float32)), rq)
    v = _zero_pad(torch.from_numpy(rng.standard_normal(
        (B, T, KV, d)).astype(np.float32)), rv)
    lengths = torch.tensor([300, 200, 150, 60], dtype=torch.int32)
    want = ref.decode_attention_ref(q, k, v, lengths, scale=SCALE,
                                    qk_ranks=rq, vo_ranks=rv)
    n_split, span = plan_splits(T, B * KV, SMS)
    got = _split_decode(q, lambda b, lo, hi: (k[b, lo:hi], v[b, lo:hi]),
                        lengths, span, n_split, KV, d, rq, rv)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
    past = torch.arange(d)[None, :] >= rv.long()[:, None]    # (KV, d)
    assert torch.equal(got[:, past], torch.zeros_like(got[:, past]))
    unranked = ref.decode_attention_ref(q, k, v, lengths, scale=SCALE)
    torch.testing.assert_close(unranked, want, atol=1e-6, rtol=0)


# -- 3xTF32, emulated ---------------------------------------------------

def tf32_rna(x):
    """cvt.rna.tf32.f32: keep 10 mantissa bits, round to nearest with
    ties away from zero (add half an ulp of TF32 to the magnitude bits,
    then truncate)."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x):
    big = tf32_rna(x)
    return big, tf32_rna(x - big)


def mm3(a, b):
    """a @ b as the kernel takes it: small terms first, float32 sums;
    products of TF32 values are exact in float32."""
    (ab, as_), (bb, bs) = split(a), split(b)
    d = as_ @ bb
    d = d + ab @ bs
    return d + ab @ bb


def mm1(a, b):
    return tf32_rna(a) @ tf32_rna(b)


def test_tf32_rounding():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)
    x = np.array([1 + 2 ** -11, 1 + 2 ** -12, -(1 + 2 ** -11),
                  1 + 3 * 2 ** -12, 0.0, 3.0], np.float32)
    np.testing.assert_array_equal(
        tf32_rna(x), np.array([one + ulp, one, -(one + ulp), one + ulp, 0.0,
                               3.0], np.float32))
    rng = np.random.default_rng(3)
    y = rng.standard_normal(10000).astype(np.float32)
    big, small = split(y)
    assert np.all(big.view(np.uint32) & 0x1FFF == 0)
    assert np.all(small.view(np.uint32) & 0x1FFF == 0)
    # big + small carries 21+ significant bits of y
    assert np.max(np.abs((big + small) - y) / np.abs(y)) < 2.0 ** -20


def _attention(mm, q, k, v):
    """Causal attention of one head with products by ``mm``, softmax in
    float32 (the kernel's registers)."""
    S = q.shape[0]
    s = mm(q * np.float32(SCALE), k.T).astype(np.float32)
    s[np.triu_indices(S, 1)] = -np.inf
    p = np.exp(s - s.max(-1, keepdims=True)).astype(np.float32)
    out = mm(p, v) / p.sum(-1, keepdims=True)
    return out.astype(np.float32)


@pytest.mark.parametrize("width", [32, 64, 128])
@pytest.mark.parametrize("gain", [1.0, 8.0])
def test_three_pass_tf32_holds_float32_parity(width, gain):
    rng = np.random.default_rng(width)
    S = 256
    q, k, v = (gain * rng.standard_normal((S, width))).astype(np.float32), \
        (gain * rng.standard_normal((S, width))).astype(np.float32), \
        (gain * rng.standard_normal((S, width))).astype(np.float32)
    exact = _attention(lambda a, b: (a.astype(np.float64)
                                     @ b.astype(np.float64)), q, k, v)
    tol = 2e-5 * max(1.0, float(np.abs(exact).max()))
    err3 = np.abs(_attention(mm3, q, k, v) - exact).max()
    err32 = np.abs(_attention(lambda a, b: a @ b, q, k, v) - exact).max()
    err1 = np.abs(_attention(mm1, q, k, v) - exact).max()
    assert err3 <= tol                      # the kernel's premise
    assert err3 <= 4 * err32 + 1e-7         # as good as float32 products
    assert err1 > tol                       # single-pass TF32 would miss


@pytest.mark.parametrize("width", [32, 64, 128])
def test_three_pass_tf32_products(width):
    rng = np.random.default_rng(10 + width)
    a = rng.standard_normal((64, width)).astype(np.float32)
    b = rng.standard_normal((width, 64)).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    scale = math.sqrt(width)
    assert np.abs(mm3(a, b) - exact).max() <= 2e-6 * scale
    assert np.abs(mm1(a, b) - exact).max() > 2e-5 * scale
