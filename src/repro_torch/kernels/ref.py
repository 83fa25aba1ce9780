"""Plain PyTorch versions of the attention, page-mover, Mamba scan and
RWKV-6 wkv kernels (own port of ``repro/kernels/ref.py``; DESIGN.md §4,
§9, §12, §14).

They are the semantics the CUDA kernels reproduce: the CPU path of
``kernels/ops.py`` and the target ``chip_smoke.py`` holds each kernel
to on the card.  Nothing on the main path calls them when a card is
present; each keeps a ``calls`` count so a run can show that.

One deliberate difference from the jnp oracles: the decode versions
clamp the softmax denominator at 1e-30 like the kernels, so a row with
``lengths[b] == 0`` outputs exactly 0 (the jnp oracle's all-masked
softmax gives NaN there; the Pallas kernels give 0).  For every row
with a valid position the two agree.

The decode versions compute the TPU decode kernels' function in every
compute dtype (q's): K and V arrive in their storage dtype and are
converted to the compute dtype as the reference's call sites'
``astype(x.dtype)`` converts them; the logits accumulate in float32 (in
a 16-bit compute dtype in the CUDA kernels' order, ``_chained_dots``).
In a 16-bit compute dtype the softmax is the kernels' online one, over
their blocks of positions (``decode_block``; one page paged): each
``p = exp(logit - m)``, m the running max over the blocks so far, is
rounded to the compute dtype before P.V, ``l`` sums the unrounded p,
and the output is rounded once, to q's dtype.  In float32 that rounding
is the identity and the softmax is taken over the whole row at once.

``flash_attention_ref`` is the flash kernel's 16-bit form the same way
(the TPU kernel's 128-key blocks, its sums in the CUDA kernel's
tensor-core order); ``attention_ref`` stays its float32 form's, and the
training forward's plain attention in every dtype.  ``window_attention_ref``
is the window kernel's: the reference's XLA attention over a cache window
in a 16-bit dtype (logits and the normalised p rounded to it), its sums
in that kernel's order.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

# the TPU decode kernels' block of positions over a dense cache
# (``repro/kernels/ops.py``: ``block_t=256``, at least 8)
DENSE_BLOCK = 256


def decode_block(capacity: int) -> int:
    """Positions per online-softmax block of a dense cache of
    ``capacity`` positions: one block up to ``DENSE_BLOCK``, else blocks
    of ``DENSE_BLOCK``."""
    return capacity if capacity <= DENSE_BLOCK else DENSE_BLOCK


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  scale: float, causal: bool = True) -> torch.Tensor:
    """GQA attention with asymmetric head widths (dq != dv allowed).

    q: (B, S, H, dq);  k: (B, T, KV, dq);  v: (B, T, KV, dv)
    -> (B, S, H, dv).  Causal queries align to the END of the key range
    (query i sits at position ``T - S + i``).
    """
    attention_ref.calls += 1
    B, S, H, dq = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, S, KV, G, dq)
    logits = torch.einsum("bskgq,btkq->bkgst", qg, k).float() * scale
    if causal:
        qi = torch.arange(S, device=q.device)[:, None] + (T - S)
        mask = qi >= torch.arange(T, device=q.device)[None, :]
        logits = logits.masked_fill(~mask, float("-inf"))
    p = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkv->bskgv", p, v)
    return out.reshape(B, S, H, v.shape[-1])


attention_ref.calls = 0

# the TPU flash kernel's key block (``repro/kernels/ops.py``: ``block_k``
# 128, at least 8): its online softmax takes one running max per block
FLASH_BLOCK = 128
# query rows the plain flash version takes at a time (its memory bound)
FLASH_ROWS = 128
# the tensor cores' product: m16n8k16 (csrc/clover_attention.cu, 16-bit
# form), terms below 2^(emax - MMA_DROP) dropped (see ``_mma_chain``)
MMA_K = 16
MMA_DROP = 25


def _floor_log2(x: torch.Tensor) -> torch.Tensor:
    """floor(log2 |x|) of each nonzero element (int32), -2^20 at 0."""
    e = torch.frexp(x)[1] - 1
    return torch.where(x == 0, torch.full_like(e, -(1 << 20)), e)


def _mma_chain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as a chain of the H100 tensor cores' m16n8k16 products on
    16-bit operands with a float32 accumulator: a (..., M, K) and b (...,
    K, N) hold bfloat16 or float16 values (in any float dtype), K is
    walked in steps of MMA_K from 0 (the last zero-padded), the
    accumulator starts at 0.  One step, as measured on an H100
    (``chip_mma_probe.py``: all 655,360 outputs a dtype, chains of one and
    two steps on unit, positive, wide-exponent, zero-holding and tiny
    inputs, float16 subnormals included): the 16 products (exact) and the
    accumulator c are aligned to emax, the largest of the products'
    exponent sums e_a + e_b and c's exponent; each is truncated toward 0 to
    a multiple of 2^(emax - MMA_DROP); their exact sum is rounded toward 0
    to float32.  -> (..., M, N) float32."""
    K = a.shape[-1]
    a, b = a.float(), b.float()
    # a zero operand's exponent (-2^20) keeps its product out of the max
    ea, eb = _floor_log2(a), _floor_log2(b)
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float64,
                      device=a.device)
    for k0 in range(0, K, MMA_K):
        ak, bk = a[..., k0:k0 + MMA_K], b[..., k0:k0 + MMA_K, :]
        e = ea[..., k0:k0 + MMA_K, None] + eb[..., None, k0:k0 + MMA_K, :]
        emax = torch.maximum(e.amax(dim=-2), _floor_log2(acc))
        del e
        # (q >= 2^-149, float32's least: every term is a multiple of it)
        q = torch.exp2((emax.clamp_min(-124) - MMA_DROP).float())
        # a product (exact in float32) over q is below 2^27 and keeps its
        # bits: its truncation is exact, an int32, and their sum an int64
        ints = torch.trunc(ak[..., :, None] * bk[..., None, :, :]
                           / q[..., None, :]).int().sum(dim=-2)
        qd = q.double()
        exact = (ints.double() + torch.trunc(acc / qd)) * qd
        f = exact.float()
        f = torch.where(f.double().abs() > exact.abs(),
                        torch.nextafter(f, torch.zeros_like(f)), f)
        acc = f.double()
    return acc.float()


def _kernel_sum(p: torch.Tensor) -> torch.Tensor:
    """The sum over the last axis (FLASH_BLOCK float32 values) in the 16-bit
    kernel's order: lane t of a quad adds keys 8 n + 2 t and 8 n + 2 t + 1
    for n = 0, 1, ... in turn, then the quad's four sums meet as (s0 + s1)
    + (s2 + s3)."""
    lanes = p.reshape(*p.shape[:-1], -1, 4, 2).transpose(-3, -2)
    lanes = lanes.reshape(*p.shape[:-1], 4, -1)
    s = torch.zeros_like(lanes[..., 0])
    for i in range(lanes.shape[-1]):
        s = s + lanes[..., i]
    return (s[..., 0] + s[..., 1]) + (s[..., 2] + s[..., 3])


def _check16(q, k, v, form: str) -> None:
    if q.dtype not in (torch.bfloat16, torch.float16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q {q.dtype}, k {k.dtype}, v {v.dtype}: the {form} "
                        "takes q, K and V in one of bfloat16, float16")


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, scale: float) -> torch.Tensor:
    """``attention_ref`` (causal) as the TPU flash kernel computes it in a
    16-bit dtype: q, K and V in one bfloat16 or float16 dtype; each logit
    ``dot * scale`` in float32; an online softmax over key blocks of
    ``FLASH_BLOCK`` from key 0 (one block of T when T <= FLASH_BLOCK),
    each block's p = exp(logit - m), m the row's running max through the
    block, rounded to V's dtype before P.V while ``l`` sums the unrounded
    p; acc = acc * alpha + P.V and l = l * alpha + sum(p) per block, alpha
    = exp(m_prev - m); the output acc / max(l, 1e-30) rounded once to q's
    dtype.

    The sums are the CUDA kernel's: both products as its chains of
    tensor-core steps (``_mma_chain``; a block's P.V from a zero
    accumulator), ``l``'s block sums in its lanes' order
    (``_kernel_sum``); products of 16-bit values are exact.  A 16-bit p
    rounds differently under a logit one float32 ulp off, so the order is
    part of what the kernel must reproduce (the TPU's own order is its
    matrix unit's; float32 sums in other orders meet the tolerance on the
    CPU, ``tests/test_torch_attention_16bit.py``).

    q: (B, S, H, dq);  k: (B, T, KV, dq);  v: (B, T, KV, dv) -> (B, S, H,
    dv); query i at position ``T - S + i``."""
    _check16(q, k, v, "16-bit form")
    flash_attention_ref.calls += 1
    B, S, H, dq = q.shape
    T, KV = k.shape[1], k.shape[2]
    G, dv = H // KV, v.shape[-1]
    blk = min(T, FLASH_BLOCK)
    qg = q.reshape(B, S, KV, G, dq).permute(0, 2, 3, 1, 4).float()
    kt = k.permute(0, 2, 3, 1).float()[:, :, None]       # (B, KV, 1, dq, T)
    vt = v.permute(0, 2, 1, 3).float()[:, :, None]       # (B, KV, 1, T, dv)
    out = torch.empty((B, KV, G, S, dv), dtype=q.dtype, device=q.device)
    for r0 in range(0, S, FLASH_ROWS):
        r1 = min(S, r0 + FLASH_ROWS)
        t_end = T - S + r1                   # keys the tile's rows see
        nb = -(-t_end // blk)
        tp = nb * blk
        logits = _mma_chain(qg[..., r0:r1, :], kt[..., :t_end]) * scale
        pos = (T - S + torch.arange(r0, r1, device=q.device))[:, None]
        logits = logits.masked_fill(
            pos < torch.arange(t_end, device=q.device)[None, :],
            float("-inf"))
        lb = F.pad(logits, (0, tp - t_end), value=float("-inf")).reshape(
            *logits.shape[:-1], nb, blk)
        # every row sees key 0, so the running max is finite from block 0
        run = lb.amax(dim=-1).cummax(dim=-1).values       # (.., rows, nb)
        p = torch.exp(lb - run[..., None])
        # the kernel's tiles of FLASH_BLOCK keys (T < FLASH_BLOCK: zeros)
        p = F.pad(p, (0, FLASH_BLOCK - blk))
        p16 = p.to(v.dtype).float()
        vb = F.pad(vt[..., :t_end, :], (0, 0, 0, tp - t_end))
        acc = torch.zeros(p.shape[:-2] + (dv,), dtype=torch.float32,
                          device=q.device)
        l = torch.zeros_like(run[..., 0])
        m_prev = torch.full_like(l, float("-inf"))
        for j in range(nb):
            alpha = torch.exp(m_prev - run[..., j])
            l = alpha * l + _kernel_sum(p[..., j, :])
            pv = _mma_chain(p16[..., j, :blk], vb[..., j * blk:(j + 1) * blk,
                                                  :])
            acc = acc * alpha[..., None] + pv
            m_prev = run[..., j]
        out[..., r0:r1, :] = (acc / l.clamp_min(1e-30)[..., None]).to(
            q.dtype)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, dv)


flash_attention_ref.calls = 0


def window_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, scale: float, scale_first: bool) -> torch.Tensor:
    """Causal attention over a cache window as the reference's XLA
    attention computes it in a 16-bit dtype (``_causal_attention_chunked``
    beyond ``ATTN_CHUNK`` queries, the masked path within), in the window
    kernel's order of sums: q, K and V in one bfloat16 or float16 dtype;
    each logit ``x = dot(q, k)`` rounded to that dtype, then scaled: in
    float32 after the cast (``scale_first=False``, the chunked path), or
    by the scale rounded to the dtype, the product rounded again, before
    it (``scale_first=True``, the masked path); a softmax over the whole
    row, ``p = exp(x - m) / l`` with m the row's max, rounded to V's dtype
    before P.V; the output rounded once.

    The kernel's order: ``l`` accumulates online over key tiles of
    ``FLASH_BLOCK`` from key 0 (``l = alpha l + sum(exp(x - m_run))`` per
    tile, alpha = exp(m_prev - m_run), the tile's sum in its lanes' order,
    ``_kernel_sum``); both products are its tensor-core chains
    (``_mma_chain``), P.V a chain a tile from zero, the tiles' sums added
    in key order.

    q: (B, S, H, dq);  k: (B, T, KV, dq);  v: (B, T, KV, dv) -> (B, S, H,
    dv); query i at position ``T - S + i``."""
    _check16(q, k, v, "window form")
    window_attention_ref.calls += 1
    B, S, H, dq = q.shape
    T, KV = k.shape[1], k.shape[2]
    G, dv, dt = H // KV, v.shape[-1], q.dtype
    blk = FLASH_BLOCK
    # the reference multiplies a 16-bit array by the scale in its dtype
    s16 = torch.tensor(scale, dtype=dt).item()
    qg = q.reshape(B, S, KV, G, dq).permute(0, 2, 3, 1, 4).float()
    kt = k.permute(0, 2, 3, 1).float()[:, :, None]       # (B, KV, 1, dq, T)
    vt = v.permute(0, 2, 1, 3).float()[:, :, None]       # (B, KV, 1, T, dv)
    out = torch.empty((B, KV, G, S, dv), dtype=dt, device=q.device)
    for r0 in range(0, S, FLASH_ROWS):
        r1 = min(S, r0 + FLASH_ROWS)
        t_end = T - S + r1                   # keys the tile's rows see
        nb = -(-t_end // blk)
        x = _mma_chain(qg[..., r0:r1, :], kt[..., :t_end]).to(dt).float()
        logits = (x * s16).to(dt).float() if scale_first else x * scale
        pos = (T - S + torch.arange(r0, r1, device=q.device))[:, None]
        logits = logits.masked_fill(
            pos < torch.arange(t_end, device=q.device)[None, :],
            float("-inf"))
        lb = F.pad(logits, (0, nb * blk - t_end),
                   value=float("-inf")).reshape(*logits.shape[:-1], nb, blk)
        del x, logits
        # every row sees key 0, so the running max is finite from tile 0
        run = lb.amax(dim=-1).cummax(dim=-1).values       # (.., rows, nb)
        l = torch.zeros_like(run[..., 0])
        m_prev = torch.full_like(l, float("-inf"))
        for j in range(nb):
            alpha = torch.exp(m_prev - run[..., j])
            l = alpha * l + _kernel_sum(torch.exp(lb[..., j, :]
                                                  - run[..., j, None]))
            m_prev = run[..., j]
        p = (torch.exp(lb - m_prev[..., None, None])
             / l[..., None, None]).to(v.dtype).float()
        vb = F.pad(vt[..., :t_end, :], (0, 0, 0, nb * blk - t_end))
        acc = torch.zeros(p.shape[:-2] + (dv,), dtype=torch.float32,
                          device=q.device)
        for j in range(nb):
            acc = acc + _mma_chain(p[..., j, :],
                                   vb[..., j * blk:(j + 1) * blk, :])
        out[..., r0:r1, :] = acc.to(dt)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, dv)


window_attention_ref.calls = 0


def _masked_softmax_av(logits: torch.Tensor, mask: torch.Tensor,
                       v: torch.Tensor, lse: bool = False):
    """softmax(logits | mask) @ v with the kernels' clamped denominator.
    logits (B, KV, G, T) f32, mask (B, T) bool, v (B, T, KV, dv).  With
    ``lse`` also the (B, KV, G) log-sum-exp of the logits under the mask
    (-inf where the mask is empty)."""
    logits = logits.masked_fill(~mask[:, None, None, :], float("-inf"))
    m = logits.amax(dim=-1, keepdim=True).clamp_min(-1e30)
    p = torch.exp(logits - m)
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bkgt,btkv->bkgv", p.to(v.dtype), v) / denom
    if not lse:
        return out
    total = p.sum(dim=-1)
    return out, torch.where(total > 0, m[..., 0] + torch.log(total),
                            float("-inf"))


def _blocked_softmax_av(logits: torch.Tensor, mask: torch.Tensor,
                        v: torch.Tensor, block: int, lse: bool = False):
    """``_masked_softmax_av`` as the TPU kernels compute it in v's 16-bit
    dtype: an online softmax over blocks of ``block`` positions, each
    block's p relative to the running max through it and rounded to v's
    dtype before P.V; float32 sums, each block's weighed by exp(its max
    - the row's)."""
    B, KV, G, T = logits.shape
    nb = -(-T // block)
    pad = nb * block - T
    logits = logits.masked_fill(~mask[:, None, None, :], float("-inf"))
    lb = F.pad(logits, (0, pad), value=float("-inf")).reshape(
        B, KV, G, nb, block)
    run = lb.amax(dim=-1).cummax(dim=-1).values.clamp_min(-1e30)
    p = torch.exp(lb - run[..., None])
    vb = F.pad(v, (0, 0, 0, 0, 0, pad)).reshape(B, nb, block, KV, -1)
    m = run[..., -1]
    w = torch.exp(run - m[..., None])                # (B, KV, G, nb)
    total = (p.sum(dim=-1) * w).sum(dim=-1)
    acc = torch.einsum("bkgjt,bjtkv->bkgjv", p.to(v.dtype).float(),
                       vb.float())
    out = (acc * w[..., None]).sum(dim=-2) / total.clamp_min(
        1e-30)[..., None]
    if not lse:
        return out
    return out, torch.where(total > 0, m + torch.log(total), float("-inf"))


def _rank_mask(x: torch.Tensor, ranks) -> torch.Tensor:
    """Zero dims >= ranks[kv] of a (..., KV, d) array: exact rank
    truncation under a non-uniform per-head plan (DESIGN.md §14).  The
    CUDA kernels skip those dims per dimension too; the reference's TPU
    kernels skip whole ``rank_block``-wide blocks, which agrees whenever
    ranks are block multiples or the data obeys the ``mask_head_ranks``
    zero-pad convention."""
    if ranks is None:
        return x
    d = x.shape[-1]
    r = torch.as_tensor(ranks, device=x.device).long().clamp(max=d)
    keep = torch.arange(d, device=x.device)[None, :] < r[:, None]  # (KV, d)
    return torch.where(keep, x, torch.zeros((), dtype=x.dtype,
                                             device=x.device))


def _chained_dots(qg: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """(B, KV, G, T) float32 dot products of qg (B, KV, G, d) with k (B,
    T, KV, d), both holding 16-bit values (so every product is exact),
    summed in the kernels' order: column by column, in four chains by
    column mod 4 joined as (c0 + c1) + (c2 + c3) when G == 1.  A 16-bit
    p rounds differently under a logit one float32 ulp off, so the order
    is part of what the kernels must reproduce."""
    prods = qg[..., None, :] * k.permute(0, 2, 1, 3)[:, :, None]
    G, d = qg.shape[2], qg.shape[3]
    n = 4 if G == 1 else 1
    chains = [torch.zeros(prods.shape[:-1], dtype=torch.float32,
                          device=qg.device) for _ in range(n)]
    for c in range(d):
        chains[c % n] = chains[c % n] + prods[..., c]
    if n == 1:
        return chains[0]
    return (chains[0] + chains[1]) + (chains[2] + chains[3])


def _decode(q, k, v, lengths, scale, block, qk_ranks=None, vo_ranks=None,
            return_lse=False):
    # the reference's astype(x.dtype) of the cache
    k = _rank_mask(k.to(q.dtype), qk_ranks)
    v = _rank_mask(v.to(q.dtype), vo_ranks)
    B, H, dq = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, dq)
    half = q.dtype in (torch.bfloat16, torch.float16)
    if half:
        logits = _chained_dots(qg.float(), k.float()) * scale
    else:
        logits = torch.einsum("bkgq,btkq->bkgt", qg, k).float() * scale
    mask = (torch.arange(T, device=q.device)[None, :]
            < lengths.to(q.device).long()[:, None])
    if half:
        res = _blocked_softmax_av(logits, mask, v, block, lse=return_lse)
    else:
        res = _masked_softmax_av(logits, mask, v, lse=return_lse)
    out, lse = res if return_lse else (res, None)
    out = out.reshape(B, H, v.shape[-1]).to(q.dtype)
    return (out, lse.reshape(B, H)) if return_lse else out


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         lengths: torch.Tensor, *, scale: float,
                         qk_ranks: Optional[torch.Tensor] = None,
                         vo_ranks: Optional[torch.Tensor] = None,
                         return_lse: bool = False):
    """Single-token flash-decoding.

    q: (B, H, dq) in the compute dtype;  k: (B, T, KV, dq);  v: (B, T,
    KV, dv), both in one storage dtype;  lengths: (B,) int — positions
    >= length are masked.
    qk_ranks / vo_ranks: optional (KV,) int per-head kept ranks: K dims
    >= qk_ranks[kv] and V dims >= vo_ranks[kv] are zeroed (a zeroed K
    dim kills its logit term; a zeroed V dim zeros that output dim).
    -> (B, H, dv) in q's dtype; with ``return_lse`` also the (B, H)
    float32 log-sum-exp of the scaled logits over each row's lengths
    (-inf at length 0), as ``flash_decode(return_lse=True)`` returns it.
    """
    decode_attention_ref.calls += 1
    return _decode(q, k, v, lengths, scale, decode_block(k.shape[1]),
                   qk_ranks, vo_ranks, return_lse)


decode_attention_ref.calls = 0


def verify_decode_attention_ref(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, lengths: torch.Tensor, *,
                                scale: float) -> torch.Tensor:
    """Speculative-VERIFY oracle: a W-token window of queries against a
    per-slot cache (the multi-token form of ``decode_attention_ref``;
    W == 1 reduces to it).

    q: (B, W, H, dq);  k: (B, T, KV, dq);  v: (B, T, KV, dv);
    lengths: (B,) int -- the TOTAL valid cache length per row, window
    included: query j of row b sits at position ``lengths[b] - W + j``
    and attends to cache positions <= its own.  Cache contents past
    ``lengths[b]`` (K/V of draft tokens rejected and rolled back) never
    count.  -> (B, W, H, dv)
    """
    verify_decode_attention_ref.calls += 1
    B, W, H, dq = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, W, KV, G, dq)
    logits = torch.einsum("bskgq,btkq->bkgst", qg, k).float() * scale
    qpos = (lengths.to(q.device).long()[:, None] - W
            + torch.arange(W, device=q.device)[None, :])          # (B, W)
    mask = (torch.arange(T, device=q.device)[None, None, :]
            <= qpos[:, :, None])                                   # (B, W, T)
    logits = logits.masked_fill(~mask[:, None, None], float("-inf"))
    p = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkv->bskgv", p, v)
    return out.reshape(B, W, H, v.shape[-1])


verify_decode_attention_ref.calls = 0


def paged_decode_attention_ref(q: torch.Tensor, k_pool: torch.Tensor,
                               v_pool: torch.Tensor,
                               page_table: torch.Tensor,
                               lengths: torch.Tensor, *, scale: float,
                               qk_ranks: Optional[torch.Tensor] = None,
                               vo_ranks: Optional[torch.Tensor] = None,
                               ) -> torch.Tensor:
    """Paged flash-decoding: gather each slot's pages into a dense cache
    through the page table, then the dense version, one page per
    online-softmax block.

    q: (B, H, dq);  k_pool: (N, page_tokens, KV, dq);
    v_pool: (N, page_tokens, KV, dv);  page_table: (B, n_p) int;
    lengths: (B,) int;  qk_ranks / vo_ranks: optional (KV,) per-head
    kept ranks (see ``decode_attention_ref``).  Every table entry must
    be a valid pool row (the engine pads with the garbage row
    ``N - 1``).  -> (B, H, dv)
    """
    paged_decode_attention_ref.calls += 1
    B, n_p = page_table.shape
    pt = k_pool.shape[1]
    tab = page_table.long()

    def gather(pool):      # as bytes: torch indexes no float8 on the CPU
        bits = pool.view(torch.uint8) if pool.element_size() == 1 else pool
        return bits[tab].view(pool.dtype).reshape(B, n_p * pt,
                                                  *pool.shape[2:])
    return _decode(q, gather(k_pool), gather(v_pool), lengths, scale, pt,
                   qk_ranks, vo_ranks)


paged_decode_attention_ref.calls = 0


def page_copy_ref(pool: torch.Tensor, src: torch.Tensor,
                  dst: torch.Tensor) -> torch.Tensor:
    """Batched KV-page clone (copy-on-write prefix caching): row
    ``dst[i]`` of every block becomes a copy of row ``src[i]``; every
    other row is untouched.  In place; returns ``pool``.

    pool: (n_blocks, N, page_tokens, KV, r);  src, dst: (m,) int.
    Gather-then-scatter: every read sees the INPUT pool, as the
    kernel's does.  Pairs are disjoint except sentinel self-copies
    (padding), and a page may be the src of one pair and the dst of a
    LATER pair only, so this agrees with the reference's in-order row
    moves."""
    page_copy_ref.calls += 1
    pool[:, dst.long()] = pool[:, src.long()]
    return pool


page_copy_ref.calls = 0


def page_restore_ref(pool: torch.Tensor, rows: torch.Tensor,
                     dst: torch.Tensor) -> torch.Tensor:
    """Host-tier page restore: slab ``rows[:, i]`` (bytes spilled to
    host RAM, copied back) lands in pool row ``dst[i]``; every other
    row is untouched.  In place; returns ``pool``.

    pool: (n_blocks, N, page_tokens, KV, r);  rows: (n_blocks, W,
    page_tokens, KV, r);  dst: (W,) int.  Real dst entries are distinct
    pages; padding repeats the sentinel row with all-zero slabs, so
    duplicate targets receive identical bytes."""
    page_restore_ref.calls += 1
    pool[:, dst.long()] = rows.to(pool.dtype)
    return pool


page_restore_ref.calls = 0


def page_copy_leaves_ref(pools, src: torch.Tensor, dst: torch.Tensor):
    """``page_copy_ref`` on each KV leaf of a batch (the multi-leaf
    kernel's plain version): one call per batch.  -> ``pools``."""
    page_copy_leaves_ref.calls += 1
    for pool in pools:
        page_copy_ref(pool, src, dst)
    return pools


page_copy_leaves_ref.calls = 0


def page_restore_leaves_ref(pools, rows, dst: torch.Tensor):
    """``page_restore_ref`` on each KV leaf with its slabs (the
    multi-leaf kernel's plain version): one call per batch.  ->
    ``pools``."""
    page_restore_leaves_ref.calls += 1
    for pool, r in zip(pools, rows, strict=True):
        page_restore_ref(pool, r, dst)
    return pools


page_restore_leaves_ref.calls = 0


def wkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             logw: torch.Tensor, u: torch.Tensor,
             s0: Optional[torch.Tensor] = None):
    """Sequential RWKV-6 wkv oracle, float32.

    r, k, v, logw: (B, H, T, d);  u: (H, d);  s0: (B, H, d, d) or None
    (zeros).  Per step, the decay applied BEFORE the read:
        Sd = diag(exp(logw_t)) S;  o_t = r_t Sd + (r_t . (u * k_t)) v_t;
        S' = Sd + k_t v_t^T.
    -> (out (B, H, T, d), S_end (B, H, d, d)), both float32.
    """
    wkv6_ref.calls += 1
    B, H, T, d = r.shape
    rf, kf, vf, wf = (t.float() for t in (r, k, v, logw))
    uf = u.float()[None]                                     # (1, H, d)
    S = (torch.zeros((B, H, d, d), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    outs = []
    for t in range(T):
        rt, kt, vt = rf[:, :, t], kf[:, :, t], vf[:, :, t]    # (B, H, d)
        Sd = torch.exp(wf[:, :, t])[..., None] * S            # decay k-side
        o = torch.einsum("bhd,bhde->bhe", rt, Sd)
        bonus = (rt * (uf * kt)).sum(-1)
        outs.append(o + bonus[..., None] * vt)
        S = Sd + kt[..., None] * vt[..., None, :]
    out = (torch.stack(outs, dim=2) if outs
           else torch.zeros((B, H, 0, d), dtype=torch.float32,
                            device=r.device))
    return out, S


wkv6_ref.calls = 0


def mamba_scan_ref(dt: torch.Tensor, A: torch.Tensor, Bmat: torch.Tensor,
                   C: torch.Tensor, x: torch.Tensor,
                   h0: Optional[torch.Tensor] = None):
    """Sequential Mamba-1 selective-scan oracle, float32.

    dt, x: (B, S, dI);  A: (dI, dS) (positive: the decay is
    ``exp(-dt A)``);  Bmat, C: (B, S, dS);  h0: (B, dI, dS) or None
    (zeros).  Per step:
        h_t = exp(dt_t * -A) * h_{t-1} + (dt_t * x_t) B_t;  y_t = h_t . C_t.
    -> (y (B, S, dI), h_end (B, dI, dS)), both float32.
    """
    mamba_scan_ref.calls += 1
    B, S, dI = x.shape
    dS = A.shape[-1]
    dtf, xf, Bf, Cf = (t.float() for t in (dt, x, Bmat, C))
    negA = -A.float()
    h = (torch.zeros((B, dI, dS), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    ys = []
    for t in range(S):
        dt_t = dtf[:, t]                                       # (B, dI)
        a = torch.exp(dt_t[..., None] * negA[None])             # (B, dI, dS)
        b = (dt_t * xf[:, t])[..., None] * Bf[:, t, None, :]
        h = a * h + b
        ys.append(torch.einsum("bns,bs->bn", h, Cf[:, t]))
    y = (torch.stack(ys, dim=1) if ys
         else torch.zeros((B, 0, dI), dtype=torch.float32, device=x.device))
    return y, h


mamba_scan_ref.calls = 0
