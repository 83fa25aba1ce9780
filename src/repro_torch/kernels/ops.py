"""Kernel entry points: dispatch on the tensor's device (DESIGN.md §4,
§6, §10, §14).

A CUDA tensor goes to the hand-written kernel, a CPU tensor to the
plain PyTorch version in ``ref.py``.  There is no fallback: a kernel
that fails to build or launch raises.  The decode entries take
optional per-KV-head rank vectors: with neither given the unranked
kernels run unchanged; with one given the other defaults to full width
and the rank-clamped kernel runs.  (The reference's shard_map branch
arrives with tensor parallelism.)

Training is explicit: ``clover_attention``, ``wkv6`` and
``mamba_scan`` take ``plain=True`` from the training forward
(``models.transformer.train_forward``), which runs the plain version
under autograd on any device -- the reference trains through its XLA
path too (``kernel_impl="xla"``), and neither it nor the port has a
backward kernel.  A CUDA input that requires grad without ``plain``
raises, so no kernel is silently differentiated and no plain path is
silently taken.

On ``meta`` inputs (the dry-run, ``launch.dryrun``) every entry
returns outputs of the right shape and dtype without launching or
looping, and adds the kernel's FLOPs and bytes to the sink that
``kernel_costs`` installs: each input byte read once and each output
byte written once, as the kernels' bounds count them (PERF.md §2); a
decode reads every cache position, the dry-run's caches being full.
The two recurrences take their meta route under ``plain`` too, with a
backward (``_MetaScan``): the plain versions loop over every step.

The page movers update the pool leaf in place (the reference returns
a new array; its TPU kernel aliases the pool through).  ``wkv6`` and
``mamba_scan`` take the sequence length as a loop bound on the card, so
they pad nothing (the reference pads it to a chunk multiple with
state-neutral steps).
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.clover_attention import (flash_attention,
                                                  window_attention as
                                                  _window_attention)
from repro_torch.kernels.decode_attention import (flash_decode,
                                                  flash_decode_ranked)
from repro_torch.kernels.mamba_scan import mamba_scan as _mamba_scan
from repro_torch.kernels.page_copy import page_copy as _page_copy
from repro_torch.kernels.page_copy import (page_copy_leaves as
                                           _page_copy_leaves)
from repro_torch.kernels.page_copy import page_restore as _page_restore
from repro_torch.kernels.page_copy import (page_restore_leaves as
                                           _page_restore_leaves)
from repro_torch.kernels.paged_decode_attention import (
    paged_flash_decode, paged_flash_decode_ranked)
from repro_torch.kernels.wkv6 import wkv6 as _wkv6


# each kernel wrapper counts its launches where it launches, each plain
# version its calls
_WRAPPERS = (flash_attention, flash_decode, paged_flash_decode, _page_copy,
             _page_restore, flash_decode_ranked, paged_flash_decode_ranked,
             _mamba_scan, _wkv6, _window_attention)
_PLAIN = (ref.attention_ref, ref.flash_attention_ref,
          ref.window_attention_ref,
          ref.decode_attention_ref, ref.paged_decode_attention_ref,
          ref.page_copy_ref, ref.page_restore_ref, ref.page_copy_leaves_ref,
          ref.page_restore_leaves_ref, ref.mamba_scan_ref, ref.wkv6_ref)


def launch_counts() -> dict:
    """{kernel name: launches} of this process's kernel wrappers, {plain
    version name: calls} of the plain versions, {"<name>.strided":
    strided launches} of the decode kernels (reads of ``cache[..., :r]``
    views), ``flash_decode.lse``, its launches that returned the
    log-sum-exp, and {"flash_attention.<dtype>": launches} and
    {"window_attention.<dtype>": launches} by operand dtype: what a
    process that served reports back."""
    out = {f.__name__: f.launches for f in _WRAPPERS}
    out.update({f.__name__: f.calls for f in _PLAIN})
    out.update({f"{f.__name__}.strided": f.strided_launches
                for f in _WRAPPERS if hasattr(f, "strided_launches")})
    out["flash_decode.lse"] = flash_decode.lse_launches
    for f in (flash_attention, _window_attention):
        out.update({f"{f.__name__}.{d}": n for d, n in f.forms.items()})
    return out


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no kernel for device {t.device}")
    return t.is_cuda


# the meta routes' cost sink: fn(kernel name, flops, bytes) or None
_COST_SINK = None


@contextlib.contextmanager
def kernel_costs(sink):
    """While open, each meta-route call reports ``sink(name, flops,
    bytes)``."""
    global _COST_SINK
    saved, _COST_SINK = _COST_SINK, sink
    try:
        yield
    finally:
        _COST_SINK = saved


def _is_meta(t) -> bool:
    return t is not None and t.device.type == "meta"


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def _meta(name: str, flops: float, reads, outs):
    """Report one meta-route call: ``reads`` its inputs (each read
    once), ``outs`` its outputs (each written once)."""
    if _COST_SINK is not None:
        _COST_SINK(name, float(flops), _nbytes(*reads) + _nbytes(*outs))
    return outs


def _empty(shape, like, dtype=torch.float32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=like.device)


class _MetaScan(torch.autograd.Function):
    """A recurrence's meta route, differentiable: the training forward
    takes it too (its plain version would loop over every time step).
    The backward reports twice the forward's FLOPs (the recurrence run
    backwards, its products twice) and its bytes: the output gradients
    and the inputs read, the input gradients written."""

    @staticmethod
    def forward(ctx, name, flops, shapes, *inputs):
        ctx.name, ctx.flops = name, flops
        ctx.like = [None if t is None else (t.shape, t.dtype)
                    for t in inputs]
        ctx.in_bytes = _nbytes(*inputs)
        outs = tuple(torch.empty(sh, dtype=torch.float32, device="meta")
                     for sh in shapes)
        return _meta(name, flops, inputs, outs)

    @staticmethod
    def backward(ctx, *grads):
        dx = tuple(None if like is None else
                   torch.empty(like[0], dtype=like[1], device="meta")
                   for like in ctx.like)
        if _COST_SINK is not None:
            _COST_SINK(ctx.name + ".backward", 2.0 * ctx.flops,
                       _nbytes(*grads) + 2 * ctx.in_bytes)
        return (None, None, None) + dx


def _kernel(name: str, *inputs) -> bool:
    """True: launch the CUDA kernel; False: run the plain version (CPU
    inputs).  Raises on CUDA inputs that require grad: the kernels have
    no backward, and training asks for the plain version explicitly."""
    if not _on_cuda(inputs[0]):
        return False
    if any(t is not None and t.requires_grad for t in inputs):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward; the training "
            "forward passes plain=True (the reference trains through its "
            "XLA path as well)")
    return True


def _causal_pairs(B: int, S: int, H: int, T: int) -> int:
    """(query, key) pairs a causal pass of S queries ending T keys
    scores."""
    return B * H * (S * (T - S) + S * (S + 1) // 2)


def clover_attention(q, k, v, *, scale: float,
                     plain: bool = False) -> torch.Tensor:
    """Causal GQA attention with asymmetric head widths.
    q (B,S,H,dq), k (B,T,KV,dq), v (B,T,KV,dv) -> (B,S,H,dv) in q's
    dtype: all three in float32, or all in one 16-bit dtype (the TPU
    kernel's blockwise function, ``ref.flash_attention_ref``).
    ``plain``: the float32-softmax plain version on any device
    (training, as the reference's XLA attention)."""
    if not plain and _is_meta(q):
        B, S, H, dq = q.shape
        T, dv = k.shape[1], v.shape[-1]
        return _meta("flash_attention",
                     _causal_pairs(B, S, H, T) * 2 * (dq + dv), (q, k, v),
                     (_empty((B, S, H, dv), q),))[0]
    if not plain and _kernel("clover_attention", q, k, v):
        return flash_attention(q, k, v, scale=scale)
    if not plain and q.dtype in (torch.bfloat16, torch.float16):
        return ref.flash_attention_ref(q, k, v, scale=scale)
    return ref.attention_ref(q, k, v, scale=scale, causal=True)


def window_attention(q, k, v, *, scale: float,
                     scale_first: bool) -> torch.Tensor:
    """Causal attention over a cache window in a 16-bit compute dtype, the
    reference's XLA attention there (``ref.window_attention_ref``): q (B,
    S, H, dq), k (B, T, KV, dq), v (B, T, KV, dv), all in one of bfloat16,
    float16; k / v may be strided views of the cache.  ``scale_first``:
    the reference's masked path (S <= ATTN_CHUNK), else its chunked one.
    -> (B, S, H, dv) in q's dtype.  The meta route reports the kernel's
    work: two Q.K sweeps (the row's max and sum, then p) and one P.V."""
    if _is_meta(q):
        B, S, H, dq = q.shape
        T, dv = k.shape[1], v.shape[-1]
        return _meta("window_attention",
                     _causal_pairs(B, S, H, T) * 2 * (2 * dq + dv),
                     (q, k, v), (_empty((B, S, H, dv), q, q.dtype),))[0]
    if _kernel("window_attention", q, k, v):
        return _window_attention(q, k, v, scale=scale,
                                 scale_first=scale_first)
    return ref.window_attention_ref(q, k, v, scale=scale,
                                    scale_first=scale_first)


def _int32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32).contiguous()   # no copy if it already is


def _rank_vectors(qk_ranks, vo_ranks, KV: int, dq: int, dv: int, device):
    """Both (KV,) int32 rank vectors for a ranked kernel; a missing one
    is full width."""
    def full(r, d):
        if r is None:
            return torch.full((KV,), d, dtype=torch.int32, device=device)
        return _int32(r)
    return full(qk_ranks, dq), full(vo_ranks, dv)


def decode_attention(q, k, v, lengths, *, scale: float, qk_ranks=None,
                     vo_ranks=None, return_lse: bool = False):
    """Flash-decoding vs a dense (CLOVER-rank) cache.
    q (B,H,dq), k (B,T,KV,dq), v (B,T,KV,dv), lengths (B,) -> (B,H,dv).
    k / v may be ``cache[..., :r]`` views of a wider cache (the draft's
    sliced ranks, DESIGN.md §8): the kernel reads them through the
    cache's row stride.  qk_ranks / vo_ranks: optional (KV,) per-head
    kept ranks (a non-uniform ``RankBudget`` plan, DESIGN.md §14).
    ``return_lse`` (unranked only): also the (B, H) float32 log-sum-exp
    of the scaled logits over each row's lengths.  q in a compute dtype
    (float32, bfloat16, float16), k / v in one KV cache dtype, read as
    they lie; the context comes in q's dtype."""
    ranked = qk_ranks is not None or vo_ranks is not None
    if return_lse and ranked:
        raise ValueError("return_lse is the unranked kernel's output")
    if _is_meta(q):
        B, H, dq = q.shape
        T, dv = k.shape[1], v.shape[-1]
        outs = (_empty((B, H, dv), q, q.dtype),) + (
            (_empty((B, H), q),) if return_lse else ())
        outs = _meta("flash_decode_ranked" if ranked else "flash_decode",
                     B * T * H * 2 * (dq + dv), (q, k, v, lengths), outs)
        return outs if return_lse else outs[0]
    if not _on_cuda(q):
        return ref.decode_attention_ref(q, k, v, lengths, scale=scale,
                                        qk_ranks=qk_ranks,
                                        vo_ranks=vo_ranks,
                                        return_lse=return_lse)
    if not ranked:
        return flash_decode(q, k, v, _int32(lengths), scale=scale,
                            return_lse=return_lse)
    qk, vo = _rank_vectors(qk_ranks, vo_ranks, k.shape[2], q.shape[-1],
                           v.shape[-1], q.device)
    return flash_decode_ranked(q, k, v, _int32(lengths), qk, vo,
                               scale=scale)


def paged_decode_attention(q, k_pool, v_pool, page_table, lengths, *,
                           scale: float, qk_ranks=None,
                           vo_ranks=None) -> torch.Tensor:
    """Flash-decoding vs the paged pool.  q (B,H,dq), k_pool
    (N,pt,KV,dq), v_pool (N,pt,KV,dv), page_table (B,n_p), lengths (B,)
    -> (B,H,dv).  Strided pool views and qk_ranks / vo_ranks as in
    ``decode_attention``."""
    if _is_meta(q):
        B, H, dq = q.shape
        n_p, pt, KV = page_table.shape[1], k_pool.shape[1], k_pool.shape[2]
        dv = v_pool.shape[-1]
        T = n_p * pt
        read = B * T * KV * (dq + dv) * k_pool.element_size()
        name = ("paged_flash_decode" if qk_ranks is None and vo_ranks is None
                else "paged_flash_decode_ranked")
        out = _empty((B, H, dv), q, q.dtype)
        if _COST_SINK is not None:
            _COST_SINK(name, float(B * T * H * 2 * (dq + dv)),
                       read + _nbytes(q, page_table, lengths, out))
        return out
    if not _on_cuda(q):
        return ref.paged_decode_attention_ref(
            q, k_pool, v_pool, page_table, lengths, scale=scale,
            qk_ranks=qk_ranks, vo_ranks=vo_ranks)
    if qk_ranks is None and vo_ranks is None:
        return paged_flash_decode(q, k_pool, v_pool, _int32(page_table),
                                  _int32(lengths), scale=scale)
    qk, vo = _rank_vectors(qk_ranks, vo_ranks, k_pool.shape[2],
                           q.shape[-1], v_pool.shape[-1], q.device)
    return paged_flash_decode_ranked(q, k_pool, v_pool, _int32(page_table),
                                     _int32(lengths), qk, vo, scale=scale)


def _copy_bytes(pool, m: int) -> int:
    """A copy's bytes in one leaf: each pair's rows read and written."""
    return 2 * pool[:, 0].numel() * pool.element_size() * m


def page_copy(pool, src, dst) -> torch.Tensor:
    """Batched KV-page clone backing copy-on-write (DESIGN.md §9).
    pool (n_blocks, N, page_tokens, KV, r), src/dst (m,) pool-row ids
    -> pool with row ``dst[i]`` a copy of row ``src[i]``, in place."""
    if _is_meta(pool):
        if _COST_SINK is not None:
            _COST_SINK("page_copy", 0.0, _copy_bytes(pool, src.shape[0])
                       + _nbytes(src, dst))
        return pool
    if _on_cuda(pool):
        return _page_copy(pool, _int32(src), _int32(dst))
    return ref.page_copy_ref(pool, src, dst)


def page_copy_leaves(pools, src, dst):
    """``page_copy`` over every KV leaf of a batch (one N), one launch.
    The meta route reports the bytes of one ``page_copy`` per leaf, in
    one report.  -> ``pools``, updated in place."""
    pools = list(pools)
    if _is_meta(pools[0]):
        if _COST_SINK is not None:
            _COST_SINK("page_copy", 0.0, sum(
                _copy_bytes(p, src.shape[0]) + _nbytes(src, dst)
                for p in pools))
        return pools
    if _on_cuda(pools[0]):
        return _page_copy_leaves(pools, _int32(src), _int32(dst))
    return ref.page_copy_leaves_ref(pools, src, dst)


def page_restore(pool, rows, dst) -> torch.Tensor:
    """Host-tier restore scatter (DESIGN.md §12).  pool (n_blocks, N,
    page_tokens, KV, r), rows (n_blocks, W, page_tokens, KV, r) on the
    pool's device, dst (W,) pool-row ids -> pool with row ``dst[i]``
    holding ``rows[:, i]``, in place."""
    if _is_meta(pool):
        _meta("page_restore", 0, (rows, dst), (rows,))
        return pool
    if _on_cuda(pool):
        return _page_restore(pool, rows, _int32(dst))
    return ref.page_restore_ref(pool, rows, dst)


def page_restore_leaves(pools, rows, dst):
    """``page_restore`` over every KV leaf of a batch, ``rows[j]`` the
    slabs of ``pools[j]``, one launch.  The meta route reports the bytes
    of one ``page_restore`` per leaf, in one report.  -> ``pools``,
    updated in place."""
    pools, rows = list(pools), list(rows)
    if _is_meta(pools[0]):
        if _COST_SINK is not None:
            _COST_SINK("page_restore", 0.0, sum(
                2 * _nbytes(r) + _nbytes(dst) for r in rows))
        return pools
    if _on_cuda(pools[0]):
        return _page_restore_leaves(pools, rows, _int32(dst))
    return ref.page_restore_leaves_ref(pools, rows, dst)


def wkv6(r, k, v, logw, u, s0=None, *, plain: bool = False):
    """RWKV-6 wkv recurrence (the time-mix core of the rwkv family).
    r, k, v, logw (B, H, T, d), u (H, d), s0 (B, H, d, d) or None
    (zeros) -> (out (B, H, T, d), S_end (B, H, d, d)), float32; ``s0``
    is not modified.  ``plain``: the plain version (training)."""
    if _is_meta(r):
        B, H, T, d = r.shape
        return _MetaScan.apply("wkv6", B * H * T * (5 * d * d + 6 * d),
                               ((B, H, T, d), (B, H, d, d)),
                               r, k, v, logw, u, s0)
    if not plain and _kernel("wkv6", r, k, v, logw, u, s0):
        return _wkv6(r, k, v, logw, u, s0)
    return ref.wkv6_ref(r, k, v, logw, u, s0)


def mamba_scan(dt, A, Bmat, C, x, h0=None, *, plain: bool = False):
    """Mamba-1 selective scan (the SSM core of the jamba family).
    dt, x (B, S, dI), A (dI, dS) positive, Bmat, C (B, S, dS), h0 (B,
    dI, dS) or None (zeros) -> (y (B, S, dI), h_end (B, dI, dS)),
    float32; ``h0`` is not modified.  ``plain``: the plain version
    (training)."""
    if _is_meta(x):
        B, S, dI = x.shape
        dS = A.shape[-1]
        return _MetaScan.apply("mamba_scan", 5 * B * S * dI * dS,
                               ((B, S, dI), (B, dI, dS)),
                               dt, A, Bmat, C, x, h0)
    if not plain and _kernel("mamba_scan", x, dt, A, Bmat, C, h0):
        return _mamba_scan(dt, A, Bmat, C, x, h0)
    return ref.mamba_scan_ref(dt, A, Bmat, C, x, h0)
