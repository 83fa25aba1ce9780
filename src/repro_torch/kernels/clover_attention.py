"""Causal flash attention for CLOVER-pruned heads (DESIGN.md §4): the
wrapper of the CUDA kernel in ``csrc/clover_attention.cu``.

Replaces ``repro/kernels/clover_attention.py: flash_attention``: GQA,
asymmetric head widths (dq != dv), queries aligned to the end of the
key range (``q_offset = T - S``), key tiles above the causal diagonal
skipped.  The kernel bounds its loop by the true ``T``, so no padding
is needed; the head widths are zero-padded on chip to the bucket
``width_bucket`` picks.

Two forms, chosen by the operands' dtype (q, K and V in one dtype; the
output in it):

* float32: both products on the tensor cores in 3xTF32 (float32
  accuracy), the softmax over the whole row, ``ref.attention_ref``'s
  function.
* bfloat16 or float16: the TPU kernel's function in that dtype
  (``ref.flash_attention_ref``): both products on the tensor cores at
  the operands' dtype with float32 accumulators, an online softmax over
  the TPU's 128-key blocks, each p rounded to V's dtype against the
  row's running max through its block.

Any other dtype, or mixed dtypes, raise ``TypeError``: nothing is cast.
``launches`` counts every launch, ``forms`` the launches by dtype.

``window_attention`` is a third form, for the cache windows (a long
cached prefill, a sequence-split cache), where the reference runs XLA
attention, not its Pallas kernel (``ref.window_attention_ref``): q, K and
V in one 16-bit dtype, the logits rounded to it, the softmax over the
whole row, the normalised p rounded to V's dtype before P.V.  K and V
may be strided views of a cache (``cache[:, :end, :, :d]``): the kernel
reads them through their batch, position and head strides.  It keeps
its own ``launches`` and ``forms``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

MAX_WIDTH = 256     # dq, dv the kernel's shared-memory plan accepts
WIDTH_BUCKETS = (32, 64, 128, 256)   # the kernel's compile-time widths
# operand dtype -> the kernel's dtype code (csrc/clover_attention.cu)
FORM_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def width_bucket(dq: int, dv: int) -> int:
    """The smallest compiled width that holds both head widths."""
    return next(w for w in WIDTH_BUCKETS if w >= max(dq, dv))


def check_dtypes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """q, K and V in one of ``FORM_CODES``' dtypes (raise ``TypeError``
    on anything else; nothing is cast)."""
    if q.dtype not in FORM_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"q {q.dtype}, k {k.dtype}, v {v.dtype}: the kernel takes q, K "
            f"and V in one of {', '.join(map(str, FORM_CODES))}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float) -> torch.Tensor:
    """q: (B, S, H, dq);  k: (B, T, KV, dq);  v: (B, T, KV, dv) with
    S <= T and H % KV == 0, all in one dtype.  Causal.  -> (B, S, H, dv)
    in that dtype."""
    check_dtypes(q, k, v)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-D, got {tuple(t.shape)}")
    B, S, H, dq = q.shape
    _, T, KV, _ = k.shape
    dv = v.shape[3]
    if k.shape[0] != B or k.shape[3] != dq or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} do not match")
    if KV < 1 or H % KV:
        raise ValueError(f"H={H} is not a multiple of KV={KV}")
    if not 1 <= S <= T:
        raise ValueError(f"need 1 <= S={S} <= T={T}")
    if not (1 <= dq <= MAX_WIDTH and 1 <= dv <= MAX_WIDTH):
        raise ValueError(f"dq={dq}, dv={dv}: the kernel takes widths in "
                         f"[1, {MAX_WIDTH}]")
    out = torch.empty((B, S, H, dv), device=q.device, dtype=q.dtype)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _build.lib().clover_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, S, T, H, KV, dq, dv, width_bucket(dq, dv), FORM_CODES[q.dtype],
        float(scale), stream)
    _build.check(rc, "flash_attention")
    flash_attention.launches += 1
    flash_attention.forms[str(q.dtype)[6:]] += 1
    return out


flash_attention.launches = 0
flash_attention.forms = {str(d)[6:]: 0 for d in FORM_CODES}

# the window form's dtypes -> the kernel's dtype code
WINDOW_CODES = {torch.bfloat16: 1, torch.float16: 2}


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     scale: float, scale_first: bool) -> torch.Tensor:
    """q: (B, S, H, dq) contiguous;  k: (B, T, KV, dq), v: (B, T, KV, dv)
    with unit stride along the width; S <= T, H % KV == 0; all in one of
    bfloat16, float16.  Causal, query i at position T - S + i.
    ``scale_first``: the logits scaled in the 16-bit dtype before the
    float32 cast (the reference's masked path), else after it (its
    chunked path).  -> (B, S, H, dv) in q's dtype."""
    if q.dtype not in WINDOW_CODES or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise TypeError(
            f"q {q.dtype}, k {k.dtype}, v {v.dtype}: the window kernel takes "
            f"q, K and V in one of {', '.join(map(str, WINDOW_CODES))}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor")
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-D, got {tuple(t.shape)}")
        if t.stride(3) != 1:
            raise ValueError(f"{name} must have unit stride along its width")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    B, S, H, dq = q.shape
    _, T, KV, _ = k.shape
    dv = v.shape[3]
    if k.shape[0] != B or k.shape[3] != dq or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} do not match")
    if KV < 1 or H % KV:
        raise ValueError(f"H={H} is not a multiple of KV={KV}")
    if not 1 <= S <= T:
        raise ValueError(f"need 1 <= S={S} <= T={T}")
    if not (1 <= dq <= MAX_WIDTH and 1 <= dv <= MAX_WIDTH):
        raise ValueError(f"dq={dq}, dv={dv}: the kernel takes widths in "
                         f"[1, {MAX_WIDTH}]")
    out = torch.empty((B, S, H, dv), device=q.device, dtype=q.dtype)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _build.lib().clover_window_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, S, T, H, KV, dq, dv, k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2), width_bucket(dq, dv),
        WINDOW_CODES[q.dtype], float(scale), int(bool(scale_first)), stream)
    _build.check(rc, "window_attention")
    window_attention.launches += 1
    window_attention.forms[str(q.dtype)[6:]] += 1
    return out


window_attention.launches = 0
window_attention.forms = {str(d)[6:]: 0 for d in WINDOW_CODES}
