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

The 16-bit forms share one tile pipeline (``plan16``): a block owns one
(batch, KV head) and ``ROWS`` (position, head) rows of that head group,
the G query heads of a position next to each other, so every K / V tile
it stages serves the whole group; its warp 0 keeps K / V tiles in
flight, by TMA where the strides and the alignment allow it, else by
``cp.async`` (``ROUTES``).  The plan is made here, from the shapes,
strides and pointers, and the kernel checks it.

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

from dataclasses import dataclass
from typing import Sequence

import torch

from repro_torch.kernels import _build

MAX_WIDTH = 256     # dq, dv the kernel's shared-memory plan accepts
WIDTH_BUCKETS = (32, 64, 128, 256)   # the kernel's compile-time widths
# operand dtype -> the kernel's dtype code (csrc/clover_attention.cu)
FORM_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def width_bucket(dq: int, dv: int) -> int:
    """The smallest compiled width that holds both head widths."""
    return next(w for w in WIDTH_BUCKETS if w >= max(dq, dv))


# (position, head) rows a block of the 16-bit forms (csrc/clover_attention.cu:
# flash16::kRows)
ROWS = 128
# the producer's staging route -> the kernel's route code
ROUTES = {"cp.async": 0, "tma": 1}


@dataclass(frozen=True)
class Plan16:
    """One launch of a 16-bit form: ``width`` the compiled bucket,
    ``group`` the query heads a KV head serves (G, packed into the rows),
    ``tiles`` the row tiles of ``ROWS`` over a head group's S G rows,
    ``grid`` the kernel's (KV B, tiles), ``route`` how K and V are
    staged."""
    width: int
    group: int
    tiles: int
    grid: tuple
    route: str


def tma_ready(ptr: int, strides: Sequence[int]) -> bool:
    """A 2-byte tensor TMA can read: the base 16-byte aligned and every
    stride (elements; batch, position, head) a positive multiple of 16
    bytes."""
    return ptr % 16 == 0 and all(s > 0 and (2 * s) % 16 == 0
                                 for s in strides)


def plan16(B: int, S: int, H: int, KV: int, dq: int, dv: int,
           k_ptr: int, k_strides: Sequence[int], v_ptr: int,
           v_strides: Sequence[int]) -> Plan16:
    """The 16-bit forms' launch for q (B, S, H, dq) over K / V (B, T, KV,
    dq / dv) at ``k_ptr`` / ``v_ptr`` with (batch, position, head)
    strides: TMA when both K and V qualify, else ``cp.async``."""
    G = H // KV
    tiles = -(-S * G // ROWS)
    route = ("tma" if tma_ready(k_ptr, k_strides)
             and tma_ready(v_ptr, v_strides) else "cp.async")
    return Plan16(width_bucket(dq, dv), G, tiles, (KV * B, tiles), route)


def tile_rows(plan: Plan16, S: int, KV: int, block: tuple) -> list:
    """The (b, s, h) rows block (x, y) of ``plan.grid`` computes, as the
    kernel maps them: x = b KV + kv head, row tiles last-first over y, row
    i of a head group at position i // G, head kv G + i % G."""
    x, y = block
    G = plan.group
    b, kvh = divmod(x, KV)
    row0 = (plan.tiles - 1 - y) * ROWS
    return [(b, i // G, kvh * G + i % G)
            for i in range(row0, min(row0 + ROWS, S * G))]


def tile_keys(plan: Plan16, S: int, T: int, y: int) -> int:
    """Key tiles of 128 that block row ``y`` stages: up to its last row's
    position (queries at the end of the keys)."""
    G = plan.group
    row0 = (plan.tiles - 1 - y) * ROWS
    t_end = T - S + (min(row0 + ROWS, S * G) - 1) // G + 1
    return -(-t_end // 128)


def _launch16(fn, name: str, plan: Plan16, stream: int, *args) -> None:
    """A 16-bit form's launch: the plan's tiles and route after ``args``;
    a negative return is a tensor map the driver refused (no other route
    is tried)."""
    rc = fn(*args, plan.tiles, ROUTES[plan.route], stream)
    if rc < 0:
        raise RuntimeError(f"{name}: the driver refused a TMA descriptor "
                           f"(error {-rc})")
    _build.check(rc, name)


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
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, S, T, H, KV, dq, dv, width_bucket(dq, dv),
            FORM_CODES[q.dtype], float(scale))
    if q.dtype == torch.float32:
        rc = _build.lib().clover_flash_attention(*args, 0, 0, stream)
        _build.check(rc, "flash_attention")
    else:
        _launch16(_build.lib().clover_flash_attention, "flash_attention",
                  plan16(B, S, H, KV, dq, dv, k.data_ptr(), k.stride()[:3],
                         v.data_ptr(), v.stride()[:3]), stream, *args)
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
    _launch16(_build.lib().clover_window_attention, "window_attention",
              plan16(B, S, H, KV, dq, dv, k.data_ptr(), k.stride()[:3],
                     v.data_ptr(), v.stride()[:3]),
              torch.cuda.current_stream(q.device).cuda_stream,
              q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
              B, S, T, H, KV, dq, dv, k.stride(0), k.stride(1), k.stride(2),
              v.stride(0), v.stride(1), v.stride(2), width_bucket(dq, dv),
              WINDOW_CODES[q.dtype], float(scale), int(bool(scale_first)))
    window_attention.launches += 1
    window_attention.forms[str(q.dtype)[6:]] += 1
    return out


window_attention.launches = 0
window_attention.forms = {str(d)[6:]: 0 for d in WINDOW_CODES}
