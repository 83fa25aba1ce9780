"""RWKV-6 wkv recurrence (DESIGN.md §4, §6): the wrapper of the CUDA
kernel in ``csrc/wkv6.cu``.

Replaces ``repro/kernels/wkv6.py: wkv6``.  The layout is the
reference's, (B, H, T, d) per sequence tensor; the state ``s0`` is
(B, H, d, d) with the decay (key) dimension first.  ``S_end`` lands in
a buffer of its own and ``s0`` is never written, so a caller can keep
old state rows (the engine's merge of idle slots).  The kernel's design
and its bound on the H100 are noted in the source.

``plan`` is the host side of the kernel's work split: each block owns
``cols`` columns of the (d, d) state of one (b, h); each thread holds
``cc`` consecutive columns, and their d rows are split over ``lanes``
neighbouring threads, lane l holding rows ``4 (l + lanes g) + m``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

WIDTHS = (32, 64)       # head widths d the kernel is instantiated for
# (lanes per state column, columns per thread, columns per block) that
# csrc/wkv6.cu instantiates at each head width, large tile first
CONFIGS = {64: ((8, 4, 64), (8, 1, 16)),
           32: ((8, 4, 32), (8, 1, 16))}
# plan takes the large tile while its grid covers this share of the SMs
# (chip_smoke.py's tile sweep: at B = 4, H = 32 the 64-column blocks, one
# per head, are fastest; at B = 1 the 16-column ones)
COVER = 0.9


def plan(d: int, bh: int = 1, sms: int = 1,
         config: Optional[Tuple[int, int, int]] = None
         ) -> Tuple[int, int, int, int]:
    """(lanes per column, columns per thread, columns per block, blocks
    per (b, h)) at head width d for ``bh`` = B * H heads on ``sms`` SMs:
    ``config`` if given, else the first tile of ``CONFIGS[d]`` whose grid
    covers ``COVER`` of the SMs, else the last."""
    if d not in WIDTHS:
        raise ValueError(f"d={d}: the kernel takes head widths {WIDTHS}")
    if config is None:
        config = next((c for c in CONFIGS[d]
                       if bh * (d // c[2]) >= COVER * sms), CONFIGS[d][-1])
    config = tuple(config)
    if config not in CONFIGS[d]:
        raise ValueError(f"wkv6: config {config} is not built at d={d}; "
                         f"built: {CONFIGS[d]}")
    lanes, cc, cols = config
    return lanes, cc, cols, d // cols


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         logw: torch.Tensor, u: torch.Tensor,
         s0: Optional[torch.Tensor] = None, *,
         config: Optional[Tuple[int, int, int]] = None,
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, logw: (B, H, T, d) float32;  u: (H, d);  s0: (B, H, d,
    d) or None (zeros), all contiguous on one card, d in ``WIDTHS``;
    ``config`` one of ``CONFIGS[d]`` (``plan``'s choice unless given:
    the hook that lets a test reach every instance).
    -> (out (B, H, T, d), S_end (B, H, d, d)), float32."""
    if r.dim() != 4:
        raise ValueError(f"r {tuple(r.shape)}: need (B, H, T, d)")
    B, H, T, d = r.shape
    if d not in WIDTHS:
        raise ValueError(f"d={d}: the kernel takes head widths {WIDTHS}")
    for name, t in (("r", r), ("k", k), ("v", v), ("logw", logw)):
        _build.check_tensor(name, t, (B, H, T, d))
    _build.check_tensor("u", u, (H, d))
    if s0 is not None:
        _build.check_tensor("s0", s0, (B, H, d, d))
    if any(t.device != r.device for t in (k, v, logw, u)) or (
            s0 is not None and s0.device != r.device):
        raise ValueError("wkv6: all tensors must be on one device")
    lanes, cc, cols, _ = plan(d, B * H, _build.sm_count(r.device.index),
                              config)
    out = torch.empty((B, H, T, d), device=r.device, dtype=torch.float32)
    s_end = torch.empty((B, H, d, d), device=r.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    rc = _build.lib().clover_wkv6(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
        u.data_ptr(), None if s0 is None else s0.data_ptr(), out.data_ptr(),
        s_end.data_ptr(), B, H, T, d, lanes, cc, cols, stream)
    _build.check(rc, "wkv6")
    wkv6.launches += 1
    return out, s_end


wkv6.launches = 0
