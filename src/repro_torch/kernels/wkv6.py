"""RWKV-6 wkv recurrence (DESIGN.md §4, §6): the wrapper of the CUDA
kernel in ``csrc/wkv6.cu``.

Replaces ``repro/kernels/wkv6.py: wkv6``.  The layout is the
reference's, (B, H, T, d) per sequence tensor; the state ``s0`` is
(B, H, d, d) with the decay (key) dimension first.  ``S_end`` lands in
a buffer of its own and ``s0`` is never written, so a caller can keep
old state rows (the engine's merge of idle slots).  The kernel's design
and its bound on the H100 are noted in the source.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

WIDTHS = (32, 64)       # head widths d the kernel is instantiated for


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         logw: torch.Tensor, u: torch.Tensor,
         s0: Optional[torch.Tensor] = None,
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, logw: (B, H, T, d) float32;  u: (H, d);  s0: (B, H, d,
    d) or None (zeros), all contiguous on one card, d in ``WIDTHS``.
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
    out = torch.empty((B, H, T, d), device=r.device, dtype=torch.float32)
    s_end = torch.empty((B, H, d, d), device=r.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    rc = _build.lib().clover_wkv6(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
        u.data_ptr(), None if s0 is None else s0.data_ptr(), out.data_ptr(),
        s_end.data_ptr(), B, H, T, d, stream)
    _build.check(rc, "wkv6")
    wkv6.launches += 1
    return out, s_end


wkv6.launches = 0
