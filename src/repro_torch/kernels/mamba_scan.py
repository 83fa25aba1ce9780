"""Mamba-1 selective scan (DESIGN.md §4, §6): the wrapper of the CUDA
kernel in ``csrc/mamba_scan.cu``.

Replaces ``repro/kernels/mamba_scan.py: mamba_scan``.  The layout is the
reference's: dt and x (B, S, dI), A (dI, dS) positive (the decay is
``exp(-dt A)``), B and C (B, S, dS), the state h0 (B, dI, dS).  S is the
kernel's loop bound, so nothing is padded.  ``h_end`` lands in a buffer
of its own and ``h0`` is never written, so a caller can keep old state
rows (the engine's merge of idle slots).  The kernel's design and its
bound on the H100 are noted in the source.

``plan`` is the host side of the kernel's work split: each block owns
``channels`` consecutive channels of one batch row (the last block of a
row may be ragged), and each channel's dS states are split over
``lanes`` neighbouring threads, lane l holding states ``l dS / lanes``
onwards.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

STATES = (16,)          # state sizes dS the kernel is instantiated for
# (lanes per channel, channels per block) that csrc/mamba_scan.cu
# instantiates; plan takes the first that puts this many warps on each SM,
# else the last (chip_smoke.py's tile sweep: 2 lanes at B = 4, dI = 8192;
# 4 lanes at B = 1, where 2 leave one warp per scheduler)
CONFIGS = ((2, 64), (4, 32))
MIN_WARPS_PER_SM = 8


def plan(dI: int, rows: int = 1, sms: int = 1, config=None
         ) -> Tuple[int, int, int]:
    """(lanes per channel, channels per block, blocks per batch row) for
    ``rows`` = B batch rows of dI channels on ``sms`` SMs: ``config`` if
    given, else the first of ``CONFIGS`` that puts ``MIN_WARPS_PER_SM``
    warps on each SM, else the last."""
    if config is None:
        config = next((c for c in CONFIGS
                       if rows * dI * c[0] >= 32 * MIN_WARPS_PER_SM * sms),
                      CONFIGS[-1])
    config = tuple(config)
    if config not in CONFIGS:
        raise ValueError(f"mamba_scan: config {config} is not built; "
                         f"built: {CONFIGS}")
    lanes, channels = config
    return lanes, channels, -(-dI // channels)


def mamba_scan(dt: torch.Tensor, A: torch.Tensor, Bmat: torch.Tensor,
               C: torch.Tensor, x: torch.Tensor,
               h0: Optional[torch.Tensor] = None, *, config=None,
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dt, x: (B, S, dI) float32;  A: (dI, dS);  Bmat, C: (B, S, dS);
    h0: (B, dI, dS) or None (zeros), all contiguous on one card, dS in
    ``STATES``; ``config`` one of ``CONFIGS`` (``plan``'s choice
    unless given: the hook that lets a test reach every instance).
    -> (y (B, S, dI), h_end (B, dI, dS)), float32."""
    if x.dim() != 3 or A.dim() != 2:
        raise ValueError(f"x {tuple(x.shape)}, A {tuple(A.shape)}: need "
                         "(B, S, dI) and (dI, dS)")
    B, S, dI = x.shape
    dS = A.shape[1]
    if dS not in STATES:
        raise ValueError(f"dS={dS}: the kernel takes state sizes {STATES}")
    _build.check_tensor("dt", dt, (B, S, dI))
    _build.check_tensor("x", x, (B, S, dI))
    _build.check_tensor("A", A, (dI, dS))
    _build.check_tensor("Bmat", Bmat, (B, S, dS))
    _build.check_tensor("C", C, (B, S, dS))
    if h0 is not None:
        _build.check_tensor("h0", h0, (B, dI, dS))
    if any(t.device != x.device for t in (dt, A, Bmat, C)) or (
            h0 is not None and h0.device != x.device):
        raise ValueError("mamba_scan: all tensors must be on one device")
    lanes, channels, _ = plan(dI, B, _build.sm_count(x.device.index), config)
    y = torch.empty((B, S, dI), device=x.device, dtype=torch.float32)
    h_end = torch.empty((B, dI, dS), device=x.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _build.lib().clover_mamba_scan(
        dt.data_ptr(), A.data_ptr(), Bmat.data_ptr(), C.data_ptr(),
        x.data_ptr(), None if h0 is None else h0.data_ptr(), y.data_ptr(),
        h_end.data_ptr(), B, S, dI, dS, lanes, channels, stream)
    _build.check(rc, "mamba_scan")
    mamba_scan.launches += 1
    return y, h_end


mamba_scan.launches = 0
