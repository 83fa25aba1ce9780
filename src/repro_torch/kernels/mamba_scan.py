"""Mamba-1 selective scan (DESIGN.md §4, §6): the wrapper of the CUDA
kernel in ``csrc/mamba_scan.cu``.

Replaces ``repro/kernels/mamba_scan.py: mamba_scan``.  The layout is the
reference's: dt and x (B, S, dI), A (dI, dS) positive (the decay is
``exp(-dt A)``), B and C (B, S, dS), the state h0 (B, dI, dS).  S is the
kernel's loop bound, so nothing is padded.  ``h_end`` lands in a buffer
of its own and ``h0`` is never written, so a caller can keep old state
rows (the engine's merge of idle slots).  The kernel's design and its
bound on the H100 are noted in the source.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

STATES = (16,)          # state sizes dS the kernel is instantiated for


def mamba_scan(dt: torch.Tensor, A: torch.Tensor, Bmat: torch.Tensor,
               C: torch.Tensor, x: torch.Tensor,
               h0: Optional[torch.Tensor] = None,
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dt, x: (B, S, dI) float32;  A: (dI, dS);  Bmat, C: (B, S, dS);
    h0: (B, dI, dS) or None (zeros), all contiguous on one card, dS in
    ``STATES``.  -> (y (B, S, dI), h_end (B, dI, dS)), float32."""
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
    y = torch.empty((B, S, dI), device=x.device, dtype=torch.float32)
    h_end = torch.empty((B, dI, dS), device=x.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _build.lib().clover_mamba_scan(
        dt.data_ptr(), A.data_ptr(), Bmat.data_ptr(), C.data_ptr(),
        x.data_ptr(), None if h0 is None else h0.data_ptr(), y.data_ptr(),
        h_end.data_ptr(), B, S, dI, dS, stream)
    _build.check(rc, "mamba_scan")
    mamba_scan.launches += 1
    return y, h_end


mamba_scan.launches = 0
