"""Mamba-1 block (selective SSM) of the port, for the jamba hybrid —
own port of ``repro/models/mamba.py`` (DESIGN.md §5, §6).

Per layer: ``in_proj`` to (x, z), a causal depthwise convolution of
width ``mamba_d_conv`` over the sequence, silu, ``x_proj`` to the
low-rank dt and the input-dependent B and C, softplus dt in float32,
then the selective scan

    h_t = exp(-dt_t A) h_{t-1} + (dt_t x_t) B_t;   y_t = h_t . C_t

in ``kernels.ops.mamba_scan`` (the CUDA kernel on the card, the plain
sequential version on the CPU), ``+ x D``, gated by ``silu(z)``,
``out_proj``.  Both the stateless full-sequence path and the stateful
decode/chunk path run the scan through ``ops.mamba_scan``; the
reference sends only the first to its kernel (its stateful path is a
``lax.scan`` of the same recurrence) and its XLA associative scan
(``_selective_scan``) is not ported.  The convolution is the
reference's ``dconv`` shifted multiply-adds, not a cuDNN convolution.

Decode carries ``{"conv": (B, dconv-1, dI), "ssm": (B, dI, dS)}``.  New
states are new tensors, never written into the old ones, so the engine
can keep idle slots' rows (``serve.executor._merge_inactive``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init

Params = Dict[str, Any]


def init_mamba(gen: torch.Generator, cfg, *, dtype=torch.float32,
               device=None) -> Params:
    """The reference's distributions: N(0, 1/fan_in) projections and
    conv, S4D-real ``A_log = log(1..dS)`` per channel, ``D`` = 1,
    ``dt_bias`` = -4.6 (softplus^-1(0.01)), ``conv_b`` = 0; ``A_log`` and
    ``D`` are float32 whatever ``dtype`` is."""
    D = cfg.d_model
    dI, dS = cfg.mamba_d_inner, cfg.mamba_d_state
    dt_rank = cfg.mamba_dt_rank_
    dconv = cfg.mamba_d_conv
    kw = dict(dtype=dtype, device=device)
    A = torch.arange(1, dS + 1, dtype=torch.float32,
                     device=device)[None, :].expand(dI, dS)
    return {
        "in_proj": dense_init(gen, (D, 2 * dI), D, **kw),
        "conv_w": dense_init(gen, (dconv, dI), dconv, **kw),
        "conv_b": torch.zeros((dI,), **kw),
        "x_proj": dense_init(gen, (dI, dt_rank + 2 * dS), dI, **kw),
        "dt_proj": dense_init(gen, (dt_rank, dI), dt_rank, **kw),
        "dt_bias": torch.full((dI,), -4.6, **kw),
        "A_log": torch.log(A),
        "D": torch.ones((dI,), dtype=torch.float32, device=device),
        "out_proj": dense_init(gen, (dI, D), dI, **kw),
    }


def mamba_forward(params: Params, cfg, x: torch.Tensor, *,
                  state: Optional[Params] = None, plain: bool = False,
                  ) -> Tuple[torch.Tensor, Optional[Params]]:
    """x: (B, S, D).  state (decode): {"conv": (B, dconv-1, dI), "ssm":
    (B, dI, dS)}.  Full-sequence when state is None.  ``plain``: the
    plain scan under autograd (training).  -> (y (B, S, D), new state or
    None)."""
    B, S, _ = x.shape
    dS = cfg.mamba_d_state
    dt_rank = cfg.mamba_dt_rank_
    dconv = cfg.mamba_d_conv

    xz = x @ params["in_proj"].to(x.dtype)                    # (B, S, 2dI)
    xin, z = xz.chunk(2, dim=-1)
    dI = xin.shape[-1]

    # causal depthwise conv over the sequence: dconv shifted
    # multiply-adds over [previous dconv-1 inputs, this window]
    conv_w = params["conv_w"].to(x.dtype)                     # (dconv, dI)
    if state is None:
        pad = torch.zeros((B, dconv - 1, dI), dtype=x.dtype, device=x.device)
    else:
        pad = state["conv"].to(x.dtype)
    xp = torch.cat([pad, xin], dim=1)                         # (B, S+dc-1, dI)
    xc = xp[:, 0:S] * conv_w[0]
    for c in range(1, dconv):
        xc = xc + xp[:, c:c + S] * conv_w[c]
    xc = F.silu(xc + params["conv_b"].to(x.dtype))

    proj = xc @ params["x_proj"].to(x.dtype)                  # (B, S, dtr+2dS)
    dt_lr, Bmat, C = proj.split([dt_rank, dS, dS], dim=-1)
    dt_in = dt_lr @ params["dt_proj"].to(x.dtype) + params["dt_bias"].to(
        x.dtype)
    dt = torch.logaddexp(dt_in, torch.zeros_like(dt_in)).float()  # softplus
    A = torch.exp(params["A_log"].float())                    # (dI, dS) > 0

    h0 = state["ssm"].float().contiguous() if state is not None else None
    y, h_end = ops.mamba_scan(dt.contiguous(), A.contiguous(),
                              Bmat.float().contiguous(),
                              C.float().contiguous(),
                              xc.float().contiguous(), h0, plain=plain)
    y = y.to(x.dtype) + xc * params["D"].to(x.dtype)
    y = y * F.silu(z)
    new_state = None
    if state is not None:
        new_state = {"conv": xp[:, -(dconv - 1):].clone(), "ssm": h_end}
    return y @ params["out_proj"].to(x.dtype), new_state


def init_mamba_state(cfg, batch: int, *, dtype=torch.float32,
                     device=None) -> Params:
    """Zero decode state of one layer: the conv window in ``dtype``, the
    SSM state in float32."""
    return {
        "conv": torch.zeros((batch, cfg.mamba_d_conv - 1, cfg.mamba_d_inner),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((batch, cfg.mamba_d_inner, cfg.mamba_d_state),
                           dtype=torch.float32, device=device),
    }
