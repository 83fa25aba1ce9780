"""RWKV-6 (Finch) blocks of the port — own port of
``repro/models/rwkv.py`` (DESIGN.md §5, §6): the time-mix with its
data-dependent per-channel decay, and the channel-mix FFN.

The wkv recurrence per head (d = ``rwkv_head_dim``), with the decay
applied before the read, as the reference's code (not its module
docstring) computes it:

    Sd = diag(exp(logw_t)) S;   o_t = r_t Sd + (r_t . (u * k_t)) v_t;
    S  = Sd + k_t v_t^T

runs in ``kernels.ops.wkv6``: the CUDA kernel on the card, the plain
sequential version on the CPU.  The reference's XLA path
(``wkv6_chunked``) is not ported; the tests hold the port to it.
Decode carries the token-shift inputs and the state: ``{"time":
{"last_x", "wkv"}, "chan": {"last_x"}}``.  New states are returned as
new tensors, never written into the old ones, so the engine can keep
idle slots' rows (``serve.executor._merge_inactive``).

As in the reference, the token-shift mixes of r/k/v/g are static
per-channel coefficients and the decay keeps its data-dependent LoRA.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import RWKV_DECAY_LORA as W_LORA
from repro_torch.kernels import ops
from repro_torch.models.layers import clover_up, dense_init

Params = Dict[str, Any]


def init_rwkv_timemix(gen: torch.Generator, cfg, *, dtype=torch.float32,
                      device=None) -> Params:
    """The reference's distributions: mixes 0.5, decay bias ``w0`` -2,
    N(0, 1/fan_in) projections, N(0, 0.01) LoRA up, N(0, 0.1) bonus
    ``u``; ``w0`` and ``u`` are float32 whatever ``dtype`` is."""
    D = cfg.d_model
    H, dh = cfg.rwkv_n_heads, cfg.rwkv_head_dim
    kw = dict(dtype=dtype, device=device)

    def full(value, dt=dtype):
        return torch.full((D,), value, dtype=dt, device=device)

    def normal(shape, std):
        return torch.randn(shape, generator=gen, device=device) * std

    return {
        "mix_r": full(0.5), "mix_k": full(0.5), "mix_v": full(0.5),
        "mix_g": full(0.5), "mix_w": full(0.5),
        "wr": dense_init(gen, (D, D), D, **kw),
        "wk": dense_init(gen, (D, D), D, **kw),
        "wv": dense_init(gen, (D, D), D, **kw),
        "wg": dense_init(gen, (D, D), D, **kw),
        "w0": full(-2.0, torch.float32),                 # decay bias
        "w_lora_a": dense_init(gen, (D, W_LORA), D, **kw),
        "w_lora_b": normal((W_LORA, D), 0.01).to(dtype),
        "u": normal((H, dh), 0.1),
        "out": dense_init(gen, (D, D), D, **kw),
        "ln_x_scale": torch.ones((D,), **kw),
        "ln_x_bias": torch.zeros((D,), **kw),
    }


def init_rwkv_chanmix(gen: torch.Generator, cfg, *, dtype=torch.float32,
                      device=None) -> Params:
    D, Fd = cfg.d_model, cfg.d_ff
    kw = dict(dtype=dtype, device=device)
    return {
        "mix_k": torch.full((D,), 0.5, **kw),
        "mix_r": torch.full((D,), 0.5, **kw),
        "wk": dense_init(gen, (D, Fd), D, **kw),
        "wv": dense_init(gen, (Fd, D), Fd, **kw),
        "wr": dense_init(gen, (D, D), D, **kw),
    }


def _token_shift(x: torch.Tensor, last: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    """Shift the sequence right by one; position 0 sees ``last`` (or
    zeros)."""
    pad = (torch.zeros_like(x[:, :1]) if last is None
           else last[:, None, :].to(x.dtype))
    return torch.cat([pad, x[:, :-1]], dim=1)


def _mix(x, xs, coef):
    c = coef.to(x.dtype)
    return x * c + xs * (1.0 - c)


def _group_norm(x, scale, bias, n_groups: int, eps: float = 1e-5):
    """x: (B, S, D) grouped into ``n_groups`` along D (RWKV's head-wise
    layer norm), in float32."""
    B, S, D = x.shape
    xg = x.reshape(B, S, n_groups, D // n_groups).float()
    mu = xg.mean(dim=-1, keepdim=True)
    var = xg.var(dim=-1, keepdim=True, correction=0)
    xn = ((xg - mu) * torch.rsqrt(var + eps)).reshape(B, S, D)
    return (xn * scale.float() + bias.float()).to(x.dtype)


def rwkv_timemix_forward(params: Params, cfg, x: torch.Tensor, *,
                         state: Optional[Params] = None,
                         plain: bool = False,
                         ) -> Tuple[torch.Tensor, Optional[Params]]:
    """x: (B, T, D).  state (decode): {"last_x": (B, D), "wkv": (B, H,
    d, d)}.  ``plain``: the plain wkv under autograd (training).  -> (y
    (B, T, D), new state or None)."""
    B, T, D = x.shape
    H, dh = cfg.rwkv_n_heads, cfg.rwkv_head_dim

    xs = _token_shift(x, state["last_x"] if state is not None else None)
    xr = _mix(x, xs, params["mix_r"])
    xk = _mix(x, xs, params["mix_k"])
    xv = _mix(x, xs, params["mix_v"])
    xg = _mix(x, xs, params["mix_g"])
    xw = _mix(x, xs, params["mix_w"])

    r = xr @ params["wr"].to(x.dtype)
    k = xk @ params["wk"].to(x.dtype)
    v = xv @ params["wv"].to(x.dtype)
    g = F.silu(xg @ params["wg"].to(x.dtype))

    # data-dependent decay (float32): logw = -exp(w0 + lora(xw)) < 0
    lora = torch.tanh(xw @ params["w_lora_a"].to(x.dtype)) @ \
        params["w_lora_b"].to(x.dtype)
    logw = -torch.exp(params["w0"].float() + lora.float())
    logw = logw.clamp(-10.0, -1e-4)

    def heads(t):  # (B, T, D) -> contiguous (B, H, T, dh) float32
        return t.float().reshape(B, T, H, dh).transpose(1, 2).contiguous()

    S0 = state["wkv"].float() if state is not None else None
    out, S_end = ops.wkv6(heads(r), heads(k), heads(v), heads(logw),
                          params["u"].float().contiguous(), S0, plain=plain)
    out = out.transpose(1, 2).reshape(B, T, D).to(x.dtype)

    out = _group_norm(out, params["ln_x_scale"], params["ln_x_bias"], H)
    y = (out * g) @ params["out"].to(x.dtype)

    new_state = None
    if state is not None:
        new_state = {"last_x": x[:, -1, :], "wkv": S_end}
    return y, new_state


def rwkv_chanmix_forward(params: Params, cfg, x: torch.Tensor, *,
                         state: Optional[Params] = None,
                         ) -> Tuple[torch.Tensor, Optional[Params]]:
    """x: (B, T, D).  state (decode): {"last_x": (B, D)}."""
    del cfg
    xs = _token_shift(x, state["last_x"] if state is not None else None)
    xk = _mix(x, xs, params["mix_k"])
    xr = _mix(x, xs, params["mix_r"])
    if "up_u" in params:  # CLOVER blockwise-decomposed key projection
        kk = clover_up(params, xk)
    else:
        kk = xk @ params["wk"].to(x.dtype)
    k = torch.square(torch.relu(kk))
    out = torch.sigmoid(xr @ params["wr"].to(x.dtype)) * (
        k @ params["wv"].to(x.dtype))
    new_state = {"last_x": x[:, -1, :]} if state is not None else None
    return out, new_state


def init_rwkv_state(cfg, batch: int, *, dtype=torch.float32,
                    device=None) -> Params:
    """Zero decode state of one layer: token-shift inputs in ``dtype``,
    the wkv state in float32."""
    H, dh = cfg.rwkv_n_heads, cfg.rwkv_head_dim
    return {
        "time": {"last_x": torch.zeros((batch, cfg.d_model), dtype=dtype,
                                       device=device),
                 "wkv": torch.zeros((batch, H, dh, dh), dtype=torch.float32,
                                    device=device)},
        "chan": {"last_x": torch.zeros((batch, cfg.d_model), dtype=dtype,
                                       device=device)},
    }
