"""Architecture configuration dataclasses (own copy of ``repro``'s
``configs/base.py``; the port never imports the JAX package).

Every architecture is an ``ArchConfig``; the decoder in
``repro_torch.models`` is config-driven.  Field names and defaults match
the reference so configs compare field by field.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

# Mixer kinds a layer can use.
MIXER_ATTN = "attn"
MIXER_MAMBA = "mamba"
MIXER_RWKV = "rwkv"

# MLP kinds.
MLP_DENSE = "dense"
MLP_MOE = "moe"
MLP_RWKV = "rwkv_ffn"

# Width of the RWKV-6 decay LoRA (``models/rwkv.py``; the reference's
# ``W_LORA``).
RWKV_DECAY_LORA = 64

# Expert-parallel degree the padded expert count must divide (the
# reference's ``models/moe.py: EP_PAD_TO``).
EP_PAD_TO = 16


@dataclass(frozen=True)
class MoEConfig:
    """GShard-style top-k mixture of experts."""

    n_experts: int
    top_k: int
    n_shared: int = 0            # always-on shared experts (DeepSeek/Qwen style)
    d_expert: int = 0            # per-expert FFN hidden size (0 -> cfg.d_ff)
    capacity_factor: float = 1.25
    router_z_coef: float = 1e-3
    aux_loss_coef: float = 1e-2

    def padded_experts(self, ep: int) -> int:
        """Experts padded up to a multiple of the expert-parallel degree."""
        return ((self.n_experts + ep - 1) // ep) * ep


@dataclass(frozen=True)
class CloverConfig:
    """CLOVER decomposition / pruning switches.

    ``qk_rank``/``vo_rank`` are the retained ranks after pruning
    (0 = full head_dim, i.e. decomposed but unpruned).
    """

    enabled: bool = False
    qk_rank: int = 0
    vo_rank: int = 0
    finetune_s: bool = False
    up_block: int = 64
    rank_multiple: int = 8


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // n_heads

    rope: bool = True
    rope_theta: float = 10000.0
    rotary_pct: float = 1.0
    learned_pos: bool = False
    max_position: int = 524288

    pattern: Tuple[Tuple[str, str], ...] = ((MIXER_ATTN, MLP_DENSE),)

    moe: Optional[MoEConfig] = None
    clover: CloverConfig = field(default_factory=CloverConfig)

    mlp_act: str = "swiglu"
    norm: str = "rmsnorm"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    attn_logit_softcap: float = 0.0

    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    mamba_dt_rank: int = 0

    rwkv_head_dim: int = 64

    frontend: str = "none"
    frontend_len: int = 0
    frontend_dim: int = 0

    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    kv_cache_dtype: str = ""

    # Kept for field parity with the reference.  The port dispatches
    # its kernels on the tensor's device instead (kernels/ops.py).
    kernel_impl: str = "xla"
    unroll_layers: bool = False
    remat_group: int = 1
    supports_long_context: bool = False
    pad_vocab_to: int = 1

    # ---- derived helpers -------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        m = max(1, self.pad_vocab_to)
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def head_dim_(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def q_per_kv(self) -> int:
        assert self.n_heads % self.n_kv_heads == 0
        return self.n_heads // self.n_kv_heads

    @property
    def period(self) -> int:
        return len(self.pattern)

    @property
    def n_blocks(self) -> int:
        assert self.n_layers % self.period == 0, (
            f"{self.name}: n_layers={self.n_layers} not divisible by "
            f"pattern period {self.period}")
        return self.n_layers // self.period

    @property
    def mamba_d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    @property
    def mamba_dt_rank_(self) -> int:
        if self.mamba_dt_rank:
            return self.mamba_dt_rank
        return max(1, (self.d_model + 15) // 16)

    @property
    def n_experts_padded(self) -> int:
        """Experts the MoE weights hold: ``n_experts``, padded up to a
        multiple of ``EP_PAD_TO`` from 16 experts on (the extra ones are
        dead: their router logits are masked)."""
        e = self.moe.n_experts
        if e >= EP_PAD_TO and e % EP_PAD_TO != 0:
            return self.moe.padded_experts(EP_PAD_TO)
        return e

    @property
    def rwkv_n_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    @property
    def qk_dim(self) -> int:
        """Per-head Q/K projection width (CLOVER-pruned rank or head_dim)."""
        if self.clover.enabled and self.clover.qk_rank:
            return self.clover.qk_rank
        return self.head_dim_

    @property
    def vo_dim(self) -> int:
        if self.clover.enabled and self.clover.vo_rank:
            return self.clover.vo_rank
        return self.head_dim_

    @property
    def rope_dims(self) -> int:
        """Number of rotated dims per head (partial RoPE support)."""
        if not self.rope:
            return 0
        r = int(self.head_dim_ * self.rotary_pct)
        return (r // 2) * 2

    def n_params(self, active_only: bool = False) -> int:
        """Exact count of the parameters ``init_lm_params`` makes: the
        attention, Mamba and RWKV-6 mixers, dense, MoE and RWKV channel
        MLPs, the norms (final one included) and the embeddings.  The
        reference's ``n_params`` is approximate: it counts one of the
        Mamba vectors ``conv_b``/``dt_bias``/``D`` instead of three,
        approximates the RWKV terms, counts the router over the real
        experts only, and leaves out the final norm (on one jamba period
        it is 118,784 low).  ``active_only``: the parameters one token
        touches (MODEL_FLOPS, ``launch.dryrun``): each MoE layer's
        ``top_k`` routed experts and its shared experts, and the router
        over the padded experts; equal to the total without MoE."""
        D, H, KV = self.d_model, self.n_heads, self.n_kv_heads
        dq, dv = self.qk_dim, self.vo_dim
        total = self.padded_vocab * D
        if not self.tie_embeddings:
            total += self.padded_vocab * D
        if self.learned_pos:
            total += self.max_position * D
        norm = 2 if self.norm == "layernorm" else 1
        gated = 3 if self.mlp_act in ("swiglu", "geglu") else 2
        per_pattern = 0
        for mixer, mlp in self.pattern:
            p = 2 * norm * D
            if mixer == MIXER_ATTN:
                p += D * H * dq + D * KV * dq + D * KV * dv + H * dv * D
            elif mixer == MIXER_MAMBA:
                dI, dS = self.mamba_d_inner, self.mamba_d_state
                dt = self.mamba_dt_rank_
                p += D * 2 * dI + dI * self.mamba_d_conv       # in, conv_w
                p += dI * (dt + 2 * dS) + dt * dI + dI * dS    # x, dt, A_log
                p += 3 * dI + dI * D             # conv_b, dt_bias, D; out
            elif mixer == MIXER_RWKV:
                p += 5 * D * D + 2 * RWKV_DECAY_LORA * D
                p += 5 * D + D + self.rwkv_n_heads * self.rwkv_head_dim \
                    + 2 * D                  # mixes, w0, u, ln_x
            if mlp == MLP_DENSE:
                p += gated * D * self.d_ff
            elif mlp == MLP_MOE:
                de = self.moe.d_expert or self.d_ff
                E = self.n_experts_padded
                routed = self.moe.top_k if active_only else E
                p += D * E + gated * routed * D * de      # router, experts
                p += gated * D * self.moe.n_shared * de   # shared experts
            elif mlp == MLP_RWKV:
                p += 2 * D * self.d_ff + D * D + 2 * D
            per_pattern += p
        return total + norm * D + self.n_blocks * per_pattern

    def reduced(self, **overrides) -> "ArchConfig":
        """Same family/topology, tiny sizes — runnable on 1 CPU core."""
        moe = self.moe
        if moe is not None:
            moe = dataclasses.replace(
                moe, n_experts=min(moe.n_experts, 4),
                top_k=min(moe.top_k, 2), n_shared=min(moe.n_shared, 1),
                d_expert=64 if moe.d_expert else 0)
        small = dict(
            n_layers=self.period * min(self.n_blocks, 2),
            d_model=128,
            n_heads=4,
            n_kv_heads=max(1, 4 * self.n_kv_heads // self.n_heads),
            head_dim=32,
            d_ff=256,
            vocab_size=512,
            max_position=1024,
            moe=moe,
            mamba_dt_rank=8,
            rwkv_head_dim=32,
            frontend_len=min(self.frontend_len, 8) if self.frontend_len else 0,
            frontend_dim=128 if self.frontend != "none" else 0,
        )
        small.update(overrides)
        return dataclasses.replace(self, **small)


def jamba_pattern(attn_period: int = 8, attn_offset: int = 4,
                  moe_period: int = 2, moe_offset: int = 1
                  ) -> Tuple[Tuple[str, str], ...]:
    """Jamba's interleave: 1 attention layer per ``attn_period``, MoE
    every ``moe_period`` layers.  Returns one full period (lcm)."""
    period = attn_period  # lcm(8, 2) == 8
    pat = []
    for i in range(period):
        mixer = MIXER_ATTN if i % attn_period == attn_offset else MIXER_MAMBA
        mlp = MLP_MOE if i % moe_period == moe_offset else MLP_DENSE
        pat.append((mixer, mlp))
    return tuple(pat)
