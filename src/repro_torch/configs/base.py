"""Architecture configuration dataclasses (own copy of ``repro``'s
``configs/base.py``; the port never imports the JAX package).

Every architecture is an ``ArchConfig``; the decoder in
``repro_torch.models`` is config-driven.  Field names and defaults match
the reference so configs compare field by field.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

# Mixer kinds a layer can use.
MIXER_ATTN = "attn"
MIXER_MAMBA = "mamba"
MIXER_RWKV = "rwkv"

# MLP kinds.
MLP_DENSE = "dense"
MLP_MOE = "moe"
MLP_RWKV = "rwkv_ffn"


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

    moe: Optional[Any] = None    # MoE configs arrive with their slice
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

    def n_params(self) -> int:
        """Parameter count of the attention + dense-MLP decoder."""
        D, H, KV = self.d_model, self.n_heads, self.n_kv_heads
        dq, dv = self.qk_dim, self.vo_dim
        total = self.padded_vocab * D
        if not self.tie_embeddings:
            total += self.padded_vocab * D
        if self.learned_pos:
            total += self.max_position * D
        norm = 2 if self.norm == "layernorm" else 1
        per_layer = 2 * norm * D + D * H * dq + D * KV * dq + D * KV * dv \
            + H * dv * D
        mult = 3 if self.mlp_act in ("swiglu", "geglu") else 2
        per_layer += mult * D * self.d_ff
        return total + norm * D + self.n_layers * per_layer

    def reduced(self, **overrides) -> "ArchConfig":
        """Same family/topology, tiny sizes — runnable on 1 CPU core."""
        small = dict(
            n_layers=self.period * min(self.n_blocks, 2),
            d_model=128,
            n_heads=4,
            n_kv_heads=max(1, 4 * self.n_kv_heads // self.n_heads),
            head_dim=32,
            d_ff=256,
            vocab_size=512,
            max_position=1024,
            mamba_dt_rank=8,
            rwkv_head_dim=32,
            frontend_len=min(self.frontend_len, 8) if self.frontend_len else 0,
            frontend_dim=128 if self.frontend != "none" else 0,
        )
        small.update(overrides)
        return dataclasses.replace(self, **small)
