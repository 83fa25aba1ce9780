"""jamba-v0.1-52b [arXiv:2403.19887] — Mamba + attention 1:7 interleave,
MoE.

32L d_model=4096 32H (GQA kv=8) d_ff=14336, MoE 16e top-2.  Jamba's
attention layers use no positional encoding (Mamba carries position),
so full cross-layer Q-K CLOVER applies to them (DESIGN.md §5).  Serving
carries a KV cache for the attention layers and O(1) Mamba state per
slot for the others (DESIGN.md §6).
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, jamba_pattern

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    rope=False,
    pattern=jamba_pattern(attn_period=8, attn_offset=4, moe_period=2,
                          moe_offset=1),
    moe=MoEConfig(n_experts=16, top_k=2, n_shared=0, d_expert=14336),
    mlp_act="swiglu",
    norm="rmsnorm",
    mamba_d_state=16,
    mamba_d_conv=4,
    mamba_expand=2,
    supports_long_context=True,
)
