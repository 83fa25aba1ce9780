"""qwen2-moe-a2.7b [hf:Qwen/Qwen1.5-MoE-A2.7B].

24L d_model=2048 16H (kv=16, i.e. MHA) d_ff=1408 vocab=151936,
MoE: 4 shared + 60 routed, top-4.  RoPE -> Q-K CLOVER falls back to
intra-layer K decomposition; V-O CLOVER applies (MHA, group size 1).

A field-for-field copy of the JAX package's config.  The 60 routed
experts are held as 64 (``n_experts_padded``: four dead experts whose
router logits are masked).
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, MIXER_ATTN, MLP_MOE

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=151936,
    rope=True,
    rope_theta=1e6,
    pattern=((MIXER_ATTN, MLP_MOE),),
    moe=MoEConfig(n_experts=60, top_k=4, n_shared=4, d_expert=1408),
    mlp_act="swiglu",
    norm="rmsnorm",
)
