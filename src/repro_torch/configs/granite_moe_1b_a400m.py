"""granite-moe-1b-a400m [hf:ibm-granite/granite-3.0-1b-a400m-base].

24L d_model=1024 16H (GQA kv=8) d_ff=512 vocab=49155, MoE 32e top-8.

A field-for-field copy of the JAX package's config: tied embeddings,
full RoPE ("intra" CLOVER mode), GQA with G = 2.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, MIXER_ATTN, MLP_MOE

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,
    rope=True,
    rope_theta=10000.0,
    pattern=((MIXER_ATTN, MLP_MOE),),
    moe=MoEConfig(n_experts=32, top_k=8, n_shared=0, d_expert=512),
    mlp_act="swiglu",
    norm="rmsnorm",
    tie_embeddings=True,
)
