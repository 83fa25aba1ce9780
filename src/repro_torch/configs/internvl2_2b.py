"""internvl2-2b [arXiv:2404.16821] — InternViT + InternLM2 backbone.

24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553.  The InternViT
frontend is a stub: the caller passes precomputed (B, 256, 2048) patch
embeddings, placed before the text tokens.  Full RoPE ("intra" CLOVER
mode), GQA with G = 2.

A field-for-field copy of the JAX package's config.
"""
from repro_torch.configs.base import ArchConfig, MIXER_ATTN, MLP_DENSE

CONFIG = ArchConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92553,
    rope=True,
    rope_theta=1e6,
    pattern=((MIXER_ATTN, MLP_DENSE),),
    mlp_act="swiglu",
    norm="rmsnorm",
    frontend="vision",
    frontend_len=256,    # stub: 256 precomputed ViT patch embeddings
    frontend_dim=2048,
)
