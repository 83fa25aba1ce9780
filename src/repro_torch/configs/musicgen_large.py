"""musicgen-large [arXiv:2306.05284] — decoder-only over EnCodec tokens.

48L d_model=2048 32H (MHA kv=32) d_ff=8192 vocab=2048.  Sinusoidal
positions (no RoPE), added to the embeddings in the model -> full
cross-layer Q-K and V-O CLOVER ("cross" mode).  The EnCodec frontend is
a stub: the caller passes precomputed (B, 250, 2048) frame embeddings,
placed before the text tokens.

A field-for-field copy of the JAX package's config.
"""
from repro_torch.configs.base import ArchConfig, MIXER_ATTN, MLP_DENSE

CONFIG = ArchConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    rope=False,
    learned_pos=False,   # sinusoidal, added in-model
    pattern=((MIXER_ATTN, MLP_DENSE),),
    mlp_act="gelu",
    norm="layernorm",
    frontend="audio",
    frontend_len=250,    # stub: 250 precomputed EnCodec frame embeddings
    frontend_dim=2048,
)
