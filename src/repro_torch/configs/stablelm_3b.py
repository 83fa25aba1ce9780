"""stablelm-3b [hf:stabilityai/stablelm-2 family].

32L d_model=2560 32H (MHA kv=32) d_ff=6912 vocab=50304.
StableLM-2 uses partial rotary (rotary_pct=0.25): only 25% of head dims are
rotated.  Beyond-paper: the remaining 75% NoPE dims admit full cross-layer
Q-K CLOVER blockwise (see DESIGN.md §5).
"""
from repro_torch.configs.base import ArchConfig, MIXER_ATTN, MLP_DENSE

CONFIG = ArchConfig(
    name="stablelm-3b",
    family="dense",
    n_layers=32,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    head_dim=80,
    d_ff=6912,
    vocab_size=50304,
    rope=True,
    rope_theta=10000.0,
    rotary_pct=0.25,
    pattern=((MIXER_ATTN, MLP_DENSE),),
    mlp_act="swiglu",
    norm="layernorm",
)
