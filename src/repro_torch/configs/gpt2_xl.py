"""gpt2-xl — the paper's own pruning testbed (Table 1).

48L d_model=1600 25H (MHA) d_ff=6400 vocab=50257, learned absolute
positions (no RoPE) -> full cross-layer Q-K + V-O CLOVER, exactly the
paper's setting.
"""
from repro_torch.configs.base import ArchConfig, MIXER_ATTN, MLP_DENSE

CONFIG = ArchConfig(
    name="gpt2-xl",
    family="dense",
    n_layers=48,
    d_model=1600,
    n_heads=25,
    n_kv_heads=25,
    head_dim=64,
    d_ff=6400,
    vocab_size=50257,
    rope=False,
    learned_pos=True,
    max_position=1024,
    pattern=((MIXER_ATTN, MLP_DENSE),),
    mlp_act="gelu",
    norm="layernorm",
    tie_embeddings=True,
)
