"""minitron-4b [arXiv:2407.14679] — pruned nemotron.

32L d_model=3072 24H (GQA kv=8) d_ff=9216 vocab=256000.
"""
from repro_torch.configs.base import ArchConfig, MIXER_ATTN, MLP_DENSE

CONFIG = ArchConfig(
    name="minitron-4b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9216,
    vocab_size=256000,
    rope=True,
    rope_theta=10000.0,
    pattern=((MIXER_ATTN, MLP_DENSE),),
    mlp_act="gelu",   # nemotron uses squared-relu; gelu family stands in
    norm="layernorm",
)
