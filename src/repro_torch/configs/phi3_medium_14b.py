"""phi3-medium-14b [arXiv:2404.14219].

40L d_model=5120 40H (GQA kv=10) d_ff=17920 vocab=100352. RoPE + SwiGLU + GQA.

A field-for-field copy of the JAX package's config.  Its vocab, 100352,
is Phi-3-small's tiktoken vocabulary (Phi-3-medium's is 32064); it is
kept so that the port and the reference agree.
"""
from repro_torch.configs.base import ArchConfig, MIXER_ATTN, MLP_DENSE

CONFIG = ArchConfig(
    name="phi3-medium-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=10,
    head_dim=128,
    d_ff=17920,
    vocab_size=100352,
    rope=True,
    rope_theta=10000.0,
    pattern=((MIXER_ATTN, MLP_DENSE),),
    mlp_act="swiglu",
    norm="rmsnorm",
)
