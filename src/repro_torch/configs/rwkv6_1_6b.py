"""rwkv6-1.6b (Finch) [arXiv:2404.05892] — attention-free, data-dependent
decay.

24L d_model=2048 d_ff=7168 vocab=65536.  head_dim=64 -> 32 wkv heads.
CLOVER Q-K/V-O is inapplicable (no attention): ``clover_decompose``
passes its layers through (DESIGN.md §5).  Serving carries O(1)
recurrent state per slot instead of a KV cache (DESIGN.md §6).
"""
from repro_torch.configs.base import ArchConfig, MIXER_RWKV, MLP_RWKV

CONFIG = ArchConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,          # wkv heads (d_model / rwkv_head_dim)
    n_kv_heads=32,
    head_dim=64,
    d_ff=7168,
    vocab_size=65536,
    rope=False,
    pattern=((MIXER_RWKV, MLP_RWKV),),
    norm="layernorm",
    rwkv_head_dim=64,
    supports_long_context=True,
)
