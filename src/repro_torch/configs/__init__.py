"""Architecture config registry of the port.

Ported so far: gpt2-xl (the paper's Table 1 model, no RoPE),
rwkv6-1.6b (the attention-free RWKV-6 family, recurrent serving state)
and jamba-v0.1-52b (Mamba + GQA attention, MoE).  The other
architectures arrive with their slices (RoPE configs, the qwen2 and
granite MoEs).
"""
from __future__ import annotations

from repro_torch.configs.base import (ArchConfig, CloverConfig,  # noqa: F401
                                      MoEConfig)
from repro_torch.configs.gpt2_xl import CONFIG as _GPT2_XL
from repro_torch.configs.jamba_v0_1_52b import CONFIG as _JAMBA_V0_1_52B
from repro_torch.configs.rwkv6_1_6b import CONFIG as _RWKV6_1_6B

_CONFIGS = {"gpt2-xl": _GPT2_XL, "rwkv6-1.6b": _RWKV6_1_6B,
            "jamba-v0.1-52b": _JAMBA_V0_1_52B}


def get_config(name: str) -> ArchConfig:
    if name not in _CONFIGS:
        raise KeyError(f"unknown arch {name!r}; the port knows "
                       f"{sorted(_CONFIGS)}")
    return _CONFIGS[name]
