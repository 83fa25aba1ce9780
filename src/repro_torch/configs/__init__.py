"""Architecture config registry of the port.

Ported so far: gpt2-xl (the paper's Table 1 model, no RoPE),
rwkv6-1.6b (the attention-free RWKV-6 family, recurrent serving state),
jamba-v0.1-52b (Mamba + GQA attention, MoE) and the dense RoPE
decoders stablelm-3b (partial RoPE, 20 of 80 dims), phi3-medium-14b,
minitron-4b and deepseek-coder-33b (full RoPE, GQA with G = 4, 3 and
7).  The qwen2 and granite MoEs and the frontend configs arrive with
their slices.
"""
from __future__ import annotations

from repro_torch.configs.base import (ArchConfig, CloverConfig,  # noqa: F401
                                      MoEConfig)
from repro_torch.configs.deepseek_coder_33b import \
    CONFIG as _DEEPSEEK_CODER_33B
from repro_torch.configs.gpt2_xl import CONFIG as _GPT2_XL
from repro_torch.configs.jamba_v0_1_52b import CONFIG as _JAMBA_V0_1_52B
from repro_torch.configs.minitron_4b import CONFIG as _MINITRON_4B
from repro_torch.configs.phi3_medium_14b import CONFIG as _PHI3_MEDIUM_14B
from repro_torch.configs.rwkv6_1_6b import CONFIG as _RWKV6_1_6B
from repro_torch.configs.stablelm_3b import CONFIG as _STABLELM_3B

_CONFIGS = {"gpt2-xl": _GPT2_XL, "rwkv6-1.6b": _RWKV6_1_6B,
            "jamba-v0.1-52b": _JAMBA_V0_1_52B,
            "stablelm-3b": _STABLELM_3B,
            "phi3-medium-14b": _PHI3_MEDIUM_14B,
            "minitron-4b": _MINITRON_4B,
            "deepseek-coder-33b": _DEEPSEEK_CODER_33B}


def get_config(name: str) -> ArchConfig:
    if name not in _CONFIGS:
        raise KeyError(f"unknown arch {name!r}; the port knows "
                       f"{sorted(_CONFIGS)}")
    return _CONFIGS[name]
