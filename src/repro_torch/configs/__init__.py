"""Architecture config registry of the port: the reference's eleven
configs, each a field-for-field copy, and its input shapes.

gpt2-xl (the paper's Table 1 model, no RoPE), rwkv6-1.6b (the
attention-free RWKV-6 family, recurrent serving state), jamba-v0.1-52b
(Mamba + GQA attention, MoE), the dense RoPE decoders stablelm-3b
(partial RoPE, 20 of 80 dims), phi3-medium-14b, minitron-4b and
deepseek-coder-33b (full RoPE, GQA with G = 4, 3 and 7), the RoPE MoEs
qwen2-moe-a2.7b (60 experts top-4, 4 shared) and granite-moe-1b-a400m
(32 experts top-8), and the frontend configs musicgen-large (sinusoidal
positions, audio frames) and internvl2-2b (RoPE, vision patches).
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs.base import (ArchConfig, CloverConfig,  # noqa: F401
                                      MoEConfig)
from repro_torch.configs.deepseek_coder_33b import \
    CONFIG as _DEEPSEEK_CODER_33B
from repro_torch.configs.gpt2_xl import CONFIG as _GPT2_XL
from repro_torch.configs.granite_moe_1b_a400m import \
    CONFIG as _GRANITE_MOE_1B_A400M
from repro_torch.configs.internvl2_2b import CONFIG as _INTERNVL2_2B
from repro_torch.configs.jamba_v0_1_52b import CONFIG as _JAMBA_V0_1_52B
from repro_torch.configs.minitron_4b import CONFIG as _MINITRON_4B
from repro_torch.configs.musicgen_large import CONFIG as _MUSICGEN_LARGE
from repro_torch.configs.phi3_medium_14b import CONFIG as _PHI3_MEDIUM_14B
from repro_torch.configs.qwen2_moe_a2_7b import CONFIG as _QWEN2_MOE_A2_7B
from repro_torch.configs.rwkv6_1_6b import CONFIG as _RWKV6_1_6B
from repro_torch.configs.shapes import (SHAPES, ShapeConfig,  # noqa: F401
                                        cell_applicable)
from repro_torch.configs.stablelm_3b import CONFIG as _STABLELM_3B

# the reference's registry order
_CONFIGS = {"qwen2-moe-a2.7b": _QWEN2_MOE_A2_7B,
            "granite-moe-1b-a400m": _GRANITE_MOE_1B_A400M,
            "phi3-medium-14b": _PHI3_MEDIUM_14B,
            "deepseek-coder-33b": _DEEPSEEK_CODER_33B,
            "minitron-4b": _MINITRON_4B,
            "stablelm-3b": _STABLELM_3B,
            "rwkv6-1.6b": _RWKV6_1_6B,
            "musicgen-large": _MUSICGEN_LARGE,
            "jamba-v0.1-52b": _JAMBA_V0_1_52B,
            "internvl2-2b": _INTERNVL2_2B,
            "gpt2-xl": _GPT2_XL}


def get_config(name: str) -> ArchConfig:
    if name not in _CONFIGS:
        raise KeyError(f"unknown arch {name!r}; the port knows "
                       f"{sorted(_CONFIGS)}")
    return _CONFIGS[name]


# every config but the paper's own testbed, in the registry's order
ASSIGNED_ARCHS: List[str] = [k for k in _CONFIGS if k != "gpt2-xl"]


def all_configs() -> Dict[str, ArchConfig]:
    return dict(_CONFIGS)
