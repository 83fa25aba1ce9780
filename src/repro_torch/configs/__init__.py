"""Architecture config registry of the port.

Only gpt2-xl (the paper's Table 1 model, no RoPE) is ported so far;
the other architectures arrive with their slices (RoPE, GQA, MoE,
recurrent mixers).
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig, CloverConfig  # noqa: F401
from repro_torch.configs.gpt2_xl import CONFIG as _GPT2_XL

_CONFIGS = {"gpt2-xl": _GPT2_XL}


def get_config(name: str) -> ArchConfig:
    if name not in _CONFIGS:
        raise KeyError(f"unknown arch {name!r}; the port knows "
                       f"{sorted(_CONFIGS)}")
    return _CONFIGS[name]
