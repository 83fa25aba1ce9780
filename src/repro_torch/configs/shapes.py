"""The reference's input shapes and (arch x shape) cell applicability
(own copy of ``repro``'s ``configs/shapes.py``).

LM transformer shapes are seq_len x global_batch.  ``decode_*`` /
``long_*`` are serve steps (one new token against a KV cache of
``seq_len``), not train steps.  ``long_500k`` needs a sub-quadratic
token-mixing path and applies only to the SSM / hybrid archs; pure
full-attention archs skip it (DESIGN.md §5).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def cell_applicable(arch_cfg, shape: ShapeConfig) -> bool:
    """Whether (arch x shape) is a runnable cell: ``long_500k`` only for
    archs with a sub-quadratic path (``supports_long_context``); every
    other shape applies to every arch (all are decoder-style)."""
    if shape.name == "long_500k":
        return arch_cfg.supports_long_context
    return True
