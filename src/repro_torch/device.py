"""Device resolution for the port's entry points.

The card is the default: an entry point given no device runs on
``cuda``.  Without a card it raises; it never falls back to the CPU.
The CPU runs only when the caller asks for it (``device="cpu"``), as
the tests do.  ``meta`` holds shapes and no data: the sharded executor
plans its state layout there.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; raise if a CUDA device is asked for and
    there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}: expected cuda or cpu")
    return dev

