"""Optimizer and schedules of the port (plain torch, no torch.optim)."""
from repro_torch.optim.adamw import (  # noqa: F401
    AdamWConfig, adamw_init, adamw_update, clip_by_global_norm,
    global_norm, warmup_cosine, warmup_linear)
