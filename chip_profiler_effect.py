#!/usr/bin/env python3
"""Same-call A/B of the port's dense engines on one NVIDIA GPU, before
and after a ``torch.profiler`` session in the same process.

    python3 chip_profiler_effect.py

Three models at gpt2-xl's full width, random weights from seed 0:
A, ``clover_prune`` to 32/32 (the main path's); B, the checkerboard-
damped model under the spectrum-planned ``RankBudget`` at the same total
rank (``chip_smoke.py``'s budget phase, served with ``rank_budget``, so
decode runs the rank-clamped kernels); W, B's weights without the rank
vectors (the same 56/56 widths through the unranked kernels).  Each
serves the main path's 8 requests (32 new tokens) on a fresh dense
engine, in the order A B W A twice, then ``chip_smoke``'s profile phase
runs, then A B twice more.  Every line prints tokens/s and mean ITL
beside the card's name and power limit.  It asks whether a rank plan
or a profiler session moves the host-bound engines, within the spread
of repeated runs of one model.
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_profiler_effect: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.core.decompose import clover_decompose
    from repro_torch.core.prune import (apply_rank_budget, clover_prune,
                                        plan_rank_budget)
    from repro_torch.models.transformer import init_lm_params
    from repro_torch.serve import EngineConfig

    smoke = chip_smoke.Smoke(torch)
    smoke.phase_card()
    cfg = get_config("gpt2-xl")
    params = init_lm_params(cfg, chip_smoke.SEED)
    dparams, dcfg, _ = clover_decompose(params, cfg)
    del params
    a_params, a_cfg = clover_prune(dparams, dcfg, qk_ratio=0.5,
                                   vo_ratio=0.5)
    del dparams
    dparams, dcfg, extras = smoke.damped_decomposition(cfg)
    uniform = smoke.uniform_budget(extras, dcfg, a_cfg.qk_dim, a_cfg.vo_dim)
    plan = plan_rank_budget(extras, dcfg, total_rank=uniform.total_rank)
    b_params, b_cfg = apply_rank_budget(dparams, dcfg, plan)
    del dparams
    w_params = {**b_params, "blocks": tuple(
        {**b, "attn": {k: v for k, v in b["attn"].items()
                       if not k.startswith("rank_")}}
        for b in b_params["blocks"])}
    prompts = smoke.main_prompts(cfg)
    ek = dict(slots=4, max_len=512, prefill_chunk=64)
    runs = {"A 32/32": (a_params, a_cfg, EngineConfig(**ek)),
            "B budget": (b_params, b_cfg,
                         EngineConfig(rank_budget=plan, **ek)),
            "W 56/56 no ranks": (w_params, b_cfg, EngineConfig(**ek))}

    def serve(tag, prefix=""):
        smoke.serve_main(prefix + tag, *runs[tag], prompts)

    for _ in range(2):
        for tag in ("A 32/32", "B budget", "W 56/56 no ranks", "A 32/32"):
            serve(tag)
    smoke.phase_profile(b_params, b_cfg, plan)
    for _ in range(2):
        for tag in ("A 32/32", "B budget"):
            serve(tag, "after profile ")
    if smoke.failures:
        print("FAILED:\n  " + "\n  ".join(smoke.failures))
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
