"""Executor of the port: runs planned engine steps on the device —
own port of ``LocalExecutor`` from ``repro/serve/executor.py``
(DESIGN.md §6, §10).

The engine plans WHAT happens each step (host numpy); the executor
holds the params and the decode state on the device and runs the two
step entries, ``prefill_chunk`` and ``decode_step``.  PyTorch runs
eagerly, so there is no jit cache; ``compiled_shapes()`` counts the
distinct (entry, input shapes) pairs run instead, which is what the
reference's jit cache counts.  The contract stays the same: 2 for any
prompt-length mix, dense or paged (DESIGN.md §6).

The decode state's KV caches are updated in place by every step.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as T
from repro_torch.serve.config import EngineConfig

Params = Dict[str, Any]


def _reset_fresh(state: Params, fresh: torch.Tensor,
                 resume: torch.Tensor) -> Params:
    """Set freshly admitted (and idle) rows' ``index`` to ``resume``.
    KV caches keep their stale contents, masked by the per-slot index
    until overwritten.  (The reference also zeroes recurrent state
    here; attention-only models have none.)"""
    index = torch.where(fresh, resume.to(state["index"].dtype),
                        state["index"])
    return {"blocks": state["blocks"], "index": index}


def _merge_inactive(old_blocks, new_blocks, active: torch.Tensor):
    """Keep inactive slots' recurrent state across a chunk step.  KV
    caches are taken wholesale: inactive rows' padded writes land past
    their index (masked or overwritten before readable) or, paged, in
    the garbage row.  Attention-only models carry KV leaves only, so
    the new blocks are returned as they are; a recurrent leaf (the
    reference's per-row select) is not ported yet."""
    del old_blocks, active
    for entry in new_blocks:
        if set(entry) != {"kv"}:
            raise NotImplementedError("recurrent decode state is not "
                                      "ported yet")
    return new_blocks


class LocalExecutor:
    """Single-device executor — params used where they are."""

    def __init__(self, params: Params, cfg: ArchConfig, ecfg: EngineConfig,
                 device: torch.device):
        self.params = params
        self.cfg = cfg
        self.ecfg = ecfg
        self.device = device
        self._shapes: Set[Tuple] = set()

    def _t(self, a, dtype=None) -> Optional[torch.Tensor]:
        if a is None:
            return None
        return torch.as_tensor(np.asarray(a), device=self.device,
                               dtype=dtype)

    def _record(self, entry: str, *arrays) -> None:
        self._shapes.add((entry,) + tuple(
            None if a is None else tuple(np.shape(a)) for a in arrays))

    def init_state(self) -> Params:
        cfg, ecfg = self.cfg, self.ecfg
        if ecfg.paged:
            return T.init_decode_state_paged(cfg, ecfg.slots,
                                             ecfg.pool_pages,
                                             ecfg.page_tokens,
                                             device=self.device)
        state = T.init_decode_state(cfg, ecfg.slots, ecfg.capacity,
                                    device=self.device)
        # per-slot positions: slots at different depths share one batch
        state["index"] = torch.zeros((ecfg.slots,), dtype=torch.int32,
                                     device=self.device)
        return state

    def prefill_chunk(self, state, tokens, lengths, fresh, resume, pages,
                      wfloor):
        """(slots, C) chunk step -> (last-valid logits, new state)."""
        self._record("prefill_chunk", tokens, lengths, fresh, resume, pages,
                     wfloor)
        st = _reset_fresh(state, self._t(fresh, torch.bool),
                          self._t(resume))
        lens = self._t(lengths, torch.int32)
        logits, new = T.prefill_chunk(
            self.params, self.cfg, self._t(tokens, torch.long), st, lens,
            pages=self._t(pages, torch.int32),
            write_floor=self._t(wfloor, torch.int32))
        blocks = _merge_inactive(st["blocks"], new["blocks"], lens > 0)
        return logits, {"blocks": blocks, "index": new["index"]}

    def decode_step(self, state, tok, fresh, resume, pages, wfloor):
        """(slots,) one-token step -> (logits, new state)."""
        self._record("decode_step", tok, fresh, resume, pages, wfloor)
        st = _reset_fresh(state, self._t(fresh, torch.bool),
                          self._t(resume))
        return T.decode_step(self.params, self.cfg,
                             self._t(tok, torch.long), st,
                             pages=self._t(pages, torch.int32),
                             write_floor=self._t(wfloor, torch.int32))

    def compiled_shapes(self) -> int:
        """Distinct (entry, input shapes) pairs run so far: 2 (chunk +
        decode) for any prompt-length mix."""
        return len(self._shapes)
