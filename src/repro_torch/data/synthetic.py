"""Deterministic synthetic LM data with exactly-resumable iterator state
— own copy of ``repro/data/synthetic.py``.

The stream is a counter-addressed PRNG: batch ``i`` is a pure function
of (seed, i), so the iterator state is one integer, ``batch_at(i)`` is
bit for bit the reference's, and any data-parallel rank can regenerate
any shard: ``make_global_batch`` takes this rank's rows of the host
batch (elastic resharding needs no data redistribution).  The tokens follow a small
induction-head-friendly Markov chain (repeating patterns, 10% noise), so
recovery fine-tuning and PEFT have something to learn.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterator

import numpy as np
import torch

from repro_torch.parallel.sharding import local_slice


@dataclass(frozen=True)
class SyntheticConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_patterns: int = 64      # distinct bigram patterns
    pattern_len: int = 8      # repeat period


class SyntheticLM:
    """Iterator over {tokens, labels} global batches (int32 numpy).

    State = {"step": int}.  ``batch_at(step)`` is pure; ``__next__``
    advances the counter.
    """

    def __init__(self, cfg: SyntheticConfig):
        self.cfg = cfg
        self.step = 0
        rng = np.random.default_rng(cfg.seed)
        # fixed library of repeating patterns (the learnable structure)
        self.patterns = rng.integers(
            0, cfg.vocab_size, (cfg.n_patterns, cfg.pattern_len),
            dtype=np.int32)

    def state_dict(self) -> Dict[str, Any]:
        return {"step": self.step, "seed": self.cfg.seed}

    def load_state_dict(self, st: Dict[str, Any]):
        assert st["seed"] == self.cfg.seed, "stream identity mismatch"
        self.step = int(st["step"])

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed << 20) ^ step)
        B, S = cfg.global_batch, cfg.seq_len
        pat = rng.integers(0, cfg.n_patterns, (B,))
        base = self.patterns[pat]                       # (B, P)
        reps = (S + cfg.pattern_len) // cfg.pattern_len + 1
        seq = np.tile(base, (1, reps))[:, :S + 1]
        # noise: corrupt 10% of positions so the task isn't trivial
        noise = rng.random((B, S + 1)) < 0.10
        rand = rng.integers(0, cfg.vocab_size, (B, S + 1), dtype=np.int32)
        seq = np.where(noise, rand, seq).astype(np.int32)
        return {"tokens": seq[:, :-1], "labels": seq[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        b = self.batch_at(self.step)
        self.step += 1
        return b


def make_global_batch(batch_np: Dict[str, np.ndarray], mesh,
                      spec) -> Dict[str, torch.Tensor]:
    """Host numpy batch -> this rank's rows under ``spec`` (the
    ``parallel.sharding.data_specs`` of ``mesh``), as tensors on the
    mesh's device; the whole batch where the spec replicates it."""
    return {k: local_slice(torch.from_numpy(np.ascontiguousarray(v)), spec,
                           mesh).to(mesh.device)
            for k, v in batch_np.items()}
