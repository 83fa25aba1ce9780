"""Roofline analysis of a traced step: collective bytes and the three
roofline terms -- the port's counterpart of ``repro/parallel/hlo.py``.

The reference reads a compiled per-device SPMD program (XLA's
``cost_analysis`` and the collectives in its HLO text).  The port has no
compiled program: ``launch.dryrun`` traces one rank of the production
mesh on the meta device, counting FLOPs (``torch.utils.flop_counter``
plus the kernels' analytic counts), bytes every op reads and writes,
live bytes, and every collective the rank issues
(``parallel.sharding.COLLECTIVE_LOG``).  These are per-device
quantities, as the reference's are.

Hardware model (NVIDIA H100 SXM5 80GB HBM3 at its 700 W power limit,
NVIDIA's H100 Tensor Core GPU data sheet, as the ``hopper-kernels``
guide quotes it; per card):

  peak bf16 dense tensor-core compute   989 TFLOP/s
  HBM3 bandwidth                        3.35 TB/s
  NVLink 4 per direction                450 GB/s (900 GB/s both ways)

The collective term models every mesh axis as the card's NVLink, one
direction, as the reference's ICI term models one torus.  An axis that
spans hosts (the production meshes' 256 and 512 cards do; so does
"pod") runs over the slower inter-host network, which this term does
not model.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterable, Mapping, Tuple

PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
LINK_BW = 450e9

# the reference's collective kinds, and the port's broadcast
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute", "broadcast")

# the port's kind -> the reference's HLO opcode
_KIND = {"all_gather": "all-gather", "all_reduce": "all-reduce",
         "reduce_scatter": "reduce-scatter", "send": "collective-permute",
         "recv": None, "broadcast": "broadcast"}


def collective_bytes(log: Mapping[Tuple[str, int, int], int]
                     ) -> Dict[str, int]:
    """Per-device OPERAND bytes of every collective, keyed by kind.

    ``log`` maps (kind, result bytes, group size g) -> count, as
    ``parallel.sharding.COLLECTIVE_LOG`` records them; the operand
    follows the reference's convention for an HLO line:

      all-reduce          operand == result
      all-gather          operand == result / g   (result is gathered)
      reduce-scatter      operand == result * g   (result is scattered)
      collective-permute  operand == result       (a pipeline send)
      broadcast           operand == result

    A pipeline ``recv`` is the other half of its sender's permute and
    is not counted again."""
    out: Dict[str, int] = {c: 0 for c in COLLECTIVES}
    for (kind, result, g), n in log.items():
        op = _KIND[kind]
        if op is None:
            continue
        g = max(1, int(g))
        if op == "all-gather":
            result = result // g
        elif op == "reduce-scatter":
            result = result * g
        out[op] += result * n
    return out


@dataclass
class Roofline:
    flops: float                 # per-device FLOPs
    hbm_bytes: float             # per-device bytes accessed
    coll_bytes: float            # per-device collective operand bytes
    coll_detail: Dict[str, int]
    t_compute: float             # seconds
    t_memory: float
    t_collective: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def bound(self) -> float:
        """Roof-bound step time (s) = max of the three terms."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    def fraction(self, model_flops_per_device: float) -> float:
        """Achievable roofline fraction = useful-compute time / bound."""
        t_useful = model_flops_per_device / PEAK_FLOPS
        return t_useful / max(self.bound, 1e-30)


def roofline(flops: float, hbm_bytes: float,
             coll: Mapping[str, int]) -> Roofline:
    """The three terms of per-device counts."""
    cb = float(sum(coll.values()))
    return Roofline(flops=float(flops), hbm_bytes=float(hbm_bytes),
                    coll_bytes=cb, coll_detail=dict(coll),
                    t_compute=flops / PEAK_FLOPS,
                    t_memory=hbm_bytes / HBM_BW,
                    t_collective=cb / LINK_BW)


def roofline_from_trace(trace: Any) -> Roofline:
    """The three roofline terms of a traced step (``launch.dryrun.
    Trace``: ``flops``, ``hbm_bytes`` and its collective ``log``) --
    the counterpart of the reference's ``roofline_from_compiled``."""
    return roofline(trace.flops, trace.hbm_bytes,
                    collective_bytes(trace.log))


def memory_per_device(trace: Any) -> Dict[str, float]:
    """The reference's memory keys of a traced step: argument bytes
    (this rank's params, optimizer state, decode state and inputs) and
    temp bytes (the peak of the live bytes the step created); output
    bytes are the step's new state, counted within temp; no generated
    code."""
    out = {"argument_size_in_bytes": float(trace.argument_bytes),
           "output_size_in_bytes": float(trace.output_bytes),
           "temp_size_in_bytes": float(trace.temp_bytes),
           "generated_code_size_in_bytes": 0.0}
    out["total_gib"] = (out["argument_size_in_bytes"]
                        + out["temp_size_in_bytes"]) / 2**30
    return out


def nbytes(tensors: Iterable) -> int:
    """Bytes of the tensors (``None`` skipped)."""
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)
