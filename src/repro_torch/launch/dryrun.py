"""Production dry-run of the port: trace every (arch x shape) cell as
one rank of the production meshes and report per-device memory, FLOPs,
HBM bytes, collective bytes, the three roofline terms on the H100's
constants (``parallel.hlo``) and the roofline fraction -- the port's
counterpart of ``repro/launch/dryrun.py``.

Usage (CPU only, no card, no allocation):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch phi3-medium-14b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --json out.json

Everything runs on the ``meta`` device as rank 0 of the (16, 16) or (2,
16, 16) mesh: a ``fake`` process group (``torch.testing._internal.
distributed.fake_pg``; the dry-run raises where torch lacks it) of 256
or 512 ranks gives ``launch.mesh.make_production_mesh`` its real
per-axis groups, the collectives complete without moving anything, and
the group is torn down after each cell.  The cells run the real steps:
``train.step.make_train_step`` for train cells, ``make_serve_step``'s
prefill and decode for the others, under one recorder, a
``TorchDispatchMode`` that sees every op once: it counts the products'
FLOPs by ``torch.utils.flop_counter``'s per-op formulas (the registry
``FlopCounterMode`` counts with; one mode instead of two halves the
trace's time; the kernels' meta routes add their analytic counts,
``kernels.ops.kernel_costs``), sums each op's input and output bytes
(XLA's "bytes accessed"; views and allocations move nothing, an indexed
in-place write moves its source) and tracks the live bytes the step
creates by storage, freed when the last tensor on a storage dies.  The
collective bytes are the rank's own (``parallel.sharding.
COLLECTIVE_LOG``).

A trace runs every layer it holds, so every cell is traced whole at
full depth (``calibrated_costs``).  The counts are the port's program: where it does more work than the
reference (a bf16 model's float32 casts at the kernels, recurrent
layers run whole on every "model" rank, heads replicated where their
count does not divide "model"), the count shows it.  A train cell's
microbatch count is the largest divisor of this rank's rows that does
not exceed the reference's (the port splits each rank's rows; at (2,
16, 16) deepseek-coder-33b's 16 becomes 8).  On meta each MoE expert
takes an even share of the routed slots (``models.moe``).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time
import weakref
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
from torch.utils import flop_counter
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import (ASSIGNED_ARCHS, SHAPES, ArchConfig,
                                 cell_applicable, get_config)
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import transformer as T
from repro_torch.optim import AdamWConfig
from repro_torch.parallel import hlo as H
from repro_torch.parallel import sharding as sh
from repro_torch.train.step import (TrainConfig, make_opt_state,
                                    make_serve_step, make_train_step,
                                    place_train_state)
from repro_torch.tree import tree_leaves

META = torch.device("meta")

# Default microbatch count for train cells: global batch 256 -> 16 per
# device on the data axis -> microbatch 2/device (the reference's).
TRAIN_MICROBATCHES = 8

# Per-arch memory tuning for the train shape (the reference's): the
# deepest model also groups remat so layer carries shrink 2x.
TRAIN_TUNING = {
    "deepseek-coder-33b": {"microbatches": 16, "remat_group": 2},
}


def production_cfg(name: str) -> ArchConfig:
    """Full assigned config at production numerics: bf16 params/compute,
    vocab padded to 128 so the logits shard on the model axis."""
    return dataclasses.replace(get_config(name),
                               param_dtype="bfloat16",
                               compute_dtype="bfloat16",
                               pad_vocab_to=128)


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Meta stand-ins for every model input of this cell (the global
    batch).

    train:   {tokens, labels} (+frontend_embeds)
    prefill: {tokens} (+frontend_embeds) — full prompt
    decode:  {token} — one new token against a seq_len KV cache
    """
    B, S = shape.global_batch, shape.seq_len
    F = cfg.frontend_len if cfg.frontend != "none" else 0
    n_tok = S - F  # backbone sees exactly seq_len positions
    i32 = torch.int32
    cdt = (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
           else torch.float32)

    def spec(shp, dtype):
        return torch.empty(shp, dtype=dtype, device=META)

    out: Dict[str, Any] = {}
    if shape.kind == "train":
        out["tokens"] = spec((B, n_tok), i32)
        out["labels"] = spec((B, n_tok), i32)
        if F:
            out["frontend_embeds"] = spec((B, F, cfg.d_model), cdt)
    elif shape.kind == "prefill":
        out["tokens"] = spec((B, n_tok), i32)
        if F:
            out["frontend_embeds"] = spec((B, F, cfg.d_model), cdt)
    else:  # decode
        out["token"] = spec((B,), i32)
    return out


# ---------------------------------------------------------------------------
# recorders
# ---------------------------------------------------------------------------

def _storage_id(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


_INDEXED_WRITES = {"index_copy_", "index_put_", "index_add_", "scatter_",
                   "scatter_add_", "masked_scatter_"}
_NO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided", "detach", "lift_fresh", "alias"}
_WRITE, _INPLACE, _OP, _SKIP = range(4)


def _tensor_leaves(x, out):
    """The tensors in an op's (nested tuple / list / dict) arguments."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (tuple, list)):
        for y in x:
            _tensor_leaves(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _tensor_leaves(y, out)
    return out


class _Recorder(TorchDispatchMode):
    """One pass over every op the step dispatches: its FLOPs by
    ``torch.utils.flop_counter``'s per-op formulas (the registry
    ``FlopCounterMode`` counts with: the products), the bytes it reads
    and writes, and the peak of the live bytes of the storages the step
    creates."""

    def __init__(self, known_storages):
        super().__init__()
        self.flops = 0
        self.hbm = 0
        self.live = 0
        self.peak = 0
        self.known = set(known_storages)    # the step's arguments
        self.refs: Dict[int, list] = {}     # storage id -> [bytes, refs]
        self.kinds: Dict[Any, tuple] = {}   # op -> (kind, flop formula)

    def _free(self, sid: int) -> None:
        entry = self.refs.get(sid)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self.live -= entry[0]
            del self.refs[sid]

    def _track(self, t: torch.Tensor) -> None:
        sid = _storage_id(t)
        if sid in self.known:
            return
        entry = self.refs.get(sid)
        if entry is None:
            entry = self.refs[sid] = [t.untyped_storage().nbytes(), 0]
            self.live += entry[0]
            self.peak = max(self.peak, self.live)
        entry[1] += 1
        weakref.finalize(t, self._free, sid)

    def _kind(self, func):
        got = self.kinds.get(func)
        if got is None:
            name = func.overloadpacket.__name__
            if (func.is_view or name in _NO_BYTES
                    or func.namespace in ("c10d", "_c10d_functional")):
                kind = _SKIP
            elif name in _INDEXED_WRITES:
                kind = _WRITE
            elif name.endswith("_"):
                kind = _INPLACE
            else:
                kind = _OP
            got = self.kinds[func] = (
                kind, flop_counter.flop_registry.get(func.overloadpacket))
        return got

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        kind, flops = self._kind(func)
        outs = _tensor_leaves(out, [])
        for t in outs:
            self._track(t)
        if flops is not None:
            self.flops += flops(*args, **kwargs, out_val=out)
        if kind == _SKIP:
            return out
        ins = _tensor_leaves((args, kwargs), [])
        if kind == _WRITE:              # the source and the index move
            self.hbm += 2 * H.nbytes(ins[1:])
        elif kind == _INPLACE:          # in place: self once, written
            self.hbm += H.nbytes(ins[1:]) + H.nbytes(outs)
        else:
            self.hbm += H.nbytes(ins) + H.nbytes(outs)
        return out


@dataclasses.dataclass
class Trace:
    """One traced step on one rank: FLOPs (products plus the kernels'
    analytic counts), bytes accessed, the collective log, and memory."""
    flops: float
    hbm_bytes: float
    log: Dict
    argument_bytes: int
    input_bytes: int
    output_bytes: int
    temp_bytes: int


def _tensors(tree):
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def trace(fn, args, inputs=()) -> Trace:
    """Run ``fn()`` under the recorders; ``args`` (a tree) holds the
    step's state arguments and ``inputs`` its batch inputs, whose bytes
    together are ``argument_bytes`` (``input_bytes`` the inputs')."""
    arg_ts = _tensors((args, inputs))
    known = {_storage_id(t) for t in arg_ts}
    kern = {"flops": 0.0, "bytes": 0.0}

    def sink(_name, flops, nbytes):
        kern["flops"] += flops
        kern["bytes"] += nbytes

    sh.reset_collectives()
    rec = _Recorder(known)
    with ops.kernel_costs(sink), rec:
        out = fn()
    outs = {_storage_id(t): t.untyped_storage().nbytes()
            for t in _tensors(out) if _storage_id(t) not in known}
    arg_bytes = sum({_storage_id(t): t.untyped_storage().nbytes()
                     for t in arg_ts}.values())
    result = Trace(flops=float(rec.flops) + kern["flops"],
                   hbm_bytes=float(rec.hbm) + kern["bytes"],
                   log=dict(sh.COLLECTIVE_LOG), argument_bytes=arg_bytes,
                   input_bytes=H.nbytes(_tensors(inputs)),
                   output_bytes=sum(outs.values()), temp_bytes=rec.peak)
    del out
    return result


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def fake_world(size: int):
    """A fake process group of ``size`` ranks, this process rank 0, torn
    down on exit."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:            # pragma: no cover - torch build
        raise RuntimeError("the dry-run needs torch's fake process group "
                           "(torch.testing._internal.distributed.fake_pg)"
                           ) from e
    if dist.is_initialized():
        raise RuntimeError("the dry-run needs its own process group; one "
                           "is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _rows(t, bspec, mesh):
    """This rank's rows of a global input, in a storage of their own."""
    return sh.local_slice(t, sh.Spec(tuple(bspec[:1])
                                     + (None,) * (t.dim() - 1)), mesh).clone()


def _microbatches(want: int, rows: int) -> int:
    """The largest divisor of ``rows`` that is at most ``want``."""
    return max(d for d in range(1, min(want, rows) + 1) if rows % d == 0)


def trace_cell(cfg: ArchConfig, shape: ShapeConfig, mesh,
               rules: Optional[sh.ShardingRules] = None, *,
               remat: bool = True,
               microbatches: int = TRAIN_MICROBATCHES) -> Trace:
    """Trace the cell's step on this rank of ``mesh`` (its device meta)
    -> ``Trace``.  The reference's ``lower_cell``."""
    rules = rules or sh.ShardingRules()
    ins = input_specs(cfg, shape)
    bspec = sh.data_specs(mesh, rules, global_batch=shape.global_batch)
    params = T.init_lm_params(cfg, device=META)
    if shape.kind == "train":
        local = {k: _rows(v, bspec, mesh) for k, v in ins.items()}
        m = _microbatches(microbatches, local["tokens"].shape[0])
        tcfg = TrainConfig(optimizer=AdamWConfig(), remat=remat,
                           microbatches=m)
        step = make_train_step(cfg, tcfg, mesh)
        p_l, o_l, specs = place_train_state(params, make_opt_state(params),
                                            mesh, rules)
        del params
        return trace(lambda: step(p_l, o_l, local, specs=specs["params"]),
                     (p_l, o_l), local)
    state = T.init_decode_state(cfg, shape.global_batch, shape.seq_len,
                                device=META)
    _, _, compile_serve = make_serve_step(cfg, mesh, rules)
    steps = compile_serve(params, state, shape.global_batch, shape.seq_len)
    del params, state
    if shape.kind == "prefill":
        local = {k: _rows(v, bspec, mesh) for k, v in ins.items()}
        return trace(lambda: steps.prefill(ins["tokens"], steps.state,
                                           ins.get("frontend_embeds")),
                     (steps.params, steps.state), local)
    local = _rows(ins["token"], bspec, mesh)
    return trace(lambda: steps.decode(ins["token"], steps.state),
                 (steps.params, steps.state), local)


def calibrated_costs(cfg: ArchConfig, shape: ShapeConfig, mesh,
                     rules: Optional[sh.ShardingRules] = None, *,
                     remat: bool = True,
                     microbatches: int = TRAIN_MICROBATCHES
                     ) -> Dict[str, Any]:
    """The cell's full-depth counts: FLOPs, bytes accessed, collective
    bytes by kind, and memory.  The reference compiles its model at one
    and two periods and finite-differences over depth, because XLA
    counts a scanned layer body once.  The port's trace runs every layer
    it holds, so the cell is traced whole and nothing is extrapolated.
    -> {"flops", "hbm_bytes", "coll_bytes", "coll_detail", "memory" (the
    reference's keys, ``parallel.hlo.memory_per_device``)}."""
    tr = trace_cell(cfg, shape, mesh, rules, remat=remat,
                    microbatches=microbatches)
    coll = H.collective_bytes(tr.log)
    return {"flops": float(tr.flops), "hbm_bytes": float(tr.hbm_bytes),
            "coll_bytes": float(sum(coll.values())),
            "coll_detail": {k: v for k, v in coll.items() if v},
            "memory": H.memory_per_device(tr)}


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             rules: Optional[sh.ShardingRules] = None, remat: bool = True,
             verbose: bool = True) -> Dict[str, Any]:
    """One cell -> the reference's result keys.  ``lower_s`` is the
    trace's wall time; ``compile_s`` is 0 (nothing compiles; the
    reference's ``unroll`` has no counterpart: the trace runs every layer
    it holds)."""
    cfg = production_cfg(arch)
    tuning = dict(TRAIN_TUNING.get(arch, {})) if shape_name.startswith(
        "train") else {}
    microbatches = tuning.pop("microbatches", TRAIN_MICROBATCHES)
    if tuning:
        cfg = dataclasses.replace(cfg, **tuning)
    shape = SHAPES[shape_name]
    if not cell_applicable(cfg, shape):
        return {"arch": arch, "shape": shape_name, "status": "skipped",
                "reason": "long_500k needs sub-quadratic mixing "
                          "(DESIGN.md §5)"}
    with fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device=META)
        t0 = time.time()
        cal = calibrated_costs(cfg, shape, mesh, rules, remat=remat,
                               microbatches=microbatches)
        t1 = time.time()
        mem = cal["memory"]
        n_chips = mesh.size
        mesh_shape = tuple(mesh.shape.values())
    rl = H.roofline(cal["flops"], cal["hbm_bytes"], cal["coll_detail"])
    # MODEL_FLOPS: 6 N D for train, 2 N D for inference (per token);
    # MoE uses active params.  Per-device = global / chips.
    n_active = cfg.n_params(active_only=True)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mult = 6 if shape.kind == "train" else 2
    model_flops = mult * n_active * tokens / n_chips
    res = {
        "arch": arch, "shape": shape_name, "status": "ok",
        "mesh": mesh_shape, "multi_pod": multi_pod,
        "lower_s": round(t1 - t0, 1), "compile_s": 0.0,
        "bytes_per_device_gib": round(mem["total_gib"], 3),
        "flops_per_device": rl.flops,
        "hbm_bytes_per_device": rl.hbm_bytes,
        "collective_bytes": rl.coll_bytes,
        "collective_detail": {k: v for k, v in rl.coll_detail.items() if v},
        "t_compute_s": rl.t_compute,
        "t_memory_s": rl.t_memory,
        "t_collective_s": rl.t_collective,
        "dominant": rl.dominant,
        "model_flops_per_device": model_flops,
        "useful_flops_ratio": model_flops / max(rl.flops, 1.0),
        "roofline_fraction": rl.fraction(model_flops),
    }
    if verbose:
        print(f"[{arch} x {shape_name}] mesh={res['mesh']} "
              f"mem={res['bytes_per_device_gib']}GiB "
              f"compute={rl.t_compute*1e3:.2f}ms "
              f"memory={rl.t_memory*1e3:.2f}ms "
              f"collective={rl.t_collective*1e3:.2f}ms "
              f"dominant={rl.dominant} "
              f"roofline={res['roofline_fraction']:.3f} "
              f"({res['lower_s']} s)", flush=True)
    return res


def _cell(a: str, s: str, multi_pod: bool) -> Dict[str, Any]:
    """One cell -> its result, a failure reported and the sweep going
    on."""
    try:
        return run_cell(a, s, multi_pod=multi_pod)
    except Exception as e:  # noqa: BLE001 — report and continue sweep
        print(f"[{a} x {s}] FAILED: {type(e).__name__}: {e}",
              file=sys.stderr, flush=True)
        return {"arch": a, "shape": s, "status": "failed",
                "error": f"{type(e).__name__}: {e}"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)

    if args.all:
        cells = [(a, s) for a in ASSIGNED_ARCHS for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape)]

    t0 = time.time()
    results = [_cell(a, s, args.multi_pod) for a, s in cells]
    failed = [r for r in results if r["status"] == "failed"]
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1, default=str)
    ok = sum(1 for r in results if r["status"] == "ok")
    sk = sum(1 for r in results if r["status"] == "skipped")
    print(f"\n{ok} ok, {sk} skipped, {len(failed)} failed "
          f"of {len(results)} cells ({time.time() - t0:.1f} s)")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
