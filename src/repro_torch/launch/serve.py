"""Tensor-parallel serving on one host: spawn ``data * tp`` rank
processes, each running the same engine on its shard (DESIGN.md §10):
``data`` replicas of the ``tp`` shards, each replica serving its block
of the slots.

    runs = [ServeRun("dense", params, cfg, EngineConfig(tp=2, ...), waves)]
    per_rank = serve_tp(runs, tp=2, backend="nccl")   # one card per rank
    per_rank = serve_tp(runs, tp=2, data=2, backend="nccl")   # 4 ranks

``serve_tp`` starts the ranks through ``launch.spawn.spawn`` (the
``spawn`` start method, a ``file://`` rendezvous, an explicit backend),
runs every ``ServeRun`` in order on each rank through ``serve_waves``
and returns each rank's results.  Params pass to the ranks as they are:
CUDA tensors through CUDA IPC (each rank keeps only its slices), CPU
tensors through shared memory.  ``nccl`` needs one card per rank;
``gloo`` runs ``all_reduce`` and ``broadcast`` on CUDA tensors through
host memory and is the one backend that can put several ranks on one
card (and the one that runs on the CPU).  A rank that raises or outlives
``timeout`` fails the call, and every rank is stopped before it
returns.

``serve_waves`` is also the tp = 1 run of the same work in this process,
so one function produces what is compared.

``serve_step_ranks`` runs ``train.step.make_serve_step`` (serving under
training's rules: FSDP weights, the batch over "data", the dense cache's
sequence over "model") on spawned ranks: each ``StepRun`` prefills its
prompt batches and decodes greedily, on its own mesh of the group's
ranks; ``run_steps`` is the same in this process.
"""
from __future__ import annotations

import dataclasses
import gc
import math
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.spawn import spawn
from repro_torch.parallel import sharding as sh
from repro_torch.serve.engine import Engine
from repro_torch.serve.executor import ShardedExecutor
from repro_torch.serve.scheduler import Request
from repro_torch.tree import tree_leaves


@dataclasses.dataclass
class ServeRun:
    """One engine's work: request ``waves`` (each a list of ``Request``
    keyword dicts) served to the end one after another on a fresh engine.
    ``plan``: an explicit head partition (``core.prune.HeadPartition``)
    for the sharded executor, instead of the one the engine plans;
    ``adapters``: an SV-adapter registry; ``trace``: record the
    scheduling state after every step (``step_record``);
    ``trace_logits``: record every executor entry's logits, in call
    order, as ``(entry, float32 numpy array)``."""
    label: str
    params: Any
    cfg: Any
    ecfg: Any
    waves: Sequence[Sequence[Dict[str, Any]]]
    plan: Any = None
    adapters: Any = None
    trace: bool = False
    trace_logits: bool = False


ENTRIES = ("prefill_chunk", "decode_step", "draft_step", "verify_chunk")


def record_logits(exe, out: list) -> None:
    """Wrap the executor's step entries so each call appends (entry,
    its logits as float32 numpy) to ``out``."""
    for name in ENTRIES:
        def entry(*args, _f=getattr(exe, name), _n=name, **kw):
            logits, state = _f(*args, **kw)
            lg = logits.float().cpu() if torch.is_tensor(logits) else logits
            out.append((_n, np.asarray(lg, np.float32)))
            return logits, state
        setattr(exe, name, entry)


def step_record(eng) -> Dict[str, Any]:
    """The engine's host scheduling state after a step, as plain Python
    values (works on any engine with the reference's attribute names)."""
    idx = eng.state["index"]
    if torch.is_tensor(idx):
        idx = idx.cpu()
    rec = {"phase": list(eng.sched.phase),
           "index": np.asarray(idx).tolist(),
           "spec_rounds": eng.spec_rounds,
           "accept_hist": dict(eng.accept_hist),
           "preemptions": eng.sched.preemptions}
    if eng.alloc is not None:
        rec.update(tables=[list(t) for t in eng.alloc.tables],
                   free=list(eng.alloc.free_list),
                   refcount=list(eng.alloc.refcount))
    return rec


def serve_waves(run: ServeRun, *, device=None) -> Dict[str, Any]:
    """Serve ``run`` on a fresh engine in this process (one rank of a
    group when ``run.ecfg.tp > 1``) -> its streams, per-step records,
    step and shape counts, stats, kernel launches, collectives, wall
    time, tokens/s, mean ITL and (on a card) peak memory."""
    ecfg = run.ecfg
    cuda = (torch.device(device).type == "cuda" if device is not None
            else torch.cuda.is_available())
    gc.collect()            # an earlier run's engine (reference cycles)
    if cuda:
        # the peak covers placing this rank's shard and serving
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    executor = None
    if run.plan is not None:
        mesh = make_host_mesh(data=ecfg.data, model=ecfg.tp, device=device)
        executor = ShardedExecutor(
            run.params, run.cfg, ecfg, mesh, plan=run.plan,
            adapter_bank=(run.adapters.bank() if run.adapters is not None
                          else None))
    eng = Engine(run.params, run.cfg, ecfg, device=device,
                 adapters=run.adapters, executor=executor)
    if cuda:
        torch.cuda.synchronize(eng.device)
    logits: list = []
    if run.trace_logits:
        record_logits(eng.exe, logits)
    launches0 = ops.launch_counts()
    sh.reset_collectives()
    trace, waves, uid = [], [], 0
    t0 = time.perf_counter()
    for wave in run.waves:
        reqs = []
        for kw in wave:
            reqs.append(Request(**dict({"uid": uid}, **kw)))
            uid += 1
        for r in reqs:
            eng.submit(r)
        while eng.sched.busy:
            eng.step()
            if run.trace:
                trace.append(step_record(eng))
        waves.append(reqs)
    if cuda:
        torch.cuda.synchronize(eng.device)
    wall = time.perf_counter() - t0
    launches1 = ops.launch_counts()
    reqs = [r for w in waves for r in w]
    n_tok = sum(len(r.generated) for r in reqs)
    itl = [d for r in reqs for d in np.diff(r.token_times)]
    exe = eng.exe
    out = {
        "label": run.label,
        "streams": [[list(r.generated) for r in w] for w in waves],
        "status": [[r.status for r in w] for w in waves],
        "cached_tokens": [[r.cached_tokens for r in w] for w in waves],
        "trace": trace, "logits": logits, "steps": eng.steps,
        "compiled_shapes": eng.compiled_shapes(),
        "stats": {k: v for k, v in eng.stats().items()
                  if isinstance(v, (int, float, str))},
        "launches": {k: launches1[k] - launches0[k] for k in launches1},
        "collectives": dict(sh.COLLECTIVES),
        "wall": wall, "tokens": n_tok,
        "tokens_per_s": n_tok / wall if wall > 0 else float("nan"),
        "itl_ms": 1e3 * float(np.mean(itl)) if itl else float("nan"),
        "peak_gb": (torch.cuda.max_memory_allocated(eng.device) / 1e9
                    if cuda else float("nan")),
        "tp": getattr(exe, "tp", 1),
    }
    if isinstance(exe, ShardedExecutor):
        out.update(plan_salt=exe.plan_salt(),
                   kv_perm=None if exe.plan is None else exe.plan.kv_perm,
                   balance=None if exe.plan is None else exe.plan.balance,
                   shard_load_fractions=exe.shard_load_fractions(),
                   rank=exe.mesh.rank, data=exe.data,
                   replica=exe.mesh.coords.get("data", 0),
                   resident_bytes=_nbytes_once((exe.params, eng.state)))
    if eng.prefix is not None:
        out["salt"] = eng.prefix._root[1]
    return out


def _serve_runs(runs, device):
    return [serve_waves(r, device=device) for r in runs]


def serve_tp(runs: Sequence[ServeRun], *, tp: int, backend: str,
             data: int = 1, device=None, timeout: float = 600.0,
             workdir: Optional[str] = None,
             threads: Optional[int] = None) -> List[List[Dict[str, Any]]]:
    """Run ``runs`` (each with ``ecfg.tp == tp``, and slots a multiple of
    ``data``) on ``data * tp`` spawned ranks, rank ``r`` at data replica
    ``r // tp`` and model shard ``r % tp`` -> ``[rank][run]`` results of
    ``serve_waves``; each run's ``ecfg.data`` is set to ``data``.  ``device``: the
    ranks' device (``cpu``, or None for each rank's card); ``workdir``:
    where the rendezvous file goes (a fresh temporary directory when
    None); ``threads``: each rank's torch intra-op threads (torch's
    default when None).  Raises RuntimeError with the first failing rank's traceback,
    TimeoutError when a rank outlives ``timeout`` seconds."""
    if any(r.ecfg.tp != tp for r in runs):
        raise ValueError(f"every run must be configured for tp={tp}")
    if data < 1:
        raise ValueError(f"data={data}: need at least one replica")
    if any(r.ecfg.data not in (1, data) for r in runs):
        raise ValueError(f"a run is configured for other than data={data}")
    runs = [dataclasses.replace(r, ecfg=dataclasses.replace(r.ecfg,
                                                            data=data))
            for r in runs]
    return spawn(_serve_runs, runs, data * tp, backend=backend,
                 device=device,
                 timeout=timeout, workdir=workdir, threads=threads,
                 name="serve_tp")


# ---------------------------------------------------------------------------
# make_serve_step on a mesh
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StepRun:
    """Greedy serving through ``make_serve_step`` on a ``mesh`` of
    (data, model) extents.  ``batches``: dicts of ``prompts`` (B, S)
    int, optionally ``more`` (B, S2) int -- a second prefill at index S
    -- ``new`` greedy tokens and the cache's ``max_len``; each batch
    starts from a fresh state.  ``logits``: keep every step's logits of
    this rank's rows."""
    label: str
    params: Any
    cfg: Any
    mesh: tuple
    batches: Sequence[Dict[str, Any]]
    logits: bool = False


def run_steps(run: StepRun, *, device=None) -> Dict[str, Any]:
    """Serve ``run`` in this process (one rank of a group when the mesh
    has more than one) -> the global greedy streams, this rank's rows'
    logits per step, step wall times, collectives, launches, resident
    and peak bytes."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as T
    from repro_torch.train.step import make_serve_step
    mesh = make_mesh(run.mesh, ("data", "model"), device=device)
    cuda = mesh.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(mesh.device)
        torch.cuda.reset_peak_memory_stats(mesh.device)
    group, nd = sh.axis_group(mesh, "data")
    _, _, compile_serve = make_serve_step(run.cfg, mesh)
    launches0 = ops.launch_counts()
    sh.reset_collectives()
    streams, logits, times, resident = [], [], [], 0
    for batch in run.batches:
        prompts = np.asarray(batch["prompts"])
        B = prompts.shape[0]
        steps = compile_serve(run.params, T.init_decode_state(
            run.cfg, B, batch["max_len"], device="meta"), B,
            prompts.shape[1])
        state = steps.state
        resident = max(resident, _nbytes_once((steps.params, state)))

        def timed(fn, *args):
            t0 = time.perf_counter()
            lg, st = fn(*args)
            if cuda:
                torch.cuda.synchronize(mesh.device)
            times.append(time.perf_counter() - t0)
            if run.logits:
                logits.append(lg.float().cpu().numpy())
            return lg, st

        def greedy(lg):
            tok = lg.argmax(-1)
            if nd > 1 and tok.shape[0] != B:      # every replica's rows
                tok = sh.all_gather_dim(tok.contiguous(), 0, group, nd)
            return tok

        lg, state = timed(steps.prefill, prompts, state)
        if batch.get("more") is not None:
            lg, state = timed(steps.prefill, np.asarray(batch["more"]),
                              state)
        out = [greedy(lg)]
        for _ in range(batch["new"] - 1):
            lg, state = timed(steps.decode, out[-1], state)
            out.append(greedy(lg))
        streams.append(torch.stack(out, 1).cpu().numpy().tolist())
        del steps, state
    launches1 = ops.launch_counts()
    return {"label": run.label, "streams": streams, "logits": logits,
            "step_s": times, "collectives": dict(sh.COLLECTIVES),
            "collective_log": dict(sh.COLLECTIVE_LOG),
            "launches": {k: launches1[k] - launches0[k] for k in launches1},
            "resident_bytes": resident,
            "peak_bytes": (torch.cuda.max_memory_allocated(mesh.device)
                           if cuda else 0),
            "coords": dict(mesh.coords)}


def _nbytes_once(tree) -> int:
    """Bytes of the tensors of ``tree``, each storage once."""
    seen = {}
    for t in tree_leaves(tree):
        if torch.is_tensor(t):
            st = t.untyped_storage()
            seen[(st.device.type, st.data_ptr())] = st.nbytes()
    return sum(seen.values())


def _run_step_jobs(runs, device):
    return [run_steps(r, device=device) for r in runs]


def serve_step_ranks(runs: Sequence[StepRun], *, world: int, backend: str,
                     device=None, timeout: float = 600.0,
                     workdir: Optional[str] = None,
                     threads: Optional[int] = None
                     ) -> List[List[Dict[str, Any]]]:
    """Run ``runs`` (each mesh of ``world`` ranks) on ``world`` spawned
    ranks -> ``[rank][run]`` results of ``run_steps``; the arguments as
    ``serve_tp``'s."""
    if any(math.prod(r.mesh) != world for r in runs):
        raise ValueError(f"every run's mesh must hold {world} ranks")
    return spawn(_run_step_jobs, list(runs), world, backend=backend,
                 device=device, timeout=timeout, workdir=workdir,
                 threads=threads, name="serve_steps")
