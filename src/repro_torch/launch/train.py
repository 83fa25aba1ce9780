"""End-to-end training driver of the port — own port of
``repro/launch/train.py``: config -> model init -> (CLOVER decompose /
prune) -> mesh -> sharded train step -> synthetic data -> checkpoint
manager -> fault-tolerance supervisor.

    PYTHONPATH=src python -m repro_torch.launch.train --arch musicgen-large \\
        --steps 50 --batch 8 --seq 64 --reduced --device cpu
    ... --peft clover      # CLOVER-S fine-tuning instead of full training
    ... --clover-prune 0.5 # prune first, then train (recovery setting)
    ... --fail-at 12       # inject a WorkerFailure at step 12

``main`` is a thin argparse over ``train``, which takes the config (a
caller can pass one cut in depth) and runs on one rank's mesh, or on
the mesh it is given.  The default checkpoint directory is
``repro_torch_ckpt`` under the temporary directory.

``train_ranks`` runs ``TrainRun`` / ``PipeRun`` jobs on a rank group of
one host (``launch.spawn.spawn``: spawned processes, a ``file://``
rendezvous, an explicit backend): each rank builds the run's mesh with
``launch.mesh.make_mesh`` and reports its steps' metrics, step times,
peak memory and collectives.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import os
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional, Sequence

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.core.decompose import clover_decompose
from repro_torch.core.prune import clover_prune
from repro_torch.data import SyntheticConfig, SyntheticLM, make_global_batch
from repro_torch.launch.mesh import make_host_mesh, make_mesh
from repro_torch.launch.spawn import spawn
from repro_torch.models import transformer as T
from repro_torch.optim import AdamWConfig
from repro_torch.parallel import sharding as sh
from repro_torch.parallel.pipeline import pipeline_apply
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.step import (TrainConfig, batch_spec, make_opt_state,
                                    make_train_step, place_train_state)
from repro_torch.train.supervisor import (Supervisor, SupervisorReport,
                                          WorkerFailure)
from repro_torch.tree import tree_leaves_with_path, tree_map

DEFAULT_CKPT_DIR = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclasses.dataclass
class Trained:
    """What ``train`` returns: the supervisor's report, this rank's final
    params and optimizer state, the train state's spec tree, the mesh,
    the (possibly decomposed / pruned) config, and each step's wall ms
    (ended by a device synchronize)."""
    report: SupervisorReport
    params: Any
    opt: Any
    specs: Any
    mesh: Any
    cfg: ArchConfig
    step_ms: List[float]


def build(cfg: ArchConfig, *, batch: int, seq: int, steps: int,
          peft: Optional[str] = None, prune_ratio: float = 0.0,
          lr: float = 3e-4, seed: int = 0, mesh=None, device=None,
          grad_compress: bool = False):
    """-> (cfg, mesh, params, opt_state, data, step, specs): the
    reference's ``build`` on ``cfg``, with this rank's slices of the
    params and moments on the mesh (one rank's (1, 1) mesh by default)
    and the train state's spec tree (``train.step.train_specs``)."""
    mesh = mesh if mesh is not None else make_host_mesh(device=device)
    params = T.init_lm_params(cfg, seed, device=mesh.device)
    if prune_ratio > 0:
        params, cfg, _ = clover_decompose(params, cfg,
                                          peft=(peft == "clover"))
        params, cfg = clover_prune(params, cfg, qk_ratio=prune_ratio,
                                   vo_ratio=prune_ratio)
    elif peft == "clover":
        params, cfg, _ = clover_decompose(params, cfg, peft=True)
    tcfg = TrainConfig(
        optimizer=AdamWConfig(lr=lr, weight_decay=0.0 if peft else 0.1),
        warmup_steps=max(2, steps // 20),
        total_steps=steps,
        remat=True,
        peft_mode=(peft == "clover"),
        grad_compress=grad_compress)
    params, opt_state, specs = place_train_state(
        params, make_opt_state(params, peft_mode=tcfg.peft_mode), mesh)
    step = make_train_step(cfg, tcfg, mesh)
    data = SyntheticLM(SyntheticConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
        seed=seed))
    return cfg, mesh, params, opt_state, data, step, specs


class _NoCheckpoints:
    """The checkpoint manager of a run without checkpoints: saves
    nothing and has nothing to restore."""

    def save(self, step, tree, extra=None, **layout):
        pass

    def wait(self):
        pass

    def latest_step(self):
        return None


def _sync(mesh) -> None:
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)


def train(cfg: ArchConfig, *, steps: int, batch: int, seq: int,
          lr: float = 3e-4, peft: Optional[str] = None,
          prune_ratio: float = 0.0, seed: int = 0,
          ckpt_dir: Optional[str] = DEFAULT_CKPT_DIR, ckpt_every: int = 10,
          fail_at: int = -1, mesh=None, device=None,
          grad_compress: bool = False, log=print) -> Trained:
    """Train ``cfg`` for ``steps`` steps of (batch, seq) ``SyntheticLM``
    batches under the ``Supervisor``: checkpoints every ``ckpt_every``
    steps and at the end into ``ckpt_dir`` (keeping the last 2), a
    ``WorkerFailure`` injected once at step ``fail_at`` (rolled back to
    the last checkpoint and replayed).  ``ckpt_dir=None``: no
    checkpoints (a failure replays from step 0 with the state it failed
    in, as before a first checkpoint).  ``mesh``: this
    rank's mesh (every rank of it calls ``train``); ``log``: where the
    progress lines go (None: nowhere)."""
    cfg, mesh, params, opt, data, step, specs = build(
        cfg, batch=batch, seq=seq, steps=steps, peft=peft,
        prune_ratio=prune_ratio, lr=lr, seed=seed, mesh=mesh, device=device,
        grad_compress=grad_compress)
    dspec = batch_spec(mesh, batch)
    state: Dict[str, Any] = {"params": params, "opt": opt, "data": data}
    del params, opt
    failed_once = {"done": False}
    step_ms: List[float] = []
    last = {"state": state}        # the supervisor keeps its state inside

    def step_fn(st, i):
        if i == fail_at and not failed_once["done"]:
            failed_once["done"] = True
            raise WorkerFailure(f"injected failure at step {i}")
        t0 = time.perf_counter()
        b = make_global_batch(st["data"].batch_at(i), mesh, dspec)
        p, o, metrics = step(st["params"], st["opt"], b, specs["params"])
        _sync(mesh)
        step_ms.append(1e3 * (time.perf_counter() - t0))
        st = {"params": p, "opt": o, "data": st["data"]}
        st["data"].step = i + 1
        last["state"] = st
        return st, metrics

    def metrics_cb(i, m):
        if log is not None and (i % 5 == 0 or i == steps - 1):
            log(f"step {i:5d}  loss {float(m['loss']):.4f}  "
                f"gnorm {float(m['grad_norm']):.3f}")

    def save_tree(st):
        return ({"params": st["params"], "opt": st["opt"]},
                {"data": st["data"].state_dict()})

    def restore_tree(tree, extra):
        data.load_state_dict(extra["data"])
        return {"params": tree["params"], "opt": tree["opt"], "data": data}

    layout = dict(specs=specs, mesh=mesh)
    sup = Supervisor(_NoCheckpoints() if ckpt_dir is None
                     else CheckpointManager(ckpt_dir, keep=2),
                     ckpt_every=ckpt_every, save_kw=layout,
                     restore_kw=layout)
    rep = sup.run(state=state, step_fn=step_fn, save_tree=save_tree,
                  restore_tree=restore_tree, start_step=0,
                  total_steps=steps, metrics_cb=metrics_cb)
    state = last["state"]
    return Trained(rep, state["params"], state["opt"], specs, mesh, cfg,
                   step_ms)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="musicgen-large")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--peft", choices=["clover"], default=None)
    ap.add_argument("--clover-prune", type=float, default=0.0)
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--fail-at", type=int, default=-1,
                    help="inject a WorkerFailure at this step (FT demo)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cpu, or the card (cuda) when not given")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    t0 = time.time()
    out = train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                lr=args.lr, peft=args.peft, prune_ratio=args.clover_prune,
                seed=args.seed, ckpt_dir=args.ckpt_dir,
                ckpt_every=args.ckpt_every, fail_at=args.fail_at,
                device=args.device)
    rep = out.report
    print(f"done: {rep.steps_run} steps ({rep.restarts} restarts, "
          f"{len(rep.stragglers)} stragglers flagged) in "
          f"{time.time() - t0:.1f}s; final loss "
          f"{rep.metrics_history[-1]['loss']:.4f}")
    return 0


# ---------------------------------------------------------------------------
# rank groups on one host
# ---------------------------------------------------------------------------

def digest(t: torch.Tensor) -> str:
    """sha256 of a tensor's bytes (its dtype and shape included)."""
    t = t.detach().contiguous()
    raw = t.reshape(-1).view(torch.uint8).cpu().numpy().tobytes()
    return hashlib.sha256(f"{t.dtype}{tuple(t.shape)}".encode()
                          + raw).hexdigest()


@dataclasses.dataclass
class TrainRun:
    """One training run on a rank group: ``train(cfg, ...)`` on the mesh
    of ``shape`` over ``axes`` (``kw``: ``train``'s other keywords).
    Each rank reports its metrics, step ms, peak GB, collectives by kind
    and the host seconds inside them, its mesh coords; with ``local``
    its final params (numpy, its slices), with ``full`` every leaf
    whole (numpy, on rank 0), with ``digests`` each whole leaf's
    ``digest``."""
    label: str
    cfg: ArchConfig
    shape: Sequence[int]
    axes: Sequence[str]
    kw: Dict[str, Any]
    local: bool = False
    full: bool = False
    digests: bool = False

    def execute(self, device) -> Dict[str, Any]:
        mesh = make_mesh(self.shape, self.axes, device=device)
        cuda = mesh.device.type == "cuda"
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(mesh.device)
        sh.reset_collectives()
        out = train(self.cfg, mesh=mesh, log=None, **self.kw)
        res: Dict[str, Any] = {
            "label": self.label, "coords": dict(mesh.coords),
            "metrics": out.report.metrics_history,
            "restarts": out.report.restarts, "step_ms": out.step_ms,
            "collectives": dict(sh.COLLECTIVES),
            # the final params and moments, and what else is alive
            "resident_gb": (torch.cuda.memory_allocated(mesh.device) / 1e9
                            if cuda else float("nan")),
            "peak_gb": (torch.cuda.max_memory_allocated(mesh.device) / 1e9
                        if cuda else float("nan"))}
        if self.local:
            res["local"] = {p: t.detach().cpu().numpy()
                            for p, t in tree_leaves_with_path(out.params)
                            if t is not None}
        if self.full or self.digests:
            by_path = sh.specs_by_path(out.params, out.specs["params"])
            whole = {p: sh.gather_full(t, by_path[p], mesh)
                     for p, t in tree_leaves_with_path(out.params)
                     if t is not None}
            if self.digests:
                res["digests"] = {p: digest(t) for p, t in whole.items()}
            if self.full and torch.distributed.get_rank() == 0:
                res["full"] = {p: t.cpu().numpy() for p, t in whole.items()}
            del whole
        del out
        return res


@dataclasses.dataclass
class PipeRun:
    """``pipeline_apply`` on the mesh of ``shape`` over ``axes``: the
    stage-stacked ``stage_params`` over ``x`` in ``n_microbatches``
    (``stage_fn`` a module-level function or a partial of one).  Each
    rank reports the output (numpy), the sequential composition's (on
    rank 0) and the wall ms of the pipelined call."""
    label: str
    shape: Sequence[int]
    axes: Sequence[str]
    stage_params: Any
    x: Any
    stage_fn: Any
    n_microbatches: int

    def execute(self, device) -> Dict[str, Any]:
        mesh = make_mesh(self.shape, self.axes, device=device)
        params = tree_map(lambda t: t.to(mesh.device), self.stage_params)
        x = self.x.to(mesh.device)
        sh.reset_collectives()
        with torch.no_grad():
            _sync(mesh)
            t0 = time.perf_counter()
            y = pipeline_apply(params, x, mesh, self.stage_fn,
                               n_microbatches=self.n_microbatches)
            _sync(mesh)
            ms = 1e3 * (time.perf_counter() - t0)
            res = {"label": self.label, "coords": dict(mesh.coords),
                   "out": y.cpu().numpy(), "ms": ms,
                   "collectives": dict(sh.COLLECTIVES)}
            if torch.distributed.get_rank() == 0:
                ref = x
                for s in range(mesh.shape["pipe"]):
                    ref = self.stage_fn(
                        tree_map(lambda t, s=s: t[s], params), ref)
                res["sequential"] = ref.cpu().numpy()
        return res


def block_stage(cfg: ArchConfig, params, h: torch.Tensor) -> torch.Tensor:
    """One decoder layer of ``cfg`` (pattern position 0) as a pipeline
    stage: ``params`` is that layer's tree (no stacked axis).  Bind
    ``cfg`` with ``functools.partial`` for ``PipeRun``."""
    S = h.shape[1]
    positions = torch.arange(S, device=h.device)[None].expand(h.shape[0], S)
    y, _, _ = T._apply_layer(params, cfg, *cfg.pattern[0], h,
                             positions=positions, state=None,
                             cache_index=None, plain=True)
    return y


def _run_jobs(jobs, device):
    return [job.execute(device) for job in jobs]


def train_ranks(jobs: Sequence[Any], world: int, *, backend: str,
                device=None, timeout: float = 600.0,
                workdir: Optional[str] = None,
                threads: Optional[int] = None) -> List[List[Dict[str, Any]]]:
    """Run ``jobs`` (``TrainRun`` / ``PipeRun``, each on a mesh of
    ``world`` ranks) in order on ``world`` spawned ranks -> ``[rank]
    [job]`` results (``launch.spawn.spawn``'s arguments)."""
    return spawn(_run_jobs, list(jobs), world, backend=backend,
                 device=device, timeout=timeout, workdir=workdir,
                 threads=threads, name="train_ranks")


if __name__ == "__main__":
    sys.exit(main())
