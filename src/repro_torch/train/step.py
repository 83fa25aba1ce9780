"""The train and serve steps of the port — own port of
``repro/train/step.py``.

``make_train_step`` returns ``step(params, opt_state, batch) ->
(params, opt_state, metrics)``: the causal-LM loss (+ MoE aux losses)
through ``models.transformer.train_forward`` -- with the plain attention
and scans, named explicitly here, as the reference trains through its
XLA path -- then AdamW under ``warmup_cosine``, evaluated at the step
BEFORE the increment (so the first update has lr 0).  ``peft_mode``
differentiates the CLOVER-S half (``core.peft.partition``) only;
``microbatches`` splits the batch and accumulates float32 gradients.
``make_adapter_step`` is the step of Table 2's LoRA / DoRA / PiSSA
arms (``benchmarks/table2_peft.py``'s ``_train_adapters``).

On a mesh (``launch.mesh``; FSDP + data + tensor parallel, the
counterpart of the reference's jitted ``in_shardings``):
``place_train_state`` puts this rank's slices of the params and moments
on its device under ``param_specs`` / ``opt_specs`` and returns their
spec tree, whose params half the step takes (``step(..., specs=)``);
the batch is this rank's rows
(``data.make_global_batch``).  The loss is the global batch's (token
count and MoE batch means summed over the batch axes); gradients are
summed over "data" (FSDP leaves get their shard back by the
reduce-scatter of their gather's backward) and then over "pod", in
full precision or, with ``TrainConfig.grad_compress``, in int8
(``parallel.compress``); the clip norm is the whole tree's.  Every
rank holds the same metrics, and replicated leaves stay bit for bit
equal across ranks.

``make_serve_step`` serves under training's rules (the reference's
serving steps on the training mesh): weights FSDP-split and gathered
per layer, the batch over ("pod", "data"), and the dense decode cache
split along its sequence over "model" (``parallel.sharding.KV_SEQ``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import peft as peft_lib
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as T
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               warmup_cosine)
from repro_torch.parallel import sharding as sh
from repro_torch.parallel.compress import compress_cross_pod
from repro_torch.tree import tree_leaves, tree_map

Params = Dict[str, Any]

METRIC_KEYS = ("loss", "moe_load_balance", "moe_router_z")


@dataclass(frozen=True)
class TrainConfig:
    optimizer: AdamWConfig = AdamWConfig()
    warmup_steps: int = 100
    total_steps: int = 10000
    remat: bool = True
    peft_mode: bool = False         # differentiate CLOVER-S keys only
    grad_compress: bool = False     # int8 gradients over the "pod" axis
    # gradient accumulation: the batch is split into this many
    # microbatches, run in sequence, gradients summed in float32
    microbatches: int = 1


def _nll(logits: torch.Tensor, labels) -> torch.Tensor:
    labels = torch.as_tensor(labels, device=logits.device).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.clamp_min(0)[..., None])[..., 0], labels


def loss_fn(params: Params, cfg: ArchConfig, tokens, labels, *,
            frontend_embeds=None, remat: bool = True,
            device: DeviceLike = None, shard=None, specs=None):
    """Causal-LM cross entropy (+ MoE aux losses), mean over tokens;
    labels < 0 are masked.  -> (total, {"loss", aux...}).  Differentiable
    in ``params``; the forward runs the plain attention and scans.
    ``frontend_embeds`` (B, F, D) go before the tokens; their positions
    carry no labels, so their logits are dropped.  ``shard`` / ``specs``:
    sharded training (``params`` this rank's slices, ``tokens`` /
    ``labels`` its rows): the mean is over the global batch's tokens,
    and its gradient is this rank's share of the global one."""
    logits, aux = T.train_forward(params, cfg, tokens, remat=remat,
                                  plain_attention=True,
                                  frontend_embeds=frontend_embeds,
                                  device=device, shard=shard, specs=specs)
    logits = logits[:, -tokens.shape[1]:]
    nll, labels = _nll(logits, labels)
    mask = labels >= 0
    if sh.batch_extent(shard) > 1:
        count = sh.reduce_batch(mask.sum().float(), shard)
        ce = sh.reduce_batch((nll * mask).sum(), shard) / count.clamp_min(1)
    else:
        ce = (nll * mask).sum() / mask.sum().clamp_min(1)
    total = ce + sum(aux.values())
    return total, {"loss": ce, **aux}


def _value_and_grad(fn: Callable, tree: Params):
    """-> ((total, metrics) of ``fn(tree)``, detached; the gradient of
    total w.r.t. every leaf of ``tree``: ``None`` where the leaf is
    ``None``, zeros where ``fn`` does not use it)."""
    tree = tree_map(lambda x: None if x is None
                    else x.detach().requires_grad_(True), tree)
    leaves = tree_leaves(tree)
    total, metrics = fn(tree)
    grads = torch.autograd.grad(total, leaves, allow_unused=True)
    by_id = {id(x): torch.zeros_like(x) if g is None else g
             for x, g in zip(leaves, grads)}
    return ((total.detach(), {k: v.detach() for k, v in metrics.items()}),
            tree_map(lambda x: None if x is None else by_id[id(x)], tree))


def make_train_step(cfg: ArchConfig, tcfg: TrainConfig, mesh=None, *,
                    device: DeviceLike = None) -> Callable:
    """-> step(params, opt_state, batch, specs=None) -> (params,
    opt_state, metrics).  ``batch``: {"tokens", "labels"} (B, S) int
    (numpy or tensors), and optionally "frontend_embeds" (B, F, D) float
    (see ``loss_fn``); metrics: loss, MoE aux losses, grad_norm
    (pre-clip), lr_scale -- 0-d tensors (nothing is read back to the
    host).  Inputs are not modified.  ``mesh``: this rank's mesh; the
    step then runs sharded on ``mesh.device`` (see the module doc) and
    ``specs`` is the param spec tree (``place_train_state``'s
    ``["params"]``, which carries the layout)."""
    dev = mesh.device if mesh is not None else resolve_device(device)

    def step(params, opt_state, batch, specs=None):
        if (mesh is None) != (specs is None):
            raise ValueError("a sharded step needs the specs of "
                             "place_train_state, and only a sharded step "
                             "takes them")
        if tcfg.peft_mode:
            opt_params, frozen = peft_lib.partition(params)

            def full(tr):
                return peft_lib.combine(tr, frozen)
        else:
            opt_params = params

            def full(tr):
                return tr
        ospecs = (None if specs is None else sh.map_with_specs(
            lambda _, spec: spec, opt_params, specs))

        def grad_of(tokens, labels, fe):
            return _value_and_grad(
                lambda tr: loss_fn(full(tr), cfg, tokens, labels,
                                   frontend_embeds=fe, remat=tcfg.remat,
                                   device=dev, shard=mesh, specs=specs),
                opt_params)

        tokens = torch.as_tensor(batch["tokens"], device=dev)
        labels = torch.as_tensor(batch["labels"], device=dev)
        fe = batch.get("frontend_embeds")
        if fe is not None:
            fe = torch.as_tensor(fe, device=dev)
        m = max(1, tcfg.microbatches)
        if m == 1:
            (_, metrics), grads = grad_of(tokens, labels, fe)
        else:
            B = tokens.shape[0]
            assert B % m == 0, (B, m)
            mb = B // m
            grads = tree_map(lambda p: None if p is None else torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), opt_params)
            metrics = {k: torch.zeros((), dtype=torch.float32, device=dev)
                       for k in METRIC_KEYS}
            for i in range(m):
                sl = slice(i * mb, (i + 1) * mb)
                (_, met), g = grad_of(tokens[sl], labels[sl],
                                      None if fe is None else fe[sl])
                grads = tree_map(lambda a, t: None if a is None
                                 else a + t.float() / m, grads, g)
                metrics = {k: metrics[k] + met[k] / m for k in metrics}
        if mesh is not None:
            grads = sync_grads(grads, ospecs, mesh, tcfg.grad_compress)

        lr_scale = warmup_cosine(opt_state["step"].to(dev),
                                 warmup=tcfg.warmup_steps,
                                 total=tcfg.total_steps)
        new_opt_params, new_opt, gnorm = adamw_update(
            grads, opt_state, opt_params, tcfg.optimizer, lr_scale,
            specs=ospecs, mesh=mesh)
        new_params = (peft_lib.combine(new_opt_params, frozen)
                      if tcfg.peft_mode else new_opt_params)
        metrics = dict(metrics)
        metrics["grad_norm"] = gnorm
        metrics["lr_scale"] = lr_scale.float()
        return new_params, new_opt, metrics

    return step


@torch.no_grad()
def sync_grads(grads: Params, specs: Params, mesh, compress: bool = False
               ) -> Params:
    """Sum this rank's gradients over the batch axes: over "data" in
    full precision (a leaf split over "data" already was, by its
    gather's reduce-scatter), then over "pod" -- with ``compress``, in
    int8 wherever the mesh has a "pod" axis, as the reference's step
    (``compress_cross_pod`` of each pod's replica, scaled by the pod
    count so its average is the sum)."""
    group, n = sh.axis_group(mesh, "data")
    if n > 1:
        grads = sh.map_with_specs(
            lambda g, spec: g if "data" in sh.split_axes(spec)
            else sh.all_reduce(g.contiguous(), group), grads, specs)
    group, n = sh.axis_group(mesh, "pod")
    if compress and "pod" in mesh.shape:
        return compress_cross_pod(tree_map(lambda g: None if g is None
                                           else g * n, grads), mesh)
    if n == 1:
        return grads
    return tree_map(lambda g: None if g is None
                    else sh.all_reduce(g.contiguous(), group), grads)


def train_specs(params: Params, mesh,
                rules: Optional[sh.ShardingRules] = None) -> Params:
    """The spec tree of the train state ``{"params", "opt"}``:
    ``param_specs`` for the params, ``opt_specs`` for the moments, the
    step counter replicated -- the layout ``place_train_state`` puts on
    a mesh and ``train.checkpoint`` gathers and restores."""
    pspec = sh.param_specs(params, mesh, rules)
    mspec = sh.opt_specs(pspec)
    return {"params": pspec, "opt": {"m": mspec, "v": mspec,
                                     "step": sh.Spec()}}


def place_train_state(params: Params, opt_state: Params, mesh,
                      rules: Optional[sh.ShardingRules] = None):
    """-> (this rank's params, its optimizer state, the train state's
    spec tree ``train_specs``): every leaf split per ``param_specs`` /
    ``opt_specs`` and copied to ``mesh.device`` (the counterpart of the
    reference's ``in_shardings``; the whole trees can be freed).  The
    step takes ``specs=`` the tree's ``["params"]``."""
    specs = train_specs(params, mesh, rules)
    local = sh.map_with_specs(
        lambda t, spec: sh.local_slice(t, spec, mesh).to(
            mesh.device, copy=True),
        {"params": params, "opt": opt_state}, specs)
    return local["params"], local["opt"], specs


def batch_spec(mesh, global_batch: int,
               rules: Optional[sh.ShardingRules] = None) -> sh.Spec:
    """``data_specs`` of a training batch; raises unless the batch
    splits over every batch axis (a replicated batch would count each
    rank's tokens several times)."""
    spec = sh.data_specs(mesh, rules, global_batch)
    if spec[0] is None and sh.batch_extent(mesh) > 1:
        raise ValueError(f"a global batch of {global_batch} does not split "
                         f"over the batch axes of mesh {mesh.shape}")
    return spec


def make_opt_state(params: Params, peft_mode: bool = False) -> Params:
    if peft_mode:
        trainable, _ = peft_lib.partition(params)
        return adamw_init(trainable)
    return adamw_init(params)


def make_adapter_step(cfg: ArchConfig, pcfg: peft_lib.PeftConfig,
                      frozen: Params, ocfg: AdamWConfig, *,
                      remat: bool = False,
                      device: DeviceLike = None) -> Callable:
    """-> step(adapters, opt_state, tokens, labels) -> (adapters,
    opt_state, loss): one AdamW step (no schedule) on the adapter tree
    of a LoRA / DoRA / PiSSA arm, with the loss mean NLL + MoE aux over
    ``materialize(frozen, adapters)`` -- ``benchmarks/table2_peft.py``'s
    step.  ``frozen``: the base params (PiSSA: ``pissa_residual``)."""
    dev = resolve_device(device)

    def loss(ad, tokens, labels):
        eff = peft_lib.materialize(frozen, ad, pcfg)
        logits, aux = T.train_forward(eff, cfg, tokens, remat=remat,
                                      plain_attention=True, device=dev)
        nll, _ = _nll(logits, labels)
        return nll.mean() + sum(aux.values()), {}

    def step(adapters, opt_state, tokens, labels):
        (total, _), g = _value_and_grad(
            lambda ad: loss(ad, tokens, labels), adapters)
        adapters, opt_state, _ = adamw_update(g, opt_state, adapters, ocfg)
        return adapters, opt_state, total

    return step


# ---------------------------------------------------------------------------
# serving steps
# ---------------------------------------------------------------------------

class ServeSteps(NamedTuple):
    """What ``compile_serve`` returns: the two step callables bound to
    the mesh and specs, this rank's placed params and decode state, and
    the spec trees they were placed by."""
    prefill: Callable
    decode: Callable
    params: Params
    state: Params
    param_specs: Params
    state_specs: Params


def make_serve_step(cfg: ArchConfig, mesh=None,
                    rules: Optional[sh.ShardingRules] = None):
    """-> (prefill_step, decode_fn, compile_serve), the reference's
    serving steps under training's ``ShardingRules``.

    ``prefill_step(params, tokens, state, frontend_embeds=None)`` and
    ``decode_fn(params, token, state)`` are ``models.transformer.
    prefill`` / ``decode_step`` on whole trees (one device).
    ``compile_serve(params, state, batch, prompt)`` places this rank's
    slices of ``params`` (``param_specs``) and ``state``
    (``decode_state_specs``: the batch over ("pod", "data"), the dense
    cache's sequence over "model") on ``mesh.device`` and returns
    ``ServeSteps``: ``prefill(tokens, state, frontend_embeds=None)`` and
    ``decode(token, state)`` take the GLOBAL batch (each rank keeps its
    rows, or all of them when ``batch`` does not divide the batch axes,
    as ``data_specs`` replicates it) and this rank's state, and return
    (this rank's rows' logits, the new state); the state is donated:
    its KV leaves are updated in place, so only the returned state may
    be used again (``ServeSteps.state`` is the placed initial state).
    ``prompt``: the prompt length the caller will prefill (checked
    against the cache).  ``state`` may be planned on the meta device
    (``init_decode_state(..., device="meta")``): this rank's slice then
    starts at zero on ``mesh.device``, and the whole state never exists.
    Nothing is captured as a CUDA graph."""
    rules = rules or sh.ShardingRules()

    def prefill_step(params, tokens, state, frontend_embeds=None):
        return T.prefill(params, cfg, tokens, state,
                         frontend_embeds=frontend_embeds)

    def decode_fn(params, token, state):
        return T.decode_step(params, cfg, token, state)

    def compile_serve(params: Params, state: Params, batch: int,
                      prompt: int) -> ServeSteps:
        if mesh is None:
            raise ValueError("compile_serve places on a mesh; without one "
                             "call prefill_step / decode_fn directly")
        pspec = sh.param_specs(params, mesh, rules)
        sspec = sh.decode_state_specs(state, mesh, rules)
        cap = T._capacity(state)
        if cap is not None and prompt > cap:
            raise ValueError(f"a prompt of {prompt} tokens does not fit the "
                             f"cache's {cap} positions")
        def place(t, spec):
            local = sh.local_slice(t, spec, mesh)
            if t.device.type == "meta" and mesh.device.type != "meta":
                # a state planned on meta starts at zero on the device
                return torch.zeros(local.shape, dtype=local.dtype,
                                   device=mesh.device)
            return local.to(mesh.device, copy=True)

        p_local = sh.map_with_specs(place, params, pspec)
        s_local = sh.map_with_specs(place, state, sspec)
        bspec = sh.data_specs(mesh, rules, global_batch=batch)

        def rows(t, ndim):
            if t is None:
                return None
            t = torch.as_tensor(t, device=mesh.device)
            return sh.local_slice(t, sh.Spec(bspec[:1] + (None,) * (ndim - 1)),
                                  mesh)

        def prefill(tokens, state, frontend_embeds=None):
            return T.prefill(p_local, cfg, rows(tokens, 2), state,
                             frontend_embeds=rows(frontend_embeds, 3),
                             shard=mesh, specs=pspec, state_specs=sspec)

        def decode(token, state):
            return T.decode_step(p_local, cfg, rows(token, 1), state,
                                 shard=mesh, specs=pspec, state_specs=sspec)

        return ServeSteps(prefill, decode, p_local, s_local, pspec, sspec)

    return prefill_step, decode_fn, compile_serve
