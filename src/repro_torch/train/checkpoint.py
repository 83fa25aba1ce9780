"""Checkpointing: atomic, async, keep-k, elastic restore — own port of
``repro/train/checkpoint.py``, file for file the same layout:

    <root>/step_000000420.tmp/...   while writing
    <root>/step_000000420/          after the atomic rename (commit)
        manifest.json               paths, shapes, dtypes, extra
        arr_00000.npy ...           leaves in the reference's flatten order

A checkpoint written by either package restores in the other: leaves
are numbered in JAX's flatten order (dict keys sorted, tuples in
order), their paths spelled as ``jax.tree_util.keystr`` spells them
(``['blocks'][0]['attn']['wq']``), ``None`` leaves recorded with null
dtype and shape and no file, bfloat16 saved as a raw uint16 view.  The
``treedef`` field is written in the reference's form and ignored on
restore by both.  1-byte float dtypes (float8) are saved as a uint8 view
(the reference views every such dtype as uint16; ROADMAP C).

Writes run on a daemon thread after a host snapshot taken before it
starts (training continues); ``wait()`` joins before the next save, on a
rollback and at shutdown.  On a mesh (``save(..., specs=, mesh=)``)
every rank gathers the full leaves, rank 0 snapshots and writes them,
and a barrier follows; ``wait()`` then joins and barriers too, so every
rank sees rank 0's commit.  ``restore`` loads the full arrays and takes
this rank's ``local_slice`` under the TARGET layout -- the elastic path
(a checkpoint from a (2, 2) run restores onto (1, 2) or one device
unchanged).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.parallel.sharding import (gather_full, local_slice,
                                           specs_by_path)
from repro_torch.tree import tree_leaves_with_path

Params = Dict[str, Any]

_STEP_RE = re.compile(r"^step_(\d{9})$")

# dtypes numpy cannot hold, stored as a raw view of the same width
_RAW = {torch.bfloat16: (torch.int16, np.uint16),
        torch.float8_e4m3fn: (torch.uint8, np.uint8),
        torch.float8_e5m2: (torch.uint8, np.uint8)}
_BY_NAME = {str(t).removeprefix("torch."): t for t in _RAW}


def _flatten(tree) -> List[Tuple[str, Any]]:
    """(keystr path, leaf) in JAX's flatten order (dict keys sorted),
    ``None`` leaves included."""
    return list(tree_leaves_with_path(tree, sort_keys=True))


def _treedef(tree) -> str:
    """The structure as the reference's ``repr`` of its treedef."""
    def walk(t):
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {walk(t[k])}"
                                   for k in sorted(t)) + "}"
        if isinstance(t, tuple):
            inner = ", ".join(walk(v) for v in t)
            return f"({inner},)" if len(t) == 1 else f"({inner})"
        if isinstance(t, list):
            return "[" + ", ".join(walk(v) for v in t) + "]"
        return "*"
    return f"PyTreeDef({walk(tree)})"


def _rebuild(like, leaves: Dict[str, Any], path: str = ""):
    if isinstance(like, dict):
        return {k: _rebuild(v, leaves, f"{path}[{k!r}]")
                for k, v in like.items()}
    if isinstance(like, (tuple, list)):
        out = [_rebuild(v, leaves, f"{path}[{i}]")
               for i, v in enumerate(like)]
        return tuple(out) if isinstance(like, tuple) else out
    return leaves[path]


def _to_host(t: Optional[torch.Tensor]):
    """-> (numpy array to save, dtype name), a copy taken now."""
    if t is None:
        return None
    t = t.detach()
    name = str(t.dtype).removeprefix("torch.")
    if t.dtype in _RAW:
        view, np_dt = _RAW[t.dtype]
        return t.view(view).to("cpu", copy=True).numpy().view(np_dt), name
    return t.to("cpu", copy=True).numpy(), name


def _from_saved(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype in _BY_NAME:
        view = _RAW[_BY_NAME[dtype]][0]
        return torch.from_numpy(arr.view(
            np.int16 if view == torch.int16 else np.uint8)).view(
            _BY_NAME[dtype])
    return torch.from_numpy(arr)


def _world(mesh) -> bool:
    return (mesh is not None and mesh.size > 1 and dist.is_available()
            and dist.is_initialized())


class CheckpointManager:
    def __init__(self, root: str, keep: int = 3, async_write: bool = True):
        self.root = root
        self.keep = keep
        self.async_write = async_write
        self._thread: Optional[threading.Thread] = None
        self._sharded = False
        os.makedirs(root, exist_ok=True)

    # -- save -------------------------------------------------------------
    def save(self, step: int, tree: Params, extra: Optional[Dict] = None,
             *, specs: Optional[Params] = None, mesh=None):
        """Snapshot to host memory NOW, write (possibly async), rename.
        ``specs`` / ``mesh``: ``tree`` is this rank's slices under
        ``specs`` (the full tree's spec tree): every rank takes part in
        gathering the full leaves, rank 0 writes them."""
        self.wait()
        sharded = _world(mesh)
        self._sharded = sharded
        if sharded:
            by_path = specs_by_path(tree, specs)
            tree = _rebuild(tree, {
                p: None if t is None else gather_full(t, by_path[p], mesh)
                for p, t in _flatten(tree)})
        writer = not sharded or dist.get_rank() == 0
        if writer:
            leaves = [(p, _to_host(t)) for p, t in _flatten(tree)]
            structure = _treedef(tree)
        del tree
        if sharded:
            dist.barrier()
        if not writer:
            return
        extra = dict(extra or {})

        def write():
            name = f"step_{step:09d}"
            tmp = os.path.join(self.root, name + ".tmp")
            final = os.path.join(self.root, name)
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            manifest = {
                "step": step,
                "extra": extra,
                "leaves": [
                    {"path": p,
                     "dtype": None if a is None else a[1],
                     "shape": None if a is None else list(a[0].shape)}
                    for p, a in leaves],
                "treedef": structure,
            }
            for i, (_, a) in enumerate(leaves):
                if a is not None:
                    np.save(os.path.join(tmp, f"arr_{i:05d}.npy"), a[0])
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, final)       # atomic commit
            self._gc()

        if self.async_write:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        else:
            write()

    def wait(self):
        """Join the writer; after a sharded save also barrier, so every
        rank sees rank 0's commit."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._sharded:
            dist.barrier()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.root, f"step_{s:09d}"),
                          ignore_errors=True)

    # -- restore ------------------------------------------------------------
    def all_steps(self) -> List[int]:
        out = []
        for n in os.listdir(self.root):
            m = _STEP_RE.match(n)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.all_steps()
        return s[-1] if s else None

    def restore(self, step: int, like: Params,
                specs: Optional[Params] = None, mesh=None,
                ) -> Tuple[Params, Dict]:
        """Load ``step`` into the structure of ``like`` -> (tree, extra).
        Each leaf is loaded whole; with ``specs`` and ``mesh`` (the
        TARGET layout: the full tree's spec tree and this rank's mesh)
        this rank keeps its ``local_slice`` -- the elastic path.  A leaf
        must come out at ``like``'s shape and lands on ``like``'s
        device (``mesh.device`` on a mesh)."""
        d = os.path.join(self.root, f"step_{step:09d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        saved = {e["path"]: i for i, e in enumerate(manifest["leaves"])}
        by_path = (specs_by_path(like, specs)
                   if mesh is not None and specs is not None else {})
        out = {}
        for p, leaf in _flatten(like):
            if leaf is None:
                out[p] = None
                continue
            if p not in saved:
                raise KeyError(f"checkpoint {d} has no leaf {p}")
            i = saved[p]
            t = _from_saved(np.load(os.path.join(d, f"arr_{i:05d}.npy")),
                            manifest["leaves"][i]["dtype"])
            if p in by_path:
                t = local_slice(t, by_path[p], mesh)
            if tuple(t.shape) != tuple(leaf.shape):
                raise ValueError(f"{p}: restored {tuple(t.shape)} != "
                                 f"expected {tuple(leaf.shape)}")
            dev = mesh.device if mesh is not None else leaf.device
            out[p] = t.to(dev, copy=True)
        return _rebuild(like, out), manifest["extra"]
