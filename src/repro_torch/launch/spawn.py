"""Rank groups on one host: spawn ``world`` processes, each joining one
``torch.distributed`` process group, and run the same function on each.

``spawn`` starts the ranks with the ``spawn`` start method (never
``fork``: a parent that touched CUDA cannot fork) and rendezvouses them
on a ``file://`` path; the backend is explicit (``nccl`` needs one card
per rank; ``gloo`` runs on the CPU and can put several ranks on one
card, moving CUDA tensors through host memory).  Arguments pass to the
ranks as they are: CUDA tensors through CUDA IPC, CPU tensors through
shared memory.  A rank that raises or outlives ``timeout`` fails the
call, and every rank is stopped before it returns.
"""
from __future__ import annotations

import gc
import os
import queue as queue_mod
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_main(rank: int, world: int, backend: str, init_file: str,
               timeout: float, device, threads, fn, jobs, results) -> None:
    try:
        if threads is not None:
            torch.set_num_threads(threads)
        if device is None and torch.cuda.is_available():
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(backend, init_method=f"file://{init_file}",
                                world_size=world, rank=rank,
                                timeout=timedelta(seconds=timeout))
        try:
            out = fn(jobs, device)
        finally:
            dist.destroy_process_group()
        results.put((rank, "ok", out))
    except BaseException:                     # noqa: BLE001 — reported
        results.put((rank, "error", traceback.format_exc()))
    finally:
        # the process object keeps its arguments until exit, and a rank
        # that exits holding the parent's CUDA tensors never releases
        # them to CUDA IPC: the parent's memory would stay allocated
        jobs.clear()
        gc.collect()


def spawn(fn: Callable[[list, Any], Any], jobs: list, world: int, *,
          backend: str, device=None, timeout: float = 600.0,
          workdir: Optional[str] = None, threads: Optional[int] = None,
          name: str = "spawn") -> List[Any]:
    """Run ``fn(jobs, device)`` on ``world`` spawned ranks -> each rank's
    return value, by rank.  ``fn``: a module-level function (the ranks
    import it); ``jobs``: a list, cleared in each rank once ``fn``
    returns; ``device``: the ranks' device (``cpu``, or None for each
    rank's card, ``cuda:{rank % device_count}``); ``workdir``: where the
    rendezvous file goes (a fresh temporary directory when None);
    ``threads``: each rank's torch intra-op threads (torch's default
    when None).  Raises RuntimeError with the first failing rank's
    traceback, TimeoutError when a rank outlives ``timeout`` seconds."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix=f"{name}_", dir=workdir)
    init_file = os.path.join(tmp, "rendezvous")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, backend, init_file, timeout, device,
                               threads, fn, list(jobs), results))
             for r in range(world)]
    for p in procs:
        p.start()
    got: Dict[int, Any] = {}
    error = None
    deadline = time.monotonic() + timeout
    try:
        while len(got) < world and error is None:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"{name}: {world - len(got)} of {world} ranks still "
                    f"running after {timeout:.0f} s")
            try:
                rank, kind, payload = results.get(timeout=min(left, 5.0))
            except queue_mod.Empty:
                # a rank that exited without reporting was killed or
                # crashed (a reporting rank's result is queued before it
                # exits, and the queue is empty)
                dead = [r for r, p in enumerate(procs)
                        if r not in got and not p.is_alive()]
                if dead:
                    error = (f"rank {dead[0]} exited with code "
                             f"{procs[dead[0]].exitcode} without reporting")
                continue
            if kind == "ok":
                got[rank] = payload
            else:
                error = f"rank {rank} failed:\n{payload}"
        if error is not None:
            raise RuntimeError(f"{name}: {error}")
    finally:
        for p in procs:
            p.join(timeout=10.0 if error is None else 1.0)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10.0)
        results.close()
        if torch.cuda.is_initialized():
            # free what the ranks held of this process's CUDA tensors
            torch.cuda.ipc_collect()
        try:
            os.remove(init_file)
        except OSError:
            pass
        try:
            os.rmdir(tmp)
        except OSError:
            pass
    return [got[r] for r in range(world)]
