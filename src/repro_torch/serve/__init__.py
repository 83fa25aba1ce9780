"""Serving of the port: a batched engine over dense or paged CLOVER-rank
KV caches (DESIGN.md §6).

  * ``config``    — ``EngineConfig``
  * ``memory``    — ``PageAllocator``
  * ``scheduler`` — ``Request``, ``Scheduler``, phases and statuses
  * ``executor``  — ``LocalExecutor`` (step entries on the device)
  * ``metrics``   — ``ServeMetrics`` behind ``Engine.stats()``
  * ``engine``    — ``Engine``, ``greedy_reference``
"""
from repro_torch.serve.config import EngineConfig  # noqa: F401
from repro_torch.serve.engine import Engine, greedy_reference  # noqa: F401
from repro_torch.serve.executor import LocalExecutor  # noqa: F401
from repro_torch.serve.memory import PageAllocator  # noqa: F401
from repro_torch.serve.metrics import ServeMetrics  # noqa: F401
from repro_torch.serve.scheduler import (  # noqa: F401
    DONE, QUEUED, RUNNING, Request, Scheduler)
