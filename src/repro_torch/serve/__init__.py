"""Serving of the port: a batched engine over dense or paged CLOVER-rank
KV caches, with copy-on-write prefix caching and a host-RAM spill tier
on the paged layout, self-speculative decoding, overload safety and
multi-tenant SV adapters (DESIGN.md §6, §8, §9, §11, §12, §13:
``core.peft.AdapterRegistry``, re-exported here, and
``Request.adapter_id``).

  * ``config``    — ``EngineConfig``
  * ``memory``    — ``PageAllocator``, ``PrefixCache``, ``HostTier``
  * ``scheduler`` — ``Request``, ``Scheduler``, phases and statuses
  * ``faults``    — ``FaultPlan``, ``FaultError`` (fault injection)
  * ``executor``  — ``LocalExecutor`` (step entries on the device)
  * ``metrics``   — ``ServeMetrics`` behind ``Engine.stats()``
  * ``engine``    — ``Engine``, ``greedy_reference``
"""
from repro_torch.core.peft import AdapterRegistry  # noqa: F401
from repro_torch.serve.config import EngineConfig  # noqa: F401
from repro_torch.serve.engine import Engine, greedy_reference  # noqa: F401
from repro_torch.serve.executor import LocalExecutor  # noqa: F401
from repro_torch.serve.faults import FaultError, FaultPlan  # noqa: F401
from repro_torch.serve.memory import (  # noqa: F401
    HostTier, PageAllocator, PrefixCache)
from repro_torch.serve.metrics import ServeMetrics  # noqa: F401
from repro_torch.serve.scheduler import (  # noqa: F401
    CANCELLED, DONE, QUEUED, RUNNING, SHED, TERMINAL, TIMED_OUT, Request,
    Scheduler)
