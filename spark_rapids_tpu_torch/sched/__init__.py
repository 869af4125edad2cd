"""Multi-tenant query scheduling — admission control, pools, cancellation.

- :mod:`.cancel` — per-query :class:`CancelToken` (cancellation + deadline),
  checked at batch boundaries throughout the engine;
- :mod:`.estimate` — peak device working-set estimation from the physical
  plan (scan footprints × widest operator, plus join/agg build sides);
- :mod:`.admission` — :class:`WeightedPermitPool`: the weighted, multi-query
  generalization of ``mem/semaphore.py``'s DeviceSemaphore, with fair-share
  pools and a bounded admission queue;
- :mod:`.scheduler` — :class:`QueryScheduler`: ties the three together and
  owns the active-query registry (``session.cancel`` / ``cancel_all``);
- :mod:`.speculation` — :class:`SpeculationMonitor`: duplicate attempts for
  straggling partitions, first commit wins.

Copied from ``spark_rapids_tpu/sched/``.
"""
from .cancel import (
    CancelToken,
    LinkedCancelToken,
    QueryCancelledError,
    QueryOverloadedError,
    QueryQueueFull,
    QueryTimeoutError,
    SchedulerError,
)
from .admission import PoolSpec, WeightedPermitPool, parse_pool_spec
from .estimate import estimate_plan_bytes
from .scheduler import Admission, QueryScheduler

__all__ = [
    "Admission",
    "CancelToken",
    "LinkedCancelToken",
    "PoolSpec",
    "QueryCancelledError",
    "QueryOverloadedError",
    "QueryQueueFull",
    "QueryScheduler",
    "QueryTimeoutError",
    "SchedulerError",
    "WeightedPermitPool",
    "estimate_plan_bytes",
    "parse_pool_spec",
]
