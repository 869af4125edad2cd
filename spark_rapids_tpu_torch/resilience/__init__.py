"""Resilience: graceful degradation under memory pressure and device
failures (reference: DeviceMemoryEventHandler.scala spill-retry, task retry
from lineage, per-node CPU fallback).

* ``retry``   — OOM classification (cause-chain walk, sticky CUDA errors),
  the spill → retry → split-in-half state machine splittable operators opt
  into, and the process-wide resilience counters.
* ``breaker`` — CPU-fallback circuit breaker: repeated non-OOM device
  failures per op signature flip that op to the CPU engine for the session.
* ``faults``  — deterministic, counter-driven fault injection (device OOM,
  kernel errors, spill-disk IO errors) behind
  ``spark.rapids.tpu.faults.*``; drives the chaos tests.
* ``lineage`` — task descriptors, attempt scopes and the recoverable-error
  predicate of the session's task-retry loop.
* ``watchdog`` — the stall and compile-deadline error types and the
  thread-local current token (the monitor thread comes later).

The port of ``spark_rapids_tpu/resilience/``.
"""
from __future__ import annotations

from .breaker import CircuitBreaker
from .faults import FaultConfig, InjectedFault
from .retry import (
    RetryPolicy,
    is_device_error,
    is_oom_error,
    is_sticky_device_error,
    record,
    report,
    reset,
    run_once,
    run_with_retry,
    split_batch,
    walk_causes,
)
from .watchdog import CompileDeadlineError, WatchdogStallError

__all__ = [
    "CircuitBreaker",
    "CompileDeadlineError",
    "FaultConfig",
    "InjectedFault",
    "WatchdogStallError",
    "RetryPolicy",
    "is_device_error",
    "is_oom_error",
    "is_sticky_device_error",
    "record",
    "report",
    "reset",
    "run_once",
    "run_with_retry",
    "split_batch",
    "walk_causes",
]
