"""Profiling facade — stable public entry points over the obs/ subsystem.

- typed metric registries      → :mod:`spark_rapids_tpu_torch.obs.metrics`
- hierarchical span tracing    → :mod:`spark_rapids_tpu_torch.obs.trace`
- reports/exporters            → :mod:`spark_rapids_tpu_torch.obs.export`

``walk``, ``instrument_plan``, ``query_trace``, ``metrics_report``,
``pipeline_report``, ``resilience_report`` and ``device_host_breakdown``
are importable from here, as from the JAX package's ``profiling.py``. What
stays native here is the device profiler: ``query_trace`` captures one
query under ``torch.profiler`` (CPU and, on a card, CUDA activity) and
writes it as a Chrome trace, and ``instrument_plan``'s opTime debug mode
waits for the device after every batch of every device operator
(``torch.cuda.synchronize`` on a CUDA device), inside an NVTX range named
after the operator, so an operator's time is its own kernels'; a host
operator's time is its own pulls, its children's excluded.

Copied from ``spark_rapids_tpu/profiling.py``, where ``jax.profiler``
(``trace``, ``TraceAnnotation``) and ``jax.block_until_ready`` stand in
these places.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time

import torch

from .obs.export import (  # noqa: F401  (public re-exports)
    device_host_breakdown,
    metrics_report,
    pipeline_report,
    resilience_report,
    walk,
)
from .plan.physical import Exec, ExecContext, PartitionSet


def _device_of(batch):
    return getattr(batch, "device", None)


def _wait(batch) -> None:
    """Block until the device finished the work behind ``batch`` (every
    thread launches on the default stream, so a stream sync covers it)."""
    dev = _device_of(batch)
    if dev is not None and torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def _range(name: str, batch):
    dev = _device_of(batch)
    if dev is not None and torch.device(dev).type == "cuda":
        return torch.cuda.nvtx.range(name)
    return contextlib.nullcontext()


#: per thread, the host pulls in flight: each entry sums the time of the
#: host pulls nested in it, so a host node's opTime is its own
_PULLS = threading.local()
_DONE = object()


def _host_pull(src):
    """(next batch of ``src`` or ``_DONE``, ns spent in this pull outside
    the host pulls nested in it)."""
    stack = _PULLS.__dict__.setdefault("stack", [])
    stack.append(0)
    t0 = time.perf_counter_ns()
    try:
        x = next(src, _DONE)
    finally:
        took = time.perf_counter_ns() - t0
        nested = stack.pop()
        if stack:
            stack[-1] += took
    return x, took - nested


def _wrap_partitions(node: Exec, pset: PartitionSet) -> PartitionSet:
    """Per-partition: mark each produced batch with an NVTX range named
    after the node and attribute the node's time per produced batch to its
    opTime metric. A device node's time is the blocked device time after
    the batch (its own kernels: its children waited already); a host node
    computes inside the pull, so its time is the pull's, less the host
    pulls of its children — what the calibrated routing's host ns/row
    reads (the JAX package times a host node's wait, which is ~0)."""
    from .obs.metrics import MetricKind

    op_time = node.metric("opTime", "DEBUG", MetricKind.NANOS)
    batches_m = node.metric("opOutputBatches", "DEBUG")
    # a host node's output rows (host batches count without a sync): the
    # calibration divides a host node's time by its sources' rows
    rows_m = None if node.is_device else node.metric("opOutputRows", "DEBUG")
    name = type(node).__name__

    def make(t):
        def it():
            for db in t():
                t0 = time.perf_counter_ns()
                with _range(name, db):
                    _wait(db)
                op_time.add(time.perf_counter_ns() - t0)
                batches_m.add(1)
                yield db

        def host_it():
            src = t()
            while True:
                b, own = _host_pull(src)
                op_time.add(own)
                if b is _DONE:
                    return
                batches_m.add(1)
                rows_m.add(int(getattr(b, "num_rows", 0)))
                yield b

        return it if node.is_device else host_it

    return PartitionSet([make(t) for t in pset.parts])


def instrument_plan(plan: Exec) -> None:
    """Instance-level wrap of every node's ``execute`` so its output
    partitions block-and-time per batch. Wall-clock spent blocking at node
    X = device work that finished between X-1's sync and X's sync = X's own
    kernels (the pipeline is serialized by the syncs themselves)."""
    for node in walk(plan):
        if getattr(node, "_profiled", False):
            continue
        orig = node.execute

        def execute(ctx: ExecContext, _orig=orig, _node=node):
            return _wrap_partitions(_node, _orig(ctx))

        node.execute = execute  # type: ignore[method-assign]
        node._profiled = True  # type: ignore[attr-defined]


class query_trace:
    """Context manager: capture one query execution under
    ``torch.profiler`` and write it to ``<path>/query-trace-<pid>-<n>.json``
    (Chrome trace) when a path is configured, else a no-op. This is the
    device profiler's capture; the portable span trace is obs/trace.py."""

    _count = 0

    def __init__(self, path: str | None):
        self.path = path or None
        self._prof = None
        self.file = None

    def __enter__(self):
        if self.path:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self._prof is None:
            return False
        self._prof.__exit__(*exc)
        os.makedirs(self.path, exist_ok=True)
        query_trace._count += 1
        self.file = os.path.join(
            self.path, f"query-trace-{os.getpid()}-{query_trace._count}.json"
        )
        self._prof.export_chrome_trace(self.file)
        return False
