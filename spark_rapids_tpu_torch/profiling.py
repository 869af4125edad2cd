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
waits for the device after every batch of every operator
(``torch.cuda.synchronize`` on a CUDA device), inside an NVTX range named
after the operator, so an operator's time is its own kernels'.

Copied from ``spark_rapids_tpu/profiling.py``, where ``jax.profiler``
(``trace``, ``TraceAnnotation``) and ``jax.block_until_ready`` stand in
these places.
"""
from __future__ import annotations

import contextlib
import os
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


def _wrap_partitions(node: Exec, pset: PartitionSet) -> PartitionSet:
    """Per-partition: mark each produced batch with an NVTX range named
    after the node and attribute the blocked device time per produced
    batch to the node's opTime metric."""
    from .obs.metrics import MetricKind

    op_time = node.metric("opTime", "DEBUG", MetricKind.NANOS)
    batches_m = node.metric("opOutputBatches", "DEBUG")
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

        return it

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
