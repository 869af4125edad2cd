"""Observability — typed metrics, the phase ledger, hierarchical tracing
and exporters, copied from ``spark_rapids_tpu/obs/``:

- :mod:`.metrics` — the typed metric registry, per-operator
  (``Exec.metrics``) and process-wide (``GLOBAL``), with log₂ histograms;
- :mod:`.ledger` — the per-query phase ledger (wall clock → exhaustive,
  non-overlapping phases);
- :mod:`.trace` — query → operator → batch spans in a ring buffer, with
  span context carried onto pipeline producer threads, exported as
  Chrome-trace/Perfetto JSON;
- :mod:`.export` — Prometheus text, the per-query JSON artifact and the
  ``df.explain("metrics")`` renderer;
- :mod:`.scrape` — the live ``/metrics`` + ``/healthz`` HTTP endpoint;
- :mod:`.calibration` — measured per-op cost tables for the cost-based
  optimizer.
"""
from . import ledger, metrics, trace  # noqa: F401
from .metrics import (  # noqa: F401
    GLOBAL,
    Histogram,
    Metric,
    MetricKind,
    MetricRegistry,
)
