"""Exporters over the metric registries, span buffers and phase ledgers.

Three consumers, three formats:

- :func:`prometheus_text` — the process-wide registry plus the last plan's
  per-operator metrics in Prometheus text exposition format (scrape it
  live through ``obs/scrape.py``, or dump it next to a run);
- :func:`query_artifact` / :func:`write_query_artifact` — one JSON document
  per query: per-node metrics, pipeline health, resilience counters, the
  phase ledger and the process registry snapshot;
- :func:`render_plan_metrics` — the ``df.explain("metrics")`` renderer:
  per-op metrics inline on the physical plan tree, nanos rendered as ms,
  headed by :func:`render_ledger`'s ranked phases.

The report functions (``metrics_report``, ``pipeline_report``,
``resilience_report``, ``device_host_breakdown``) live here;
``profiling.py`` keeps their public names.

Copied from ``spark_rapids_tpu/obs/export.py``: the same Prometheus names
(prefix ``spark_rapids_tpu_``, so one dashboard reads both packages) and
the same artifact keys. The shuffle compression-ratio gauge waits for the
shuffle slice.
"""
from __future__ import annotations

import json
import os
import re
from typing import Iterator, Optional

from . import metrics as M
from .metrics import GLOBAL, MetricKind


def walk(plan) -> Iterator:
    yield plan
    for c in plan.children:
        yield from walk(c)


# ── plan renderers ──────────────────────────────────────────────────────────


def _fmt_value(m) -> str:
    if m.kind == MetricKind.NANOS:
        return f"{m.value / 1e6:.1f}ms"
    return str(m.value)


def render_plan_metrics(plan, level: Optional[str] = None) -> str:
    """Physical plan tree with each node's metrics inline —
    ``df.explain("metrics")`` (reference-style per-op annotations).
    ``level`` caps what is shown (e.g. ``"ESSENTIAL"``); None shows every
    collected metric."""
    cutoff = M.METRIC_LEVELS.get((level or "").upper())
    lines = []

    def fmt(node, indent: int):
        shown = []
        for name in sorted(node.metrics):
            m = node.metrics[name]
            if cutoff is not None and M.METRIC_LEVELS.get(m.level, 0) > cutoff:
                continue
            shown.append(f"{name}={_fmt_value(m)}")
        mark = "* " if node.is_device else "  "
        lines.append(
            "  " * indent + mark + node.node_string()
            + (("  [" + ", ".join(shown) + "]") if shown else "")
        )
        for c in node.children:
            fmt(c, indent + 1)

    fmt(plan, 0)
    return "\n".join(lines)


def render_ledger(ledger) -> str:
    """Human-readable host-overhead breakdown for ``df.explain("metrics")``:
    the query's wall clock decomposed into ranked phases with percentages —
    ``host_overhead_frac`` as an answer instead of a number."""
    if ledger is None:
        return ""
    bd = ledger.breakdown()
    wall = bd["wall_ms"]
    lines = [f"host-overhead ledger: wall {wall:.1f}ms"]
    for phase, ms in bd["phases_ms"].items():
        pct = (100.0 * ms / wall) if wall else 0.0
        lines.append(f"  {phase:<16} {ms:>10.1f}ms  {pct:5.1f}%")
    if bd["parallel_overlap_ms"]:
        lines.append(
            f"  (parallel overlap: {bd['parallel_overlap_ms']:.1f}ms measured "
            "on concurrent threads beyond the wall)"
        )
    return "\n".join(lines)


def metrics_report(plan) -> str:
    """Human-readable per-node metric tree (Spark-UI stand-in; the
    pre-obs ``profiling.metrics_report`` contract — every level shown)."""
    return render_plan_metrics(plan, level=None)


def device_host_breakdown(plan) -> dict:
    """Aggregate totals: device-attributed op time vs host transfer time
    vs rows moved."""
    out = {
        "op_time_ms": 0.0,
        "h2d_time_ms": 0.0,
        "d2h_time_ms": 0.0,
        "h2d_bytes": 0,
        "d2h_bytes": 0,
        "per_node_ms": {},
    }
    for node in walk(plan):
        for m in node.metrics.values():
            if m.name == "opTime":
                ms = m.value / 1e6
                out["op_time_ms"] += ms
                key = type(node).__name__
                out["per_node_ms"][key] = out["per_node_ms"].get(key, 0.0) + ms
            elif m.name == "hostToDeviceTime":
                out["h2d_time_ms"] += m.value / 1e6
            elif m.name == "deviceToHostTime":
                out["d2h_time_ms"] += m.value / 1e6
            elif m.name == "hostToDeviceBytes":
                out["h2d_bytes"] += m.value
            elif m.name == "deviceToHostBytes":
                out["d2h_bytes"] += m.value
    out["per_node_ms"] = dict(
        sorted(out["per_node_ms"].items(), key=lambda kv: -kv[1])
    )
    return out


def pipeline_report(plan) -> dict:
    """Dispatch-ahead pipeline health (exec/pipeline.py feeds the
    ``pipe*`` metrics):

    * ``dispatch_depth`` — deepest in-flight window observed at any
      pipelined sink (0 = pipeline never engaged);
    * ``overlap_frac``   — fraction of upstream production time hidden
      behind consumer-side work, ``1 - stall/producer``;
    * ``pipe_stall_ms``  — total consumer time blocked on an empty window;
    * ``pipe_stalls``    — the per-stage breakdown of those stalls.
    """
    depth = 0
    stall_ns = 0
    producer_ns = 0
    stages: dict = {}
    for node in walk(plan):
        ms = node.metrics
        d = ms.get("pipeDispatchDepth")
        if d is not None:
            depth = max(depth, d.value)
        st = ms.get("pipeStallTime")
        if st is not None and st.value:
            stall_ns += st.value
            key = type(node).__name__
            stages[key] = round(stages.get(key, 0.0) + st.value / 1e6, 1)
        pr = ms.get("pipeProducerTime")
        if pr is not None:
            producer_ns += pr.value
    overlap = 0.0
    if producer_ns > 0:
        overlap = max(0.0, min(1.0, 1.0 - stall_ns / producer_ns))
    return {
        "dispatch_depth": depth,
        "overlap_frac": round(overlap, 3),
        "pipe_stall_ms": round(stall_ns / 1e6, 1),
        "pipe_stalls": stages,
    }


def resilience_report(session=None) -> dict:
    """Fault-tolerance counters — a view over the ``resilience.`` slice of
    the process registry (the old bespoke dict is now a registry view).
    With a ``session``, the circuit breaker's open set rides along."""
    out = GLOBAL.view("resilience.")
    breaker = getattr(session, "_breaker", None)
    if breaker is not None:
        out["circuit_breaker_open"] = breaker.state()["open"]
    return out


# ── prometheus text exposition format ───────────────────────────────────────

_SANITIZE = re.compile(r"[^a-zA-Z0-9_]")


def _render_histogram(lines, pname, m) -> None:
    """Prometheus histogram exposition: cumulative ``_bucket{le=...}`` rows
    (log₂ upper bounds, trailing empty buckets elided), ``+Inf``, ``_sum``,
    ``_count`` — the invariant scrapers rely on: the +Inf bucket equals
    ``_count`` and bucket counts are monotone non-decreasing."""
    counts, total_sum, count = m.state()
    lines.append(f"# TYPE {pname} histogram")
    # elide the empty head and tail: Prometheus accepts any le subset as
    # long as cumulative counts are monotone and +Inf equals _count —
    # 64 log2 buckets would otherwise be mostly zeros on every series
    nonempty = [i for i, c in enumerate(counts) if c]
    lowest = max(0, (nonempty[0] - 1)) if nonempty else 0
    highest = nonempty[-1] if nonempty else -1
    cum = 0
    for i in range(lowest, highest + 1):
        cum += counts[i]
        le = 1 if i == 0 else (1 << i)
        lines.append(f'{pname}_bucket{{le="{le}"}} {cum}')
    lines.append(f'{pname}_bucket{{le="+Inf"}} {count}')
    lines.append(f"{pname}_sum {total_sum}")
    lines.append(f"{pname}_count {count}")


def _prom_name(name: str) -> str:
    # kernel.compileTimeNs → kernel_compile_time_ns (prometheus snake case)
    name = name.replace(".", "_")
    name = re.sub(r"(?<=[a-z0-9])([A-Z])", r"_\1", name).lower()
    return "spark_rapids_tpu_" + _SANITIZE.sub("_", name)


def prometheus_text(plan=None, session=None) -> str:
    """Prometheus text-format dump: every process-registry series (always
    emitted, zero or not, so scrapes see a stable series set) plus — when a
    ``plan`` is given — its per-operator metrics as one labeled family."""
    lines = []
    with GLOBAL._lock:  # stable copy: registrations may race a scrape
        snap = dict(GLOBAL)
    for name in sorted(snap):
        m = snap[name]
        pname = _prom_name(name)
        if m.kind == MetricKind.HISTOGRAM:
            _render_histogram(lines, pname, m)
            continue
        ptype = "counter" if m.kind in (MetricKind.COUNTER, MetricKind.NANOS) else "gauge"
        lines.append(f"# TYPE {pname} {ptype}")
        lines.append(f"{pname} {m.value}")
    if session is not None:
        breaker = getattr(session, "_breaker", None)
        if breaker is not None:
            lines.append("# TYPE spark_rapids_tpu_circuit_breaker_open gauge")
            lines.append(
                f"spark_rapids_tpu_circuit_breaker_open "
                f"{len(breaker.state()['open'])}"
            )
    if plan is not None:
        fam = "spark_rapids_tpu_operator_metric"
        lines.append(f"# TYPE {fam} gauge")
        for i, node in enumerate(walk(plan)):
            op = type(node).__name__
            for name in sorted(node.metrics):
                m = node.metrics[name]
                lines.append(
                    f'{fam}{{op="{op}",node="{i}",metric="{name}"}} {m.value}'
                )
    return "\n".join(lines) + "\n"


# ── per-query JSON artifact ─────────────────────────────────────────────────


def query_artifact(plan=None, session=None, tracer=None, ledger=None) -> dict:
    """One machine-readable document per query: per-node metrics, the
    pipeline + resilience views (the old bespoke reports, folded in), the
    process-registry snapshot, the host-overhead phase ledger, and trace
    stats when a tracer ran."""
    out: dict = {"process": GLOBAL.snapshot()}
    if plan is not None:
        out["operators"] = plan.collect_metrics()
        out["pipeline"] = pipeline_report(plan)
        out["breakdown"] = device_host_breakdown(plan)
    if ledger is None and session is not None:
        ledger = getattr(session, "_last_ledger", None)
    if ledger is not None:
        out["ledger"] = ledger.breakdown()
    out["resilience"] = resilience_report(session)
    if tracer is not None:
        out["trace"] = {
            "spans": tracer.span_count,
            "dropped": tracer.dropped,
            "capacity": tracer.capacity,
        }
    return out


def write_query_artifact(path: str, plan=None, session=None, tracer=None,
                         ledger=None) -> str:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(
            query_artifact(plan, session, tracer, ledger=ledger),
            f, indent=1,
        )
    return path
