"""Typed metric registry — the ``GpuMetric`` analogue, generalized.

Reference: GpuExec.scala:40-157 — one metric class with ESSENTIAL /
MODERATE / DEBUG levels gated by ``spark.rapids.sql.metrics.level``, plus
the Spark ``SQLMetrics`` accumulator taxonomy (sum / timing / size /
average). Here a :class:`Metric` is one thread-safe value with a *kind*
that tells exporters how to render it:

- ``COUNTER``   — monotonic sum (rows, bytes, retries, cache hits);
- ``NANOS``     — accumulated ``perf_counter_ns`` durations (rendered ms);
- ``GAUGE``     — last-set value (dispatch window, pool size);
- ``WATERMARK`` — high-watermark via ``set_max`` (peak HBM bytes, max
  in-flight depth — the reference's ``peakDevMemory``).

A :class:`MetricRegistry` is a dict of metrics with a *locked*
get-or-create. Two scopes exist:

- per-operator-instance: ``Exec.metrics`` (plan/physical.py) — rebuilt per
  query with the plan;
- process-wide: :data:`GLOBAL` — kernel builds, spill bytes by tier,
  semaphore waits, resilience counters, the scheduler, pipeline, fusion,
  speculation and watchdog series. Module-level code publishes here;
  sessions read it through :mod:`spark_rapids_tpu_torch.obs.export` views.

This module is dependency-free (stdlib threading only) so every layer of
the engine can import it without cycles.

Copied from ``spark_rapids_tpu/obs/metrics.py``. The process catalog holds
the series the port publishes (kernel builds, spill tiers, the semaphore,
the retry counters, task re-attempts, the scheduler, the pipeline, fusion,
speculation, the watchdog and the trace's own drop counter), under the JAX
package's names; the shuffle, serving, caching and live series come with
the slices that port them.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Iterable, Optional

METRIC_LEVELS = {"ESSENTIAL": 0, "MODERATE": 1, "DEBUG": 2}


class MetricKind:
    COUNTER = "counter"
    NANOS = "nanos"
    GAUGE = "gauge"
    WATERMARK = "watermark"
    HISTOGRAM = "histogram"


_SLUG_RE = __import__("re").compile(r"[^a-z0-9]+")


def metric_slug(name: str, fallback: str = "unspecified") -> str:
    """Free-form text → a bounded metric-name segment, the ONE rule for
    dynamically-named series (``scheduler.cancelled.reason.<slug>``,
    ``serve.tenant.<slug>.queries``) so their naming never diverges."""
    s = _SLUG_RE.sub("_", (name or fallback).lower()).strip("_")
    return (s or fallback)[:48]


# ── dynamic-series cardinality guard ────────────────────────────────────────
# metric_slug bounds each segment's LENGTH but not how many DISTINCT slugs a
# prefix accumulates: cancel reasons carry free-ish text and tenant names
# arrive from the wire, so an adversarial (or merely buggy) caller could mint
# unbounded Prometheus series. Every dynamically-named series therefore goes
# through dynamic_name(), which admits at most the configured number of
# distinct slugs per prefix (spark.rapids.tpu.metrics.maxDynamicSlugs) and
# folds the overflow into one shared 'other' bucket, counted in
# metrics.slugOverflow so the truncation is itself observable.

_SLUG_CAP = [64]
_SLUG_SEEN: Dict[str, set] = {}
_SLUG_LOCK = threading.Lock()

#: prefixes known to mint series dynamically — the metrics-lint allowlist
#: (a GLOBAL.counter(f"...") call whose literal prefix is listed here is a
#: catalogued dynamic family, not catalog drift)
DYNAMIC_PREFIXES = (
    "scheduler.cancelled.reason.",
    "scheduler.shed.reason.",
    "scheduler.pool.",
    "serve.tenant.",
    "watchdog.stalls.site.",
)


def set_slug_cap(n: int) -> None:
    """Install the per-prefix distinct-slug budget (session init reads
    spark.rapids.tpu.metrics.maxDynamicSlugs)."""
    _SLUG_CAP[0] = max(1, int(n))


def dynamic_name(prefix: str, raw: str, suffix: str = "",
                 fallback: str = "unspecified") -> str:
    """``prefix + metric_slug(raw) + suffix`` with the per-prefix
    cardinality cap applied: the cap+1-th distinct slug (and every one
    after it) becomes ``other``, and metrics.slugOverflow counts each
    folded observation."""
    s = metric_slug(raw, fallback)
    with _SLUG_LOCK:
        seen = _SLUG_SEEN.setdefault(prefix, set())
        if s not in seen:
            if len(seen) >= _SLUG_CAP[0]:
                GLOBAL.counter("metrics.slugOverflow").add(1)
                s = "other"
            else:
                seen.add(s)
    return f"{prefix}{s}{suffix}"


def infer_kind(name: str) -> str:
    """Kind from naming convention when a call site doesn't say: ``*Time`` /
    ``*Ns`` are timers, ``peak*`` / ``*HighWatermark`` are watermarks."""
    if name.endswith("Time") or name.endswith("Ns") or name.endswith("TimeNs"):
        return MetricKind.NANOS
    low = name.lower()
    if low.startswith("peak") or low.endswith("highwatermark"):
        return MetricKind.WATERMARK
    return MetricKind.COUNTER


class Metric:
    """One thread-safe metric value (the GpuMetric analogue)."""

    __slots__ = ("name", "value", "level", "kind", "_lock")

    def __init__(
        self,
        name: str,
        level: str = "ESSENTIAL",
        kind: Optional[str] = None,
    ):
        self.name = name
        self.value = 0  # graft: guarded_by(_lock)
        self.level = level
        self.kind = kind or infer_kind(name)
        self._lock = threading.Lock()

    def add(self, v: int):
        with self._lock:
            self.value += v

    def set(self, v: int):
        """Gauge semantics: last write wins."""
        with self._lock:
            self.value = v

    def set_max(self, v: int):
        """High-water-mark semantics (e.g. pipeline dispatch depth)."""
        with self._lock:
            if v > self.value:
                self.value = v

    class _Timer:
        __slots__ = ("m", "t0")

        def __init__(self, m):
            self.m = m

        def __enter__(self):
            self.t0 = time.perf_counter_ns()
            return self

        def __exit__(self, *a):
            self.m.add(time.perf_counter_ns() - self.t0)

    def timed(self) -> "_Timer":
        return Metric._Timer(self)

    def __repr__(self):
        # graft: ok(guarded-by: debug repr — a torn read of a CPython int
        # is impossible and a stale one is fine here)
        return f"Metric({self.name}={self.value}, {self.kind}/{self.level})"


class Histogram(Metric):
    """Fixed log₂-bucket histogram — real latency distributions for every
    series that used to keep bounded raw-sample lists (serve wait/run,
    scheduler queue wait, kernel compile, shuffle fetch).

    Bucket ``i`` holds observations ``v`` with ``2^(i-1) < v <= 2^i``
    (``v <= 0`` lands in bucket 0), so 64 buckets cover the whole int64
    range with no per-series configuration and ~7% worst-case relative
    quantile error — the GWP-style always-on tradeoff: cheap enough to
    leave running, accurate enough to rank.

    ``value`` is the observation COUNT (so generic exporters render
    something sane); ``add``/``timed()`` observe, so a Histogram drops in
    anywhere a NANOS timer was fed durations. ``state()`` snapshots
    ``(counts, sum, count)`` for delta-based percentile math (bench
    phases)."""

    N_BUCKETS = 64

    __slots__ = ("counts", "sum")

    def __init__(self, name: str, level: str = "ESSENTIAL"):
        super().__init__(name, level, MetricKind.HISTOGRAM)
        self.counts = [0] * self.N_BUCKETS
        self.sum = 0

    def observe(self, v) -> None:
        v = int(v)
        i = v.bit_length() if v > 0 else 0
        if i >= self.N_BUCKETS:
            i = self.N_BUCKETS - 1
        with self._lock:
            self.counts[i] += 1
            self.sum += v
            self.value += 1

    # timers feed durations through add() — same call shape as Metric
    def add(self, v) -> None:
        self.observe(v)

    def state(self) -> tuple:
        """Point-in-time ``(counts tuple, sum, count)`` — consistent under
        the metric lock, subtractable for windowed percentiles."""
        with self._lock:
            return (tuple(self.counts), self.sum, self.value)

    def quantile(self, q: float, state: Optional[tuple] = None) -> float:
        """Estimated q-quantile (0 <= q <= 1) by linear interpolation
        inside the selected bucket; 0.0 when empty."""
        counts, _s, total = state if state is not None else self.state()
        return quantile_from_counts(counts, total, q)


def histogram_delta(after: tuple, before: tuple) -> tuple:
    """``after - before`` of two Histogram.state() snapshots — the windowed
    view bench phases use (percentiles of only this run's observations)."""
    ca, sa, na = after
    cb, sb, nb = before
    return (
        tuple(a - b for a, b in zip(ca, cb)),
        sa - sb,
        na - nb,
    )


def quantile_from_counts(counts, total: int, q: float) -> float:
    """Interpolated quantile over log₂ bucket counts (bucket i spans
    (2^(i-1), 2^i]); 0.0 for an empty distribution."""
    if total <= 0:
        return 0.0
    rank = max(0.0, min(1.0, q)) * total
    seen = 0
    for i, c in enumerate(counts):
        if c <= 0:
            continue
        if seen + c >= rank:
            lo = 0.0 if i == 0 else float(1 << (i - 1))
            hi = 1.0 if i == 0 else float(1 << i)
            frac = (rank - seen) / c
            return lo + (hi - lo) * frac
        seen += c
    return float(1 << (len(counts) - 1))


class _NullMetric:
    """Shared no-op sink for metrics gated off by the level conf: call
    sites keep one unconditional code path with zero per-batch allocation
    or bookkeeping (the <2% instrumentation-cost contract)."""

    __slots__ = ()
    name = "__null__"
    value = 0
    level = "DEBUG"
    kind = MetricKind.COUNTER

    def add(self, v: int):
        pass

    def set(self, v: int):
        pass

    def set_max(self, v: int):
        pass

    class _NoopTimer:
        __slots__ = ()

        def __enter__(self):
            return self

        def __exit__(self, *a):
            pass

    _TIMER = _NoopTimer()

    def timed(self):
        return _NullMetric._TIMER


NULL_METRIC = _NullMetric()


class MetricRegistry(dict):
    """name → :class:`Metric` with a locked get-or-create.

    Subclasses ``dict`` so existing consumers (``node.metrics.values()``,
    ``.get(name)``, iteration) keep working unchanged.
    """

    def __init__(self, scope: str = ""):
        super().__init__()
        self.scope = scope
        self._lock = threading.Lock()

    def get_or_create(
        self, name: str, level: str = "ESSENTIAL", kind: Optional[str] = None
    ) -> Metric:
        m = self.get(name)
        if m is None:
            with self._lock:
                m = self.get(name)
                if m is None:
                    if kind == MetricKind.HISTOGRAM:
                        m = Histogram(name, level)
                    else:
                        m = Metric(name, level, kind)
                    self[name] = m
        return m

    # kind shorthands (the typed-registry surface)
    def counter(self, name: str, level: str = "ESSENTIAL") -> Metric:
        return self.get_or_create(name, level, MetricKind.COUNTER)

    def timer(self, name: str, level: str = "ESSENTIAL") -> Metric:
        return self.get_or_create(name, level, MetricKind.NANOS)

    def gauge(self, name: str, level: str = "ESSENTIAL") -> Metric:
        return self.get_or_create(name, level, MetricKind.GAUGE)

    def watermark(self, name: str, level: str = "ESSENTIAL") -> Metric:
        return self.get_or_create(name, level, MetricKind.WATERMARK)

    def histogram(self, name: str, level: str = "ESSENTIAL") -> "Histogram":
        return self.get_or_create(name, level, MetricKind.HISTOGRAM)

    def snapshot(self) -> Dict[str, int]:
        """Point-in-time name → value (stable iteration copy)."""
        with self._lock:
            return {name: m.value for name, m in self.items()}

    def view(self, prefix: str, strip: bool = True) -> Dict[str, int]:
        """Snapshot of the metrics under ``prefix`` (``resilience.``,
        ``spill.`` …), optionally with the prefix stripped — the registry
        view the old bespoke report functions became."""
        with self._lock:
            return {
                (name[len(prefix):] if strip else name): m.value
                for name, m in self.items()
                if name.startswith(prefix)
            }

    def reset(self, prefix: str = "") -> None:
        """Zero the metrics under ``prefix`` ('' = all). Values are zeroed
        in place — published references stay live. Each metric's own lock
        is taken so a racing ``add`` cannot resurrect the pre-reset total
        (the unlocked write could land inside add's read-modify-write)."""
        with self._lock:
            for name, m in self.items():
                if name.startswith(prefix):
                    with m._lock:
                        m.value = 0
                        if isinstance(m, Histogram):
                            m.counts = [0] * Histogram.N_BUCKETS
                            m.sum = 0


#: Process-wide registry (kernel compiles, spill tiers, shuffle bytes,
#: semaphore waits, resilience counters). Sessions read it via export views.
GLOBAL = MetricRegistry(scope="process")


# ── well-known process metrics (the metric catalog) ─────────────────────────
# Registered eagerly so exporters always emit the full series set (a
# Prometheus scrape sees `spark_rapids_tpu_spill_bytes_device_to_host 0`
# on a healthy run instead of a missing series), and so docs/observability.md
# can list the catalog. Per-operator metrics (numInputRows, opTime, pipe*)
# live on Exec instances and are documented there.

CATALOG: Iterable[tuple] = (
    # kernels.py — the nvcc builds of the hand-written kernels
    ("kernel.builds", MetricKind.COUNTER, "kernel and host libraries built by nvcc or g++ (cache misses)"),
    ("kernel.compileTimeNs", MetricKind.NANOS, "time spent in nvcc and g++ builds at first use"),
    ("kernel.compileHist", MetricKind.HISTOGRAM,
     "nvcc or g++ build time per library (ns distribution)"),
    # mem/spill.py — spill bytes by tier transition + device watermark
    ("spill.bytesDeviceToHost", MetricKind.COUNTER, "bytes spilled device → host RAM"),
    ("spill.bytesHostToDisk", MetricKind.COUNTER, "bytes spilled host RAM → disk"),
    ("spill.bytesDiskToHost", MetricKind.COUNTER, "bytes re-materialized disk → host RAM"),
    ("spill.count", MetricKind.COUNTER, "tier-transition spill operations"),
    ("mem.deviceBytesHighWatermark", MetricKind.WATERMARK,
     "peak registered spillable bytes on device, sampled at batch boundaries"),
    # mem/semaphore.py — admission control
    ("semaphore.acquires", MetricKind.COUNTER, "device-semaphore acquisitions"),
    ("semaphore.waitNs", MetricKind.NANOS, "time blocked acquiring the device semaphore"),
    # sched/* — multi-tenant admission control (per-pool admitted counters
    # under scheduler.pool.<name>.admitted and per-cause cancellations
    # under scheduler.cancelled.reason.<slug> register dynamically on
    # first use)
    ("scheduler.admitted", MetricKind.COUNTER, "queries granted device permits"),
    ("scheduler.rejected", MetricKind.COUNTER, "admissions rejected (QueryQueueFull)"),
    ("scheduler.cancelled", MetricKind.COUNTER,
     "queries cancelled (queued or running) — the aggregate over every "
     "scheduler.cancelled.reason.* series, deadline expiries INCLUDED "
     "(a timeout is a cancellation with reason 'deadline')"),
    ("scheduler.timeouts", MetricKind.COUNTER,
     "queries past their deadline (QueryTimeoutError); each is also "
     "counted in scheduler.cancelled under reason.deadline"),
    ("scheduler.queueWaitNs", MetricKind.NANOS, "time queries spent waiting for admission"),
    ("scheduler.queueDepth", MetricKind.GAUGE, "queries currently waiting for admission"),
    ("scheduler.permitsInUse", MetricKind.GAUGE, "admission permits currently held"),
    ("scheduler.effectivePermits", MetricKind.GAUGE,
     "live permit limit (configured permits, halved under OOM pressure)"),
    ("scheduler.shed", MetricKind.COUNTER,
     "admissions shed by deadline-aware load shedding (per-cause series "
     "under scheduler.shed.reason.*; each also counts in rejected)"),
    ("scheduler.queueWaitHist", MetricKind.HISTOGRAM,
     "admission queue wait per query (ns distribution)"),
    # resilience/watchdog.py — hung-query detection (per-site series under
    # watchdog.stalls.site.* register dynamically on first use)
    ("watchdog.stalls", MetricKind.COUNTER,
     "queries cancelled by the progress watchdog (no beat for "
     "stallTimeout); classified per stall site (compile/launch/fetch/"
     "client) under watchdog.stalls.site.*"),
    # exec/pipeline.py — dispatch-ahead producers
    ("pipeline.dispatchHist", MetricKind.HISTOGRAM,
     "per-batch upstream production time on pipeline producers "
     "(ns distribution)"),
    # obs/ self-observation — the attribution layer watches itself
    ("trace.droppedSpans", MetricKind.COUNTER,
     "spans overwritten by ring-buffer wrap across all tracers (a "
     "truncated Perfetto export is detectable, not silent)"),
    ("metrics.slugOverflow", MetricKind.COUNTER,
     "dynamic-series observations folded into an 'other' bucket because "
     "their prefix hit spark.rapids.tpu.metrics.maxDynamicSlugs"),
    # resilience/* — the retry.report() counters (registry view)
    ("resilience.oom_retries", MetricKind.COUNTER, "spill-and-retry launches after device OOM"),
    ("resilience.splits", MetricKind.COUNTER, "OOM batch halvings"),
    ("resilience.circuit_breaker_trips", MetricKind.COUNTER, "ops flipped to CPU by the breaker"),
    ("resilience.spill_write_errors", MetricKind.COUNTER, "disk-spill write failures (degraded to HOST)"),
    ("resilience.faults_injected", MetricKind.COUNTER, "chaos-harness injections fired"),
    # resilience/lineage.py + sched/speculation.py — partition-granular
    # recovery (task re-execution, straggler speculation, stage fallback)
    ("task.reattempts", MetricKind.COUNTER,
     "partition tasks re-executed under a fresh attempt id after a "
     "recoverable fault (spark.task.maxFailures bounds the loop)"),
    ("speculation.launched", MetricKind.COUNTER,
     "speculative duplicate attempts launched for straggling partitions"),
    ("speculation.won", MetricKind.COUNTER,
     "speculative attempts that committed first (original cancelled)"),
    ("fusion.breakerFallbacks", MetricKind.COUNTER,
     "fused stages rebuilt as their unfused per-op chain because the "
     "circuit breaker opened on the stage signature"),
)

for _name, _kind, _doc in CATALOG:
    GLOBAL.get_or_create(_name, "ESSENTIAL", _kind)
