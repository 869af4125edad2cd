"""Dispatch-ahead partition pipelining.

CUDA launches are asynchronous (enqueuing a kernel costs a few
microseconds; only ``.cpu()``/``.item()``/synchronizes wait), but the
engine's operator chains are *pull-based* generators: batch i+1's kernels
are not even launched until the consumer finishes with batch i. Every
blocking sink — the D2H pull at collect(), a LIMIT's per-batch row-count
sync — therefore idles the device for a full host round trip per batch.

``PipelinedIterator`` moves the upstream pull loop onto a producer thread
with a bounded in-flight window: device work for batches i+1..i+k is
launched while the consumer blocks on batch i. The window is bounded by
BOTH a batch count (``spark.rapids.tpu.pipeline.maxBatches``) and bytes
(``spark.rapids.tpu.pipeline.maxInflightBytes``), and the producer asks the
spill catalog for headroom before each pull — prefetch can never grow the
device working set unboundedly.

Semantics preserved:

* batches arrive in order, exactly once (no loss, no duplication);
* an upstream error surfaces on the CONSUMING thread, after every batch
  produced before it;
* closing the iterator (LIMIT early-exit, a downstream error) stops the
  producer at the next batch boundary and closes the upstream generator on
  the producer thread (generators must be closed by the thread driving
  them);
* the device-semaphore permit acquired by upstream operators on the
  producer thread is released when production ends (the ``release``
  callback) — without it a producer thread would end still holding its
  permit, and with ``concurrentGpuTasks=1`` the next partition's producer
  (and the consumer waiting on it) would block forever.

Every thread of the port launches on the device's default stream, so the
device runs the producer's and the consumer's kernels in launch order:
a batch handed across the window needs no event or ``record_stream``.

Copied from ``spark_rapids_tpu/exec/pipeline.py``. The producer is a plain
daemon thread: nothing compiles on it here, where the JAX package gave it
a big stack for XLA's compiles.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Iterator, Optional

from ..obs import ledger as obs_ledger
from ..obs import trace as obs_trace
from ..obs.metrics import GLOBAL as _GLOBAL_METRICS
from ..obs.metrics import MetricKind

#: per-batch upstream production time on producer threads (log2 buckets):
#: the distribution behind the pipeProducerTime total
_M_DISPATCH_HIST = _GLOBAL_METRICS.histogram("pipeline.dispatchHist")

class PipelinedIterator:
    """Bounded dispatch-ahead prefetcher over an iterator of batches.

    ``metrics`` (optional) is a dict of plan Metrics fed while running:
      * ``depth``     — max batches ever in flight (set_max)
      * ``stall``     — ns the consumer waited on an empty window
      * ``producer``  — ns the producer spent pulling upstream batches
      * ``wait_full`` — ns the producer waited on a full window
      * ``batches``   — batches that crossed the pipe
    """

    def __init__(
        self,
        source: Iterator,
        depth: int = 4,
        max_bytes: int = 0,
        catalog=None,
        release: Optional[Callable[[], None]] = None,
        metrics: Optional[dict] = None,
        cancel_token=None,
    ):
        self._source = source
        # sched/ cancellation: checked before each upstream pull so a
        # cancelled query's producer stops at its next batch boundary; the
        # raised error surfaces on the consuming thread like any upstream
        # failure, and the finally-block release still runs (semaphore/
        # permit holds cannot leak on a cancel)
        self._cancel_token = cancel_token
        self._depth = max(1, int(depth))
        self._max_bytes = max(0, int(max_bytes))
        self._catalog = catalog
        self._release = release
        self._metrics = metrics or {}
        self._cond = threading.Condition()
        self._buf: list = []  # [(item, size_bytes)]
        self._bytes = 0
        self._stop = False
        self._done = False
        self._error: Optional[BaseException] = None
        self._last_size = 0
        # span-context propagation (obs/trace.py): capture the consuming
        # thread's current span so upstream work pulled on the producer
        # thread attributes under the operator that spawned the pipeline —
        # not outside the query trace (the pre-obs attribution hole). The
        # phase ledger propagates the same way: producer-side pulls bill
        # the query's 'dispatch' phase.
        self._trace_ctx = obs_trace.capture_context()
        self._ledger = obs_ledger.current()
        from . import task as _task

        self._in_pool = _task.in_task_pool()
        self._thread = threading.Thread(
            target=self._produce, name="srt-pipeline", daemon=True
        )
        self._thread.start()

    # ── producer side ───────────────────────────────────────────────────
    def _window_full(self) -> bool:
        depth = self._depth
        if depth > 1:
            # resilience opt-in: while the OOM retry machinery has fired
            # recently anywhere in the process, prefetching ahead only adds
            # allocation pressure to a device that just ran out — clamp the
            # dispatch window to one batch until the pressure signal ages
            # out (resilience/retry.py oom_pressure)
            from ..resilience import retry as _R

            if _R.oom_pressure():
                depth = 1
        if len(self._buf) >= depth:
            return True
        # the bytes bound never blocks an EMPTY window: one batch must
        # always be able to flow or an oversized batch would deadlock
        return bool(
            self._max_bytes
            and self._buf
            and self._bytes >= self._max_bytes
        )

    def _produce(self) -> None:
        from . import task as _task

        obs_trace.attach_context(self._trace_ctx)
        obs_ledger.set_current(self._ledger)
        _task.set_in_task_pool(self._in_pool)
        led = self._ledger
        if self._cancel_token is not None:
            # producer threads drive upstream pulls (and first-touch
            # compiles): give the watchdog a current token here too
            from ..resilience import watchdog as _wd

            _wd.set_current(self._cancel_token)
        m_prod = self._metrics.get("producer")
        m_full = self._metrics.get("wait_full")
        m_depth = self._metrics.get("depth")
        it = self._source
        try:
            while True:
                with self._cond:
                    t0 = time.perf_counter_ns()
                    while self._window_full() and not self._stop:
                        self._cond.wait(0.1)
                    if m_full is not None:
                        m_full.add(time.perf_counter_ns() - t0)
                    if self._stop:
                        return
                if self._catalog is not None and self._last_size:
                    # make room for roughly one more batch BEFORE dispatching
                    # it, so prefetch pressure spills parked buffers instead
                    # of OOMing the allocator mid-kernel
                    try:
                        self._catalog.ensure_headroom(self._last_size)
                    except Exception:
                        pass  # headroom is advisory; the pull may still fit
                if self._cancel_token is not None:
                    self._cancel_token.check()
                t0 = time.perf_counter_ns()
                try:
                    # the pull is the upstream chain's production: kernel
                    # enqueue + operator host work → ledger 'dispatch'
                    # (nested compile/h2d scopes subtract themselves out)
                    with obs_ledger.scope_or_null(led, "dispatch"):
                        item = next(it)
                except StopIteration:
                    return
                pull_ns = time.perf_counter_ns() - t0
                _M_DISPATCH_HIST.observe(pull_ns)
                if m_prod is not None:
                    m_prod.add(pull_ns)
                size = 0
                sb = getattr(item, "size_bytes", None)
                if callable(sb):
                    try:
                        size = int(sb())
                    except Exception:
                        size = 0
                self._last_size = size or self._last_size
                with self._cond:
                    if self._stop:
                        return
                    self._buf.append((item, size))
                    self._bytes += size
                    if m_depth is not None:
                        m_depth.set_max(len(self._buf))
                    self._cond.notify_all()
        except BaseException as e:  # noqa: BLE001 - re-raised on the consumer
            with self._cond:
                self._error = e
                self._cond.notify_all()
        finally:
            close = getattr(it, "close", None)
            if callable(close):
                try:
                    close()  # generators must be closed by their own driver
                except BaseException:  # noqa: BLE001
                    pass
            if self._release is not None:
                try:
                    self._release()
                except Exception:
                    pass
            with self._cond:
                self._done = True
                self._cond.notify_all()

    # ── consumer side ───────────────────────────────────────────────────
    def __iter__(self) -> "PipelinedIterator":
        return self

    def __next__(self):
        m_stall = self._metrics.get("stall")
        m_batches = self._metrics.get("batches")
        with self._cond:
            t0 = time.perf_counter_ns()
            while not self._buf and not self._done and self._error is None:
                self._cond.wait(0.1)
            if m_stall is not None:
                m_stall.add(time.perf_counter_ns() - t0)
            if self._buf:
                item, size = self._buf.pop(0)
                self._bytes -= size
                self._cond.notify_all()
                if m_batches is not None:
                    m_batches.add(1)
                return item
            if self._error is not None:
                err, self._error = self._error, None
                self._done = True
                raise err
            raise StopIteration

    def close(self, join_timeout: float = 0.5) -> None:
        """Stop the producer at its next batch boundary and drop any
        buffered (unconsumed) batches. Safe to call more than once.

        The join is best-effort: a producer parked inside a long device
        pull must not stall a LIMIT early-exit (the latency this layer
        exists to remove), so after a short grace the daemon thread is
        left to finish its in-flight batch alone — it re-checks ``_stop``
        under the lock before buffering, so nothing it produces leaks."""
        with self._cond:
            self._stop = True
            self._buf.clear()
            self._bytes = 0
            self._cond.notify_all()
        self._thread.join(timeout=join_timeout)

    def __enter__(self) -> "PipelinedIterator":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def pipeline_conf(ctx) -> Optional[dict]:
    """Resolve the pipeline settings for one query context; None when the
    kill switch (``spark.rapids.tpu.pipeline.enabled=false``) is thrown."""
    from .. import config as cfg

    if not cfg.PIPELINE_ENABLED.get(ctx.conf):
        return None
    max_bytes = cfg.PIPELINE_MAX_INFLIGHT_BYTES.get(ctx.conf)
    if max_bytes <= 0:
        # auto: a quarter of the spillable device budget when one is known,
        # else 1 GiB — small next to HBM, large next to typical batches
        limit = getattr(ctx.catalog, "device_limit", 0) or 0
        max_bytes = limit // 4 if limit > 0 else (1 << 30)
    return {
        "depth": cfg.PIPELINE_MAX_BATCHES.get(ctx.conf),
        "max_bytes": max_bytes,
    }


def pipe_metrics(node, ctx=None) -> dict:
    """The five ``pipe*`` metrics of a pipelined sink (typed: the window
    depth is a high-watermark, the three waits are nanos timers). Call once
    per execute() — on the single-threaded plan-walk — and pass the dict
    into ``pipelined_partition`` so partition thunks share one metric set.
    With a ``ctx`` the MODERATE level gates collection: at ESSENTIAL the
    sink publishes nothing (the hot loop's no-obs-work contract)."""
    if ctx is not None and not node.metrics_on(ctx, "MODERATE"):
        return {}
    return {
        "depth": node.metric("pipeDispatchDepth", "MODERATE", MetricKind.WATERMARK),
        "stall": node.metric("pipeStallTime", "MODERATE", MetricKind.NANOS),
        "producer": node.metric("pipeProducerTime", "MODERATE", MetricKind.NANOS),
        "wait_full": node.metric("pipeWaitFullTime", "MODERATE", MetricKind.NANOS),
        "batches": node.metric("pipeBatches", "MODERATE", MetricKind.COUNTER),
    }


def pipelined_partition(conf, ctx, it, fn, metrics=None):
    """Run ``fn`` (a batch-stream transform, e.g. the D2H pull loop) over a
    dispatch-ahead view of partition iterator ``it``; falls back to the
    direct pull loop when ``conf`` is None (pipeline disabled). ``conf`` is
    a ``pipeline_conf(ctx)`` result and ``metrics`` a ``pipe_metrics(node)``
    dict — both resolved once per execute(), not per partition."""
    if conf is None:
        led = getattr(ctx, "ledger", None)
        if led is not None:
            # no producer thread to bill 'dispatch' — time the direct
            # upstream pulls here so the ledger decomposition holds in
            # the pipeline-disabled (strictly serial) configuration
            it = led.timed_iter("dispatch", it)
        yield from fn(it)
        return
    pipe = PipelinedIterator(
        it,
        depth=conf["depth"],
        max_bytes=conf["max_bytes"],
        catalog=ctx.catalog,
        release=ctx.semaphore.release_if_necessary,
        metrics=metrics,
        cancel_token=getattr(ctx, "cancel_token", None),
    )
    try:
        yield from fn(pipe)
    finally:
        pipe.close()
