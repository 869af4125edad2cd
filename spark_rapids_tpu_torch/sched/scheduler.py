"""QueryScheduler — the session's multi-tenant service layer.

One scheduler per :class:`TorchSession` gates every ``collect()`` /
``to_host()`` / ``to_torch()`` through admission control
(:class:`~spark_rapids_tpu_torch.sched.admission.WeightedPermitPool`),
tracks every in-flight query in a registry keyed by query id (the
``cancelJobGroup`` analogue: ``session.cancel(query_id)`` /
``session.cancel_all()``), and enforces per-query deadlines.

Every conf this module reads is re-read *per admission* — permit count,
queue bound, pool weights, pool assignment, timeout — so a long-lived
service can be retuned live without restarting.

Observability: admitted/rejected/cancelled/timeout counters, the
queue-wait timer and histogram, queue-depth and permits-in-use gauges all
live in the process registry (``obs/metrics.py``) so the Prometheus export
carries them; a ``queued`` span (category ``sched``) is recorded on the
query's tracer whenever admission had to wait, so Perfetto shows admission
stalls inside the query timeline.

Copied from ``spark_rapids_tpu/sched/scheduler.py``. The per-plan run
calibration keys on the plan's exchange-reuse canonical key
(``plan/reuse.py::canonical_key``), as in the JAX package.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from ..obs import metrics as obs_metrics
from .admission import WeightedPermitPool, parse_pool_spec
from .cancel import (
    CancelToken,
    QueryCancelledError,
    QueryOverloadedError,
    QueryQueueFull,
    QueryTimeoutError,
)

_M = obs_metrics.GLOBAL


def _count_cancelled(reason: str) -> None:
    """One Prometheus series per distinct cancel cause (user action vs
    client disconnect vs deadline vs watchdog stall) next to the
    aggregate counter. Cancel reasons carry free-ish text, so the family
    is slug-capped (metrics.maxDynamicSlugs → 'other' overflow)."""
    _M.counter("scheduler.cancelled").add(1)
    _M.counter(
        obs_metrics.dynamic_name("scheduler.cancelled.reason.", reason)
    ).add(1)


def _count_shed(reason: str) -> None:
    """Load-shedding rejections, per cause (queue_full rides the
    rejected counter; this family covers the deadline-aware sheds)."""
    _M.counter("scheduler.shed").add(1)
    _M.counter(
        obs_metrics.dynamic_name("scheduler.shed.reason.", reason)
    ).add(1)


class Admission:
    """One query's passage through the scheduler: a context manager that
    blocks in ``__enter__`` until admitted (or raises the typed rejection)
    and releases permits + unregisters in ``__exit__`` — on success, error,
    and cancellation alike."""

    def __init__(
        self,
        scheduler: "QueryScheduler",
        query_id: str,
        permits: int,
        pool: str,
        token: CancelToken,
        enabled: bool,
        tracer=None,
    ):
        self.scheduler = scheduler
        self.query_id = query_id
        self.permits = permits
        self.pool = pool
        self.token = token
        self.enabled = enabled
        self.tracer = tracer
        self.queue_wait_ns = 0
        self._granted = 0
        self.enqueued_at = None  # set when __enter__ starts queueing
        self.est_bytes = 0  # plan-footprint estimate (calibration input)
        self._granted_at = None  # monotonic stamp once permits are held

    def queue_wait_s(self) -> float:
        """Seconds this query has waited for admission SO FAR: the final
        wait once granted (or when admission is disabled — no permit gate,
        so nothing queues), the still-growing wait while queued (the live
        queue view ``session.active_queries()`` renders)."""
        if self._granted or not self.enabled or self.enqueued_at is None:
            return self.queue_wait_ns / 1e9
        return max(0.0, time.monotonic() - self.enqueued_at)

    def __enter__(self) -> "Admission":
        self.enqueued_at = time.monotonic()
        self.scheduler._register(self)
        try:
            self.token.check()  # cancelled/expired while still client-side
            if self.enabled:
                t0 = time.perf_counter_ns()
                span = (
                    self.tracer.span(
                        "queued",
                        "sched",
                        {"pool": self.pool, "permits": self.permits},
                    )
                    if self.tracer is not None
                    else None
                )
                try:
                    if span is not None:
                        span.__enter__()
                    self._granted = self.scheduler.pool.acquire(
                        self.permits, self.pool, self.token
                    )
                finally:
                    if span is not None:
                        span.__exit__(None, None, None)
                self.queue_wait_ns = time.perf_counter_ns() - t0
                # counted only when admission actually gated: a disabled
                # scheduler must not report admissions it never performed
                _M.counter("scheduler.admitted").add(1)
            self._granted_at = time.monotonic()
        except QueryTimeoutError:
            _M.counter("scheduler.timeouts").add(1)
            _count_cancelled("deadline")
            self.scheduler._unregister(self)
            raise
        except QueryCancelledError as e:
            _count_cancelled(getattr(e, "reason", "") or self.token.reason)
            self.scheduler._unregister(self)
            raise
        except QueryQueueFull as e:
            _M.counter("scheduler.rejected").add(1)
            # attach the drain-time hint so the serve layer's OVERLOADED
            # frame can tell the client when to come back
            e.retry_after_s = self.scheduler.retry_after_hint()
            self.scheduler._unregister(self)
            raise
        except BaseException:
            # anything else (KeyboardInterrupt while queued, tracer bugs)
            # is NOT backpressure — unregister without touching rejected
            self.scheduler._unregister(self)
            raise
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._granted:
            self.scheduler.pool.release(self._granted, self.pool)
            self._granted = 0
        self.scheduler._unregister(self)
        if exc_type is None and self._granted_at is not None:
            # successful completion feeds the shed calibration: measured
            # run time against the plan's byte estimate
            from .estimate import CALIBRATION

            CALIBRATION.record(
                self.est_bytes,
                time.monotonic() - self._granted_at,
                plan_key=getattr(self, "plan_key", None),
            )
        if exc_type is not None and issubclass(
            exc_type, QueryTimeoutError
        ):
            _M.counter("scheduler.timeouts").add(1)
            _count_cancelled("deadline")
        elif exc_type is not None and issubclass(
            exc_type, QueryCancelledError
        ):
            _count_cancelled(getattr(exc, "reason", "") or self.token.reason)
        return False


class QueryScheduler:
    """Session-scoped admission + cancellation authority."""

    def __init__(self):
        from ..resilience.watchdog import Watchdog

        self.pool = WeightedPermitPool()
        self._active: Dict[str, Admission] = {}  # graft: guarded_by(_lock)
        self._lock = threading.Lock()
        # bumped by cancel_all: preparation-phase waits that predate a
        # query's admission (no token yet — e.g. blocking on another
        # query's cache materialization) poll this so session shutdown
        # reaches them too
        self._cancel_epoch = 0
        #: session circuit breaker (set by TpuSession) — watchdog stalls
        #: attributed to an op signature feed it like kernel crashes do
        self.breaker = None
        #: progress watchdog — lazily spawns its scanner when a conf
        #: enables it at admission (resilience/watchdog.py)
        self.watchdog = Watchdog(self)

    @property
    def cancel_epoch(self) -> int:
        return self._cancel_epoch

    # ── admission ───────────────────────────────────────────────────────
    def admit(
        self, query_id: str, plan, conf, tracer=None, pool: Optional[str] = None
    ) -> Admission:
        """Build the admission for one query from the CURRENT conf (all
        scheduler keys are per-query, never frozen at session init).
        ``pool`` overrides the conf's fair-share pool — the serving
        front-end admits each tenant under ITS pool without mutating the
        shared session conf.

        Deadline-aware load shedding happens HERE, before anything
        queues: when ``scheduler.shedExpired`` holds and the query has a
        deadline, a calibrated estimate of queue wait + run time that
        already exceeds it raises the typed :class:`QueryOverloadedError`
        (with a retry-after hint) instead of admitting work that cannot
        finish."""
        from .. import config as cfg
        from .estimate import CALIBRATION, estimate_plan_bytes, permits_for_plan

        enabled = cfg.SCHEDULER_ENABLED.get(conf)
        permits = cfg.SCHEDULER_PERMITS.get(conf)
        self.pool.configure(
            permits=permits,
            max_queued=cfg.SCHEDULER_MAX_QUEUED.get(conf),
            pools=parse_pool_spec(cfg.SCHEDULER_POOLS.get(conf)),
        )
        self.watchdog.configure(conf)
        need = permits_for_plan(plan, conf, permits) if enabled else 1
        est_bytes = estimate_plan_bytes(plan, conf) if enabled else 0
        plan_key = None
        if enabled:
            # per-plan calibration bucket: a repeated query predicts from
            # its own run history (canonical structural identity — the
            # exchange-reuse key). Plans with incomparable parameters
            # simply stay on the global estimate.
            try:
                from ..plan.reuse import canonical_key

                plan_key = canonical_key(plan)
                hash(plan_key)
            except Exception:
                plan_key = None
        timeout = cfg.SCHEDULER_QUERY_TIMEOUT_S.get(conf)
        token = CancelToken(
            query_id, timeout_s=timeout if timeout > 0 else None
        )
        if (
            enabled
            and timeout > 0
            and cfg.SCHEDULER_SHED_EXPIRED.get(conf)
        ):
            est_run = CALIBRATION.estimate_run_s(est_bytes, plan_key)
            est_wait = self.estimated_queue_wait_s()
            # shed only under actual queue pressure: an uncontended query
            # with a tight deadline keeps its normal timeout semantics
            # (run estimates are rough; overload is what shedding is for)
            if est_wait > 0 and est_run > 0 and est_wait + est_run > timeout:
                hint = self.retry_after_hint()
                _count_shed("deadline_unmeetable")
                _M.counter("scheduler.rejected").add(1)
                raise QueryOverloadedError(
                    f"query {query_id} shed at admission: estimated queue "
                    f"wait {est_wait:.2f}s + estimated run {est_run:.2f}s "
                    f"exceeds its {timeout:g}s deadline "
                    f"(spark.rapids.tpu.scheduler.shedExpired); retry after "
                    f"~{hint:.1f}s",
                    retry_after_s=hint,
                    reason="deadline_unmeetable",
                )
        pool_name = pool or cfg.SCHEDULER_POOL.get(conf) or "default"
        adm = Admission(
            self, query_id, need, pool_name, token, enabled, tracer
        )
        adm.est_bytes = est_bytes
        adm.plan_key = plan_key
        return adm

    # ── overload hints ──────────────────────────────────────────────────
    def estimated_queue_wait_s(self) -> float:
        """Calibrated guess at how long a NEW admission would queue:
        queued queries ahead × average run time / effective parallelism
        (0.0 while uncalibrated or idle)."""
        from .estimate import CALIBRATION

        depth = self.pool.queued
        if depth <= 0:
            return 0.0
        avg = CALIBRATION.avg_run_s()
        if avg <= 0:
            return 0.0
        return depth * avg / max(1, self.pool.effective_permits())

    def retry_after_hint(self) -> float:
        """When an overloaded scheduler should have capacity again: the
        estimated drain time of the current queue plus one average run,
        floored so clients never hot-spin."""
        from .estimate import CALIBRATION

        avg = CALIBRATION.avg_run_s()
        return round(max(0.1, self.estimated_queue_wait_s() + avg), 3)

    # ── registry / cancellation ─────────────────────────────────────────
    def _register(self, adm: Admission) -> None:
        with self._lock:
            self._active[adm.query_id] = adm

    def _unregister(self, adm: Admission) -> None:
        with self._lock:
            cur = self._active.get(adm.query_id)
            if cur is adm:
                del self._active[adm.query_id]

    def active_admissions(self) -> List[Admission]:
        """Snapshot of every registered Admission object — the watchdog's
        scan surface (tokens carry the beats/phases it classifies on)."""
        with self._lock:
            return list(self._active.values())

    def active_queries(self) -> Dict[str, dict]:
        """query_id → live view of every registered query (queued or
        running): fair-share pool, requested/granted permit counts, whether
        it is running, and the queue wait so far — the ops/STATUS queue
        view a server renders."""
        with self._lock:
            return {
                qid: {
                    "pool": a.pool,
                    "permits": a.permits,
                    "granted": a._granted,
                    "running": a._granted > 0 or not a.enabled,
                    "queue_wait_s": round(a.queue_wait_s(), 6),
                }
                for qid, a in self._active.items()
            }

    def cancel(self, query_id: str, reason: str = "cancelled by user") -> bool:
        """Flag one query cancelled (queued or mid-execution); True when a
        matching active query existed — including one already flagged
        (double-cancel is idempotent, not a miss)."""
        with self._lock:
            adm = self._active.get(query_id)
        if adm is None:
            return False
        adm.token.cancel(reason)
        return True

    def cancel_all(self, reason: str = "cancel_all") -> int:
        """The ``cancelJobGroup`` analogue across the whole session:
        returns the number of queries flagged."""
        with self._lock:
            admissions = list(self._active.values())
            self._cancel_epoch += 1
        return sum(1 for a in admissions if a.token.cancel(reason))

    def state(self) -> dict:
        """One snapshot for bench/diagnostics: pool occupancy + the
        scheduler slice of the process metric registry."""
        with self._lock:
            n_active = len(self._active)
        out = {
            "permits": self.pool.permits,
            "effective_permits": self.pool.effective_permits(),
            "in_use": self.pool.in_use,
            "queued": self.pool.queued,
            "active": n_active,
            "watchdog_running": self.watchdog.running,
            "retry_after_hint_s": self.retry_after_hint(),
        }
        out.update(_M.view("scheduler.", strip=False))
        return out
