"""Cancellation tokens and the scheduler's typed error family.

The ``cancelJobGroup`` analogue: a :class:`CancelToken` is minted per query
by the scheduler and threaded into execution (``ExecContext.cancel_token``).
Operators check it at *batch boundaries* — ``exec/task.py``'s device loop,
the pipeline producer thread, the H2D/D2H pull loops, and the session's
result loop — so a cancelled query stops within one batch and unwinds
through normal exception propagation, releasing its device permits,
semaphore holds, and spill registrations on the way out.

Deadlines ride the same token: ``spark.rapids.tpu.scheduler.queryTimeout``
becomes an absolute ``time.monotonic`` deadline at admission; ``check()``
raises the *typed* :class:`QueryTimeoutError` once it passes, whether the
query is still queued or already running.

Copied from ``spark_rapids_tpu/sched/cancel.py``. Admission
(``sched/scheduler.py``) mints each query's token.
"""
from __future__ import annotations

import threading
import time
from typing import Optional


class SchedulerError(RuntimeError):
    """Base of the scheduler's typed error family — never retried by the
    task-retry machinery (retrying a cancelled/rejected query can only
    waste the device)."""


class QueryCancelledError(SchedulerError):
    """The query was cancelled (``session.cancel`` / ``cancel_all``).
    ``reason`` carries the cancel call's reason string verbatim, so a
    server distinguishes client-disconnect from deadline from operator
    action without parsing the message."""

    def __init__(self, message: str, reason: str = ""):
        super().__init__(message)
        self.reason = reason


class QueryTimeoutError(QueryCancelledError):
    """The query's deadline (``spark.rapids.tpu.scheduler.queryTimeout``)
    expired — in the admission queue or mid-execution."""


class QueryQueueFull(SchedulerError):
    """Admission rejected: the scheduler queue is at
    ``spark.rapids.tpu.scheduler.maxQueued`` — the backpressure signal a
    service in front of this engine sheds load on. ``retry_after_s`` is
    the scheduler's drain-time hint (0.0 when unknown); the serve layer
    forwards it on the typed OVERLOADED error frame."""

    def __init__(self, message: str, retry_after_s: float = 0.0):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class QueryOverloadedError(SchedulerError):
    """Deadline-aware load shedding (``scheduler.shedExpired``): the
    query's estimated queue wait plus estimated run time already exceeds
    its deadline, so admission rejects it instead of wasting device time
    on work that cannot finish. ``retry_after_s`` hints when capacity
    should exist again."""

    def __init__(self, message: str, retry_after_s: float = 0.0,
                 reason: str = "overloaded"):
        super().__init__(message)
        self.retry_after_s = retry_after_s
        self.reason = reason


class CancelToken:
    """Thread-safe per-query cancellation flag + optional deadline.

    ``check()`` is the hot-path call (one attribute read when healthy, plus
    a clock read only when a deadline exists); ``cancel()`` may be called
    from any thread, any number of times — first reason wins.
    """

    __slots__ = ("query_id", "deadline", "_cancelled", "_reason", "_lock",
                 "last_beat", "phase", "phase_detail")

    def __init__(self, query_id: str = "", timeout_s: Optional[float] = None):
        self.query_id = query_id
        self.deadline = (
            time.monotonic() + timeout_s
            if timeout_s is not None and timeout_s > 0
            else None
        )
        self._cancelled = False
        self._reason = ""
        self._lock = threading.Lock()
        # progress-watchdog state (resilience/watchdog.py): every check()
        # and beat() stamps last_beat; phase names the potentially-blocking
        # region execution is currently inside ("launch" by default,
        # "compile" / "fetch" / "client" around those waits) so a stall is
        # classified by WHERE progress stopped. Plain attribute writes —
        # racy phase labels only ever blur classification, never safety.
        self.last_beat = time.monotonic()
        self.phase = "launch"
        self.phase_detail = ""

    def cancel(self, reason: str = "cancelled") -> bool:
        """Flag the query cancelled; True if this call flipped the flag."""
        with self._lock:
            if self._cancelled:
                return False
            self._cancelled = True
            self._reason = reason
            return True

    @property
    def cancelled(self) -> bool:
        return self._cancelled or self.expired

    @property
    def expired(self) -> bool:
        return self.deadline is not None and time.monotonic() > self.deadline

    @property
    def reason(self) -> str:
        return self._reason

    def remaining_s(self) -> Optional[float]:
        """Seconds until the deadline (None = no deadline; 0.0 = expired)."""
        if self.deadline is None:
            return None
        return max(0.0, self.deadline - time.monotonic())

    def beat(self) -> None:
        """Stamp a progress beat (batch boundary, compile start/end,
        fetch completion) without the cancellation check."""
        self.last_beat = time.monotonic()

    def stalled_s(self) -> float:
        """Seconds since the last progress beat."""
        return max(0.0, time.monotonic() - self.last_beat)

    def check(self) -> None:
        """Raise the typed error if cancelled or past deadline; the one
        call engine loops make at each batch boundary. Reaching a check
        IS progress, so it stamps the watchdog beat."""
        self.last_beat = time.monotonic()
        if self._cancelled:
            raise QueryCancelledError(
                f"query {self.query_id or '<anonymous>'} cancelled"
                + (f": {self._reason}" if self._reason else ""),
                reason=self._reason,
            )
        if self.expired:
            raise QueryTimeoutError(
                f"query {self.query_id or '<anonymous>'} exceeded its "
                "deadline (spark.rapids.tpu.scheduler.queryTimeout)",
                reason="deadline",
            )


class LinkedCancelToken(CancelToken):
    """A child token chained to a parent: cancelling either stops the work.

    Minted per task *attempt* by the recovery/speculation layer so one
    attempt of a partition can be cancelled (speculation lost the race,
    original overtaken) without touching the query's own token — while a
    query-level cancel or deadline still reaches every attempt through the
    parent. ``check()`` delegates to the parent first, which also stamps
    the parent's watchdog beat: a query running only speculative attempts
    keeps beating and is never misclassified as stalled.
    """

    __slots__ = ("parent",)

    def __init__(self, parent: CancelToken, query_id: str = ""):
        super().__init__(query_id or parent.query_id, timeout_s=None)
        self.parent = parent
        # Inherit the absolute deadline so expiry raises even when an
        # attempt loop only checks the child.
        self.deadline = parent.deadline

    @property
    def cancelled(self) -> bool:
        return self._cancelled or self.expired or self.parent.cancelled

    def check(self) -> None:
        self.parent.check()
        super().check()
