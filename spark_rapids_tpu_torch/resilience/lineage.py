"""Task lineage — partition-granular recovery descriptors and attempt scopes.

The engine's analogue of Spark's lineage-based fault tolerance: every
partition thunk the session runs is described by a :class:`TaskDescriptor`
(plan label, partition id, attempt counter). Because partition thunks are
*pure* — they close over the plan subtree and re-derive their input from
sources — re-invoking the same thunk under a fresh attempt id recomputes
exactly that partition from lineage. Nothing here snapshots data; the thunk
IS the lineage.

The attempt id travels as a thread-local (``exec/task.py``): the session's
retry loop enters :func:`attempt_scope` before invoking the thunk, and
``plan/physical._scoped_part`` reads it when minting each layer's
``TaskInfo`` — so every operator of a re-executed partition observes the
same attempt number.

Copied from ``spark_rapids_tpu/resilience/lineage.py``: ``recovery_scope``
bills the re-executed wall time to the phase ledger's ``recovery`` phase
(``obs/ledger.py``) and counts the re-attempt on ``task.reattempts``;
``record_reattempt`` logs it and, when the query is traced, marks it with
a zero-length ``task.reattempt`` span.
"""
from __future__ import annotations

import contextlib
import logging

from ..obs import metrics as obs_metrics

_M = obs_metrics.GLOBAL
_M_REATTEMPTS = _M.counter("task.reattempts")
log = logging.getLogger(__name__)


class TaskDescriptor:
    """Lineage handle for one partition of one running query.

    ``attempt`` counts *re-executions* of the whole partition (not the
    batch-level OOM splits beneath it, which resilience/retry.py handles
    in-place). The descriptor is mutable — the session's retry loop bumps
    the attempt and re-invokes the same thunk.
    """

    __slots__ = ("plan_label", "partition_id", "attempt", "query_id")

    def __init__(self, partition_id: int, plan_label: str = "",
                 query_id: str = ""):
        self.partition_id = int(partition_id)
        self.plan_label = plan_label
        self.query_id = query_id
        self.attempt = 0

    def next_attempt(self) -> int:
        self.attempt += 1
        return self.attempt

    def __repr__(self):
        return (
            f"TaskDescriptor(part={self.partition_id}, "
            f"attempt={self.attempt}, plan={self.plan_label!r})"
        )


@contextlib.contextmanager
def attempt_scope(attempt: int):
    """Install ``attempt`` as this worker thread's attempt id for the
    duration of one partition execution (read back by
    ``plan/physical._scoped_part`` → ``TaskInfo.attempt``)."""
    from ..exec import task as _task

    prev = _task.current_attempt()
    _task.set_attempt(attempt)
    try:
        yield
    finally:
        _task.set_attempt(prev)


def record_reattempt(desc: TaskDescriptor, error: BaseException,
                     tracer=None) -> None:
    """Log one lineage re-execution and what killed the prior attempt; with
    a ``tracer``, a zero-length span (a Perfetto instant) marks WHERE the
    re-execution started."""
    log.warning(
        "task failed (partition %d, attempt %d), retrying from lineage: %s: %s",
        desc.partition_id, desc.attempt, type(error).__name__, error,
    )
    if tracer is not None:
        try:
            with tracer.span(
                "task.reattempt",
                cat="recovery",
                args={
                    "partition": desc.partition_id,
                    "attempt": desc.attempt,
                    "error": type(error).__name__,
                },
            ):
                pass
        except Exception:
            pass


@contextlib.contextmanager
def recovery_scope(ledger=None):
    """The dynamic extent of one re-executed partition: counts it on
    ``task.reattempts`` and bills its wall time to the ledger's
    ``recovery`` phase (``ledger``, else the thread's current ledger; a
    no-op scope when neither exists)."""
    from ..obs import ledger as _ledger

    _M_REATTEMPTS.add(1)
    led = ledger if ledger is not None else _ledger.current()
    with _ledger.scope_or_null(led, "recovery"):
        yield


def is_recoverable(error: BaseException) -> bool:
    """Partition-scoped (re-execute from lineage) vs query-scoped
    (propagate). Mirrors — and must stay in sync with — the session retry
    loop's never-retry set: assertion failures and ANSI violations are
    deterministic, scheduler errors mean the QUERY was cancelled/rejected,
    compile deadlines will not improve on a re-run, and a sticky CUDA error
    leaves the device context unusable for every later attempt."""
    from ..expr.base import AnsiError
    from ..sched.cancel import SchedulerError
    from .retry import is_sticky_device_error
    from .watchdog import CompileDeadlineError

    if isinstance(error, (AssertionError, AnsiError, SchedulerError,
                          CompileDeadlineError)):
        return False
    if is_sticky_device_error(error):
        return False
    return isinstance(error, Exception)
