"""Per-partition task context — the TaskContext / InputFileBlockHolder seam.

Reference: Spark's ``TaskContext.partitionId`` and ``InputFileBlockHolder``
(thread-locals set by the scheduler/scan), which the reference's
GpuSparkPartitionID / GpuMonotonicallyIncreasingID / GpuInputFileName read
(GpuSparkPartitionID.scala, GpuMonotonicallyIncreasingID.scala,
GpuInputFileBlock.scala). Here the engine runs partitions through
``PartitionSet`` thunks; each thunk installs a ``TaskInfo`` in a thread-local
for the duration of the partition's iteration.

Expressions cannot read the thread-local directly on the device path — they
run as device programs. Instead the task-dependent values are packaged as
``TaskVals`` (a few backend scalars) and passed as an input to the device
function; ``Ctx.task`` exposes them to expression ``eval``. The host-side
``TaskInfo`` is the source of truth the operators sample per batch.

Copied from ``spark_rapids_tpu/exec/task.py``. On the device ``TaskVals``
holds torch scalars; ``zero_vals`` is left out (nothing compiles per shape,
so a batch function that reads no task value gets ``None``). ``run_device``
drives the device project, filter and fused stage through the OOM retry
state machine, with the JAX package's ``dispatch`` ledger scope.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Optional

_LOCAL = threading.local()


class TaskInfo:
    """Mutable per-partition state (one per running partition iteration).

    ``attempt`` is the lineage re-execution counter (Spark's
    ``TaskContext.attemptNumber``): 0 on the first run, bumped by the
    session's task-retry loop for each recovery re-execution and by the
    speculation monitor for duplicate attempts.
    """

    def __init__(self, partition_id: int, attempt: int = 0):
        self.partition_id = partition_id
        self.attempt = attempt
        # running live-row count for monotonically_increasing_id
        self.row_base = 0

    def advance_rows(self, n: int) -> int:
        base = self.row_base
        self.row_base += int(n)
        return base


def current() -> Optional[TaskInfo]:
    return getattr(_LOCAL, "task", None)


def set_current(info: Optional[TaskInfo]) -> None:
    _LOCAL.task = info


def current_attempt() -> int:
    """The attempt number the session's retry/speculation layer set for
    this worker thread (0 outside any retry scope). Read by
    ``plan/physical._scoped_part`` when minting each layer's TaskInfo so
    every plan node of a re-executed partition observes the same attempt."""
    return getattr(_LOCAL, "attempt", 0)


def set_attempt(attempt: int) -> None:
    _LOCAL.attempt = int(attempt)


def in_task_pool() -> bool:
    """Whether this thread runs one partition task of a concurrent pool (a
    coalesce worker, a session pool worker, or a pipeline producer started
    from one). A nested coalesce then drives its own child partitions on
    this thread, serially: a second pool inside a task could hold every
    device-semaphore permit while its own workers wait for one."""
    return getattr(_LOCAL, "in_pool", False)


def set_in_task_pool(flag: bool) -> None:
    _LOCAL.in_pool = bool(flag)


def get_or_create(partition_id: int = 0) -> TaskInfo:
    t = current()
    if t is None:
        t = TaskInfo(partition_id)
        _LOCAL.task = t
    return t


def set_input_file(path: str, start: int = 0, length: int = -1) -> None:
    """Record the file (and block) currently being scanned. A thread-local
    *separate* from TaskInfo, exactly like Spark's InputFileBlockHolder —
    every pipeline stage of the partition sees the same value regardless of
    which nested TaskInfo is active. Scans read whole files here, so the
    block is (0, file size); -1 length means unknown."""
    if length < 0:
        try:
            import os

            length = os.path.getsize(path)
        except OSError:
            length = -1
    _LOCAL.input_file = path
    _LOCAL.input_block = (start, length)


def input_file() -> str:
    return getattr(_LOCAL, "input_file", "")


def input_file_block() -> tuple:
    """(start, length) of the current block; (-1, -1) outside a scan
    (Spark's InputFileBlockHolder defaults)."""
    return getattr(_LOCAL, "input_block", (-1, -1))


def reset_input_file() -> None:
    _LOCAL.input_file = ""
    _LOCAL.input_block = (-1, -1)


@dataclasses.dataclass
class TaskVals:
    """Task-dependent scalars passed into compiled kernels as traced inputs.

    ``file_bytes``/``file_len`` carry the current input file name as padded
    utf-8 so ``input_file_name()`` stays a pure device expression.
    """

    part_id: object  # int32 scalar
    row_base: object  # int64 scalar
    file_bytes: object  # uint8[w]
    file_len: object  # int32 scalar
    block_start: object = None  # int64 scalar (-1 outside a scan)
    block_length: object = None  # int64 scalar (-1 outside a scan)


def _encode_file(path: str, xp) -> tuple:
    from ..columnar.device import pad_scalar_bytes

    buf, n = pad_scalar_bytes(path.encode("utf-8"))
    return xp.asarray(buf), xp.asarray(n, dtype=xp.int32)


def task_vals(xp, row_base: Optional[int] = None) -> TaskVals:
    """Sample the thread-local TaskInfo into backend arrays (xp is numpy or
    the torch namespace)."""
    t = current()
    pid = t.partition_id if t else 0
    base = row_base if row_base is not None else (t.row_base if t else 0)
    fname = input_file()
    fb, fl = _encode_file(fname, xp)
    bs, bl = input_file_block()
    return TaskVals(
        xp.asarray(pid, dtype=xp.int32),
        xp.asarray(base, dtype=xp.int64),
        fb,
        fl,
        xp.asarray(bs, dtype=xp.int64),
        xp.asarray(bl, dtype=xp.int64),
    )


def run_device(fn, it, needs_task, catalog, policy, op=None, breaker=None,
               token=None):
    """Drive ``fn(batch, task_vals)`` over device batches (the JAX
    package's ``run_device``, shared by the device project and filter).
    Task values are sampled only where the expressions read them; the
    running row base of ``monotonically_increasing_id`` stays a device
    scalar, so no batch pays a sync for it.

    Each launch routes through the OOM retry state machine
    (resilience/retry.py): spill-retry, then split-in-half — project and
    filter are row-wise, so halves yield independently and one input batch
    may give several outputs. Task-dependent functions keep
    spill-retry only: a split would need the row base threaded per half.
    An ``AnsiError`` from the error channel is not an OOM and not a device
    error: it leaves the loop at the batch it belongs to, untried again,
    and never feeds the breaker.

    ``token`` (sched/cancel.py CancelToken) is checked before every batch:
    a cancelled query stops dispatching within one batch boundary and
    unwinds through the normal error path."""
    import torch

    from ..obs import ledger as _ledger
    from ..resilience import retry as R
    from ..xp import namespace

    if token is not None:
        # watchdog current-token install: blocking regions beneath this
        # loop label their stall phase on it; each check() is a beat
        from ..resilience import watchdog as _wd

        _wd.set_current(token)
    # host-overhead ledger: each launch bills its time to the 'dispatch'
    # phase (nested h2d/compile scopes subtract themselves out — exclusive
    # scopes). The ledger is resolved ONCE per partition; un-ledgered paths
    # keep a no-op scope.
    led = _ledger.current()
    if not needs_task:
        for db in it:
            if token is not None:
                token.check()
            # NOT scoped: run_with_retry yields split halves lazily (the
            # OOM contract — halves must not be held concurrently), so its
            # time lands in the caller's phase instead
            yield from R.run_with_retry(
                catalog, lambda b: fn(b, None), db, policy, op=op, breaker=breaker,
            )
        return
    base = None  # device-resident running row count (no per-batch sync)
    for db in it:
        if token is not None:
            token.check()
        tv = task_vals(namespace(db.device), row_base=base)
        with _ledger.scope_or_null(led, "dispatch"):
            out = R.run_once(
                catalog, lambda b: fn(b, tv), db, policy, op=op, breaker=breaker,
            )
        base = tv.row_base + db.num_rows.to(torch.int64)
        yield out
