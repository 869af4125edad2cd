"""Device admission control — the GpuSemaphore analogue.

Reference: GpuSemaphore.scala (:58-154): N concurrent tasks may hold the
device at once (``spark.rapids.sql.concurrentGpuTasks``), acquired before any
operator touches HBM and released when the task finishes. This bounds the
device-memory working set across concurrent tasks — the same role here, where
"task" is a partition computation.

Copied from ``spark_rapids_tpu/mem/semaphore.py``: the upload takes the
permit and the download releases it (``exec/gpu.py``).
"""
from __future__ import annotations

import threading
import time

from ..obs import metrics as obs_metrics

# admission-control telemetry: how often tasks take the device, and how
# long they block waiting for a permit (the reference's semaphoreWaitTime)
_M_ACQUIRES = obs_metrics.GLOBAL.counter("semaphore.acquires")
_M_WAIT_NS = obs_metrics.GLOBAL.timer("semaphore.waitNs")


class DeviceSemaphore:
    def __init__(self, permits: int):
        self._sem = threading.BoundedSemaphore(max(1, permits))
        self._held = threading.local()

    def acquire_if_necessary(self):
        """Idempotent per-thread acquire (GpuSemaphore.acquireIfNecessary)."""
        if getattr(self._held, "count", 0) == 0:
            # graft: ok(resource-lifecycle: task-duration hold — the
            # paired release lives in release_if_necessary, called by the
            # task driver at task end; reswatch asserts the balance)
            if not self._sem.acquire(blocking=False):
                # contended path only pays the timer (the common uncontended
                # acquire stays two branch instructions)
                t0 = time.perf_counter_ns()
                # graft: ok(resource-lifecycle: same task-duration hold —
                # blocking retry of the non-blocking acquire above)
                self._sem.acquire()
                _M_WAIT_NS.add(time.perf_counter_ns() - t0)
            self._held.count = 1
            _M_ACQUIRES.add(1)

    def release_if_necessary(self):
        if getattr(self._held, "count", 0) > 0:
            self._held.count = 0
            self._sem.release()

    class _Scope:
        def __init__(self, sem):
            self.sem = sem

        def __enter__(self):
            self.sem.acquire_if_necessary()
            return self

        def __exit__(self, *a):
            self.sem.release_if_necessary()

    def held(self) -> "_Scope":
        return DeviceSemaphore._Scope(self)
