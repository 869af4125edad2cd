"""Straggler speculation — duplicate attempts for slow partitions.

The Spark ``spark.speculation`` model adapted to this engine's in-process
partition tasks: a monitor thread watches per-partition runtimes; once at
least ``speculation.quantile`` of a query's partitions have finished, any
partition still running past ``multiplier × median(completed runtimes)``
(floored at ``speculation.minRuntime``, and at the run calibration's
expected per-partition runtime when one exists) gets a speculative
duplicate attempt. Both attempts run the SAME pure partition thunk (the
lineage guarantee makes duplication safe); the first to finish commits,
and the loser is cancelled through an attempt-scoped
:class:`~..sched.cancel.LinkedCancelToken` with reason ``"speculation"`` —
the query-level token is never touched, so sibling partitions run on.

Permit accounting: a speculative attempt is opportunistic — it launches
only if :meth:`WeightedPermitPool.try_acquire` grants a permit without
queueing (it must never displace or delay real admissions), and the permit
is released when the attempt exits, win or lose.

Copied from ``spark_rapids_tpu/sched/speculation.py``. A duplicate attempt
runs on a plain thread: nothing compiles on it here, where the JAX package
gave it a big stack for XLA's compiles.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from ..obs import metrics as obs_metrics
from .cancel import CancelToken, LinkedCancelToken, QueryCancelledError

_M = obs_metrics.GLOBAL
_M_LAUNCHED = _M.counter("speculation.launched")
_M_WON = _M.counter("speculation.won")

#: the cancel reason a losing attempt's token carries — the attempt wrapper
#: swallows exactly this (any other reason is a real cancellation)
SPECULATION_REASON = "speculation"


class _Part:
    """Race state for one partition: primary + (maybe) speculative attempt."""

    __slots__ = ("index", "t_start", "running", "spec_launched",
                 "primary_token", "spec_token", "done", "result", "error",
                 "winner", "runner")

    def __init__(self, index: int):
        self.index = index
        self.t_start: Optional[float] = None
        self.running = False
        self.spec_launched = False
        self.primary_token: Optional[LinkedCancelToken] = None
        self.spec_token: Optional[LinkedCancelToken] = None
        self.done = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        self.winner = ""  # "primary" | "speculative" | "" (undecided)
        self.runner = None  # run_attempt callable (set by run_partition)


class SpeculationMonitor:
    """Per-query straggler watcher + attempt-race referee.

    One instance per ``_run_plan`` parallel execution; ``run_partition``
    is called on each worker thread, ``close()`` from the query's finally.
    """

    def __init__(self, ctx, token: CancelToken, pool=None,
                 pool_name: str = "default", quantile: float = 0.75,
                 multiplier: float = 1.5, min_runtime_s: float = 0.25,
                 interval_s: float = 0.05, n_partitions: int = 0,
                 baseline_s: float = 0.0):
        self._ctx = ctx
        self._token = token
        self._pool = pool
        self._pool_name = pool_name
        self._quantile = min(max(quantile, 0.0), 1.0)
        self._multiplier = max(multiplier, 1.0)
        self._min_runtime_s = max(min_runtime_s, 0.0)
        self._interval_s = max(interval_s, 0.01)
        self._baseline_s = max(baseline_s, 0.0)
        self._lock = threading.Lock()
        self._parts: Dict[int, _Part] = {}
        self._completed_s: list = []
        self._n_partitions = n_partitions
        self._stop = threading.Event()
        self._threads: list = []
        self._monitor = threading.Thread(
            target=self._watch, name="speculation-monitor", daemon=True
        )
        self._monitor.start()

    @classmethod
    def from_conf(cls, conf, ctx, token, pool=None, n_partitions: int = 0):
        from .. import config as cfg
        from . import estimate as est

        # calibration baseline: the run-history expectation for this plan
        # shape (sched/estimate.py records wall time per admission) spread
        # over the partition count — a floor for the straggler threshold
        # so a cold query with no completed partitions yet is still judged
        # against measured history rather than nothing
        baseline = 0.0
        try:
            avg = est.CALIBRATION.avg_run_s()
            if avg and n_partitions:
                baseline = avg / n_partitions
        except Exception:
            pass
        return cls(
            ctx,
            token,
            pool=pool,
            quantile=cfg.SPECULATION_QUANTILE.get(conf),
            multiplier=cfg.SPECULATION_MULTIPLIER.get(conf),
            min_runtime_s=cfg.SPECULATION_MIN_RUNTIME_S.get(conf),
            interval_s=cfg.SPECULATION_INTERVAL_S.get(conf),
            n_partitions=n_partitions,
            baseline_s=baseline,
        )

    # ── worker-thread side ──────────────────────────────────────────────
    def run_partition(self, index: int, run_attempt):
        """Run partition ``index`` with speculation cover.

        ``run_attempt(token)`` executes the partition's full task-retry
        loop under ``token`` (a LinkedCancelToken child of the query
        token). Returns the winning attempt's result; raises the primary's
        error when no attempt succeeded.
        """
        with self._lock:
            part = self._parts.setdefault(index, _Part(index))
            part.runner = run_attempt
            part.primary_token = LinkedCancelToken(self._token)
            part.t_start = time.monotonic()
            part.running = True
        try:
            # the token override routes the attempt token to every operator
            # that lazily reads ctx.cancel_token on this thread — losing
            # the race cancels THIS attempt's device loops, not the query
            with self._ctx.token_override(part.primary_token):
                result = self._attempt(part, run_attempt,
                                       part.primary_token, who="primary")
            if result is not None:
                return result
            # lost the race (or errored after the speculative attempt
            # committed): the winner's result is authoritative
            part.done.wait()
            if part.error is not None:
                raise part.error
            return part.result
        finally:
            with self._lock:
                part.running = False

    def _attempt(self, part: _Part, run_attempt, token, who: str):
        """Run one attempt; commit on success. Returns the result when this
        attempt won, None when it lost (winner's result is on ``part``);
        re-raises real failures."""
        try:
            result = run_attempt(token)
        except QueryCancelledError as e:
            if e.reason == SPECULATION_REASON or part.done.is_set():
                return None  # cancelled as the losing attempt
            self._fail(part, e, who)
            raise
        except BaseException as e:
            if part.done.is_set() and part.error is None:
                # the other attempt already committed: this failure is
                # moot (likely collateral of losing the device mid-race)
                return None
            self._fail(part, e, who)
            raise
        return self._commit(part, result, who)

    def _commit(self, part: _Part, result, who: str):
        with self._lock:
            if part.done.is_set():
                return None  # the other attempt beat us to the commit
            part.result = result
            part.winner = who
            part.done.set()
            loser = (part.spec_token if who == "primary"
                     else part.primary_token)
        if who == "speculative":
            _M_WON.add(1)
        if loser is not None:
            loser.cancel(SPECULATION_REASON)
        with self._lock:
            self._record_completion(part)
        return result

    def _fail(self, part: _Part, error: BaseException, who: str) -> None:
        with self._lock:
            if part.done.is_set():
                return
            part.error = error
            part.done.set()
            loser = (part.spec_token if who == "primary"
                     else part.primary_token)
        if loser is not None:
            loser.cancel(SPECULATION_REASON)

    def _record_completion(self, part: _Part) -> None:
        # lock held by caller
        if part.t_start is not None:
            self._completed_s.append(time.monotonic() - part.t_start)

    # ── monitor side ────────────────────────────────────────────────────
    def _threshold_s(self) -> Optional[float]:
        """The elapsed-runtime bar a running partition must pass to earn a
        duplicate attempt; None while too few partitions have finished."""
        done = sorted(self._completed_s)
        total = max(self._n_partitions, len(self._parts), 1)
        if not done or len(done) / total < self._quantile:
            return None
        median = done[len(done) // 2]
        return max(self._min_runtime_s,
                   self._multiplier * median,
                   self._multiplier * self._baseline_s)

    def _watch(self) -> None:
        while not self._stop.wait(self._interval_s):
            if self._token.cancelled:
                return
            with self._lock:
                bar = self._threshold_s()
                if bar is None:
                    continue
                now = time.monotonic()
                candidates = [
                    p for p in self._parts.values()
                    if p.running and not p.spec_launched
                    and not p.done.is_set()
                    and p.t_start is not None and now - p.t_start > bar
                ]
            for part in candidates:
                self._launch_speculative(part)

    def _launch_speculative(self, part: _Part) -> None:
        granted = 0
        if self._pool is not None:
            granted = self._pool.try_acquire(1, self._pool_name)
            if not granted:
                return  # no free capacity — stay opportunistic
        with self._lock:
            skip = (part.spec_launched or part.done.is_set()
                    or not part.running)
            if not skip:
                part.spec_launched = True
                part.spec_token = LinkedCancelToken(self._token)
        if skip:
            if granted and self._pool is not None:
                self._pool.release(granted, self._pool_name)
            return
        _M_LAUNCHED.add(1)

        def body():
            try:
                with self._ctx.token_override(part.spec_token):
                    self._attempt(part, part.runner, part.spec_token,
                                  who="speculative")
            except BaseException:
                pass  # a failed speculative attempt is simply a no-op
            finally:
                if granted and self._pool is not None:
                    self._pool.release(granted, self._pool_name)

        t = threading.Thread(
            target=body,
            name=f"speculative-attempt-p{part.index}",
            daemon=True,
        )
        t.start()
        self._threads.append(t)

    def close(self) -> None:
        """Stop the monitor and wait out in-flight speculative attempts
        (they hold pool permits — the query must not exit owing any)."""
        self._stop.set()
        self._monitor.join(timeout=5.0)
        for t in self._threads:
            t.join(timeout=30.0)
