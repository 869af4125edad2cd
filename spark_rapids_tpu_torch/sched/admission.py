"""Weighted permit pool — device-memory admission control across
concurrent queries.

The multi-query generalization of ``mem/semaphore.py``'s DeviceSemaphore
(itself the GpuSemaphore analogue): instead of N interchangeable task slots
*within* one query, the pool holds ``permits`` capacity units for the whole
device and each QUERY takes a weighted share sized from its estimated peak
device working set (``sched/estimate.py``) — a scan-heavy join takes
several permits, an interactive point query takes one, and the two coexist
exactly when their estimates fit.

Fairness follows Spark's FAIR scheduler pools (stride scheduling over
per-pool virtual time): waiters are FIFO *within* a pool; across pools the
dispatcher always serves the pool with the smallest accumulated
``pass`` value, and admitting a query advances its pool's pass by
``permits / weight`` — so under saturation a weight-3 pool is admitted ~3×
as much permit-capacity as a weight-1 pool, while an idle pool's share
redistributes automatically.

Backpressure is explicit and typed: a bounded queue
(``spark.rapids.tpu.scheduler.maxQueued``) rejects with
:class:`QueryQueueFull` instead of building an unbounded convoy.

Resilience integration: while ``resilience/retry.py``'s OOM-pressure signal
holds (an OOM was spilled/split/retried recently anywhere in the process),
the *effective* permit limit halves — new admissions shrink until the
device has been healthy for the pressure window, the query-level twin of
the pipeline prefetcher's window clamp.

Copied from ``spark_rapids_tpu/sched/admission.py``. As there,
``scheduler.queueWaitHist`` observes only the admissions that queued. One
difference: the dispatcher clamps a waiter's share to the effective
limit, OOM pressure included, where the JAX package clamps it to the
configured permits only; there, while the pressure holds, a query needing
more than half the pool waits the 30 s pressure window out on an idle
device after each OOM, where the docstring above promises that admissions
shrink.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Dict, Optional

from ..obs import metrics as obs_metrics
from .cancel import CancelToken, QueryQueueFull

_M = obs_metrics.GLOBAL
_M_WAIT_NS = _M.timer("scheduler.queueWaitNs")
_M_WAIT_HIST = _M.histogram("scheduler.queueWaitHist")
_M_DEPTH = _M.gauge("scheduler.queueDepth")
_M_IN_USE = _M.gauge("scheduler.permitsInUse")
_M_LIMIT = _M.gauge("scheduler.effectivePermits")


class PoolSpec:
    """Static description of one fair-share pool (name + weight)."""

    __slots__ = ("name", "weight")

    def __init__(self, name: str, weight: float = 1.0):
        self.name = name
        self.weight = max(0.001, float(weight))

    def __repr__(self):
        return f"PoolSpec({self.name!r}, weight={self.weight})"


def parse_pool_spec(spec: Optional[str]) -> Dict[str, PoolSpec]:
    """``"etl:3,interactive:1"`` → pools by name. Malformed entries are
    skipped (a typo in one pool must not unconfigure the scheduler); an
    unknown pool referenced by a query is created on the fly at weight 1."""
    pools: Dict[str, PoolSpec] = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        name, _, w = part.partition(":")
        name = name.strip()
        if not name:
            continue
        try:
            weight = float(w) if w.strip() else 1.0
        except ValueError:
            continue
        pools[name] = PoolSpec(name, weight)
    return pools


class _Waiter:
    __slots__ = ("need", "pool", "event", "granted", "granted_need", "seq")

    def __init__(self, need: int, pool: str, seq: int):
        self.need = need
        self.pool = pool
        self.event = threading.Event()
        self.granted = False
        # what the dispatcher actually granted (may be re-clamped below
        # ``need`` when the permit conf shrank while this waiter queued)
        self.granted_need = need
        self.seq = seq


class WeightedPermitPool:
    """``permits`` capacity units; queries acquire a weighted share, FIFO
    within their pool, stride-scheduled across pools. ``configure`` is
    called per admission so a long-lived service can retune limits, queue
    bound, and pool weights live (nothing here is session-frozen)."""

    def __init__(self, permits: int = 8, max_queued: int = 32):
        self._lock = threading.Lock()
        self._permits = max(1, int(permits))  # graft: guarded_by(_lock)
        self._max_queued = max(0, int(max_queued))  # graft: guarded_by(_lock)
        self._pools: Dict[str, PoolSpec] = {}  # graft: guarded_by(_lock)
        self._queues: Dict[str, deque] = {}  # graft: guarded_by(_lock)
        self._pass: Dict[str, float] = {}  # graft: guarded_by(_lock)
        self._in_use = 0  # graft: guarded_by(_lock)
        self._queued = 0  # graft: guarded_by(_lock)
        self._seq = itertools.count()

    # ── configuration (re-read per query by the scheduler) ──────────────
    def configure(
        self,
        permits: Optional[int] = None,
        max_queued: Optional[int] = None,
        pools: Optional[Dict[str, PoolSpec]] = None,
    ) -> None:
        with self._lock:
            if permits is not None:
                self._permits = max(1, int(permits))
            if max_queued is not None:
                self._max_queued = max(0, int(max_queued))
            if pools is not None:
                # REPLACE semantics ('unlisted pools get weight 1', re-read
                # per query): a weight removed from the spec must actually
                # revert, not linger for the session's lifetime
                for name in self._pools:
                    if name not in pools:
                        self._pools[name] = PoolSpec(name)
                for p in pools.values():
                    self._pools[p.name] = p
            _M_LIMIT.set(self.effective_permits())
            self._dispatch()

    @property
    def permits(self) -> int:
        with self._lock:
            return self._permits

    @property
    def in_use(self) -> int:
        with self._lock:
            return self._in_use

    @property
    def queued(self) -> int:
        with self._lock:
            return self._queued

    def effective_permits(self) -> int:
        """The live admission limit: the configured permit count, halved
        (floor 1) while the process-wide OOM-pressure signal holds."""
        # graft: ok(guarded-by: called both under the pool lock (from
        # _dispatch) and bare (monitoring) — a single aligned int read;
        # admission decisions re-read it under the lock)
        limit = self._permits
        try:
            from ..resilience.retry import oom_pressure

            if oom_pressure():
                limit = max(1, limit // 2)
        except Exception:
            pass
        return limit

    def clamp(self, need: int) -> int:
        """Bound a requested share to [1, permits] so one huge query can
        always run alone rather than deadlocking the pool."""
        # graft: ok(guarded-by: pre-admission advisory clamp — _dispatch
        # re-clamps against the live value under the lock, so a racy
        # read here can never wedge the queue)
        return max(1, min(int(need), self._permits))

    # ── acquire / release ───────────────────────────────────────────────
    def acquire(self, need: int, pool: str = "default",
                token: Optional[CancelToken] = None) -> int:
        """Block until ``need`` permits are granted (FIFO within ``pool``,
        stride-fair across pools). Returns the granted permit count.
        Raises :class:`QueryQueueFull` when the wait queue is at capacity,
        or the token's typed error on cancellation/deadline while queued."""
        need = self.clamp(need)
        with self._lock:
            self._ensure_pool(pool)
            idle = self._queued == 0
            if idle and self._in_use + need <= self.effective_permits():
                self._grant_locked(need, pool)
                return need
            if self._queued >= self._max_queued:
                raise QueryQueueFull(
                    f"scheduler queue full ({self._queued} queued ≥ "
                    f"maxQueued={self._max_queued}); rejecting admission "
                    f"to pool {pool!r}"
                )
            w = _Waiter(need, pool, next(self._seq))
            if not self._queues[pool]:
                # returning from idle: lift this pool's pass to the floor
                # of pools with LIVE demand — an hour-old low pass must
                # earn fair share from now on, not a catch-up monopoly
                # (the same floor rule new pools get at creation)
                live = [
                    self._pass[p]
                    for p, q in self._queues.items()
                    if q and p != pool
                ]
                if live:
                    self._pass[pool] = max(self._pass[pool], min(live))
            self._queues[pool].append(w)
            self._queued += 1
            _M_DEPTH.set(self._queued)
            # the new waiter may be immediately dispatchable (capacity free
            # but the queue non-empty because another pool's head doesn't
            # fit): run the dispatcher rather than waiting for a release
            self._dispatch()
        t0 = time.perf_counter_ns()
        try:
            while not w.event.wait(0.05):
                if token is not None:
                    token.check()
                # OOM-pressure decay has no callback (it is a pure time
                # check) — with no acquire/release activity a recovered
                # limit would never re-dispatch; poke it from the wait loop
                with self._lock:
                    self._dispatch()
        except BaseException:
            with self._lock:
                if w.granted:
                    # granted between the raise and the lock: hand it back
                    self._release_locked(w.granted_need, pool)
                else:
                    try:
                        self._queues[pool].remove(w)
                        self._queued -= 1
                        _M_DEPTH.set(self._queued)
                    except ValueError:
                        pass
                self._dispatch()
            raise
        finally:
            wait_ns = time.perf_counter_ns() - t0
            _M_WAIT_NS.add(wait_ns)
            _M_WAIT_HIST.observe(wait_ns)
        return w.granted_need

    def try_acquire(self, need: int = 1, pool: str = "default") -> int:
        """Non-blocking acquire: grant ``need`` permits immediately if the
        pool is idle (no waiters to jump) and capacity allows, else return
        0 without queueing. Speculative task attempts use this — a
        duplicate attempt is opportunistic work that must never displace
        or delay a real admission."""
        need = self.clamp(need)
        with self._lock:
            self._ensure_pool(pool)
            if self._queued == 0 and self._in_use + need <= self.effective_permits():
                self._grant_locked(need, pool)
                return need
        return 0

    def release(self, granted: int, pool: str = "default") -> None:
        with self._lock:
            self._release_locked(granted, pool)
            self._dispatch()

    # ── internals (lock held) ───────────────────────────────────────────
    def _ensure_pool(self, name: str) -> None:
        if name not in self._pools:
            self._pools[name] = PoolSpec(name)
        if name not in self._queues:
            self._queues[name] = deque()
            # a new pool starts at the minimum live pass value: it gets its
            # fair share from now on, not a catch-up monopoly of the device
            floor = min(self._pass.values()) if self._pass else 0.0
            self._pass[name] = floor

    def _grant_locked(self, need: int, pool: str) -> None:
        self._ensure_pool(pool)
        self._in_use += need
        _M_IN_USE.set(self._in_use)
        _M_LIMIT.set(self.effective_permits())
        self._pass[pool] += need / self._pools[pool].weight
        # slug-capped dynamic family: pool names are conf-supplied text
        _M.counter(
            obs_metrics.dynamic_name("scheduler.pool.", pool, ".admitted")
        ).add(1)

    def _release_locked(self, granted: int, pool: str) -> None:
        self._in_use = max(0, self._in_use - granted)
        _M_IN_USE.set(self._in_use)
        # refresh the limit gauge on release too: OOM-pressure decay (or a
        # configure between grants) must not leave a stale export
        _M_LIMIT.set(self.effective_permits())

    def _dispatch(self) -> None:
        """Admit waiters while capacity allows: always the FIFO head of the
        pool with the smallest pass value. If that head does not fit, stop —
        skipping it for a smaller query behind it would starve big queries
        forever (head-of-line order is the anti-starvation guarantee)."""
        while True:
            ready = [p for p, q in self._queues.items() if q]
            if not ready:
                break
            pool = min(ready, key=lambda p: (self._pass[p], self._queues[p][0].seq))
            head = self._queues[pool][0]
            # re-clamp against the CURRENT effective limit: a live permits
            # reduction below an already-queued waiter's need must shrink
            # the grant, not wedge the queue forever — and so must the OOM
            # pressure's halving, or a query that needs more than half the
            # pool waits out the whole pressure window on an idle device
            limit = self.effective_permits()
            need = min(head.need, limit)
            if self._in_use + need > limit:
                break
            self._queues[pool].popleft()
            self._queued -= 1
            _M_DEPTH.set(self._queued)
            head.granted_need = need
            self._grant_locked(need, pool)
            head.granted = True
            head.event.set()
