"""Executor discovery via driver-mediated heartbeats, with liveness.

Reference: RapidsShuffleHeartbeatManager.scala:51,114 — executors register
with the driver plugin on startup; each heartbeat returns the peers that
appeared since the executor last asked, so every executor eventually knows
every peer's shuffle server address (BlockManagerId topology field →
here the transport address).

Liveness (resilience layer): every register/heartbeat stamps the executor's
last-heartbeat time; ``evict_stale(max_age_s)`` removes executors that went
quiet (dead-peer eviction — the reference relies on Spark's executor-loss
events, which this standalone engine does not have). Deltas are driven by a
monotonic registration VERSION, not a list index, so eviction compacts the
registry instead of growing ``_order`` without bound, and an evicted peer
never reappears in a later delta unless it actually re-registers.

Copied from ``spark_rapids_tpu/shuffle/heartbeat.py``; the port's watchdog
(``resilience/watchdog.py``) runs the same periodic sweep.
"""
from __future__ import annotations

import threading
import time
import weakref
from typing import Callable, Dict, List, Optional

# Live managers in this process (weak: a dropped manager must be
# collectable). The watchdog's periodic sweep (resilience/watchdog.py,
# spark.rapids.tpu.watchdog.evictStalePeriod) walks this so dead peers are
# evicted even when no executor explicitly heartbeats — before this,
# eviction only ever happened inside heartbeat()/evict_stale() calls.
_MANAGERS: "weakref.WeakSet[ShuffleHeartbeatManager]" = weakref.WeakSet()
_MANAGERS_LOCK = threading.Lock()


def evict_stale_all(max_age_s: float) -> List[str]:
    """Sweep every live ShuffleHeartbeatManager in the process; returns
    the evicted executor ids across all registries."""
    if max_age_s <= 0:
        return []
    with _MANAGERS_LOCK:
        managers = list(_MANAGERS)
    dead: List[str] = []
    for m in managers:
        try:
            dead.extend(m.evict_stale(max_age_s))
        except Exception:  # noqa: BLE001 - one bad registry never stops the sweep
            pass
    return dead


class ExecutorInfo:
    def __init__(self, executor_id: str, address: Optional[tuple]):
        self.executor_id = executor_id
        self.address = address  # transport dial address (None for in-process)

    def __repr__(self):
        return f"ExecutorInfo({self.executor_id}, {self.address})"


class ShuffleHeartbeatManager:
    """Driver-side registry (one per 'driver'). ``now_fn`` is injectable so
    staleness tests do not sleep."""

    def __init__(self, now_fn: Callable[[], float] = time.monotonic):
        self._lock = threading.Lock()
        self._now = now_fn
        self._version = 0  # monotonic registration counter
        self._entries: List[tuple] = []  # [(version, ExecutorInfo)]
        self._last_seen: Dict[str, int] = {}  # executor -> version high-water
        self._last_beat: Dict[str, float] = {}  # executor -> last heartbeat
        with _MANAGERS_LOCK:
            _MANAGERS.add(self)

    def register_executor(self, executor_id: str, address: Optional[tuple] = None) -> List[ExecutorInfo]:
        """First contact: returns ALL currently known peers
        (RapidsShuffleHeartbeatManager.registerExecutor). Re-registering a
        previously evicted (or restarted) executor mints a fresh version so
        peers re-learn it through their next delta."""
        with self._lock:
            existing = next(
                (
                    (v, e)
                    for v, e in self._entries
                    if e.executor_id == executor_id
                ),
                None,
            )
            if existing is not None and existing[1].address != address:
                # restarted executor on a new address: replace the entry
                # with a fresh version so peers re-learn it via their delta
                self._entries.remove(existing)
                existing = None
            if existing is None:
                self._version += 1
                self._entries.append(
                    (self._version, ExecutorInfo(executor_id, address))
                )
            self._last_beat[executor_id] = self._now()
            peers = [
                e for _v, e in self._entries if e.executor_id != executor_id
            ]
            self._last_seen[executor_id] = self._version
            return peers

    def executor_heartbeat(self, executor_id: str) -> List[ExecutorInfo]:
        """Returns peers registered since this executor last heard
        (.executorHeartbeat :114), and stamps its liveness."""
        with self._lock:
            self._last_beat[executor_id] = self._now()
            start = self._last_seen.get(executor_id, 0)
            self._last_seen[executor_id] = self._version
            return [
                e
                for v, e in self._entries
                if v > start and e.executor_id != executor_id
            ]

    def last_heartbeat(self, executor_id: str) -> Optional[float]:
        with self._lock:
            return self._last_beat.get(executor_id)

    def evict_stale(self, max_age_s: float) -> List[str]:
        """Remove executors whose last heartbeat is older than
        ``max_age_s``; returns the evicted ids. Evicted peers vanish from
        the registry, so they never show up in later registration snapshots
        or heartbeat deltas (their version entries are gone)."""
        now = self._now()
        with self._lock:
            dead = [
                eid
                for eid, t in self._last_beat.items()
                if now - t > max_age_s
            ]
            if not dead:
                return []
            dead_set = set(dead)
            self._entries = [
                (v, e) for v, e in self._entries
                if e.executor_id not in dead_set
            ]
            for eid in dead:
                self._last_beat.pop(eid, None)
                self._last_seen.pop(eid, None)
        if dead:
            from ..obs.metrics import GLOBAL as _obs
            from ..resilience import retry as R

            R.record("peers_evicted", len(dead))
            _obs.counter("shuffle.evictedStale").add(len(dead))
        return dead

    def evict(self, executor_id: str) -> bool:
        """Explicit eviction (a peer blacklisted after repeated fetch
        failures); returns whether it was present."""
        with self._lock:
            before = len(self._entries)
            self._entries = [
                (v, e) for v, e in self._entries
                if e.executor_id != executor_id
            ]
            self._last_beat.pop(executor_id, None)
            self._last_seen.pop(executor_id, None)
            return len(self._entries) < before

    def all_executors(self) -> List[ExecutorInfo]:
        with self._lock:
            return [e for _v, e in self._entries]


class HeartbeatEndpoint:
    """Executor-side: keeps a local peer table fresh
    (RapidsShuffleHeartbeatEndpoint in Plugin.scala:197)."""

    def __init__(self, executor_id: str, manager: ShuffleHeartbeatManager,
                 address=None, max_age_s: float = 0.0):
        self.executor_id = executor_id
        self._manager = manager
        #: spark.rapids.tpu.shuffle.heartbeatMaxAgeSeconds — when > 0 each
        #: heartbeat also sweeps the registry for dead peers
        self.max_age_s = max_age_s
        self._lock = threading.Lock()
        self.peers: Dict[str, ExecutorInfo] = {}
        for p in manager.register_executor(executor_id, address):
            self.peers[p.executor_id] = p

    def heartbeat(self):
        new = self._manager.executor_heartbeat(self.executor_id)
        if self.max_age_s > 0:
            # age-based dead-peer sweep AFTER stamping our own beat (or a
            # quiet-but-alive caller would evict itself) and BEFORE merging
            # the delta (a peer evicted in this very sweep must not be
            # re-added from it); remote facades (driver_service) have no
            # local eviction — the driver sweeps its own registry
            evict = getattr(self._manager, "evict_stale", None)
            if evict is not None:
                dead = set(evict(self.max_age_s))
                for d in dead:
                    self.drop_peer(d)
                new = [p for p in new if p.executor_id not in dead]
        with self._lock:
            for p in new:
                # assign, not setdefault: a re-registered executor's delta
                # entry carries its NEW address
                self.peers[p.executor_id] = p
        return new

    def peer(self, executor_id: str) -> Optional[ExecutorInfo]:
        with self._lock:
            return self.peers.get(executor_id)

    def drop_peer(self, executor_id: str) -> None:
        """Forget a dead/blacklisted peer locally (it re-enters the table
        only through a fresh registration delta)."""
        with self._lock:
            self.peers.pop(executor_id, None)
