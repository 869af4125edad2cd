"""CPU-fallback circuit breaker — the per-node fallback contract extended to
runtime failures.

The reference decides CPU-vs-GPU per node at PLAN time (tagging rules,
``willNotWorkOnGpu``); a kernel that compiles-and-plans fine but fails at
RUNTIME (a kernel fault on one input shape, a driver error) would
fail every retry of every query forever. The breaker closes that gap: the
retry layer records non-OOM device failures per op signature (the planner
rule name — ``ProjectExec``, ``HashAggregateExec`` …); at the threshold the
breaker opens and the NEXT planning pass marks that op CPU-fallback for the
rest of the session, with the reason in the explain output — exactly where
a plan-time fallback would have shown up.

OOM never trips the breaker (it has its own spill/split recovery), and
deterministic semantic errors (ANSI, assertions) never reach it — the
retry layer only records what ``is_device_error`` classifies.

Copied from ``spark_rapids_tpu/resilience/breaker.py``. In the port the
failures are CUDA errors raised by a device operator (an illegal address, a
launch failure, an assertion on the device) and the breaker's op names are
the port's planner rule names, which are the JAX package's."""
from __future__ import annotations

import logging
import threading
from typing import Optional

log = logging.getLogger(__name__)


class CircuitBreaker:
    """Per-session failure counts keyed by planner rule name."""

    def __init__(self, threshold: int = 3, enabled: bool = True):
        self.threshold = max(1, threshold)
        self.enabled = enabled
        self._lock = threading.Lock()
        self._failures: dict[str, int] = {}
        self._last_error: dict[str, str] = {}
        self._open: set[str] = set()
        # asynchronous device faults: (op where it surfaced, error)
        self._device_faults: list[tuple[str, str]] = []

    @classmethod
    def from_conf(cls, conf) -> "CircuitBreaker":
        from .. import config as cfg

        return cls(
            threshold=cfg.CIRCUIT_BREAKER_THRESHOLD.get(conf),
            enabled=cfg.CIRCUIT_BREAKER_ENABLED.get(conf),
        )

    def record_failure(self, op: str, err: BaseException) -> None:
        if not self.enabled:
            return
        from . import retry as R

        with self._lock:
            n = self._failures.get(op, 0) + 1
            self._failures[op] = n
            self._last_error[op] = f"{type(err).__name__}: {str(err)[:160]}"
            tripped = n >= self.threshold and op not in self._open
            if tripped:
                self._open.add(op)
        if tripped:
            R.record("circuit_breaker_trips")
            log.warning(
                "circuit breaker OPEN for %s after %d device-kernel failures; "
                "the op runs on CPU for the rest of the session (last: %s)",
                op, n, self._last_error.get(op),
            )

    def record_device_fault(self, surfaced_at: str, err: BaseException) -> None:
        """Record a sticky CUDA error without pinning it on an op: the
        kernel that faulted ran somewhere since the device's last completed
        sync, and ``surfaced_at`` is only the op that waited on it
        (resilience/retry.py). Opens nothing: after such an error the
        device context is unusable for every op alike."""
        if not self.enabled:
            return
        with self._lock:
            self._device_faults.append(
                (surfaced_at, f"{type(err).__name__}: {str(err)[:160]}")
            )
        log.error(
            "asynchronous device fault surfaced in %s (not attributed to it): %s",
            surfaced_at, err,
        )

    def force_open(self, op: str, err: BaseException) -> None:
        """Open the breaker for ``op`` in one step — the compile-deadline
        path: one blown compile budget already cost the tenant seconds,
        so the op flips to CPU immediately instead of after ``threshold``
        repeats of the same multi-second wait."""
        if not self.enabled:
            return
        from . import retry as R

        with self._lock:
            self._failures[op] = max(
                self._failures.get(op, 0) + 1, self.threshold
            )
            self._last_error[op] = f"{type(err).__name__}: {str(err)[:160]}"
            tripped = op not in self._open
            if tripped:
                self._open.add(op)
        if tripped:
            R.record("circuit_breaker_trips")
            log.warning(
                "circuit breaker FORCED OPEN for %s; the op runs on CPU for "
                "the rest of the session (%s)",
                op, self._last_error.get(op),
            )

    def is_open(self, op: str) -> bool:
        with self._lock:
            return op in self._open

    def check(self, op: str) -> Optional[str]:
        """Explain-output reason when open, else None — the planner appends
        this to the node's fallback reasons."""
        with self._lock:
            if op not in self._open:
                return None
            return (
                f"circuit breaker open: {self._failures.get(op, 0)} device-"
                f"kernel failures this session "
                f"(last: {self._last_error.get(op, 'unknown')})"
            )

    def state(self) -> dict:
        with self._lock:
            return {
                "open": sorted(self._open),
                "failures": dict(self._failures),
                "device_faults": list(self._device_faults),
            }

    def reset(self) -> None:
        with self._lock:
            self._failures.clear()
            self._last_error.clear()
            self._open.clear()
            self._device_faults.clear()
