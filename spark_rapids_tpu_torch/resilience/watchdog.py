"""Progress watchdog — hung-query detection and stall classification.

The resilience layer recovers failures that RAISE (OOM, kernel errors);
nothing recovered failures that simply STOP — a kernel build that never
ends, a device launch that never returns, a producer wedged in a pull.
Each of those holds scheduler permits forever.

The contract here is deliberately minimal and lock-light:

* **Beats.** Execution stamps a monotonic progress beat on its query's
  :class:`~spark_rapids_tpu_torch.sched.cancel.CancelToken` at every batch
  boundary — ``CancelToken.check()`` (called in ``exec/task.py``'s device
  loop, the pipeline producer, the H2D upload loop and the session's
  result loop) IS the beat, so the hot path gains one attribute write.
  Long legitimate waits (the nvcc build of a kernel at first use) stamp
  explicit beats at entry/exit via :func:`stall_phase`.

* **Phases.** ``stall_phase("compile"|"launch"|"fetch", detail=op)`` labels the
  potentially-blocking region the current thread is inside, on the
  thread-local current token (installed by the execution loops via
  :func:`set_current`). When a stall fires, the phase is the
  classification, and ``detail`` (the op signature) feeds the circuit
  breaker so a repeatedly-stalling op flips to the CPU engine at the next
  planning pass, exactly like a repeatedly-crashing one.

* **The thread.** One daemon scanner per :class:`QueryScheduler`, spawned
  lazily at the first admission that enables it (``watchdog.stallTimeout``
  or ``watchdog.evictStalePeriod`` non-zero) and self-terminating after a
  long idle streak — an engine used as a library never pays for it. A
  query with no beat for ``stallTimeout`` is cancelled with reason
  ``stall:<phase>``; the cancel unwinds through the normal error path when
  the stalled wait returns, releasing permits through the ordinary
  admission exit. The same thread runs the jittered
  ``shuffle/heartbeat.py::evict_stale`` sweep so dead executors are
  evicted even when nobody explicitly heartbeats.

Cancellation cannot interrupt a C call that never returns; the watchdog
bounds the DAMAGE of such a wedge (the cancel is flagged immediately, the
stall is counted and classified, the breaker learns).

Copied from ``spark_rapids_tpu/resilience/watchdog.py``, the periodic
stale-shuffle-peer sweep (``watchdog.evictStalePeriod``) included.
"""
from __future__ import annotations

import logging
import random
import threading
import time
from contextlib import contextmanager
from typing import Optional

from ..obs import metrics as obs_metrics

_M = obs_metrics.GLOBAL
log = logging.getLogger(__name__)


class WatchdogStallError(RuntimeError):
    """The error object handed to the circuit breaker when a stall is
    attributed to an op signature (the query itself gets the token's
    typed QueryCancelledError with reason ``stall:<phase>``)."""


class CompileDeadlineError(RuntimeError):
    """A first-touch compile exceeded its deadline. Force-opens the op's
    circuit breaker in the retry layer — the next planning pass runs the op
    on the CPU — and is never task-retried (retrying re-enters the same
    compile). Eager torch compiles nothing per shape, so nothing in the port
    raises it yet; the retry and task loops already classify it."""


# ── thread-local current token ──────────────────────────────────────────────
# Execution spans many threads; each installs the query token it is driving
# so blocking regions beneath it can label their phase without threading the
# token through every call signature.

_TLS = threading.local()


def set_current(token) -> None:
    _TLS.token = token


def current():
    return getattr(_TLS, "token", None)


@contextmanager
def stall_phase(phase: str, detail: str = "", token=None):
    """Label the dynamic extent of a potentially-blocking region on the
    current (or given) query token, stamping beats at entry and exit so
    the region's own duration — not the time since the previous batch —
    is what the stall clock measures. No-op without a token."""
    tok = token if token is not None else current()
    if tok is None:
        yield
        return
    prev_phase, prev_detail = tok.phase, tok.phase_detail
    tok.phase = phase
    if detail:
        tok.phase_detail = detail
    tok.beat()
    try:
        yield
    finally:
        tok.beat()
        tok.phase, tok.phase_detail = prev_phase, prev_detail


# ── the scanner thread ──────────────────────────────────────────────────────

#: idle scans (no active queries, no sweep configured) before the thread
#: exits; it respawns lazily at the next enabling admission
_IDLE_SCANS_BEFORE_EXIT = 40


class Watchdog:
    """One scanner per :class:`QueryScheduler`. ``configure`` is called at
    every admission with the CURRENT conf values (nothing session-frozen),
    and spawns/respawns the daemon thread only while something is enabled."""

    def __init__(self, scheduler):
        self._scheduler = scheduler
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._wake = threading.Event()
        self.stall_timeout_s = 0.0
        self.beat_interval_s = 0.0
        self.evict_period_s = 0.0
        self.evict_age_s = 0.0
        self._next_evict = 0.0
        self._rng = random.Random(0xD06)  # jitter only; determinism unneeded

    # ── configuration (per admission) ───────────────────────────────────
    def configure(self, conf) -> None:
        from .. import config as cfg

        if not cfg.WATCHDOG_ENABLED.get(conf):
            self.stall_timeout_s = 0.0
            self.evict_period_s = 0.0
            return
        self.stall_timeout_s = max(0.0, cfg.WATCHDOG_STALL_TIMEOUT_S.get(conf))
        beat = cfg.WATCHDOG_BEAT_INTERVAL_S.get(conf)
        if beat <= 0:
            beat = min(5.0, max(0.05, self.stall_timeout_s / 4.0))
        self.beat_interval_s = beat
        self.evict_period_s = max(
            0.0, cfg.WATCHDOG_EVICT_STALE_PERIOD_S.get(conf)
        )
        age = cfg.HEARTBEAT_MAX_AGE_S.get(conf)
        self.evict_age_s = age if age > 0 else self.evict_period_s * 3.0
        if self.stall_timeout_s > 0 or self.evict_period_s > 0:
            self._ensure_running()

    def _ensure_running(self) -> None:
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return
            self._wake.clear()
            self._thread = threading.Thread(
                target=self._run, name="srt-watchdog", daemon=True
            )
            self._thread.start()

    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def kick(self) -> None:
        """Wake the scanner early (tests; drain paths)."""
        self._wake.set()

    # ── scanning ────────────────────────────────────────────────────────
    def _run(self) -> None:
        idle = 0
        while True:
            interval = self.beat_interval_s or 0.25
            self._wake.wait(interval)
            self._wake.clear()
            busy = False
            try:
                busy |= self._scan_stalls()
                busy |= self._maybe_evict_stale()
            except Exception:  # noqa: BLE001 - the watchdog must not die
                log.warning("watchdog scan failed", exc_info=True)
            if busy or self.evict_period_s > 0:
                idle = 0
            else:
                idle += 1
                if idle >= _IDLE_SCANS_BEFORE_EXIT:
                    with self._lock:
                        self._thread = None
                    return

    def _scan_stalls(self) -> bool:
        """Cancel every running query with no beat for stallTimeout;
        returns whether any active queries existed."""
        timeout = self.stall_timeout_s
        active = self._scheduler.active_admissions()
        if not active or timeout <= 0:
            return bool(active)
        for adm in active:
            tok = adm.token
            # queued queries beat from the admission wait loop; only a
            # GRANTED (or gate-free) query can be device-stalled
            if not (adm._granted or not adm.enabled):
                continue
            if tok.cancelled:
                continue
            stalled = tok.stalled_s()
            if stalled <= timeout:
                continue
            phase = tok.phase or "launch"
            detail = tok.phase_detail
            reason = f"stall:{phase}"
            if tok.cancel(
                f"{reason} — no progress beat for {stalled:.1f}s "
                f"(> stallTimeout={timeout:g}s)"
                + (f" in {detail}" if detail else "")
            ):
                # first reason wins; keep the metrics reason slug the
                # compact classification, not the long message
                tok._reason = reason
                _M.counter("watchdog.stalls").add(1)
                _M.counter(
                    obs_metrics.dynamic_name("watchdog.stalls.site.", phase)
                ).add(1)
                log.warning(
                    "watchdog: query %s stalled %.1fs in phase %s%s — "
                    "cancelled (%s)",
                    tok.query_id, stalled, phase,
                    f" ({detail})" if detail else "", reason,
                )
                breaker = getattr(self._scheduler, "breaker", None)
                if breaker is not None and detail and phase in (
                    "launch", "compile"
                ):
                    breaker.record_failure(
                        detail,
                        WatchdogStallError(
                            f"stalled {stalled:.1f}s in {phase}"
                        ),
                    )
        return True

    def _maybe_evict_stale(self) -> bool:
        period = self.evict_period_s
        if period <= 0:
            return False
        now = time.monotonic()
        if now < self._next_evict:
            return False
        # ±20% jitter: many sessions' sweeps de-correlate instead of
        # hammering shared registries in lockstep
        self._next_evict = now + period * (0.8 + 0.4 * self._rng.random())
        from ..shuffle import heartbeat as hb

        evicted = hb.evict_stale_all(self.evict_age_s or period * 3.0)
        if evicted:
            log.warning("watchdog: evicted stale shuffle peers: %s", evicted)
        return False
