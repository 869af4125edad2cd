"""Progress-watchdog seams: the stall and compile-deadline error types, the
thread-local current token and ``stall_phase``.

Copied in part from ``spark_rapids_tpu/resilience/watchdog.py``. Execution
stamps a progress beat on its query's cancel token at every batch boundary
(``CancelToken.check()`` is the beat) and labels potentially-blocking
regions with :func:`stall_phase`, on the thread-local token the run loops
install with :func:`set_current`. The ``Watchdog`` monitor thread that reads
those beats, cancels a stalled query and sweeps stale shuffle peers reads
the scheduler and the shuffle heartbeat, so it comes with those slices
(ROADMAP Queue A).
"""
from __future__ import annotations

import threading
from contextlib import contextmanager


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
