"""Host-overhead ledger — per-query wall clock decomposed into exhaustive,
non-overlapping phases.

One :class:`PhaseLedger` per query accumulates exclusive nanoseconds per
phase:

    ``parse_plan``   — analysis + physical planning + overrides + fusion
                       (``session._prepare_plan``)
    ``queue_wait``   — scheduler admission wait (from ``Admission``)
    ``compile``      — the nvcc build of a hand-written kernel at its first
                       use (``kernels.build``); eager torch compiles nothing
                       per shape, so this is the only compile there is
    ``h2d``          — host→device upload (``columnar/device.py
                       host_to_device``, under ``HostToDeviceExec``)
    ``pad``          — padding batches out to their power-of-two capacity
                       and string width on the device (nested inside the
                       h2d scope, so the exclusive design carves it out
                       rather than double-counting)
    ``dispatch``     — upstream batch production: kernel launches + operator
                       host work (pipeline producer pulls / the direct pull
                       loop / ``run_device`` launches)
    ``device_execute`` — explicit blocking waits for device completion
                       (the stream sync before each D2H copy; device time
                       the host never waits for is invisible by
                       construction)
    ``d2h``          — device→host result transfer (``DeviceToHostExec``)
    ``serialize``    — result assembly into one host batch
    ``recovery``     — re-executed partition attempts (``resilience/
                       lineage.py::recovery_scope``)
    ``glue``         — the residual: wall − Σ(measured phases), i.e. python
                       orchestration nobody claimed

Phases are **exclusive by construction**: scopes nest on a per-thread
stack, and entering a child phase pauses the parent, so an h2d inside a
producer pull bills ``h2d``, not both. Scopes accrue from every thread
into the one ledger (partition pool workers, pipeline producers), which
keeps the sum ≈ wall in the serial configurations where a wall-clock
decomposition is meaningful; ``breakdown()`` reports ``parallel_overlap_ms``
when concurrent threads measured more than the wall (the decomposition is
then per-thread-exclusive work, not a wall partition).

Design follows Google-Wide Profiling (Ren et al., 2010): always-on, cheap
enough to leave enabled (two ``perf_counter_ns`` calls and a few list ops
per scope), with a thread-local *current ledger* so module-level code —
the kernel build, the upload — attributes into whatever query is driving
the thread without threading a ledger through every signature.

Copied from ``spark_rapids_tpu/obs/ledger.py``: the same phase names, the
same classes and hooks.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Optional

#: canonical phase order (ranked output keeps this set; unknown phases are
#: allowed but these are the documented decomposition)
PHASES = (
    "parse_plan",
    "queue_wait",
    "compile",
    "h2d",
    "pad",
    "dispatch",
    "device_execute",
    "d2h",
    "serialize",
    "glue",
    "recovery",
)


class _Scope:
    """One open phase scope (context manager). Entering pauses the
    enclosing scope on this thread; exiting accrues this phase's exclusive
    time and resumes the parent."""

    __slots__ = ("ledger", "phase")

    def __init__(self, ledger: "PhaseLedger", phase: str):
        self.ledger = ledger
        self.phase = phase

    def __enter__(self):
        led = self.ledger
        now = time.perf_counter_ns()
        stack = led._stack()
        if stack:
            parent = stack[-1]
            led._accrue(parent[0], now - parent[1])
        stack.append([self.phase, now])
        return self

    def __exit__(self, *exc):
        led = self.ledger
        now = time.perf_counter_ns()
        stack = led._stack()
        if stack and stack[-1][0] == self.phase:
            frame = stack.pop()
            led._accrue(frame[0], now - frame[1])
        if stack:
            stack[-1][1] = now  # parent resumes from here
        return False


class _NullScope:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SCOPE = _NullScope()


def scope_or_null(ledger: Optional["PhaseLedger"], phase: str):
    """``ledger.scope(phase)`` or the shared no-op when ``ledger`` is None
    — the one null-object dispatch every per-batch call site uses (resolve
    the ledger once per partition, pay nothing when it is off)."""
    return _NULL_SCOPE if ledger is None else _Scope(ledger, phase)


class PhaseLedger:
    """Per-query phase accumulator. Thread-safe: scopes run on many
    threads; each exit takes the ledger lock once."""

    __slots__ = ("_ns", "_lock", "_tls", "wall_ns", "_wall_t0")

    def __init__(self):
        self._ns: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._tls = threading.local()
        self.wall_ns = 0  # accumulated across wall windows (serve: prepare+fetch)
        self._wall_t0: Optional[int] = None

    # ── accrual ─────────────────────────────────────────────────────────
    def _stack(self) -> list:
        s = getattr(self._tls, "stack", None)
        if s is None:
            s = self._tls.stack = []
        return s

    def _accrue(self, phase: str, ns: int) -> None:
        if ns <= 0:
            return
        with self._lock:
            self._ns[phase] = self._ns.get(phase, 0) + ns

    def add(self, phase: str, ns: int) -> None:
        """Direct accrual for durations measured elsewhere (the admission
        queue wait arrives as a finished number, not a scope)."""
        self._accrue(phase, int(ns))

    def scope(self, phase: str) -> _Scope:
        return _Scope(self, phase)

    def timed_iter(self, phase: str, it):
        """Wrap an iterator so each ``next`` is billed to ``phase`` — the
        direct (non-pipelined) upstream pull loop's dispatch accounting."""
        it = iter(it)
        while True:
            with _Scope(self, phase):
                try:
                    item = next(it)
                except StopIteration:
                    return
            yield item

    # ── wall clock windows ──────────────────────────────────────────────
    def wall_start(self) -> None:
        if self._wall_t0 is None:
            self._wall_t0 = time.perf_counter_ns()

    def wall_stop(self) -> None:
        t0 = self._wall_t0
        if t0 is not None:
            self.wall_ns += time.perf_counter_ns() - t0
            self._wall_t0 = None

    class _WallWindow:
        __slots__ = ("led",)

        def __init__(self, led):
            self.led = led

        def __enter__(self):
            self.led.wall_start()
            return self.led

        def __exit__(self, *exc):
            self.led.wall_stop()
            return False

    def wall_window(self) -> "_WallWindow":
        """Context manager accumulating wall time while the query is
        actively driven (serve queries have a client-side gap between
        prepare and fetch that must not count as engine overhead)."""
        return PhaseLedger._WallWindow(self)

    # ── reporting ───────────────────────────────────────────────────────
    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._ns)

    def breakdown(self) -> dict:
        """The exported decomposition: per-phase ms ranked by cost, the
        wall, the residual ``glue``, and ``parallel_overlap_ms`` when
        concurrent threads measured more than the wall (sum then exceeds
        it by construction, not by error)."""
        ns = self.snapshot()
        wall = self.wall_ns
        if self._wall_t0 is not None:  # live view mid-query
            wall += time.perf_counter_ns() - self._wall_t0
        measured = sum(ns.values())
        glue = max(0, wall - measured)
        overlap = max(0, measured - wall)
        phases = dict(ns)
        if glue:
            phases["glue"] = glue
        ranked = dict(
            sorted(
                ((k, round(v / 1e6, 3)) for k, v in phases.items()),
                key=lambda kv: -kv[1],
            )
        )
        return {
            "wall_ms": round(wall / 1e6, 3),
            "phases_ms": ranked,
            "measured_ms": round(measured / 1e6, 3),
            "glue_ms": round(glue / 1e6, 3),
            "parallel_overlap_ms": round(overlap / 1e6, 3),
            "coverage_frac": round(min(measured, wall) / wall, 4) if wall else 0.0,
        }


# ── thread-local current ledger (the module-level attribution seam) ─────────

_TLS = threading.local()


def set_current(ledger: Optional[PhaseLedger]) -> None:
    """Install ``ledger`` as this thread's attribution target. Execution
    entry points call this wherever they install the watchdog token:
    partition thunk wrappers, pipeline producers, the session main
    thread."""
    _TLS.ledger = ledger


def current() -> Optional[PhaseLedger]:
    return getattr(_TLS, "ledger", None)


def phase(name: str):
    """Module-level scope hook: a real phase scope when the calling thread
    has a current ledger, a shared no-op otherwise (zero allocation on
    un-ledgered paths)."""
    led = getattr(_TLS, "ledger", None)
    if led is None:
        return _NULL_SCOPE
    return _Scope(led, name)


class ledger_scope:
    """Install ``ledger`` as current for a dynamic extent (restores the
    previous one — nested queries via subquery resolution keep their own
    attribution)."""

    __slots__ = ("ledger", "_prev")

    def __init__(self, ledger: Optional[PhaseLedger]):
        self.ledger = ledger

    def __enter__(self):
        self._prev = getattr(_TLS, "ledger", None)
        if self.ledger is not None:
            _TLS.ledger = self.ledger
        return self.ledger

    def __exit__(self, *exc):
        _TLS.ledger = self._prev
        return False
