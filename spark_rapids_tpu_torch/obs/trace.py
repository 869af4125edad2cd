"""Hierarchical query tracing — cheap spans, propagated context, Perfetto
export.

Design follows Dapper (Google's production tracing): spans are cheap
(one ring-buffer slot, no I/O on the hot path), sampled (per-query decision
made once at query start, ``spark.rapids.tpu.trace.sample``), and carry
explicit *span context* so work that executes on a different thread than
the one that requested it still attributes to the right parent: the
pipeline moves upstream operator pulls onto producer threads, and
``PipelinedIterator`` captures :func:`capture_context` on the consuming
thread and :func:`attach_context` on its producer thread before pulling
upstream.

Span hierarchy: **query → operator(partition) → batch**, plus the
scheduler's ``queued`` span. Export is Chrome-trace JSON (the
``traceEvents`` array of complete ``"ph": "X"`` events) — loadable in
Perfetto (ui.perfetto.dev) or ``chrome://tracing``.

When no tracer is active every hook in this module is a no-op returning a
shared singleton: zero allocation on the engine's hot loop.

Copied from ``spark_rapids_tpu/obs/trace.py``: the same span, context,
sampling, ring-buffer and export code, so both packages write the same
``traceEvents`` shape. The cross-process span context (``SpanContext``,
``record_span``, ``merge_chrome``) waits for the serve and shuffle slices
that carry it over the wire.
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time
import uuid
from typing import Iterator, List, Optional

from .metrics import GLOBAL as _GLOBAL_METRICS

_EPOCH_NS = time.perf_counter_ns()  # trace timestamps are relative; ts=0 at import

#: process-global span-id allocator: ids stay unique across concurrent
#: tracers
_SID_COUNTER = itertools.count(1)

#: ring-buffer overwrites across every tracer in the process — a truncated
#: trace must be detectable from the export alone (satellite: the old ring
#: silently overwrote on wrap)
_M_DROPPED = _GLOBAL_METRICS.counter("trace.droppedSpans")


class Span:
    __slots__ = ("sid", "name", "cat", "ts", "dur", "parent", "tid", "args")

    def __init__(self, sid, name, cat, ts, dur, parent, tid, args):
        self.sid = sid
        self.name = name
        self.cat = cat
        self.ts = ts  # ns since _EPOCH_NS
        self.dur = dur  # ns
        self.parent = parent  # parent span id (None = root)
        self.tid = tid
        self.args = args


class _OpenSpan:
    """Context manager for one in-flight span; records into the tracer's
    ring buffer on exit."""

    __slots__ = ("tracer", "sid", "name", "cat", "args", "t0", "_prev")

    def __init__(self, tracer: "Tracer", name: str, cat: str, args):
        self.tracer = tracer
        self.sid = None
        self.name = name
        self.cat = cat
        self.args = args

    def __enter__(self):
        t = self.tracer
        self.sid = t._next_sid()
        tls = t._tls
        self._prev = getattr(tls, "ctx", None)
        tls.ctx = self.sid
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t = self.tracer
        dur = time.perf_counter_ns() - self.t0
        parent = self._prev if self._prev is not None else t._thread_parent()
        if parent == self.sid:
            parent = None  # the root span itself: no self-parent cycle
        t._tls.ctx = self._prev
        t._record(
            Span(
                self.sid,
                self.name,
                self.cat,
                self.t0 - _EPOCH_NS,
                dur,
                parent,
                threading.get_ident(),
                self.args,
            )
        )
        return False


class _NoopSpan:
    __slots__ = ()
    sid = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP_SPAN = _NoopSpan()


class Tracer:
    """Lock-cheap span sink: a fixed-capacity ring buffer of completed
    spans. One tracer per traced query (sessions build one per sampled
    query and export it at query end)."""

    def __init__(self, capacity: int = 65536, trace_id: Optional[str] = None):
        self.capacity = max(16, int(capacity))
        self._ring: list = [None] * self.capacity
        self._n = 0  # total spans ever recorded (ring index = _n % capacity)
        self._lock = threading.Lock()
        self._tls = threading.local()
        #: fallback parent for threads with no attached context (partition
        #: pool threads): the query root span, set by query_scope
        self.root_sid: Optional[int] = None
        #: the trace's id, stamped on the root span and the export
        self.trace_id = trace_id or uuid.uuid4().hex[:16]

    # ── recording ───────────────────────────────────────────────────────
    def _next_sid(self) -> int:
        return next(_SID_COUNTER)

    def _record(self, span: Span) -> None:
        with self._lock:
            if self._n >= self.capacity:
                _M_DROPPED.add(1)  # overwriting the oldest slot
            self._ring[self._n % self.capacity] = span
            self._n += 1

    def _thread_parent(self) -> Optional[int]:
        return self.root_sid

    def span(self, name: str, cat: str = "op", args=None) -> _OpenSpan:
        return _OpenSpan(self, name, cat, args)

    # ── context propagation (the Dapper span-context seam) ──────────────
    def capture_context(self) -> Optional[int]:
        """The calling thread's current span id (None = at root)."""
        return getattr(self._tls, "ctx", None)

    def attach_context(self, ctx: Optional[int]) -> None:
        """Adopt ``ctx`` as the calling thread's current span — producer
        threads call this so their spans nest under the operator that
        spawned them, not under the query root."""
        self._tls.ctx = ctx

    # ── introspection / export ──────────────────────────────────────────
    @property
    def span_count(self) -> int:
        """Total spans recorded (including any overwritten in the ring)."""
        return self._n

    @property
    def dropped(self) -> int:
        return max(0, self._n - self.capacity)

    def spans(self) -> Iterator[Span]:
        with self._lock:
            live = (
                self._ring[: self._n]
                if self._n <= self.capacity
                else self._ring[self._n % self.capacity:]
                + self._ring[: self._n % self.capacity]
            )
        return iter([s for s in live if s is not None])

    def to_chrome(self, process_name: str = "spark_rapids_tpu_torch") -> dict:
        """Chrome-trace/Perfetto JSON object (``traceEvents`` complete
        events; ts/dur in microseconds per the spec)."""
        pid = os.getpid()
        events = [
            {
                "ph": "M",
                "name": "process_name",
                "pid": pid,
                "args": {"name": process_name},
            }
        ]
        for s in self.spans():
            args = dict(s.args or {}, span_id=s.sid, parent_id=s.parent)
            if s.parent is None:
                args["trace_id"] = self.trace_id
            ev = {
                "ph": "X",
                "name": s.name,
                "cat": s.cat,
                "ts": s.ts / 1e3,
                "dur": s.dur / 1e3,
                "pid": pid,
                "tid": s.tid,
                "args": args,
            }
            events.append(ev)
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "trace_id": self.trace_id,
                "dropped_spans": self.dropped,
            },
        }

    def export_chrome(self, path: str, process_name: str = "spark_rapids_tpu_torch") -> str:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_chrome(process_name), f)
        return path


# ── process-active tracer (None = tracing off, every hook no-ops) ──────────

_ACTIVE: Optional[Tracer] = None
_ACTIVE_LOCK = threading.Lock()


def active() -> Optional[Tracer]:
    return _ACTIVE


def activate(tracer: Optional[Tracer]) -> None:
    global _ACTIVE
    with _ACTIVE_LOCK:
        _ACTIVE = tracer


def deactivate(tracer: Tracer) -> None:
    """Clear the active tracer ONLY if it is still ``tracer`` — with the
    scheduler admitting concurrent queries, query A ending must not strip
    query B's freshly-activated tracer (module-level span hooks would go
    dark mid-query). Plan spans are unaffected either way: instrument_plan
    pins each query's tracer into its wrappers."""
    global _ACTIVE
    with _ACTIVE_LOCK:
        if _ACTIVE is tracer:
            _ACTIVE = None


def span(name: str, cat: str = "op", args=None):
    """Module-level hook for engine code: a real span when a tracer is
    active, a shared no-op singleton otherwise (zero allocation)."""
    t = _ACTIVE
    if t is None:
        return _NOOP_SPAN
    return t.span(name, cat, args)


def capture_context():
    """(tracer, ctx) pair for cross-thread propagation; None when off.
    Pinning the tracer in the capture keeps a producer thread consistent
    even if the active tracer changes mid-stream."""
    t = _ACTIVE
    if t is None:
        return None
    return (t, t.capture_context())


def attach_context(captured) -> None:
    if captured is None:
        return
    tracer, ctx = captured
    tracer.attach_context(ctx)


class query_scope:
    """Context manager for one traced query: activates ``tracer``, opens
    the root *query* span, and deactivates on exit. A ``None`` tracer makes
    the whole scope a no-op (the unsampled-query path)."""

    def __init__(self, tracer: Optional[Tracer], name: str, args=None):
        self.tracer = tracer
        self.name = name
        self.args = args
        self._span = None

    def __enter__(self):
        if self.tracer is not None:
            activate(self.tracer)
            self._span = self.tracer.span(self.name, "query", self.args)
            self._span.__enter__()
            self.tracer.root_sid = self._span.sid
        return self

    def __exit__(self, *exc):
        if self._span is not None:
            self._span.__exit__(*exc)
            deactivate(self.tracer)
        return False


def instrument_plan(plan, tracer: Optional[Tracer] = None) -> None:
    """Wrap every exec node's partition iterators in operator + batch spans
    (instance-level, like profiling.instrument_plan). Operator spans carry
    the partition index; each produced batch gets a nested *batch* span
    covering this operator's production time for it — including time spent
    on a pipeline producer thread, which attaches the consumer's context.

    ``tracer`` pins the sink: a producer thread that outlives its query
    (best-effort ``PipelinedIterator.close``) must keep recording into ITS
    query's tracer, never into whichever tracer is globally active by the
    time it finishes (those late spans land in an already-exported buffer
    and are simply dropped). Falls back to the active tracer when omitted."""
    from ..plan.physical import Exec, PartitionSet  # local: avoid cycle

    def walk(node):
        yield node
        for c in node.children:
            yield from walk(c)

    def _span(name, cat, args):
        t = tracer if tracer is not None else _ACTIVE
        if t is None:
            return _NOOP_SPAN
        return t.span(name, cat, args)

    def wrap(node):
        orig = node.execute
        name = type(node).__name__

        def execute(ctx, _orig=orig, _name=name):
            pset = _orig(ctx)

            def make(p, thunk):
                def it():
                    with _span(_name, "operator", {"partition": p}) as op:
                        t = op.tracer if isinstance(op, _OpenSpan) else None
                        captured = (
                            (t, t.capture_context()) if t is not None else None
                        )
                        src = thunk()
                        i = 0
                        while True:
                            attach_context(captured)
                            with _span("batch", "batch", {"op": _name, "batch": i}):
                                try:
                                    db = next(src)
                                except StopIteration:
                                    return
                            i += 1
                            yield db

                return it

            return PartitionSet(
                [make(p, t) for p, t in enumerate(pset.parts)]
            )

        node.execute = execute  # type: ignore[method-assign]
        node._span_instrumented = True  # type: ignore[attr-defined]

    for node in walk(plan):
        if not getattr(node, "_span_instrumented", False):
            wrap(node)
