"""Measured per-op cost calibration — the bridge from metrics to the
cost-based optimizer.

The override layer's island-weight un-conversion can run on *measured*
costs instead of the hardcoded ``GpuOverrides._CBO_WEIGHTS`` guesses. This
module is that table: an EWMA per-op-signature record of measured
device-ns/row and host-ns/row, harvested from the executed plan's operator
metric registries at query exit (``opTime`` ÷ rows — for a device node
the ``profiling.instrument_plan`` wait-per-batch attribution over its
sources' rows, for a host node its own pull time over its sources' rows,
enabled while calibration runs) and persisted to a JSON file so a restarted session
starts calibrated.

Consumption (``plan/overrides.py``): with
``spark.rapids.tpu.cbo.measuredWeights`` on and the file present, island
weights derive from measured device ns/row normalized against the
cheapest measured op (the weight-1 unit the hardcoded table pins on
``GpuProjectExec``); otherwise behavior is bit-identical to the hardcoded
table. The routing pass (``spark.rapids.tpu.routing.enabled``) reads both
sides' ns/row (``ns_per_row``). The explain output names which table
decided and with what numbers, so an un-conversion is always auditable.

File schema (``spark.rapids.tpu.cbo.calibrationFile``)::

    {
      "version": 1,
      "ops": {
        "GpuProjectExec":  {"device_ns_per_row": 12.4, "rows": 183000,
                            "updates": 7},
        "CpuProjectExec":  {"host_ns_per_row": 55.1, "rows": 9000,
                            "updates": 2}
      }
    }

Writes are atomic (tmp + ``os.replace``) and best-effort: a read-only
filesystem degrades calibration to in-memory, never fails a query.

Copied from ``spark_rapids_tpu/obs/calibration.py``. The default file is
``build/cbo_calibration.json`` at the root of the checkout (the JAX
package keeps it under the user's cache directory).
"""
from __future__ import annotations

import json
import logging
import os
import threading
from typing import Dict, Optional

_log = logging.getLogger(__name__)

_SCHEMA_VERSION = 1

#: default on-disk location: beside the kernel builds, in the checkout
DEFAULT_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build",
    "cbo_calibration.json",
)


class CostCalibration:
    """EWMA per-op table of measured ns/row, device and host side."""

    def __init__(self, path: Optional[str] = None, alpha: float = 0.25):
        self.path = path or DEFAULT_PATH
        self.alpha = alpha
        self._ops: Dict[str, dict] = {}
        self._lock = threading.Lock()
        self._dirty = False
        self._load()

    # ── persistence ─────────────────────────────────────────────────────
    def _load(self) -> None:
        try:
            with open(self.path) as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError):
            return
        if not isinstance(doc, dict) or doc.get("version") != _SCHEMA_VERSION:
            return
        ops = doc.get("ops")
        if isinstance(ops, dict):
            self._ops = {
                str(k): dict(v) for k, v in ops.items() if isinstance(v, dict)
            }

    def save(self) -> bool:
        """Atomic write-back; True on success. No-op while clean."""
        with self._lock:
            if not self._dirty:
                return True
            doc = {"version": _SCHEMA_VERSION, "ops": self._ops}
            self._dirty = False
        tmp = f"{self.path}.tmp.{os.getpid()}"
        try:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            with open(tmp, "w") as f:
                json.dump(doc, f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)
            return True
        except OSError as e:
            _log.debug("calibration save failed (in-memory only): %s", e)
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return False

    # ── harvest ─────────────────────────────────────────────────────────
    def _update(self, op: str, field: str, ns_per_row: float, rows: int) -> None:
        with self._lock:
            e = self._ops.setdefault(op, {})
            prev = e.get(field)
            a = self.alpha if prev is not None else 1.0
            e[field] = round((prev or 0.0) + a * (ns_per_row - (prev or 0.0)), 4)
            e["rows"] = int(e.get("rows", 0)) + int(rows)
            e["updates"] = int(e.get("updates", 0)) + 1
            self._dirty = True

    def observe_plan(self, plan) -> int:
        """Harvest one executed plan's operator registries: every node with
        a populated ``opTime`` feeds its side's ns/row EWMA. Row counts
        come from the node's own row metrics when it publishes them, else
        from the nearest descendants that do (device compute nodes time
        themselves but only the transition execs count rows — a chain of
        row-streaming ops processes ~its sources' rows). Returns how many
        nodes contributed."""
        fed = 0
        for node in _walk(plan):
            ms = getattr(node, "metrics", None)
            if not ms:
                continue
            op_time = ms.get("opTime")
            if op_time is None or op_time.value <= 0:
                continue
            device = getattr(node, "is_device", False)
            rows = _rows_for(node) if device else _source_rows(node)
            if rows <= 0:
                continue
            field = "device_ns_per_row" if device else "host_ns_per_row"
            self._update(type(node).__name__, field, op_time.value / rows, rows)
            fed += 1
        return fed

    # ── consumption ─────────────────────────────────────────────────────
    def ns_per_row(self, op: str, device: bool = True) -> Optional[float]:
        """One op's measured ns/row on the device or the host side (None
        when that side was never measured) — what the routing pass reads."""
        with self._lock:
            e = self._ops.get(op)
        if e is None:
            return None
        return e.get("device_ns_per_row" if device else "host_ns_per_row")

    def device_weights(self) -> Dict[str, int]:
        """Measured device costs as integer island weights: each op's
        ns/row over the cheapest measured op's (the weight-1 unit),
        rounded and clamped to [0, 100]. Empty when nothing measured —
        callers fall back to the hardcoded table."""
        with self._lock:
            pairs = [
                (op, e["device_ns_per_row"])
                for op, e in self._ops.items()
                if e.get("device_ns_per_row", 0) > 0
            ]
        if not pairs:
            return {}
        unit = min(v for _op, v in pairs)
        if unit <= 0:
            return {}
        return {
            op: max(0, min(100, int(round(v / unit)))) for op, v in pairs
        }

    def snapshot(self) -> Dict[str, dict]:
        with self._lock:
            return {k: dict(v) for k, v in self._ops.items()}


def _walk(node):
    yield node
    for c in node.children:
        yield from _walk(c)


def _rows_for(node) -> int:
    """Rows attributable to ``node``: its own row metrics, else the sum of
    the nearest descendants that count rows (0 when nothing measured)."""
    ms = getattr(node, "metrics", None)
    if ms:
        rows_m = ms.get("numOutputRows") or ms.get("numInputRows")
        if rows_m is not None and rows_m.value > 0:
            return int(rows_m.value)
    return sum(_rows_for(c) for c in getattr(node, "children", ()))


def _source_rows(node) -> int:
    """Rows a host node's sources produced: the output rows
    (``opOutputRows``, counted by ``profiling.instrument_plan``) of the
    leaves beneath it — the row count a device node's ns/row is taken over
    too, and the one the routing pass multiplies by. The JAX package
    harvests no host ns/row: its host nodes count no rows."""
    kids = getattr(node, "children", ())
    if kids:
        return sum(_source_rows(c) for c in kids)
    ms = getattr(node, "metrics", None)
    m = ms.get("opOutputRows") if ms else None
    return int(m.value) if m is not None else 0


# ── process-wide instances (one per file path; sessions share) ──────────────

_INSTANCES: Dict[str, CostCalibration] = {}
_INSTANCES_LOCK = threading.Lock()


def get(path: Optional[str] = None) -> CostCalibration:
    key = os.path.abspath(path or DEFAULT_PATH)
    with _INSTANCES_LOCK:
        inst = _INSTANCES.get(key)
        if inst is None:
            inst = _INSTANCES[key] = CostCalibration(key)
        return inst


def invalidate(path: Optional[str] = None) -> None:
    """Drop the cached instance (tests rewrite calibration files)."""
    key = os.path.abspath(path or DEFAULT_PATH)
    with _INSTANCES_LOCK:
        _INSTANCES.pop(key, None)


def load_weights(path: Optional[str]) -> Dict[str, int]:
    """The overrides-layer entry point: measured island weights from the
    persisted file, ``{}`` when absent/empty (callers keep the hardcoded
    table)."""
    if path is not None and not os.path.exists(path):
        return {}
    return get(path).device_weights()
