"""Peak device working-set estimation from a physical plan.

Admission control needs a *pre-execution* footprint guess, the same problem
Spark's CBO statistics solve for join planning. The model here is
deliberately coarse but monotone in the inputs that matter:

    footprint ≈ Σ_leaf  est_rows(leaf) × widest_row_width(plan)
              + Σ_join  build_side_bytes        (resident during the probe)
              + Σ_agg   input_bytes_bound       (hash-table residency)

- ``est_rows(leaf)``: an in-memory scan reports its ``HostBatch``'s row
  count, rounded up to the power-of-two capacity the upload pads it to
  (``columnar/device.py::bucket_capacity``), and its host bytes.
- ``widest_row_width``: the per-row device width (data + validity planes)
  of the WIDEST operator output in the plan — a projection that explodes
  ten columns out of a two-column scan costs ten columns of device memory,
  not two. Strings count at the port's device layout: a ``uint8[n, W]``
  plane plus int32 lengths, with ``W`` the widest padded string width
  among the plan's scanned string columns (64 when it scans none).
- build sides: a hash join's build side is WHOLLY resident while the probe
  streams; a hash aggregate holds a table bounded by its input.

A query with no measurable inputs falls back to
``spark.rapids.tpu.scheduler.defaultQueryBytes``. The result feeds
``WeightedPermitPool`` via ``ceil(bytes / bytesPerPermit)``, clamped to the
pool size — over-estimation degrades to serial execution, never deadlock.

Copied from ``spark_rapids_tpu/sched/estimate.py`` with the port's leaves
(in-memory scans, and file scans at their bytes on disk times the format's
expansion, as there) and widths;
its plan-cost estimate waits for the subplan sharing it serves (the
caches slice).
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np

from ..types import Schema, StringType

#: nominal padded width of a string column whose data the plan cannot see
DEFAULT_STRING_BYTES = 64


def row_width_bytes(schema: Schema, string_bytes: int = DEFAULT_STRING_BYTES) -> int:
    """Per-row device footprint of one operator output: dtype widths plus a
    validity byte per column; strings at their padded-plane width."""
    total = 0
    for f in schema:
        dt = f.data_type
        if isinstance(dt, StringType):
            total += string_bytes + 4  # byte plane + int32 lengths
        else:
            try:
                total += dt.np_dtype.itemsize
            except Exception:
                total += 16
        total += 1  # validity plane
    return max(total, 1)


def _walk(node):
    yield node
    for c in node.children:
        yield from _walk(c)


#: decoded bytes per byte on disk, by file format (the JAX package's)
_FORMAT_EXPANSION = {"parquet": 3.0, "csv": 1.5}


def _leaf_bytes_rows(node) -> Optional[tuple]:
    """(host bytes, padded rows) for a source leaf; None for non-sources."""
    from ..columnar.device import bucket_capacity

    name = type(node).__name__
    if name == "CpuScanExec":
        t = getattr(node, "table", None)
        if t is not None:
            return max(int(t.nbytes), 1), bucket_capacity(max(int(t.num_rows), 1))
    if name == "CpuFileScanExec":
        import os

        disk = 0
        for f in node.files:
            try:
                disk += os.path.getsize(f)
            except OSError:
                pass
        if disk:
            decoded = int(disk * _FORMAT_EXPANSION.get(node.fmt, 2.0))
            rows = max(1, decoded // row_width_bytes(node.output))
            return decoded, bucket_capacity(rows)
    return None


def _string_width(col) -> int:
    """The padded device width of one host string column (cached on the
    column: the estimate runs at every admission)."""
    w = getattr(col, "_est_width", None)
    if w is None:
        from ..columnar.device import bucket_width

        offs = col.offsets
        longest = int(np.diff(offs).max()) if offs is not None and len(offs) > 1 else 0
        w = bucket_width(max(longest, 1))
        try:
            col._est_width = w
        except AttributeError:
            pass
    return w


def plan_string_bytes(plan) -> int:
    """The widest padded string plane among the plan's scanned string
    columns (``DEFAULT_STRING_BYTES`` when it scans none)."""
    widest = 0
    for node in _walk(plan):
        if type(node).__name__ != "CpuScanExec":
            continue
        t = node.table
        for f, c in zip(t.schema, t.columns):
            if isinstance(f.data_type, StringType):
                widest = max(widest, _string_width(c))
    return widest or DEFAULT_STRING_BYTES


def estimate_plan_bytes(plan, conf=None) -> int:
    """Estimated peak device working set of one physical plan, in bytes.
    Returns 0 when nothing was measurable (caller applies the conf
    default)."""
    leaves = []
    widest = 1
    build_bytes = 0
    agg_bytes = 0
    sbytes = plan_string_bytes(plan)
    for node in _walk(plan):
        try:
            widest = max(widest, row_width_bytes(node.output, sbytes))
        except Exception:
            pass
        lb = _leaf_bytes_rows(node)
        if lb is not None:
            leaves.append(lb)
        name = type(node).__name__
        if "Join" in name and len(node.children) == 2:
            # build side resident during the probe: charge the smaller
            # subtree's source bytes again (it lives concurrently with the
            # probe stream)
            side_bytes = []
            for child in node.children:
                sb = sum(
                    b for c in _walk(child)
                    for (b, _r) in [_leaf_bytes_rows(c) or (0, 0)]
                )
                side_bytes.append(sb)
            build_bytes += min(side_bytes)
        elif "HashAggregate" in name:
            inp = sum(
                b for c in _walk(node)
                for (b, _r) in [_leaf_bytes_rows(c) or (0, 0)]
            )
            # hash-table residency bounded by the (deduplicated) input
            agg_bytes = max(agg_bytes, inp)
    stream = sum(rows * widest for (_b, rows) in leaves)
    total = stream + build_bytes + agg_bytes
    return int(total)


def permits_for_plan(plan, conf, pool_size: int) -> int:
    """ceil(estimate / bytesPerPermit) in [1, pool_size] — the weighted
    share one query takes from the WeightedPermitPool."""
    from .. import config as cfg

    est = estimate_plan_bytes(plan, conf)
    if est <= 0:
        est = cfg.SCHEDULER_DEFAULT_QUERY_BYTES.get(conf)
    per = max(1, cfg.SCHEDULER_BYTES_PER_PERMIT.get(conf))
    return max(1, min(pool_size, math.ceil(est / per)))


# ── run-time calibration (deadline-aware load shedding) ─────────────────────
# The byte estimate above answers "does it fit"; shedding needs "how LONG
# will it take". Completed queries feed an EWMA of measured run time and
# processing rate, so admission can refuse a query whose estimated queue
# wait + run already blows its deadline — with a retry-after hint derived
# from the same numbers. Process-wide on purpose: every session shares the
# one device, so one calibration describes it.


class RunCalibration:
    """EWMA of completed-query (run seconds, bytes/second), plus per-plan
    EWMA buckets keyed by a plan's structural identity: a repeated query's
    prediction comes from ITS OWN history, not the global average. Unseen
    plans fall back to the global EWMA. Buckets are LRU-bounded."""

    _MAX_PLANS = 256

    def __init__(self, alpha: float = 0.2):
        import threading
        from collections import OrderedDict

        self._lock = threading.Lock()
        self._alpha = alpha
        self._avg_run_s = 0.0
        self._bytes_per_s = 0.0
        self._samples = 0
        self._plans: "OrderedDict" = OrderedDict()  # key -> [run_s, samples]

    def record(self, est_bytes: int, run_s: float, plan_key=None) -> None:
        if run_s <= 0:
            return
        with self._lock:
            a = self._alpha if self._samples else 1.0
            self._avg_run_s += a * (run_s - self._avg_run_s)
            if est_bytes > 0:
                rate = est_bytes / run_s
                self._bytes_per_s += a * (rate - self._bytes_per_s)
            self._samples += 1
            if plan_key is not None:
                e = self._plans.pop(plan_key, None)
                if e is None:
                    e = [run_s, 1]
                else:
                    e[0] += self._alpha * (run_s - e[0])
                    e[1] += 1
                self._plans[plan_key] = e  # (re)insert at MRU end
                while len(self._plans) > self._MAX_PLANS:
                    self._plans.popitem(last=False)

    def plan_samples(self, plan_key) -> int:
        with self._lock:
            e = self._plans.get(plan_key)
            return e[1] if e is not None else 0

    @property
    def samples(self) -> int:
        with self._lock:
            return self._samples

    def avg_run_s(self) -> float:
        """EWMA run seconds of recent queries (0.0 = uncalibrated)."""
        with self._lock:
            return self._avg_run_s

    def estimate_run_s(self, est_bytes: int, plan_key=None) -> float:
        """Predicted run seconds: this plan's own EWMA when its
        ``plan_key`` has history, else the calibrated global rate, else
        the plain average, 0.0 while uncalibrated (a cold scheduler never
        sheds on run time)."""
        with self._lock:
            if plan_key is not None:
                e = self._plans.get(plan_key)
                if e is not None:
                    self._plans.move_to_end(plan_key)
                    return e[0]
            if self._samples == 0:
                return 0.0
            if est_bytes > 0 and self._bytes_per_s > 0:
                # never predict below the average floor: tiny queries pay
                # fixed dispatch costs the linear model misses
                return max(
                    est_bytes / self._bytes_per_s, self._avg_run_s * 0.25
                )
            return self._avg_run_s

    def reset(self) -> None:
        with self._lock:
            self._avg_run_s = 0.0
            self._bytes_per_s = 0.0
            self._samples = 0
            self._plans.clear()


CALIBRATION = RunCalibration()
