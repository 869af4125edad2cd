"""Typed configuration — the ``RapidsConf`` analogue, cut to the keys the
port reads.

Cut from ``spark_rapids_tpu/config.py``: the same ``ConfEntry`` builder, the
same key names and defaults, and ``TpuConf`` unchanged, so the reference's
test confs apply as they are. A key the port does not read (the JAX
package's serving, caching, transport faults, Pallas and scheduling keys) is
not defined here: ``TpuConf`` keeps it as an unknown setting that nothing
reads. Every operator/expression rule also gets a kill switch
(``spark.rapids.sql.exec.*`` / ``spark.rapids.sql.expression.*``), read
through ``TpuConf.rule_enabled`` by ``plan/overrides.py``.
"""
from __future__ import annotations

import os
from typing import Any, Callable, Generic, Optional, TypeVar

T = TypeVar("T")


class ConfEntry(Generic[T]):
    def __init__(self, key: str, default: T, doc: str, conv: Callable[[str], T]):
        self.key = key
        self.default = default
        self.doc = doc
        self.conv = conv

    def get(self, conf: "TpuConf") -> T:
        return conf.get(self.key, self.default, self.conv)


class _EntryBuilder:
    def __init__(self, key: str):
        self._key = key
        self._doc = ""

    def doc(self, text: str) -> "_EntryBuilder":
        self._doc = text
        return self

    def boolean_conf(self, default: bool) -> ConfEntry[bool]:
        return ConfEntry(self._key, default, self._doc, lambda s: s.strip().lower() in ("true", "1"))

    def int_conf(self, default: int) -> ConfEntry[int]:
        return ConfEntry(self._key, default, self._doc, int)

    def bytes_conf(self, default: int) -> ConfEntry[int]:
        return ConfEntry(self._key, default, self._doc, _parse_bytes)

    def double_conf(self, default: float) -> ConfEntry[float]:
        return ConfEntry(self._key, default, self._doc, float)

    def string_conf(self, default: Optional[str]) -> ConfEntry[Optional[str]]:
        return ConfEntry(self._key, default, self._doc, lambda s: s)


def conf(key: str) -> _EntryBuilder:
    return _EntryBuilder(key)

def _parse_bytes(s: str) -> int:
    s = s.strip().lower()
    mult = 1
    for suffix, m in (("k", 1 << 10), ("m", 1 << 20), ("g", 1 << 30), ("t", 1 << 40)):
        if s.endswith(suffix + "b"):
            s, mult = s[:-2], m
            break
        if s.endswith(suffix):
            s, mult = s[:-1], m
            break
    return int(float(s) * mult)


# ── The keys the port reads ─────────────────────────────────────────────────

SQL_ENABLED = conf("spark.rapids.sql.enabled").doc(
    "Enable (true) or disable (false) device acceleration of SQL operators."
).boolean_conf(True)

EXPLAIN = conf("spark.rapids.sql.explain").doc(
    "Explain why parts of a query were or were not placed on the device: "
    "NONE, NOT_ON_GPU (only log un-replaced nodes), ALL."
).string_conf("NONE")

TEST_CONF = conf("spark.rapids.sql.test.enabled").doc(
    "Test mode: fail if any operator that was expected on device fell back "
    "(reference: RapidsConf TEST_CONF)."
).boolean_conf(False)

TEST_ALLOWED_NONTPU = conf("spark.rapids.sql.test.allowedNonGpu").doc(
    "Comma-separated exec names allowed to stay on CPU in test mode."
).string_conf(None)

BATCH_SIZE_BYTES = conf("spark.rapids.sql.batchSizeBytes").doc(
    "Target size of a columnar batch the operators work on "
    "(reference: RapidsConf.scala:402)."
).bytes_conf(1 << 30)

SHUFFLE_PARTITIONS = conf("spark.sql.shuffle.partitions").doc(
    "Default number of partitions for exchanges (Spark's key, honored here)."
).int_conf(8)

AUTO_BROADCAST_THRESHOLD = conf("spark.sql.autoBroadcastJoinThreshold").doc(
    "Maximum estimated build-side size for which a join is planned as a "
    "broadcast hash join (Spark's key, honored here; -1 disables)."
).bytes_conf(10 << 20)

ANSI_ENABLED = conf("spark.sql.ansi.enabled").doc(
    "Spark's ANSI mode (honored here): casts raise on overflow or malformed "
    "input instead of returning NULL, and integral narrowing range-checks "
    "instead of wrapping."
).boolean_conf(False)

DECIMAL_ENABLED = conf("spark.rapids.sql.decimalType.enabled").doc(
    "Enable decimal (64-bit) processing on device."
).boolean_conf(True)

VARIABLE_FLOAT_AGG = conf("spark.rapids.sql.variableFloatAgg.enabled").doc(
    "Allow float/double aggregations whose result can vary with evaluation "
    "order (sum/avg over float)."
).boolean_conf(True)

INCOMPATIBLE_OPS = conf("spark.rapids.sql.incompatibleOps.enabled").doc(
    "Enable operators that produce results that differ from Spark in corner "
    "cases (e.g. float aggregation ordering)."
).boolean_conf(False)

CAST_FLOAT_TO_STRING = conf("spark.rapids.sql.castFloatToString.enabled").doc(
    "Enable float→string casts, which may differ from Spark in formatting."
).boolean_conf(False)

CAST_STRING_TO_FLOAT = conf("spark.rapids.sql.castStringToFloat.enabled").doc(
    "Enable string→float casts, which may differ from Spark in corner cases."
).boolean_conf(False)

CAST_STRING_TO_TIMESTAMP = conf(
    "spark.rapids.sql.castStringToTimestamp.enabled"
).doc(
    "Enable string→timestamp casts on device; the device grammar is the "
    "UTC-only subset of Spark's (no zone offsets), matching the reference's "
    "gated support (GpuCast.scala castStringToTimestamp)."
).boolean_conf(False)

HAS_NANS = conf("spark.rapids.sql.hasNans").doc(
    "Assume floating point values may contain NaNs (gates some operators, "
    "matching the reference)."
).boolean_conf(True)

OUT_OF_CORE_SORT_THRESHOLD = conf("spark.rapids.tpu.sort.outOfCoreThresholdBytes").doc(
    "Partition size above which GpuSortExec switches from single-batch sort "
    "to sorted-run merge (reference: GpuSortExec.scala:212 out-of-core mode "
    "gated by targetSize)."
).bytes_conf(1 << 30)

STRING_MAX_BYTES = conf("spark.rapids.tpu.string.maxBytes").doc(
    "Maximum per-value string width the fixed-width device representation "
    "pads to before the column falls back to the CPU."
).int_conf(256)

POOL_SIZE_FRACTION = conf("spark.rapids.memory.gpu.allocFraction").doc(
    "Fraction of device memory the HBM pool may use "
    "(reference: RapidsConf.scala RMM_ALLOC_FRACTION)."
).double_conf(0.9)

DEVICE_POOL_LIMIT = conf("spark.rapids.tpu.memory.deviceLimitBytes").doc(
    "Spillable-buffer budget on device; 0 means unlimited. When registered "
    "spillable bytes would exceed this, the catalog proactively spills "
    "(reference: RMM pool size via spark.rapids.memory.gpu.allocFraction)."
).bytes_conf(0)


UPLOAD_CACHE_MAX_BYTES = conf("spark.rapids.tpu.uploadCache.maxBytes").doc(
    "Byte budget for the session's device-upload (H2D) cache of in-memory "
    "relations — the LRU bound standing between many-table sessions and "
    "pinned-HBM OOM. 0 (default) sizes automatically from device memory "
    "stats (a quarter of the device's byte limit) with a 4 GiB fallback "
    "when no stats are available."
).bytes_conf(0)

ADAPTIVE_ENABLED = conf("spark.sql.adaptive.enabled").doc(
    "Adaptive query execution (Spark's key, honored here): exchanges "
    "coalesce small output partitions at runtime from measured sizes "
    "(the GpuCustomShuffleReaderExec analogue)."
).boolean_conf(False)

SHUFFLE_MANAGER_ENABLED = conf("spark.rapids.shuffle.manager.enabled").doc(
    "Route exchanges through the accelerated shuffle manager (device-"
    "resident spillable map output + transport fetches) instead of the "
    "in-process default path (reference: RapidsShuffleManager)."
).boolean_conf(False)


# ── memory and resilience (mem/, resilience/) ───────────────────────────────

TASK_MAX_FAILURES = conf("spark.task.maxFailures").doc(
    "Task-retry budget (Spark's key): a failed partition task re-runs from "
    "its lineage up to this many total attempts before the query fails. "
    "Deterministic semantic errors (ANSI arithmetic/cast errors, "
    "assertions) are never retried."
).int_conf(4)

CONCURRENT_TPU_TASKS = conf("spark.rapids.sql.concurrentGpuTasks").doc(
    "Number of concurrent tasks that may hold the device at once — admission "
    "control via the device semaphore (reference: GpuSemaphore.scala)."
).int_conf(4)

MEMORY_DEBUG = conf("spark.rapids.memory.tpu.debug").doc(
    "Debug-allocator mode (the reference's spark.rapids.memory.gpu.debug + "
    "ai.rapids.refcount.debug): the spill catalog records the registration "
    "site of every spillable buffer, logs tier transitions, and reports any "
    "buffer still registered at query end as a LEAK with its origin."
).boolean_conf(False)

HOST_SPILL_STORAGE_SIZE = conf("spark.rapids.memory.host.spillStorageSize").doc(
    "Amount of host memory to use for spilled device buffers before "
    "overflowing to disk."
).bytes_conf(1 << 31)

SPILL_DIR = conf("spark.rapids.memory.spillDir").doc(
    "Directory for the disk spill tier."
).string_conf(None)

RETRY_OOM_MAX_RETRIES = conf("spark.rapids.tpu.retry.oom.maxRetries").doc(
    "Spill-and-retry attempts per device launch on a device OOM before the "
    "retry state machine starts splitting the input batch (reference: "
    "DeviceMemoryEventHandler.scala:42-69 spill-retry loop)."
).int_conf(2)

RETRY_OOM_SPLIT_ENABLED = conf("spark.rapids.tpu.retry.oom.splitEnabled").doc(
    "After the spill-retry budget is exhausted, recursively halve the "
    "input batch of splittable operators (project/filter, partial "
    "aggregate update, join probe) and retry each half — the "
    "split-and-retry escalation for work that genuinely does not fit."
).boolean_conf(True)

RETRY_OOM_MIN_SPLIT_ROWS = conf("spark.rapids.tpu.retry.oom.minSplitRows").doc(
    "Floor on the batch capacity the OOM retry state machine will split "
    "down to; a batch at or below this capacity that still OOMs fails "
    "the task."
).int_conf(1024)

CIRCUIT_BREAKER_ENABLED = conf("spark.rapids.tpu.retry.circuitBreaker.enabled").doc(
    "When a device operator for an op signature fails repeatedly with "
    "non-OOM device errors, mark that op CPU-fallback for the session and "
    "log the reason in the explain output (the per-node fallback contract "
    "extended to runtime failures)."
).boolean_conf(True)

CIRCUIT_BREAKER_THRESHOLD = conf("spark.rapids.tpu.retry.circuitBreaker.threshold").doc(
    "Device-operator failures for one op signature that trip its circuit "
    "breaker."
).int_conf(3)

FAULTS_ENABLED = conf("spark.rapids.tpu.faults.enabled").doc(
    "Master switch for the deterministic fault-injection harness; all "
    "spark.rapids.tpu.faults.* points are inert unless enabled. Drives "
    "the chaos tests — never enable in production."
).boolean_conf(False)

FAULTS_DEVICE_OOM_EVERY_N = conf("spark.rapids.tpu.faults.deviceOomEveryN").doc(
    "Raise a synthetic device OOM on every Nth device launch under an "
    "OOM-recovery scope (with_oom_retry / the retry state machine) — each "
    "injection deterministically exercises the spill/split recovery; 0 "
    "disables."
).int_conf(0)

FAULTS_OOM_ABOVE_BYTES = conf("spark.rapids.tpu.faults.oomAboveBytes").doc(
    "Raise a synthetic device OOM whenever a splittable operator launches a "
    "batch larger than this many bytes — the deterministic driver for "
    "demonstrating recursive split-and-retry; 0 disables."
).bytes_conf(0)

FAULTS_KERNEL_ERROR_EVERY_N = conf("spark.rapids.tpu.faults.kernelErrorEveryN").doc(
    "Raise a synthetic non-OOM device error on every Nth splittable-operator "
    "launch (drives the circuit breaker); 0 disables."
).int_conf(0)

FAULTS_SPILL_WRITE_ERROR_EVERY_N = conf(
    "spark.rapids.tpu.faults.spill.writeErrorEveryN"
).doc(
    "Fail every Nth disk-tier spill write with an IO error (the buffer "
    "stays at the host tier); 0 disables."
).int_conf(0)

FAULTS_SPILL_READ_ERROR_EVERY_N = conf(
    "spark.rapids.tpu.faults.spill.readErrorEveryN"
).doc(
    "Fail every Nth disk-tier re-materialization read with an IO error "
    "(surfaces as a catalog SpillError naming the buffer); 0 disables."
).int_conf(0)

class TpuConf:
    """An immutable-ish view over a key→string dict, with typed access.

    Mirrors ``RapidsConf``'s construction from the Spark conf; here it is
    constructed from a plain dict plus ``SPARK_RAPIDS_*``-style environment
    overrides.
    """

    def __init__(self, settings: Optional[dict[str, Any]] = None):
        self._settings: dict[str, str] = {}
        for k, v in (settings or {}).items():
            self._settings[k] = str(v) if not isinstance(v, bool) else str(v).lower()

    def get(self, key: str, default: T, conv: Callable[[str], T]) -> T:
        raw = self._settings.get(key)
        if raw is None:
            raw = os.environ.get("SRT_CONF_" + key.replace(".", "_").upper())
        if raw is None:
            return default
        return conv(raw)

    def get_raw(self, key: str) -> Optional[str]:
        return self._settings.get(key)

    def set(self, key: str, value: Any) -> "TpuConf":
        new = dict(self._settings)
        new[key] = str(value) if not isinstance(value, bool) else str(value).lower()
        return TpuConf(new)

    def is_enabled(self, entry: ConfEntry[bool]) -> bool:
        return entry.get(self)

    # Rule kill switches (auto-derived keys): default True unless set.
    def rule_enabled(self, conf_key: str, default: bool = True) -> bool:
        raw = self._settings.get(conf_key)
        if raw is None:
            return default
        return raw.strip().lower() in ("true", "1")

    def items(self):
        return self._settings.items()

