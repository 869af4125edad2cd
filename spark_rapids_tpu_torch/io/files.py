"""File scans — the I/O layer's read half.

The port of ``spark_rapids_tpu/io/files.py`` (reference: GpuParquetScan.scala
PERFILE/COALESCING/MULTITHREADED reader strategies, GpuBatchScanExec.scala
for CSV). As in the JAX package there is no device-side decode: the scan
keeps the reference's host-side half — file listing, footer and schema
handling, multi-file coalescing, background prefetch threads — and hands
decoded host batches to the ``HostToDeviceExec`` transition. The decode
engine is the port's own (``io/parquet.py``, ``io/csv.py``) where the JAX
package uses pyarrow.

Reader strategies (``spark.rapids.sql.format.parquet.reader.type``):

* PERFILE: one partition per file, streamed batch reads;
* COALESCING: small files grouped into shared partitions by size until the
  reader byte target (MultiFileParquetPartitionReader,
  GpuParquetScan.scala:939, at file granularity);
* MULTITHREADED: a background thread pool prefetches file batches (the
  cloud reader, GpuParquetScan.scala:1358);
* AUTO: COALESCING for local paths, MULTITHREADED when a path's scheme is in
  ``spark.rapids.cloudSchemes``.

Also here: Hive-style partition discovery (escaped values,
``__HIVE_DEFAULT_PARTITION__``) with per-file constant columns, Parquet
row-group pruning from footer min/max statistics for pushed-down
conjuncts (never on float columns), whole-file pruning on partition values,
and bucket-file pruning (``io/bucketing.py``). The scan exec counts what
it skipped in ``pruned_row_groups``, ``pruned_files`` and
``pruned_buckets``, and adds to the query's counters its host decode time
(``fileScanDecodeNs``), the files it opened (``fileScanFiles``) and their
bytes (``fileScanBytes``). ORC raises, naming ROADMAP item 10b.
"""
from __future__ import annotations

import glob as _glob
import math
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Optional, Tuple

import numpy as np

from .. import config as cfg
from ..columnar.host import HostBatch, HostColumn, column_from_pylist
from ..config import TpuConf
from ..exec import task
from ..plan.physical import Exec, ExecContext, PartitionSet
from ..types import DOUBLE, LONG, STRING, Schema, StructField

ORC_ITEM = "ROADMAP item 10b"


def orc_not_ported(what: str):
    return NotImplementedError(f"{what}: ORC files are not read or written by the port yet "
                               f"({ORC_ITEM})")


def expand_paths(paths, fmt: str) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, _dirs, files in os.walk(p):
                for f in sorted(files):
                    if f.startswith(("_", ".")):
                        continue
                    out.append(os.path.join(root, f))
        elif any(ch in p for ch in "*?["):
            out.extend(sorted(_glob.glob(p)))
        else:
            out.append(p)
    if not out:
        raise FileNotFoundError(f"no {fmt} files found in {paths}")
    return out


# ── Hive-style partition discovery ─────────────────────────────────────────

# Spark's PartitioningUtils.charToEscape set (escapePathName/unescapePathName)
_ESCAPE_CHARS = set('"#%\'*/:=?\\\x7f{[]^') | {chr(c) for c in range(0x20)}


def escape_path_name(s: str) -> str:
    return "".join(f"%{ord(c):02X}" if c in _ESCAPE_CHARS else c for c in s)


def unescape_path_name(s: str) -> str:
    out = []
    i = 0
    while i < len(s):
        if s[i] == "%" and i + 3 <= len(s):
            try:
                out.append(chr(int(s[i + 1 : i + 3], 16)))
                i += 3
                continue
            except ValueError:
                pass
        out.append(s[i])
        i += 1
    return "".join(out)


def _partition_segments(path: str) -> List[Tuple[str, str]]:
    segs = []
    for part in path.split(os.sep)[:-1]:  # exclude the file name
        if "=" in part and not part.startswith("."):
            k, _, v = part.partition("=")
            if k:
                segs.append((unescape_path_name(k), unescape_path_name(v)))
    return segs


_HIVE_NULL = "__HIVE_DEFAULT_PARTITION__"


def discover_partitions(files: List[str]):
    """Infer Hive-layout partition columns from ``key=value`` directory
    segments. Returns (partition Schema, per-file value dicts); empty schema
    when the files carry no partition segments (Spark's
    PartitioningAwareFileIndex inference, narrowed to long/double/string)."""
    per_file = [dict(_partition_segments(f)) for f in files]
    keys: List[str] = []
    for d in per_file:
        for k in d:
            if k not in keys:
                keys.append(k)
    if not keys or any(set(d) != set(keys) for d in per_file):
        return Schema([]), [dict() for _ in files]

    def infer(vals):
        def is_long(s):
            try:
                int(s)
                return True
            except ValueError:
                return False

        def is_double(s):
            try:
                float(s)
                return True
            except ValueError:
                return False

        vals = [v for v in vals if v != _HIVE_NULL]
        if vals and all(is_long(v) for v in vals):
            return LONG
        if vals and all(is_double(v) for v in vals):
            return DOUBLE
        return STRING

    fields = []
    for k in keys:
        vals = [d[k] for d in per_file]
        nullable = any(d[k] == _HIVE_NULL for d in per_file)
        fields.append(StructField(k, infer(vals), nullable))
    return Schema(fields), per_file


def _typed_partition_value(raw: str, dt):
    if raw == _HIVE_NULL:
        return None
    if dt == LONG:
        return int(raw)
    if dt == DOUBLE:
        return float(raw)
    return raw


def splice_partition_values(rb: HostBatch, part_schema: Schema, values: dict) -> HostBatch:
    """Append constant partition-value columns to a data batch
    (ColumnarPartitionReaderWithPartitionValues.scala analogue)."""
    if not len(part_schema.fields):
        return rb
    cols = list(rb.columns)
    fields = list(rb.schema.fields)
    for f in part_schema:
        v = _typed_partition_value(values[f.name], f.data_type)
        cols.append(column_from_pylist([v] * rb.num_rows, f.data_type))
        fields.append(f)
    return HostBatch(Schema(fields), cols, rb.num_rows)


def infer_schema(files: List[str], fmt: str, options: dict) -> Schema:
    if fmt == "parquet":
        from .parquet import read_schema

        base = read_schema(files[0])
    elif fmt == "csv":
        from .csv import read_csv

        base = read_csv(files[0], options).schema
    elif fmt == "orc":
        raise orc_not_ported("read.orc")
    else:
        raise ValueError(fmt)
    part_schema, _ = discover_partitions(files)
    extra = [f for f in part_schema if f.name not in base.names]
    return Schema(list(base.fields) + extra)


# ── predicate pushdown: row-group pruning ──────────────────────────────────


def _stat_allows(op: str, value, mn, mx) -> bool:
    """Could any row in [mn, mx] satisfy ``col <op> value``? Conservative:
    True when stats are missing, and for NaN operands (the engine orders
    NaN greatest / NaN == NaN, which min/max stats cannot witness)."""
    if mn is None or mx is None:
        return True
    if isinstance(value, float) and math.isnan(value):
        return True
    try:
        if op == ">":
            return mx > value
        if op == ">=":
            return mx >= value
        if op == "<":
            return mn < value
        if op == "<=":
            return mn <= value
        if op == "=":
            return mn <= value <= mx
    except TypeError:
        return True
    return True


def row_group_survives(pf, rg_index: int, predicates) -> bool:
    """Evaluate pushed-down conjuncts against one row group's footer stats
    (GpuParquetFileFilterHandler analogue over the port's footer)."""
    for name, op, value in predicates:
        st = pf.statistics(rg_index, name)
        if st is None or not st.has_min_max:
            continue
        if st.physical_type in ("FLOAT", "DOUBLE"):
            # float min/max stats are NaN-blind (a NaN row can hide in any
            # group) and the engine treats NaN as the greatest value — never
            # prune float columns on stats
            continue
        if not _stat_allows(op, value, st.min, st.max):
            return False
    return True


def partition_value_survives(values: dict, part_schema: Schema, predicates) -> bool:
    """Whole-file pruning on Hive partition values."""
    types = {f.name: f.data_type for f in part_schema}
    for name, op, value in predicates:
        if name not in values:
            continue
        v = _typed_partition_value(values[name], types[name])
        if not _stat_allows(op, value, v, v):
            return False
    return True


class _ScanCounters:
    """The scan's per-query counters: host decode time, files opened and
    their bytes (added into ``ctx.metrics`` when there is a context)."""

    def __init__(self, metrics):
        self.metrics = metrics
        self.lock = threading.Lock()

    def add(self, decode_ns: int, files: int = 0, nbytes: int = 0) -> None:
        if self.metrics is None:
            return
        with self.lock:
            self.metrics["fileScanDecodeNs"] += decode_ns
            self.metrics["fileScanFiles"] += files
            self.metrics["fileScanBytes"] += nbytes


def _iter_file(
    path: str,
    fmt: str,
    schema: Schema,
    options: dict,
    batch_rows: int,
    part_schema: Optional[Schema] = None,
    part_values: Optional[dict] = None,
    predicates=(),
    pruned_counter=None,
    counters: Optional[_ScanCounters] = None,
) -> Iterator[HostBatch]:
    """The host batches of one file, conformed to ``schema`` (partition
    values spliced in), each decode timed into ``counters``."""
    part_schema = part_schema or Schema([])
    part_names = set(part_schema.names)
    counters = counters or _ScanCounters(None)
    try:
        nbytes = os.path.getsize(path)
    except OSError:
        nbytes = 0

    def out(rb):
        return _conform(splice_partition_values(rb, part_schema, part_values or {}), schema)

    if fmt == "parquet":
        from .parquet import ParquetFile

        t0 = time.perf_counter_ns()
        pf = ParquetFile(path)
        counters.add(time.perf_counter_ns() - t0, 1, nbytes)
        try:
            file_names = {c.name for c in pf.columns}
            want = [n for n in schema.names if n in file_names and n not in part_names]
            groups = list(range(pf.num_row_groups))
            if predicates:
                survivors = [g for g in groups if row_group_survives(pf, g, predicates)]
                if pruned_counter is not None and len(survivors) < len(groups):
                    pruned_counter(len(groups) - len(survivors))
                groups = survivors
            # pruned schema ⇒ pruned decode (pushed-down column projection)
            for g in groups:
                t0 = time.perf_counter_ns()
                hb = pf.read_row_group(g, want)
                counters.add(time.perf_counter_ns() - t0)
                for off in range(0, hb.num_rows, batch_rows):
                    part = hb if hb.num_rows <= batch_rows else hb.slice(off, batch_rows)
                    yield out(part)
        finally:
            pf.close()
    elif fmt == "csv":
        from .csv import read_csv

        t0 = time.perf_counter_ns()
        hb = read_csv(path, options)
        counters.add(time.perf_counter_ns() - t0, 1, nbytes)
        for off in range(0, hb.num_rows, batch_rows):
            yield out(hb if hb.num_rows <= batch_rows else hb.slice(off, batch_rows))
    elif fmt == "orc":
        raise orc_not_ported("an ORC scan")
    else:
        raise ValueError(fmt)


def _conform(rb: HostBatch, target: Schema) -> HostBatch:
    """The batch's columns in the target's order and types (a file whose
    column type differs from the first file's is cast)."""
    if rb.schema == target:
        return rb
    cols = []
    for f in target:
        c = rb.columns[rb.schema.index_of(f.name)]
        if c.dtype != f.data_type:
            c = _cast_column(c, f.data_type)
        cols.append(c)
    return HostBatch(target, cols, rb.num_rows)


def _cast_column(c: HostColumn, dt) -> HostColumn:
    if c.offsets is not None or dt.np_dtype is None or c.data is None:
        raise TypeError(f"cannot read a {c.dtype} column as {dt}")
    data = np.where(c.validity, c.data, 0).astype(dt.np_dtype)
    return HostColumn(dt, data, c.validity)


class CpuFileScanExec(Exec):
    """File source scan (GpuFileSourceScanExec/GpuBatchScanExec analogue).
    It stays on the host by design: there is no device Parquet or CSV
    decode, so its batches reach the device through ``HostToDeviceExec``."""

    def __init__(self, files: List[str], fmt: str, schema: Schema, options: dict,
                 conf: TpuConf):
        super().__init__([])
        if fmt == "orc":
            raise orc_not_ported("an ORC scan")
        self.files = files
        self.fmt = fmt
        self._schema = schema
        self.options = options
        self.batch_rows = cfg.MAX_READER_BATCH_SIZE_ROWS.get(conf)
        self.coalesce_bytes = cfg.MAX_READER_BATCH_SIZE_BYTES.get(conf)
        rt = options.get("readerType", cfg.PARQUET_READER_TYPE.get(conf)).upper()
        if rt == "AUTO":
            # reference default: COALESCING locally, MULTITHREADED when any
            # path lives on a cloud scheme (RapidsConf.scala:651)
            schemes = {
                s.strip().lower() for s in cfg.CLOUD_SCHEMES.get(conf).split(",") if s.strip()
            }
            # URI schemes are case-insensitive (RFC 3986)
            is_cloud = any(
                "://" in f and f.split("://", 1)[0].lower() in schemes for f in files
            )
            rt = "MULTITHREADED" if is_cloud else "COALESCING"
        self.reader_type = rt
        self.num_threads = cfg.MULTITHREADED_READ_NUM_THREADS.get(conf)
        # pushed-down conjuncts (name, op, literal) — set by the planner
        self.predicates: list = list(options.get("__predicates", ()))
        self.part_schema, self._part_values = discover_partitions(files)
        self.bucket_spec = options.get("__bucket_spec")
        self.pruned_row_groups = 0
        self.pruned_files = 0
        self.pruned_buckets = 0
        self._prune_lock = threading.Lock()

    @property
    def output(self) -> Schema:
        return self._schema

    @property
    def num_partitions(self) -> int:
        """The partitions ``execute`` gives before any pruning (pruning only
        takes files away): one a file, or one a size group when
        COALESCING."""
        if self.reader_type == "COALESCING":
            return max(1, len(self._coalesce_groups([(f, None) for f in self.files])))
        return max(1, len(self.files))

    def _count_pruned(self, n: int):
        with self._prune_lock:
            self.pruned_row_groups += n

    def _surviving_files(self):
        """(path, partition values) pairs after partition-value and bucket
        pruning (bucket pruning: GpuFileSourceScanExec.scala:148-149 — when
        every bucket column carries an equality conjunct, matching rows can
        only live in the literals' bucket file)."""
        target = None
        if self.bucket_spec and self.predicates:
            from .bucketing import target_bucket

            target = target_bucket(self.bucket_spec, self.predicates, self._schema)
        from .bucketing import parse_bucket_id

        out = []
        for path, vals in zip(self.files, self._part_values):
            if self.predicates and not partition_value_survives(
                vals, self.part_schema, self.predicates
            ):
                self.pruned_files += 1
                continue
            if target is not None:
                b = parse_bucket_id(os.path.basename(path))
                if b is not None and b != target:
                    self.pruned_files += 1
                    self.pruned_buckets += 1
                    continue
            out.append((path, vals))
        return out

    def _file_iter(self, path: str, vals: dict, counters: _ScanCounters):
        task.set_input_file(path)  # InputFileBlockHolder analogue
        yield from _iter_file(
            path,
            self.fmt,
            self._schema,
            self.options,
            self.batch_rows,
            self.part_schema,
            vals,
            self.predicates if self.fmt == "parquet" else (),
            self._count_pruned,
            counters,
        )

    def execute(self, ctx: Optional[ExecContext]) -> PartitionSet:
        counters = _ScanCounters(ctx.metrics if ctx is not None else None)
        pairs = self._surviving_files()
        if self.reader_type == "MULTITHREADED":
            return self._execute_multithreaded(pairs, counters)
        if self.reader_type == "COALESCING":
            return self._execute_coalescing(pairs, counters)
        parts = []
        for path, vals in pairs:
            def make(path=path, vals=vals):
                return self._file_iter(path, vals, counters)

            parts.append(make)
        if not parts:
            parts = [lambda: iter(())]
        return PartitionSet(parts)

    def _coalesce_groups(self, pairs) -> List[List[tuple]]:
        """Small files grouped by on-disk size into shared partitions until
        the reader byte target (MultiFileParquetPartitionReader's stitching,
        at file granularity)."""
        groups: List[List[tuple]] = []
        cur: List[tuple] = []
        cur_bytes = 0
        for path, vals in pairs:
            try:
                sz = os.path.getsize(path)
            except OSError:
                sz = self.coalesce_bytes
            if cur and cur_bytes + sz > self.coalesce_bytes:
                groups.append(cur)
                cur, cur_bytes = [], 0
            cur.append((path, vals))
            cur_bytes += sz
        if cur:
            groups.append(cur)
        return groups

    def _execute_coalescing(self, pairs, counters) -> PartitionSet:
        groups = self._coalesce_groups(pairs)

        def make(group):
            def it():
                for path, vals in group:
                    yield from self._file_iter(path, vals, counters)

            return it()

        parts = [lambda g=g: make(g) for g in groups]
        if not parts:
            parts = [lambda: iter(())]
        return PartitionSet(parts)

    def _execute_multithreaded(self, pairs, counters) -> PartitionSet:
        """Background prefetch pool (MultiFileCloudParquetPartitionReader):
        every file's read is submitted when its partition starts."""
        pool = ThreadPoolExecutor(max_workers=self.num_threads,
                                  thread_name_prefix="srt-file-read")

        def make(path, vals):
            def thunk():
                fut = pool.submit(lambda: list(self._file_iter(path, vals, counters)))

                def it():
                    task.set_input_file(path)
                    yield from fut.result()

                return it()

            return thunk

        parts = [make(p, v) for p, v in pairs]
        if not parts:
            parts = [lambda: iter(())]
        return PartitionSet(parts)

    def node_string(self):
        pred = f" pushed={self.predicates}" if self.predicates else ""
        return f"CpuFileScan {self.fmt} [{len(self.files)} files]{pred}"
