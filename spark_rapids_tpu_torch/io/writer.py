"""File write path — the I/O layer's write half, as PLAN NODES, not a
driver-side collect.

The port of ``spark_rapids_tpu/io/writer.py`` (reference:
GpuDataWritingCommandExec.scala, GpuFileFormatWriter.scala,
GpuFileFormatDataWriter.scala's SingleDirectoryDataWriter and
DynamicPartitionDataWriter). The columnar data is on the host side of the
``DeviceToHostExec`` transition and the port's own writers encode it
(``io/parquet.py``, ``io/csv.py``), where the JAX package uses pyarrow.

``CpuWriteFilesExec`` consumes each child partition *inside the partition
task* (concurrently across partitions, never funneled through the driver),
writing ``part-{pid}-{uuid}`` files; with ``partition_by`` each task splits
its batches by partition-value tuple and appends to per-directory writers
(``key=value/`` Hive layout); with ``bucket_by`` rows route to per-bucket
files by the exchange's hash (``io/bucketing.py``). The exec's output is one
stats row per written file (filename, rows) — the write-stats tracker
(BasicColumnarWriteStatsTracker analogue).

The JAX writer also bumps the result cache's table versions and tells the
live-table runtime of a write; the port has neither yet (ROADMAP item 14),
and ``append_live_file`` waits there for its caller.
"""
from __future__ import annotations

import os
import shutil
import uuid
from typing import List, Optional

import numpy as np

from ..columnar.host import HostBatch, HostColumn, concat_batches, string_column, to_pylist
from ..plan.physical import Exec, ExecContext, PartitionSet
from ..types import (
    LONG,
    STRING,
    DateType,
    Schema,
    StructField,
    TimestampType,
)
from .files import escape_path_name, orc_not_ported

STATS_SCHEMA = Schema(
    [StructField("filename", STRING, False), StructField("num_rows", LONG, False)]
)

_NAN = float("nan")  # canonical NaN for partition-combo dedup

# 1582-10-15, the Gregorian cutover, as days since epoch
_CUTOVER_DAYS = -141427
_FORMATS = ("parquet", "csv")


def _rebase_guard(rb: HostBatch) -> None:
    """spark.sql.parquet.datetimeRebaseModeInWrite=EXCEPTION (shim-routed
    default, Spark 3.1/3.2): refuse dates/timestamps before the Gregorian
    cutover — the engine writes proleptic values and performs no julian
    rebase (reference RebaseHelper.newRebaseExceptionInWrite). The port's
    timestamps are microseconds, its dates days."""
    for f, col in zip(rb.schema, rb.columns):
        if isinstance(f.data_type, DateType):
            cut = _CUTOVER_DAYS
        elif isinstance(f.data_type, TimestampType):
            cut = _CUTOVER_DAYS * 86_400_000_000
        else:
            continue
        if not col.validity.any():
            continue
        lo = int(col.data[col.validity].min())
        if lo < cut:
            raise ValueError(
                f"write of column {f.name!r} contains dates before "
                "1582-10-15, which would need julian rebase "
                "(spark.sql.parquet.datetimeRebaseModeInWrite="
                "EXCEPTION; use the 3.3 shim for CORRECTED writes)"
            )


class _FormatWriter:
    """One open output file, append-able batch by batch."""

    def __init__(self, fmt: str, path: str, schema: Schema, options: dict):
        self.path = path
        self.fmt = fmt
        self.options = options
        self.rows = 0
        if fmt == "parquet":
            from .parquet import ParquetWriter

            self._w = ParquetWriter(path, schema, options.get("compression", "snappy"))
        elif fmt == "csv":
            from .csv import CsvWriter

            include_header = str(options.get("header", "false")).lower() in ("true", "1")
            self._w = CsvWriter(path, schema, include_header)
        elif fmt == "orc":
            raise orc_not_ported("write.orc")
        else:
            raise ValueError(fmt)

    def write(self, rb: HostBatch):
        self.rows += rb.num_rows
        if self.fmt == "parquet" and self.options.get("__rebase") == "EXCEPTION":
            _rebase_guard(rb)
        self._w.write_batch(rb)

    def close(self):
        self._w.close()


def append_live_file(path: str, fmt: str, table: HostBatch, basename: str,
                     options: Optional[dict] = None) -> str:
    """The live-ingestion append primitive: land one host batch as a single
    ROOT-LEVEL data file named by the caller, who picks a basename that
    sorts after every existing one so a fresh directory listing replays
    files in append order. (Its caller, the live-table runtime, comes with
    ROADMAP item 14.)"""
    os.makedirs(path, exist_ok=True)
    full = os.path.join(path, basename)
    w = _FormatWriter(fmt, full, table.schema, dict(options or {}))
    try:
        if table.num_rows:
            w.write(table)
    finally:
        w.close()
    return full


def _fmt_value(v) -> str:
    """Hive partition-directory encoding of one value (escaped like Spark's
    PartitioningUtils.escapePathName so read-back round-trips)."""
    if v is None:
        return "__HIVE_DEFAULT_PARTITION__"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float) and v != v:
        return "NaN"  # java Double.toString
    return escape_path_name(str(v))


def _canon(v):
    # one canonical NaN object so set-dedup of combos works
    if isinstance(v, float) and v != v:
        return _NAN
    return v


def _factorize(col: HostColumn) -> tuple:
    """(codes int64[n], a row of each code) of one flat key column, by
    value: nulls one value, every NaN one value, -0.0 equal to 0.0 (as a
    Python dict of the values would group them), strings by their bytes."""
    n = len(col)
    valid = col.validity
    if col.offsets is not None:
        lens = np.diff(col.offsets).astype(np.int64)
        w = int(lens.max()) if n else 0
        plane = np.zeros((n, w + 5), dtype=np.uint8)
        row = np.repeat(np.arange(n), lens)
        pos = np.arange(len(row)) - np.repeat(col.offsets[:-1].astype(np.int64), lens)
        plane[row, pos] = col.data[int(col.offsets[0]):int(col.offsets[-1])]
        plane[:, w:w + 4] = lens.astype("<u4").view(np.uint8).reshape(n, 4)
    else:
        data = col.data
        if data.dtype.kind == "f":
            data = np.where(np.isnan(data), np.nan, data + 0.0)
        plane = np.zeros((n, data.dtype.itemsize + 1), dtype=np.uint8)
        plane[:, :-1] = np.ascontiguousarray(np.where(valid, data, 0)).view(np.uint8).reshape(n, -1)
    plane[:, -1] = valid
    keys = np.ascontiguousarray(plane).view(f"V{plane.shape[1]}").ravel()
    _, first, codes = np.unique(keys, return_index=True, return_inverse=True)
    return codes.reshape(-1).astype(np.int64), first


def _group_rows(rb: HostBatch, names: List[str]) -> dict:
    """Partition-value tuple → the rows holding it: each key column
    factorized with numpy, the codes combined and grouped."""
    n = rb.num_rows
    combo = np.zeros(n, dtype=np.int64)
    cols = [rb.columns[rb.schema.index_of(name)] for name in names]
    for col in cols:
        codes, first = _factorize(col)
        combo = combo * len(first) + codes
    _, inv = np.unique(combo, return_inverse=True)
    order = np.argsort(inv, kind="stable")
    starts = np.flatnonzero(np.diff(inv[order], prepend=-1))
    out = {}
    for lo, hi in zip(starts, list(starts[1:]) + [n]):
        rows = order[lo:hi]
        key = tuple(_canon(to_pylist(c.slice(int(rows[0]), 1))[0]) for c in cols)
        out[key] = rows
    return out


class CpuWriteFilesExec(Exec):
    """The write plan node (GpuDataWritingCommandExec analogue). It stays
    on the host by design: the encoders are host code."""

    def __init__(self, child: Exec, path: str, fmt: str, partition_by: List[str],
                 options: dict):
        super().__init__([child])
        if fmt == "orc":
            raise orc_not_ported("write.orc")
        self.path = path
        self.fmt = fmt
        self.partition_by = list(partition_by)
        self.w_options = dict(options)
        child_schema = child.output
        missing = [c for c in self.partition_by if c not in child_schema.names]
        if missing:
            raise ValueError(f"partitionBy columns not in schema: {missing}")
        self._data_names = [n for n in child_schema.names if n not in self.partition_by]
        self.bucket_spec = options.get("__bucket_spec")
        if self.bucket_spec:
            bad = [
                c for c in self.bucket_spec["cols"]
                if c not in child_schema.names or c in self.partition_by
            ]
            if bad:
                raise ValueError(f"bucketBy columns must be non-partition data columns: {bad}")
        self._child_schema = child_schema
        self._data_schema = Schema(
            [f for f in child_schema.fields if f.name in self._data_names]
        )

    @property
    def output(self) -> Schema:
        return STATS_SCHEMA

    def execute(self, ctx: ExecContext) -> PartitionSet:
        child_parts = self.children[0].execute(ctx)
        ext = {"parquet": ".parquet", "csv": ".csv"}[self.fmt]

        def make(pid: int, thunk):
            def it():
                writers: dict = {}
                run_id = uuid.uuid4().hex[:12]

                def writer_for(subdir: str, schema: Schema, bucket: int = None) -> _FormatWriter:
                    key = (subdir, bucket)
                    w = writers.get(key)
                    if w is None:
                        d = os.path.join(self.path, subdir) if subdir else self.path
                        os.makedirs(d, exist_ok=True)
                        suffix = "" if bucket is None else f"_b{bucket:05d}"
                        fname = f"part-{pid:05d}-{run_id}{suffix}{ext}"
                        w = _FormatWriter(self.fmt, os.path.join(d, fname), schema,
                                          self.w_options)
                        writers[key] = w
                    return w

                def write_bucketed(subdir: str, rb2: HostBatch, schema: Schema):
                    """Route rows to per-bucket files by the exchange's own
                    hash (io/bucketing.py)."""
                    from .bucketing import bucket_ids

                    bids = bucket_ids(rb2, schema, self.bucket_spec)
                    for b in np.unique(bids).tolist():
                        sub = rb2.filter(bids == b)
                        if sub.num_rows:
                            writer_for(subdir, sub.schema, b).write(sub)

                try:
                    for rb in thunk():
                        if rb.num_rows == 0:
                            continue
                        if not self.partition_by:
                            if self.bucket_spec:
                                write_bucketed("", rb, self._child_schema)
                            else:
                                writer_for("", rb.schema).write(rb)
                            continue
                        # dynamic partitioning: group rows by partition tuple
                        # (DynamicPartitionDataWriter's sorted-loop analogue)
                        rows_of = _group_rows(rb, self.partition_by)
                        data = rb.select(self._data_names)
                        for combo in sorted(
                            rows_of, key=lambda c: tuple((x is None, str(x)) for x in c)
                        ):
                            sub = data.take(rows_of[combo])
                            subdir = os.path.join(*[
                                f"{c}={_fmt_value(v)}" for c, v in zip(self.partition_by, combo)
                            ])
                            if self.bucket_spec:
                                write_bucketed(subdir, sub, self._data_schema)
                            else:
                                writer_for(subdir, sub.schema).write(sub)
                finally:
                    for w in writers.values():
                        w.close()
                yield HostBatch(
                    STATS_SCHEMA,
                    [
                        string_column([w.path for w in writers.values()]),
                        HostColumn(LONG, np.asarray([w.rows for w in writers.values()],
                                                    dtype=np.int64),
                                   np.ones(len(writers), dtype=bool)),
                    ],
                    len(writers),
                )

            return it

        return PartitionSet([make(i, t) for i, t in enumerate(child_parts.parts)])

    def node_string(self):
        pb = f" partitionBy={self.partition_by}" if self.partition_by else ""
        return f"WriteFiles {self.fmt} {self.path}{pb}"


class DataFrameWriter:
    """df.write — executes a write PLAN (scan→…→WriteFilesExec), with the
    encode work running per-partition in the query's tasks. Options:
    ``compression`` (Parquet: none, snappy, gzip) and ``header`` (CSV)."""

    def __init__(self, df):
        self._df = df
        self._mode = "error"
        self._partition_by: List[str] = []
        self._bucket_spec = None
        self._options: dict = {}

    def mode(self, m: str) -> "DataFrameWriter":
        self._mode = m
        return self

    def option(self, k, v) -> "DataFrameWriter":
        self._options[k] = v
        return self

    def partition_by(self, *cols: str) -> "DataFrameWriter":
        self._partition_by = list(cols)
        return self

    partitionBy = partition_by

    def bucket_by(self, num_buckets: int, *cols: str) -> "DataFrameWriter":
        """Bucketed layout: rows route to ``num_buckets`` files per task by
        pmod(murmur3(cols), n); a ``_bucket_spec.json`` sidecar records the
        spec for the scan's bucket pruning (io/bucketing.py)."""
        if num_buckets <= 0 or not cols:
            raise ValueError("bucketBy needs num_buckets > 0 and columns")
        self._bucket_spec = {"num_buckets": int(num_buckets), "cols": list(cols)}
        return self

    bucketBy = bucket_by

    def _reads_from(self, path: str) -> bool:
        """True when the DataFrame's plan scans ``path`` (or a file inside
        it) — Spark refuses 'Cannot overwrite a path that is also being
        read from' rather than deleting its own input."""
        from ..plan import logical as L

        target = os.path.realpath(path)

        def walk(p) -> bool:
            if isinstance(p, L.FileScan):
                for sp in p.paths:
                    rp = os.path.realpath(sp)
                    if rp == target or rp.startswith(target + os.sep):
                        return True
            return any(walk(c) for c in p.children())

        return walk(self._df._plan)

    def _check_append_bucket_spec(self, path: str) -> None:
        """Appending must agree with the existing bucket layout: a
        mismatched spec (or bucketBy over data written without one) would
        silently overwrite ``_bucket_spec.json`` and make bucket pruning
        skip files that DO hold matching rows — wrong results, not an
        error. Spark refuses the same way ('mismatched bucketing')."""
        from .bucketing import read_spec

        existing = read_spec(path)
        if self._bucket_spec:
            if existing is None:
                has_data = any(not f.startswith("_") for f in os.listdir(path))
                if has_data:
                    raise ValueError(
                        f"Cannot append bucketed data (bucketBy) to {path}: "
                        "existing data was written without a bucket spec — "
                        "bucket pruning over the mixed layout would return "
                        "wrong results"
                    )
                return
            if existing["num_buckets"] != self._bucket_spec["num_buckets"] or [
                c.lower() for c in existing["cols"]
            ] != [c.lower() for c in self._bucket_spec["cols"]]:
                raise ValueError(
                    f"Cannot append to {path}: bucket spec mismatch — "
                    f"existing num_buckets={existing['num_buckets']} "
                    f"cols={existing['cols']}, requested "
                    f"num_buckets={self._bucket_spec['num_buckets']} "
                    f"cols={self._bucket_spec['cols']}"
                )
        elif existing is not None:
            raise ValueError(
                f"Cannot append unbucketed data to bucketed table {path} "
                f"(num_buckets={existing['num_buckets']} "
                f"cols={existing['cols']}); use "
                f"bucketBy({existing['num_buckets']}, "
                f"{', '.join(map(repr, existing['cols']))})"
            )

    def _write(self, path: str, fmt: str) -> HostBatch:
        if fmt not in _FORMATS:
            raise ValueError(fmt)
        if os.path.exists(path):
            if self._mode in ("error", "errorifexists"):
                raise FileExistsError(path)
            if self._mode == "overwrite":
                if self._reads_from(path):
                    raise ValueError(
                        f"Cannot overwrite a path that is also being read from: {path}"
                    )
                shutil.rmtree(path)
            elif self._mode == "ignore":
                return concat_batches(STATS_SCHEMA, [])
            elif self._mode == "append":
                self._check_append_bucket_spec(path)
        os.makedirs(path, exist_ok=True)
        session = self._df._session
        from ..plan import logical as L

        opts = dict(self._options)
        # shim-routed write semantics (SparkShims seam)
        opts.setdefault("__rebase", session.shim.parquet_rebase_write())
        if self._bucket_spec:
            opts["__bucket_spec"] = self._bucket_spec
        lp = L.WriteFiles(self._df._plan, path, fmt, list(self._partition_by), opts)
        stats = session._execute(lp)
        if self._bucket_spec:
            from .bucketing import write_spec

            write_spec(path, self._bucket_spec["num_buckets"], self._bucket_spec["cols"])
        # driver commit marker (FileFormatWriter's _SUCCESS)
        open(os.path.join(path, "_SUCCESS"), "w").close()
        return stats

    def parquet(self, path: str) -> HostBatch:
        return self._write(path, "parquet")

    def csv(self, path: str) -> HostBatch:
        return self._write(path, "csv")

    def orc(self, path: str):
        raise orc_not_ported("write.orc")


__all__ = ["CpuWriteFilesExec", "DataFrameWriter", "STATS_SCHEMA"]
