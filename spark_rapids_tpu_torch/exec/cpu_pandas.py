"""pandas-interop execs — the L7 python-exec family.

Reference: GpuMapInPandasExec / GpuFlatMapGroupsInPandasExec (+ the shared
GpuArrowEvalPythonExec Arrow streaming, :391). There the columnar batches
stream over Arrow IPC to a separate python worker; this engine IS python,
so the "worker protocol" collapses to ``HostBatch → pandas`` conversions
in-process — same dataflow, no socket. These execs run on the host side of
a D2H transition (python user code cannot run on the device), exactly like
the reference pairs its python execs with columnar↔row transitions.

Copied from ``spark_rapids_tpu/exec/cpu_pandas.py``. The JAX package
converts through pyarrow (``RecordBatch.to_pandas``, ``Table.from_pandas``);
the port converts its numpy ``HostBatch`` itself, under the same Arrow →
pandas conventions (:func:`to_pandas`), so it needs pandas but not pyarrow.
pandas is imported only when a pandas exec runs, and a plain
``ImportError`` names it where it is missing.
"""
from __future__ import annotations

from typing import Iterator, List

import numpy as np

from ..columnar.host import (
    HostBatch,
    HostColumn,
    column_from_pylist,
    concat_batches,
    to_pylist,
)
from ..plan.physical import Exec, ExecContext, PartitionSet
from ..types import (
    BooleanType,
    DateType,
    DecimalType,
    FractionalType,
    NullType,
    Schema,
    StringType,
    TimestampType,
    is_complex,
)


def _pandas():
    try:
        import pandas as pd
    except ImportError as e:
        raise ImportError(
            "the pandas execs (mapInPandas, applyInPandas, cogroup, pandas UDFs) "
            "need the pandas package, which is not installed"
        ) from e
    return pd


def _series(col: HostColumn, pd):
    """One host column as pyarrow's ``to_pandas`` gives it: integers with
    nulls widen to float64 (NaN), booleans with nulls and dates, decimals
    and nested values are objects (None for null), strings take pandas'
    string dtype, timestamps are UTC ``datetime64``."""
    dt, valid = col.dtype, col.validity
    if isinstance(dt, TimestampType):
        s = pd.Series(pd.to_datetime(col.data.astype(np.int64), unit="us", utc=True))
        s[~valid] = pd.NaT
        return s
    if isinstance(dt, FractionalType) and not isinstance(dt, DecimalType):
        return pd.Series(np.where(valid, col.data, np.nan))
    if isinstance(dt, StringType):
        return pd.Series(to_pylist(col))  # pandas picks its string dtype
    if (
        isinstance(dt, (DateType, DecimalType, NullType))
        or is_complex(dt)
        or (isinstance(dt, BooleanType) and not valid.all())
    ):
        return pd.Series(to_pylist(col), dtype=object)
    if not valid.all():
        return pd.Series(np.where(valid, col.data.astype(np.float64), np.nan))
    return pd.Series(col.data)


def to_pandas(batch: HostBatch):
    """A host batch as a ``pandas.DataFrame``, under the Arrow → pandas
    conventions of :func:`_series`."""
    pd = _pandas()
    cols = {f.name: _series(c, pd) for f, c in zip(batch.schema, batch.columns)}
    return pd.DataFrame(cols, columns=batch.schema.names)


def _column(s, dt, pd) -> HostColumn:
    """One pandas Series → a host column of ``dt`` (pyarrow's
    ``from_pandas`` + cast: NaN/None/NaT are null)."""
    null = s.isna().to_numpy(dtype=bool) if not is_complex(dt) else np.array(
        [v is None for v in s], dtype=bool
    )
    valid = ~null
    if isinstance(dt, TimestampType):
        ns = pd.to_datetime(s, utc=True).to_numpy(dtype="datetime64[ns]").astype(np.int64)
        return HostColumn(dt, np.where(valid, ns // 1000, 0).astype(np.int64), valid)
    if isinstance(dt, DateType) and np.issubdtype(s.dtype, np.datetime64):
        days = s.to_numpy().astype("datetime64[D]").astype(np.int64)
        return HostColumn(dt, np.where(valid, days, 0).astype(np.int32), valid)
    if isinstance(dt, (StringType, DateType, DecimalType)) or is_complex(dt):
        vals = [None if n else v for v, n in zip(s.tolist(), null)]
        if isinstance(dt, StringType):
            vals = [None if v is None else str(v) for v in vals]
        return column_from_pylist(vals, dt)
    if isinstance(dt, NullType):
        return column_from_pylist([None] * len(s), dt)
    raw = s.to_numpy()
    if raw.dtype == object:
        raw = np.array([0 if n else v for v, n in zip(raw, null)])
    data = np.where(valid, raw, 0).astype(dt.np_dtype)
    return HostColumn(dt, data, valid)


def prefetched(it: Iterator, depth: int) -> Iterator:
    """BatchQueue analogue (GpuArrowEvalPythonExec.scala:188): a producer
    thread drains the upstream batch pipeline into a bounded queue while
    the python function consumes — device production and python compute
    overlap instead of serializing. The WHOLE upstream iterator advances on
    the producer thread (task thread-locals re-assert per pull, so the
    stage scoping is thread-consistent); errors propagate to the consumer;
    an abandoned consumer releases the producer via the stop flag."""
    if depth <= 0:
        return it
    import queue as _q
    import threading

    buf: "_q.Queue" = _q.Queue(maxsize=depth)
    stop = threading.Event()
    DONE = object()

    class _Err:
        def __init__(self, e):
            self.e = e

    def produce():
        try:
            for x in it:
                while not stop.is_set():
                    try:
                        buf.put(x, timeout=0.1)
                        break
                    except _q.Full:
                        continue
                if stop.is_set():
                    return
            item = DONE
        except BaseException as e:  # noqa: BLE001 - relayed to the consumer
            item = _Err(e)
        while not stop.is_set():
            try:
                buf.put(item, timeout=0.1)
                return
            except _q.Full:
                continue

    def consume():
        # lazy start: a consumer generator that is never advanced never
        # runs its finally, so an eager producer would busy-poll forever
        threading.Thread(target=produce, daemon=True).start()
        try:
            while True:
                x = buf.get()
                if x is DONE:
                    return
                if isinstance(x, _Err):
                    raise x.e
                yield x
        finally:
            stop.set()

    return consume()


def _df_to_batches(df, schema: Schema, what: str) -> Iterator[HostBatch]:
    pd = _pandas()
    if not isinstance(df, pd.DataFrame):
        raise TypeError(f"{what} must return pandas DataFrames, got {type(df)}")
    cols = []
    for f in schema:
        if f.name not in df.columns:
            raise ValueError(
                f"{what} result is missing column {f.name!r} "
                f"(declared schema: {schema.names})"
            )
        cols.append(_column(df[f.name].reset_index(drop=True), f.data_type, pd))
    if len(df):
        yield HostBatch(schema, cols, len(df))


def _prefetch_depth(ctx: ExecContext) -> int:
    from .. import config as cfg

    return cfg.PYTHON_PREFETCH_BATCHES.get(ctx.conf)


class CpuMapInPandasExec(Exec):
    """fn(iterator of pd.DataFrame) → iterator of pd.DataFrame, one call
    per partition (pyspark mapInPandas contract)."""

    def __init__(self, fn, schema: Schema, child: Exec):
        super().__init__([child])
        self.fn = fn
        self._schema = schema

    @property
    def output(self) -> Schema:
        return self._schema

    def execute(self, ctx: ExecContext) -> PartitionSet:
        fn, schema = self.fn, self._schema
        depth = _prefetch_depth(ctx)

        def run(it: Iterator[HostBatch]):
            src = prefetched(it, depth)

            def dfs():
                for rb in src:
                    yield to_pandas(rb)

            for df in fn(dfs()):
                yield from _df_to_batches(df, schema, "mapInPandas fn")

        return self.children[0].execute(ctx).map_partitions(run)

    def node_string(self):
        return f"CpuMapInPandas {getattr(self.fn, '__name__', 'fn')}"


class CpuFlatMapGroupsInPandasExec(Exec):
    """fn(pd.DataFrame) → pd.DataFrame per key group. The planner exchanges
    rows by the grouping keys first, so each partition holds whole groups
    (the reference plans its python exec the same way)."""

    def __init__(self, grouping: List[str], fn, schema: Schema, child: Exec):
        super().__init__([child])
        self.grouping = list(grouping)
        self.fn = fn
        self._schema = schema

    @property
    def output(self) -> Schema:
        return self._schema

    def execute(self, ctx: ExecContext) -> PartitionSet:
        fn, schema, keys = self.fn, self._schema, self.grouping

        child_schema = self.children[0].output

        def run(it: Iterator[HostBatch]):
            batches = list(it)
            if not batches:
                return
            pdf = to_pandas(concat_batches(child_schema, batches))
            if not len(pdf):
                return
            if not keys:
                # groupBy().applyInPandas: the whole frame is one group
                yield from _df_to_batches(fn(pdf), schema, "applyInPandas fn")
                return
            # dropna=False: NULL keys form a group (Spark semantics)
            for _, group in pdf.groupby(keys, dropna=False, sort=False):
                out = fn(group.reset_index(drop=True))
                yield from _df_to_batches(out, schema, "applyInPandas fn")

        return self.children[0].execute(ctx).map_partitions(run)

    def node_string(self):
        return (
            f"CpuFlatMapGroupsInPandas {self.grouping} "
            f"{getattr(self.fn, '__name__', 'fn')}"
        )


def _group_map(pdf, keys):
    """key tuple → group DataFrame (dropna=False: NULL keys group; insertion
    order preserved)."""
    out = {}
    if not len(pdf):
        return out
    for key, group in pdf.groupby(keys, dropna=False, sort=False):
        if not isinstance(key, tuple):
            key = (key,)
        # NaN keys are not equal to themselves; normalize for matching
        norm = tuple(None if (isinstance(k, float) and k != k) else k for k in key)
        out[norm] = group.reset_index(drop=True)
    return out


class CpuFlatMapCoGroupsInPandasExec(Exec):
    """``fn(left_pd, right_pd) -> pd.DataFrame`` once per key group present
    on either side; the planner exchanges both children by their keys with
    the same arity so co-grouped keys land in the same partition pair
    (reference GpuFlatMapCoGroupsInPandasExec)."""

    def __init__(self, left_keys, right_keys, fn, schema: Schema, left: Exec, right: Exec):
        super().__init__([left, right])
        self.left_keys = list(left_keys)
        self.right_keys = list(right_keys)
        self.fn = fn
        self._schema = schema

    @property
    def output(self) -> Schema:
        return self._schema

    def execute(self, ctx: ExecContext) -> PartitionSet:
        fn, schema = self.fn, self._schema
        lk, rk = self.left_keys, self.right_keys
        lschema = self.children[0].output
        rschema = self.children[1].output
        lparts = self.children[0].execute(ctx)
        rparts = self.children[1].execute(ctx)
        assert lparts.num_partitions == rparts.num_partitions, (
            "cogroup sides must be co-partitioned"
        )

        def make(lt, rt):
            def run():
                lpdf = to_pandas(concat_batches(lschema, list(lt())))
                rpdf = to_pandas(concat_batches(rschema, list(rt())))
                lgroups = _group_map(lpdf, lk)
                rgroups = _group_map(rpdf, rk)
                lempty = lpdf.iloc[0:0]
                rempty = rpdf.iloc[0:0]
                keys = list(lgroups) + [k for k in rgroups if k not in lgroups]
                for key in keys:
                    out = fn(
                        lgroups.get(key, lempty), rgroups.get(key, rempty)
                    )
                    yield from _df_to_batches(out, schema, "cogroup applyInPandas fn")

            return run

        return PartitionSet(
            [make(lt, rt) for lt, rt in zip(lparts.parts, rparts.parts)]
        )

    def node_string(self):
        return (
            f"CpuFlatMapCoGroupsInPandas {self.left_keys}/{self.right_keys} "
            f"{getattr(self.fn, '__name__', 'fn')}"
        )


class CpuAggregateInPandasExec(Exec):
    """GROUPED_AGG pandas UDFs: one scalar per (group, udf); output is
    grouping columns ++ udf results (reference GpuAggregateInPandasExec).
    ``udfs``: list of (out_name, fn, return_type, arg_col_names)."""

    def __init__(self, grouping: List[str], udfs, schema: Schema, child: Exec):
        super().__init__([child])
        self.grouping = list(grouping)
        self.udfs = list(udfs)
        self._schema = schema

    @property
    def output(self) -> Schema:
        return self._schema

    def execute(self, ctx: ExecContext) -> PartitionSet:
        schema, keys, udfs = self._schema, self.grouping, self.udfs
        child_schema = self.children[0].output

        def run(it: Iterator[HostBatch]):
            pd = _pandas()
            pdf = to_pandas(concat_batches(child_schema, list(it)))
            if keys and not len(pdf):
                return
            rows: dict = {f.name: [] for f in schema}
            if keys:
                groups = pdf.groupby(keys, dropna=False, sort=False)
            else:
                # keyless global aggregate: exactly one output row even for
                # empty input (Spark emits the UDF over an empty frame)
                groups = [((), pdf)]
            for key, group in groups:
                if not isinstance(key, tuple):
                    key = (key,)
                for name, k in zip(keys, key):
                    rows[name].append(
                        None if (isinstance(k, float) and k != k) else k
                    )
                for out_name, fn, _rt, arg_names in udfs:
                    rows[out_name].append(
                        fn(*[group[a].reset_index(drop=True) for a in arg_names])
                    )
            out = pd.DataFrame(rows)
            yield from _df_to_batches(out, schema, "grouped-agg pandas UDF")

        return self.children[0].execute(ctx).map_partitions(run)

    def node_string(self):
        return (
            f"CpuAggregateInPandas {self.grouping} "
            f"[{', '.join(u[0] for u in self.udfs)}]"
        )
