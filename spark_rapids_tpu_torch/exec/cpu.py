"""CPU physical operators — the fallback engine.

In the reference, fallback means "leave the original Spark CPU exec in
place" (RapidsMeta.willNotWorkOnGpu). Standalone, this module IS that CPU
engine: numpy operators with Spark-exact semantics. It doubles as the
differential-test oracle, the role SparkQueryCompareTestSuite's CPU session
plays in the reference (tests/.../SparkQueryCompareTestSuite.scala:339).

Copied from ``spark_rapids_tpu/exec/cpu.py`` with the host currency changed
from ``pyarrow.RecordBatch`` to the port's numpy ``HostBatch``. The operators
the port's planner emits are carried over: scan, project, filter, the
aggregate, coalesce, union, the hash/range/round-robin/single exchange,
sort, top-N, limit, expand, range and generate (explode).
"""
from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np

from ..columnar.host import (
    HostBatch,
    HostColumn,
    batch_from_columns,
    column_from_pylist,
    concat_batches,
    np_from_host,
)
from ..expr import Expression, bind, output_name
from ..expr.aggregates import AggregateFunction
from ..expr.base import Ctx, Val
from ..expr.misc import contains_task_dependent
from . import task
from ..ops.hash import murmur3_rows, partition_ids
from ..plan.logical import SortOrder
from ..plan.physical import Exec, ExecContext, PartitionSet
from ..types import NullType, Schema, StringType, StructField
from ..xp import NUMPY
from . import cpu_kernels as ck


class _HostVals:
    """A host batch's columns as expression values, each converted when an
    expression first reads it: a string column becomes Python objects only
    if the query touches it."""

    def __init__(self, rb: HostBatch):
        self._rb = rb
        self._vals: dict = {}

    def __getitem__(self, i: int) -> Val:
        v = self._vals.get(i)
        if v is None:
            v = self._vals[i] = Val(*np_from_host(self._rb.column(i)))
        return v

    def __len__(self) -> int:
        return len(self._rb.columns)


def _cpu_ctx(rb: HostBatch, schema: Schema) -> Ctx:
    return Ctx(NUMPY, rb.num_rows, False, _HostVals(rb))


def _val_to_np(ctx: Ctx, val) -> tuple[np.ndarray, np.ndarray]:
    data = val.data
    if not isinstance(data, np.ndarray) or data.ndim == 0:
        data = np.broadcast_to(np.asarray(data), (ctx.n,)).copy()
    valid = val.valid
    if not isinstance(valid, np.ndarray) or np.ndim(valid) == 0:
        valid = np.broadcast_to(np.asarray(valid, dtype=bool), (ctx.n,)).copy()
    return data, valid.astype(bool)


class CpuScanExec(Exec):
    """In-memory table scan (LocalRelation) over one ``HostBatch``.
    ``source`` is the batch the user gave, before column pruning: the
    session's upload cache keys on it."""

    def __init__(
        self, table: HostBatch, schema: Schema, num_partitions: int = 1, source=None
    ):
        super().__init__([])
        self.table = table
        self._schema = schema
        self.num_partitions = num_partitions
        self.source = source if source is not None else table

    @property
    def output(self) -> Schema:
        return self._schema

    def execute(self, ctx: ExecContext) -> PartitionSet:
        n = self.table.num_rows
        parts = []
        per = max(1, -(-n // self.num_partitions))
        for p in range(self.num_partitions):
            lo = min(p * per, n)
            hi = min(lo + per, n)

            def make(lo=lo, hi=hi):
                def it():
                    if hi > lo:
                        yield self.table.slice(lo, hi - lo)

                return it()

            parts.append(make)
        return PartitionSet(parts)

    def node_string(self):
        return f"CpuScan{self._schema.names}"


class CpuRangeExec(Exec):
    """``spark.range()`` — sequence generation (Spark's RangeExec; the
    reference replaces it with GpuRangeExec, basicPhysicalOperators.scala).
    Spark splits the range into ``num_partitions`` contiguous slices."""

    def __init__(self, start: int, end: int, step: int, num_partitions: int):
        super().__init__([])
        from ..types import LONG

        self.start = start
        self.end = end
        self.step = step
        self.num_partitions = max(1, num_partitions)
        self._schema = Schema([StructField("id", LONG, False)])

    @property
    def output(self) -> Schema:
        return self._schema

    def total_rows(self) -> int:
        if self.step == 0:
            raise ValueError("range step cannot be 0")
        n = (self.end - self.start + self.step - (1 if self.step > 0 else -1)) // self.step
        return max(0, n)

    def partition_bounds(self) -> list:
        """[(first_row_index, row_count)] per partition — contiguous slices."""
        n = self.total_rows()
        per = -(-n // self.num_partitions) if n else 0
        out = []
        for p in range(self.num_partitions):
            lo = min(p * per, n)
            hi = min(lo + per, n)
            out.append((lo, hi - lo))
        return out

    def execute(self, ctx: ExecContext) -> PartitionSet:
        from .. import config as cfg
        from ..types import LONG

        batch_rows = cfg.BATCH_SIZE_ROWS.get(ctx.conf)
        start, step, schema = self.start, self.step, self._schema
        parts = []
        for lo, cnt in self.partition_bounds():
            def make(lo=lo, cnt=cnt):
                def it():
                    done = 0
                    while done < cnt:
                        m = min(batch_rows, cnt - done)
                        first = start + (lo + done) * step
                        ids = first + step * np.arange(m, dtype=np.int64)
                        yield HostBatch(schema, [HostColumn(LONG, ids, np.ones(m, bool))], m)
                        done += m

                return it()

            parts.append(make)
        return PartitionSet(parts)

    def node_string(self):
        return f"CpuRange ({self.start}, {self.end}, step={self.step}, splits={self.num_partitions})"


class CpuGenerateExec(Exec):
    """explode/posexplode over arrays and maps (Spark GenerateExec; the
    reference replaces it with GpuGenerateExec.scala). Each input row fans
    out to one output row per element; null/empty collections yield no
    rows (non-outer semantics)."""

    def __init__(self, generator: Expression, out_names: List[str], child: Exec):
        super().__init__([child])
        self.generator = bind(generator, child.output)
        self.out_names = list(out_names)
        self._schema = self._compute_schema(child)

    def _compute_schema(self, child: Exec) -> Schema:
        from ..types import INT, MapType

        g = self.generator
        ct = g.child.data_type
        fields = list(child.output.fields)
        i = 0
        if g.position:
            fields.append(StructField(self.out_names[i], INT, False))
            i += 1
        if isinstance(ct, MapType):
            fields.append(StructField(self.out_names[i], ct.key_type, False))
            fields.append(StructField(self.out_names[i + 1], ct.value_type, True))
        else:
            fields.append(StructField(self.out_names[i], ct.element_type, True))
        return Schema(fields)

    @property
    def output(self) -> Schema:
        return self._schema

    def execute(self, ctx: ExecContext) -> PartitionSet:
        from ..types import INT, MapType

        schema_in = self.children[0].output
        schema_out = self._schema
        g = self.generator
        ct = g.child.data_type
        is_map = isinstance(ct, MapType)

        def fn(it):
            for rb in it:
                c = _cpu_ctx(rb, schema_in)
                v = g.child.eval(c)
                data = c.broadcast(v.data)
                valid = c.broadcast_bool(v.valid)
                take: List[int] = []
                pos: List[int] = []
                elems: List = []
                for i in range(rb.num_rows):
                    if not valid[i] or data[i] is None:
                        continue
                    for j, el in enumerate(data[i]):
                        take.append(i)
                        pos.append(j)
                        elems.append(el)
                base = rb.take(np.asarray(take, dtype=np.int64))
                cols = list(base.columns)
                if g.position:
                    cols.append(HostColumn(INT, np.asarray(pos, dtype=np.int32),
                                           np.ones(len(pos), bool)))
                if is_map:
                    cols.append(column_from_pylist([k for k, _ in elems], ct.key_type))
                    cols.append(column_from_pylist([x for _, x in elems], ct.value_type))
                else:
                    cols.append(column_from_pylist(elems, ct.element_type))
                yield HostBatch(schema_out, cols, len(take))

        return self.children[0].execute(ctx).map_partitions(fn)

    def node_string(self):
        return f"CpuGenerate {self.generator}"


class CpuProjectExec(Exec):
    def __init__(self, exprs: List[Expression], child: Exec):
        super().__init__([child])
        self.exprs = [bind(e, child.output) for e in exprs]
        self._schema = Schema(
            [
                StructField(output_name(e0), e.data_type, e.nullable)
                for e0, e in zip(exprs, self.exprs)
            ]
        )

    @property
    def output(self) -> Schema:
        return self._schema

    def execute(self, ctx: ExecContext) -> PartitionSet:
        child = self.children[0]
        schema_in = child.output
        schema_out = self._schema

        needs_task = any(contains_task_dependent(e) for e in self.exprs)

        def fn(it: Iterator[HostBatch]):
            for rb in it:
                c = _cpu_ctx(rb, schema_in)
                if needs_task:
                    info = task.get_or_create()
                    c.task = task.task_vals(np)
                cols = [_val_to_np(c, e.eval(c)) for e in self.exprs]
                if needs_task:
                    info.advance_rows(rb.num_rows)
                yield batch_from_columns(schema_out, cols)

        return child.execute(ctx).map_partitions(fn)

    def node_string(self):
        return f"CpuProject [{', '.join(map(str, self.exprs))}]"


class CpuFilterExec(Exec):
    def __init__(self, condition: Expression, child: Exec):
        super().__init__([child])
        self.condition = bind(condition, child.output)

    @property
    def output(self) -> Schema:
        return self.children[0].output

    def execute(self, ctx: ExecContext) -> PartitionSet:
        schema_in = self.children[0].output

        needs_task = contains_task_dependent(self.condition)

        def fn(it):
            for rb in it:
                c = _cpu_ctx(rb, schema_in)
                if needs_task:
                    info = task.get_or_create()
                    c.task = task.task_vals(np)
                v = self.condition.eval(c)
                data, valid = _val_to_np(c, v)
                keep = data.astype(bool) & valid
                if needs_task:
                    info.advance_rows(rb.num_rows)
                yield rb.filter(keep)

        return self.children[0].execute(ctx).map_partitions(fn)

    def node_string(self):
        return f"CpuFilter {self.condition}"


class CpuCoalescePartitionsExec(Exec):
    """Merge all partitions into one (used before single-partition ops)."""

    def __init__(self, child: Exec):
        super().__init__([child])

    @property
    def output(self) -> Schema:
        return self.children[0].output

    def execute(self, ctx: ExecContext) -> PartitionSet:
        child_parts = self.children[0].execute(ctx)

        def it():
            for t in child_parts.parts:
                yield from t()

        return PartitionSet([it])


class CpuUnionExec(Exec):
    def __init__(self, children: List[Exec]):
        super().__init__(children)

    @property
    def output(self) -> Schema:
        return self.children[0].output

    def execute(self, ctx: ExecContext) -> PartitionSet:
        parts = []
        for c in self.children:
            parts.extend(c.execute(ctx).parts)
        return PartitionSet(parts)


class CpuShuffleExchangeExec(Exec):
    """Partitioned exchange (CPU path) over the four partitionings:
    hash (murmur3 pmod n), range (sampled radix-word bounds), round-robin,
    single — GpuShuffleExchangeExec + the GpuPartitioning impls."""

    def __init__(self, partitioning, child: Exec):
        super().__init__([child])
        self.partitioning = _bind_partitioning(partitioning, child.output)

    @property
    def num_partitions(self) -> int:
        return self.partitioning.num_partitions

    @property
    def output(self) -> Schema:
        return self.children[0].output

    def _np_word_groups(self, rb: HostBatch, schema: Schema):
        from ..ops.sortkeys import np_column_radix_words

        c = _cpu_ctx(rb, schema)
        groups = []
        for o in self.partitioning.order:
            d, v = _val_to_np(c, o.child.eval(c))
            groups.append(
                np_column_radix_words(
                    o.child.data_type, d, v, None, o.ascending, o.resolved_nulls_first()
                )
            )
        return groups

    def execute(self, ctx: ExecContext) -> PartitionSet:
        from ..plan.partitioning import (
            SAMPLE_PER_BATCH,
            HashPartitioning,
            RangePartitioning,
            RoundRobinPartitioning,
            align_word_groups,
            compute_range_bounds,
            words_partition_ids,
        )

        schema = self.children[0].output
        inputs = self.children[0].execute(ctx)
        nparts = self.num_partitions
        part = self.partitioning
        buckets: list[list[HostBatch]] = [[] for _ in range(nparts)]

        def scatter(rb, pids):
            for p in range(nparts):
                mask = pids == p
                if mask.any():
                    buckets[p].append(rb.filter(mask))

        if isinstance(part, RangePartitioning):
            batches, group_lists = [], []
            for thunk in inputs.parts:
                for rb in thunk():
                    if rb.num_rows == 0:
                        continue
                    batches.append(rb)
                    group_lists.append(self._np_word_groups(rb, schema))
            # align per-batch string word counts (see align_word_groups)
            all_words, _targets = align_word_groups(group_lists, part.order)
            samples = []
            for rb, words in zip(batches, all_words):
                idx = np.arange(0, rb.num_rows, max(1, rb.num_rows // SAMPLE_PER_BATCH))
                samples.append([w[idx] for w in words])
            bounds = None
            if samples:
                sample_words = [
                    np.concatenate([s[i] for s in samples]) for i in range(len(samples[0]))
                ]
                bounds = compute_range_bounds(sample_words, nparts)
            for rb, words in zip(batches, all_words):
                if bounds is None:
                    buckets[0].append(rb)
                else:
                    scatter(rb, words_partition_ids(words, bounds))
        else:
            for pi, thunk in enumerate(inputs.parts):
                offset = 0
                for rb in thunk():
                    if rb.num_rows == 0:
                        continue
                    if isinstance(part, HashPartitioning) and part.keys:
                        c = _cpu_ctx(rb, schema)
                        cols = []
                        for k in part.keys:
                            d, val = _val_to_np(c, k.eval(c))
                            cols.append((k.data_type, d, val, None))
                        h = murmur3_rows(np, cols, rb.num_rows)
                        scatter(rb, partition_ids(np, h, nparts))
                    elif isinstance(part, RoundRobinPartitioning):
                        # deterministic start per input partition (the
                        # reference seeds with the partition index)
                        pids = (pi + offset + np.arange(rb.num_rows)) % nparts
                        offset += rb.num_rows
                        scatter(rb, pids)
                    else:  # single partition
                        buckets[0].append(rb)

        def make(p):
            def it():
                yield from buckets[p]

            return it

        return PartitionSet([make(p) for p in range(nparts)])

    def node_string(self):
        return f"CpuShuffleExchange {self.partitioning} p={self.num_partitions}"


def _bind_partitioning(part, schema: Schema):
    """Bind a partitioning's expressions against the child schema."""
    import dataclasses as _dc

    from ..plan import partitioning as P

    if isinstance(part, P.HashPartitioning):
        return _dc.replace(part, keys=[bind(k, schema) for k in part.keys])
    if isinstance(part, P.RangePartitioning):
        return _dc.replace(
            part,
            order=[
                SortOrder(bind(o.child, schema), o.ascending, o.nulls_first)
                for o in part.order
            ],
        )
    return part


class CpuHashAggregateExec(Exec):
    """Group-by aggregate, one phase (mode: 'partial' | 'final' | 'complete').

    Mirrors the reference's update/merge split (aggregate.scala:345-520):
    partial consumes input rows producing (keys ++ buffers); final consumes
    buffers producing results.
    """

    def __init__(
        self,
        mode: str,
        grouping: List[Expression],
        agg_fns: List[AggregateFunction],
        result_exprs: Optional[List[Expression]],
        result_names: Optional[List[str]],
        child: Exec,
    ):
        super().__init__([child])
        self.mode = mode
        self.grouping = [bind(g, child.output) for g in grouping]
        self.agg_fns = agg_fns  # bound against the ORIGINAL input schema
        self.result_exprs = result_exprs
        self.result_names = result_names
        self._schema = self._compute_schema(child)

    def _compute_schema(self, child: Exec) -> Schema:
        fields = []
        for g in self.grouping:
            fields.append(StructField(output_name(g), g.data_type, g.nullable))
        if self.mode == "partial":
            for i, f in enumerate(self.agg_fns):
                for j, bt in enumerate(f.buffer_types):
                    fields.append(StructField(f"buf{i}_{j}", bt, True))
            return Schema(fields)
        # final/complete: results after evaluate + result projection
        if self.result_exprs is None:
            raise ValueError(f"{self.mode} aggregate needs result expressions")
        out = []
        for name, e in zip(self.result_names, self.result_exprs):
            out.append(StructField(name, e.data_type, e.nullable))
        return Schema(out)

    @property
    def output(self) -> Schema:
        return self._schema

    def execute(self, ctx: ExecContext) -> PartitionSet:
        child = self.children[0]
        schema_in = child.output

        def fn(it):
            batches = list(it)
            rb = concat_batches(schema_in, batches)
            yield self._aggregate(rb, schema_in)

        return child.execute(ctx).map_partitions(fn)

    # ── core ────────────────────────────────────────────────────────────
    def _aggregate(self, rb: HostBatch, schema_in: Schema) -> HostBatch:
        c = _cpu_ctx(rb, schema_in)
        n = rb.num_rows
        key_np = [_val_to_np(c, g.eval(c)) for g in self.grouping]
        encoded = []
        for (d, v), g in zip(key_np, self.grouping):
            encoded.extend(ck.encode_group_key(g.data_type, d, v))
        inv, first_idx = ck.group_inverse(encoded, n)
        if self.grouping:
            num_groups = len(first_idx)
        else:
            num_groups = 1
            inv = np.zeros(n, dtype=np.int64)
        # reduction with no rows: one group with empty-input semantics
        out_cols: list[tuple[np.ndarray, np.ndarray]] = []
        for (d, v) in key_np:
            out_cols.append((d[first_idx], v[first_idx]))
        buffer_vals = []
        for f in self.agg_fns:
            if self.mode in ("partial", "complete"):
                ins = [bind(e, schema_in) for e in f.update_exprs]
                ops = f.update_ops
            else:
                ins = None
                ops = f.merge_ops
            bufs = []
            for j, op in enumerate(ops):
                if ins is not None:
                    d, v = _val_to_np(c, ins[j].eval(c))
                    dt = ins[j].data_type
                else:
                    ord_ = self._buffer_ordinal(f, j)
                    d, v = _val_to_np(c, c.columns[ord_])
                    dt = schema_in[ord_].data_type
                gd, gv = ck.reduce_groups(op, dt, d, v, inv, num_groups)
                bufs.append((gd, gv, dt))
            buffer_vals.append(bufs)
        if self.mode == "partial":
            for bufs in buffer_vals:
                for gd, gv, dt in bufs:
                    out_cols.append((gd, gv))
            return batch_from_columns(self._schema, out_cols)
        # final/complete: evaluate agg fns then result projection
        gctx = Ctx.for_cpu([(d, v) for d, v in out_cols], num_groups)
        agg_results: list[Val] = []
        for f, bufs in zip(self.agg_fns, buffer_vals):
            vals = [Val(gd, gv) for gd, gv, _ in bufs]
            agg_results.append(f.evaluate(gctx, vals))
        res_ctx_cols = [Val(d, v) for d, v in out_cols[: len(self.grouping)]]
        res_ctx_cols.extend(agg_results)
        rctx = Ctx.for_cpu([], num_groups)
        rctx.columns = res_ctx_cols
        final = []
        for e in self.result_exprs:
            final.append(_val_to_np(rctx, e.eval(rctx)))
        return batch_from_columns(self._schema, final)

    def _buffer_ordinal(self, f: AggregateFunction, j: int) -> int:
        base = len(self.grouping)
        for g in self.agg_fns:
            if g is f:
                return base + j
            base += len(g.buffer_types)
        raise KeyError

    def node_string(self):
        return f"CpuHashAggregate({self.mode}) keys={[str(g) for g in self.grouping]} aggs={[str(a) for a in self.agg_fns]}"


def cpu_sort_indices(rb: HostBatch, schema: Schema, order: List[SortOrder]) -> np.ndarray:
    """Stable permutation realizing Spark's sort order over one batch."""
    from ..types import DoubleType, FloatType, StringType

    c = _cpu_ctx(rb, schema)
    n = rb.num_rows
    # build numpy sort keys, last key first (lexsort semantics)
    keys = []
    for o in order:
        d, v = _val_to_np(c, o.child.eval(c))
        dt = o.child.data_type

        if isinstance(dt, StringType):
            enc = np.array(
                [x.encode() if (x is not None and vv) else b"" for x, vv in zip(d, v)],
                dtype=object,
            )
            val_key = enc
        elif isinstance(dt, (FloatType, DoubleType)):
            # signed-int64 total order: NaN (canonical, positive bits)
            # lands above +inf, matching Spark's NaN-greatest ordering
            bits = ck.normalized_float_bits(d)
            val_key = np.where(bits < 0, ~bits ^ np.int64(-(2**63)), bits)
        else:
            val_key = d.astype(np.int64)
        if not o.ascending and val_key.dtype == object:
            # lexsort can't negate bytes; use DENSE ranks so equal
            # values share a rank (keeps ties stable under negation)
            order_idx = np.argsort(val_key, kind="stable")
            sv = val_key[order_idx]
            new_grp = np.ones(n, dtype=np.int64)
            new_grp[1:] = (sv[1:] != sv[:-1]).astype(np.int64)
            dense = np.cumsum(new_grp) - 1
            rank = np.empty(n, dtype=np.int64)
            rank[order_idx] = dense
            val_key = -rank
        elif not o.ascending:
            val_key = -1 - val_key
        nf = o.resolved_nulls_first()
        null_key = np.where(v, 1, 0) if nf else np.where(v, 0, 1)
        # null flag is MORE significant than the value within a column
        keys.append(null_key)
        keys.append(val_key)
    return np.lexsort(keys[::-1])


class CpuSortExec(Exec):
    def __init__(self, order: List[SortOrder], child: Exec):
        super().__init__([child])
        self.order = [
            SortOrder(bind(o.child, child.output), o.ascending, o.nulls_first)
            for o in order
        ]

    @property
    def output(self) -> Schema:
        return self.children[0].output

    def execute(self, ctx: ExecContext) -> PartitionSet:
        schema = self.children[0].output

        def fn(it):
            rb = concat_batches(schema, list(it))
            if rb.num_rows == 0:
                yield rb
                return
            perm = cpu_sort_indices(rb, schema, self.order)
            yield rb.take(perm)

        return self.children[0].execute(ctx).map_partitions(fn)


class CpuTakeOrderedAndProjectExec(Exec):
    """TopN: per-partition sort + slice(n), then merged final sort + slice(n)
    — the reference's GpuTakeOrderedAndProjectExec pattern (limit.scala)."""

    def __init__(self, n: int, order: List[SortOrder], child: Exec):
        super().__init__([child])
        self.n = n
        self.order = [
            SortOrder(bind(o.child, child.output), o.ascending, o.nulls_first)
            for o in order
        ]

    @property
    def output(self) -> Schema:
        return self.children[0].output

    def execute(self, ctx: ExecContext) -> PartitionSet:
        schema = self.children[0].output
        n = self.n

        def topn(it):
            rb = concat_batches(schema, list(it))
            if rb.num_rows == 0:
                return []
            perm = cpu_sort_indices(rb, schema, self.order)[:n]
            return [rb.take(perm)]

        child_parts = self.children[0].execute(ctx)

        def it():
            partials: list[HostBatch] = []
            for t in child_parts.parts:
                partials.extend(topn(t()))
            yield from topn(iter(partials))

        return PartitionSet([it])

    def node_string(self):
        return f"CpuTakeOrderedAndProject n={self.n} [{', '.join(map(str, self.order))}]"


class CpuExpandExec(Exec):
    """Projection-list fan-out: each input row produces one output row per
    projection (reference: GpuExpandExec.scala) — the engine under the
    rewrite of several DISTINCT column sets."""

    def __init__(self, projections: List[List[Expression]], names: List[str], child: Exec):
        super().__init__([child])
        self.projections = [[bind(e, child.output) for e in proj] for proj in projections]
        self._schema = expand_schema(self.projections, names)

    @property
    def output(self) -> Schema:
        return self._schema

    def execute(self, ctx: ExecContext) -> PartitionSet:
        schema_in = self.children[0].output
        schema_out = self._schema

        def fn(it):
            for rb in it:
                c = _cpu_ctx(rb, schema_in)
                for proj in self.projections:
                    cols = []
                    for e, f in zip(proj, schema_out):
                        d, v = _val_to_np(c, e.eval(c))
                        if not isinstance(f.data_type, StringType) and d.dtype != f.data_type.np_dtype:
                            d = d.astype(f.data_type.np_dtype)
                        cols.append((d, v))
                    yield batch_from_columns(schema_out, cols)

        return self.children[0].execute(ctx).map_partitions(fn)

    def node_string(self):
        return f"CpuExpand x{len(self.projections)}"


def expand_schema(projections: List[List[Expression]], names: List[str]) -> Schema:
    """An Expand's output: each column takes the first non-NULL type among
    its projections, and is nullable if any projection's is."""
    fields = []
    for i, name in enumerate(names):
        es = [proj[i] for proj in projections]
        dt = next(
            (e.data_type for e in es if not isinstance(e.data_type, NullType)),
            es[0].data_type,
        )
        fields.append(StructField(name, dt, any(e.nullable for e in es)))
    return Schema(fields)


class CpuLimitExec(Exec):
    """CollectLimit: single partition, first n rows."""

    def __init__(self, n: int, child: Exec):
        super().__init__([child])
        self.n = n

    @property
    def output(self) -> Schema:
        return self.children[0].output

    def execute(self, ctx: ExecContext) -> PartitionSet:
        child_parts = self.children[0].execute(ctx)

        def it():
            remaining = self.n
            for t in child_parts.parts:
                for rb in t():
                    if remaining <= 0:
                        return
                    if rb.num_rows > remaining:
                        rb = rb.slice(0, remaining)
                    remaining -= rb.num_rows
                    yield rb

        return PartitionSet([it])
