"""Device physical operators — the GpuExec family, in torch.

The port of ``spark_rapids_tpu/exec/tpu.py``, with the upstream
spark-rapids names: the transitions (``HostToDeviceExec``,
``DeviceToHostExec``), ``GpuCoalesceBatchesExec``, ``GpuProjectExec``,
``GpuFilterExec``, ``GpuHashAggregateExec`` (ungrouped; its filter-fusion
decision is the JAX package's ``_fused_child``) and
``GpuCoalescePartitionsExec``.

Eager torch runs each operator's expression tree as it comes — there is no
per-shape program to compile — so the JAX package's kernel cache, compile
guards, upload cache, OOM retry, ledger and pipelining have no counterpart
here yet. The expression library evaluates against the batch's torch
namespace (``xp.py``), and string search runs the hand-written kernel of
``ops/strings_kernels.py``.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from ..columnar.device import (
    MIN_CAPACITY,
    DeviceBatch,
    DeviceColumn,
    dc_replace,
    device_to_host,
    empty_batch,
    host_to_device,
)
from ..expr import Expression, bind, output_name
from ..expr.aggregates import AggregateFunction
from ..expr.base import Ctx, Val
from ..ops.aggregate import ungrouped_aggregate
from ..ops.gather import compact, concat_device
from ..plan.physical import Exec, ExecContext, PartitionSet
from ..types import Schema, StringType, StructField
from ..xp import torch_dtype


def val_to_column(ctx: Ctx, val: Val, dtype) -> DeviceColumn:
    """Materialize an expression result into a full DeviceColumn."""
    xp = ctx.xp
    if isinstance(dtype, StringType):
        data = xp.asarray(val.data)
        if data.ndim == 1:  # scalar string literal [w]
            data = xp.broadcast_to(data[None, :], (ctx.n, data.shape[0]))
        lengths = xp.broadcast_to(xp.asarray(val.lengths, dtype=xp.int32), (ctx.n,))
        return DeviceColumn(
            dtype, data.contiguous(), val.full_valid(ctx).contiguous(), lengths.contiguous()
        )
    data = ctx.broadcast(val.data)
    want = torch_dtype(dtype.np_dtype)
    if data.dtype != want:
        data = data.to(want)
    return DeviceColumn(dtype, data.contiguous(), val.full_valid(ctx).contiguous())


# ── transitions ─────────────────────────────────────────────────────────────


def _row_bytes(schema: Schema) -> int:
    """Rough per-row device footprint for batch-size targeting (the JAX
    package's estimate, so both engines cut the same chunks)."""
    total = 0
    for f in schema:
        dt = f.data_type
        if isinstance(dt, StringType):
            total += 64  # padded bytes + lengths, typical bucket
        else:
            try:
                total += dt.np_dtype.itemsize
            except Exception:
                total += 16
        total += 1  # validity
    return max(total, 1)


class HostToDeviceExec(Exec):
    """Host batches → device batches (HostColumnarToGpu analogue).

    Incoming batches are re-chunked to ``spark.rapids.sql.batchSizeBytes``
    (the CoalesceGoal TargetSize contract — GpuExec.scala:173-188) so one
    oversized host batch cannot blow the device working set."""

    def __init__(self, child: Exec):
        super().__init__([child])

    @property
    def output(self) -> Schema:
        return self.children[0].output

    @property
    def is_device(self) -> bool:
        return True

    def execute(self, ctx: ExecContext) -> PartitionSet:
        from .. import config as cfg

        schema = self.output
        max_rows = max(1, cfg.BATCH_SIZE_BYTES.get(ctx.conf) // _row_bytes(schema))
        max_str = cfg.STRING_MAX_BYTES.get(ctx.conf)
        device = ctx.device

        def fn(it):
            for rb in it:
                if rb.num_rows == 0:
                    continue
                for off in range(0, rb.num_rows, max_rows):
                    chunk = rb if rb.num_rows <= max_rows else rb.slice(off, max_rows)
                    yield host_to_device(chunk, device, max_str_bytes=max_str)

        return self.children[0].execute(ctx).map_partitions(fn)


class DeviceToHostExec(Exec):
    """Device batches → host batches (GpuColumnarToRow/GpuBringBackToHost)."""

    def __init__(self, child: Exec):
        super().__init__([child])

    @property
    def output(self) -> Schema:
        return self.children[0].output

    def execute(self, ctx: ExecContext) -> PartitionSet:
        def fn(it):
            for db in it:
                hb = device_to_host(db)
                if hb.num_rows:
                    yield hb

        return self.children[0].execute(ctx).map_partitions(fn)


class CoalesceGoal:
    """Batching contract (CoalesceGoal): a negative target is
    RequireSingleBatch, else TargetSize in bytes."""

    __slots__ = ("target_bytes",)

    def __init__(self, target_bytes: int):
        self.target_bytes = target_bytes

    def __repr__(self):
        if self.target_bytes < 0:
            return "RequireSingleBatch"
        return f"TargetSize({self.target_bytes})"


class GpuCoalesceBatchesExec(Exec):
    """Concatenate undersized device batches up to the goal before handing
    them to the parent (GpuCoalesceBatches' Table.concatenate accumulation
    loop :133-455)."""

    def __init__(self, child: Exec, goal: CoalesceGoal):
        super().__init__([child])
        self.goal = goal

    @property
    def output(self) -> Schema:
        return self.children[0].output

    @property
    def is_device(self) -> bool:
        return True

    def execute(self, ctx: ExecContext) -> PartitionSet:
        goal = self.goal

        def fn(it):
            acc: list = []
            acc_bytes = 0
            for db in it:
                sz = db.size_bytes()
                if goal.target_bytes >= 0 and acc and acc_bytes + sz > goal.target_bytes:
                    yield concat_device(acc)
                    acc, acc_bytes = [], 0
                acc.append(db)
                acc_bytes += sz
            if acc:
                yield concat_device(acc)

        return self.children[0].execute(ctx).map_partitions(fn)

    def node_string(self):
        return f"GpuCoalesceBatches {self.goal!r}"


# ── project / filter ────────────────────────────────────────────────────────


def project_fn(exprs: tuple, schema: Schema):
    """The projection of one device batch (the JAX package's
    ``project_kernel``)."""

    def _project(batch: DeviceBatch):
        c = Ctx.for_device(batch)
        cols = [val_to_column(c, e.eval(c), e.data_type) for e in exprs]
        # keep padding rows inert
        live = batch.row_mask()
        cols = [dc_replace(col, validity=col.validity & live) for col in cols]
        return DeviceBatch(schema, cols, batch.num_rows)

    return _project


def filter_fn(condition: Expression):
    """The filter of one device batch: evaluate, then compact (the JAX
    package's ``filter_kernel``)."""

    def _filter(batch: DeviceBatch):
        c = Ctx.for_device(batch)
        v = condition.eval(c)
        keep = c.broadcast_bool(v.data) & v.full_valid(c)
        return compact(batch, keep)

    return _filter


class GpuProjectExec(Exec):
    def __init__(
        self,
        exprs: List[Expression],
        child: Exec,
        schema: Optional[Schema] = None,
    ):
        super().__init__([child])
        self.exprs = [bind(e, child.output) for e in exprs]
        # converted plans pass the CPU exec's schema: their exprs are already
        # bound, so output_name() would yield colN placeholders
        self._schema = schema or Schema(
            [
                StructField(output_name(e0), e.data_type, e.nullable)
                for e0, e in zip(exprs, self.exprs)
            ]
        )

    @property
    def output(self) -> Schema:
        return self._schema

    @property
    def is_device(self) -> bool:
        return True

    def execute(self, ctx: ExecContext) -> PartitionSet:
        fn = project_fn(tuple(self.exprs), self._schema)
        return self.children[0].execute(ctx).map_partitions(lambda it: map(fn, it))

    def node_string(self):
        return f"GpuProject [{', '.join(map(str, self.exprs))}]"


class GpuFilterExec(Exec):
    def __init__(self, condition: Expression, child: Exec):
        super().__init__([child])
        self.condition = bind(condition, child.output)

    @property
    def output(self) -> Schema:
        return self.children[0].output

    @property
    def is_device(self) -> bool:
        return True

    def execute(self, ctx: ExecContext) -> PartitionSet:
        fn = filter_fn(self.condition)
        return self.children[0].execute(ctx).map_partitions(lambda it: map(fn, it))

    def node_string(self):
        return f"GpuFilter {self.condition}"


class GpuCoalescePartitionsExec(Exec):
    """All child partitions into one, in partition order."""

    def __init__(self, child: Exec):
        super().__init__([child])

    @property
    def output(self) -> Schema:
        return self.children[0].output

    @property
    def is_device(self) -> bool:
        return True

    def execute(self, ctx: ExecContext) -> PartitionSet:
        child_parts = self.children[0].execute(ctx)

        def it():
            for t in child_parts.parts:
                yield from t()

        return PartitionSet([it])


# ── aggregate ───────────────────────────────────────────────────────────────


def _buffer_ordinal(agg_fns, f: AggregateFunction, j: int) -> int:
    """Ordinal of buffer ``j`` of ``f`` in the (keyless) buffers layout."""
    base = 0
    for g in agg_fns:
        if g is f:
            return base + j
        base += len(g.buffer_types)
    raise KeyError


def aggregate_fn(
    mode: str,
    agg_fns: tuple,
    result_exprs,
    out_schema: Schema,
    child_schema: Schema,
    pre_filter: Optional[Expression] = None,
):
    """The ungrouped aggregate of one device batch (update or
    merge+evaluate) — the keyless case of the JAX package's
    ``aggregate_kernel``. ``pre_filter`` folds a child filter's predicate in
    as a liveness mask: no compaction between the filter and the aggregate."""

    def _aggregate(batch: DeviceBatch) -> DeviceBatch:
        c = Ctx.for_device(batch)
        xp = c.xp
        live = batch.row_mask()
        if pre_filter is not None:
            fv = pre_filter.eval(c)
            live = live & c.broadcast_bool(fv.data) & fv.full_valid(c)
        in_cols: list = []
        ops: list = []
        for f in agg_fns:
            if mode in ("partial", "complete"):
                exprs = [bind(e, child_schema) for e in f.update_exprs]
                for e, op in zip(exprs, f.update_ops):
                    in_cols.append(val_to_column(c, e.eval(c), e.data_type))
                    ops.append(op)
            else:
                for j, op in enumerate(f.merge_ops):
                    in_cols.append(batch.columns[_buffer_ordinal(agg_fns, f, j)])
                    ops.append(op)
        out_aggs = ungrouped_aggregate(in_cols, ops, live, MIN_CAPACITY)
        num_groups = torch.ones((), dtype=torch.int32, device=batch.device)
        if mode == "partial":
            return DeviceBatch(out_schema, out_aggs, num_groups)
        # final/complete: evaluate aggregates + result projection
        agg_results: list = []
        i = 0
        gctx = Ctx(xp, MIN_CAPACITY, True, [], num_groups)
        for f in agg_fns:
            nbuf = len(f.buffer_types)
            bufs = [
                Val(out_aggs[i + j].data, out_aggs[i + j].validity, out_aggs[i + j].lengths)
                for j in range(nbuf)
            ]
            agg_results.append(f.evaluate(gctx, bufs))
            i += nbuf
        rctx = Ctx(xp, MIN_CAPACITY, True, agg_results, num_groups)
        glive = torch.arange(MIN_CAPACITY, device=batch.device) < 1
        cols = []
        for e in result_exprs:
            col = val_to_column(rctx, e.eval(rctx), e.data_type)
            cols.append(dc_replace(col, validity=col.validity & glive))
        return DeviceBatch(out_schema, cols, num_groups)

    return _aggregate


class GpuHashAggregateExec(Exec):
    """Aggregation on the device, one phase (partial|final|complete). This
    slice of the port runs the ungrouped case; the overrides keep grouped
    aggregation on the CPU engine."""

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
        if grouping:
            raise NotImplementedError("grouped aggregation is not in the torch port yet")
        self.mode = mode
        self.agg_fns = list(agg_fns)
        self.result_exprs = None if result_exprs is None else list(result_exprs)
        self.result_names = None if result_names is None else list(result_names)
        self._schema = self._compute_schema()

    def _compute_schema(self) -> Schema:
        if self.mode == "partial":
            fields = []
            for i, f in enumerate(self.agg_fns):
                for j, bt in enumerate(f.buffer_types):
                    fields.append(StructField(f"buf{i}_{j}", bt, True))
            return Schema(fields)
        return Schema(
            [
                StructField(name, e.data_type, e.nullable)
                for name, e in zip(self.result_names, self.result_exprs)
            ]
        )

    @property
    def output(self) -> Schema:
        return self._schema

    @property
    def is_device(self) -> bool:
        return True

    def _fused_child(self) -> tuple:
        """(effective child, fused pre_filter) — the JAX package's
        filter-fusion decision (``exec/tpu.py`` ``_fused_child``): a child
        filter's predicate folds into the aggregate as a liveness mask, and
        the compaction gather of every column is skipped. The JAX package
        keeps filters with task-dependent or error-raising expressions
        standalone; the port's overrides keep those off the device."""
        child = self.children[0]
        if self.mode in ("partial", "complete") and isinstance(child, GpuFilterExec):
            return child.children[0], child.condition
        return child, None

    def execute(self, ctx: ExecContext) -> PartitionSet:
        child, pre_filter = self._fused_child()
        child_schema = child.output
        fn = aggregate_fn(
            self.mode,
            tuple(self.agg_fns),
            None if self.result_exprs is None else tuple(self.result_exprs),
            self._schema,
            child_schema,
            pre_filter,
        )
        device = ctx.device

        def run(it):
            # one update (or merge + evaluate) over the whole partition, as
            # the JAX package's final/complete path does
            batches = list(it)
            if not batches:
                batches = [empty_batch(child_schema, device)]
            yield fn(concat_device(batches))

        return child.execute(ctx).map_partitions(run)

    def node_string(self):
        return (
            f"GpuHashAggregate({self.mode}) keys=[] "
            f"aggs={[str(a) for a in self.agg_fns]}"
        )
