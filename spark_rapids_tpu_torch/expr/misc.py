"""Hash + task-context expressions.

Reference: HashFunctions.scala (GpuMurmur3Hash, GpuMd5),
GpuSparkPartitionID.scala, GpuMonotonicallyIncreasingID.scala,
GpuInputFileBlock.scala (input_file_name), GpuRand in mathExpressions group,
NormalizeFloatingNumbers.scala (NormalizeNaNAndZero).

Task-dependent expressions (``TaskDependent``) read ``Ctx.task`` — a
``TaskVals`` pytree of *traced* device scalars sampled per batch from the
thread-local task context (see exec/task.py). That keeps the compiled kernel
pure while matching Spark's TaskContext-thread-local design.

Copied from ``spark_rapids_tpu/expr/misc.py``.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Tuple

import numpy as np

from ..ops.hash import DEFAULT_SEED, hash_long, murmur3_rows
from ..ops.md5 import md5_padded
from ..types import (
    DataType,
    DoubleType,
    INT,
    LONG,
    STRING,
    StringType,
    DOUBLE,
)
from ..xp import is_torch
from .base import Ctx, Expression, UnaryExpression, Val


class TaskDependent:
    """Marker: evaluation reads per-task state (Spark's Nondeterministic —
    requires ``Ctx.task`` to be populated by the enclosing operator)."""


def contains_task_dependent(e: Expression) -> bool:
    if isinstance(e, TaskDependent):
        return True
    return any(contains_task_dependent(c) for c in e.children())


def _require_task(ctx: Ctx, what: str):
    if ctx.task is None:
        raise RuntimeError(
            f"{what} requires task context (only supported in project/filter)"
        )
    return ctx.task


def _child_cols(ctx: Ctx, vals):
    """Normalize child Vals for the row hasher: full data/valid plus padded
    string handling for both backends."""
    cols = []
    for dt, v in vals:
        if isinstance(dt, StringType):
            if ctx.is_device:
                data = v.data
                if data.ndim == 1:  # scalar string literal [w]
                    data = ctx.xp.broadcast_to(data[None, :], (ctx.n, data.shape[0]))
                lengths = ctx.xp.broadcast_to(ctx.xp.asarray(v.lengths), (ctx.n,))
                cols.append((dt, data, v.full_valid(ctx), lengths))
            else:
                data = np.broadcast_to(np.asarray(v.data, dtype=object), (ctx.n,))
                cols.append((dt, data, v.full_valid(ctx), None))
        else:
            cols.append((dt, v.full_data(ctx), v.full_valid(ctx), None))
    return cols


@dataclass(frozen=True)
class Murmur3Hash(Expression):
    """Spark's ``hash(...)`` — murmur3_x86_32 folded across columns, seed 42.

    Reference: HashFunctions.scala GpuMurmur3Hash; device kernel ops/hash.py.
    """

    exprs: Tuple[Expression, ...]
    seed: int = DEFAULT_SEED

    @property
    def data_type(self) -> DataType:
        return INT

    @property
    def nullable(self) -> bool:
        return False

    def eval(self, ctx: Ctx) -> Val:
        vals = [(e.data_type, e.eval(ctx)) for e in self.exprs]
        cols = _child_cols(ctx, vals)
        h = murmur3_rows(ctx.xp, cols, ctx.n, seed=self.seed)  # int32 in both paths
        return Val(h, ctx.xp.asarray(True))


@dataclass(frozen=True)
class Md5(Expression):
    """``md5(str)`` → 32-char lowercase hex. Reference: GpuMd5 (cudf device
    MD5); device kernel ops/md5.py over the padded-string layout.

    Spark's md5 takes binary; this engine has no BinaryType, so the utf-8
    bytes of the string are hashed — equal to ``md5(cast(s as binary))``.
    """

    child: Expression

    @property
    def data_type(self) -> DataType:
        return STRING

    @property
    def nullable(self) -> bool:
        return self.child.nullable

    def eval(self, ctx: Ctx) -> Val:
        v = self.child.eval(ctx)
        xp = ctx.xp
        if ctx.is_device:
            data = v.data
            if data.ndim == 1:
                data = xp.broadcast_to(data[None, :], (ctx.n, data.shape[0]))
            lengths = xp.broadcast_to(xp.asarray(v.lengths), (ctx.n,))
            out, out_len = md5_padded(xp, data, lengths)
            return Val(out, v.full_valid(ctx), out_len)
        data = np.broadcast_to(np.asarray(v.data, dtype=object), (ctx.n,))
        valid = v.full_valid(ctx)
        out = np.empty(ctx.n, dtype=object)
        for i in range(ctx.n):
            if valid[i] and data[i] is not None:
                out[i] = hashlib.md5(str(data[i]).encode("utf-8")).hexdigest()
            else:
                out[i] = None
        return Val(out, valid)


@dataclass(frozen=True)
class SparkPartitionID(Expression, TaskDependent):
    """``spark_partition_id()`` — reference: GpuSparkPartitionID.scala."""

    @property
    def data_type(self) -> DataType:
        return INT

    @property
    def nullable(self) -> bool:
        return False

    def eval(self, ctx: Ctx) -> Val:
        t = _require_task(ctx, "spark_partition_id()")
        return Val(ctx.xp.asarray(t.part_id, dtype=ctx.xp.int32), ctx.xp.asarray(True))

    def __str__(self):
        return "SPARK_PARTITION_ID()"


@dataclass(frozen=True)
class MonotonicallyIncreasingID(Expression, TaskDependent):
    """``monotonically_increasing_id()`` = (partition_id << 33) + row offset.

    Reference: GpuMonotonicallyIncreasingID.scala. The row offset is the
    running live-row count of this operator's input stream (row_base) plus the
    row's position; rows are prefix-compacted so positions are ``arange``.
    """

    @property
    def data_type(self) -> DataType:
        return LONG

    @property
    def nullable(self) -> bool:
        return False

    def eval(self, ctx: Ctx) -> Val:
        xp = ctx.xp
        t = _require_task(ctx, "monotonically_increasing_id()")
        base = (xp.asarray(t.part_id, dtype=xp.int64) << np.int64(33)) + xp.asarray(
            t.row_base, dtype=xp.int64
        )
        ids = base + xp.arange(ctx.n, dtype=xp.int64)
        return Val(ids, xp.asarray(True))

    def __str__(self):
        return "monotonically_increasing_id()"


@dataclass(frozen=True)
class InputFileName(Expression, TaskDependent):
    """``input_file_name()`` — reference: GpuInputFileBlock.scala reading
    InputFileBlockHolder. The scan sets the current path into the task
    context; it reaches the kernel as padded utf-8 bytes in TaskVals."""

    @property
    def data_type(self) -> DataType:
        return STRING

    @property
    def nullable(self) -> bool:
        return False

    def eval(self, ctx: Ctx) -> Val:
        xp = ctx.xp
        t = _require_task(ctx, "input_file_name()")
        if ctx.is_device:
            return Val(
                xp.asarray(t.file_bytes, dtype=xp.uint8),
                xp.asarray(True),
                xp.asarray(t.file_len, dtype=xp.int32),
            )
        raw = bytes(np.asarray(t.file_bytes, dtype=np.uint8))[: int(t.file_len)]
        return Val(np.asarray(raw.decode("utf-8"), dtype=object), np.asarray(True))

    def __str__(self):
        return "input_file_name()"


class _InputFileBlockField(Expression, TaskDependent):
    """Base of ``input_file_block_start()``/``_length()`` — reference:
    GpuInputFileBlockStart/Length (GpuInputFileBlock.scala, rule rows
    GpuOverrides.scala:2138). Reads the InputFileBlockHolder analogue from
    TaskVals; -1 outside a scan, exactly like Spark."""

    @property
    def data_type(self) -> DataType:
        from ..types import LONG

        return LONG

    @property
    def nullable(self) -> bool:
        return False

    def eval(self, ctx: Ctx) -> Val:
        xp = ctx.xp
        t = _require_task(ctx, str(self))
        return Val(xp.asarray(self._field(t), dtype=xp.int64), xp.asarray(True))


@dataclass(frozen=True)
class InputFileBlockStart(_InputFileBlockField):
    _field = staticmethod(lambda t: t.block_start)

    def __str__(self):
        return "input_file_block_start()"


@dataclass(frozen=True)
class InputFileBlockLength(_InputFileBlockField):
    _field = staticmethod(lambda t: t.block_length)

    def __str__(self):
        return "input_file_block_length()"


@dataclass(frozen=True)
class Rand(Expression, TaskDependent):
    """``rand(seed)`` — uniform [0, 1) doubles.

    Reference: GpuRand (mathExpressions rule group). Deterministic given
    (seed, partition, row index) via a counter-based murmur-mix generator —
    NOT bit-identical to Spark's per-partition XORShiftRandom stream, so the
    rule is gated behind ``spark.rapids.sql.incompatibleOps.enabled`` exactly
    like the reference gates its RNG.
    """

    seed: int = 0

    @property
    def data_type(self) -> DataType:
        return DOUBLE

    @property
    def nullable(self) -> bool:
        return False

    def eval(self, ctx: Ctx) -> Val:
        xp = ctx.xp
        t = _require_task(ctx, "rand()")
        idx = xp.asarray(t.row_base, dtype=xp.int64) + xp.arange(ctx.n, dtype=xp.int64)
        if is_torch(xp):
            # torch has no uint32 + or >> on uint64: the same mixing in
            # int64 lanes masked to 32 bits, as ops/hash.py does
            m = 0xFFFFFFFF
            pid = xp.asarray(t.part_id, dtype=xp.int64) & m
            s1 = (self.seed & m) ^ ((pid * 0x9E3779B9) & m)
            s2 = (s1 + 0x85EBCA6B) & m
            s1 = s1.reshape(-1).expand(ctx.n)
            s2 = s2.reshape(-1).expand(ctx.n)
            hi = (hash_long(xp, idx, s1) >> 5).to(xp.float64)  # 27 bits
            lo = (hash_long(xp, idx, s2) >> 6).to(xp.float64)  # 26 bits
            u = (hi * float(1 << 26) + lo) * (1.0 / (1 << 53))
            return Val(u, xp.asarray(True))
        pid = xp.asarray(t.part_id, dtype=xp.uint32)
        s1 = xp.astype(xp.asarray(np.uint32(self.seed & 0xFFFFFFFF)) ^ (pid * np.uint32(0x9E3779B9)), xp.uint32)
        s2 = xp.astype(s1 + np.uint32(0x85EBCA6B), xp.uint32)
        a = xp.astype(hash_long(xp, idx, s1), xp.uint32)
        b = xp.astype(hash_long(xp, idx, s2), xp.uint32)
        hi = xp.astype(a >> np.uint32(5), xp.float64)  # 27 bits
        lo = xp.astype(b >> np.uint32(6), xp.float64)  # 26 bits
        u = (hi * np.float64(1 << 26) + lo) * np.float64(1.0 / (1 << 53))
        return Val(u, xp.asarray(True))

    def __str__(self):
        return f"rand({self.seed})"


@dataclass(frozen=True)
class NormalizeNaNAndZero(UnaryExpression):
    """Canonicalize NaN bit patterns and -0.0 → 0.0 before grouping/joining —
    reference: NormalizeFloatingNumbers.scala."""

    c: Expression

    @property
    def data_type(self) -> DataType:
        return self.c.data_type

    def _compute(self, ctx: Ctx, data):
        xp = ctx.xp
        is_double = isinstance(self.c.data_type, DoubleType)
        nan = np.float64(np.nan) if is_double else np.float32(np.nan)
        data = xp.where(data == 0, xp.zeros_like(data), data)
        return xp.where(xp.isnan(data), xp.asarray(nan), data)
