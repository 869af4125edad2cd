"""Expression IR — the analogue of the reference's expression library plus the
Catalyst expressions it wraps (reference: GpuOverrides.scala ~260 expr rules,
GpuBoundAttribute.scala, literals.scala, namedExpressions.scala).

Design, TPU-first:

* Expressions are **frozen dataclasses**, hashable by structure. A bound
  expression tree is the compile-cache key for the jitted kernel that
  evaluates it — the analogue of cudf's pre-compiled kernel dispatch.
* One evaluation implementation serves both backends: ``Ctx.xp`` is either
  ``numpy`` (CPU fallback operators + differential-test oracle) or the torch
  namespace of ``xp.py`` (device). Spark semantics (null propagation, Java
  wraparound, NaN ordering, div-by-zero→null) are implemented explicitly so
  both backends agree bit-for-bit with CPU Spark. Code on the device path
  casts with ``xp.astype(x, t)``: torch tensors have no ``.astype``.
* Values are (data, validity) pairs with lazy scalar broadcasting.

Name resolution: the DataFrame/logical layer produces ``UnresolvedAttribute``;
``bind()`` resolves names against a schema into ``BoundReference`` (ordinal) —
the analogue of ``GpuBindReferences``.

Copied from ``spark_rapids_tpu/expr/base.py``; ``Ctx.for_device`` and the
broadcast helpers are rewritten for torch.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional, Sequence, Union

import numpy as np

from ..types import (
    BOOLEAN,
    DOUBLE,
    BooleanType,
    DataType,
    DecimalType,
    FractionalType,
    IntegralType,
    LONG,
    NullType,
    Schema,
    StringType,
    TimestampType,
    DateType,
    numeric_promote,
)


class AnsiError(ArithmeticError):
    """Raised when an ANSI-mode expression (cast overflow, malformed parse)
    hits invalid input — Spark's SparkArithmeticException/DateTimeException
    family under ``spark.sql.ansi.enabled`` (reference: ansiEnabled branches
    in GpuCast.scala and AnsiCastOpSuite)."""


@dataclass
class Val:
    """An evaluation result: data + validity, each either scalar or length-n.

    Device strings carry ``lengths`` (see columnar.device); CPU strings use an
    object ndarray in ``data`` with ``lengths is None``. Device complex values
    (array/struct/map) carry ``children`` — nested DeviceColumn planes — with
    ``data`` None; the CPU engine stores python objects in ``data`` instead.
    """

    data: Any
    valid: Any
    lengths: Any = None
    children: Any = None  # tuple[DeviceColumn] for device complex values

    def full_data(self, ctx: "Ctx"):
        return ctx.broadcast(self.data)

    def full_valid(self, ctx: "Ctx"):
        return ctx.broadcast_bool(self.valid)


class Ctx:
    """Evaluation context over one batch for one backend."""

    def __init__(self, xp, n: int, is_device: bool, columns, num_rows=None, task=None):
        self.xp = xp
        self.n = n  # capacity (device) or row count (cpu)
        self.is_device = is_device
        self.columns = columns  # list of Val
        self.num_rows = num_rows  # device scalar when is_device
        self.task = task  # TaskVals (traced) for task-dependent expressions
        # ANSI error sites: (message, per-row bool mask) accumulated during
        # device tracing; the project/filter kernels return the masked
        # any-flags and the exec raises AnsiError host-side after the run
        self.errors: list = []
        # rows for which the currently-evaluating expression is actually
        # selected (vectorized eval runs ALL conditional branches; Spark
        # evaluates per-row, so errors in untaken branches must not fire)
        self._err_mask = None

    def error_scope(self, mask):
        """Context manager: AND ``mask`` into the branch-liveness mask that
        gates ANSI error sites (If/CaseWhen/Coalesce branch evaluation)."""
        from contextlib import contextmanager

        @contextmanager
        def scope():
            prev = self._err_mask
            m = self.broadcast_bool(mask)
            self._err_mask = m if prev is None else (prev & m)
            try:
                yield
            finally:
                self._err_mask = prev

        return scope()

    def register_error(self, message: str, row_mask) -> None:
        row_mask = self.broadcast_bool(row_mask)
        if self._err_mask is not None:
            row_mask = row_mask & self._err_mask
        if self.is_device:
            self.errors.append((message, row_mask))
        else:
            if bool(np.any(row_mask)):
                raise AnsiError(message)

    def broadcast(self, data):
        xp = self.xp
        arr = xp.asarray(data)
        if arr.ndim == 0:
            return xp.broadcast_to(arr, (self.n,))
        return arr

    def broadcast_bool(self, v):
        xp = self.xp
        arr = xp.asarray(v)
        if arr.ndim == 0:
            return xp.broadcast_to(xp.astype(arr, bool), (self.n,))
        return xp.astype(arr, bool)

    @staticmethod
    def for_device(batch, task=None) -> "Ctx":
        from ..xp import namespace

        cols = [
            Val(c.data, c.validity, c.lengths, c.children) for c in batch.columns
        ]
        return Ctx(
            namespace(batch.device), batch.capacity, True, cols, batch.num_rows, task
        )

    @staticmethod
    def for_cpu(columns: list[tuple[np.ndarray, np.ndarray]], n: int, task=None) -> "Ctx":
        from ..xp import NUMPY

        cols = [Val(d, v) for d, v in columns]
        return Ctx(NUMPY, n, False, cols, task=task)


@dataclass(frozen=True)
class Expression:
    """Base class. Subclasses are frozen dataclasses; children are fields."""

    def children(self) -> Sequence["Expression"]:
        vals = []
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, Expression):
                vals.append(v)
            elif isinstance(v, tuple):
                for x in v:
                    if isinstance(x, Expression):
                        vals.append(x)
                    elif isinstance(x, tuple):
                        vals.extend(y for y in x if isinstance(y, Expression))
        return vals

    @property
    def data_type(self) -> DataType:
        raise NotImplementedError(type(self).__name__)

    @property
    def nullable(self) -> bool:
        return True

    def eval(self, ctx: Ctx) -> Val:
        raise NotImplementedError(type(self).__name__)

    # pretty printing
    def __str__(self) -> str:
        args = ", ".join(str(c) for c in self.children())
        return f"{type(self).__name__.lower()}({args})"


@dataclass(frozen=True)
class UnresolvedAttribute(Expression):
    name: str

    @property
    def data_type(self) -> DataType:
        raise TypeError(f"unresolved attribute '{self.name}' has no type")

    def __str__(self):
        return f"'{self.name}"


@dataclass(frozen=True)
class BoundReference(Expression):
    ordinal: int
    dtype: DataType
    _nullable: bool = True

    @property
    def data_type(self) -> DataType:
        return self.dtype

    @property
    def nullable(self) -> bool:
        return self._nullable

    def eval(self, ctx: Ctx) -> Val:
        return ctx.columns[self.ordinal]

    def __str__(self):
        return f"input[{self.ordinal}, {self.dtype}]"


@dataclass(frozen=True)
class Literal(Expression):
    value: Any
    dtype: DataType

    @property
    def data_type(self) -> DataType:
        return self.dtype

    @property
    def nullable(self) -> bool:
        return self.value is None

    def eval(self, ctx: Ctx) -> Val:
        xp = ctx.xp
        if self.value is None:
            if isinstance(self.dtype, StringType):
                if ctx.is_device:
                    from ..columnar.device import MIN_STR_WIDTH

                    return Val(
                        xp.zeros(MIN_STR_WIDTH, dtype=xp.uint8),
                        xp.asarray(False),
                        xp.asarray(0, dtype=xp.int32),
                    )
                return Val(np.asarray(None, dtype=object), np.asarray(False))
            zero = xp.zeros((), dtype=self.dtype.np_dtype)
            return Val(zero, xp.asarray(False))
        if isinstance(self.dtype, StringType):
            raw = self.value.encode("utf-8")
            if ctx.is_device:
                from ..columnar.device import pad_scalar_bytes

                buf, n = pad_scalar_bytes(raw)
                data = xp.asarray(buf)  # [w] — scalar-like string
                return Val(data, xp.asarray(True), xp.asarray(n, dtype=xp.int32))
            return Val(np.asarray(self.value, dtype=object), np.asarray(True))
        if isinstance(self.dtype, DecimalType):
            import decimal as _dec

            unscaled = int(
                _dec.Decimal(self.value).scaleb(self.dtype.scale).to_integral_value()
            )
            return Val(xp.asarray(unscaled, dtype=xp.int64), xp.asarray(True))
        return Val(
            xp.asarray(self.value, dtype=self.dtype.np_dtype), xp.asarray(True)
        )

    def __str__(self):
        return f"{self.value}"


@dataclass(frozen=True)
class Alias(Expression):
    child: Expression
    name: str

    @property
    def data_type(self) -> DataType:
        return self.child.data_type

    @property
    def nullable(self) -> bool:
        return self.child.nullable

    def eval(self, ctx: Ctx) -> Val:
        return self.child.eval(ctx)

    def __str__(self):
        return f"{self.child} AS {self.name}"


def output_name(e: Expression) -> str:
    if isinstance(e, Alias):
        return e.name
    if isinstance(e, UnresolvedAttribute):
        return e.name
    if isinstance(e, BoundReference):
        return f"col{e.ordinal}"
    return str(e)


# ── null-propagation helpers shared by concrete expressions ────────────────


def and_valid(ctx: Ctx, *vs):
    xp = ctx.xp
    out = None
    for v in vs:
        b = xp.astype(xp.asarray(v), bool)
        out = b if out is None else out & b
    return out


class UnaryExpression(Expression):
    """Null-propagating unary op: implement ``_compute(ctx, data)``."""

    @property
    def child(self) -> Expression:  # convention: first dataclass field
        return self.children()[0]

    @property
    def nullable(self) -> bool:
        return self.child.nullable

    def eval(self, ctx: Ctx) -> Val:
        c = self.child.eval(ctx)
        data = self._compute(ctx, c.data)
        return Val(data, c.valid)

    def _compute(self, ctx: Ctx, data):
        raise NotImplementedError


class BinaryExpression(Expression):
    """Null-propagating binary op: implement ``_compute(ctx, l, r)`` which may
    also return (data, extra_valid) to add result-dependent nullability, and
    ``_register_errors`` where the op raises through the ANSI error channel."""

    @property
    def left(self) -> Expression:
        return self.children()[0]

    @property
    def right(self) -> Expression:
        return self.children()[1]

    def eval(self, ctx: Ctx) -> Val:
        l = self.left.eval(ctx)
        r = self.right.eval(ctx)
        out = self._compute(ctx, l.data, r.data)
        if isinstance(out, tuple):
            data, extra = out
            valid = and_valid(ctx, l.valid, r.valid, extra)
        else:
            data = out
            valid = and_valid(ctx, l.valid, r.valid)
        self._register_errors(ctx, l.data, r.data, data, valid)
        return Val(data, valid)

    def _compute(self, ctx: Ctx, l, r):
        raise NotImplementedError

    def _register_errors(self, ctx: Ctx, l, r, data, valid) -> None:
        """Register the op's error sites over its inputs and result."""


# ── binding / coercion ──────────────────────────────────────────────────────


def map_child_exprs(e: Expression, f) -> Expression:
    """Rebuild ``e`` with ``f`` applied to each child expression, handling
    plain fields, tuples of expressions, and tuples of expression-pairs
    (CaseWhen branches)."""
    kwargs = {}
    changed = False
    for fld in dataclasses.fields(e):
        v = getattr(e, fld.name)
        if isinstance(v, Expression):
            nv = f(v)
        elif isinstance(v, tuple):
            items = []
            for x in v:
                if isinstance(x, Expression):
                    items.append(f(x))
                elif isinstance(x, tuple):
                    items.append(
                        tuple(f(y) if isinstance(y, Expression) else y for y in x)
                    )
                else:
                    items.append(x)
            nv = tuple(items)
        else:
            nv = v
        kwargs[fld.name] = nv
        if nv is not v:
            changed = True
    return dataclasses.replace(e, **kwargs) if changed else e


def bind(expr: Expression, schema: Schema) -> Expression:
    """Resolve names → ordinals and apply Spark-style type coercion.

    The analogue of ``GpuBindReferences`` + the slice of Catalyst's analyzer
    the reference relies on Spark for.
    """
    from .coercion import coerce  # late import to avoid cycle

    def rec(e: Expression) -> Expression:
        if isinstance(e, UnresolvedAttribute):
            i = schema.index_of(e.name)
            f = schema[i]
            return BoundReference(i, f.data_type, f.nullable)
        if isinstance(e, BoundReference) or isinstance(e, Literal):
            return e
        return coerce(map_child_exprs(e, rec))

    return rec(expr)


def to_expr(v: Union[Expression, int, float, str, bool, None]) -> Expression:
    """Lift python values to literals (DataFrame-API convenience)."""
    if isinstance(v, Expression):
        return v
    from ..types import BOOLEAN, DOUBLE, INT, LONG, NULL, STRING

    if v is None:
        return Literal(None, NULL)
    if isinstance(v, bool):
        return Literal(v, BOOLEAN)
    if isinstance(v, int):
        return Literal(v, INT if -(2**31) <= v < 2**31 else LONG)
    if isinstance(v, float):
        return Literal(v, DOUBLE)
    if isinstance(v, str):
        return Literal(v, STRING)
    import datetime as _dt

    if isinstance(v, _dt.datetime):
        from ..types import TIMESTAMP

        if v.tzinfo is None:  # naive timestamps are UTC in this engine
            v = v.replace(tzinfo=_dt.timezone.utc)
        epoch = _dt.datetime(1970, 1, 1, tzinfo=_dt.timezone.utc)
        return Literal(
            (v - epoch) // _dt.timedelta(microseconds=1), TIMESTAMP
        )
    if isinstance(v, _dt.date):
        from ..types import DATE

        return Literal((v - _dt.date(1970, 1, 1)).days, DATE)
    raise TypeError(f"cannot lift {type(v)} to an expression")
