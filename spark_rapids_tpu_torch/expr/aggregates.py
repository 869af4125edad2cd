"""Aggregate functions — reference: org/.../rapids/AggregateFunctions.scala
(CudfAggregate mapping) + aggregate.scala's update/merge two-phase model.

Each aggregate declares, exactly like the reference's ``GpuAggregateFunction``:

* ``update_exprs``   — projections of the input evaluated before the update
* ``buffer_fields``  — the aggregation buffer schema (e.g. Average: sum, count)
* ``update_ops`` / ``merge_ops`` — per-buffer-column segment reductions
  ('sum' | 'min' | 'max' | 'count' | 'first' | 'last'), executed by the
  sort+segment-reduce device kernel (ops/aggregate.py) or the numpy fallback
* ``evaluate(ctx, buffers)`` — final projection from buffer values

Spark result-type rules implemented: sum(integral)=long (wrapping),
sum(float/double)=double, sum(decimal(p,s))=decimal(min(p+10,18),s) under the
DECIMAL64 gate; count=long never-null; avg=double (decimal later); min/max
keep the input type and are null on empty groups.

Copied from ``spark_rapids_tpu/expr/aggregates.py``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

from ..types import (
    DOUBLE,
    DataType,
    DecimalType,
    DoubleType,
    FloatType,
    IntegralType,
    LONG,
    NullType,
    StringType,
)
from .base import Ctx, Expression, Literal, Val


@dataclass(frozen=True)
class AggregateFunction(Expression):
    """Base; concrete functions are frozen dataclasses with child exprs."""

    @property
    def update_exprs(self) -> Tuple[Expression, ...]:
        raise NotImplementedError

    @property
    def buffer_types(self) -> Tuple[DataType, ...]:
        raise NotImplementedError

    @property
    def update_ops(self) -> Tuple[str, ...]:
        raise NotImplementedError

    @property
    def merge_ops(self) -> Tuple[str, ...]:
        raise NotImplementedError

    def evaluate(self, ctx: Ctx, buffers: Sequence[Val]) -> Val:
        """Final projection; default: first buffer."""
        return buffers[0]


@dataclass(frozen=True)
class Sum(AggregateFunction):
    child: Expression
    # DISTINCT is planned away before execution (planner._rewrite_distinct:
    # group by keys+child first, then re-aggregate — AggUtils
    # planAggregateWithOneDistinct analogue), so execution never sees it
    distinct: bool = False

    @property
    def data_type(self) -> DataType:
        ct = self.child.data_type
        if isinstance(ct, DecimalType):
            return DecimalType(min(ct.precision + 10, DecimalType.MAX_PRECISION), ct.scale)
        if isinstance(ct, (FloatType, DoubleType)):
            return DOUBLE
        return LONG

    @property
    def update_exprs(self):
        from .cast import Cast

        ct = self.child.data_type
        if self.data_type == ct:
            return (self.child,)
        return (Cast(self.child, self.data_type),)

    @property
    def buffer_types(self):
        return (self.data_type,)

    @property
    def update_ops(self):
        return ("sum",)

    @property
    def merge_ops(self):
        return ("sum",)

    def __str__(self):
        return f"sum({self.child})"


@dataclass(frozen=True)
class Count(AggregateFunction):
    """count(expr) — counts non-null; count(*) via Count(Literal(1))."""

    child: Expression
    distinct: bool = False

    @property
    def data_type(self) -> DataType:
        return LONG

    @property
    def nullable(self) -> bool:
        return False

    @property
    def update_exprs(self):
        return (self.child,)

    @property
    def buffer_types(self):
        return (LONG,)

    @property
    def update_ops(self):
        return ("count",)

    @property
    def merge_ops(self):
        return ("sum",)

    def __str__(self):
        return f"count({self.child})"


@dataclass(frozen=True)
class Min(AggregateFunction):
    child: Expression

    @property
    def data_type(self) -> DataType:
        return self.child.data_type

    @property
    def update_exprs(self):
        return (self.child,)

    @property
    def buffer_types(self):
        return (self.child.data_type,)

    @property
    def update_ops(self):
        return ("min",)

    @property
    def merge_ops(self):
        return ("min",)

    def __str__(self):
        return f"min({self.child})"


@dataclass(frozen=True)
class Max(AggregateFunction):
    child: Expression

    @property
    def data_type(self) -> DataType:
        return self.child.data_type

    @property
    def update_exprs(self):
        return (self.child,)

    @property
    def buffer_types(self):
        return (self.child.data_type,)

    @property
    def update_ops(self):
        return ("max",)

    @property
    def merge_ops(self):
        return ("max",)

    def __str__(self):
        return f"max({self.child})"


@dataclass(frozen=True)
class Average(AggregateFunction):
    child: Expression
    distinct: bool = False

    @property
    def data_type(self) -> DataType:
        return DOUBLE

    @property
    def update_exprs(self):
        from .cast import Cast

        c = self.child
        if c.data_type != DOUBLE:
            c = Cast(c, DOUBLE)
        return (c, self.child)

    @property
    def buffer_types(self):
        return (DOUBLE, LONG)

    @property
    def update_ops(self):
        return ("sum", "count")

    @property
    def merge_ops(self):
        return ("sum", "sum")

    def evaluate(self, ctx: Ctx, buffers: Sequence[Val]) -> Val:
        xp = ctx.xp
        s, c = buffers
        cnt = ctx.broadcast(c.data)
        nz = cnt != 0
        safe = xp.where(nz, cnt, 1)
        data = ctx.broadcast(s.data) / safe
        valid = ctx.broadcast_bool(s.valid) & nz
        return Val(data, valid)

    def __str__(self):
        return f"avg({self.child})"


@dataclass(frozen=True)
class First(AggregateFunction):
    child: Expression
    ignore_nulls: bool = False

    @property
    def data_type(self) -> DataType:
        return self.child.data_type

    @property
    def update_exprs(self):
        return (self.child,)

    @property
    def buffer_types(self):
        return (self.child.data_type,)

    @property
    def update_ops(self):
        return ("first_ignore_nulls" if self.ignore_nulls else "first",)

    @property
    def merge_ops(self):
        return ("first_ignore_nulls" if self.ignore_nulls else "first",)


@dataclass(frozen=True)
class Last(AggregateFunction):
    child: Expression
    ignore_nulls: bool = False

    @property
    def data_type(self) -> DataType:
        return self.child.data_type

    @property
    def update_exprs(self):
        return (self.child,)

    @property
    def buffer_types(self):
        return (self.child.data_type,)

    @property
    def update_ops(self):
        return ("last_ignore_nulls" if self.ignore_nulls else "last",)

    @property
    def merge_ops(self):
        return ("last_ignore_nulls" if self.ignore_nulls else "last",)


@dataclass(frozen=True)
class _CentralMoment(AggregateFunction):
    """Variance/stddev over (count, sum, sum-of-squares) buffers — all plain
    segment reductions, so the same fused device kernel serves them.

    Reference: AggregateFunctions.scala GpuStddevSamp/GpuVariancePop family.
    Spark merges Welford M2 terms; the sum-of-squares formulation here can
    differ from Spark in low-order float bits for ill-conditioned inputs
    (both engines here share it, so the differential harness is exact).
    """

    child: Expression

    sample = False  # n-1 divisor + NaN at n == 1
    sqrt = False

    @property
    def data_type(self) -> DataType:
        return DOUBLE

    @property
    def update_exprs(self):
        from .arithmetic import Multiply
        from .cast import Cast

        c = self.child
        if not isinstance(c.data_type, DoubleType):
            c = Cast(c, DOUBLE)
        return (self.child, c, Multiply(c, c))

    @property
    def buffer_types(self):
        return (LONG, DOUBLE, DOUBLE)

    @property
    def update_ops(self):
        return ("count", "sum", "sum")

    @property
    def merge_ops(self):
        return ("sum", "sum", "sum")

    def evaluate(self, ctx: Ctx, buffers: Sequence[Val]) -> Val:
        xp = ctx.xp
        cnt = xp.astype(ctx.broadcast(buffers[0].data), xp.float64)
        s = ctx.broadcast(buffers[1].data)
        ss = ctx.broadcast(buffers[2].data)
        nz = cnt > 0
        safe_n = xp.where(nz, cnt, 1.0)
        m = s / safe_n
        m2 = ss - s * m  # Σ(x−μ)² up to rounding
        div = (cnt - 1.0) if self.sample else cnt
        safe_div = xp.where(div > 0, div, 1.0)
        var = xp.where(div > 0, m2 / safe_div, xp.nan)
        out = xp.sqrt(xp.maximum(var, 0.0)) if self.sqrt else xp.where(
            xp.isnan(var), var, xp.maximum(var, 0.0)
        )
        return Val(out, nz)

    def __str__(self):
        return f"{type(self).__name__.lower()}({self.child})"


@dataclass(frozen=True)
class VariancePop(_CentralMoment):
    sample = False
    sqrt = False


@dataclass(frozen=True)
class VarianceSamp(_CentralMoment):
    sample = True
    sqrt = False


@dataclass(frozen=True)
class StddevPop(_CentralMoment):
    sample = False
    sqrt = True


@dataclass(frozen=True)
class StddevSamp(_CentralMoment):
    sample = True
    sqrt = True


@dataclass(frozen=True)
class _PairMoment(AggregateFunction):
    """covar_pop / covar_samp / corr over (n, Σx, Σy, Σxy [, Σx², Σy²])
    buffers — plain count/sum segment reductions, so the fused device
    aggregate kernel serves them unchanged. Spark semantics: only rows
    where BOTH operands are non-null contribute (Corr.scala /
    Covariance.scala); the masked update expressions below encode that."""

    x: Expression
    y: Expression

    sample = False
    is_corr = False

    @property
    def data_type(self) -> DataType:
        return DOUBLE

    def _masked(self):
        from .base import Literal
        from .cast import Cast
        from .conditional import If
        from .predicates import And, IsNotNull

        both = And(IsNotNull(self.x), IsNotNull(self.y))
        null = Literal(None, DOUBLE)

        def m(e):
            if not isinstance(e.data_type, DoubleType):
                e = Cast(e, DOUBLE)
            return If(both, e, null)

        return m(self.x), m(self.y)

    @property
    def update_exprs(self):
        from .arithmetic import Multiply

        mx, my = self._masked()
        base = (mx, mx, my, Multiply(mx, my))
        if self.is_corr:
            return base + (Multiply(mx, mx), Multiply(my, my))
        return base

    @property
    def buffer_types(self):
        return (LONG,) + (DOUBLE,) * (5 if self.is_corr else 3)

    @property
    def update_ops(self):
        return ("count",) + ("sum",) * (5 if self.is_corr else 3)

    @property
    def merge_ops(self):
        return ("sum",) * (6 if self.is_corr else 4)

    def evaluate(self, ctx: Ctx, buffers: Sequence[Val]) -> Val:
        xp = ctx.xp
        n = xp.astype(ctx.broadcast(buffers[0].data), xp.float64)
        sx = ctx.broadcast(buffers[1].data)
        sy = ctx.broadcast(buffers[2].data)
        sxy = ctx.broadcast(buffers[3].data)
        nan = float("nan")
        safe_n = xp.where(n > 0, n, 1.0)
        cxy = sxy / safe_n - (sx / safe_n) * (sy / safe_n)
        if self.is_corr:
            sxx = ctx.broadcast(buffers[4].data)
            syy = ctx.broadcast(buffers[5].data)
            vx = sxx / safe_n - (sx / safe_n) ** 2
            vy = syy / safe_n - (sy / safe_n) ** 2
            # Spark Corr: NaN when either side is constant — selected via
            # where over a SAFE divisor (unguarded 0/0 spews numpy
            # RuntimeWarnings on the CPU engine)
            denom = xp.sqrt(xp.maximum(vx, 0.0) * xp.maximum(vy, 0.0))
            data = xp.where(denom > 0, cxy / xp.where(denom > 0, denom, 1.0), nan)
            valid = n >= 1
        elif self.sample:
            # covar_samp: (Σxy − ΣxΣy/n)/(n−1); NaN at one pair — matching
            # the engine's var_samp/stddev_samp convention (NaN at one
            # sample, null at zero; the _CentralMoment family above)
            data = xp.where(
                n > 1,
                (sxy - sx * sy / safe_n) / xp.where(n > 1, n - 1, 1.0),
                nan,
            )
            valid = n >= 1
        else:
            data = cxy
            valid = n >= 1
        return Val(xp.astype(data, xp.float64), valid)

    def __str__(self):
        name = (
            "corr"
            if self.is_corr
            else ("covar_samp" if self.sample else "covar_pop")
        )
        return f"{name}({self.x}, {self.y})"


@dataclass(frozen=True)
class CovarPop(_PairMoment):
    sample = False


@dataclass(frozen=True)
class CovarSamp(_PairMoment):
    sample = True


@dataclass(frozen=True)
class Corr(_PairMoment):
    is_corr = True


@dataclass(frozen=True)
class CollectList(AggregateFunction):
    """collect_list — gathers non-null values per group into an array
    (reference: AggregateFunctions.scala GpuCollectList). Runs on the CPU
    engine; the planner falls back (TypeSig-style gate in overrides)."""

    child: Expression

    @property
    def data_type(self) -> DataType:
        from ..types import ArrayType

        return ArrayType(self.child.data_type, contains_null=False)

    @property
    def nullable(self) -> bool:
        return False  # empty array, never null (Spark semantics)

    @property
    def update_exprs(self):
        return (self.child,)

    @property
    def buffer_types(self):
        return (self.data_type,)

    @property
    def update_ops(self):
        return ("collect_list",)

    @property
    def merge_ops(self):
        return ("merge_lists",)

    def __str__(self):
        return f"collect_list({self.child})"


@dataclass(frozen=True)
class CollectSet(CollectList):
    """collect_set — collect_list with duplicates removed at evaluation
    (reference: GpuCollectSet)."""

    @property
    def update_ops(self):
        return ("collect_set",)

    @property
    def merge_ops(self):
        return ("merge_sets",)

    def __str__(self):
        return f"collect_set({self.child})"


@dataclass(frozen=True)
class MergeLists(AggregateFunction):
    """Internal: merge partial collect_list arrays into one (Spark's
    Collect merge phase). Produced only by the DISTINCT rewrite when a
    collect aggregate rides along; CPU-only (the device path plans collect
    as a single complete aggregate and never merges lists)."""

    child: Expression

    @property
    def data_type(self) -> DataType:
        return self.child.data_type

    @property
    def nullable(self) -> bool:
        return False

    @property
    def update_exprs(self):
        return (self.child,)

    @property
    def buffer_types(self):
        return (self.data_type,)

    @property
    def update_ops(self):
        return ("merge_lists",)

    @property
    def merge_ops(self):
        return ("merge_lists",)

    def __str__(self):
        return f"merge_lists({self.child})"


@dataclass(frozen=True)
class MergeSets(MergeLists):
    @property
    def update_ops(self):
        return ("merge_sets",)

    @property
    def merge_ops(self):
        return ("merge_sets",)

    def __str__(self):
        return f"merge_sets({self.child})"


def is_aggregate(e: Expression) -> bool:
    if isinstance(e, AggregateFunction):
        return True
    return any(is_aggregate(c) for c in e.children())


def contains_distinct(e: Expression) -> bool:
    if isinstance(e, AggregateFunction) and getattr(e, "distinct", False):
        return True
    return any(contains_distinct(c) for c in e.children())
