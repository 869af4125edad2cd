"""Comparison and logical predicates with Spark-exact semantics.

Reference: sql-plugin predicates.scala, nullExpressions.scala. Notable
Spark-isms implemented on both backends:

* Floating comparisons follow Spark's NaN ordering — NaN == NaN is TRUE and
  NaN sorts greater than every other value (Spark "NaN semantics" doc).
* AND/OR use Kleene three-valued logic.
* ``EqualNullSafe`` (<=>) treats NULL == NULL as TRUE.
* String comparisons are binary (UTF-8 byte order), matching Spark's
  UTF8String.compareTo. On device they run on the padded byte matrix.

Copied from ``spark_rapids_tpu/expr/predicates.py``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

from ..types import BOOLEAN, BooleanType, DataType, DoubleType, FloatType, StringType
from .base import BinaryExpression, Ctx, Expression, UnaryExpression, Val, and_valid


def _is_float(dt: DataType) -> bool:
    return isinstance(dt, (FloatType, DoubleType))


def _str_cmp(ctx: Ctx, lval: Val, rval: Val):
    """Return (lt, eq) boolean arrays for string operands."""
    xp = ctx.xp
    if not ctx.is_device:
        import numpy as np

        l = lval.data
        r = rval.data
        lb = np.broadcast_to(np.asarray(l, dtype=object), (ctx.n,))
        rb = np.broadcast_to(np.asarray(r, dtype=object), (ctx.n,))
        lt = np.fromiter(
            (
                (a.encode() < b.encode()) if (a is not None and b is not None) else False
                for a, b in zip(lb, rb)
            ),
            dtype=bool,
            count=ctx.n,
        )
        eq = np.fromiter(
            ((a == b) if (a is not None and b is not None) else False for a, b in zip(lb, rb)),
            dtype=bool,
            count=ctx.n,
        )
        return lt, eq
    # device: padded byte matrices, possibly different widths; compare on the
    # common width after zero-padding (zero pad bytes don't affect order since
    # lengths break ties: prefix-equal → shorter is smaller).
    l, ll = lval.data, lval.lengths
    r, rl = rval.data, rval.lengths
    if l.ndim == 1:
        l = l[None, :]
    if r.ndim == 1:
        r = r[None, :]
    wl, wr = l.shape[-1], r.shape[-1]
    w = max(wl, wr)
    if wl < w:
        l = xp.pad(l, ((0, 0), (0, w - wl)))
    if wr < w:
        r = xp.pad(r, ((0, 0), (0, w - wr)))
    # First differing byte decides; equal prefixes decided by length.
    diff = l != r
    any_diff = diff.any(axis=-1)
    first = xp.argmax(diff, axis=-1)
    lb = xp.take_along_axis(l, first[..., None], axis=-1)[..., 0]
    rb = xp.take_along_axis(r, first[..., None], axis=-1)[..., 0]
    lt_bytes = lb < rb
    ll_b = xp.broadcast_to(xp.asarray(ll), any_diff.shape)
    rl_b = xp.broadcast_to(xp.asarray(rl), any_diff.shape)
    lt = xp.where(any_diff, lt_bytes, ll_b < rl_b)
    eq = (~any_diff) & (ll_b == rl_b)
    return lt, eq


class Comparison(BinaryExpression):
    @property
    def data_type(self) -> DataType:
        return BOOLEAN

    def eval(self, ctx: Ctx) -> Val:
        lval = self.left.eval(ctx)
        rval = self.right.eval(ctx)
        if isinstance(self.left.data_type, StringType):
            lt, eq = _str_cmp(ctx, lval, rval)
            data = self._from_lt_eq(ctx, lt, eq)
        else:
            data = self._cmp(ctx, lval.data, rval.data)
        return Val(data, and_valid(ctx, lval.valid, rval.valid))

    def _cmp(self, ctx: Ctx, l, r):
        raise NotImplementedError

    def _from_lt_eq(self, ctx: Ctx, lt, eq):
        raise NotImplementedError


@dataclass(frozen=True)
class EqualTo(Comparison):
    l: Expression
    r: Expression

    def _cmp(self, ctx: Ctx, l, r):
        if _is_float(self.l.data_type):
            xp = ctx.xp
            return (l == r) | (xp.isnan(l) & xp.isnan(r))
        return l == r

    def _from_lt_eq(self, ctx, lt, eq):
        return eq

    def __str__(self):
        return f"({self.l} = {self.r})"


@dataclass(frozen=True)
class LessThan(Comparison):
    l: Expression
    r: Expression

    def _cmp(self, ctx: Ctx, l, r):
        if _is_float(self.l.data_type):
            xp = ctx.xp
            # NaN is greater than everything; NaN < NaN is false
            return (l < r) | (xp.isnan(r) & ~xp.isnan(l))
        return l < r

    def _from_lt_eq(self, ctx, lt, eq):
        return lt

    def __str__(self):
        return f"({self.l} < {self.r})"


@dataclass(frozen=True)
class LessThanOrEqual(Comparison):
    l: Expression
    r: Expression

    def _cmp(self, ctx: Ctx, l, r):
        if _is_float(self.l.data_type):
            xp = ctx.xp
            return (l <= r) | xp.isnan(r)
        return l <= r

    def _from_lt_eq(self, ctx, lt, eq):
        return lt | eq

    def __str__(self):
        return f"({self.l} <= {self.r})"


@dataclass(frozen=True)
class GreaterThan(Comparison):
    l: Expression
    r: Expression

    def _cmp(self, ctx: Ctx, l, r):
        if _is_float(self.l.data_type):
            xp = ctx.xp
            return (l > r) | (xp.isnan(l) & ~xp.isnan(r))
        return l > r

    def _from_lt_eq(self, ctx, lt, eq):
        return ~(lt | eq)

    def __str__(self):
        return f"({self.l} > {self.r})"


@dataclass(frozen=True)
class GreaterThanOrEqual(Comparison):
    l: Expression
    r: Expression

    def _cmp(self, ctx: Ctx, l, r):
        if _is_float(self.l.data_type):
            xp = ctx.xp
            return (l >= r) | xp.isnan(l)
        return l >= r

    def _from_lt_eq(self, ctx, lt, eq):
        return ~lt

    def __str__(self):
        return f"({self.l} >= {self.r})"


@dataclass(frozen=True)
class EqualNullSafe(Comparison):
    """<=> — never NULL; NULL <=> NULL is TRUE."""

    l: Expression
    r: Expression

    @property
    def nullable(self) -> bool:
        return False

    def eval(self, ctx: Ctx) -> Val:
        lval = self.left.eval(ctx)
        rval = self.right.eval(ctx)
        xp = ctx.xp
        lv = ctx.broadcast_bool(lval.valid)
        rv = ctx.broadcast_bool(rval.valid)
        if isinstance(self.left.data_type, StringType):
            _, eq = _str_cmp(ctx, lval, rval)
        elif _is_float(self.l.data_type):
            eq = (lval.data == rval.data) | (xp.isnan(lval.data) & xp.isnan(rval.data))
        else:
            eq = lval.data == rval.data
        both_null = ~lv & ~rv
        data = xp.where(lv & rv, ctx.broadcast_bool(eq), both_null)
        return Val(data, xp.ones((ctx.n,), dtype=bool))

    def __str__(self):
        return f"({self.l} <=> {self.r})"


@dataclass(frozen=True)
class And(Expression):
    l: Expression
    r: Expression

    @property
    def data_type(self) -> DataType:
        return BOOLEAN

    def eval(self, ctx: Ctx) -> Val:
        xp = ctx.xp
        lv = self.l.eval(ctx)
        rv = self.r.eval(ctx)
        l_false = lv.full_valid(ctx) & ~ctx.broadcast_bool(lv.data)
        r_false = rv.full_valid(ctx) & ~ctx.broadcast_bool(rv.data)
        data = ctx.broadcast_bool(lv.data) & ctx.broadcast_bool(rv.data)
        valid = (lv.full_valid(ctx) & rv.full_valid(ctx)) | l_false | r_false
        return Val(data & valid, valid)

    def __str__(self):
        return f"({self.l} AND {self.r})"


@dataclass(frozen=True)
class Or(Expression):
    l: Expression
    r: Expression

    @property
    def data_type(self) -> DataType:
        return BOOLEAN

    def eval(self, ctx: Ctx) -> Val:
        xp = ctx.xp
        lv = self.l.eval(ctx)
        rv = self.r.eval(ctx)
        l_true = lv.full_valid(ctx) & ctx.broadcast_bool(lv.data)
        r_true = rv.full_valid(ctx) & ctx.broadcast_bool(rv.data)
        data = l_true | r_true
        valid = (lv.full_valid(ctx) & rv.full_valid(ctx)) | l_true | r_true
        return Val(data, valid)

    def __str__(self):
        return f"({self.l} OR {self.r})"


@dataclass(frozen=True)
class Not(UnaryExpression):
    c: Expression

    @property
    def data_type(self) -> DataType:
        return BOOLEAN

    def _compute(self, ctx: Ctx, data):
        return ~ctx.xp.astype(ctx.xp.asarray(data), bool)

    def __str__(self):
        return f"(NOT {self.c})"


@dataclass(frozen=True)
class IsNull(Expression):
    c: Expression

    @property
    def data_type(self) -> DataType:
        return BOOLEAN

    @property
    def nullable(self) -> bool:
        return False

    def eval(self, ctx: Ctx) -> Val:
        v = self.c.eval(ctx)
        xp = ctx.xp
        return Val(~v.full_valid(ctx), xp.ones((ctx.n,), dtype=bool))

    def __str__(self):
        return f"({self.c} IS NULL)"


@dataclass(frozen=True)
class IsNotNull(Expression):
    c: Expression

    @property
    def data_type(self) -> DataType:
        return BOOLEAN

    @property
    def nullable(self) -> bool:
        return False

    def eval(self, ctx: Ctx) -> Val:
        v = self.c.eval(ctx)
        xp = ctx.xp
        return Val(v.full_valid(ctx), xp.ones((ctx.n,), dtype=bool))

    def __str__(self):
        return f"({self.c} IS NOT NULL)"


@dataclass(frozen=True)
class IsNaN(UnaryExpression):
    c: Expression

    @property
    def data_type(self) -> DataType:
        return BOOLEAN

    @property
    def nullable(self) -> bool:
        return False

    def eval(self, ctx: Ctx) -> Val:
        v = self.c.eval(ctx)
        xp = ctx.xp
        data = xp.isnan(ctx.broadcast(v.data)) & v.full_valid(ctx)
        return Val(data, xp.ones((ctx.n,), dtype=bool))


@dataclass(frozen=True)
class In(Expression):
    """value IN (literals...) — Spark null semantics: NULL if value is null,
    or if no match and the list contains a null."""

    c: Expression
    values: Tuple[Expression, ...]

    @property
    def data_type(self) -> DataType:
        return BOOLEAN

    def eval(self, ctx: Ctx) -> Val:
        xp = ctx.xp
        v = self.c.eval(ctx)
        any_match = xp.zeros((ctx.n,), dtype=bool)
        for item in self.values:
            iv = item.eval(ctx)
            if isinstance(self.c.data_type, StringType):
                _, eq = _str_cmp(ctx, v, iv)
            else:
                eq = ctx.broadcast(v.data) == ctx.broadcast(iv.data)
            any_match = any_match | (
                ctx.broadcast_bool(eq) & ctx.broadcast_bool(iv.valid)
            )
        # Trace-safe null-item detection: IN lists are literal-only (coercion
        # enforces foldable items), so inspect the expressions, not the data.
        has_null_item = any(getattr(x, "value", 0) is None for x in self.values)
        if has_null_item:
            valid = v.full_valid(ctx) & any_match
        else:
            valid = v.full_valid(ctx)
        return Val(any_match & valid, valid)
