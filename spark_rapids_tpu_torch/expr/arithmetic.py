"""Arithmetic expressions with Spark-exact semantics.

Reference: sql-plugin arithmetic.scala + decimalExpressions.scala. Key
semantics implemented here (both backends, bit-identical to CPU Spark):

* Integral ops wrap (Java two's complement) — numpy/XLA native behavior.
* ``Divide`` operates on double/decimal and returns NULL when the divisor is
  zero (Spark's DivModLike), unlike Java/IEEE.
* ``IntegralDivide``/``Remainder``/``Pmod`` are NULL on zero divisors.
* Decimal add/sub/multiply follow Spark's DecimalPrecision result types,
  gated to 64-bit precision like the reference (TypeChecks DECIMAL_64).
* Under ANSI mode (``ansi=True``, set by the session's ANSI rewrite)
  integral ``+``, ``-`` and ``*`` raise ``AnsiError`` on overflow, as
  Spark's ``failOnError`` arithmetic does; the device raises it through the
  error channel of ``exec/gpu.py``.

Copied from ``spark_rapids_tpu/expr/arithmetic.py``. The JAX package has no
ANSI arithmetic (its integral ops always wrap); ``AnsiArithmetic`` is the
port's own.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..types import (
    DataType,
    DecimalType,
    DoubleType,
    FloatType,
    FractionalType,
    IntegralType,
    LONG,
    LongType,
)
from .base import BinaryExpression, Ctx, Expression, UnaryExpression


def _is_float(dt: DataType) -> bool:
    return isinstance(dt, (FloatType, DoubleType))


def _java_div(xp, l, r):
    """Integer division truncating toward zero (Java `/`), r must be nonzero."""
    q = l // r
    remnz = (l - q * r) != 0
    return xp.where(remnz & ((l < 0) != (r < 0)), q + 1, q)


def _java_rem(xp, l, r):
    """Java `%`: remainder carries the sign of the dividend, r nonzero."""
    return l - _java_div(xp, l, r) * r


class AnsiArithmetic(BinaryExpression):
    """Integral ``+``/``-``/``*`` whose ANSI form registers an error site
    on overflow (null inputs never raise). Subclasses give ``_overflow``
    over the wrapped result."""

    ansi: bool = False

    def _register_errors(self, ctx: Ctx, l, r, data, valid) -> None:
        if self.ansi and isinstance(self.data_type, IntegralType):
            ctx.register_error(
                f"[ARITHMETIC_OVERFLOW] {self.data_type.simple_string} overflow in {self}",
                self._overflow(ctx.xp, l, r, data) & ctx.broadcast_bool(valid),
            )


@dataclass(frozen=True)
class Add(AnsiArithmetic):
    l: Expression
    r: Expression
    ansi: bool = False

    @property
    def data_type(self) -> DataType:
        lt = self.l.data_type
        if isinstance(lt, DecimalType):
            rt = self.r.data_type
            assert isinstance(rt, DecimalType)
            scale = max(lt.scale, rt.scale)
            prec = max(lt.precision - lt.scale, rt.precision - rt.scale) + scale + 1
            return DecimalType(min(prec, DecimalType.MAX_PRECISION), scale)
        return lt

    def _compute(self, ctx: Ctx, l, r):
        if isinstance(self.l.data_type, DecimalType):
            l, r = _rescale_pair(ctx, self, l, r)
        return l + r

    @staticmethod
    def _overflow(xp, l, r, res):
        return ((l ^ res) & (r ^ res)) < 0

    def __str__(self):
        return f"({self.l} + {self.r})"


@dataclass(frozen=True)
class Subtract(AnsiArithmetic):
    l: Expression
    r: Expression
    ansi: bool = False

    @property
    def data_type(self) -> DataType:
        lt = self.l.data_type
        if isinstance(lt, DecimalType):
            rt = self.r.data_type
            assert isinstance(rt, DecimalType)
            scale = max(lt.scale, rt.scale)
            prec = max(lt.precision - lt.scale, rt.precision - rt.scale) + scale + 1
            return DecimalType(min(prec, DecimalType.MAX_PRECISION), scale)
        return lt

    def _compute(self, ctx: Ctx, l, r):
        if isinstance(self.l.data_type, DecimalType):
            l, r = _rescale_pair(ctx, self, l, r)
        return l - r

    @staticmethod
    def _overflow(xp, l, r, res):
        return ((l ^ r) & (l ^ res)) < 0

    def __str__(self):
        return f"({self.l} - {self.r})"


@dataclass(frozen=True)
class Multiply(AnsiArithmetic):
    l: Expression
    r: Expression
    ansi: bool = False

    @property
    def data_type(self) -> DataType:
        lt = self.l.data_type
        if isinstance(lt, DecimalType):
            rt = self.r.data_type
            assert isinstance(rt, DecimalType)
            prec = lt.precision + rt.precision + 1
            scale = lt.scale + rt.scale
            if prec > DecimalType.MAX_PRECISION:
                raise TypeError(
                    f"decimal multiply result precision {prec} exceeds DECIMAL64"
                )
            return DecimalType(prec, scale)
        return lt

    def _compute(self, ctx: Ctx, l, r):
        # decimal: unscaled product already has scale s1+s2 — no rescale needed
        return l * r

    def _overflow(self, xp, l, r, res):
        if self.data_type.np_dtype.itemsize < 8:
            exact = xp.astype(xp.asarray(l), xp.int64) * xp.astype(xp.asarray(r), xp.int64)
            return exact != xp.astype(xp.asarray(res), xp.int64)
        # 64 bits: the wrapped product divided back (r == -1 overflows only
        # at the minimum, and never divides)
        lo = -(2**63)
        bad_r = (r == 0) | (r == -1)
        safe = xp.where(bad_r, 1, r)
        back = _java_div(xp, res, safe)
        return xp.where(r == -1, l == lo, ~bad_r & (back != l))

    def __str__(self):
        return f"({self.l} * {self.r})"


def _rescale_pair(ctx: Ctx, e: BinaryExpression, l, r):
    """Align decimal operands to the result scale (unscaled int64 arithmetic)."""
    lt: DecimalType = e.left.data_type  # type: ignore
    rt: DecimalType = e.right.data_type  # type: ignore
    scale = max(lt.scale, rt.scale)
    if lt.scale < scale:
        l = l * (10 ** (scale - lt.scale))
    if rt.scale < scale:
        r = r * (10 ** (scale - rt.scale))
    return l, r


@dataclass(frozen=True)
class Divide(BinaryExpression):
    """Double or decimal division; NULL on zero divisor (Spark semantics)."""

    l: Expression
    r: Expression

    @property
    def data_type(self) -> DataType:
        lt = self.l.data_type
        if isinstance(lt, DecimalType):
            rt = self.r.data_type
            assert isinstance(rt, DecimalType)
            # Spark DecimalPrecision for divide
            prec = lt.precision - lt.scale + rt.scale + max(6, lt.scale + rt.precision + 1)
            scale = max(6, lt.scale + rt.precision + 1)
            if prec > DecimalType.MAX_PRECISION:
                raise TypeError("decimal divide exceeds DECIMAL64")
            return DecimalType(prec, scale)
        return lt

    def _compute(self, ctx: Ctx, l, r):
        xp = ctx.xp
        if isinstance(self.data_type, DecimalType):
            lt: DecimalType = self.l.data_type  # type: ignore
            rt: DecimalType = self.r.data_type  # type: ignore
            out_scale = self.data_type.scale
            # unscaled result = l * 10^(out_scale - s1 + s2) / r, ROUND_HALF_UP
            shift = out_scale - lt.scale + rt.scale
            num = xp.astype(l, xp.int64) * (10**shift)
            denom = xp.where(r == 0, xp.ones_like(r), r)
            q = _java_div(xp, num, denom)  # truncate toward zero
            rem = num - q * denom  # sign of num (or 0)
            sign = xp.astype(xp.sign(num), xp.int64) * xp.astype(xp.sign(denom), xp.int64)
            adj = xp.where(2 * xp.abs(rem) >= xp.abs(denom), sign, 0)
            return q + adj, r != 0
        denom_zero = r == 0
        safe = xp.where(denom_zero, xp.ones_like(r), r)
        return l / safe, ~denom_zero

    def __str__(self):
        return f"({self.l} / {self.r})"


@dataclass(frozen=True)
class IntegralDivide(BinaryExpression):
    """``div`` — long division truncated toward zero, NULL on zero divisor."""

    l: Expression
    r: Expression

    @property
    def data_type(self) -> DataType:
        return LONG

    def _compute(self, ctx: Ctx, l, r):
        xp = ctx.xp
        zero = r == 0
        safe = xp.where(zero, xp.ones_like(r), r)
        return xp.astype(_java_div(xp, l, safe), xp.int64), ~zero

    def __str__(self):
        return f"({self.l} div {self.r})"


@dataclass(frozen=True)
class Remainder(BinaryExpression):
    """``%`` with Java semantics (sign of dividend), NULL on zero divisor."""

    l: Expression
    r: Expression

    @property
    def data_type(self) -> DataType:
        return self.l.data_type

    def _compute(self, ctx: Ctx, l, r):
        xp = ctx.xp
        zero = r == 0
        safe = xp.where(zero, xp.ones_like(r), r)
        if _is_float(self.data_type):
            return xp.fmod(l, safe), ~zero
        return _java_rem(xp, l, safe), ~zero

    def __str__(self):
        return f"({self.l} % {self.r})"


@dataclass(frozen=True)
class Pmod(BinaryExpression):
    """Spark's pmod: ``r = a % n; if (r < 0) (r + n) % n else r`` — NULL on
    zero divisor. Note the result keeps Java-% semantics per that formula and
    is NOT always positive when the divisor is negative (pmod(-7,-3) = -1)."""

    l: Expression
    r: Expression

    @property
    def data_type(self) -> DataType:
        return self.l.data_type

    def _compute(self, ctx: Ctx, l, r):
        xp = ctx.xp
        zero = r == 0
        safe = xp.where(zero, xp.ones_like(r), r)
        if _is_float(self.data_type):
            m = xp.fmod(l, safe)
            return xp.where(m < 0, xp.fmod(m + safe, safe), m), ~zero
        m = _java_rem(xp, l, safe)
        return xp.where(m < 0, _java_rem(xp, m + safe, safe), m), ~zero


@dataclass(frozen=True)
class UnaryMinus(UnaryExpression):
    c: Expression

    @property
    def data_type(self) -> DataType:
        return self.c.data_type

    def _compute(self, ctx: Ctx, data):
        return -data

    def __str__(self):
        return f"(- {self.c})"


@dataclass(frozen=True)
class UnaryPositive(UnaryExpression):
    c: Expression

    @property
    def data_type(self) -> DataType:
        return self.c.data_type

    def _compute(self, ctx: Ctx, data):
        return data


@dataclass(frozen=True)
class Abs(UnaryExpression):
    c: Expression

    @property
    def data_type(self) -> DataType:
        return self.c.data_type

    def _compute(self, ctx: Ctx, data):
        return ctx.xp.abs(data)
