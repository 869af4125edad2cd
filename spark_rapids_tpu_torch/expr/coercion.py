"""Type coercion — the slice of Catalyst's analyzer the reference relies on
Spark to run before its planning pass. Inserts Casts so binary operators see
same-type operands, and promotes Divide operands to double (Spark's
``ImplicitTypeCasts``/``DecimalPrecision`` behavior for the supported types).

Copied from ``spark_rapids_tpu/expr/coercion.py``.
"""
from __future__ import annotations

import dataclasses

from ..types import (
    DOUBLE,
    BooleanType,
    DataType,
    DecimalType,
    DateType,
    IntegralType,
    NullType,
    NumericType,
    StringType,
    TimestampType,
    numeric_promote,
)
from .arithmetic import Add, Divide, IntegralDivide, Multiply, Pmod, Remainder, Subtract
from .base import Expression, Literal
from .bitwise import BitwiseAnd, BitwiseOr, BitwiseXor
from .cast import Cast
from .nullexprs import Greatest, Least, NaNvl
from .predicates import (
    Comparison,
    EqualNullSafe,
    EqualTo,
    GreaterThan,
    GreaterThanOrEqual,
    In,
    LessThan,
    LessThanOrEqual,
)

_ARITH = (Add, Subtract, Multiply, Remainder, Pmod)
_CMP = (
    EqualTo,
    EqualNullSafe,
    LessThan,
    LessThanOrEqual,
    GreaterThan,
    GreaterThanOrEqual,
)


def _cast_to(e: Expression, dt: DataType) -> Expression:
    if e.data_type == dt:
        return e
    if isinstance(e, Literal) and e.value is None:
        return Literal(None, dt)
    return Cast(e, dt)


def _integral_decimal(dt: DataType) -> DecimalType:
    """Exact-width Decimal(p, 0) of an integral type (Spark's
    DecimalType.forType): byte→3, short→5, int→10, long→19 (capped)."""
    widths = {1: 3, 2: 5, 4: 10, 8: 19}
    p = min(widths[dt.np_dtype.itemsize], DecimalType.MAX_PRECISION)
    return DecimalType(p, 0)


def _common_type(a: DataType, b: DataType) -> DataType:
    if a == b:
        return a
    if isinstance(a, NullType):
        return b
    if isinstance(b, NullType):
        return a
    if isinstance(a, DecimalType) and isinstance(b, DecimalType):
        # Spark DecimalPrecision.widerDecimalType: keep every integral and
        # fractional digit of both sides
        s = max(a.scale, b.scale)
        p = max(a.precision - a.scale, b.precision - b.scale) + s
        return DecimalType(min(p, DecimalType.MAX_PRECISION), s)
    if isinstance(a, DecimalType) and isinstance(b, IntegralType) and not isinstance(b, (DateType, TimestampType)):
        # Spark: integral promotes to decimal of exact width
        p = _integral_decimal(b).precision
        return DecimalType(max(a.precision, min(p + a.scale, DecimalType.MAX_PRECISION)), a.scale)
    if isinstance(b, DecimalType):
        return _common_type(b, a)
    if isinstance(a, NumericType) and isinstance(b, NumericType) and not isinstance(
        a, (DateType, TimestampType)
    ) and not isinstance(b, (DateType, TimestampType)):
        return numeric_promote(a, b)
    if isinstance(a, StringType) and isinstance(b, NumericType):
        return DOUBLE
    if isinstance(b, StringType) and isinstance(a, NumericType):
        return DOUBLE
    raise TypeError(f"cannot find common type for {a} and {b}")


def coerce(e: Expression) -> Expression:
    """Rewrite one (already child-resolved) node with the casts Spark's
    analyzer would insert."""
    from ..types import CalendarInterval, CalendarIntervalType

    if isinstance(e, (Add, Subtract)) and (
        isinstance(e.l.data_type, CalendarIntervalType)
        or isinstance(e.r.data_type, CalendarIntervalType)
    ):
        # analyzer's DateTimeOperations: date/timestamp ± INTERVAL becomes
        # DateAddInterval / TimeAdd (intervals must be literals, like the
        # reference's GpuTimeAdd gate)
        from .datetime import DateAddInterval, TimeAdd

        if isinstance(e.l.data_type, CalendarIntervalType):
            if isinstance(e, Subtract):
                raise TypeError("cannot subtract a date/timestamp from an interval")
            base, itv = e.r, e.l
        else:
            base, itv = e.l, e.r
        if isinstance(e, Subtract):
            if not isinstance(itv, Literal):
                raise TypeError("interval operand must be a literal")
            m, d, us = CalendarInterval(*itv.value)
            itv = Literal(CalendarInterval(-m, -d, -us), itv.data_type)
        if isinstance(base.data_type, DateType):
            return DateAddInterval(base, itv)
        if isinstance(base.data_type, TimestampType):
            return TimeAdd(base, itv)
        raise TypeError(
            f"cannot add an interval to a {base.data_type} operand"
        )
    if isinstance(e, _ARITH) or isinstance(e, _CMP):
        lt, rt = e.l.data_type, e.r.data_type
        if isinstance(e, Multiply) and (
            isinstance(lt, DecimalType) or isinstance(rt, DecimalType)
        ):
            # Spark multiplies decimals at their ORIGINAL types (result
            # p1+p2+1, s1+s2); widening to a common type first would
            # inflate the result precision past what Spark produces. An
            # integral operand is promoted to its exact-width Decimal(p,0)
            # only; fractional operands fall through to the double path.
            def _exact(side, dt):
                if isinstance(dt, DecimalType):
                    return side
                if isinstance(dt, IntegralType) and not isinstance(
                    dt, (DateType, TimestampType)
                ):
                    return _cast_to(side, _integral_decimal(dt))
                return None

            nl, nr = _exact(e.l, lt), _exact(e.r, rt)
            if nl is not None and nr is not None:
                return dataclasses.replace(e, l=nl, r=nr)
        if lt == rt and not isinstance(lt, NullType):
            return e
        ct = _common_type(lt, rt)
        return dataclasses.replace(e, l=_cast_to(e.l, ct), r=_cast_to(e.r, ct))
    if isinstance(e, (Divide, IntegralDivide)):
        lt, rt = e.l.data_type, e.r.data_type
        if isinstance(lt, DecimalType) or isinstance(rt, DecimalType):
            ct = _common_type(lt, rt)
            return dataclasses.replace(e, l=_cast_to(e.l, ct), r=_cast_to(e.r, ct))
        # Spark: Divide on anything non-decimal runs on double
        return dataclasses.replace(e, l=_cast_to(e.l, DOUBLE), r=_cast_to(e.r, DOUBLE))
    if isinstance(e, (BitwiseAnd, BitwiseOr, BitwiseXor)):
        lt, rt = e.l.data_type, e.r.data_type
        if lt == rt:
            return e
        ct = _common_type(lt, rt)
        return dataclasses.replace(e, l=_cast_to(e.l, ct), r=_cast_to(e.r, ct))
    if isinstance(e, (Greatest, Least)):
        ct = e.exprs[0].data_type
        for v in e.exprs[1:]:
            if not isinstance(v.data_type, NullType):
                ct = _common_type(ct, v.data_type) if not isinstance(ct, NullType) else v.data_type
        return dataclasses.replace(e, exprs=tuple(_cast_to(v, ct) for v in e.exprs))
    if isinstance(e, NaNvl):
        # Spark keeps the operands' common fractional type (float stays float)
        lt, rt = e.l.data_type, e.r.data_type
        ct = lt if lt == rt else _common_type(lt, rt)
        if not isinstance(ct, (NullType,)):
            return dataclasses.replace(e, l=_cast_to(e.l, ct), r=_cast_to(e.r, ct))
        return e
    if isinstance(e, In):
        ct = e.c.data_type
        for v in e.values:
            if not isinstance(v.data_type, NullType):
                ct = _common_type(ct, v.data_type)
        return dataclasses.replace(
            e,
            c=_cast_to(e.c, ct),
            values=tuple(_cast_to(v, ct) for v in e.values),
        )
    from .complex import CreateArray, UnresolvedExtractValue

    if isinstance(e, UnresolvedExtractValue):
        return e.resolve()  # struct field / array index / map key dispatch
    if isinstance(e, CreateArray) and e.items:
        ct = e.items[0].data_type
        for v in e.items[1:]:
            if not isinstance(v.data_type, NullType):
                ct = (
                    v.data_type
                    if isinstance(ct, NullType)
                    else _common_type(ct, v.data_type)
                )
        return dataclasses.replace(e, items=tuple(_cast_to(v, ct) for v in e.items))
    return e
