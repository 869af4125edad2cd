"""Bitwise expressions — the analogue of bitwise.scala (~200 LoC).

Java shift semantics: the shift amount is masked to the operand width
(``n & 31`` for int, ``n & 63`` for long) — implemented explicitly since
numpy/XLA shifts are undefined/zero for out-of-range amounts.

Copied from ``spark_rapids_tpu/expr/bitwise.py``.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..types import DataType, IntegralType
from .base import BinaryExpression, Ctx, Expression, UnaryExpression


@dataclass(frozen=True)
class BitwiseAnd(BinaryExpression):
    l: Expression
    r: Expression

    @property
    def data_type(self) -> DataType:
        return self.l.data_type

    def _compute(self, ctx: Ctx, l, r):
        return l & r


@dataclass(frozen=True)
class BitwiseOr(BinaryExpression):
    l: Expression
    r: Expression

    @property
    def data_type(self) -> DataType:
        return self.l.data_type

    def _compute(self, ctx: Ctx, l, r):
        return l | r


@dataclass(frozen=True)
class BitwiseXor(BinaryExpression):
    l: Expression
    r: Expression

    @property
    def data_type(self) -> DataType:
        return self.l.data_type

    def _compute(self, ctx: Ctx, l, r):
        return l ^ r


@dataclass(frozen=True)
class BitwiseNot(UnaryExpression):
    c: Expression

    @property
    def data_type(self) -> DataType:
        return self.c.data_type

    def _compute(self, ctx: Ctx, data):
        return ~data


def _width_mask(dt: DataType) -> int:
    return 63 if dt.np_dtype.itemsize == 8 else 31


class _Shift(BinaryExpression):
    """value SHIFT amount — value keeps its type, amount is int."""

    @property
    def data_type(self) -> DataType:
        return self.l.data_type

    def _compute(self, ctx: Ctx, l, r):
        xp = ctx.xp
        dt = self.l.data_type
        n = xp.astype(xp.astype(r, xp.int32) & _width_mask(dt), xp.int32)
        return self._shift(ctx, l, n, dt)


@dataclass(frozen=True)
class ShiftLeft(_Shift):
    l: Expression
    r: Expression

    def _shift(self, ctx, v, n, dt):
        return ctx.xp.astype(v << n, dt.np_dtype)


@dataclass(frozen=True)
class ShiftRight(_Shift):
    """Arithmetic (sign-extending) right shift — Java ``>>``."""

    l: Expression
    r: Expression

    def _shift(self, ctx, v, n, dt):
        return ctx.xp.astype(v >> n, dt.np_dtype)


@dataclass(frozen=True)
class ShiftRightUnsigned(_Shift):
    """Logical right shift — Java ``>>>``."""

    l: Expression
    r: Expression

    def _shift(self, ctx, v, n, dt):
        # in signed int64 lanes (torch has no >> on uint64 and no uint32
        # shifts): a 64-bit value shifts arithmetically and drops the n sign
        # copies it pulled in; a narrower one shifts its 32-bit pattern
        xp = ctx.xp
        n = xp.astype(n, xp.int64)
        if dt.np_dtype.itemsize == 8:
            v = xp.astype(v, xp.int64)
            high = (xp.full_like(v, -1) << (63 - n)) << 1  # the top n bits
            return (v >> n) & ~high
        out = (xp.astype(v, xp.int64) & 0xFFFFFFFF) >> n
        return xp.astype(out, dt.np_dtype)
