"""Null-handling + variadic comparison expressions — reference:
nullExpressions.scala (nvl/nanvl/atleastnnonnulls) and Greatest/Least from
arithmetic.scala's rule group in GpuOverrides.

Copied from ``spark_rapids_tpu/expr/nullexprs.py``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

from ..types import BOOLEAN, DataType, DoubleType, FloatType, NullType, StringType
from .base import Ctx, Expression, Val, and_valid
from .conditional import _select


class _GreatestLeast(Expression):
    """Spark greatest/least: skips nulls, NULL only if all inputs NULL;
    NaN is greater than any other value (Spark nan semantics)."""

    greatest = True

    @property
    def data_type(self) -> DataType:
        for e in self.exprs:
            if not isinstance(e.data_type, NullType):
                return e.data_type
        return self.exprs[0].data_type

    def eval(self, ctx: Ctx) -> Val:
        xp = ctx.xp
        vals = [e.eval(ctx) for e in self.exprs]
        dt = self.data_type
        if isinstance(dt, StringType):
            # CPU-only (device path override-gated): UTF-8 byte order
            cols = [
                (
                    np.broadcast_to(np.asarray(v.data, dtype=object), (ctx.n,)),
                    v.full_valid(ctx),
                )
                for v in vals
            ]
            out = np.empty(ctx.n, dtype=object)
            outv = np.zeros(ctx.n, dtype=bool)
            for i in range(ctx.n):
                best = None
                for d, vl in cols:
                    if not vl[i]:
                        continue
                    x = d[i]
                    if best is None:
                        best = x
                    elif self.greatest and x.encode() > best.encode():
                        best = x
                    elif not self.greatest and x.encode() < best.encode():
                        best = x
                out[i] = best
                outv[i] = best is not None
            return Val(out, outv)
        is_float = isinstance(dt, (FloatType, DoubleType))
        result = vals[0]
        for v in vals[1:]:
            a = result
            b = v
            av, bv = a.full_valid(ctx), b.full_valid(ctx)
            ad, bd = a.full_data(ctx), b.full_data(ctx)
            if is_float:
                # NaN greatest: for greatest prefer NaN; for least avoid NaN
                a_nan, b_nan = xp.isnan(ad), xp.isnan(bd)
                if self.greatest:
                    b_wins = (bd > ad) | b_nan
                else:
                    b_wins = (bd < ad) | a_nan
                b_wins = b_wins & ~(a_nan & b_nan) if self.greatest else b_wins
            else:
                b_wins = bd > ad if self.greatest else bd < ad
            take_b = (b_wins & bv) | ~av
            data = xp.where(take_b, bd, ad)
            result = Val(data, av | bv)
        return result


@dataclass(frozen=True)
class Greatest(_GreatestLeast):
    exprs: Tuple[Expression, ...]
    greatest = True


@dataclass(frozen=True)
class Least(_GreatestLeast):
    exprs: Tuple[Expression, ...]
    greatest = False


@dataclass(frozen=True)
class NaNvl(Expression):
    """nanvl(a, b): b when a is NaN, else a."""

    l: Expression
    r: Expression

    @property
    def data_type(self) -> DataType:
        return self.l.data_type

    def eval(self, ctx: Ctx) -> Val:
        xp = ctx.xp
        a = self.l.eval(ctx)
        b = self.r.eval(ctx)
        a_nan = xp.isnan(a.full_data(ctx)) & a.full_valid(ctx)
        return _select(ctx, ~a_nan, a, b, self.data_type)


@dataclass(frozen=True)
class Nvl2(Expression):
    """nvl2(a, b, c): b when a is not null, else c."""

    a: Expression
    b: Expression
    c: Expression

    @property
    def data_type(self) -> DataType:
        return self.b.data_type if not isinstance(self.b.data_type, NullType) else self.c.data_type

    def eval(self, ctx: Ctx) -> Val:
        av = self.a.eval(ctx)
        return _select(
            ctx, av.full_valid(ctx), self.b.eval(ctx), self.c.eval(ctx), self.data_type
        )


@dataclass(frozen=True)
class AtLeastNNonNulls(Expression):
    """True when at least n of the inputs are non-null (and non-NaN for
    floats) — the predicate behind DataFrame.na.drop."""

    n: int
    exprs: Tuple[Expression, ...]

    @property
    def data_type(self) -> DataType:
        return BOOLEAN

    @property
    def nullable(self) -> bool:
        return False

    def eval(self, ctx: Ctx) -> Val:
        xp = ctx.xp
        count = xp.zeros(ctx.n, dtype=xp.int32)
        for e in self.exprs:
            v = e.eval(ctx)
            ok = v.full_valid(ctx)
            if isinstance(e.data_type, (FloatType, DoubleType)):
                ok = ok & ~xp.isnan(v.full_data(ctx))
            count = count + xp.astype(ok, xp.int32)
        return Val(count >= self.n, xp.ones(ctx.n, dtype=bool))
