"""Math expressions — the analogue of mathExpressions.scala (443 LoC).

Spark-isms implemented on both backends:
* ``log``/``log1p`` return NULL for out-of-domain inputs (Spark's Logarithm),
  unlike IEEE -inf/NaN.
* ``floor``/``ceil`` on double return LONG (Java Math.floor + toLong with
  saturation); on integral types they are identity.
* ``round``/``bround`` (HALF_UP / HALF_EVEN) run on device for integral
  inputs (exact integer math); double rounding falls back to CPU where the
  oracle uses java.math.BigDecimal semantics via python decimal — the
  reference (branch-0.5) has no GPU Round either.

Copied from ``spark_rapids_tpu/expr/math.py``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..types import (
    DOUBLE,
    LONG,
    DataType,
    DoubleType,
    FloatType,
    IntegralType,
)
from .base import BinaryExpression, Ctx, Expression, UnaryExpression, Val, and_valid


class _DoubleFn(UnaryExpression):
    """Unary double function: input coerced to double, NaN-in → NaN-out."""

    @property
    def data_type(self) -> DataType:
        return DOUBLE

    def _compute(self, ctx: Ctx, data):
        xp = ctx.xp
        return self._fn(xp, xp.astype(data, xp.float64))


def _mk_double_fn(name: str, fn, doc: str = ""):
    cls = dataclass(frozen=True)(
        type(
            name,
            (_DoubleFn,),
            {
                "__doc__": doc or f"Spark ``{name.lower()}``.",
                "__annotations__": {"c": Expression},
                "_fn": staticmethod(fn),
            },
        )
    )
    return cls


Sqrt = _mk_double_fn("Sqrt", lambda xp, x: xp.sqrt(x))
Cbrt = _mk_double_fn("Cbrt", lambda xp, x: xp.cbrt(x))
Exp = _mk_double_fn("Exp", lambda xp, x: xp.exp(x))
Expm1 = _mk_double_fn("Expm1", lambda xp, x: xp.expm1(x))
Sin = _mk_double_fn("Sin", lambda xp, x: xp.sin(x))
Cos = _mk_double_fn("Cos", lambda xp, x: xp.cos(x))
Tan = _mk_double_fn("Tan", lambda xp, x: xp.tan(x))
Asin = _mk_double_fn("Asin", lambda xp, x: xp.arcsin(x))
Acos = _mk_double_fn("Acos", lambda xp, x: xp.arccos(x))
Atan = _mk_double_fn("Atan", lambda xp, x: xp.arctan(x))
Sinh = _mk_double_fn("Sinh", lambda xp, x: xp.sinh(x))
Cosh = _mk_double_fn("Cosh", lambda xp, x: xp.cosh(x))
Tanh = _mk_double_fn("Tanh", lambda xp, x: xp.tanh(x))
ToDegrees = _mk_double_fn("ToDegrees", lambda xp, x: xp.degrees(x))
ToRadians = _mk_double_fn("ToRadians", lambda xp, x: xp.radians(x))
# Inverse hyperbolics use Spark's literal formulas (StrictMath compositions,
# Asinh/Acosh/Atanh in mathExpressions.scala) rather than np.arcsinh etc. —
# same NaN domains AND the same rounding as the Java implementations.
Acosh = _mk_double_fn(
    "Acosh", lambda xp, x: xp.log(x + xp.sqrt(x * x - 1.0)),
    "Spark ``acosh`` — log(x + sqrt(x^2-1)), NaN below 1.",
)
Asinh = _mk_double_fn(
    "Asinh", lambda xp, x: xp.log(x + xp.sqrt(x * x + 1.0)),
    "Spark ``asinh`` — log(x + sqrt(x^2+1)) (Spark's exact formula).",
)
Atanh = _mk_double_fn(
    "Atanh", lambda xp, x: 0.5 * xp.log((1.0 + x) / (1.0 - x)),
    "Spark ``atanh`` — 0.5*log((1+x)/(1-x)), NaN outside (-1, 1).",
)
Cot = _mk_double_fn(
    "Cot", lambda xp, x: 1.0 / xp.tan(x), "Spark ``cot`` — 1/tan(x)."
)
Rint = _mk_double_fn("Rint", lambda xp, x: xp.rint(x))
Signum = _mk_double_fn(
    "Signum", lambda xp, x: xp.sign(x), "Sign as double (NaN → NaN)."
)


class _DomainLog(UnaryExpression):
    """Log-family: NULL outside the domain (Spark Logarithm.nullable)."""

    lower = 0.0  # exclusive domain lower bound

    @property
    def data_type(self) -> DataType:
        return DOUBLE

    def eval(self, ctx: Ctx) -> Val:
        c = self.child.eval(ctx)
        xp = ctx.xp
        x = xp.astype(ctx.broadcast(c.data), xp.float64)
        # Spark's Logarithm nulls only when input <= bound; NaN input is NOT
        # <= bound in Java, so log(NaN) stays NaN (not NULL)
        ok = (x > self.lower) | xp.isnan(x)
        safe = xp.where(ok, x, 1.0)
        data = self._fn(xp, safe)
        return Val(data, and_valid(ctx, c.valid, ok))


@dataclass(frozen=True)
class Log(_DomainLog):
    c: Expression
    _fn = staticmethod(lambda xp, x: xp.log(x))


@dataclass(frozen=True)
class Log10(_DomainLog):
    c: Expression
    _fn = staticmethod(lambda xp, x: xp.log10(x))


@dataclass(frozen=True)
class Log2(_DomainLog):
    c: Expression
    _fn = staticmethod(lambda xp, x: xp.log2(x))


@dataclass(frozen=True)
class Log1p(_DomainLog):
    c: Expression
    lower = -1.0
    _fn = staticmethod(lambda xp, x: xp.log1p(x))


@dataclass(frozen=True)
class Logarithm(BinaryExpression):
    """``log(base, x)`` — NULL when base <= 0 or x <= 0 (Spark Logarithm's
    nullSafeEval; reference rule GpuOverrides.scala:1274)."""

    base: Expression
    x: Expression

    @property
    def data_type(self) -> DataType:
        return DOUBLE

    @property
    def nullable(self) -> bool:
        return True

    def _compute(self, ctx: Ctx, l, r):
        xp = ctx.xp
        b = xp.astype(l, xp.float64)
        x = xp.astype(r, xp.float64)
        # NaN operands are not <= 0 in Java, so they flow through as NaN
        ok = ((b > 0.0) | xp.isnan(b)) & ((x > 0.0) | xp.isnan(x))
        data = xp.log(xp.where(ok, x, 1.0)) / xp.log(xp.where(ok, b, 2.0))
        return data, ok


@dataclass(frozen=True)
class Pow(BinaryExpression):
    l: Expression
    r: Expression

    @property
    def data_type(self) -> DataType:
        return DOUBLE

    def _compute(self, ctx: Ctx, l, r):
        xp = ctx.xp
        return xp.power(xp.astype(l, xp.float64), xp.astype(r, xp.float64))


@dataclass(frozen=True)
class Atan2(BinaryExpression):
    l: Expression
    r: Expression

    @property
    def data_type(self) -> DataType:
        return DOUBLE

    def _compute(self, ctx: Ctx, l, r):
        xp = ctx.xp
        return xp.arctan2(xp.astype(l, xp.float64), xp.astype(r, xp.float64))


@dataclass(frozen=True)
class Hypot(BinaryExpression):
    l: Expression
    r: Expression

    @property
    def data_type(self) -> DataType:
        return DOUBLE

    def _compute(self, ctx: Ctx, l, r):
        xp = ctx.xp
        return xp.hypot(xp.astype(l, xp.float64), xp.astype(r, xp.float64))


_LONG_MIN, _LONG_MAX = -(2**63), 2**63 - 1


class _FloorCeil(UnaryExpression):
    """floor/ceil: identity on integral, double → LONG with Java-toLong
    saturation (NaN → 0)."""

    @property
    def data_type(self) -> DataType:
        if isinstance(self.child.data_type, IntegralType):
            return self.child.data_type
        return LONG

    def _compute(self, ctx: Ctx, data):
        xp = ctx.xp
        if isinstance(self.child.data_type, IntegralType):
            return data
        x = self._rnd(xp, xp.astype(data, xp.float64))
        oob_hi = x >= float(_LONG_MAX)
        oob_lo = x <= float(_LONG_MIN)
        safe = xp.where(xp.isnan(x) | oob_hi | oob_lo, 0.0, x)
        out = xp.astype(safe, xp.int64)
        # Java toLong saturation at the boundaries (float(_LONG_MAX) == 2^63
        # itself overflows an int64 cast, hence the masked fix-up)
        out = xp.where(oob_hi, _LONG_MAX, out)
        out = xp.where(oob_lo, _LONG_MIN, out)
        return out


@dataclass(frozen=True)
class Floor(_FloorCeil):
    c: Expression
    _rnd = staticmethod(lambda xp, x: xp.floor(x))


@dataclass(frozen=True)
class Ceil(_FloorCeil):
    c: Expression
    _rnd = staticmethod(lambda xp, x: xp.ceil(x))


class _RoundBase(Expression):
    """Spark round/bround — scale must be a literal (like the reference's
    foldable requirement for cudf round scales)."""

    half_even = False

    @property
    def data_type(self) -> DataType:
        return self.child.data_type

    @property
    def nullable(self) -> bool:
        return self.child.nullable

    def _scale(self) -> int:
        from .base import Literal

        assert isinstance(self.scale, Literal)
        return int(self.scale.value)

    def eval(self, ctx: Ctx) -> Val:
        c = self.child.eval(ctx)
        d = self._scale()
        dt = self.child.data_type
        xp = ctx.xp
        if isinstance(dt, IntegralType):
            data = ctx.broadcast(c.data)
            if d >= 0:
                return Val(data, c.valid)
            p = 10 ** (-d)
            x = xp.astype(data, xp.int64)
            q = xp.floor_divide(x, p)  # rem = x - q*p is in [0, p)
            rem2 = (x - q * p) * 2
            if self.half_even:
                up = (rem2 > p) | ((rem2 == p) & (xp.mod(q, 2) != 0))
            else:  # HALF_UP: ties go away from zero
                up = (rem2 > p) | ((rem2 == p) & (x >= 0))
            out = q + xp.astype(up, xp.int64)
            return Val(xp.astype(out * p, dt.np_dtype), c.valid)
        if ctx.is_device:
            # incompat-gated device path (reference GpuRound/GpuBRound via
            # cudf round — "may round slightly differently"): arithmetic in
            # f64 binary, not java BigDecimal's shortest-decimal-repr space,
            # so decimal-boundary ties can land one ulp differently.
            x = xp.astype(ctx.broadcast(c.data), xp.float64)
            if d >= 309:
                # 10**d overflows float64; every double is unchanged at
                # this scale (largest exponent span is ±308)
                return Val(xp.astype(x, dt.np_dtype), c.valid)
            if d <= -309:
                # |x|/10**309 < 1 for every finite double: rounds to zero
                out = xp.where(xp.isfinite(x), xp.zeros_like(x), x)
                return Val(xp.astype(out, dt.np_dtype), c.valid)
            if d >= 0:
                p = float(10 ** d)
                if self.half_even:
                    out = xp.round(x * p) / p
                else:
                    out = xp.sign(x) * xp.floor(xp.abs(x) * p + 0.5) / p
                # x * p can overflow to ±inf for finite x (round(1e306, 3)):
                # the scaled space cannot represent the value, where
                # Spark's BigDecimal path returns x unchanged — such a
                # magnitude has no digits at scale d to round
                out = xp.where(xp.isfinite(x * p), out, x)
            else:
                q = float(10 ** (-d))
                if self.half_even:
                    out = xp.round(x / q) * q
                else:
                    out = xp.sign(x) * xp.floor(xp.abs(x) / q + 0.5) * q
            # NaN/±inf pass through sign*floor unscathed except sign(nan)=nan
            out = xp.where(xp.isfinite(x), out, x)
            return Val(xp.astype(out, dt.np_dtype), c.valid)
        # CPU engine keeps exact java BigDecimal semantics
        import decimal as _dec

        data = np.asarray(ctx.broadcast(c.data), dtype=np.float64)
        mode = _dec.ROUND_HALF_EVEN if self.half_even else _dec.ROUND_HALF_UP
        out = np.empty(len(data), dtype=np.float64)
        # java BigDecimal is arbitrary-precision; python's default 28-digit
        # context raises InvalidOperation quantizing huge doubles (1e306 at
        # scale 3 needs ~310 digits) — widen to cover the full f64 range
        with _dec.localcontext() as dctx:
            dctx.prec = 400
            for i, x in enumerate(data.tolist()):
                if x != x or x in (float("inf"), float("-inf")):
                    out[i] = x
                    continue
                out[i] = float(
                    _dec.Decimal(repr(x)).quantize(
                        _dec.Decimal(1).scaleb(-d), rounding=mode
                    )
                )
        return Val(xp.astype(out, dt.np_dtype), c.valid)


@dataclass(frozen=True)
class Round(_RoundBase):
    child: Expression
    scale: Expression
    half_even = False


@dataclass(frozen=True)
class BRound(_RoundBase):
    child: Expression
    scale: Expression
    half_even = True
