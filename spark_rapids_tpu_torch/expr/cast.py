"""Cast — the analogue of GpuCast.scala (1319 LoC in the reference), the
single most semantics-dense expression.

Implemented pairs (both backends):

* numeric → numeric: Java conversion semantics — int narrowing wraps
  (two's complement), floating → integral saturates at min/max with NaN → 0
  (Scala ``Double.toInt``), integral → floating rounds to nearest.
* numeric/boolean ↔ boolean: ``x != 0``; bool → numeric 0/1.
* date/timestamp widening (date → timestamp, timestamp → date floor);
  timestamp ↔ integral/fractional in seconds (Spark's micros/1e6 convention).
* decimal ↔ integral/fractional/decimal rescale with overflow → NULL
  (Spark wraps in nullOnOverflow for non-ANSI).
* X → string for bool/integral/float/double/date/timestamp/decimal — device
  kernels over the padded byte matrix; float → string follows Java
  ``Double.toString`` (jformat.py) and its device kernel is gated behind
  ``spark.rapids.sql.castFloatToString.enabled`` exactly like the reference
  (GpuCast.scala castFloatingTypeToString), because shortest-round-trip digit
  selection on device can differ in the last digit for extreme exponents.
* string → bool/integral/float/double/date/timestamp/decimal — Spark's
  UTF8String parsing semantics (trimAll of control/space chars, sign, the
  DateTimeUtils segment grammar for dates/timestamps). string→float and
  string→timestamp are config-gated like the reference
  (``castStringToFloat.enabled`` / ``castStringToTimestamp.enabled``).

ANSI mode (``spark.sql.ansi.enabled``): the same pairs raise ``AnsiError`` on
overflow / malformed input instead of producing NULL, and integral narrowing
range-checks instead of wrapping (reference: ansiEnabled branches of
GpuCast.scala, AnsiCastOpSuite). On the CPU backend the error is raised
immediately; on device the error sites are accumulated on the ``Ctx`` and the
project/filter kernels return per-site flags that the exec checks after the
kernel runs (one host sync per batch, only when ANSI casts are present).

Unsupported pairs raise at planning time so the planner can fall back per-node
(the TypeChecks gating path).

Copied from ``spark_rapids_tpu/expr/cast.py``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..types import (
    BooleanType,
    ByteType,
    DataType,
    DateType,
    DecimalType,
    DoubleType,
    FloatType,
    FractionalType,
    IntegerType,
    IntegralType,
    LongType,
    NullType,
    ShortType,
    StringType,
    TimestampType,
)
from .base import AnsiError, Ctx, Expression, UnaryExpression, Val

_INT_BOUNDS = {
    np.dtype(np.int8): (-(2**7), 2**7 - 1),
    np.dtype(np.int16): (-(2**15), 2**15 - 1),
    np.dtype(np.int32): (-(2**31), 2**31 - 1),
    np.dtype(np.int64): (-(2**63), 2**63 - 1),
}

_INT_DIGITS = {
    np.dtype(np.int8): 3,
    np.dtype(np.int16): 5,
    np.dtype(np.int32): 10,
    np.dtype(np.int64): 19,
}

MICROS_PER_DAY = 86400 * 1000000
US_PER_SECOND = 1_000_000

I64_MIN = -(2**63)
LONG_MIN_STR = b"-9223372036854775808"


def _float_to_int(xp, data, to_np_dtype):
    """Java (int)/(long) conversion: NaN→0, saturate at bounds, truncate."""
    lo, hi = _INT_BOUNDS[to_np_dtype]
    x = xp.trunc(xp.where(xp.isnan(data), 0.0, data))
    hi_f = float(hi)  # rounds UP to 2^63 for int64 (inexact) — handled below
    above = (x >= hi_f) if int(hi_f) != hi else (x > hi_f)
    below = x < float(lo)  # lo is a power of two, exactly representable
    inner = ~above & ~below
    casted = xp.astype(xp.where(inner, x, 0.0), to_np_dtype)
    return xp.astype(xp.where(above, hi, xp.where(below, lo, casted)), to_np_dtype)


def _float_int_ok(xp, data, to_np_dtype):
    """ANSI range check for float → integral: in-bounds and not NaN."""
    lo, hi = _INT_BOUNDS[to_np_dtype]
    x = xp.trunc(data)
    hi_f = float(hi)
    above = (x >= hi_f) if int(hi_f) != hi else (x > hi_f)
    return ~xp.isnan(data) & ~above & (x >= float(lo))


# ── device byte-matrix helpers (shared with strings.py idioms) ─────────────

# Double-double decimal powers: 10^s = (hi + lo) · 2^E with hi ∈ [1, 2),
# host-built exactly with Fractions. float(Fraction) is correctly rounded, so
# hi+lo carries ~106 bits of 10^s — enough for correctly-rounded decimal ↔
# binary conversion without big integers on device (Ryu/strtod-style).
def _build_dd_pow10():
    from fractions import Fraction

    lo_s, hi_s = -350, 350
    his, los, es = [], [], []
    for s in range(lo_s, hi_s + 1):
        v = Fraction(10) ** s
        e = v.numerator.bit_length() - v.denominator.bit_length() - 1
        if Fraction(2) ** (e + 1) <= v:
            e += 1
        md = v / Fraction(2) ** e
        hi = float(md)
        lo = float(md - Fraction(hi))
        his.append(hi)
        los.append(lo)
        es.append(e)
    return (
        np.asarray(his, dtype=np.float64),
        np.asarray(los, dtype=np.float64),
        np.asarray(es, dtype=np.int64),
        lo_s,
    )


_DD_HI, _DD_LO, _DD_E, _DD_MIN_S = _build_dd_pow10()
with np.errstate(over="ignore"):
    _POW2 = np.power(2.0, np.arange(-1100, 1101, dtype=np.float64))


def _pow2f(xp, k):
    """Exact 2.0**k via table (k clipped to ±1100; beyond is 0/inf)."""
    return xp.take(xp.asarray(_POW2), xp.astype(xp.clip(k + 1100, 0, 2200), xp.int32))


def _two_prod(xp, a, b):
    """Dekker two-product: a*b = p + err exactly (|a|,|b| ≲ 1e150)."""
    split = 134217729.0  # 2^27 + 1
    p = a * b
    ca = split * a
    ah = ca - (ca - a)
    al = a - ah
    cb = split * b
    bh = cb - (cb - b)
    bl = b - bh
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


def _int_div_pow10(xp, v, k: int):
    """v / 10^k (v: int64) correctly rounded to float64.

    Plain ``v.astype(f64) / 10**k`` is NOT bit-stable under jit: XLA
    strength-reduces division by a constant into a reciprocal multiply
    (~30% of values one ulp off vs IEEE division). Both backends route
    through the double-double decimal path instead."""
    neg = v < 0
    mag = xp.abs(v)
    out = _dec_to_float(xp, mag, xp.full(v.shape, -k, dtype=xp.int32))
    return xp.where(neg, -out, out)


def _two_sum(xp, a, b):
    """Knuth two-sum: a + b = s + err exactly."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _dec_to_float(xp, d, r):
    """Correctly-rounded float64 of the decimal d · 10^r (d: int64 in
    [0, ~1e18]).

    d can exceed 2^53, so it is split into exact high/low parts before the
    double-double product with the 10^r tables; the only rounding is the
    final one (subnormal results double-round — the same corner every
    table-driven strtod shares)."""
    idx = xp.astype(xp.clip(r - _DD_MIN_S, 0, 700), xp.int32)
    mh = xp.take(xp.asarray(_DD_HI), idx)
    ml = xp.take(xp.asarray(_DD_LO), idx)
    E = xp.take(xp.asarray(_DD_E), idx)
    d = xp.astype(d, xp.int64)
    d_a = xp.astype((d >> 30) << 30, xp.float64)  # ≤ 2^60, 30 trailing zeros
    d_b = xp.astype(d & ((1 << 30) - 1), xp.float64)
    p1, e1 = _two_prod(xp, d_a, mh)
    p2, e2 = _two_prod(xp, d_b, mh)
    s, e3 = _two_sum(xp, p1, p2)
    tail = ((e1 + e2) + e3) + (d_a + d_b) * ml
    v = s + tail
    out = v * _pow2f(xp, E)
    # table range exceeded → saturate the way the true value would
    # (a zero mantissa stays zero regardless of the exponent)
    out = xp.where((r > 350) & (d != 0), xp.asarray(xp.inf), out)
    out = xp.where(r < -350, 0.0, out)
    out = xp.where(d == 0, 0.0, out)
    return out


def _signbit(xp, x):
    """Bitcast-free signbit for float64 (TPU X64 emulation cannot bitcast
    64-bit types): catches -0.0 via the sign of 1/x."""
    one_over = xp.where(x == 0, 1.0 / xp.where(x == 0, x, 1.0), 0.0)
    return (x < 0) | ((x == 0) & (one_over < 0))


def _digits_msd(xp, mag, k):
    """Non-negative int64 magnitudes → uint8 digit matrix [n, k], MSD first."""
    cols = []
    m = mag
    for _ in range(k):
        cols.append(xp.astype(m % 10, xp.uint8))
        m = m // 10
    return xp.stack(cols[::-1], axis=1)


def _first_sig(xp, digits):
    """Index of the first significant digit per row (k-1 when all zero)."""
    nz = digits != 0
    k = digits.shape[1]
    has = nz.any(axis=1)
    return xp.astype(xp.where(has, xp.argmax(nz, axis=1), k - 1), xp.int32)


def _pack(ctx: Ctx, slots, keep, min_width: int):
    from .strings import compact_bytes
    from ..columnar.device import bucket_width

    return compact_bytes(ctx, slots, keep, bucket_width(min_width))


def _dev_trim(ctx: Ctx, data, lengths):
    """UTF8String.trimAll bounds: indices [start, end) of the non-space
    (> 0x20) region; end == start for all-space strings."""
    xp = ctx.xp
    w = data.shape[1]
    idx = xp.arange(w, dtype=xp.int32)[None, :]
    in_len = idx < lengths[:, None]
    nonspace = (data > 0x20) & in_len
    any_ = nonspace.any(axis=1)
    start = xp.astype(xp.argmax(nonspace, axis=1), xp.int32)
    last = (w - 1) - xp.astype(xp.argmax(xp.flip(nonspace, 1), axis=1), xp.int32)
    end = xp.where(any_, last + 1, start)
    return start, end, any_


def _parse_digits(ctx: Ctx, ch, a, b, max_digits=None):
    """Parse the digit run in [a, b) per row → (int64 value, ok)."""
    xp = ctx.xp
    n, w = ch.shape
    idx = xp.arange(w, dtype=xp.int32)[None, :]
    use = (idx >= a[:, None]) & (idx < b[:, None])
    is_digit = (ch >= 48) & (ch <= 57)
    ok = xp.where(use, is_digit, True).all(axis=1) & (b > a)
    if max_digits is not None:
        ok = ok & ((b - a) <= max_digits)
    val = xp.zeros(n, dtype=xp.int64)
    for j in range(w):
        u = use[:, j] & is_digit[:, j]
        d = xp.astype(ch[:, j] - 48, xp.int64)
        val = xp.where(u, val * 10 + d, val)
    return val, ok


def _find_char(ctx: Ctx, ch, c, a, b):
    """First index of byte ``c`` in [a, b) per row, else ``b``; plus found."""
    xp = ctx.xp
    w = ch.shape[1]
    idx = xp.arange(w, dtype=xp.int32)[None, :]
    hit = (ch == c) & (idx >= a[:, None]) & (idx < b[:, None])
    any_ = hit.any(axis=1)
    first = xp.astype(xp.argmax(hit, axis=1), xp.int32)
    return xp.where(any_, first, b), any_


def _char_at(ctx: Ctx, ch, i):
    """Byte at per-row index i (0 when out of the matrix)."""
    xp = ctx.xp
    w = ch.shape[1]
    i = xp.clip(i, 0, w - 1)
    return xp.take_along_axis(ch, xp.astype(i[:, None], xp.int32), axis=1)[:, 0]


def _days_in_month(xp, y, m):
    from .datetime import days_from_civil

    ny = y + (m == 12)
    nm = xp.where(m == 12, 1, m + 1)
    return days_from_civil(xp, ny, nm, xp.ones_like(m)) - days_from_civil(
        xp, y, m, xp.ones_like(m)
    )


@dataclass(frozen=True)
class Cast(UnaryExpression):
    c: Expression
    to: DataType
    ansi: bool = False

    @property
    def data_type(self) -> DataType:
        return self.to

    @property
    def nullable(self) -> bool:
        # casts that can produce null from non-null (overflow/parse) handled
        # by returning extra validity in eval
        return True

    def _err(self, ctx: Ctx, child_valid, ok, what: str):
        """ANSI: register/raise an error for rows valid-in but failed."""
        bad = ctx.broadcast_bool(child_valid) & ~ok
        ctx.register_error(
            f"[ANSI] cast({self.c.data_type.simple_string} as "
            f"{self.to.simple_string}) {what}",
            bad,
        )

    def eval(self, ctx: Ctx) -> Val:
        v = self.c.eval(ctx)
        frm, to = self.c.data_type, self.to
        xp = ctx.xp
        if frm == to:
            return v
        if isinstance(frm, NullType):
            if isinstance(to, StringType):
                from .base import Literal

                return Literal(None, to).eval(ctx)
            return Val(xp.zeros((), dtype=to.np_dtype), xp.asarray(False))
        if isinstance(to, StringType):
            return self._to_string(ctx, v, frm)
        if isinstance(frm, StringType):
            return self._from_string(ctx, v, to)
        data, extra_valid = self._numeric_cast(ctx, v.data, frm, to)
        valid = v.valid
        if extra_valid is not None:
            if self.ansi:
                self._err(ctx, valid, extra_valid, "overflow")
            valid = ctx.broadcast_bool(valid) & extra_valid
        return Val(data, valid)

    # ── numeric/temporal matrix ────────────────────────────────────────────
    def _numeric_cast(self, ctx: Ctx, data, frm: DataType, to: DataType):
        xp = ctx.xp
        if isinstance(to, BooleanType):
            return data != 0, None
        if isinstance(frm, BooleanType):
            if isinstance(to, TimestampType):
                return xp.astype(data, np.int64) * US_PER_SECOND, None
            if isinstance(to, DecimalType):
                # true → 1 scaled to the target (unscaled = 10^scale), not
                # the raw 0/1 bit as unscaled
                unscaled = xp.astype(data, np.int64) * (10**to.scale)
                if to.scale >= to.precision:
                    # decimal(p,s) with s >= p cannot represent 1
                    return unscaled, data == 0
                return unscaled, None
            return xp.astype(data, to.np_dtype), None
        if isinstance(frm, DateType) and isinstance(to, TimestampType):
            return xp.astype(data, np.int64) * MICROS_PER_DAY, None
        if isinstance(frm, TimestampType) and isinstance(to, DateType):
            # floor-div towards -inf (Spark: DateTimeUtils.microsToDays)
            return xp.astype(data // MICROS_PER_DAY, np.int32), None
        if isinstance(frm, TimestampType):
            # timestamp → numeric: seconds (Spark: micros / 1e6, floor for
            # integral targets, exact fraction for fractional ones)
            if isinstance(to, (FloatType, DoubleType)):
                return xp.astype(_int_div_pow10(xp, data, 6), to.np_dtype), None
            if isinstance(to, DecimalType):
                # seconds (incl. fraction) at to.scale, HALF_UP
                sh = to.scale - 6
                micros = xp.astype(data, np.int64)
                if sh >= 0:
                    unscaled = micros * (10**sh)
                    lim = (2**63 - 1) // (10**sh)
                    ok = (xp.abs(micros) <= lim) if sh else xp.ones(
                        micros.shape, dtype=bool
                    )
                else:
                    # HALF_UP = away from zero: floor-div remainders are
                    # always ≥ 0, so ties round up only for non-negatives
                    f = 10 ** (-sh)
                    q = micros // f
                    r = micros - q * f
                    up = (2 * r > f) | ((2 * r == f) & (micros >= 0))
                    unscaled = q + xp.astype(up, xp.int64)
                    ok = None
                lim2 = 10**to.precision - 1
                inb = (unscaled >= -lim2) & (unscaled <= lim2)
                return unscaled, inb if ok is None else (ok & inb)
            secs = xp.floor_divide(data, US_PER_SECOND)
            out = xp.astype(secs, to.np_dtype)
            if self.ansi and to.np_dtype != np.dtype(np.int64):
                lo, hi = _INT_BOUNDS[to.np_dtype]
                return out, (secs >= lo) & (secs <= hi)
            return out, None
        if isinstance(to, TimestampType):
            # numeric → timestamp: value is seconds
            if isinstance(frm, (FloatType, DoubleType)):
                micros = xp.astype(data, np.float64) * US_PER_SECOND
                out = _float_to_int(xp, micros, np.dtype(np.int64))
                ok = ~xp.isnan(data) & ~xp.isinf(data)
                return out, ok
            if isinstance(frm, DecimalType):
                secs = _int_div_pow10(xp, data, frm.scale)
                return _float_to_int(
                    xp, secs * US_PER_SECOND, np.dtype(np.int64)
                ), None
            return xp.astype(data, np.int64) * US_PER_SECOND, None
        if isinstance(frm, DecimalType) or isinstance(to, DecimalType):
            return self._decimal_cast(ctx, data, frm, to)
        if isinstance(to, (FloatType, DoubleType)):
            # asarray: a literal's value is a numpy scalar, which np.astype refuses
            return xp.astype(xp.asarray(data), to.np_dtype), None
        # target integral
        if isinstance(frm, (FloatType, DoubleType)):
            out = _float_to_int(xp, data, to.np_dtype)
            if self.ansi:
                return out, _float_int_ok(xp, data, to.np_dtype)
            return out, None
        # integral narrowing: wraps (Java) non-ANSI, range-checks ANSI
        out = xp.astype(xp.asarray(data), to.np_dtype)
        if self.ansi and to.np_dtype.itemsize < data.dtype.itemsize:
            lo, hi = _INT_BOUNDS[to.np_dtype]
            src = xp.astype(data, np.int64)
            return out, (src >= lo) & (src <= hi)
        return out, None

    def _decimal_cast(self, ctx: Ctx, data, frm: DataType, to: DataType):
        xp = ctx.xp
        if isinstance(frm, DecimalType) and isinstance(to, DecimalType):
            ds = to.scale - frm.scale
            if ds >= 0:
                scaled = data * (10**ds)
                lo, hi = -(10**to.precision) + 1, 10**to.precision - 1
                ok = (data <= hi // (10**ds)) & (data >= lo // (10**ds))
                return scaled, ok
            # round half-up on scale reduction
            f = 10 ** (-ds)
            q = data // f
            rem = data - q * f
            adj = xp.where(2 * xp.abs(rem) >= f, xp.sign(data), 0)
            out = q + adj
            lo, hi = -(10**to.precision) + 1, 10**to.precision - 1
            return out, (out >= lo) & (out <= hi)
        if isinstance(frm, DecimalType):
            # decimal → integral/float: value = unscaled / 10^scale
            if isinstance(to, (FloatType, DoubleType)):
                return xp.astype(_int_div_pow10(xp, data, frm.scale), to.np_dtype), None
            # Spark truncates toward zero for decimal→int (integer-exact:
            # the float quotient can flip trunc at integer boundaries)
            q = data
            if frm.scale:
                p = 10**frm.scale
                q0 = data // p
                r = data - q0 * p
                q = q0 + xp.astype((q0 < 0) & (r != 0), np.int64)
            lo, hi = _INT_BOUNDS[to.np_dtype]
            ok = (q >= lo) & (q <= hi)
            return xp.astype(q, to.np_dtype), ok
        if isinstance(to, DecimalType):
            if isinstance(frm, (FloatType, DoubleType)):
                scaled = data * (10.0**to.scale)
                # round half-up
                unscaled = xp.where(
                    xp.isnan(scaled), 0, xp.floor(xp.abs(scaled) + 0.5) * xp.sign(scaled)
                )
                lo, hi = -(10**to.precision) + 1, 10**to.precision - 1
                ok = (~xp.isnan(data)) & (unscaled >= lo) & (unscaled <= hi)
                return xp.astype(unscaled, np.int64), ok
            unscaled = xp.astype(data, np.int64) * (10**to.scale)
            lo, hi = -(10**to.precision) + 1, 10**to.precision - 1
            ok = (xp.astype(data, np.int64) <= hi // (10**to.scale)) & (
                xp.astype(data, np.int64) >= lo // (10**to.scale)
            )
            return unscaled, ok
        raise TypeError(f"unsupported cast {frm} -> {to}")

    # ── X → string ─────────────────────────────────────────────────────────
    def _to_string(self, ctx: Ctx, v: Val, frm: DataType) -> Val:
        if ctx.is_device:
            return self._to_string_device(ctx, v, frm)
        data = ctx.broadcast(v.data)
        valid = ctx.broadcast_bool(v.valid)
        if isinstance(frm, BooleanType):
            out = np.asarray(
                ["true" if bool(x) else "false" for x in data], dtype=object
            )
        elif isinstance(frm, DateType):
            out = np.asarray([_cpu_date_str(int(x)) for x in data], dtype=object)
        elif isinstance(frm, TimestampType):
            out = np.asarray([_cpu_ts_str(int(x)) for x in data], dtype=object)
        elif isinstance(frm, DecimalType):
            out = np.asarray(
                [_cpu_decimal_str(int(x), frm.scale) for x in data], dtype=object
            )
        elif isinstance(frm, (FloatType, DoubleType)):
            from .jformat import java_float_str

            is32 = isinstance(frm, FloatType)
            out = np.asarray(
                [java_float_str(x, is32) for x in data], dtype=object
            )
        elif isinstance(frm, IntegralType):
            out = np.asarray([str(int(x)) for x in data], dtype=object)
        else:
            raise NotImplementedError(f"cast {frm} -> string")
        out[~valid] = None
        return Val(out, valid)

    def _to_string_device(self, ctx: Ctx, v: Val, frm: DataType) -> Val:
        xp = ctx.xp
        data = ctx.broadcast(v.data)
        if isinstance(frm, BooleanType):
            b = xp.astype(data, bool)
            t = xp.asarray(np.frombuffer(b"true\x00", dtype=np.uint8))
            f = xp.asarray(np.frombuffer(b"false", dtype=np.uint8))
            slots = xp.where(b[:, None], t[None, :], f[None, :])
            lens = xp.astype(xp.where(b, 4, 5), xp.int32)
            from ..columnar.device import bucket_width

            w = bucket_width(5)
            out = xp.pad(xp.astype(slots, xp.uint8), ((0, 0), (0, w - 5)))
            return Val(out, v.valid, lens)
        if isinstance(frm, DateType):
            packed, lens = _dev_date_str(ctx, data)
            return Val(packed, v.valid, lens)
        if isinstance(frm, TimestampType):
            packed, lens = _dev_ts_str(ctx, data)
            return Val(packed, v.valid, lens)
        if isinstance(frm, DecimalType):
            packed, lens = _dev_decimal_str(ctx, data, frm.scale)
            return Val(packed, v.valid, lens)
        if isinstance(frm, (FloatType, DoubleType)):
            packed, lens = _dev_float_str(ctx, data, isinstance(frm, FloatType))
            return Val(packed, v.valid, lens)
        if isinstance(frm, IntegralType):
            packed, lens = _dev_int_str(ctx, data, frm.np_dtype)
            return Val(packed, v.valid, lens)
        raise NotImplementedError(f"device cast {frm} -> string")

    # ── string → X ─────────────────────────────────────────────────────────
    def _from_string(self, ctx: Ctx, v: Val, to: DataType) -> Val:
        if ctx.is_device:
            return self._from_string_device(ctx, v, to)

        n = ctx.n
        data = np.broadcast_to(np.asarray(v.data, dtype=object), (n,))
        valid = ctx.broadcast_bool(v.valid)
        out = np.zeros(n, dtype=to.np_dtype if not isinstance(to, BooleanType) else bool)
        ok = np.zeros(n, dtype=bool)
        for i in range(n):
            if not valid[i] or data[i] is None:
                continue
            r = _cpu_parse(data[i], to, ansi=self.ansi)
            if r is not None:
                out[i] = r
                ok[i] = True
        if self.ansi:
            self._err(ctx, valid, ok, "invalid input")
        return Val(out, valid & ok)

    def _from_string_device(self, ctx: Ctx, v: Val, to: DataType) -> Val:
        from .strings import dev_str

        ch, lengths = dev_str(ctx, v)
        start, end, has_any = _dev_trim(ctx, ch, lengths)
        if isinstance(to, BooleanType):
            out, ok = _dev_str_to_bool(ctx, ch, start, end)
        elif isinstance(to, DateType):
            out, ok = _dev_str_to_date(ctx, ch, start, end)
        elif isinstance(to, TimestampType):
            out, ok = _dev_str_to_ts(ctx, ch, start, end)
        elif isinstance(to, DecimalType):
            out, ok = _dev_str_to_decimal(ctx, ch, start, end, to)
        elif isinstance(to, (FloatType, DoubleType)):
            out, ok = _dev_str_to_float(ctx, ch, start, end, to)
        elif isinstance(to, IntegralType):
            out, ok = _dev_str_to_int(ctx, ch, start, end, to, ansi=self.ansi)
        else:
            raise NotImplementedError(f"device cast string -> {to}")
        ok = ok & has_any
        if self.ansi:
            self._err(ctx, v.valid, ok, "invalid input")
        return Val(out, ctx.broadcast_bool(v.valid) & ok)

    def __str__(self):
        return f"cast({self.c} as {self.to})"


# ═══════════════════════════════ device kernels ════════════════════════════


def _dev_int_str(ctx: Ctx, data, src_dtype):
    """Integral → string bytes: sign + significant digits."""
    xp = ctx.xp
    v = xp.astype(data, xp.int64)
    k = _INT_DIGITS[np.dtype(src_dtype)]
    is_min = v == I64_MIN if k == 19 else xp.zeros(v.shape, dtype=bool)
    mag = xp.abs(xp.where(is_min, 0, v))
    D = _digits_msd(xp, mag, k)
    first = _first_sig(xp, D)
    neg = v < 0
    colidx = xp.arange(k, dtype=xp.int32)[None, :]
    sign_col = xp.astype(xp.where(neg, ord("-"), 0), xp.uint8)[:, None]
    slots = xp.concatenate([sign_col, xp.astype(D + 48, xp.uint8)], axis=1)
    keep = xp.concatenate(
        [neg[:, None], colidx >= first[:, None]], axis=1
    )
    packed, lens = _pack(ctx, slots, keep, k + 1)
    if k == 19:
        cbytes = np.zeros(packed.shape[1], dtype=np.uint8)
        cbytes[: len(LONG_MIN_STR)] = np.frombuffer(LONG_MIN_STR, dtype=np.uint8)
        packed = xp.where(is_min[:, None], xp.asarray(cbytes)[None, :], packed)
        lens = xp.astype(xp.where(is_min, len(LONG_MIN_STR), lens), xp.int32)
    return packed, lens


def _ymd_slots(xp, y, m, d):
    """[sign][y7][-][m2][-][d2] slot matrix + keep for a civil date."""
    neg = y < 0
    ymag = xp.abs(xp.astype(y, xp.int64))
    Dy = _digits_msd(xp, ymag, 7)
    first = _first_sig(xp, Dy)
    first = xp.minimum(first, 3)  # at least 4 year digits (zero-padded)
    Dm = _digits_msd(xp, xp.astype(m, xp.int64), 2)
    Dd = _digits_msd(xp, xp.astype(d, xp.int64), 2)
    n = y.shape[0]
    dash = xp.full((n, 1), ord("-"), dtype=xp.uint8)
    sign_col = xp.astype(xp.where(neg, ord("-"), 0), xp.uint8)[:, None]
    slots = xp.concatenate(
        [sign_col, xp.astype(Dy + 48, xp.uint8), dash, xp.astype(Dm + 48, xp.uint8),
         dash, xp.astype(Dd + 48, xp.uint8)],
        axis=1,
    )
    colidx = xp.arange(7, dtype=xp.int32)[None, :]
    ones = xp.ones((n, 1), dtype=bool)
    keep = xp.concatenate(
        [neg[:, None], colidx >= first[:, None], ones, xp.ones((n, 2), dtype=bool),
         ones, xp.ones((n, 2), dtype=bool)],
        axis=1,
    )
    return slots, keep


def _dev_date_str(ctx: Ctx, days):
    from .datetime import civil_from_days

    xp = ctx.xp
    y, m, d = civil_from_days(xp, days)
    slots, keep = _ymd_slots(xp, y, m, d)
    return _pack(ctx, slots, keep, slots.shape[1])


def _dev_ts_str(ctx: Ctx, micros):
    """yyyy-MM-dd HH:mm:ss[.ffffff] with the fraction's trailing zeros
    trimmed (Spark DateTimeUtils.timestampToString, UTC session zone)."""
    from .datetime import civil_from_days

    xp = ctx.xp
    micros = xp.astype(micros, xp.int64)
    days = xp.floor_divide(micros, MICROS_PER_DAY)
    tod = micros - days * MICROS_PER_DAY
    y, m, d = civil_from_days(xp, xp.astype(days, xp.int32))
    slots_d, keep_d = _ymd_slots(xp, y, m, d)
    secs = tod // US_PER_SECOND
    frac = xp.astype(tod - secs * US_PER_SECOND, xp.int64)
    hh = secs // 3600
    mi = (secs // 60) % 60
    ss = secs % 60
    n = micros.shape[0]

    def two(v):
        return xp.astype(_digits_msd(xp, xp.astype(v, xp.int64), 2) + 48, xp.uint8)

    sp = xp.full((n, 1), ord(" "), dtype=xp.uint8)
    col = xp.full((n, 1), ord(":"), dtype=xp.uint8)
    dot = xp.full((n, 1), ord("."), dtype=xp.uint8)
    F = _digits_msd(xp, frac, 6)
    has_frac = frac > 0
    # keep fraction digits up to the last nonzero
    last_nz = 5 - xp.astype(xp.argmax(xp.flip(F != 0, 1), axis=1), xp.int32)
    fidx = xp.arange(6, dtype=xp.int32)[None, :]
    keep_f = has_frac[:, None] & (fidx <= last_nz[:, None])
    slots = xp.concatenate(
        [slots_d, sp, two(hh), col, two(mi), col, two(ss), dot,
         xp.astype(F + 48, xp.uint8)],
        axis=1,
    )
    ones2 = xp.ones((n, 2), dtype=bool)
    ones1 = xp.ones((n, 1), dtype=bool)
    keep = xp.concatenate(
        [keep_d, ones1, ones2, ones1, ones2, ones1, ones2,
         has_frac[:, None], keep_f],
        axis=1,
    )
    return _pack(ctx, slots, keep, slots.shape[1])


def _dev_decimal_str(ctx: Ctx, unscaled, scale: int):
    """BigDecimal.toPlainString shape: [-]intdigits[.frac]; device decimals
    cap scale at the plain-notation region (planner gates scale > 6 where
    Java switches to scientific notation)."""
    xp = ctx.xp
    v = xp.astype(unscaled, xp.int64)
    neg = v < 0
    mag = xp.abs(v)
    D = _digits_msd(xp, mag, 19)
    n = v.shape[0]
    sign_col = xp.astype(xp.where(neg, ord("-"), 0), xp.uint8)[:, None]
    if scale == 0:
        first = _first_sig(xp, D)
        colidx = xp.arange(19, dtype=xp.int32)[None, :]
        slots = xp.concatenate([sign_col, xp.astype(D + 48, xp.uint8)], axis=1)
        keep = xp.concatenate([neg[:, None], colidx >= first[:, None]], axis=1)
        return _pack(ctx, slots, keep, 20)
    k_int = 19 - scale
    Di, Df = D[:, :k_int], D[:, k_int:]
    first = _first_sig(xp, Di)
    colidx = xp.arange(k_int, dtype=xp.int32)[None, :]
    dot = xp.full((n, 1), ord("."), dtype=xp.uint8)
    slots = xp.concatenate(
        [sign_col, xp.astype(Di + 48, xp.uint8), dot, xp.astype(Df + 48, xp.uint8)],
        axis=1,
    )
    keep = xp.concatenate(
        [neg[:, None], colidx >= first[:, None],
         xp.ones((n, 1 + scale), dtype=bool)],
        axis=1,
    )
    return _pack(ctx, slots, keep, slots.shape[1])


def _dev_float_str(ctx: Ctx, data, is32: bool):
    """Java Double/Float.toString on device: exact binary-mantissa
    extraction, correctly-rounded decimal digits via the double-double 10^s
    tables, shortest round-tripping prefix search, Java formatting rules.

    Verified digit-exact against the CPU (Java-rule) formatter over fuzzed
    normal doubles/floats across the full exponent range. Remaining
    divergence class: XLA flushes subnormals to zero (DAZ), so subnormal
    inputs format as ``0.0`` — which is why the pair sits behind
    ``castFloatToString.enabled`` (the reference gates it for cuDF's
    analogous formatting divergences)."""
    xp = ctx.xp
    maxd = 9 if is32 else 17
    x = xp.astype(data, xp.float64)
    mag = xp.abs(x)
    nan = xp.isnan(x)
    inf = xp.isinf(x)
    zero = mag == 0
    neg = _signbit(xp, x)
    safe = xp.where(nan | inf | zero, 1.0, mag)
    # exact binary mantissa: safe = m2 · 2^(be-52) with m2 ∈ [2^52, 2^53)
    # (power-of-two scaling is exact; log2 only seeds the integer estimate)
    be = xp.astype(xp.floor(xp.log2(safe)), xp.int64)

    def _m2(b):
        u = 52 - b
        u1 = xp.clip(u, -1000, 1000)
        return safe * _pow2f(xp, u1) * _pow2f(xp, u - u1)

    m2f = _m2(be)
    for _ in range(2):
        be = (
            be
            + xp.astype(m2f >= 2.0**53, be.dtype)
            - xp.astype(m2f < 2.0**52, be.dtype)
        )
        m2f = _m2(be)
    t = be - 52
    # correctly rounded maxd-digit decimal mantissa via the double-double
    # 10^s tables: only the final round of (m2 · 2^t · 10^s) is inexact
    e10 = xp.astype(xp.floor(xp.log10(safe)), xp.int64)
    m_full = xp.zeros(x.shape, dtype=xp.int64)
    for _ in range(2):
        s = (maxd - 1) - e10
        idx = xp.astype(xp.clip(s - _DD_MIN_S, 0, 700), xp.int32)
        mh = xp.take(xp.asarray(_DD_HI), idx)
        ml = xp.take(xp.asarray(_DD_LO), idx)
        E = xp.take(xp.asarray(_DD_E), idx)
        p2 = _pow2f(xp, t + E)  # P = (mh+ml)·2^(t+E) ∈ (1.1, 22.2] — exact
        p, err = _two_prod(xp, m2f, mh * p2)
        tot_err = err + m2f * (ml * p2)
        r0 = xp.round(p)
        rem = (p - r0) + tot_err
        m_full = xp.astype(r0, xp.int64) + xp.astype(xp.round(rem), xp.int64)
        # signed distance (true − m_full) in digit units: breaks exact-half
        # ties when rounding to shorter digit counts below
        frac_rem = rem - xp.round(rem)
        e10 = (
            e10
            + xp.astype(m_full >= 10**maxd, e10.dtype)
            - xp.astype(m_full < 10 ** (maxd - 1), e10.dtype)
        )
    m_full = xp.where(m_full >= 10**maxd, m_full // 10, m_full)
    m_full = xp.where(m_full < 10 ** (maxd - 1), m_full * 10, m_full)
    # shortest round-trip prefix length
    cmp_t = xp.float32 if is32 else xp.float64
    orig = xp.astype(xp.abs(data), cmp_t)
    best_len = xp.full(x.shape, maxd, dtype=xp.int32)
    best_m = m_full
    best_e = e10
    for L in range(maxd - 1, 0, -1):
        div = 10 ** (maxd - L)
        q = m_full // div
        r = m_full - q * div
        half = div // 2
        at_half = r == half
        up_at_half = (frac_rem > 0) | ((frac_rem == 0) & (q % 2 == 1))
        q = q + xp.astype((r > half) | (at_half & up_at_half), xp.int64)
        bumped = q >= 10**L
        q2 = xp.where(bumped, q // 10, q)
        eL = e10 + bumped
        rexp = eL - (L - 1)
        recon = _dec_to_float(xp, q2, rexp)
        ok = xp.astype(recon, cmp_t) == orig
        best_len = xp.where(ok, L, best_len)
        best_m = xp.where(ok, q2 * (10 ** (maxd - L)), best_m)
        best_e = xp.where(ok, eL, best_e)
    D = _digits_msd(xp, best_m, maxd)  # best digits, MSD first, zero-padded
    nd = best_len
    a = best_e  # adjusted exponent: value = d.ddd * 10^a
    n = x.shape[0]
    plain = (a >= -3) & (a < 7) & ~(nan | inf)
    # layout: [sign][8 int digits][.][frac digits][E][-][3 exp digits]
    # int part for plain: a+1 digits (a "0" placeholder when value < 1)
    int_cnt = xp.astype(xp.where(plain, xp.maximum(a + 1, 1), 1), xp.int32)
    islots = []
    ikeeps = []
    for j in range(8):
        jj = xp.full((n,), j, dtype=xp.int32)
        if j < maxd:
            dig = xp.astype(D[:, j], xp.uint8)
        else:
            dig = xp.zeros(n, dtype=xp.uint8)
        # leading "0" when |x| < 1 (int_cnt == 1 & a < 0 → digit "0")
        use_zero = plain & (a < 0) & (jj == 0)
        dig = xp.where(use_zero, 0, dig)
        islots.append(xp.astype(dig + 48, xp.uint8))
        ikeeps.append(jj < int_cnt)
    # fraction digits: for plain: digits int_cnt.. (skip when a<0: leading
    # zeros then all nd digits); scientific: digits 1..
    zcnt = xp.astype(xp.where(plain & (a < 0), -a - 1, 0), xp.int32)  # 0.00ddd
    fstart = xp.where(plain & (a >= 0), int_cnt, xp.where(plain, 0, 1))
    fslots = []
    fkeeps = []
    fcols = int(maxd + 3)  # frac zeros (≤2) + digits
    for j in range(fcols):
        jj = xp.full((n,), j, dtype=xp.int32)
        is_zero_pad = jj < zcnt
        didx = jj - zcnt + fstart
        dig = xp.zeros(n, dtype=xp.int64)
        for k in range(maxd):
            dig = xp.where(didx == k, xp.astype(D[:, k], xp.int64), dig)
        dig = xp.where(is_zero_pad, 0, dig)
        in_digits = (didx >= fstart) & (didx < nd)
        keep = is_zero_pad | in_digits
        fslots.append(xp.astype(dig + 48, xp.uint8))
        fkeeps.append(keep)
    # at least one fraction digit: when none kept, keep "0"
    any_frac = fkeeps[0]
    for kf in fkeeps[1:]:
        any_frac = any_frac | kf
    fkeeps[0] = fkeeps[0] | ~any_frac
    fslots[0] = xp.astype(xp.where(fkeeps[0] & ~any_frac, ord("0"), fslots[0]), xp.uint8)
    # exponent slots
    aneg = a < 0
    amag = xp.abs(a)
    Ae = _digits_msd(xp, amag, 3)
    efirst = _first_sig(xp, Ae)
    sci = ~plain & ~(nan | inf)
    dotc = xp.full((n, 1), ord("."), dtype=xp.uint8)
    slots = xp.concatenate(
        [xp.astype(xp.where(neg, ord("-"), 0), xp.uint8)[:, None]]
        + [s[:, None] for s in islots]
        + [dotc]
        + [s[:, None] for s in fslots]
        + [xp.full((n, 1), ord("E"), dtype=xp.uint8),
           xp.full((n, 1), ord("-"), dtype=xp.uint8)]
        + [xp.astype(Ae[:, k] + 48, xp.uint8)[:, None] for k in range(3)],
        axis=1,
    )
    keep = xp.concatenate(
        [(neg & ~nan)[:, None]]
        + [k[:, None] for k in ikeeps]
        + [xp.ones((n, 1), dtype=bool)]
        + [k[:, None] for k in fkeeps]
        + [sci[:, None], (sci & aneg)[:, None]]
        + [(sci & (xp.full((n,), k, dtype=xp.int32) >= efirst))[:, None]
           for k in range(3)],
        axis=1,
    )
    packed, lens = _pack(ctx, slots, keep, slots.shape[1])
    # specials overwrite
    for mask, txt in (
        (nan, b"NaN"),
        (inf & ~neg, b"Infinity"),
        (inf & neg, b"-Infinity"),
        (zero & ~neg, b"0.0"),
        (zero & neg, b"-0.0"),
    ):
        cb = np.zeros(packed.shape[1], dtype=np.uint8)
        cb[: len(txt)] = np.frombuffer(txt, dtype=np.uint8)
        packed = xp.where(mask[:, None], xp.asarray(cb)[None, :], packed)
        lens = xp.astype(xp.where(mask, len(txt), lens), xp.int32)
    return packed, lens


def _dev_str_to_int(ctx: Ctx, ch, start, end, to: DataType, ansi: bool = False):
    """Spark UTF8String.toLong semantics over the trimmed region —
    Java Long.parseLong's negative accumulation, so ``-2^63`` parses.
    Non-ANSI additionally accepts a decimal tail (``'1.5' → 1``, truncation
    toward zero), matching the reference castStringToInts regex
    ``^([+\\-]?[0-9]+)(?:\\.[0-9]*)?$``; ANSI rejects it like Spark's
    toLongExact."""
    xp = ctx.xp
    n, w = ch.shape
    idx = xp.arange(w, dtype=xp.int32)[None, :]
    first_ch = _char_at(ctx, ch, start)
    has_sign = (first_ch == ord("-")) | (first_ch == ord("+"))
    neg = first_ch == ord("-")
    dstart = start + xp.astype(has_sign, xp.int32)
    is_digit = (ch >= 48) & (ch <= 57)
    in_region = (idx >= dstart[:, None]) & (idx < end[:, None])
    dot_in = (ch == ord(".")) & in_region
    has_dot = dot_in.any(axis=1)
    first_dot = xp.astype(xp.argmax(dot_in, axis=1), xp.int32)
    int_end = xp.where(has_dot, first_dot, end)
    digit_region = (idx >= dstart[:, None]) & (idx < int_end[:, None])
    frac_region = (idx > int_end[:, None]) & (idx < end[:, None])
    ok_chars = xp.where(digit_region | frac_region, is_digit, True).all(axis=1)
    # UTF8String.toInt: the integer part may be EMPTY when a separator is
    # present ('.5' → 0, '-.5' → 0 on CPU Spark); only sign-alone /
    # fully-empty inputs are rejected
    has_digit = (is_digit & digit_region).any(axis=1) | (
        has_dot & (dstart < end)
    )
    if ansi:
        ok_chars = ok_chars & ~has_dot
        has_digit = (is_digit & digit_region).any(axis=1)
    limit = xp.where(
        neg,
        xp.asarray(I64_MIN, dtype=xp.int64),
        xp.asarray(-(2**63 - 1), dtype=xp.int64),
    )
    # limit/10 truncated toward zero — same value for both limits
    multmin = xp.asarray(-((2**63 - 1) // 10), dtype=xp.int64)
    acc = xp.zeros(n, dtype=xp.int64)
    overflow = xp.zeros(n, dtype=bool)
    for j in range(w):
        d = xp.astype(ch[:, j] - 48, xp.int64)
        use = digit_region[:, j] & is_digit[:, j]
        overflow = overflow | (use & (acc < multmin))
        nxt = acc * 10
        overflow = overflow | (use & (nxt < limit + d))
        acc = xp.where(use, nxt - d, acc)
    out = xp.where(neg, acc, -acc)
    ok = ok_chars & has_digit & ~overflow
    lo, hi = _INT_BOUNDS[to.np_dtype]
    ok = ok & (out >= lo) & (out <= hi)
    return xp.astype(out, to.np_dtype), ok


def _dev_str_to_bool(ctx: Ctx, ch, start, end):
    """Spark StringUtils.isTrueString/isFalseString (case-insensitive)."""
    xp = ctx.xp
    lower = xp.astype(xp.where(
        (ch >= ord("A")) & (ch <= ord("Z")), ch + 32, ch
    ), xp.uint8)
    ln = end - start

    def matches(tok: bytes):
        m = ln == len(tok)
        for k, b in enumerate(tok):
            m = m & (_char_at(ctx, lower, start + k) == b)
        return m

    is_true = (
        matches(b"true") | matches(b"t") | matches(b"yes") | matches(b"y")
        | matches(b"1")
    )
    is_false = (
        matches(b"false") | matches(b"f") | matches(b"no") | matches(b"n")
        | matches(b"0")
    )
    return is_true, is_true | is_false


def _dev_parse_date_part(ctx: Ctx, ch, start, end):
    """Parse [+-]y{1,7}[-m{1,2}[-d{1,2}]] in [start, end) → (days, ok)."""
    from .datetime import days_from_civil

    xp = ctx.xp
    first_ch = _char_at(ctx, ch, start)
    has_sign = (first_ch == ord("-")) | (first_ch == ord("+"))
    neg = first_ch == ord("-")
    p = start + xp.astype(has_sign, xp.int32)
    d1, f1 = _find_char(ctx, ch, ord("-"), p, end)
    d2, f2 = _find_char(ctx, ch, ord("-"), d1 + 1, end)
    y_end = xp.where(f1, d1, end)
    yv, y_ok = _parse_digits(ctx, ch, p, y_end, max_digits=6)
    m_end = xp.where(f2, d2, end)
    mv, m_ok = _parse_digits(ctx, ch, d1 + 1, m_end, max_digits=2)
    dv, dd_ok = _parse_digits(ctx, ch, d2 + 1, end, max_digits=2)
    mv = xp.where(f1, mv, 1)
    dv = xp.where(f2, dv, 1)
    ok = y_ok & xp.where(f1, m_ok, True) & xp.where(f2, dd_ok, True)
    y = xp.astype(xp.where(neg, -yv, yv), xp.int32)
    m = xp.astype(mv, xp.int32)
    d = xp.astype(dv, xp.int32)
    ok = ok & (m >= 1) & (m <= 12) & (d >= 1)
    m_c = xp.clip(m, 1, 12)
    ok = ok & (d <= _days_in_month(xp, y, m_c))
    days = days_from_civil(xp, y, m_c, xp.clip(d, 1, 31))
    return xp.astype(days, xp.int32), ok


def _dev_str_to_date(ctx: Ctx, ch, start, end):
    """Spark DateTimeUtils.stringToDate: the date segment grammar with
    anything from 'T' onward ignored."""
    xp = ctx.xp
    t_pos, has_t = _find_char(ctx, ch, ord("T"), start, end)
    date_end = xp.where(has_t, t_pos, end)
    return _dev_parse_date_part(ctx, ch, start, date_end)


def _dev_str_to_ts(ctx: Ctx, ch, start, end):
    """Spark DateTimeUtils.stringToTimestamp, UTC-only subset:
    date ['T'|' ' h{1,2}:m{1,2}:s{1,2}[.f{0,6}]]['Z']."""
    xp = ctx.xp
    last = _char_at(ctx, ch, end - 1)
    has_z = (last == ord("Z")) & (end > start)
    end = xp.where(has_z, end - 1, end)
    t1, f1 = _find_char(ctx, ch, ord("T"), start, end)
    t2, f2 = _find_char(ctx, ch, ord(" "), start, end)
    sep = xp.minimum(t1, t2)
    has_time = f1 | f2
    date_end = xp.where(has_time, sep, end)
    days, d_ok = _dev_parse_date_part(ctx, ch, start, date_end)
    t0 = sep + 1
    c1, g1 = _find_char(ctx, ch, ord(":"), t0, end)
    c2, g2 = _find_char(ctx, ch, ord(":"), c1 + 1, end)
    hv, h_ok = _parse_digits(ctx, ch, t0, c1, max_digits=2)
    mv, m_ok = _parse_digits(ctx, ch, c1 + 1, xp.where(g2, c2, end), max_digits=2)
    dot, has_dot = _find_char(ctx, ch, ord("."), c2 + 1, end)
    s_end = xp.where(has_dot, dot, end)
    sv, s_ok = _parse_digits(ctx, ch, c2 + 1, s_end, max_digits=2)
    fv, f_ok = _parse_digits(ctx, ch, dot + 1, end, max_digits=6)
    f_ok = f_ok | (end == dot + 1)  # trailing '.' with no digits is valid
    fdigits = xp.clip(end - (dot + 1), 0, 6)
    mult = xp.zeros(fdigits.shape, dtype=xp.int64)
    for k in range(7):
        mult = xp.where(fdigits == k, 10 ** (6 - k), mult)
    micros_frac = xp.where(has_dot, fv * mult, 0)
    time_ok = (
        g1 & g2 & h_ok & m_ok & s_ok
        & xp.where(has_dot, f_ok, True)
        & (hv < 24) & (mv < 60) & (sv < 60)
    )
    tod = xp.where(
        has_time,
        (hv * 3600 + mv * 60 + sv) * US_PER_SECOND + micros_frac,
        0,
    )
    ok = d_ok & xp.where(has_time, time_ok, True)
    micros = xp.astype(days, xp.int64) * MICROS_PER_DAY + tod
    return micros, ok


def _dev_str_to_float(ctx: Ctx, ch, start, end, to: DataType):
    """Decimal-notation float parse: [+-]digits[.digits][eE[+-]digits] plus
    the special literals inf/infinity/nan (Spark Cast string→double).
    Gated: binary result can differ from strtod in the last ulp for extreme
    exponents (the reference gates castStringToFloat for the same class)."""
    xp = ctx.xp
    n, w = ch.shape
    lower = xp.astype(xp.where((ch >= 65) & (ch <= 90), ch + 32, ch), xp.uint8)
    first_ch = _char_at(ctx, ch, start)
    has_sign = (first_ch == ord("-")) | (first_ch == ord("+"))
    neg = first_ch == ord("-")
    p = start + xp.astype(has_sign, xp.int32)
    ln = end - p

    def matches(tok: bytes):
        m = ln == len(tok)
        for k, b in enumerate(tok):
            m = m & (_char_at(ctx, lower, p + k) == b)
        return m

    is_inf = matches(b"inf") | matches(b"infinity")
    is_nan = matches(b"nan")
    # exponent marker
    e_pos, has_e = _find_char(ctx, lower, ord("e"), p, end)
    mant_end = xp.where(has_e, e_pos, end)
    dot, has_dot = _find_char(ctx, ch, ord("."), p, mant_end)
    int_end = xp.where(has_dot, dot, mant_end)
    idx = xp.arange(w, dtype=xp.int32)[None, :]
    is_digit = (ch >= 48) & (ch <= 57)
    # mantissa digits: integer part then fraction; cap significance at 18
    acc = xp.zeros(n, dtype=xp.int64)
    ndig = xp.zeros(n, dtype=xp.int32)  # significant digits consumed
    extra_exp = xp.zeros(n, dtype=xp.int32)  # dropped int digits
    frac_cnt = xp.zeros(n, dtype=xp.int32)
    int_any = xp.zeros(n, dtype=bool)
    frac_any = xp.zeros(n, dtype=bool)
    bad = xp.zeros(n, dtype=bool)
    for j in range(w):
        in_int = (idx[0, j] >= p) & (idx[0, j] < int_end)
        in_frac = has_dot & (idx[0, j] > dot) & (idx[0, j] < mant_end)
        dig = is_digit[:, j]
        d = xp.astype(ch[:, j] - 48, xp.int64)
        bad = bad | ((in_int | in_frac) & ~dig)
        room = ndig < 18
        take_int = in_int & dig
        take_frac = in_frac & dig
        acc = xp.where((take_int | take_frac) & room, acc * 10 + d, acc)
        ndig = ndig + xp.astype((take_int | take_frac) & room, xp.int32)
        extra_exp = extra_exp + xp.astype(take_int & ~room, xp.int32)
        frac_cnt = frac_cnt + xp.astype(take_frac & room, xp.int32)
        int_any = int_any | take_int
        frac_any = frac_any | take_frac
    # exponent
    e_first = _char_at(ctx, ch, e_pos + 1)
    e_sign = (e_first == ord("-")) | (e_first == ord("+"))
    e_neg = e_first == ord("-")
    # 8 exponent digits: anything past ±350 saturates to ±inf / 0 in
    # _dec_to_float exactly like strtod overflow/underflow
    ev, e_ok = _parse_digits(
        ctx, ch, e_pos + 1 + xp.astype(e_sign, xp.int32), end, max_digits=8
    )
    ev = xp.clip(ev, 0, 100_000)
    ev = xp.astype(xp.where(e_neg, -ev, ev), xp.int32)
    exp_total = xp.where(has_e, ev, 0) + extra_exp - frac_cnt
    # negative exponents divide by the (exactly representable for |e| ≤ 22)
    # power instead of multiplying by its inexact reciprocal — the strtod
    # fast path, so results match the CPU parse for ordinary literals
    val = _dec_to_float(xp, acc, exp_total)
    ok_num = (int_any | frac_any) & ~bad & xp.where(has_e, e_ok, True)
    out = xp.where(is_inf, xp.inf, xp.where(is_nan, xp.nan, val))
    out = xp.where(neg, -out, out)
    ok = ok_num | is_inf | is_nan
    return xp.astype(out, to.np_dtype), ok


def _dev_str_to_decimal(ctx: Ctx, ch, start, end, to: DecimalType):
    """[+-]digits[.digits][eE[+-]digits] → unscaled int64 at to.scale,
    rounding HALF_UP (Spark Decimal.changePrecision)."""
    xp = ctx.xp
    n, w = ch.shape
    lower = xp.astype(xp.where((ch >= 65) & (ch <= 90), ch + 32, ch), xp.uint8)
    first_ch = _char_at(ctx, ch, start)
    has_sign = (first_ch == ord("-")) | (first_ch == ord("+"))
    neg = first_ch == ord("-")
    p = start + xp.astype(has_sign, xp.int32)
    e_pos, has_e = _find_char(ctx, lower, ord("e"), p, end)
    mant_end = xp.where(has_e, e_pos, end)
    dot, has_dot = _find_char(ctx, ch, ord("."), p, mant_end)
    int_end = xp.where(has_dot, dot, mant_end)
    idx = xp.arange(w, dtype=xp.int32)[None, :]
    is_digit = (ch >= 48) & (ch <= 57)
    acc = xp.zeros(n, dtype=xp.int64)
    frac_cnt = xp.zeros(n, dtype=xp.int32)
    any_dig = xp.zeros(n, dtype=bool)
    bad = xp.zeros(n, dtype=bool)
    overflow = xp.zeros(n, dtype=bool)
    hi = xp.asarray(2**62, dtype=xp.int64)
    for j in range(w):
        in_int = (idx[0, j] >= p) & (idx[0, j] < int_end)
        in_frac = has_dot & (idx[0, j] > dot) & (idx[0, j] < mant_end)
        dig = is_digit[:, j]
        d = xp.astype(ch[:, j] - 48, xp.int64)
        bad = bad | ((in_int | in_frac) & ~dig)
        take = (in_int | in_frac) & dig
        overflow = overflow | (take & (acc > hi // 10))
        acc = xp.where(take, acc * 10 + d, acc)
        frac_cnt = frac_cnt + xp.astype(in_frac & dig, xp.int32)
        any_dig = any_dig | take
    e_first = _char_at(ctx, ch, e_pos + 1)
    e_sign = (e_first == ord("-")) | (e_first == ord("+"))
    e_neg = e_first == ord("-")
    ev, e_ok = _parse_digits(
        ctx, ch, e_pos + 1 + xp.astype(e_sign, xp.int32), end, max_digits=4
    )
    ev = xp.clip(ev, 0, 10_000)
    ev = xp.astype(xp.where(e_neg, -ev, ev), xp.int32)
    shift = to.scale - frac_cnt + xp.where(has_e, ev, 0)
    # apply shift: multiply (overflow-check) or divide with HALF_UP rounding
    out = acc
    for s in range(1, 19):
        up = shift == s
        pw = 10**s
        overflow = overflow | (up & (xp.abs(out) > (2**63 - 1) // pw))
        out = xp.where(up, out * pw, out)
    for s in range(1, 19):
        dn = shift == -s
        pw = 10**s
        q = out // pw
        r = out - q * pw
        q = q + xp.astype(2 * r >= pw, xp.int64)
        out = xp.where(dn, q, out)
    overflow = overflow | ((shift > 18) & (acc != 0))
    out = xp.where(xp.abs(shift) > 18, 0, out)
    lim = 10**to.precision - 1
    ok = any_dig & ~bad & ~overflow & xp.where(has_e, e_ok, True)
    ok = ok & (out <= lim)
    out = xp.where(neg, -out, out)
    return out, ok


# ═══════════════════════════════ CPU oracle ════════════════════════════════


def _cpu_date_str(days: int) -> str:
    y, m, d = _civil(days)
    sign = "-" if y < 0 else ""
    return f"{sign}{abs(y):04d}-{m:02d}-{d:02d}"


def _cpu_ts_str(micros: int) -> str:
    days, tod = divmod(micros, MICROS_PER_DAY)
    y, m, d = _civil(days)
    secs, frac = divmod(tod, US_PER_SECOND)
    hh, rem = divmod(secs, 3600)
    mi, ss = divmod(rem, 60)
    sign = "-" if y < 0 else ""
    base = f"{sign}{abs(y):04d}-{m:02d}-{d:02d} {hh:02d}:{mi:02d}:{ss:02d}"
    if frac:
        base += ("." + f"{frac:06d}").rstrip("0")
    return base


def _cpu_decimal_str(unscaled: int, scale: int) -> str:
    """java.math.BigDecimal.toString (Spark Decimal.toString)."""
    import decimal as _dec

    return str(_dec.Decimal(unscaled).scaleb(-scale))


def _civil(z: int):
    z += 719468
    era = z // 146097
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = mp + (3 if mp < 10 else -9)
    return y + (m <= 2), m, d


def _days_from_civil_py(y: int, m: int, d: int) -> int:
    y -= m <= 2
    era = y // 400
    yoe = y - era * 400
    doy = (153 * (m + (-3 if m > 2 else 9)) + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


def _cpu_parse_date_part(s: str):
    """Python mirror of _dev_parse_date_part (the single source of the
    grammar both backends implement)."""
    if not s:
        return None
    neg = s[0] == "-"
    if s[0] in "+-":
        s = s[1:]
    segs = s.split("-")
    if len(segs) > 3 or not segs[0]:
        return None
    try:
        vals = [int(x) for x in segs]
    except ValueError:
        return None
    if any(not x.isdigit() for x in segs):
        return None
    if len(segs[0]) > 6 or any(len(x) > 2 for x in segs[1:]):
        return None
    y = vals[0] * (-1 if neg else 1)
    m = vals[1] if len(vals) > 1 else 1
    d = vals[2] if len(vals) > 2 else 1
    if not (1 <= m <= 12 and 1 <= d):
        return None
    dim = _days_from_civil_py(y + (m == 12), 1 if m == 12 else m + 1, 1) - (
        _days_from_civil_py(y, m, 1)
    )
    if d > dim:
        return None
    return _days_from_civil_py(y, m, d)


def _cpu_parse(s: str, to: DataType, ansi: bool = False):
    """CPU string parse for one value; None on malformed (→ NULL)."""
    s = s.strip(
        "".join(chr(c) for c in range(0x21))
    )  # UTF8String.trimAll: all ctrl/space ≤ 0x20
    if not s.isascii():
        # Spark's UTF8String parsers are ASCII-only; python's int()/Decimal()
        # accept full-width Unicode digits — reject them to match
        return None
    if isinstance(to, BooleanType):
        ls = s.lower()
        if ls in ("true", "t", "yes", "y", "1"):
            return True
        if ls in ("false", "f", "no", "n", "0"):
            return False
        return None
    if isinstance(to, DateType):
        return _cpu_parse_date_part(s.split("T")[0])
    if isinstance(to, TimestampType):
        if s.endswith("Z"):
            s = s[:-1]
        sep = None
        for c in ("T", " "):
            if c in s:
                sep = c
                break
        if sep is None:
            days = _cpu_parse_date_part(s)
            return None if days is None else days * MICROS_PER_DAY
        date_s, _, time_s = s.partition(sep)
        days = _cpu_parse_date_part(date_s)
        if days is None:
            return None
        parts = time_s.split(":")
        if len(parts) != 3:
            return None
        try:
            h, mi = int(parts[0]), int(parts[1])
            sec_s, _, frac_s = parts[2].partition(".")
            sec = int(sec_s)
            if len(parts[0]) > 2 or len(parts[1]) > 2 or len(sec_s) > 2:
                return None
            frac = 0
            if frac_s:
                if len(frac_s) > 6 or not frac_s.isdigit():
                    return None
                frac = int(frac_s) * 10 ** (6 - len(frac_s))
        except ValueError:
            return None
        if not (h < 24 and mi < 60 and sec < 60):
            return None
        return days * MICROS_PER_DAY + (h * 3600 + mi * 60 + sec) * US_PER_SECOND + frac
    if isinstance(to, DecimalType):
        import decimal as _dec

        try:
            d = _dec.Decimal(s)
        except _dec.InvalidOperation:
            return None
        if not d.is_finite():
            return None
        unscaled = int(
            d.scaleb(to.scale).to_integral_value(rounding=_dec.ROUND_HALF_UP)
        )
        if abs(unscaled) > 10**to.precision - 1:
            return None
        return unscaled
    if isinstance(to, (FloatType, DoubleType)):
        ls = s.lower()
        sign = -1.0 if ls.startswith("-") else 1.0
        core = ls.lstrip("+-")
        if core in ("inf", "infinity"):
            return sign * float("inf")
        if core == "nan":
            return float("nan")
        if "_" in s or "x" in ls:  # Python literal-isms Java rejects
            return None
        try:
            return to.np_dtype.type(s)
        except (TypeError, ValueError):
            return None
    if isinstance(to, IntegralType):
        sign = s[:1] if s[:1] in "+-" else ""
        body = s[1:] if sign else s
        had_dot = False
        if not ansi and "." in body:
            # UTF8String.toLong truncation: '1.5' → 1 when the tail after
            # '.' is all digits (or empty); the integer part may itself be
            # empty ('.5' → 0); ANSI rejects like toLongExact
            intpart, _, frac = body.partition(".")
            if frac and not frac.isdigit():
                return None
            body = intpart
            had_dot = True
        if not body.isdigit():
            if not (had_dot and body == ""):
                return None
            body = "0"
        try:
            val = int(sign + body)
        except (TypeError, ValueError):
            return None
        lo, hi = _INT_BOUNDS[to.np_dtype]
        return val if lo <= val <= hi else None
    return None


# ═══════════════════════════════ planner gate ══════════════════════════════


def can_cast_on_device(frm: DataType, to: DataType, conf) -> bool:
    """TypeChecks-style gate used by the planner (GpuCast type matrix)."""
    from .. import config as cfg
    from ..types import is_complex

    if is_complex(frm) or is_complex(to):
        return False
    if isinstance(frm, StringType):
        if isinstance(to, (FloatType, DoubleType)):
            return conf.is_enabled(cfg.CAST_STRING_TO_FLOAT)
        if isinstance(to, TimestampType):
            return conf.is_enabled(cfg.CAST_STRING_TO_TIMESTAMP)
        return isinstance(
            to, (IntegralType, BooleanType, DateType, DecimalType, StringType)
        )
    if isinstance(to, StringType):
        if isinstance(frm, (FloatType, DoubleType)):
            return conf.is_enabled(cfg.CAST_FLOAT_TO_STRING)
        if isinstance(frm, DecimalType):
            # Java switches to scientific notation beyond scale 6 leading
            # zeros; the device kernel only emits plain notation
            return frm.scale <= 6
        return True
    return True
