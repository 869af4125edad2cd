"""Date/time expressions — the analogue of datetimeExpressions.scala +
DateUtils.scala (~1000 LoC in the reference).

Storage (types.py): DATE = int32 days since epoch, TIMESTAMP = int64
microseconds since epoch, UTC. Like the reference — which tags timestamp ops
off-device unless the session zone is UTC (GpuOverrides timezone checks) —
all semantics here are UTC.

Calendar math uses Howard Hinnant's civil-date algorithms (public domain):
pure integer floor-div/mod, so ONE implementation serves the numpy oracle and
the XLA device path bit-identically, and XLA fuses it into surrounding
expression code. No table lookups, no data-dependent control flow.

Copied from ``spark_rapids_tpu/expr/datetime.py``.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..types import (
    DATE,
    INT,
    DataType,
    DateType,
    IntegerType,
    TimestampType,
)
from .base import BinaryExpression, Ctx, Expression, UnaryExpression, Val, and_valid

US_PER_DAY = 86_400_000_000
US_PER_SECOND = 1_000_000


def civil_from_days(xp, z):
    """days-since-epoch → (year, month, day). Hinnant civil_from_days."""
    z = xp.astype(z, xp.int64) + 719468
    era = xp.floor_divide(z, 146097)
    doe = z - era * 146097
    yoe = xp.floor_divide(
        doe - xp.floor_divide(doe, 1460) + xp.floor_divide(doe, 36524) - xp.floor_divide(doe, 146096),
        365,
    )
    y = yoe + era * 400
    doy = doe - (365 * yoe + xp.floor_divide(yoe, 4) - xp.floor_divide(yoe, 100))
    mp = xp.floor_divide(5 * doy + 2, 153)
    d = doy - xp.floor_divide(153 * mp + 2, 5) + 1
    m = mp + xp.where(mp < 10, 3, -9)
    y = y + (m <= 2)
    return xp.astype(y, xp.int32), xp.astype(m, xp.int32), xp.astype(d, xp.int32)


def days_from_civil(xp, y, m, d):
    """(year, month, day) → days since epoch. Hinnant days_from_civil."""
    y = xp.astype(y, xp.int64) - xp.astype(m <= 2, xp.int64)
    era = xp.floor_divide(y, 400)
    yoe = y - era * 400
    doy = xp.floor_divide(153 * (m + xp.where(m > 2, -3, 9)) + 2, 5) + d - 1
    doe = yoe * 365 + xp.floor_divide(yoe, 4) - xp.floor_divide(yoe, 100) + doy
    return xp.astype(era * 146097 + doe - 719468, xp.int32)


def _as_days(ctx: Ctx, e: Expression, data):
    """Normalize a date or timestamp operand to days since epoch."""
    xp = ctx.xp
    if isinstance(e.data_type, TimestampType):
        return xp.astype(xp.floor_divide(xp.astype(data, xp.int64), US_PER_DAY), xp.int32)
    return xp.astype(data, xp.int32)


class _DateField(UnaryExpression):
    """Unary int field extracted from a date (timestamps floor to days)."""

    @property
    def data_type(self) -> DataType:
        return INT

    def eval(self, ctx: Ctx) -> Val:
        c = self.child.eval(ctx)
        days = _as_days(ctx, self.child, ctx.broadcast(c.data))
        return Val(self._field(ctx, days), c.valid)


@dataclass(frozen=True)
class Year(_DateField):
    c: Expression

    def _field(self, ctx, days):
        y, _, _ = civil_from_days(ctx.xp, days)
        return y


@dataclass(frozen=True)
class Month(_DateField):
    c: Expression

    def _field(self, ctx, days):
        _, m, _ = civil_from_days(ctx.xp, days)
        return m


@dataclass(frozen=True)
class DayOfMonth(_DateField):
    c: Expression

    def _field(self, ctx, days):
        _, _, d = civil_from_days(ctx.xp, days)
        return d


@dataclass(frozen=True)
class Quarter(_DateField):
    c: Expression

    def _field(self, ctx, days):
        xp = ctx.xp
        _, m, _ = civil_from_days(xp, days)
        return xp.astype(xp.floor_divide(m - 1, 3) + 1, xp.int32)


@dataclass(frozen=True)
class DayOfWeek(_DateField):
    """Spark dayofweek: 1 = Sunday … 7 = Saturday."""

    c: Expression

    def _field(self, ctx, days):
        xp = ctx.xp
        return xp.astype(xp.mod(xp.astype(days, xp.int64) + 4, 7) + 1, xp.int32)


@dataclass(frozen=True)
class WeekDay(_DateField):
    """Spark weekday: 0 = Monday … 6 = Sunday."""

    c: Expression

    def _field(self, ctx, days):
        xp = ctx.xp
        return xp.astype(xp.mod(xp.astype(days, xp.int64) + 3, 7), xp.int32)


@dataclass(frozen=True)
class DayOfYear(_DateField):
    c: Expression

    def _field(self, ctx, days):
        xp = ctx.xp
        y, _, _ = civil_from_days(xp, days)
        jan1 = days_from_civil(
            xp, y, xp.full_like(y, 1), xp.full_like(y, 1)
        )
        return xp.astype(days - jan1 + 1, xp.int32)


@dataclass(frozen=True)
class WeekOfYear(_DateField):
    """ISO-8601 week number (Spark ``weekofyear``): the week containing the
    year's first Thursday is week 1; Monday-based weeks."""

    c: Expression

    def _field(self, ctx: Ctx, days):
        xp = ctx.xp
        y, _, _ = civil_from_days(xp, days)
        # ISO weekday 1..7 (1970-01-01 was a Thursday = 4)
        dow = (xp.mod(xp.astype(days, xp.int64), 7) + 3) % 7 + 1
        jan1 = days_from_civil(xp, y, xp.full_like(y, 1), xp.full_like(y, 1))
        doy = xp.astype(days - jan1 + 1, xp.int64)
        w = xp.floor_divide(doy - dow + 10, 7)

        def weeks_in(year):
            j1 = days_from_civil(
                xp, year, xp.full_like(year, 1), xp.full_like(year, 1)
            )
            jdow = (xp.mod(xp.astype(j1, xp.int64), 7) + 3) % 7 + 1
            leap = ((year % 4 == 0) & (year % 100 != 0)) | (year % 400 == 0)
            return 52 + xp.astype((jdow == 4) | (leap & (jdow == 3)), xp.int64)

        w = xp.where(w < 1, weeks_in(y - 1), w)
        w = xp.where(w > weeks_in(y), 1, w)
        return xp.astype(w, xp.int32)


@dataclass(frozen=True)
class LastDay(UnaryExpression):
    """Last day of the month of the given date (returns DATE)."""

    c: Expression

    @property
    def data_type(self) -> DataType:
        return DATE

    def _compute(self, ctx: Ctx, data):
        xp = ctx.xp
        days = _as_days(ctx, self.child, ctx.broadcast(data))
        y, m, _ = civil_from_days(xp, days)
        ny = xp.where(m == 12, y + 1, y)
        nm = xp.where(m == 12, 1, m + 1)
        return xp.astype(days_from_civil(xp, ny, nm, xp.full_like(nm, 1)) - 1, xp.int32)


@dataclass(frozen=True)
class DateAdd(BinaryExpression):
    """date + int days (Spark date_add; timestamps floor to days like the
    analyzer's timestamp→date coercion)."""

    start: Expression
    days: Expression

    @property
    def data_type(self) -> DataType:
        return DATE

    def _compute(self, ctx: Ctx, l, r):
        xp = ctx.xp
        days = _as_days(ctx, self.start, ctx.broadcast(l))
        return xp.astype(days + xp.astype(r, xp.int32), xp.int32)


@dataclass(frozen=True)
class DateSub(BinaryExpression):
    start: Expression
    days: Expression

    @property
    def data_type(self) -> DataType:
        return DATE

    def _compute(self, ctx: Ctx, l, r):
        xp = ctx.xp
        days = _as_days(ctx, self.start, ctx.broadcast(l))
        return xp.astype(days - xp.astype(r, xp.int32), xp.int32)


@dataclass(frozen=True)
class DateDiff(BinaryExpression):
    """end - start in days (Spark datediff)."""

    end: Expression
    start: Expression

    @property
    def data_type(self) -> DataType:
        return INT

    def _compute(self, ctx: Ctx, l, r):
        xp = ctx.xp
        le = _as_days(ctx, self.end, ctx.broadcast(l))
        rs = _as_days(ctx, self.start, ctx.broadcast(r))
        return xp.astype(le - rs, xp.int32)


@dataclass(frozen=True)
class AddMonths(BinaryExpression):
    """date + n months, day clamped to the target month's last day."""

    start: Expression
    months: Expression

    @property
    def data_type(self) -> DataType:
        return DATE

    def _compute(self, ctx: Ctx, l, r):
        xp = ctx.xp
        days = _as_days(ctx, self.start, ctx.broadcast(l))
        y, m, d = civil_from_days(xp, days)
        total = xp.astype(y, xp.int64) * 12 + (m - 1) + xp.astype(r, xp.int64)
        ny = xp.astype(xp.floor_divide(total, 12), xp.int32)
        nm = xp.astype(xp.mod(total, 12) + 1, xp.int32)
        # clamp day to last day of target month
        ny2 = xp.where(nm == 12, ny + 1, ny)
        nm2 = xp.where(nm == 12, 1, nm + 1)
        last = days_from_civil(xp, ny2, nm2, xp.full_like(nm2, 1)) - days_from_civil(
            xp, ny, nm, xp.full_like(nm, 1)
        )
        nd = xp.minimum(d, xp.astype(last, xp.int32))
        return days_from_civil(xp, ny, nm, nd)


def _add_months_days(xp, days, months, delta_days):
    """Civil months-then-days add with day-of-month clamping (java
    plusMonths/plusDays at UTC). ``months``/``delta_days`` are python ints
    (literal intervals), so XLA folds them into the fused kernel."""
    if months:
        y, m, d = civil_from_days(xp, days)
        total = xp.astype(y, xp.int64) * 12 + (m - 1) + months
        ny = xp.astype(xp.floor_divide(total, 12), xp.int32)
        nm = xp.astype(xp.mod(total, 12) + 1, xp.int32)
        ny2 = xp.where(nm == 12, ny + 1, ny)
        nm2 = xp.where(nm == 12, 1, nm + 1)
        last = days_from_civil(xp, ny2, nm2, xp.full_like(nm2, 1)) - days_from_civil(
            xp, ny, nm, xp.full_like(nm, 1)
        )
        nd = xp.minimum(d, xp.astype(last, xp.int32))
        days = days_from_civil(xp, ny, nm, nd)
    return days + xp.asarray(delta_days, dtype=xp.int32)


def _interval_literal(e: Expression):
    from ..types import CalendarInterval, CalendarIntervalType
    from .base import Literal

    if not (isinstance(e, Literal) and isinstance(e.data_type, CalendarIntervalType)):
        raise ValueError("interval operand must be a literal CalendarInterval")
    return CalendarInterval(*e.value)


@dataclass(frozen=True)
class TimeAdd(BinaryExpression):
    """timestamp + literal interval (Spark TimeAdd at UTC: plusMonths with
    day clamping, then days, then exact microseconds).

    Reference: GpuTimeAdd — GpuOverrides.scala:1348 (literal-interval gated,
    same restriction here)."""

    start: Expression
    interval: Expression

    @property
    def data_type(self) -> DataType:
        from ..types import TIMESTAMP

        return TIMESTAMP

    def eval(self, ctx: Ctx) -> Val:
        # interval is a plan-time literal: don't evaluate it columnar
        c = self.start.eval(ctx)
        return Val(self._compute(ctx, c.data, None), c.valid)

    def _compute(self, ctx: Ctx, l, r):
        xp = ctx.xp
        iv = _interval_literal(self.interval)
        us = xp.astype(ctx.broadcast(l), xp.int64)
        if iv.months:
            day = xp.floor_divide(us, US_PER_DAY)
            tod = us - day * US_PER_DAY
            day = _add_months_days(xp, xp.astype(day, xp.int32), iv.months, 0)
            us = xp.astype(day, xp.int64) * US_PER_DAY + tod
        return us + iv.days * US_PER_DAY + iv.microseconds


@dataclass(frozen=True)
class DateAddInterval(BinaryExpression):
    """date + literal interval (months/days only — a sub-day component is an
    error, matching Spark's DateAddInterval and the reference's
    GpuDateAddInterval gate, GpuOverrides.scala:1369)."""

    start: Expression
    interval: Expression

    @property
    def data_type(self) -> DataType:
        return DATE

    def eval(self, ctx: Ctx) -> Val:
        c = self.start.eval(ctx)
        return Val(self._compute(ctx, c.data, None), c.valid)

    def _compute(self, ctx: Ctx, l, r):
        xp = ctx.xp
        iv = _interval_literal(self.interval)
        if iv.microseconds != 0:
            raise ValueError(
                "Cannot add hours, minutes or seconds, milliseconds, "
                "microseconds to a date"
            )
        days = xp.astype(ctx.broadcast(l), xp.int32)
        return _add_months_days(xp, days, iv.months, iv.days)


class _TimeField(UnaryExpression):
    """Unary int field from a timestamp (UTC)."""

    @property
    def data_type(self) -> DataType:
        return INT

    def eval(self, ctx: Ctx) -> Val:
        c = self.child.eval(ctx)
        xp = ctx.xp
        secs = xp.floor_divide(
            xp.astype(ctx.broadcast(c.data), xp.int64), US_PER_SECOND
        )
        return Val(self._field(ctx, secs), c.valid)


@dataclass(frozen=True)
class Hour(_TimeField):
    c: Expression

    def _field(self, ctx, secs):
        xp = ctx.xp
        return xp.astype(xp.mod(xp.floor_divide(secs, 3600), 24), xp.int32)


@dataclass(frozen=True)
class Minute(_TimeField):
    c: Expression

    def _field(self, ctx, secs):
        xp = ctx.xp
        return xp.astype(xp.mod(xp.floor_divide(secs, 60), 60), xp.int32)


@dataclass(frozen=True)
class Second(_TimeField):
    c: Expression

    def _field(self, ctx, secs):
        xp = ctx.xp
        return xp.astype(xp.mod(secs, 60), xp.int32)


@dataclass(frozen=True)
class UnixTimestamp(UnaryExpression):
    """timestamp → seconds since epoch (floor) — the no-format fast path of
    Spark's unix_timestamp (format-string parsing is CPU-only, like the
    reference's gated format support)."""

    c: Expression

    @property
    def data_type(self) -> DataType:
        from ..types import LONG

        return LONG

    def _compute(self, ctx: Ctx, data):
        xp = ctx.xp
        if isinstance(self.child.data_type, DateType):
            return xp.astype(data, xp.int64) * 86400
        return xp.floor_divide(xp.astype(data, xp.int64), US_PER_SECOND)
