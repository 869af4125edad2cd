"""Datetime pattern formatting/parsing — date_format, from_unixtime,
unix_timestamp, to_date(fmt).

Reference: datetimeExpressions.scala (GpuFromUnixTime, GpuDateFormatClass,
GpuToUnixTimestamp — cuDF strftime backed, with the plugin gating the
pattern to a supported subset via DateUtils.tagAndGetCudfFormat; unsupported
patterns fall back). Same architecture: the Java SimpleDateFormat subset
below compiles into ONE device byte-layout kernel (digit extraction from
cast.py) or a fixed-offset parse; patterns outside the subset raise at
construction so the planner can fall back per-node. UTC session zone only,
like the reference requires.

Supported tokens: ``yyyy MM dd HH mm ss`` plus literal separators.

Copied from ``spark_rapids_tpu/expr/datetime_fmt.py``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

from ..types import DataType, LONG, STRING, DateType, TimestampType
from .base import Ctx, Expression, Literal, Val
from .cast import (
    MICROS_PER_DAY,
    US_PER_SECOND,
    _digits_msd,
    _dev_trim,
    _pack,
    _parse_digits,
)
from .datetime import civil_from_days, days_from_civil

_TOKENS = {"yyyy": 4, "MM": 2, "dd": 2, "HH": 2, "mm": 2, "ss": 2}
# single-letter variants print UNPADDED (SimpleDateFormat count-1 fields);
# parsing consumes a greedy 1..k digit run behind a per-row cursor
_UNPADDED = {"y": 4, "M": 2, "d": 2, "H": 2, "m": 2, "s": 2}


def parse_pattern(fmt: str) -> Tuple[Tuple[str, str], ...]:
    """Pattern → ((kind, text)…); kind is 'tok' (zero-padded), 'unp'
    (unpadded single-letter) or 'lit'. Raises ValueError for tokens outside
    the supported subset (planner check catches it). Unpadded tokens format
    AND parse: the parser runs a per-row cursor with greedy digit runs."""
    out = []
    i = 0
    while i < len(fmt):
        ch = fmt[i]
        if ch.isalpha():
            # SimpleDateFormat groups by letter RUN: 'yy'/'MMM' are distinct
            # fields, not two of ours — consume the whole run and only
            # accept exact widths (silent mis-tokenization would format
            # wrong data instead of falling back)
            j = i
            while j < len(fmt) and fmt[j] == ch:
                j += 1
            run = fmt[i:j]
            if run in _TOKENS:
                out.append(("tok", run))
            elif len(run) == 1 and run in _UNPADDED:
                out.append(("unp", run))
            else:
                raise ValueError(
                    f"datetime pattern token {run!r} at {i} in {fmt!r} is "
                    f"outside the supported subset "
                    f"{sorted(_TOKENS) + sorted(_UNPADDED)}"
                )
            i = j
            continue
        out.append(("lit", ch))
        i += 1
    return tuple(out)


def pattern_supported(fmt: str) -> bool:
    try:
        parse_pattern(fmt)
        return True
    except ValueError:
        return False


def _fields_from_micros(xp, micros):
    micros = xp.astype(micros, xp.int64)
    days = xp.floor_divide(micros, MICROS_PER_DAY)
    tod = micros - days * MICROS_PER_DAY
    y, mo, d = civil_from_days(xp, xp.astype(days, xp.int32))
    secs = tod // US_PER_SECOND
    return {
        "yyyy": xp.astype(y, xp.int64),
        "MM": xp.astype(mo, xp.int64),
        "dd": xp.astype(d, xp.int64),
        "HH": secs // 3600,
        "mm": (secs // 60) % 60,
        "ss": secs % 60,
    }


_UNP_FIELD = {"y": "yyyy", "M": "MM", "d": "dd", "H": "HH", "m": "mm", "s": "ss"}


def _format_device(ctx: Ctx, micros, pattern) -> tuple:
    """One fused byte-layout kernel: fixed-width digit slots per token;
    unpadded tokens drop leading zeros via the keep mask (the last digit
    always stays)."""
    xp = ctx.xp
    fields = _fields_from_micros(xp, micros)
    n = micros.shape[0]
    slots, keeps = [], []
    width = 0
    for kind, text in pattern:
        if kind == "tok":
            k = _TOKENS[text]
            d = _digits_msd(xp, fields[text], k)
            slots.append(xp.astype(d + 48, xp.uint8))
            keeps.append(xp.ones((n, k), dtype=bool))
            width += k
        elif kind == "unp":
            k = _UNPADDED[text]
            val = fields[_UNP_FIELD[text]]
            d = _digits_msd(xp, val, k)
            # keep digit j iff some digit at position <= j is nonzero, or
            # it's the last digit
            nz = (xp.cumsum(xp.astype(d != 0, xp.int32), axis=1) > 0) | (
                xp.arange(k)[None, :] == k - 1
            )
            slots.append(xp.astype(d + 48, xp.uint8))
            keeps.append(nz)
            width += k
        else:
            slots.append(xp.full((n, 1), ord(text), dtype=xp.uint8))
            keeps.append(xp.ones((n, 1), dtype=bool))
            width += 1
    mat = xp.concatenate(slots, axis=1)
    keep = xp.concatenate(keeps, axis=1)
    return _pack(ctx, mat, keep, width)


def _format_cpu(micros: int, pattern) -> str:
    days, tod = divmod(int(micros), MICROS_PER_DAY)
    z = days + 719468
    era = z // 146097
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    mo = mp + (3 if mp < 10 else -9)
    y += mo <= 2
    secs = tod // US_PER_SECOND
    vals = {
        "yyyy": y,
        "MM": mo,
        "dd": d,
        "HH": secs // 3600,
        "mm": (secs // 60) % 60,
        "ss": secs % 60,
    }
    out = []
    for kind, text in pattern:
        if kind == "tok":
            out.append(f"{vals[text] % (10 ** _TOKENS[text]):0{_TOKENS[text]}d}")
        elif kind == "unp":
            out.append(str(vals[_UNP_FIELD[text]] % (10 ** _UNPADDED[text])))
        else:
            out.append(text)
    return "".join(out)


@dataclass(frozen=True)
class DateFormatClass(Expression):
    """``date_format(ts, fmt)`` — UTC."""

    child: Expression
    fmt: Expression  # literal

    @property
    def data_type(self) -> DataType:
        return STRING

    @property
    def nullable(self) -> bool:
        return self.child.nullable

    def _micros(self, ctx, v):
        xp = ctx.xp
        data = ctx.broadcast(v.data)
        if isinstance(self.child.data_type, DateType):
            return xp.astype(data, xp.int64) * MICROS_PER_DAY
        return xp.astype(data, xp.int64)

    def eval(self, ctx: Ctx) -> Val:
        v = self.child.eval(ctx)
        pattern = parse_pattern(self.fmt.value)
        micros = self._micros(ctx, v)
        if ctx.is_device:
            data, lens = _format_device(ctx, micros, pattern)
            return Val(data, v.valid, lens)
        out = np.asarray(
            [_format_cpu(m, pattern) for m in micros], dtype=object
        )
        return Val(out, v.valid)

    def __str__(self):
        return f"date_format({self.child}, {self.fmt})"


@dataclass(frozen=True)
class FromUnixTime(Expression):
    """``from_unixtime(seconds, fmt)`` — UTC."""

    child: Expression
    fmt: Expression

    @property
    def data_type(self) -> DataType:
        return STRING

    @property
    def nullable(self) -> bool:
        return self.child.nullable

    def eval(self, ctx: Ctx) -> Val:
        v = self.child.eval(ctx)
        pattern = parse_pattern(self.fmt.value)
        xp = ctx.xp
        micros = xp.astype(ctx.broadcast(v.data), xp.int64) * US_PER_SECOND
        if ctx.is_device:
            data, lens = _format_device(ctx, micros, pattern)
            return Val(data, v.valid, lens)
        out = np.asarray(
            [_format_cpu(m, pattern) for m in micros], dtype=object
        )
        return Val(out, v.valid)


def _parse_device(ctx: Ctx, val: Val, pattern):
    """Parse the pattern → (micros, ok). Fixed-width tokens sit at static
    offsets from the trim start; unpadded single-letter tokens ('M/d/yyyy')
    consume a greedy 1..k digit run behind a per-row cursor (SimpleDateFormat
    numeric-field semantics)."""
    from .cast import _char_at
    from .strings import dev_str

    xp = ctx.xp
    ch, lengths = dev_str(ctx, val)
    start, end, has_any = _dev_trim(ctx, ch, lengths)
    has_unp = any(k == "unp" for k, _ in pattern)
    # tokens absent from the pattern default like Java: month/day 1, rest 0
    fields = {
        t: xp.full(ctx.n, 1 if t in ("MM", "dd") else 0, dtype=xp.int64)
        for t in _TOKENS
    }
    if not has_unp:
        total = sum(_TOKENS[t] if k == "tok" else 1 for k, t in pattern)
        ok = has_any & ((end - start) == total)
        off = 0
        for kind, text in pattern:
            if kind == "tok":
                k = _TOKENS[text]
                v, seg_ok = _parse_digits(
                    ctx, ch, start + off, start + off + k
                )
                fields[text] = v
                ok = ok & seg_ok
                off += k
            else:
                ok = ok & (_char_at(ctx, ch, start + off) == ord(text))
                off += 1
    else:
        cur = start
        ok = has_any
        for kind, text in pattern:
            if kind == "tok":
                k = _TOKENS[text]
                v, seg_ok = _parse_digits(ctx, ch, cur, cur + k)
                fields[text] = v
                ok = ok & seg_ok & (cur + k <= end)
                cur = cur + k
            elif kind == "unp":
                k = _UNPADDED[text]
                run = None
                acc = xp.zeros(ctx.n, dtype=xp.int64)
                width = xp.zeros(ctx.n, dtype=xp.int32)
                for j in range(k):
                    c = _char_at(ctx, ch, cur + j)
                    isd = (c >= 48) & (c <= 57) & ((cur + j) < end)
                    run = isd if run is None else (run & isd)
                    acc = xp.where(
                        run, acc * 10 + xp.astype(c - 48, xp.int64), acc
                    )
                    width = width + xp.astype(run, xp.int32)
                fields[_UNP_FIELD[text]] = acc
                ok = ok & (width >= 1)
                cur = cur + width
            else:
                ok = (
                    ok
                    & (_char_at(ctx, ch, cur) == ord(text))
                    & (cur < end)
                )
                cur = cur + 1
        ok = ok & (cur == end)
    from .cast import _days_in_month

    y = xp.astype(fields["yyyy"], xp.int32)
    mo = xp.astype(xp.clip(fields["MM"], 1, 12), xp.int32)
    d = xp.astype(xp.clip(fields["dd"], 1, 31), xp.int32)
    ok = (
        ok
        & (fields["MM"] >= 1)
        & (fields["MM"] <= 12)
        & (fields["dd"] >= 1)
        # per-month bound: Feb 29 of a non-leap year must NOT parse
        & (fields["dd"] <= _days_in_month(xp, y, mo))
        & (fields["HH"] < 24)
        & (fields["mm"] < 60)
        & (fields["ss"] < 60)
    )
    days = xp.astype(days_from_civil(xp, y, mo, d), xp.int64)
    micros = days * MICROS_PER_DAY + (
        fields["HH"] * 3600 + fields["mm"] * 60 + fields["ss"]
    ) * US_PER_SECOND
    return micros, ok


def _parse_cpu(s, pattern):
    if s is None:
        return None
    s = s.strip()
    fields = {t: (1 if t in ("MM", "dd") else 0) for t in _TOKENS}
    off = 0
    for kind, text in pattern:
        if kind == "tok":
            k = _TOKENS[text]
            seg = s[off : off + k]
            if len(seg) != k or not (seg.isascii() and seg.isdigit()):
                return None
            fields[text] = int(seg)
            off += k
        elif kind == "unp":
            # greedy 1..k digit run (SimpleDateFormat numeric field)
            k = _UNPADDED[text]
            j = off
            while j < len(s) and j - off < k and s[j].isascii() and s[j].isdigit():
                j += 1
            if j == off:
                return None
            fields[_UNP_FIELD[text]] = int(s[off:j])
            off = j
        else:
            if off >= len(s) or s[off] != text:
                return None
            off += 1
    if off != len(s):
        return None
    if not (
        1 <= fields["MM"] <= 12
        and 1 <= fields["dd"] <= 31
        and fields["HH"] < 24
        and fields["mm"] < 60
        and fields["ss"] < 60
    ):
        return None
    # per-month day bound (Feb 29 of a non-leap year must not parse)
    import calendar

    if fields["dd"] > calendar.monthrange(fields["yyyy"], fields["MM"])[1]:
        return None

    def dfc(y, m, d):
        y -= m <= 2
        era = y // 400
        yoe = y - era * 400
        doy = (153 * (m + (-3 if m > 2 else 9)) + 2) // 5 + d - 1
        doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
        return era * 146097 + doe - 719468

    days = dfc(fields["yyyy"], fields["MM"], fields["dd"])
    return days * MICROS_PER_DAY + (
        fields["HH"] * 3600 + fields["mm"] * 60 + fields["ss"]
    ) * US_PER_SECOND


@dataclass(frozen=True)
class ToUnixTimestamp(Expression):
    """``unix_timestamp(str, fmt)`` → seconds (LONG), null on mismatch."""

    child: Expression
    fmt: Expression

    @property
    def data_type(self) -> DataType:
        return LONG

    def eval(self, ctx: Ctx) -> Val:
        v = self.child.eval(ctx)
        pattern = parse_pattern(self.fmt.value)
        if isinstance(self.child.data_type, (DateType, TimestampType)):
            from .cast import Cast

            tv = Cast(self.child, TimestampType()).eval(ctx)
            xp = ctx.xp
            return Val(
                xp.floor_divide(xp.astype(ctx.broadcast(tv.data), xp.int64), US_PER_SECOND),
                tv.valid,
            )
        if ctx.is_device:
            micros, ok = _parse_device(ctx, v, pattern)
            xp = ctx.xp
            return Val(
                xp.floor_divide(micros, US_PER_SECOND),
                v.full_valid(ctx) & ok,
            )
        from .strings import _cpu_strs

        s = _cpu_strs(ctx, v)
        valid = ctx.broadcast_bool(v.valid)
        out = np.zeros(ctx.n, dtype=np.int64)
        ok = np.zeros(ctx.n, dtype=bool)
        for i in range(ctx.n):
            if not valid[i]:
                continue
            m = _parse_cpu(s[i], pattern)
            if m is not None:
                out[i] = m // US_PER_SECOND
                ok[i] = True
        return Val(out, valid & ok)


@dataclass(frozen=True)
class ParseToDate(Expression):
    """``to_date(str, fmt)`` with an explicit pattern (without one, the
    planner emits a plain Cast to DATE)."""

    child: Expression
    fmt: Expression

    @property
    def data_type(self) -> DataType:
        from ..types import DATE

        return DATE

    def eval(self, ctx: Ctx) -> Val:
        v = self.child.eval(ctx)
        pattern = parse_pattern(self.fmt.value)
        xp = ctx.xp
        if ctx.is_device:
            micros, ok = _parse_device(ctx, v, pattern)
            days = xp.astype(xp.floor_divide(micros, MICROS_PER_DAY), xp.int32)
            return Val(days, v.full_valid(ctx) & ok)
        from .strings import _cpu_strs

        s = _cpu_strs(ctx, v)
        valid = ctx.broadcast_bool(v.valid)
        out = np.zeros(ctx.n, dtype=np.int32)
        ok = np.zeros(ctx.n, dtype=bool)
        for i in range(ctx.n):
            if not valid[i]:
                continue
            m = _parse_cpu(s[i], pattern)
            if m is not None:
                out[i] = m // MICROS_PER_DAY
                ok[i] = True
        return Val(out, valid & ok)
