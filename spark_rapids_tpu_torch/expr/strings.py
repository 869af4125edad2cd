"""String expression library — the analogue of stringFunctions.scala (889 LoC
in the reference: substr, pad, split, replace, trim, locate, concat, like,
initcap, …) re-designed for the TPU's static-shape world.

Device representation (columnar.device): ``bytes uint8[n, width]`` +
``lengths int32[n]``; width is power-of-two bucketed. The core trick shared by
every byte-rearranging op (substring, trim, replace, concat, repeat, pad) is
**mask-compaction**: build a candidate byte matrix whose kept bytes appear in
output order, then stable-argsort the keep mask to pack them left — one XLA
sort instead of per-row loops.

Character semantics: Spark string functions are *character* (UTF-8 code
point) based. Char starts are detected as non-continuation bytes
(``b & 0xC0 != 0x80``), so substring/locate/length are UTF-8 correct. Case
conversion and LIKE's ``_`` operate bytewise (ASCII): like the reference,
which documents cudf/Java divergence for exotic unicode (docs/compatibility),
non-ASCII case mapping is out of scope for the device path.

CPU oracle implementations are Spark-exact per-row python (UTF8String
semantics: trim removes ASCII 32 only, replace('','x') is identity, …).

Copied from ``spark_rapids_tpu/expr/strings.py``. ``Like``'s byte-NFA,
a ``lax.scan`` there, is ``like_nfa`` here: a host loop over the width of
whole-column torch ops; so is replace's ``_greedy_matches``. The
associative scans are ``cummax``/``cummin``, ``.at[].set`` an indexed
write into the plane the expression allocated. ``_match_starts`` runs the
hand-written kernel (``Contains``, ``StringLocate``, ``SubstringIndex``,
``StringReplace``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from ..types import (
    BOOLEAN,
    INT,
    STRING,
    BooleanType,
    DataType,
    IntegerType,
    StringType,
)
from .base import Ctx, Expression, Literal, Val, and_valid


# ── device byte-matrix toolkit ──────────────────────────────────────────────


def dev_str(ctx: Ctx, val: Val):
    """Normalize a device string Val to (bytes[n, w], lengths[n])."""
    xp = ctx.xp
    data = val.data
    if data.ndim == 1:  # scalar-like literal string [w]
        data = xp.broadcast_to(data[None, :], (ctx.n, data.shape[0]))
    lengths = xp.broadcast_to(xp.asarray(val.lengths), (ctx.n,))
    return data, lengths


def byte_mask(ctx: Ctx, w: int, lengths):
    xp = ctx.xp
    return xp.arange(w, dtype=xp.int32)[None, :] < lengths[:, None]


def compact_bytes(ctx: Ctx, data, keep, out_width: Optional[int] = None):
    """Pack kept bytes to the front of each row (stable), zero the tail.
    Returns (bytes[n, out_width], lengths[n])."""
    xp = ctx.xp
    order = xp.argsort(~keep, axis=1, stable=True)
    packed = xp.take_along_axis(data, order, axis=1)
    new_len = xp.astype(keep.sum(axis=1), xp.int32)
    w = data.shape[1]
    live = xp.arange(w, dtype=xp.int32)[None, :] < new_len[:, None]
    packed = xp.astype(xp.where(live, packed, 0), xp.uint8)
    if out_width is not None and out_width != w:
        if out_width < w:
            packed = packed[:, :out_width]
        else:
            packed = xp.pad(packed, ((0, 0), (0, out_width - w)))
    return packed, new_len


def char_starts(ctx: Ctx, data, lengths):
    """bool[n,w]: byte is the first byte of a UTF-8 character (within len)."""
    xp = ctx.xp
    return ((data & 0xC0) != 0x80) & byte_mask(ctx, data.shape[1], lengths)


def char_index(ctx: Ctx, data, lengths):
    """int32[n,w]: 0-based character index of each byte; (starts, nchars)."""
    xp = ctx.xp
    starts = char_starts(ctx, data, lengths)
    idx = xp.cumsum(xp.astype(starts, xp.int32), axis=1) - 1
    nchars = xp.astype(starts.sum(axis=1), xp.int32)
    return idx, starts, nchars


def _lit_bytes(e: Expression) -> bytes:
    assert isinstance(e, Literal) and isinstance(e.dtype, StringType)
    return e.value.encode("utf-8")


def is_string_literal(e: Expression) -> bool:
    return isinstance(e, Literal) and isinstance(e.dtype, StringType) and e.value is not None


def _cpu_strs(ctx: Ctx, val: Val) -> np.ndarray:
    return np.broadcast_to(np.asarray(val.data, dtype=object), (ctx.n,))


def _cpu_str_result(ctx: Ctx, out: list) -> Val:
    return Val(np.asarray(out, dtype=object), None)  # valid filled by caller


def _out_width(n_bytes: int) -> int:
    from ..columnar.device import bucket_width

    return bucket_width(max(n_bytes, 1))


# ── simple unary ────────────────────────────────────────────────────────────


@dataclass(frozen=True)
class Length(Expression):
    """Character count — Spark ``length`` (UTF8String.numChars)."""

    child: Expression

    @property
    def data_type(self) -> DataType:
        return INT

    @property
    def nullable(self) -> bool:
        return self.child.nullable

    def eval(self, ctx: Ctx) -> Val:
        c = self.child.eval(ctx)
        if ctx.is_device:
            data, lengths = dev_str(ctx, c)
            _, _, nchars = char_index(ctx, data, lengths)
            return Val(ctx.xp.astype(nchars, ctx.xp.int32), c.valid)
        s = _cpu_strs(ctx, c)
        out = np.asarray([len(x) if x is not None else 0 for x in s], dtype=np.int32)
        return Val(out, c.valid)


class _CaseConvert(Expression):
    upper = True

    @property
    def data_type(self) -> DataType:
        return STRING

    @property
    def nullable(self) -> bool:
        return self.children()[0].nullable

    def eval(self, ctx: Ctx) -> Val:
        c = self.children()[0].eval(ctx)
        if ctx.is_device:
            xp = ctx.xp
            data, lengths = dev_str(ctx, c)
            if self.upper:
                shift = ((data >= ord("a")) & (data <= ord("z"))) * 32
                out = data - xp.astype(shift, xp.uint8)
            else:
                shift = ((data >= ord("A")) & (data <= ord("Z"))) * 32
                out = data + xp.astype(shift, xp.uint8)
            return Val(xp.astype(out, xp.uint8), c.valid, lengths)
        s = _cpu_strs(ctx, c)
        f = str.upper if self.upper else str.lower
        out = np.asarray(
            [f(x) if x is not None else None for x in s], dtype=object
        )
        return Val(out, c.valid)


@dataclass(frozen=True)
class Upper(_CaseConvert):
    child: Expression
    upper = True


@dataclass(frozen=True)
class Lower(_CaseConvert):
    child: Expression
    upper = False


@dataclass(frozen=True)
class InitCap(Expression):
    """First letter of each space-delimited word upper, rest lower (Spark
    UTF8String.toLowerCase().toTitleCase(): title positions follow ' ')."""

    child: Expression

    @property
    def data_type(self) -> DataType:
        return STRING

    def eval(self, ctx: Ctx) -> Val:
        c = self.child.eval(ctx)
        if ctx.is_device:
            xp = ctx.xp
            data, lengths = dev_str(ctx, c)
            lower_shift = ((data >= ord("A")) & (data <= ord("Z"))) * 32
            low = xp.astype(data + xp.astype(lower_shift, xp.uint8), xp.uint8)
            prev_space = xp.concatenate(
                [
                    xp.full((ctx.n, 1), True),
                    (data[:, :-1] == ord(" ")),
                ],
                axis=1,
            )
            up_shift = (
                prev_space & (low >= ord("a")) & (low <= ord("z"))
            ) * 32
            out = xp.astype(low - xp.astype(up_shift, xp.uint8), xp.uint8)
            return Val(out, c.valid, lengths)
        s = _cpu_strs(ctx, c)
        out = []
        for x in s:
            if x is None:
                out.append(None)
                continue
            low = x.lower()
            chars = []
            prev_space = True
            for ch in low:
                chars.append(ch.upper() if prev_space else ch)
                prev_space = ch == " "
            out.append("".join(chars))
        return Val(np.asarray(out, dtype=object), c.valid)


@dataclass(frozen=True)
class Reverse(Expression):
    """Character-aware reverse (UTF-8 multi-byte chars keep byte order)."""

    child: Expression

    @property
    def data_type(self) -> DataType:
        return STRING

    def eval(self, ctx: Ctx) -> Val:
        c = self.child.eval(ctx)
        if not ctx.is_device:
            s = _cpu_strs(ctx, c)
            out = [x[::-1] if x is not None else None for x in s]
            return Val(np.asarray(out, dtype=object), c.valid)
        xp = ctx.xp
        data, lengths = dev_str(ctx, c)
        w = data.shape[1]
        idx, starts, _ = char_index(ctx, data, lengths)
        pos = xp.arange(w, dtype=xp.int32)[None, :]
        # start byte of this char = position of the char-start at or before i
        cur_start = xp.where(starts, pos, -1)
        cur_start = _cummax(xp, cur_start)
        # next char start strictly after i (or length)
        nxt = xp.where(starts, pos, w + 1)
        next_start = _rev_cummin(xp, nxt)
        next_start = xp.concatenate(
            [next_start[:, 1:], xp.full((ctx.n, 1), w + 1, dtype=xp.int32)], axis=1
        )
        next_start = xp.minimum(next_start, lengths[:, None])
        within = pos - cur_start
        out_pos = lengths[:, None] - next_start + within
        mask = byte_mask(ctx, w, lengths)
        out_pos = xp.where(mask, out_pos, w)  # park padding writes off-row
        out = xp.zeros((ctx.n, w + 1), dtype=xp.uint8)
        rows = xp.arange(ctx.n, dtype=xp.int64)[:, None]
        # the JAX package's ``out.at[rows, out_pos].set``: a scatter into the
        # plane this function allocated
        out[rows, xp.astype(out_pos, xp.int64)] = xp.where(mask, data, 0)
        return Val(out[:, :w], c.valid, lengths)


def _cummax(xp, a):
    """Running maximum along the row (``lax.associative_scan(maximum)``)."""
    return xp.cummax(a, axis=1)


def _rev_cummin(xp, a):
    """Running minimum from the row's end (the reversed associative scan)."""
    return xp.flip(xp.cummin(xp.flip(a, 1), axis=1), 1)


@dataclass(frozen=True)
class Ascii(Expression):
    """Code point of the first character (0 for empty) — Spark ``ascii``."""

    child: Expression

    @property
    def data_type(self) -> DataType:
        return INT

    def eval(self, ctx: Ctx) -> Val:
        c = self.child.eval(ctx)
        if not ctx.is_device:
            s = _cpu_strs(ctx, c)
            out = np.asarray(
                [ord(x[0]) if x else 0 for x in (y if y is not None else "" for y in s)],
                dtype=np.int32,
            )
            return Val(out, c.valid)
        xp = ctx.xp
        data, lengths = dev_str(ctx, c)
        w = data.shape[1]
        b = [xp.astype(data[:, i], xp.int32) if i < w else xp.zeros(ctx.n, xp.int32) for i in range(4)]
        b0 = b[0]
        one = b0  # ascii
        two = ((b0 & 0x1F) << 6) | (b[1] & 0x3F)
        three = ((b0 & 0x0F) << 12) | ((b[1] & 0x3F) << 6) | (b[2] & 0x3F)
        four = (
            ((b0 & 0x07) << 18)
            | ((b[1] & 0x3F) << 12)
            | ((b[2] & 0x3F) << 6)
            | (b[3] & 0x3F)
        )
        cp = xp.where(
            b0 < 0x80,
            one,
            xp.where(b0 < 0xE0, two, xp.where(b0 < 0xF0, three, four)),
        )
        return Val(xp.astype(xp.where(lengths > 0, cp, 0), xp.int32), c.valid)


# ── substring / trim / pad ─────────────────────────────────────────────────


@dataclass(frozen=True)
class Substring(Expression):
    """Spark ``substring(str, pos, len)`` — 1-based character position;
    pos 0 behaves like 1; negative pos counts from the end
    (UTF8String.substringSQL)."""

    child: Expression
    pos: Expression
    length: Expression

    @property
    def data_type(self) -> DataType:
        return STRING

    def eval(self, ctx: Ctx) -> Val:
        c = self.child.eval(ctx)
        p = self.pos.eval(ctx)
        ln = self.length.eval(ctx)
        valid = and_valid(ctx, c.valid, p.valid, ln.valid)
        if not ctx.is_device:
            s = _cpu_strs(ctx, c)
            pv = np.broadcast_to(np.asarray(p.data), (ctx.n,))
            lv = np.broadcast_to(np.asarray(ln.data), (ctx.n,))
            out = []
            for x, pos, leng in zip(s, pv.tolist(), lv.tolist()):
                if x is None:
                    out.append(None)
                    continue
                n = len(x)
                start = pos - 1 if pos > 0 else (n + pos if pos < 0 else 0)
                end = start + leng
                out.append(x[max(start, 0) : max(end, 0)] if end > 0 else "")
            return Val(np.asarray(out, dtype=object), valid)
        xp = ctx.xp
        data, lengths = dev_str(ctx, c)
        idx, _, nchars = char_index(ctx, data, lengths)
        pos = xp.astype(xp.broadcast_to(xp.asarray(p.data), (ctx.n,)), xp.int32)
        leng = xp.astype(xp.broadcast_to(xp.asarray(ln.data), (ctx.n,)), xp.int32)
        start = xp.where(pos > 0, pos - 1, xp.where(pos < 0, nchars + pos, 0))
        end = start + leng
        keep = (
            (idx >= xp.maximum(start, 0)[:, None])
            & (idx < end[:, None])
            & byte_mask(ctx, data.shape[1], lengths)
        )
        out, new_len = compact_bytes(ctx, data, keep)
        return Val(out, valid, new_len)


class _TrimBase(Expression):
    """Spark trim family: default trims ASCII space (32) only; with an
    explicit trim string, removes any char in that set."""

    trim_left = True
    trim_right = True

    @property
    def data_type(self) -> DataType:
        return STRING

    def _trim_set(self) -> Optional[str]:
        t = getattr(self, "trim_str", None)
        if t is None:
            return None
        return t.value if isinstance(t, Literal) else None

    def eval(self, ctx: Ctx) -> Val:
        c = self.children()[0].eval(ctx)
        if not ctx.is_device:
            s = _cpu_strs(ctx, c)
            valid = c.valid
            if getattr(self, "trim_str", None) is not None:
                tv = self.trim_str.eval(ctx)
                sets = np.broadcast_to(np.asarray(tv.data, dtype=object), (ctx.n,))
                valid = and_valid(ctx, c.valid, tv.valid)
            else:
                sets = np.broadcast_to(np.asarray(" ", dtype=object), (ctx.n,))
            out = []
            for x, chars in zip(s, sets):
                if x is None or chars is None:
                    out.append(None)
                elif self.trim_left and self.trim_right:
                    out.append(x.strip(chars))
                elif self.trim_left:
                    out.append(x.lstrip(chars))
                else:
                    out.append(x.rstrip(chars))
            return Val(np.asarray(out, dtype=object), valid)
        # device path: literal trim set (override-gated)
        tset = self._trim_set()
        chars = tset if tset is not None else " "
        xp = ctx.xp
        data, lengths = dev_str(ctx, c)
        w = data.shape[1]
        cset = np.frombuffer(chars.encode("utf-8"), dtype=np.uint8)
        member = xp.zeros_like(data, dtype=bool)
        for b in np.unique(cset):
            member = member | (data == int(b))
        mask = byte_mask(ctx, w, lengths)
        member = member & mask
        keep = mask
        if self.trim_left:
            # leading run of members: cumprod over membership
            lead = xp.astype(xp.cumprod(xp.astype(member, xp.int32), axis=1), bool)
            keep = keep & ~lead
        if self.trim_right:
            pos = xp.arange(w, dtype=xp.int32)[None, :]
            last_keep = xp.max(xp.where(~member & mask, pos, -1), axis=1)
            trail = pos > last_keep[:, None]
            keep = keep & ~trail
        out, new_len = compact_bytes(ctx, data, keep)
        return Val(out, c.valid, new_len)


@dataclass(frozen=True)
class StringTrim(_TrimBase):
    child: Expression
    trim_str: Optional[Expression] = None
    trim_left = True
    trim_right = True


@dataclass(frozen=True)
class StringTrimLeft(_TrimBase):
    child: Expression
    trim_str: Optional[Expression] = None
    trim_left = True
    trim_right = False


@dataclass(frozen=True)
class StringTrimRight(_TrimBase):
    child: Expression
    trim_str: Optional[Expression] = None
    trim_left = False
    trim_right = True


class _PadBase(Expression):
    """Spark lpad/rpad: pad (cycling the pad string) to ``len`` characters, or
    truncate to ``len`` characters when already longer. Device path requires a
    single-byte pad literal (override-gated)."""

    left = True

    @property
    def data_type(self) -> DataType:
        return STRING

    def eval(self, ctx: Ctx) -> Val:
        c = self.children()[0].eval(ctx)
        ln = self.length.eval(ctx)
        pad_v = self.pad.eval(ctx)
        valid = and_valid(ctx, c.valid, ln.valid, pad_v.valid)
        if not ctx.is_device:
            s = _cpu_strs(ctx, c)
            lv = np.broadcast_to(np.asarray(ln.data), (ctx.n,))
            pv = np.broadcast_to(np.asarray(pad_v.data, dtype=object), (ctx.n,))
            out = []
            for x, want, pad in zip(s, lv.tolist(), pv):
                if x is None or pad is None:
                    out.append(None)
                    continue
                want = max(int(want), 0)
                if len(x) >= want or not pad:
                    out.append(x[:want])
                else:
                    fill = (pad * ((want - len(x)) // len(pad) + 1))[: want - len(x)]
                    out.append(fill + x if self.left else x + fill)
            return Val(np.asarray(out, dtype=object), valid)
        # device path: single-byte literal pad + literal length (override-gated)
        xp = ctx.xp
        data, lengths = dev_str(ctx, c)
        w = data.shape[1]
        idx, _, nchars = char_index(ctx, data, lengths)
        want = xp.astype(xp.broadcast_to(xp.asarray(ln.data), (ctx.n,)), xp.int32)
        want = xp.maximum(want, 0)
        pad = self.pad.value if isinstance(self.pad, Literal) else " "
        pad_b = pad.encode("utf-8")[:1] or b" "
        max_want = int(self.length.value) if isinstance(self.length, Literal) else w
        # worst case in BYTES: all input bytes kept plus max_want pad bytes
        out_w = _out_width(w + max(max_want, 0))
        padneed = xp.maximum(want - nchars, 0)
        pads = xp.full((ctx.n, out_w), pad_b[0], dtype=xp.uint8)
        keep_p = xp.arange(out_w, dtype=xp.int32)[None, :] < padneed[:, None]
        keep_d = (idx < want[:, None]) & byte_mask(ctx, w, lengths)
        if self.left:
            cand = xp.concatenate([pads, data], axis=1)
            keep = xp.concatenate([keep_p, keep_d], axis=1)
        else:
            cand = xp.concatenate([data, pads], axis=1)
            keep = xp.concatenate([keep_d, keep_p], axis=1)
        out, new_len = compact_bytes(ctx, cand, keep, out_width=out_w)
        return Val(out, valid, new_len)


@dataclass(frozen=True)
class StringLPad(_PadBase):
    child: Expression
    length: Expression
    pad: Expression
    left = True


@dataclass(frozen=True)
class StringRPad(_PadBase):
    child: Expression
    length: Expression
    pad: Expression
    left = False


# ── concat / repeat / replace ───────────────────────────────────────────────


@dataclass(frozen=True)
class Concat(Expression):
    """Spark ``concat``: null if any input null."""

    args: Tuple[Expression, ...]

    @property
    def data_type(self) -> DataType:
        return STRING

    def eval(self, ctx: Ctx) -> Val:
        vals = [a.eval(ctx) for a in self.args]
        valid = and_valid(ctx, *[v.valid for v in vals]) if vals else None
        if not ctx.is_device:
            cols = [_cpu_strs(ctx, v) for v in vals]
            out = []
            for i in range(ctx.n):
                parts = [c[i] for c in cols]
                out.append(None if any(p is None for p in parts) else "".join(parts))
            return Val(np.asarray(out, dtype=object), valid)
        xp = ctx.xp
        mats, keeps, total = [], [], 0
        for v in vals:
            data, lengths = dev_str(ctx, v)
            mats.append(data)
            keeps.append(byte_mask(ctx, data.shape[1], lengths))
            total += data.shape[1]
        cand = xp.concatenate(mats, axis=1)
        keep = xp.concatenate(keeps, axis=1)
        out, new_len = compact_bytes(ctx, cand, keep, out_width=_out_width(total))
        return Val(out, valid, new_len)


@dataclass(frozen=True)
class StringRepeat(Expression):
    """Spark ``repeat(str, n)`` — device path requires literal n."""

    child: Expression
    times: Expression

    @property
    def data_type(self) -> DataType:
        return STRING

    def eval(self, ctx: Ctx) -> Val:
        c = self.child.eval(ctx)
        t = self.times.eval(ctx)
        valid = and_valid(ctx, c.valid, t.valid)
        if not ctx.is_device:
            s = _cpu_strs(ctx, c)
            tv = np.broadcast_to(np.asarray(t.data), (ctx.n,))
            out = [
                (x * max(int(k), 0)) if x is not None else None
                for x, k in zip(s, tv.tolist())
            ]
            return Val(np.asarray(out, dtype=object), valid)
        xp = ctx.xp
        data, lengths = dev_str(ctx, c)
        reps = max(int(self.times.value), 0) if isinstance(self.times, Literal) else 1
        if reps == 0:
            w = data.shape[1]
            return Val(
                xp.zeros((ctx.n, w), dtype=xp.uint8),
                valid,
                xp.zeros(ctx.n, dtype=xp.int32),
            )
        mask = byte_mask(ctx, data.shape[1], lengths)
        cand = xp.concatenate([data] * reps, axis=1)
        keep = xp.concatenate([mask] * reps, axis=1)
        out, new_len = compact_bytes(
            ctx, cand, keep, out_width=_out_width(data.shape[1] * reps)
        )
        return Val(out, valid, new_len)


@dataclass(frozen=True)
class StringReplace(Expression):
    """Spark ``replace(str, search, replace)`` — greedy non-overlapping from
    the left; empty search returns the input unchanged. Device path requires
    literal search/replace (reference GpuStringReplace requires scalars too)."""

    child: Expression
    search: Expression
    replacement: Expression

    @property
    def data_type(self) -> DataType:
        return STRING

    def eval(self, ctx: Ctx) -> Val:
        c = self.child.eval(ctx)
        s_v = self.search.eval(ctx)
        r_v = self.replacement.eval(ctx)
        valid = and_valid(ctx, c.valid, s_v.valid, r_v.valid)
        if not ctx.is_device:
            s = _cpu_strs(ctx, c)
            sv = np.broadcast_to(np.asarray(s_v.data, dtype=object), (ctx.n,))
            rv = np.broadcast_to(np.asarray(r_v.data, dtype=object), (ctx.n,))
            out = []
            for x, se, re_ in zip(s, sv, rv):
                if x is None or se is None or re_ is None:
                    out.append(None)
                elif se == "":
                    out.append(x)
                else:
                    out.append(x.replace(se, re_))
            return Val(np.asarray(out, dtype=object), valid)
        xp = ctx.xp
        data, lengths = dev_str(ctx, c)
        pat = _lit_bytes(self.search)
        rep = _lit_bytes(self.replacement)
        w = data.shape[1]
        L = len(pat)
        if L == 0 or L > w:
            return Val(data, valid, lengths)
        sel = _greedy_matches(ctx, data, lengths, pat)  # bool[n,w] match starts
        # covered[i] = some selected match start in (i-L, i]
        covered = _window_or(ctx, sel, L)
        R = len(rep)
        if R == 0:
            keep = byte_mask(ctx, w, lengths) & ~covered
            out, new_len = compact_bytes(ctx, data, keep)
            return Val(out, valid, new_len)
        # candidate: per input byte, [R replacement bytes][original byte]
        rep_arr = xp.asarray(np.frombuffer(rep, dtype=np.uint8))
        rep_tile = xp.broadcast_to(rep_arr[None, None, :], (ctx.n, w, R))
        orig = data[:, :, None]
        cand = xp.concatenate([rep_tile, orig], axis=2).reshape(ctx.n, w * (R + 1))
        keep_rep = xp.broadcast_to(sel[:, :, None], (ctx.n, w, R))
        keep_orig = (byte_mask(ctx, w, lengths) & ~covered)[:, :, None]
        keep = xp.concatenate([keep_rep, keep_orig], axis=2).reshape(
            ctx.n, w * (R + 1)
        )
        max_out = w + (w // L) * max(R - L, 0)
        out, new_len = compact_bytes(ctx, cand, keep, out_width=_out_width(max_out))
        return Val(out, valid, new_len)


def _match_starts(ctx: Ctx, data, lengths, pat: bytes, consumer: str):
    """bool[n, w]: literal ``pat`` matches starting at each byte position.
    On the device it is the hand-written kernel of ops/strings_kernels.py
    (its plain torch version when the plane lies on the CPU); ``consumer``
    names the expression, whose launches the kernel's wrapper counts."""
    from ..ops import strings_kernels as SK

    return SK.match_starts(
        ctx.xp.astype(data, ctx.xp.uint8).contiguous(),
        ctx.xp.astype(lengths, ctx.xp.int32).contiguous(),
        pat,
        consumer=consumer,
    )


def _greedy_matches(ctx: Ctx, data, lengths, pat: bytes):
    """Non-overlapping greedy-left match starts (str.replace semantics).
    The JAX package runs a ``lax.scan`` over the width; here it is a host
    loop over the ``W`` byte positions of whole-column ops (no host sync),
    each step taking the matches that start at or after the row's next free
    byte."""
    xp = ctx.xp
    matches = _match_starts(ctx, data, lengths, pat, "replace")
    L = len(pat)
    w = data.shape[1]
    if L == 1:
        return matches
    next_free = xp.zeros(ctx.n, dtype=xp.int32)
    sel = []
    for i in range(w):
        m = matches[:, i] & (next_free <= i)
        next_free = xp.where(m, i + L, next_free)
        sel.append(m)
    return xp.stack(sel, axis=1)


def _window_or(ctx: Ctx, starts, L: int):
    """covered[i] = any(starts[i-L+1 .. i]) — bytes covered by an L-match."""
    xp = ctx.xp
    out = starts
    shifted = starts
    for _ in range(L - 1):
        shifted = xp.concatenate(
            [xp.zeros((ctx.n, 1), dtype=bool), shifted[:, :-1]], axis=1
        )
        out = out | shifted
    return out


# ── search predicates ───────────────────────────────────────────────────────


class _SearchBase(Expression):
    @property
    def data_type(self) -> DataType:
        return BOOLEAN

    def eval(self, ctx: Ctx) -> Val:
        c = self.children()[0].eval(ctx)
        p = self.children()[1].eval(ctx)
        valid = and_valid(ctx, c.valid, p.valid)
        if not ctx.is_device:
            s = _cpu_strs(ctx, c)
            pv = np.broadcast_to(np.asarray(p.data, dtype=object), (ctx.n,))
            out = np.asarray(
                [
                    self._cpu_one(x, y) if (x is not None and y is not None) else False
                    for x, y in zip(s, pv)
                ],
                dtype=bool,
            )
            return Val(out, valid)
        data, lengths = dev_str(ctx, c)
        pat = _lit_bytes(self.children()[1])
        return Val(self._dev(ctx, data, lengths, pat), valid)


@dataclass(frozen=True)
class StartsWith(_SearchBase):
    child: Expression
    pattern: Expression

    def _cpu_one(self, s, p):
        return s.startswith(p)

    def _dev(self, ctx, data, lengths, pat):
        xp = ctx.xp
        L = len(pat)
        if L == 0:
            return xp.ones(ctx.n, dtype=bool)
        if L > data.shape[1]:
            return xp.zeros(ctx.n, dtype=bool)
        pat_a = xp.asarray(np.frombuffer(pat, dtype=np.uint8))
        return (data[:, :L] == pat_a[None, :]).all(axis=1) & (lengths >= L)


@dataclass(frozen=True)
class EndsWith(_SearchBase):
    child: Expression
    pattern: Expression

    def _cpu_one(self, s, p):
        return s.endswith(p)

    def _dev(self, ctx, data, lengths, pat):
        xp = ctx.xp
        L = len(pat)
        if L == 0:
            return xp.ones(ctx.n, dtype=bool)
        if L > data.shape[1]:
            return xp.zeros(ctx.n, dtype=bool)
        pat_a = xp.asarray(np.frombuffer(pat, dtype=np.uint8))
        pos = lengths[:, None] - L + xp.arange(L, dtype=xp.int32)[None, :]
        got = xp.take_along_axis(data, xp.clip(pos, 0, data.shape[1] - 1), axis=1)
        return (got == pat_a[None, :]).all(axis=1) & (lengths >= L)


@dataclass(frozen=True)
class Contains(_SearchBase):
    child: Expression
    pattern: Expression

    def _cpu_one(self, s, p):
        return p in s

    def _dev(self, ctx, data, lengths, pat):
        xp = ctx.xp
        if len(pat) == 0:
            return xp.ones(ctx.n, dtype=bool)
        return _match_starts(ctx, data, lengths, pat, "contains").any(axis=1)


@dataclass(frozen=True)
class SubstringIndex(Expression):
    """Spark ``substring_index(str, delim, count)`` — prefix before the
    count-th occurrence of delim (suffix after the count-th-from-last for
    negative counts); whole string when there are fewer occurrences.
    Byte-wise overlapping search, exactly UTF8String.subStringIndex.

    Reference rule: GpuOverrides.scala:2325 (GpuSubstringIndex; same
    literal-delim/count device gate)."""

    child: Expression
    delim: Expression
    count: Expression

    @property
    def data_type(self) -> DataType:
        return STRING

    @staticmethod
    def _cpu_one(s: str, delim: str, count: int) -> str:
        b, d = s.encode("utf-8"), delim.encode("utf-8")
        if not d or count == 0:
            return ""
        if count > 0:
            idx = -1
            for _ in range(count):
                idx = b.find(d, idx + 1)
                if idx < 0:
                    return s
            return b[:idx].decode("utf-8", "replace")
        k = -count
        idx = len(b) - len(d) + 1
        for _ in range(k):
            # search window end so that match starts are <= idx - 1
            idx = b.rfind(d, 0, idx - 1 + len(d))
            if idx < 0:
                return s
        return b[idx + len(d):].decode("utf-8", "replace")

    def eval(self, ctx: Ctx) -> Val:
        c = self.child.eval(ctx)
        dv = self.delim.eval(ctx)
        cv = self.count.eval(ctx)
        valid = and_valid(ctx, c.valid, dv.valid, cv.valid)
        if not ctx.is_device:
            s = _cpu_strs(ctx, c)
            ds = np.broadcast_to(np.asarray(dv.data, dtype=object), (ctx.n,))
            cs = np.broadcast_to(np.asarray(cv.data), (ctx.n,))
            out = [
                None if x is None or d is None else self._cpu_one(x, d, int(k))
                for x, d, k in zip(s, ds, cs.tolist())
            ]
            return Val(np.asarray(out, dtype=object), valid)
        xp = ctx.xp
        data, lengths = dev_str(ctx, c)
        pat = _lit_bytes(self.delim)
        count = int(self.count.value)
        w = data.shape[1]
        if not pat or count == 0:
            return Val(
                xp.zeros((ctx.n, w), dtype=xp.uint8),
                valid,
                xp.zeros(ctx.n, dtype=xp.int32),
            )
        m = _match_starts(ctx, data, lengths, pat, "substring_index")
        cum = xp.cumsum(xp.astype(m, xp.int32), axis=1)
        total = cum[:, -1]
        L = len(pat)
        pos_j = xp.arange(w, dtype=xp.int32)[None, :]
        if count > 0:
            sel = m & (cum == count)
            has = total >= count
            j = xp.astype(xp.argmax(sel, axis=1), xp.int32)
            new_len = xp.astype(xp.where(has, j, lengths), xp.int32)
            keep = pos_j < new_len[:, None]
            out = xp.astype(xp.where(keep, data, 0), xp.uint8)
            return Val(out, valid, new_len)
        k = -count
        rcount = total[:, None] - cum + xp.astype(m, xp.int32)
        sel = m & (rcount == k)
        has = total >= k
        j = xp.astype(xp.argmax(sel, axis=1), xp.int32)
        start = xp.where(has, j + L, 0)
        keep = (pos_j >= start[:, None]) & (pos_j < lengths[:, None])
        out, new_len = compact_bytes(ctx, data, keep)
        return Val(out, valid, new_len)


@dataclass(frozen=True)
class StringLocate(Expression):
    """Spark ``locate(substr, str, pos)``: 1-based char position of the first
    occurrence at or after char position ``pos``; 0 if absent; ``pos`` and the
    substring must be literals on device."""

    substr: Expression
    child: Expression
    start: Expression

    @property
    def data_type(self) -> DataType:
        return INT

    def eval(self, ctx: Ctx) -> Val:
        sub_v = self.substr.eval(ctx)
        c = self.child.eval(ctx)
        st_v = self.start.eval(ctx)
        valid = and_valid(ctx, c.valid, sub_v.valid, st_v.valid)
        if not ctx.is_device:
            s = _cpu_strs(ctx, c)
            sv = np.broadcast_to(np.asarray(sub_v.data, dtype=object), (ctx.n,))
            pv = np.broadcast_to(np.asarray(st_v.data), (ctx.n,))
            out = []
            for x, sub, pos in zip(s, sv, pv.tolist()):
                out.append(self._cpu_one(x, sub, int(pos)))
            return Val(np.asarray(out, dtype=np.int32), valid)
        xp = ctx.xp
        data, lengths = dev_str(ctx, c)
        pat = _lit_bytes(self.substr)
        pos0 = int(self.start.value) if isinstance(self.start, Literal) else 1
        idx, _, nchars = char_index(ctx, data, lengths)
        if len(pat) == 0:
            out = xp.where(
                (pos0 >= 1) & (xp.asarray(pos0) <= nchars + 1), pos0, 0
            )
            return Val(xp.astype(out, xp.int32), valid)
        if pos0 < 1:
            return Val(xp.zeros(ctx.n, dtype=xp.int32), valid)
        m = _match_starts(ctx, data, lengths, pat, "locate")
        cpos = idx + 1  # 1-based char position of each byte
        cand = xp.where(m & (cpos >= pos0), cpos, 2**30)
        best = xp.min(cand, axis=1)
        return Val(xp.astype(xp.where(best < 2**30, best, 0), xp.int32), valid)

    @staticmethod
    def _cpu_one(x, sub, pos):
        if x is None or sub is None:
            return 0
        if sub == "":
            return pos if 1 <= pos <= len(x) + 1 else 0
        if pos < 1:
            return 0
        return x.find(sub, pos - 1) + 1


# ── LIKE ────────────────────────────────────────────────────────────────────


def like_tokens(pattern: str, escape: str = "\\"):
    """Compile a LIKE pattern into (kind, byte) token list.
    kind: 0 literal byte, 1 ``_`` (one char), 2 ``%`` (any run)."""
    toks: list[tuple[int, int]] = []
    raw = pattern.encode("utf-8")
    esc = escape.encode("utf-8")[0] if escape else None
    i = 0
    while i < len(raw):
        b = raw[i]
        if esc is not None and b == esc:
            i += 1
            if i >= len(raw):
                raise ValueError("LIKE pattern ends with escape character")
            nb = raw[i]
            if nb not in (ord("_"), ord("%"), esc):
                raise ValueError(
                    f"LIKE escape must precede _, % or escape char (pattern {pattern!r})"
                )
            toks.append((0, nb))
        elif b == ord("_"):
            toks.append((1, 0))
        elif b == ord("%"):
            if not toks or toks[-1] != (2, 0):  # collapse %%
                toks.append((2, 0))
        else:
            toks.append((0, b))
        i += 1
    return toks


@dataclass(frozen=True)
class Like(Expression):
    """SQL LIKE with literal pattern (reference GpuLike also requires a
    scalar pattern). ``_`` consumes one CODE POINT (UTF8String semantics):
    the byte-NFA gives each ``_`` an in-character state that enters on a
    lead byte, self-loops on continuation bytes, and hands off to the next
    pattern state only at a character boundary (one-byte lookahead)."""

    child: Expression
    pattern: Expression
    escape: str = "\\"

    @property
    def data_type(self) -> DataType:
        return BOOLEAN

    def eval(self, ctx: Ctx) -> Val:
        c = self.child.eval(ctx)
        p = self.pattern.eval(ctx)
        valid = and_valid(ctx, c.valid, p.valid)
        if not ctx.is_device:
            s = _cpu_strs(ctx, c)
            pv = np.broadcast_to(np.asarray(p.data, dtype=object), (ctx.n,))
            out = []
            for x, pat in zip(s, pv):
                if x is None or pat is None:
                    out.append(False)
                    continue
                like_tokens(pat, self.escape)  # validate (Spark analysis error)
                rx = _like_to_regex(pat, self.escape)
                out.append(rx.fullmatch(x) is not None)
            return Val(np.asarray(out, dtype=bool), valid)
        data, lengths = dev_str(ctx, c)
        toks = like_tokens(self.pattern.value, self.escape)
        return Val(like_nfa(data, lengths, toks), valid)


def like_nfa(data, lengths, toks) -> "torch.Tensor":
    """bool[n]: each row's bytes match the LIKE tokens — the byte-NFA the
    JAX package runs as a ``lax.scan`` over the width, here a host loop over
    the ``W`` byte positions of whole-column torch ops on a ``[n, P+1]``
    state (no host sync in it).

    ``reach[:, k]``: the first ``k`` tokens match the bytes read so far.
    A literal token advances on its byte; ``%`` is an epsilon edge plus a
    self-loop on the post-``%`` state; ``_`` consumes one code point through
    an in-character state ``u[:, k]`` that enters on a lead byte, self-loops
    on continuation bytes and hands on where the next byte is not a
    continuation (one-byte lookahead). Rows past their length keep their
    state. ``like_tokens`` collapses ``%%``, so one pass of the epsilon
    edges closes a state. The plane is read transposed, so each step reads
    a contiguous row of bytes; every tensor written in place is one the step
    allocated."""
    import torch

    P = len(toks)
    n, w = data.shape
    dev = data.device
    kinds = torch.tensor([k for k, _ in toks], dtype=torch.int8, device=dev)
    lits = torch.tensor([b for _, b in toks], dtype=torch.uint8, device=dev)
    is_lit, is_any = kinds == 0, kinds == 1
    pct = [k for k, (kind, _) in enumerate(toks) if kind == 2]
    pct_from = torch.tensor(pct, dtype=torch.int64, device=dev)
    pct_to = pct_from + 1

    def closure(st):
        if pct:
            st[:, pct_to] |= st[:, pct_from]
        return st

    planes = data.t().contiguous()  # [w, n]
    cont = (planes & 0xC0) == 0x80
    reach = torch.zeros((n, P + 1), dtype=torch.bool, device=dev)
    reach[:, 0] = True
    reach = closure(reach)
    u = torch.zeros((n, P), dtype=torch.bool, device=dev)
    head = torch.zeros((n, 1), dtype=torch.bool, device=dev)
    for i in range(w):
        keep = (i < lengths)[:, None]
        is_cont = cont[i][:, None]
        if i + 1 < w:
            # this byte ends its character iff the next in-string byte is
            # not a continuation byte (or the string ends here)
            ends = ((i + 1 >= lengths) | ~cont[i + 1])[:, None]
        else:
            ends = torch.ones((n, 1), dtype=torch.bool, device=dev)
        r = reach[:, :P]
        inchar = ((r & ~is_cont) | (u & is_cont)) & is_any
        t = torch.where(
            is_lit,
            r & (planes[i][:, None] == lits),
            torch.where(is_any, inchar & ends, reach[:, 1:]),
        )
        new = closure(torch.cat([head, t], dim=1))
        reach = torch.where(keep, new, reach)
        u = torch.where(keep, inchar, u)
    return reach[:, P]


def _like_to_regex(pattern: str, escape: str):
    import re as _re

    out = []
    i = 0
    while i < len(pattern):
        ch = pattern[i]
        if escape and ch == escape:
            i += 1
            if i >= len(pattern):
                raise ValueError("LIKE pattern ends with escape character")
            out.append(_re.escape(pattern[i]))
        elif ch == "_":
            out.append(".")
        elif ch == "%":
            out.append(".*")
        else:
            out.append(_re.escape(ch))
        i += 1
    return _re.compile("".join(out), _re.DOTALL)
