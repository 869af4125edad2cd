"""String expression long tail — concat_ws, translate, split, regexp
family, get_json_object.

Reference: stringFunctions.scala:1-889 (GpuConcatWs, GpuStringTranslate,
GpuStringSplit, GpuRLike/GpuRegExpReplace/GpuRegExpExtract — cuDF regex
backed), GpuGetJsonObject.scala. Device support here:

* concat_ws / translate — fused byte-matrix kernels (translate is a 256-way
  lookup + compaction; ASCII-only arguments on device, like the reference
  requires scalar args).
* split / regexp family / get_json_object — CPU engine only for now: the
  reference leans on cuDF's device regex/JSON engines, which have no XLA
  analogue; the planner falls back per-node with an explain reason (its
  RegexParser rejects unsupported patterns the same way). Python ``re``
  semantics approximate Java regex for the common pattern classes —
  divergence class documented (the reference marks regexp incompat too).

Copied from ``spark_rapids_tpu/expr/strings_ext.py``.
"""
from __future__ import annotations

import json
import re
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from ..types import DataType, INT, ArrayType, StringType, STRING
from .base import Ctx, Expression, Literal, Val, and_valid
from .strings import (
    _cpu_strs,
    _lit_bytes,
    _out_width,
    byte_mask,
    compact_bytes,
    dev_str,
    is_string_literal,
)


@dataclass(frozen=True)
class ConcatWs(Expression):
    """``concat_ws(sep, cols…)`` — joins NON-null args with the separator
    (unlike concat, null args are skipped, and the result is null only when
    the separator is null)."""

    sep: Expression
    args: Tuple[Expression, ...]

    @property
    def data_type(self) -> DataType:
        return STRING

    @property
    def nullable(self) -> bool:
        return self.sep.nullable

    def eval(self, ctx: Ctx) -> Val:
        sv = self.sep.eval(ctx)
        vals = [a.eval(ctx) for a in self.args]
        if not ctx.is_device:
            seps = _cpu_strs(ctx, sv)
            svalid = ctx.broadcast_bool(sv.valid)
            cols = [_cpu_strs(ctx, v) for v in vals]
            valids = [ctx.broadcast_bool(v.valid) for v in vals]
            out = []
            for i in range(ctx.n):
                if not svalid[i]:
                    out.append(None)
                    continue
                parts = [
                    c[i] for c, vm in zip(cols, valids) if vm[i] and c[i] is not None
                ]
                out.append(seps[i].join(parts))
            return Val(np.asarray(out, dtype=object), svalid)
        xp = ctx.xp
        sep_data, sep_len = dev_str(ctx, sv)
        sep_mask = byte_mask(ctx, sep_data.shape[1], sep_len)
        mats, keeps = [], []
        total = 0
        any_prev = xp.zeros(ctx.n, dtype=bool)
        for v in vals:
            data, lengths = dev_str(ctx, v)
            vvalid = v.full_valid(ctx)
            # separator BEFORE this arg, when a previous arg was kept
            mats.append(sep_data)
            keeps.append(sep_mask & (any_prev & vvalid)[:, None])
            mats.append(data)
            keeps.append(byte_mask(ctx, data.shape[1], lengths) & vvalid[:, None])
            total += data.shape[1] + sep_data.shape[1]
            any_prev = any_prev | vvalid
        if not mats:
            w = sep_data.shape[1]
            return Val(
                xp.zeros((ctx.n, w), dtype=xp.uint8),
                sv.valid,
                xp.zeros(ctx.n, dtype=xp.int32),
            )
        cand = xp.concatenate(mats, axis=1)
        keep = xp.concatenate(keeps, axis=1)
        out, new_len = compact_bytes(ctx, cand, keep, out_width=_out_width(max(total, 1)))
        return Val(out, sv.valid, new_len)

    def __str__(self):
        return f"concat_ws({self.sep}, {', '.join(map(str, self.args))})"


@dataclass(frozen=True)
class StringTranslate(Expression):
    """``translate(str, from, to)`` — per-char mapping; chars of ``from``
    beyond ``to``'s length are deleted. Device: ASCII args (the planner
    gates), 256-entry lookup + compaction."""

    child: Expression
    matching: Expression  # literal
    replace: Expression  # literal

    @property
    def data_type(self) -> DataType:
        return STRING

    @property
    def nullable(self) -> bool:
        return self.child.nullable

    def _table(self):
        frm = self.matching.value
        to = self.replace.value
        tab = {}
        for i, ch in enumerate(frm):
            if ch not in tab:
                tab[ch] = to[i] if i < len(to) else None
        return tab

    def eval(self, ctx: Ctx) -> Val:
        c = self.child.eval(ctx)
        if not ctx.is_device:
            tab = self._table()
            s = _cpu_strs(ctx, c)
            out = [
                None
                if x is None
                else "".join(
                    tab.get(ch, ch) for ch in x if tab.get(ch, ch) is not None
                )
                for x in s
            ]
            return Val(np.asarray(out, dtype=object), c.valid)
        xp = ctx.xp
        lut = np.arange(256, dtype=np.int16)  # identity; -1 = delete
        for ch, to in self._table().items():
            lut[ord(ch)] = -1 if to is None else ord(to)
        lut_d = xp.asarray(lut)
        data, lengths = dev_str(ctx, c)
        mapped = lut_d[xp.astype(data, xp.int32)]
        keep = byte_mask(ctx, data.shape[1], lengths) & (mapped >= 0)
        out, new_len = compact_bytes(
            ctx, xp.astype(xp.where(mapped >= 0, mapped, 0), xp.uint8), keep,
            out_width=data.shape[1],
        )
        return Val(out, c.valid, new_len)


def translate_args_ascii(e: "StringTranslate") -> bool:
    return (
        is_string_literal(e.matching)
        and is_string_literal(e.replace)
        and e.matching.value.isascii()
        and e.replace.value.isascii()
    )


_REGEX_META = set("\\^$.|?*+()[]{}")


def split_device_pattern(pat: str):
    """(kind, payload) when the split pattern is device-feasible — a pure
    literal ('lit', bytes) or a plain char class like [,;] ('class',
    bytes of alternatives) — else None (full regex stays CPU-gated, like
    the reference gates what cuDF regex can't do; GpuOverrides.scala:2207
    GpuStringSplitMeta accepts literal/char-class there too)."""
    if not pat or not pat.isascii():
        # non-ASCII delimiters are multi-byte in UTF-8; the byte-wise class
        # kernel would mis-split — CPU path
        return None
    if not (_REGEX_META & set(pat)):
        return ("lit", pat.encode("utf-8"))
    if pat.startswith("[") and pat.endswith("]") and len(pat) > 2:
        inner = pat[1:-1]
        if not (_REGEX_META & set(inner)) and "-" not in inner and "^" not in inner:
            return ("class", inner.encode("utf-8"))
    return None


@dataclass(frozen=True)
class StringSplit(Expression):
    """``split(str, regex[, limit])`` → array<string>.

    Device path (literal / plain char-class patterns, the same subset the
    reference device-splits — GpuStringSplitMeta): delimiter-start mask
    over the padded byte planes (multi-byte literals resolve left-to-right
    non-overlap with a lax.scan over the width), token boundaries by
    per-token arg-min, one gather into the [n, maxTokens, w] element
    planes. Token counts beyond ``spark.rapids.sql.split.maxTokens`` fail
    loudly through the kernel error channel — never truncate silently.
    Full regex patterns execute on the CPU engine (planner gates)."""

    child: Expression
    pattern: Expression  # literal
    limit: int = -1
    max_tokens: int = 16  # device plane width; planner wires the conf in

    @property
    def data_type(self) -> DataType:
        return ArrayType(STRING, contains_null=False)

    @property
    def nullable(self) -> bool:
        return self.child.nullable

    def eval(self, ctx: Ctx) -> Val:
        if ctx.is_device:
            return self._eval_device(ctx)
        pat = self.pattern.value
        c = self.child.eval(ctx)
        s = _cpu_strs(ctx, c)
        rx = re.compile(pat)
        out = np.empty(ctx.n, dtype=object)
        for i in range(ctx.n):
            if s[i] is None:
                out[i] = None
                continue
            parts = rx.split(s[i], maxsplit=0 if self.limit <= 0 else self.limit - 1)
            if self.limit < 0 and parts and parts[-1] == "":
                # Java split with limit=-1 keeps trailing empties; Spark's
                # default limit (-1) KEEPS them — python re.split matches
                pass
            out[i] = parts
        return Val(out, c.valid)

    def _eval_device(self, ctx: Ctx) -> Val:
        import torch

        from ..columnar.device import DeviceColumn
        from .strings import dev_str

        kind, payload = split_device_pattern(self.pattern.value)
        v = self.child.eval(ctx)
        ch, lengths = dev_str(ctx, v)
        ch = ch.to(torch.uint8)
        lengths = lengths.to(torch.int32)
        n, w = ch.shape
        m = 1 if kind == "class" else len(payload)
        device = ch.device
        take = split_delimiter_starts(ch, lengths, kind, payload)
        if self.limit > 0:
            order = torch.cumsum(take.to(torch.int32), dim=1)
            take = take & (order <= self.limit - 1)
        ntok = take.sum(dim=1).to(torch.int32) + 1
        W = self.max_tokens
        if self.limit > 0:
            W = min(W, self.limit)
        valid = ctx.broadcast_bool(v.valid)
        # overflow → kernel error channel (loud, never truncated)
        ctx.register_error(
            f"split produced more than "
            f"{W} tokens (spark.rapids.sql.split.maxTokens) — raise the "
            f"conf or disable spark.rapids.sql.expression.StringSplit",
            (ntok > W) & valid,
        )
        # delimiter positions in order: d_pos[:, t] = first j where the
        # running delimiter count reaches t + 1 (W is small and static)
        cum = torch.cumsum(take.to(torch.int32), dim=1)
        idx = torch.arange(w, dtype=torch.int32, device=device)[None, :]
        d_pos = [
            torch.where(take & (cum == t + 1), idx, w).min(dim=1).values
            for t in range(W - 1)
        ]
        d_pos_m = (torch.stack(d_pos, dim=1) if d_pos
                   else torch.zeros((n, 0), dtype=torch.int32, device=device))
        starts = torch.cat([torch.zeros((n, 1), dtype=torch.int32, device=device), d_pos_m + m],
                           dim=1)  # [n, W]
        tpos = torch.arange(W, dtype=torch.int32, device=device)[None, :]
        n_live_tok = torch.minimum(ntok, torch.tensor(W, dtype=torch.int32, device=device))
        last = tpos == (n_live_tok[:, None] - 1)
        ends = torch.cat([d_pos_m, torch.full((n, 1), w, dtype=torch.int32, device=device)], dim=1)
        ends = torch.where(last, lengths[:, None], ends)
        tok_live = tpos < n_live_tok[:, None]
        tlen = (torch.clamp(ends - starts, 0, w) * tok_live).to(torch.int32)
        edata = split_token_planes(ch, starts, tlen)
        elem = DeviceColumn(STRING, edata, tok_live & valid[:, None], tlen)
        counts = torch.where(valid, n_live_tok, 0).to(torch.int32)
        return Val(None, valid, counts, (elem,))


def split_delimiter_starts(ch, lengths, kind: str, payload: bytes):
    """bool[n, w]: the delimiter occurrences split takes, at their first
    byte, over a padded byte plane (the JAX package's mask and its
    ``lax.scan``). A char class takes every member byte; a literal is
    matched by shifted compares, and a multi-byte literal resolves
    left-to-right without overlap — a scan over the width with an int32
    carry of the bytes still covered by the last delimiter taken (a host
    loop of whole-column ops here)."""
    import torch

    n, w = ch.shape
    idx = torch.arange(w, dtype=torch.int32, device=ch.device)
    if kind == "class":
        raw = torch.zeros((n, w), dtype=torch.bool, device=ch.device)
        for b in payload:
            raw = raw | (ch == int(b))
        return raw & (idx[None, :] < lengths[:, None])
    m = len(payload)
    raw = torch.ones((n, w), dtype=torch.bool, device=ch.device)
    for t, b in enumerate(payload):
        shifted = torch.nn.functional.pad(ch[:, t:], (0, t)) if t else ch
        raw = raw & (shifted == int(b))
    raw = raw & (idx[None, :] + m <= lengths[:, None])
    if m == 1:
        return raw
    taken = torch.zeros_like(raw)
    carry = torch.zeros(n, dtype=torch.int32, device=ch.device)
    for j in range(w):
        t = raw[:, j] & (carry == 0)
        taken[:, j] = t
        carry = torch.where(t, m - 1, torch.clamp(carry - 1, min=0)).to(torch.int32)
    return taken


def split_token_planes(ch, starts, tlen):
    """uint8[n, W, w]: token t of row i is bytes ``[starts[i, t],
    starts[i, t] + tlen[i, t])`` of ``ch`` row i, zero-padded. One ``[rows,
    w]`` gather per token and chunk of rows: the JAX package's single
    broadcast ``[n, W, w]`` gather index would need 8 bytes a slot (34 GB for
    ``o_comment`` at TPC-H SF 1 with 16 tokens)."""
    import torch

    from ..columnar.device import _PLANE_CHUNK_ELEMS

    n, w = ch.shape
    W = starts.shape[1]
    out = torch.zeros((n, W, w), dtype=torch.uint8, device=ch.device)
    cols = torch.arange(w, dtype=torch.int64, device=ch.device)[None, :]
    step = max(1, _PLANE_CHUNK_ELEMS // max(w, 1))
    for lo in range(0, n, step):
        hi = min(n, lo + step)
        rows = ch[lo:hi]
        for t in range(W):
            src = torch.clamp(starts[lo:hi, t, None].to(torch.int64) + cols, 0, w - 1)
            keep = cols < tlen[lo:hi, t, None]
            out[lo:hi, t] = torch.where(keep, torch.gather(rows, 1, src), 0)
    return out


@dataclass(frozen=True)
class RLike(Expression):
    """``str RLIKE pattern`` (unanchored regex find)."""

    child: Expression
    pattern: Expression  # literal

    @property
    def data_type(self) -> DataType:
        from ..types import BOOLEAN

        return BOOLEAN

    @property
    def nullable(self) -> bool:
        return self.child.nullable

    def eval(self, ctx: Ctx) -> Val:
        assert not ctx.is_device, "regexp executes on the CPU engine"
        c = self.child.eval(ctx)
        rx = re.compile(self.pattern.value)
        s = _cpu_strs(ctx, c)
        out = np.asarray(
            [bool(rx.search(x)) if x is not None else False for x in s]
        )
        return Val(out, c.valid)


def _java_replacement(repl: str) -> str:
    """Java's $1 group references → python \\1 (and \\$ literal)."""
    out = []
    i = 0
    while i < len(repl):
        ch = repl[i]
        if ch == "\\" and i + 1 < len(repl):
            out.append(re.escape(repl[i + 1]))
            i += 2
        elif ch == "$" and i + 1 < len(repl) and repl[i + 1].isdigit():
            out.append("\\" + repl[i + 1])
            i += 2
        else:
            out.append(re.escape(ch) if ch == "\\" else ch)
            i += 1
    return "".join(out)


@dataclass(frozen=True)
class RegExpReplace(Expression):
    """``regexp_replace(str, pattern, replacement)``."""

    child: Expression
    pattern: Expression
    replacement: Expression

    @property
    def data_type(self) -> DataType:
        return STRING

    @property
    def nullable(self) -> bool:
        return self.child.nullable

    def eval(self, ctx: Ctx) -> Val:
        assert not ctx.is_device, "regexp executes on the CPU engine"
        c = self.child.eval(ctx)
        rx = re.compile(self.pattern.value)
        repl = _java_replacement(self.replacement.value)
        s = _cpu_strs(ctx, c)
        out = np.asarray(
            [rx.sub(repl, x) if x is not None else None for x in s], dtype=object
        )
        return Val(out, c.valid)


@dataclass(frozen=True)
class RegExpExtract(Expression):
    """``regexp_extract(str, pattern, idx)`` — group idx of the FIRST match,
    empty string when no match (Spark semantics)."""

    child: Expression
    pattern: Expression
    idx: int = 1

    @property
    def data_type(self) -> DataType:
        return STRING

    @property
    def nullable(self) -> bool:
        return self.child.nullable

    def eval(self, ctx: Ctx) -> Val:
        assert not ctx.is_device, "regexp executes on the CPU engine"
        c = self.child.eval(ctx)
        rx = re.compile(self.pattern.value)
        s = _cpu_strs(ctx, c)
        out = []
        for x in s:
            if x is None:
                out.append(None)
                continue
            m = rx.search(x)
            if m is None:
                out.append("")
            else:
                g = m.group(self.idx)
                out.append(g if g is not None else "")
        return Val(np.asarray(out, dtype=object), c.valid)


def _json_path_steps(path: str):
    """$.a.b[0].c → [('key','a'), ('key','b'), ('index',0), ('key','c')];
    None for malformed paths (→ null results, Spark behavior)."""
    if not path.startswith("$"):
        return None
    steps = []
    i = 1
    while i < len(path):
        ch = path[i]
        if ch == ".":
            j = i + 1
            while j < len(path) and path[j] not in ".[":
                j += 1
            if j == i + 1:
                return None
            steps.append(("key", path[i + 1 : j]))
            i = j
        elif ch == "[":
            j = path.find("]", i)
            if j < 0:
                return None
            body = path[i + 1 : j]
            if not body.isdigit():
                return None
            steps.append(("index", int(body)))
            i = j + 1
        else:
            return None
    return steps


def _json_masks(xp, b):
    """Per-byte structural masks of a padded JSON byte plane [n, w]:
    (in_str inclusive of the opening quote, depth AFTER this byte,
    depth BEFORE this byte). Escaped quotes are handled by the
    prev-byte-backslash rule — a double-backslash before a closing quote
    is the documented divergence of the span-based device path."""
    prev = xp.pad(b[:, :-1], ((0, 0), (1, 0)))
    quote = (b == ord('"')) & (prev != ord("\\"))
    cums = xp.cumsum(xp.astype(quote, xp.int32), axis=1)
    in_str = (cums % 2) == 1  # opening quote .. char before closing quote
    # brackets inside string literals are data, not structure
    struct = ~in_str
    opens = ((b == ord("{")) | (b == ord("["))) & struct
    closes = ((b == ord("}")) | (b == ord("]"))) & struct
    depth = xp.cumsum(xp.astype(opens, xp.int32) - xp.astype(closes, xp.int32), axis=1)
    depth_before = depth - xp.astype(opens, xp.int32) + xp.astype(closes, xp.int32)
    return in_str, depth, depth_before


def _first_at_or_after(xp, mask, start, w):
    """Per row: smallest position >= start where mask holds, else w."""
    pos = xp.arange(w, dtype=xp.int32)[None, :]
    cand = xp.where(mask & (pos >= start[:, None]), pos, w)
    return xp.astype(xp.min(cand, axis=1), xp.int32)


@dataclass(frozen=True)
class GetJsonObject(Expression):
    """``get_json_object(json, '$.path')`` (reference rule
    GpuOverrides.scala:2519, GpuGetJsonObject.scala → cudf's span-based
    get_json_object). CPU engine normalizes through a JSON parser (Jackson
    shape: scalars unquoted, objects/arrays re-serialized compactly).

    The DEVICE path (gated by ``spark.rapids.sql.getJsonObject.enabled``,
    default off) extracts the RAW VALUE SPAN via vectorized depth/string
    masks + per-step span narrowing — like the reference's cudf kernel it
    returns nested results as written (no re-serialization) and does not
    unescape string values; exact on compact JSON without escapes
    (docs/compatibility.md)."""

    child: Expression
    path: Expression  # literal

    @property
    def data_type(self) -> DataType:
        return STRING

    def _eval_device(self, ctx: Ctx, c) -> Val:
        from .strings import _match_starts, _rev_cummin, compact_bytes, dev_str

        xp = ctx.xp
        data, lengths = dev_str(ctx, c)
        n, w = data.shape
        steps = _json_path_steps(self.path.value)
        valid = c.full_valid(ctx)
        if steps is None:
            return Val(
                xp.zeros((n, w), dtype=xp.uint8),
                xp.zeros(n, dtype=bool),
                xp.zeros(n, dtype=xp.int32),
            )
        in_str, depth, depth_before = _json_masks(xp, data)
        pos = xp.arange(w, dtype=xp.int32)[None, :]
        in_len = pos < lengths[:, None]
        nonspace = in_len & (data != ord(" ")) & (data != ord("\t")) & (
            data != ord("\n")
        ) & (data != ord("\r"))
        # loop-invariant: first nonspace at-or-after each position
        next_ns = _rev_cummin(xp, xp.where(nonspace, pos, w))
        # structural truncation guard: unbalanced brackets or an unclosed
        # string at end-of-document → NULL like a real parser (cheap; full
        # grammar validation is the CPU path's job)
        last_i = xp.clip(lengths - 1, 0, w - 1)[:, None]
        end_depth = xp.where(
            lengths > 0, xp.take_along_axis(depth, last_i, axis=1)[:, 0], 0
        )
        # in_str is exclusive of closing quotes, so a well-formed document
        # never ends inside a string (a trailing OPENING quote is in_str)
        end_in_str = (lengths > 0) & xp.take_along_axis(
            in_str, last_i, axis=1
        )[:, 0]
        well_formed = (end_depth == 0) & ~end_in_str
        # value span [lo, hi) — the root value, trailing whitespace trimmed
        lo = _first_at_or_after(xp, nonspace, xp.zeros(n, xp.int32), w)
        hi = xp.astype(xp.max(xp.where(nonspace, pos, -1), axis=1) + 1, xp.int32)
        ok = (lo < hi) & well_formed
        for kind, v in steps:
            # container must open the span
            first = xp.take_along_axis(
                data, xp.clip(lo, 0, w - 1)[:, None], axis=1
            )[:, 0]
            d_entry = xp.take_along_axis(
                depth, xp.clip(lo, 0, w - 1)[:, None], axis=1
            )[:, 0]
            span = (pos >= lo[:, None]) & (pos < hi[:, None])
            if kind == "key":
                ok = ok & (first == ord("{"))
                pat = b'"' + str(v).encode("utf-8") + b'"'
                m = _match_starts(ctx, data, lengths, pat, "get_json_object")
                # per-candidate ':' validation distinguishes a KEY from a
                # string VALUE with the same bytes at the same depth
                after_key = xp.clip(pos + len(pat), 0, w - 1)
                colon_at = xp.take_along_axis(next_ns, after_key, axis=1)
                colon_ch = xp.take_along_axis(
                    data, xp.clip(colon_at, 0, w - 1), axis=1
                )
                cand = (
                    m
                    & span
                    & (depth_before == d_entry[:, None])
                    & (colon_ch == ord(":"))
                    & (colon_at < hi[:, None])
                )
                kpos = xp.astype(xp.min(xp.where(cand, pos, w), axis=1), xp.int32)
                ok = ok & (kpos < w)
                colon = xp.take_along_axis(
                    colon_at, xp.clip(kpos, 0, w - 1)[:, None], axis=1
                )[:, 0]
                vstart = _first_at_or_after(xp, nonspace, colon + 1, w)
            else:  # index
                ok = ok & (first == ord("["))
                commas = (
                    (data == ord(","))
                    & ~in_str
                    & span
                    & (depth_before == d_entry[:, None])
                )
                if v == 0:
                    vstart = _first_at_or_after(xp, nonspace, lo + 1, w)
                else:
                    ccount = xp.cumsum(xp.astype(commas, xp.int32), axis=1)
                    at_v = commas & (ccount == v)
                    cpos = xp.astype(xp.min(xp.where(at_v, pos, w), axis=1), xp.int32)
                    ok = ok & (cpos < w)
                    vstart = _first_at_or_after(xp, nonspace, cpos + 1, w)
                # the selected entry must exist (not past the close bracket)
                close_ch = xp.take_along_axis(
                    data, xp.clip(vstart, 0, w - 1)[:, None], axis=1
                )[:, 0]
                ok = ok & (vstart < hi) & (close_ch != ord("]"))
            # value end: next separator/close at entry depth
            sep = (
                ((data == ord(",")) | (data == ord("}")) | (data == ord("]")))
                & ~in_str
                & (depth_before == d_entry[:, None])
            )
            vend = _first_at_or_after(xp, sep, vstart, w)
            vend = xp.minimum(vend, hi)
            # trim trailing whitespace: last nonspace in [vstart, vend)
            lastns = xp.max(xp.where(
                nonspace & (pos >= vstart[:, None]) & (pos < vend[:, None]),
                pos,
                -1,
            ), axis=1)
            lo = vstart
            hi = xp.astype(lastns + 1, xp.int32)
            ok = ok & (lo < hi)
        # unquote string results
        first = xp.take_along_axis(data, xp.clip(lo, 0, w - 1)[:, None], axis=1)[:, 0]
        last = xp.take_along_axis(
            data, xp.clip(hi - 1, 0, w - 1)[:, None], axis=1
        )[:, 0]
        quoted = ok & (first == ord('"')) & (last == ord('"')) & (hi - lo >= 2)
        lo = xp.where(quoted, lo + 1, lo)
        hi = xp.where(quoted, hi - 1, hi)
        # a JSON null VALUE is SQL NULL (Spark returns null, not 'null')
        is_null_lit = ok & ~quoted & (hi - lo == 4)
        for off, ch in enumerate(b"null"):
            at = xp.take_along_axis(
                data, xp.clip(lo + off, 0, w - 1)[:, None], axis=1
            )[:, 0]
            is_null_lit = is_null_lit & (at == ch)
        ok = ok & ~is_null_lit
        keep = (pos >= lo[:, None]) & (pos < hi[:, None]) & ok[:, None]
        out, new_len = compact_bytes(ctx, data, keep)
        return Val(out, valid & ok, new_len)

    def eval(self, ctx: Ctx) -> Val:
        c = self.child.eval(ctx)
        if ctx.is_device:
            return self._eval_device(ctx, c)
        steps = _json_path_steps(self.path.value)
        s = _cpu_strs(ctx, c)
        valid = ctx.broadcast_bool(c.valid)
        out = []
        ok = np.zeros(ctx.n, dtype=bool)
        for i in range(ctx.n):
            x = s[i] if valid[i] else None
            res = None
            if x is not None and steps is not None:
                try:
                    cur = json.loads(x)
                    for kind, v in steps:
                        if kind == "key":
                            if not isinstance(cur, dict) or v not in cur:
                                cur = _MISSING
                                break
                            cur = cur[v]
                        else:
                            if not isinstance(cur, list) or v >= len(cur):
                                cur = _MISSING
                                break
                            cur = cur[v]
                    if cur is not _MISSING and cur is not None:
                        if isinstance(cur, str):
                            res = cur
                        elif isinstance(cur, bool):
                            res = "true" if cur else "false"
                        elif isinstance(cur, (dict, list)):
                            res = json.dumps(cur, separators=(",", ":"))
                        else:
                            res = json.dumps(cur)
                except (ValueError, TypeError):
                    res = None
            out.append(res)
            ok[i] = res is not None
        return Val(np.asarray(out, dtype=object), ok)


_MISSING = object()
