"""Device window operator — ``GpuWindowExec``, in torch.

Reference: GpuWindowExec.scala + GpuWindowExpression.scala (cudf
``groupBy.aggregateWindows`` / ``aggregateWindowsOverRanges``). The port of
``spark_rapids_tpu/exec/tpu_window.py``: the whole spec group runs over the
partition's batches concatenated into one (``ops/concat.py``) —

1. radix-encode the partition and order keys (``ops/sortkeys.py``), one
   stable LSD sort with live rows first;
2. segment and peer starts by adjacent word difference;
3. every window function is torch ops over segmented scans
   (``ops/scan.py::segscan``) and gathers: running and unbounded frames
   gather an inclusive scan at the segment or peer end, bounded sum, count
   and avg take prefix-sum differences at clamped indices, bounded min and
   max query a sparse table (doubling RMQ), numeric RANGE bounds are
   per-row binary searches in value space, lead and lag are in-segment
   gathers, and the ranks are index arithmetic on peer starts.

Rows come out partition-sorted (Spark's window output order). Float sums
keep the JAX package's order of operations (scans and prefix differences,
no atomics); the log-step scan's association differs from XLA's tree only
in rounding. The window runs behind ``with_oom_retry``, as in the JAX
package: a device OOM spills the catalog and retries the whole partition's
window (it is not splittable: a partition's frames span its batches).
"""
from __future__ import annotations

from typing import List

import torch

from ..columnar.device import DeviceBatch, DeviceColumn, dc_replace
from ..expr import Expression, bind
from ..expr.aggregates import Average, Count, Max, Min, Sum
from ..expr.base import Ctx
from ..expr.windows import (
    CURRENT_ROW,
    UNBOUNDED_FOLLOWING,
    UNBOUNDED_PRECEDING,
    CumeDist,
    DenseRank,
    Lag,
    Lead,
    NTile,
    PercentRank,
    Rank,
    RowNumber,
)
from ..ops.concat import concat_device
from ..ops.gather import gather_batch
from ..ops.scan import seg_end_flags, segscan
from ..ops.sortkeys import column_radix_words, sort_permutation
from ..plan.physical import Exec, ExecContext, PartitionSet
from ..types import NullType, Schema, StringType, StructField
from ..xp import torch_dtype
from .gpu import val_to_column


def _rev(x: torch.Tensor) -> torch.Tensor:
    return torch.flip(x, dims=(0,))


def _seg_last_idx(idx: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """Per-row index of its segment's last row (reverse segmented max)."""
    return _rev(segscan(_rev(idx), _rev(seg_end_flags(starts)), "max"))


class GpuWindowExec(Exec):
    def __init__(self, window_cols: list, child: Exec):
        super().__init__([child])
        self.window_cols = window_cols  # [(name, WindowExpression)]
        self.spec = window_cols[0][1].spec
        fields = list(child.output.fields)
        for name, we in window_cols:
            fields.append(StructField(name, we.data_type, we.nullable))
        self._schema = Schema(fields)

    @property
    def output(self) -> Schema:
        return self._schema

    @property
    def is_device(self) -> bool:
        return True

    def execute(self, ctx: ExecContext) -> PartitionSet:
        child = self.children[0]
        fn = window_fn(self.spec, tuple(self.window_cols), self._schema, child.output)

        def run(it):
            from ..mem.spill import with_oom_retry

            batches = list(it)
            if not batches:
                return
            merged = concat_device(batches)
            del batches
            out = with_oom_retry(ctx.catalog, fn, merged)
            del merged
            yield out

        return child.execute(ctx).map_partitions(run)

    def node_string(self):
        names = ", ".join(str(we) for _, we in self.window_cols)
        return f"GpuWindow [{names}]"


def window_fn(spec, window_cols: tuple, out_schema: Schema, child_schema: Schema):
    """The window computation over one concatenated partition batch (the
    JAX package's ``_make_window_kernel``)."""
    pkeys = tuple(bind(p, child_schema) for p in spec.partition_by)
    orders = tuple(
        (bind(o.child, child_schema), o.ascending, o.resolved_nulls_first())
        for o in spec.order_by
    )

    def fn(batch: DeviceBatch) -> DeviceBatch:
        cap = batch.capacity
        c = Ctx.for_device(batch)
        live0 = batch.row_mask()

        def words_of(exprs_dirs):
            words = []
            for e, asc, nf in exprs_dirs:
                col = val_to_column(c, e.eval(c), e.data_type)
                col = dc_replace(col, validity=col.validity & live0)
                words.extend(column_radix_words(col, asc, nf))
            return words

        pk_words = words_of([(p, True, True) for p in pkeys])
        ok_words = words_of(orders)
        all_words = pk_words + ok_words
        if all_words:
            perm = sort_permutation(all_words, live0)
        else:
            perm = torch.arange(cap, dtype=torch.int64, device=batch.device)
        sorted_batch = gather_batch(batch, perm, batch.num_rows)
        live = sorted_batch.row_mask()
        idx = torch.arange(cap, dtype=torch.int64, device=batch.device)

        def add_starts(s, words):
            for w in words:
                sw = w[perm]
                prev = torch.cat([sw[:1], sw[:-1]])
                s = s | ((sw != prev) & live)
            return s

        first_live = (idx == 0) & live
        seg_start = add_starts(first_live, pk_words)
        peer_start = add_starts(seg_start, ok_words)
        # padding is its own segment so the last live segment ends at
        # num_rows-1, not cap-1 (lead/default, suffix scans, seg_last)
        pad_start = idx == sorted_batch.num_rows
        seg_start = seg_start | pad_start
        peer_start = peer_start | pad_start

        seg_first = segscan(idx, seg_start, "min")
        seg_last = _seg_last_idx(idx, seg_start)
        peer_first = segscan(idx, peer_start, "min")
        peer_last = _seg_last_idx(idx, peer_start)

        sctx = Ctx.for_device(sorted_batch)
        new_cols: List[DeviceColumn] = []
        for _, we in window_cols:
            new_cols.append(
                compute_window_column(
                    we, sctx, child_schema, cap, live,
                    seg_start, seg_first, seg_last,
                    peer_start, peer_first, peer_last, idx,
                )
            )
        return DeviceBatch(
            out_schema, list(sorted_batch.columns) + new_cols, sorted_batch.num_rows
        )

    return fn


def compute_window_column(
    we, ctx, schema, cap, live,
    seg_start, seg_first, seg_last,
    peer_start, peer_first, peer_last, idx,
) -> DeviceColumn:
    """One window expression's column over the sorted batch (the JAX
    package's ``_compute_window_column``). ``idx`` and the segment and peer
    bounds are int64 row indices."""
    fn = we.function
    frame = we.spec.resolved_frame()
    f64 = torch.float64

    if isinstance(fn, RowNumber):
        return DeviceColumn(we.data_type, (idx - seg_first + 1).to(torch.int32), live)
    if isinstance(fn, Rank):
        return DeviceColumn(we.data_type, (peer_first - seg_first + 1).to(torch.int32), live)
    if isinstance(fn, DenseRank):
        out = segscan(peer_start.to(torch.int32), seg_start, "add")
        return DeviceColumn(we.data_type, out.to(torch.int32), live)
    if isinstance(fn, (PercentRank, CumeDist, NTile)):
        n = (seg_last - seg_first + 1).to(f64)
        if isinstance(fn, PercentRank):
            rank = (peer_first - seg_first).to(f64)
            out = torch.where(n > 1, rank / torch.clamp(n - 1, min=1.0), 0.0)
            return DeviceColumn(we.data_type, out, live)
        if isinstance(fn, CumeDist):
            le = (peer_last - seg_first + 1).to(f64)
            return DeviceColumn(we.data_type, le / torch.clamp(n, min=1.0), live)
        # NTile: the first (n % b) buckets take one extra row
        b = fn.buckets
        ni = seg_last - seg_first + 1
        rn0 = idx - seg_first  # 0-based row number
        base = torch.div(ni, b, rounding_mode="floor")
        rem = ni % b
        big_span = rem * (base + 1)
        bucket = torch.where(
            rn0 < big_span,
            torch.div(rn0, torch.clamp(base + 1, min=1), rounding_mode="floor"),
            rem + torch.div(rn0 - big_span, torch.clamp(base, min=1), rounding_mode="floor"),
        )
        return DeviceColumn(we.data_type, (bucket + 1).to(torch.int32), live)

    if isinstance(fn, (Lead, Lag)):
        from ..ops.join import pad_string_column

        x = bind(fn.child, schema)
        col = val_to_column(ctx, x.eval(ctx), x.data_type)
        dflt = bind(fn.default, schema)
        if isinstance(dflt.data_type, NullType):
            # NULL default: a zeroed, all-invalid column of the input shape
            dcol = DeviceColumn(
                x.data_type,
                torch.zeros_like(col.data),
                torch.zeros(cap, dtype=torch.bool, device=live.device),
                None if col.lengths is None else torch.zeros_like(col.lengths),
            )
        else:
            dcol = val_to_column(ctx, dflt.eval(ctx), x.data_type)
            if col.data.ndim == 2:  # unify string widths
                w = max(col.data.shape[1], dcol.data.shape[1])
                col = pad_string_column(col, w)
                dcol = pad_string_column(dcol, w)
        k = fn.offset if isinstance(fn, Lead) else -fn.offset
        j = idx + k
        ok = (j >= seg_first) & (j <= seg_last) & live
        safe = torch.clamp(j, 0, cap - 1)
        data = torch.where(
            ok[:, None] if col.data.ndim == 2 else ok,
            col.data[safe],
            dcol.data,
        )
        valid = torch.where(ok, col.validity[safe], dcol.validity) & live
        lengths = None
        if col.lengths is not None:
            dlen = dcol.lengths if dcol.lengths is not None else torch.zeros_like(col.lengths)
            lengths = torch.where(ok, col.lengths[safe], dlen)
        return DeviceColumn(we.data_type, data, valid, lengths)

    # ── aggregates over a frame ─────────────────────────────────────────
    inner = _agg_input(fn)
    x = bind(inner, schema)
    col = val_to_column(ctx, x.eval(ctx), x.data_type)
    data = col.data
    valid = col.validity & live
    is_avg = isinstance(fn, Average)
    is_count = isinstance(fn, Count)

    # frame endpoints as row indices
    sentinels = (UNBOUNDED_PRECEDING, CURRENT_ROW, UNBOUNDED_FOLLOWING)
    if frame.frame_type == "rows":
        lo = seg_first if frame.lower == UNBOUNDED_PRECEDING else torch.maximum(
            seg_first, idx + frame.lower
        )
        hi = seg_last if frame.upper == UNBOUNDED_FOLLOWING else torch.minimum(
            seg_last, idx + frame.upper
        )
    elif frame.lower in sentinels and frame.upper in sentinels:
        # peer-bounded RANGE (multi-key orders allowed)
        lo = seg_first if frame.lower == UNBOUNDED_PRECEDING else peer_first
        hi = seg_last if frame.upper == UNBOUNDED_FOLLOWING else peer_last
    else:
        # numeric RANGE: value-space searches over the single order key
        o = we.spec.order_by[0]
        oe = bind(o.child, schema)
        ocol = val_to_column(ctx, oe.eval(ctx), oe.data_type)
        ovalid = ocol.validity & live
        ov = ocol.data
        if not ov.dtype.is_floating_point:
            ov = ov.to(torch.int64)
        frame = frame.scaled_for_decimal(oe.data_type)
        sval = ov if o.ascending else -ov
        # null rows sort to a contiguous block; a sentinel keeps sval
        # ascending across it
        if sval.dtype.is_floating_point:
            neg_s, pos_s = float("-inf"), float("inf")
        else:
            info = torch.iinfo(sval.dtype)
            neg_s, pos_s = info.min, info.max
        nulls_first = o.resolved_nulls_first()
        sval = torch.where(ovalid, sval, neg_s if nulls_first else pos_s)
        lo, hi = range_frame_bounds(
            frame, sval, ovalid, seg_first, seg_last, peer_first, peer_last, cap
        )
    nonempty = (lo <= hi) & live

    if isinstance(fn, (Min, Max)) and isinstance(x.data_type, StringType):
        # string min/max over any frame: lexicographic arg-pick through the
        # same doubling RMQ over the group-by's radix-word encoding
        from ..ops.aggregate import _string_base_words, _string_value_words

        vwords = _string_value_words(
            _string_base_words(col), valid, isinstance(fn, Min)
        )
        pick = sparse_argpick_words(vwords, lo, hi, cap)
        pcnt = segscan(valid.to(torch.int64), seg_start, "add")
        hi_c = pcnt[torch.clamp(hi, 0, cap - 1)]
        lo_c = torch.where(
            lo > seg_first, pcnt[torch.clamp(lo - 1, 0, cap - 1)], 0
        )
        ok = ((hi_c - lo_c) > 0) & nonempty
        safe = torch.clamp(pick, 0, cap - 1)
        data_o = torch.where(ok[:, None], col.data[safe], 0).to(torch.uint8)
        len_o = torch.where(ok, col.lengths[safe], 0).to(torch.int32)
        return DeviceColumn(we.data_type, data_o, ok, len_o)

    if isinstance(fn, (Min, Max)):
        op = "min" if isinstance(fn, Min) else "max"
        is_float = data.dtype.is_floating_point
        if is_float:
            ident = float("inf") if isinstance(fn, Min) else float("-inf")
            # Spark NaN-greatest: +inf sentinel, restored after the scan.
            # aux flag — max: "frame saw a NaN" (result becomes NaN); min:
            # "frame saw a non-NaN value" (else the min IS NaN), which tells
            # an all-NaN frame from a genuine +inf minimum
            aux = (
                (valid & ~torch.isnan(data))
                if isinstance(fn, Min)
                else (valid & torch.isnan(data))
            )
            work = torch.where(
                valid, torch.where(torch.isnan(data), float("inf"), data), ident
            )
        else:
            info = torch.iinfo(data.dtype)
            ident = info.max if isinstance(fn, Min) else info.min
            aux = torch.zeros(cap, dtype=torch.bool, device=data.device)
            work = torch.where(valid, data, ident)
        bounded = (
            frame.lower != UNBOUNDED_PRECEDING
            and frame.upper != UNBOUNDED_FOLLOWING
        )
        if bounded:
            out, any_valid, any_aux = sparse_minmax(
                work, valid, aux, lo, hi, cap, op, ident
            )
        else:
            out, any_valid, any_aux = _scan_window(
                work, valid, aux, frame, seg_start, lo, hi, seg_last, cap, op
            )
        if is_float:
            if isinstance(fn, Max):
                out = torch.where(any_aux, float("nan"), out)
            else:
                out = torch.where(any_valid & ~any_aux, float("nan"), out)
        return DeviceColumn(
            we.data_type,
            out.to(torch_dtype(we.data_type.np_dtype)),
            any_valid & nonempty,
        )

    # sum / count / avg via segmented prefix sums + clamped index gathers
    sum_dt = f64 if (is_avg or data.dtype.is_floating_point) else torch.int64
    vals = torch.where(valid, data.to(sum_dt), torch.zeros((), dtype=sum_dt, device=data.device))
    cnts = valid.to(torch.int64)
    psum = segscan(vals, seg_start, "add")
    pcnt = segscan(cnts, seg_start, "add")

    def window_total(pref):
        hi_v = pref[torch.clamp(hi, 0, cap - 1)]
        lo_prev = torch.clamp(lo - 1, 0, cap - 1)
        lo_v = torch.where(lo > seg_first, pref[lo_prev], torch.zeros_like(pref[0]))
        return hi_v - lo_v

    total = window_total(psum)
    count = window_total(pcnt)
    if is_count:
        return DeviceColumn(
            we.data_type,
            torch.where(nonempty, count, 0).to(torch.int64),
            live,  # count is never null
        )
    if is_avg:
        out = total / torch.clamp(count, min=1).to(f64)
        return DeviceColumn(we.data_type, out, (count > 0) & nonempty)
    # sum (wrapping long for integrals, double for floats: Sum.update's cast)
    out = total.to(torch_dtype(we.data_type.np_dtype))
    return DeviceColumn(we.data_type, out, (count > 0) & nonempty)


def _scan_window(work, valid, had_nan, frame, seg_start, lo, hi, seg_last, cap, op):
    """min/max for frames with at least one unbounded end: gather the
    inclusive prefix scan at ``hi`` (lower unbounded) or the suffix scan at
    ``lo`` (upper unbounded). ``lo``/``hi`` are already segment-clamped; an
    empty frame's garbage gather is masked by the caller's nonempty flag."""
    end_flags = seg_end_flags(seg_start)
    lower_unb = frame.lower == UNBOUNDED_PRECEDING
    upper_unb = frame.upper == UNBOUNDED_FOLLOWING
    if lower_unb:
        pre = segscan(work, seg_start, op)
        pre_valid = segscan(valid.to(torch.int32), seg_start, "add") > 0
        pre_nan = segscan(had_nan.to(torch.int32), seg_start, "add") > 0
        end = torch.clamp(seg_last if upper_unb else hi, 0, cap - 1)
        return pre[end], pre_valid[end], pre_nan[end]
    # upper unbounded
    suf = _rev(segscan(_rev(work), _rev(end_flags), op))
    suf_valid = _rev(segscan(_rev(valid.to(torch.int32)), _rev(end_flags), "add")) > 0
    suf_nan = _rev(segscan(_rev(had_nan.to(torch.int32)), _rev(end_flags), "add")) > 0
    start = torch.clamp(lo, 0, cap - 1)
    return suf[start], suf_valid[start], suf_nan[start]


def _levels(cap: int) -> int:
    return max(1, int(cap).bit_length())


def _level_of(lo: torch.Tensor, hi: torch.Tensor, levels: int) -> torch.Tensor:
    """Per row, the largest k < levels with 2^k <= the frame length."""
    L = torch.clamp(hi - lo + 1, min=1)
    m = torch.zeros_like(lo)
    for k in range(1, levels):
        m = torch.where(L >= (1 << k), k, m)
    return m


def sparse_minmax(work, valid, aux, lo, hi, cap, op, ident):
    """Bounded min/max via a sparse-table range query (doubling RMQ):
    O(cap·log cap) build, two gathers per row, for ANY [lo, hi] row bounds
    (ROWS and numeric RANGE frames share it). The JAX package's
    ``_sparse_minmax``; ``op`` is "min" or "max"."""
    f = torch.minimum if op == "min" else torch.maximum
    levels = _levels(cap)
    T, V, A = [work], [valid], [aux]
    for k in range(1, levels):
        s = 1 << (k - 1)

        def sh(arr, fill):
            pad = torch.full((s,), fill, dtype=arr.dtype, device=arr.device)
            return torch.cat([arr[s:], pad])

        T.append(f(T[-1], sh(T[-1], ident)))
        V.append(V[-1] | sh(V[-1], False))
        A.append(A[-1] | sh(A[-1], False))
    Ts, Vs, As = torch.stack(T), torch.stack(V), torch.stack(A)
    m = _level_of(lo, hi, levels)
    pw = torch.ones_like(m) << m
    lo_c = torch.clamp(lo, 0, cap - 1)
    j2 = torch.clamp(hi - pw + 1, 0, cap - 1)
    out = f(Ts[m, lo_c], Ts[m, j2])
    return out, Vs[m, lo_c] | Vs[m, j2], As[m, lo_c] | As[m, j2]


def sparse_argpick_words(words: list, lo, hi, cap):
    """Doubling RMQ over row indices with a lexicographic word compare: the
    index of the lex-smallest word tuple in [lo, hi] (ties keep the earlier
    row). Serves string min and max: the caller inverts the value words for
    max (``_string_value_words``). The JAX package's
    ``_sparse_argpick_words``."""
    idx0 = torch.arange(cap, dtype=torch.int64, device=lo.device)

    def lex_le(ia, ib):
        lt = torch.zeros(ia.shape, dtype=torch.bool, device=ia.device)
        eq = torch.ones(ia.shape, dtype=torch.bool, device=ia.device)
        for w in words:
            wa, wb = w[ia], w[ib]
            lt = lt | (eq & (wa < wb))
            eq = eq & (wa == wb)
        return lt | eq

    levels = _levels(cap)
    T = [idx0]
    for k in range(1, levels):
        s = 1 << (k - 1)
        prev = T[-1]
        # tail cells fall back to their own (in-range) index
        shifted = torch.cat([prev[s:], idx0[cap - s:]])
        T.append(torch.where(lex_le(prev, shifted), prev, shifted))
    Ts = torch.stack(T)
    m = _level_of(lo, hi, levels)
    pw = torch.ones_like(m) << m
    p1 = Ts[m, torch.clamp(lo, 0, cap - 1)]
    p2 = Ts[m, torch.clamp(hi - pw + 1, 0, cap - 1)]
    return torch.where(lex_le(p1, p2), p1, p2)


def bsearch_first(sval, lo_b, hi_b, target, cap, strict: bool):
    """Vectorized per-row binary search: first j in [lo_b, hi_b] with
    sval[j] >= target (or > when ``strict``), else hi_b + 1 (sval ascending
    within the segment). The JAX package's ``_bsearch_first``."""
    l = lo_b.to(torch.int64)
    r = hi_b.to(torch.int64) + 1
    for _ in range(int(cap).bit_length() + 1):
        m = torch.div(l + r, 2, rounding_mode="floor")
        mc = torch.clamp(m, 0, cap - 1)
        hit = (sval[mc] > target) if strict else (sval[mc] >= target)
        go_left = hit & (l < r)
        r = torch.where(go_left, m, r)
        l = torch.where(go_left | (l >= r), l, m + 1)
    return l


def range_frame_bounds(
    frame, sval, ovalid, seg_first, seg_last, peer_first, peer_last, cap
):
    """Row bounds of a numeric RANGE frame: value-space binary searches
    within the segment (cudf aggregateWindowsOverRanges analogue). NULL
    order rows take their peer group as the frame (Spark: nulls are peers,
    incomparable to numeric offsets). The JAX package's
    ``_range_frame_bounds``."""
    lo_delta = 0 if frame.lower == CURRENT_ROW else frame.lower
    hi_delta = 0 if frame.upper == CURRENT_ROW else frame.upper
    if frame.lower == UNBOUNDED_PRECEDING:
        lo = seg_first
    else:
        lo = bsearch_first(sval, seg_first, seg_last, sval + lo_delta, cap, strict=False)
        lo = torch.where(ovalid, lo, peer_first)
    if frame.upper == UNBOUNDED_FOLLOWING:
        hi = seg_last
    else:
        # last j with sval[j] <= target  ⇔  (first j with sval[j] > target) - 1
        first_gt = bsearch_first(sval, seg_first, seg_last, sval + hi_delta, cap, strict=True)
        hi = torch.where(ovalid, first_gt - 1, peer_last)
    return lo, hi


def _agg_input(fn) -> Expression:
    if isinstance(fn, Sum):
        return fn.update_exprs[0]  # cast to the result type (wrapping long sums)
    if isinstance(fn, (Count, Min, Max, Average)):
        return fn.child
    raise NotImplementedError(f"window aggregate {type(fn).__name__}")
