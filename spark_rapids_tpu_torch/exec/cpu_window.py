"""CPU window operator — oracle/fallback for the window family.

Reference: GpuWindowExec.scala + GpuWindowExpression.scala. Implemented as a
per-partition python loop over numpy segments — intentionally a *different*
algorithm from the device kernel (segmented scans) so differential tests
cross-check two independent implementations.

Copied from ``spark_rapids_tpu/exec/cpu_window.py``, on numpy ``HostBatch``es
in place of Arrow record batches, the windowed pandas UDF
(``GroupedAggUdf``, WindowInPandas) included.
"""
from __future__ import annotations

import numpy as np

from ..columnar.host import HostBatch, concat_batches, empty_host_batch, host_from_np
from ..expr import Expression, bind
from ..expr.aggregates import Average, Count, Max, Min, Sum
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
from ..plan.logical import SortOrder
from ..plan.physical import Exec, ExecContext, PartitionSet
from ..types import Schema, StringType, StructField
from .cpu import _cpu_ctx, _val_to_np, cpu_sort_indices


class CpuWindowExec(Exec):
    """Appends one column per window expression; all share one spec."""

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

    def execute(self, ctx: ExecContext) -> PartitionSet:
        child = self.children[0]
        schema = child.output

        def fn(it):
            rb = concat_batches(schema, list(it))
            if rb.num_rows == 0:
                yield empty_host_batch(self._schema)
                return
            yield self._compute(rb, schema)

        return child.execute(ctx).map_partitions(fn)

    # ── the window computation over one coalesced partition ────────────
    def _compute(self, rb: HostBatch, schema: Schema) -> HostBatch:
        spec = self.spec
        n = rb.num_rows
        order = [
            SortOrder(bind(o.child, schema), o.ascending, o.nulls_first)
            for o in spec.order_by
        ]
        pkeys = [bind(p, schema) for p in spec.partition_by]
        sort_spec = [SortOrder(p, True, True) for p in pkeys] + order
        perm = (
            cpu_sort_indices(rb, schema, sort_spec)
            if sort_spec
            else np.arange(n, dtype=np.int64)
        )
        srb = rb.take(perm)
        ctx = _cpu_ctx(srb, schema)

        def key_matrix(exprs):
            from ..ops.sortkeys import np_column_radix_words

            cols = []
            for e in exprs:
                d, v = _val_to_np(ctx, e.eval(ctx))
                cols.extend(np_column_radix_words(e.data_type, d, v))
            return cols

        pk_words = key_matrix(pkeys)
        ok_words = key_matrix([o.child for o in order])

        def starts_from(words):
            s = np.zeros(n, dtype=bool)
            s[0] = True
            for w in words:
                s[1:] |= w[1:] != w[:-1]
            return s

        seg_start = starts_from(pk_words) if pk_words else _first_only(n)
        peer_start = seg_start.copy()
        for w in ok_words:
            peer_start[1:] |= w[1:] != w[:-1]
        seg_bounds = np.flatnonzero(seg_start).tolist() + [n]

        out_cols = []
        for name, we in self.window_cols:
            data, valid = self._compute_one(we, ctx, schema, seg_bounds, peer_start, n)
            out_cols.append(host_from_np(data, valid, we.data_type))
        return HostBatch(self._schema, list(srb.columns) + out_cols, n)

    def _compute_one(self, we, ctx, schema, seg_bounds, peer_start, n):
        fn = we.function
        frame = we.spec.resolved_frame()

        def _peer_first0(s, e):
            """0-based rank (index of each row's peer-group first row) —
            shared by Rank and PercentRank."""
            ranks = np.arange(e - s)
            return np.maximum.accumulate(np.where(peer_start[s:e], ranks, 0))

        if isinstance(fn, (RowNumber, Rank, DenseRank)):
            out = np.zeros(n, dtype=np.int32)
            for s, e in zip(seg_bounds[:-1], seg_bounds[1:]):
                if isinstance(fn, RowNumber):
                    out[s:e] = np.arange(1, e - s + 1)
                elif isinstance(fn, Rank):
                    out[s:e] = _peer_first0(s, e) + 1
                else:  # DenseRank
                    out[s:e] = np.cumsum(peer_start[s:e].astype(np.int32))
            return out, np.ones(n, dtype=bool)

        if isinstance(fn, (PercentRank, CumeDist, NTile)):
            is_frac = isinstance(fn, (PercentRank, CumeDist))
            out = np.zeros(n, dtype=np.float64 if is_frac else np.int32)
            for s, e in zip(seg_bounds[:-1], seg_bounds[1:]):
                m = e - s
                if isinstance(fn, PercentRank):
                    out[s:e] = _peer_first0(s, e) / (m - 1) if m > 1 else 0.0
                elif isinstance(fn, CumeDist):
                    # rows <= current peer group == each row's peer-group
                    # LAST index + 1 (next-group-start propagation)
                    ends = np.append(peer_start[s + 1 : e], True)
                    ends_idx = np.nonzero(ends)[0]
                    last = ends_idx[np.searchsorted(ends_idx, np.arange(m))]
                    out[s:e] = (last + 1) / m
                else:  # NTile
                    b = fn.buckets
                    base, rem = divmod(m, b)
                    rn0 = np.arange(m)
                    big = rem * (base + 1)
                    out[s:e] = np.where(
                        rn0 < big,
                        rn0 // max(base + 1, 1),
                        rem + (rn0 - big) // max(base, 1),
                    ) + 1
            return out, np.ones(n, dtype=bool)

        if isinstance(fn, (Lead, Lag)):
            x = bind(fn.child, schema)
            d, v = _val_to_np(ctx, x.eval(ctx))
            dflt = bind(fn.default, schema)
            dd, dv = _val_to_np(ctx, dflt.eval(ctx))
            k = fn.offset if isinstance(fn, Lead) else -fn.offset
            is_str = isinstance(we.data_type, StringType)
            out = np.empty(n, dtype=object if is_str else we.data_type.np_dtype)
            if not is_str:
                out[:] = 0
            out_set = np.broadcast_to(np.asarray(dd, dtype=out.dtype), (n,))
            out[:] = out_set
            ov = np.array(np.broadcast_to(np.asarray(dv).astype(bool), (n,)), copy=True)
            for s, e in zip(seg_bounds[:-1], seg_bounds[1:]):
                idx = np.arange(s, e)
                j = idx + k
                ok = (j >= s) & (j < e)
                out[idx[ok]] = np.asarray(d, dtype=out.dtype)[j[ok]]
                ov[idx[ok]] = v[j[ok]]
            return out, ov

        from ..expr.udf import GroupedAggUdf

        if isinstance(fn, GroupedAggUdf):
            # WindowInPandas: the GROUPED_AGG pandas UDF sees each row's
            # frame as pandas Series (reference GpuWindowInPandasExecBase).
            # Whole-partition frames collapse to one call per segment.
            from ..expr.udf import np_to_series, scalar_from_agg_result

            arg_series = []
            for a in fn.args:
                x = bind(a, schema)
                d_, v_ = _val_to_np(ctx, x.eval(ctx))
                d_ = np.array(np.broadcast_to(np.asarray(d_), (n,)), copy=True)
                m_ = np.array(
                    np.broadcast_to(np.asarray(v_).astype(bool), (n,)), copy=True
                )
                arg_series.append(np_to_series(x.data_type, d_, m_))
            out_dt = fn.return_type
            is_str = isinstance(out_dt, StringType)
            out = np.empty(n, dtype=object) if is_str else np.zeros(n, out_dt.np_dtype)
            ov = np.zeros(n, dtype=bool)
            order_info = None
            sentinels = (UNBOUNDED_PRECEDING, CURRENT_ROW, UNBOUNDED_FOLLOWING)
            if frame.frame_type == "range" and not (
                frame.lower in sentinels and frame.upper in sentinels
            ):
                o = we.spec.order_by[0]
                obound = bind(o.child, schema)
                od, ovv = _val_to_np(ctx, obound.eval(ctx))
                od = np.asarray(od)
                if not np.issubdtype(od.dtype, np.floating):
                    od = od.astype(np.int64)
                frame = frame.scaled_for_decimal(obound.data_type)
                order_info = (
                    od if o.ascending else -od,
                    np.asarray(ovv).astype(bool),
                )
            whole_partition = (
                frame.lower == UNBOUNDED_PRECEDING
                and frame.upper == UNBOUNDED_FOLLOWING
            )

            def call(lo, hi):
                args = [s_.iloc[lo : hi + 1].reset_index(drop=True) for s_ in arg_series]
                return scalar_from_agg_result(out_dt, fn.fn(*args))

            for s, e in zip(seg_bounds[:-1], seg_bounds[1:]):
                if whole_partition:
                    scalar, valid = call(s, e - 1)
                    out[s:e] = scalar
                    ov[s:e] = valid
                else:
                    for i in range(s, e):
                        lo, hi = _frame_bounds(frame, i, s, e, peer_start, order_info)
                        if lo > hi:
                            # empty frame: Spark still calls the UDF (a
                            # count-style UDF returns 0, not NULL)
                            scalar, valid = call(0, -1)
                        else:
                            scalar, valid = call(lo, hi)
                        out[i] = scalar
                        ov[i] = valid
            return out, ov

        # aggregate over frame
        inner = _agg_input(fn)
        x = bind(inner, schema)
        d, v = _val_to_np(ctx, x.eval(ctx))
        d = np.asarray(d)
        v = np.asarray(v).astype(bool)
        is_avg = isinstance(fn, Average)
        out_dt = we.data_type
        if isinstance(out_dt, StringType):
            out = np.empty(n, dtype=object)  # string min/max
        else:
            out = np.zeros(n, dtype=out_dt.np_dtype if not is_avg else np.float64)
        ov = np.zeros(n, dtype=bool)
        order_info = None
        sentinels = (UNBOUNDED_PRECEDING, CURRENT_ROW, UNBOUNDED_FOLLOWING)
        if frame.frame_type == "range" and not (
            frame.lower in sentinels and frame.upper in sentinels
        ):
            o = we.spec.order_by[0]
            obound = bind(o.child, schema)
            od, ovv = _val_to_np(ctx, obound.eval(ctx))
            od = np.asarray(od)
            if not np.issubdtype(od.dtype, np.floating):
                od = od.astype(np.int64)
            frame = frame.scaled_for_decimal(obound.data_type)
            order_info = (
                od if o.ascending else -od,
                np.asarray(ovv).astype(bool),
            )
        for s, e in zip(seg_bounds[:-1], seg_bounds[1:]):
            for i in range(s, e):
                lo, hi = _frame_bounds(frame, i, s, e, peer_start, order_info)
                if lo > hi:
                    vals = np.zeros(0, dtype=d.dtype)
                else:
                    sel = slice(lo, hi + 1)
                    vals = d[sel][v[sel]]
                if isinstance(fn, Count):
                    out[i] = len(vals)
                    ov[i] = True
                elif len(vals) == 0:
                    ov[i] = False
                elif isinstance(fn, Sum):
                    if np.issubdtype(d.dtype, np.integer):
                        out[i] = np.sum(vals.astype(np.int64), dtype=np.int64)
                    else:
                        out[i] = np.sum(vals.astype(np.float64))
                    ov[i] = True
                elif isinstance(fn, (Min, Max)):
                    if np.issubdtype(d.dtype, np.floating):
                        # Spark: NaN greatest
                        if isinstance(fn, Max):
                            out[i] = np.nan if np.isnan(vals).any() else vals.max()
                        else:
                            nn = vals[~np.isnan(vals)]
                            out[i] = nn.min() if len(nn) else np.nan
                    else:
                        out[i] = vals.min() if isinstance(fn, Min) else vals.max()
                    ov[i] = True
                elif is_avg:
                    out[i] = np.sum(vals.astype(np.float64)) / len(vals)
                    ov[i] = True
        return out, ov


def _first_only(n: int) -> np.ndarray:
    s = np.zeros(n, dtype=bool)
    if n:
        s[0] = True
    return s


def _agg_input(fn) -> Expression:
    if isinstance(fn, Sum):
        return fn.update_exprs[0]  # cast to result type (wrapping long sums)
    if isinstance(fn, (Count, Min, Max, Average)):
        return fn.child
    raise NotImplementedError(f"window aggregate {type(fn).__name__}")


def _frame_bounds(frame, i, s, e, peer_start, order_info=None):
    """Inclusive [lo, hi] row bounds of the frame for row i in segment [s, e).
    ``order_info`` = (sign-adjusted values, validity) of the single ORDER BY
    key, required for numeric RANGE bounds; NULL order rows frame over their
    peer group (Spark semantics — incomparable to numeric offsets)."""
    if frame.frame_type == "rows":
        lo = s if frame.lower == UNBOUNDED_PRECEDING else max(s, i + frame.lower)
        hi = e - 1 if frame.upper == UNBOUNDED_FOLLOWING else min(e - 1, i + frame.upper)
        return lo, min(hi, e - 1)

    def peer_lo():
        j = i
        while j > s and not peer_start[j]:
            j -= 1
        return j

    def peer_hi():
        j = i + 1
        while j < e and not peer_start[j]:
            j += 1
        return j - 1

    sentinels = (UNBOUNDED_PRECEDING, CURRENT_ROW, UNBOUNDED_FOLLOWING)
    if frame.lower in sentinels and frame.upper in sentinels:
        lo = s
        hi = e - 1
        if frame.lower == CURRENT_ROW:
            lo = peer_lo()
        if frame.upper == CURRENT_ROW:
            hi = peer_hi()
        return lo, hi
    # numeric RANGE: value-space scan (the device does binary searches —
    # deliberately different algorithm, same semantics)
    sval, ovalid = order_info
    if frame.lower == UNBOUNDED_PRECEDING:
        lo = s
    elif not ovalid[i]:
        lo = peer_lo()
    else:
        delta = 0 if frame.lower == CURRENT_ROW else frame.lower
        target = sval[i] + delta
        lo = e  # empty unless found
        for j in range(s, e):
            if ovalid[j] and sval[j] >= target:
                lo = j
                break
    if frame.upper == UNBOUNDED_FOLLOWING:
        hi = e - 1
    elif not ovalid[i]:
        hi = peer_hi()
    else:
        delta = 0 if frame.upper == CURRENT_ROW else frame.upper
        target = sval[i] + delta
        hi = s - 1
        for j in range(e - 1, s - 1, -1):
            if ovalid[j] and sval[j] <= target:
                hi = j
                break
    return lo, hi
