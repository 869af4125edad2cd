"""Sort-based group-by aggregation on the device — the port of
``spark_rapids_tpu/ops/aggregate.py`` (``group_aggregate`` and its helpers,
the collect family's ``group_max_size`` and ``_group_collect``, and
``_ungrouped_aggregate``).

Grouped: radix-encode the keys → LSD radix sort → segment boundaries by
adjacent difference → segmented scans over the sorted runs, with the group
outputs gathered at the segment ends through a compaction permutation.
Output capacity equals input capacity, with the live groups in the prefix
and a device-resident group count, so nothing here waits for the device.
No scatter reduces a value: float sums are log-step scans (``ops/scan.py``),
whose order is fixed by the shape.

Ungrouped (no keys): one output group from plain masked reductions; the
output row sits at row 0 of a column of ``out_cap`` rows (the JAX package
keeps the input capacity there only for its static shapes). Float sums are
one ``torch.sum`` — a fixed-order reduction, never an atomic scatter.

Spark semantics, as in the JAX package: NULL keys form a group; float keys
are normalized (-0.0 → 0.0, canonical NaN) as NormalizeFloatingNumbers
does; sums wrap for longs; min/max/first/last are NULL on all-null groups;
float min/max treat NaN as the greatest value, so a min over +inf and NaN is
+inf; count is never null. ``collect_list`` keeps input row order and
``collect_set`` is value-ascending with NaN canonical and -0.0 as 0.0 (both
never null: an all-null or empty group collects an empty array), built as
``[cap, W]`` element planes whose width ``W`` the exec measures first
(``group_max_size``).
"""
from __future__ import annotations

import torch

from ..columnar.device import MIN_CAPACITY, DeviceBatch, DeviceColumn, element_plane
from ..types import LONG, ArrayType, DoubleType, FloatType, StringType
from .gather import gather_column
from .scan import first_k_positions, logstep_scan, seg_end_flags, segscan
from .sortkeys import (
    WORD_MAX,
    WORD_MIN,
    batch_radix_words,
    column_radix_words,
    segment_starts,
    sort_permutation,
)

_BIG = 2**31 - 1


def _normalize_float(col: DeviceColumn, has_nans: bool = True) -> DeviceColumn:
    if isinstance(col.dtype, (FloatType, DoubleType)):
        x = col.data
        x = torch.where(x == 0, torch.zeros_like(x), x)
        if has_nans:  # spark.rapids.sql.hasNans=false skips canonicalization
            x = torch.where(torch.isnan(x), float("nan"), x)
        return DeviceColumn(col.dtype, x, col.validity, col.lengths)
    return col


def _minmax_fill(op: str, dtype: torch.dtype):
    if dtype.is_floating_point:
        return float("inf") if op == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if op == "min" else info.min


def _count_scan(flags: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    return segscan(flags.to(torch.int32), starts, "add")


def _scan_reduce(op: str, data, valid, starts, idx, cap):
    """Per-row inclusive segmented reduction over sorted rows. Returns
    (scan_vals, scan_valid, pick) where values at each segment's END row are
    the segment totals; ``pick`` (per-row running pick index) is set for
    first/last ops."""
    if op == "sum":
        vals = torch.where(valid, data, torch.zeros_like(data))
        return segscan(vals, starts, "add"), _count_scan(valid, starts) > 0, None
    if op == "count":
        out = segscan(valid.to(torch.int64), starts, "add")
        return out, torch.ones(cap, dtype=torch.bool, device=valid.device), None
    if op in ("min", "max"):
        masked = torch.where(valid, data, _minmax_fill(op, data.dtype))
        if data.dtype.is_floating_point:
            # Spark NaN ordering: NaN is the greatest value. +inf sentinel so
            # the scan never propagates NaN; restored by the caller.
            masked = torch.where(torch.isnan(masked), float("inf"), masked)
        out = segscan(masked, starts, op)
        return out, _count_scan(valid, starts) > 0, None
    # first/last family: running pick of a row index per segment
    if op == "first":
        pick = segscan(idx, starts, "min")
    elif op == "last":
        pick = segscan(idx, starts, "max")
    elif op == "first_ignore_nulls":
        pick = segscan(torch.where(valid, idx, _BIG), starts, "min")
    elif op == "last_ignore_nulls":
        pick = segscan(torch.where(valid, idx, -1), starts, "max")
    else:
        raise ValueError(f"unknown reduce op {op}")
    return pick, None, pick


def _had_nan_scan(data, valid, starts):
    """Per-row 'segment saw a valid NaN' flag (Spark: NaN greatest)."""
    return _count_scan(valid & torch.isnan(data), starts) > 0


def _string_base_words(col: DeviceColumn) -> list:
    """Ascending sortable value words of a string column (computed once per
    column even when both min AND max aggregate it)."""
    return column_radix_words(col, ascending=True, nulls_first=True, value_only=True)


def _string_value_words(base_words: list, valid, want_min: bool) -> list:
    """Words for the lex-min scan with invalid rows losing STRICTLY: the
    prepended validity word (valid → least, invalid → greatest) breaks ties
    so a NULL row carrying residual branch bytes can never beat a valid
    empty string. ``want_min=False`` inverts the value words so one lex-MIN
    scan serves both directions."""
    out = [torch.where(valid, WORD_MIN, WORD_MAX)]
    for w in base_words:
        w = w if want_min else ~w
        out.append(torch.where(valid, w, WORD_MAX))
    return out


def _seg_arglexmin(words: list, starts, idx):
    """Per-row running index of the lexicographically smallest word tuple in
    the segment (ties keep the earlier row — stable, like the CPU oracle).
    The (flag, words…, idx) combine is the standard segmented-scan form."""

    def comb(a, b):
        af, bf = a[0], b[0]
        a_ws, b_ws = a[1:-1], b[1:-1]
        lt = torch.zeros(af.shape, dtype=torch.bool, device=af.device)
        eq = torch.ones_like(lt)
        for aw, bw in zip(a_ws, b_ws):
            lt = lt | (eq & (bw < aw))
            eq = eq & (bw == aw)
        take_b = bf | lt  # segment restart at b, or b strictly smaller
        out_ws = tuple(torch.where(take_b, bw, aw) for aw, bw in zip(a_ws, b_ws))
        return (af | bf, *out_ws, torch.where(take_b, b[-1], a[-1]))

    return logstep_scan((starts, *words, idx), comb)[-1]


def _whole_arglexmin(words: list, valid, cap):
    """Index of the lex-smallest valid word tuple over the whole column
    (_BIG when no row is valid)."""
    cand = valid
    for w in words:
        masked = torch.where(cand, w, WORD_MAX)
        cand = cand & (masked == masked.min()) & valid
    idx = torch.arange(cap, dtype=torch.int64, device=valid.device)
    return torch.where(cand, idx, _BIG).min()


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]``: every row gather of the group-by on a tensor goes through
    here or ``gather_column``, so a profiler can time the gathers as one
    phase (``chip_smoke.py``)."""
    return x[idx]


def _mask_data(data, group_live):
    if data.ndim == 2:
        return torch.where(group_live[:, None], data, 0)
    return torch.where(group_live, data, torch.zeros_like(data))


def group_aggregate(
    batch: DeviceBatch,
    key_ordinals: list,
    agg_columns: list,
    ops: list,
    live_mask=None,
    has_nans: bool = True,
    collect_width: int = 0,
) -> tuple:
    """Group ``batch`` rows by key columns; reduce ``agg_columns[i]`` with
    ``ops[i]``. Returns (key cols, agg cols, num_groups) — all [capacity]
    with live groups in the prefix, ``num_groups`` an int32 device scalar.
    ``collect_width`` is the element-plane width of the collect ops.

    ``live_mask`` (bool[cap]) restricts which rows participate — the fused
    pre-filter path: a filter feeding an aggregate contributes a mask here
    instead of compacting its output (saving a full gather of every column).
    Keyless calls go to :func:`ungrouped_aggregate`, whose one output row
    sits in a column of ``MIN_CAPACITY`` rows."""
    device = batch.device
    if not key_ordinals:
        cap = agg_columns[0].capacity  # the key-less work batch has no columns
        live = live_mask
        if live is None:
            live = torch.arange(cap, dtype=torch.int32, device=device) < batch.num_rows
        out_aggs = ungrouped_aggregate(
            agg_columns, ops, live, MIN_CAPACITY, collect_width, has_nans
        )
        return [], out_aggs, torch.ones((), dtype=torch.int32, device=device)
    cap = batch.capacity
    keys = [_normalize_float(batch.columns[i], has_nans) for i in key_ordinals]
    words = batch_radix_words(keys)
    row_mask = batch.row_mask() if live_mask is None else live_mask
    n_live = batch.num_rows if live_mask is None else live_mask.sum().to(torch.int32)
    perm = sort_permutation(words, row_mask)
    idx = torch.arange(cap, dtype=torch.int32, device=device)
    # live rows sort first, so the sorted live mask is a prefix of n_live
    live = idx < n_live
    s_words = [_take(w, perm) for w in words]
    starts = segment_starts(s_words, live)
    num_groups = starts.sum().to(torch.int32)
    group_live = idx < num_groups
    # the first padding row "starts a segment" so the LAST live segment's
    # end lands on row n_live-1, not cap-1
    ends = seg_end_flags(starts | (idx == n_live)) & live

    # group-ordered positions of segment starts/ends
    start_pos = first_k_positions(starts)
    end_pos = first_k_positions(ends)

    # representative keys: the first sorted row of each segment
    out_keys: list = []
    for k in keys:
        gk = gather_column(k, _take(perm, start_pos), group_live)
        out_keys.append(
            DeviceColumn(
                k.dtype,
                _mask_data(gk.data, group_live),
                gk.validity,
                None if gk.lengths is None else torch.where(group_live, gk.lengths, 0),
            )
        )

    out_aggs: list = []
    str_words_cache: dict = {}  # id(col) → ascending base words (min+max share)
    for col, op in zip(agg_columns, ops):
        sc = gather_column(col, perm)
        if op in ("collect_list", "collect_set"):
            out_aggs.append(
                _group_collect(op, col, sc, words, row_mask, n_live, live, starts, end_pos,
                               group_live, collect_width, cap, has_nans)
            )
            continue
        v = sc.validity & live
        is_str = isinstance(col.dtype, StringType)
        if is_str and op in ("min", "max"):
            # string min/max: lexicographic arg-scan over the sortable word
            # encoding, then an index-pick like first/last
            base = str_words_cache.get(id(col))
            if base is None:
                base = str_words_cache[id(col)] = _string_base_words(sc)
            vwords = _string_value_words(base, v, op == "min")
            gpick = _take(_seg_arglexmin(vwords, starts, idx), end_pos)
            ok = _take(_count_scan(v, starts) > 0, end_pos) & group_live
            safe = torch.clamp(gpick, 0, cap - 1).to(torch.int64)
            data = torch.where(ok[:, None], _take(sc.data, safe), 0)
            lengths = torch.where(ok, _take(sc.lengths, safe), 0).to(torch.int32)
            out_aggs.append(DeviceColumn(col.dtype, data, ok, lengths))
            continue
        scan_vals, scan_valid, pick = _scan_reduce(op, sc.data, v, starts, idx, cap)
        if pick is not None:
            # first/last: gather the picked row's value per group
            gpick = _take(scan_vals, end_pos)  # pick at each segment's end
            ok = (gpick != _BIG) & (gpick >= 0) & group_live
            safe = torch.clamp(gpick, 0, cap - 1).to(torch.int64)
            data = _take(sc.data, safe)
            valid_out = _take(sc.validity, safe) & ok
            lengths = _take(sc.lengths, safe) if is_str else None
            out_aggs.append(DeviceColumn(col.dtype, _mask_data(data, ok), valid_out, lengths))
            continue
        # count only reads validity, so string inputs are fine there
        if is_str and op != "count":
            raise ValueError(f"string op {op} requires an index-pick")
        data = _take(scan_vals, end_pos)
        valid_out = _take(scan_valid, end_pos) & group_live
        if op in ("min", "max") and sc.data.dtype.is_floating_point and has_nans:
            had_nan = _take(_had_nan_scan(sc.data, v, starts), end_pos)
            if op == "max":
                data = torch.where(had_nan, float("nan"), data)
            else:
                # min is NaN only when EVERY valid value was NaN — a real
                # +inf minimum alongside a NaN must stay +inf (NaN greatest)
                has_nonnan = _take(_count_scan(v & ~torch.isnan(sc.data), starts) > 0, end_pos)
                data = torch.where(had_nan & ~has_nonnan, float("nan"), data)
        if op == "count":
            valid_out = group_live  # count is never null
        # count's output is a LONG regardless of the input column's type
        out_dtype = LONG if op == "count" else col.dtype
        out_aggs.append(DeviceColumn(out_dtype, _mask_data(data, group_live), valid_out, None))
    return out_keys, out_aggs, num_groups


def group_max_size(batch: DeviceBatch, key_ordinals: list, live_mask=None,
                   has_nans: bool = True) -> torch.Tensor:
    """Largest group's row count, an int32 device scalar — the collect
    family's width pre-pass (an upper bound on any collect plane width)."""
    cap = batch.capacity
    device = batch.device
    keys = [_normalize_float(batch.columns[i], has_nans) for i in key_ordinals]
    row_mask = batch.row_mask() if live_mask is None else live_mask
    n_live = batch.num_rows if live_mask is None else live_mask.sum().to(torch.int32)
    if not keys:
        return n_live.to(torch.int32)
    words = batch_radix_words(keys)
    perm = sort_permutation(words, row_mask)
    live = torch.arange(cap, dtype=torch.int32, device=device) < n_live
    starts = segment_starts([_take(w, perm) for w in words], live)
    run = segscan(torch.ones(cap, dtype=torch.int32, device=device), starts, "add")
    return torch.where(live, run, 0).max().to(torch.int32)


def _adjacent_diff(words: list, perm) -> torch.Tensor:
    """bool[cap]: the sorted word tuple differs from the row before."""
    diff = torch.zeros(perm.shape[0], dtype=torch.bool, device=perm.device)
    for w in words:
        sw = _take(w, perm)
        diff = diff | (sw != torch.cat([sw[:1], sw[:-1]]))
    return diff


def _group_collect(op, col, sc, key_words, row_mask, n_live, live, starts, end_pos,
                   group_live, W: int, cap: int, has_nans: bool) -> DeviceColumn:
    """collect_list / collect_set as an array-plane build — the device list
    accumulator (reference GpuCollectList/GpuCollectSet,
    AggregateFunctions.scala:644; the JAX package's ``_group_collect``). No
    scatters: the kept rows compact to the front in (group, order) sequence
    and each group's plane row gathers them through an offset + rank index
    matrix. ``W`` is the bucketed size of the largest group, which the exec
    measures in a prior pass (the one host sync this family needs).

    collect_list keeps input row order (the key sort is stable); collect_set
    re-sorts by value and keeps the first of each run of equal values, so
    its output is value-ascending — deterministic, and mirrored by the CPU
    engine (Spark itself guarantees no order)."""
    device = sc.validity.device
    idx = torch.arange(cap, dtype=torch.int32, device=device)
    if op == "collect_set":
        vcol = _normalize_float(col, has_nans)
        vwords = column_radix_words(vcol, ascending=True, nulls_first=False)
        perm2 = sort_permutation(key_words + vwords, row_mask)
        starts2 = segment_starts([_take(w, perm2) for w in key_words], live)
        use_sc = gather_column(vcol, perm2)
        keep = use_sc.validity & live & (starts2 | _adjacent_diff(vwords, perm2))
        ends2 = seg_end_flags(starts2 | (idx == n_live)) & live
        use_starts, use_end_pos = starts2, first_k_positions(ends2)
    else:
        use_sc, use_starts, use_end_pos = sc, starts, end_pos
        keep = sc.validity & live
    kc = _take(segscan(keep.to(torch.int32), use_starts, "add"), use_end_pos)
    kc = torch.where(group_live, kc, 0).to(torch.int32)
    kept = gather_column(use_sc, first_k_positions(keep))
    offs = torch.cumsum(kc, 0) - kc  # each group's first kept row
    elem = element_plane(kept, offs, kc, max(W, 1))
    return DeviceColumn(ArrayType(col.dtype, contains_null=False), None, group_live, kc, (elem,))


def _ungrouped_collect(op, col, valid, out_cap: int, W: int, has_nans: bool):
    """collect_list / collect_set with no keys: one array in row 0."""
    device = valid.device
    cap = valid.shape[0]
    idx = torch.arange(cap, dtype=torch.int32, device=device)
    if op == "collect_set":
        vcol = _normalize_float(col, has_nans)
        vwords = column_radix_words(vcol, ascending=True, nulls_first=False)
        perm2 = sort_permutation(vwords, valid)
        svals = gather_column(vcol, perm2)
        keep = _take(valid, perm2) & ((idx == 0) | _adjacent_diff(vwords, perm2))
    else:
        perm2 = first_k_positions(valid)
        svals = gather_column(col, perm2)
        keep = _take(valid, perm2)
    kept = gather_column(svals, first_k_positions(keep))
    kcount = keep.sum().to(torch.int32)
    one_live = torch.arange(out_cap, device=device) < 1
    lengths = torch.where(one_live, kcount, 0).to(torch.int32)
    starts = torch.zeros(out_cap, dtype=torch.int64, device=device)
    elem = element_plane(kept, starts, lengths, max(W, 1))
    return DeviceColumn(ArrayType(col.dtype, contains_null=False), None, one_live, lengths,
                        (elem,))


def ungrouped_aggregate(agg_columns, ops, live: torch.Tensor, out_cap: int,
                        collect_width: int = 0, has_nans: bool = True):
    """Reduce each ``(column, op)`` over the rows where ``live`` holds.
    Returns one DeviceColumn of ``out_cap`` rows per op, the result in row 0."""
    device = live.device
    cap = live.shape[0]
    idx = torch.arange(cap, dtype=torch.int32, device=device)
    one_live = torch.arange(out_cap, device=device) < 1
    out_aggs = []
    for col, op in zip(agg_columns, ops):
        data, valid = col.data, col.validity & live
        is_str = isinstance(col.dtype, StringType)

        def place(scalar, ok, lengths_scalar=None, out_dtype=None):
            """Put the scalar into row 0 of an [out_cap] column."""
            if scalar.ndim == 1:  # string bytes [w]
                out = torch.zeros((out_cap, scalar.shape[0]), dtype=scalar.dtype, device=device)
            else:
                out = torch.zeros(out_cap, dtype=scalar.dtype, device=device)
            out[0] = scalar
            lout = None
            if lengths_scalar is not None:
                lout = torch.zeros(out_cap, dtype=torch.int32, device=device)
                lout[0] = lengths_scalar
            return DeviceColumn(out_dtype or col.dtype, out, one_live & ok, lout)

        any_valid = valid.any()
        if op in ("collect_list", "collect_set"):
            out_aggs.append(_ungrouped_collect(op, col, valid, out_cap, collect_width, has_nans))
        elif op == "sum":
            total = torch.where(valid, data, torch.zeros((), dtype=data.dtype, device=device)).sum(
                dtype=data.dtype
            )
            out_aggs.append(place(total, any_valid))
        elif op == "count":
            out_aggs.append(
                place(valid.sum(dtype=torch.int64), torch.ones((), dtype=torch.bool, device=device), out_dtype=LONG)
            )
        elif op in ("min", "max") and is_str:
            vwords = _string_value_words(_string_base_words(col), valid, op == "min")
            pick = _whole_arglexmin(vwords, valid, cap)
            safe = torch.clamp(pick, 0, cap - 1)
            out_aggs.append(
                place(col.data[safe], col.validity[safe] & (pick != _BIG), col.lengths[safe])
            )
        elif op in ("min", "max"):
            masked = torch.where(valid, data, _minmax_fill(op, data.dtype))
            is_float = data.dtype.is_floating_point
            if is_float:
                masked = torch.where(torch.isnan(masked), float("inf"), masked)
            total = masked.min() if op == "min" else masked.max()
            if is_float:
                had_nan = (valid & torch.isnan(data)).any()
                if op == "max":
                    total = torch.where(had_nan, float("nan"), total)
                else:
                    # NaN only when every valid value was NaN (NaN greatest)
                    has_nonnan = (valid & ~torch.isnan(data)).any()
                    total = torch.where(had_nan & ~has_nonnan, float("nan"), total)
            out_aggs.append(place(total, any_valid))
        elif op in ("first", "last", "first_ignore_nulls", "last_ignore_nulls"):
            rows = live if op in ("first", "last") else valid
            if op.startswith("first"):
                pick = torch.where(rows, idx, _BIG).min()
            else:
                pick = torch.where(rows, idx, -1).max()
            ok = (pick != _BIG) & (pick >= 0)
            safe = torch.clamp(pick, 0, cap - 1).to(torch.int64)
            out_aggs.append(
                place(
                    data[safe],
                    col.validity[safe] & ok,
                    None if col.lengths is None else col.lengths[safe],
                )
            )
        else:
            raise NotImplementedError(
                f"ungrouped {op} over {col.dtype.simple_string} is not in the torch port yet"
            )
    return out_aggs
