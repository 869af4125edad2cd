"""Ungrouped aggregation on the device — the port of
``spark_rapids_tpu/ops/aggregate.py::_ungrouped_aggregate``.

No keys: one output group; plain masked whole-array reductions, for the
sum, count, min/max and first/last families (update and merge ops alike).
Grouped aggregation (the radix sort and segmented scans of the JAX module)
comes with a later slice of the port; the overrides keep it on the CPU
engine.

Spark semantics, as in the JAX package: sums wrap for longs; min/max and
first/last are NULL on all-null input; float min/max treat NaN as the
greatest value. Float sums are one ``torch.sum`` over the masked column — a
fixed-order reduction, never an atomic scatter — so a run's result does not
depend on scheduling. The one output row sits at row 0 of a column of
``out_cap`` rows (the JAX package keeps the input capacity there only for
its static shapes).
"""
from __future__ import annotations

import torch

from ..columnar.device import DeviceColumn
from ..types import LONG, StringType

_BIG = 2**31 - 1


def _minmax_fill(op: str, dtype: torch.dtype):
    if dtype.is_floating_point:
        return float("inf") if op == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if op == "min" else info.min


def ungrouped_aggregate(agg_columns, ops, live: torch.Tensor, out_cap: int):
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
                out[0] = scalar
            else:
                out = torch.zeros(out_cap, dtype=scalar.dtype, device=device)
                out[0] = scalar
            vout = one_live & ok
            lout = None
            if lengths_scalar is not None:
                lout = torch.zeros(out_cap, dtype=torch.int32, device=device)
                lout[0] = lengths_scalar
            return DeviceColumn(out_dtype or col.dtype, out, vout, lout)

        any_valid = valid.any()
        if op == "sum":
            total = torch.where(valid, data, torch.zeros((), dtype=data.dtype, device=device)).sum(
                dtype=data.dtype
            )
            out_aggs.append(place(total, any_valid))
        elif op == "count":
            out_aggs.append(
                place(valid.sum(dtype=torch.int64), torch.ones((), dtype=torch.bool, device=device), out_dtype=LONG)
            )
        elif op in ("min", "max") and not is_str:
            fill = _minmax_fill(op, data.dtype)
            masked = torch.where(valid, data, torch.full((), fill, dtype=data.dtype, device=device))
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
