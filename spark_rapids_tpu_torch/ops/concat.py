"""Device batch concatenation — the Table.concatenate analogue used by the
aggregate merge loop, sort, and shuffle coalesce (reference:
GpuCoalesceBatches.scala:133-455, aggregate.scala:451).

The port of ``spark_rapids_tpu/ops/concat.py``. With no counts from the
caller, the output capacity is the bucketed sum of input capacities, and
live rows from each input are packed at offsets carried as device scalars,
by row scatters in input order — no host sync. A caller that already holds
the inputs' live-row counts (``bulk_shrink``'s callers) passes them, and
the output is bucketed to the live rows instead. String planes widen to the
widest input. Nested columns are not in the port yet.
"""
from __future__ import annotations

import torch

from ..columnar.device import DeviceBatch, DeviceColumn, bucket_capacity


def _pad_width(data: torch.Tensor, width: int) -> torch.Tensor:
    if data.ndim == 2 and data.shape[1] < width:
        return torch.nn.functional.pad(data, (0, width - data.shape[1]))
    return data


def _scatter_plane(planes: list, lives: list, rows: list, cap: int) -> torch.Tensor:
    """One leaf plane (data/validity/lengths) of the output: each input's
    rows written at its offset, dead rows zeroed; rows past ``cap`` land in
    a dropped extra row (the JAX package's ``mode="drop"``). Later inputs
    overwrite the dead tail of earlier ones, as the JAX scatters in order."""
    width = max(p.shape[1] for p in planes) if planes[0].ndim == 2 else None
    shape = (cap + 1,) if width is None else (cap + 1, width)
    dst = torch.zeros(shape, dtype=planes[0].dtype, device=planes[0].device)
    for p, live, idx in zip(planes, lives, rows):
        p = _pad_width(p, width) if width is not None else p
        mask = live if p.ndim == 1 else live[:, None]
        dst[idx] = torch.where(mask, p, torch.zeros((), dtype=p.dtype, device=p.device))
    return dst[:cap]


def _concat_counted(batches: list, counts: list) -> DeviceBatch:
    """Concat with the live-row counts known on the host: slices of the live
    prefixes, into a capacity bucketed to their total."""
    total = sum(counts)
    cap = bucket_capacity(max(total, 1))
    device = batches[0].device
    cols = []
    for i in range(len(batches[0].schema)):
        parts = [b.columns[i] for b in batches]
        first = parts[0]
        validity = torch.zeros(cap, dtype=torch.bool, device=device)
        validity[:total] = torch.cat([p.validity[:k] for p, k in zip(parts, counts)])
        if first.is_string:
            width = max(p.str_width for p in parts)
            data = torch.zeros((cap, width), dtype=torch.uint8, device=device)
            lengths = torch.zeros(cap, dtype=torch.int32, device=device)
            off = 0
            for p, k in zip(parts, counts):
                data[off : off + k, : p.str_width] = p.data[:k]
                lengths[off : off + k] = p.lengths[:k]
                off += k
            cols.append(DeviceColumn(first.dtype, data, validity, lengths))
            continue
        data = torch.zeros(cap, dtype=first.data.dtype, device=device)
        data[:total] = torch.cat([p.data[:k] for p, k in zip(parts, counts)])
        cols.append(DeviceColumn(first.dtype, data, validity))
    n = torch.tensor(total, dtype=torch.int32, device=device)
    return DeviceBatch(batches[0].schema, cols, n)


def concat_device(batches: list, capacity: int = None, counts: list = None) -> DeviceBatch:
    """Concatenate device batches (same schema) into one batch.

    ``capacity`` fixes the output capacity (default: the bucketed sum of the
    input capacities). ``counts``, the inputs' live rows when the caller has
    them, takes the packed path bucketed to their total instead."""
    assert batches, "concat of zero batches"
    if len(batches) == 1 and (capacity is None or batches[0].capacity == capacity):
        return batches[0]
    if counts is not None:
        return _concat_counted(batches, counts)
    device = batches[0].device
    cap = capacity or bucket_capacity(sum(b.capacity for b in batches))
    lives, rows = [], []
    off = torch.zeros((), dtype=torch.int64, device=device)
    for b in batches:
        iota = torch.arange(b.capacity, dtype=torch.int64, device=device)
        lives.append(iota < b.num_rows)
        idx = iota + off
        rows.append(torch.where(idx < cap, idx, cap))
        off = off + b.num_rows
    cols = []
    for i in range(len(batches[0].schema)):
        parts = [b.columns[i] for b in batches]
        first = parts[0]
        data = _scatter_plane([p.data for p in parts], lives, rows, cap)
        validity = _scatter_plane([p.validity for p in parts], lives, rows, cap)
        lengths = (
            _scatter_plane([p.lengths for p in parts], lives, rows, cap)
            if first.lengths is not None
            else None
        )
        cols.append(DeviceColumn(first.dtype, data, validity, lengths))
    return DeviceBatch(batches[0].schema, cols, off.to(torch.int32))
