"""Device batch concatenation — the Table.concatenate analogue used by the
aggregate merge loop, sort, and shuffle coalesce (reference:
GpuCoalesceBatches.scala:133-455, aggregate.scala:451).

The port of ``spark_rapids_tpu/ops/concat.py``. With no counts from the
caller, the output capacity is the bucketed sum of input capacities, and
live rows from each input are packed at offsets carried as device scalars,
by row scatters in input order — no host sync. A caller that already holds
the inputs' live-row counts (``bulk_shrink``'s callers) passes them, and
the output is bucketed to the live rows instead. String planes widen to the
widest input; nested columns concatenate plane by plane along the row
axis, each element plane widened to the widest input's.
"""
from __future__ import annotations

import torch

from ..columnar.device import DeviceBatch, DeviceColumn, bucket_capacity


def _pad_width(data: torch.Tensor, width: int) -> torch.Tensor:
    if data.ndim == 2 and data.shape[1] < width:
        return torch.nn.functional.pad(data, (0, width - data.shape[1]))
    return data


def _plane_shape(planes: list) -> tuple:
    """The widest trailing shape (string width, element-plane width) of one
    leaf plane across the inputs."""
    return tuple(max(p.shape[ax] for p in planes) for ax in range(1, planes[0].ndim))


def _pad_axes(data: torch.Tensor, trail: tuple) -> torch.Tensor:
    """Zero-pad the trailing axes of ``data`` up to ``trail``."""
    pads = []
    for have, want in reversed(list(zip(data.shape[1:], trail))):
        pads += [0, want - have]
    if any(pads):
        return torch.nn.functional.pad(data, pads)
    return data


def _scatter_plane(planes: list, lives: list, rows: list, cap: int) -> torch.Tensor:
    """One leaf plane (data/validity/lengths) of the output: each input's
    rows written at its offset, dead rows zeroed; rows past ``cap`` land in
    a dropped extra row (the JAX package's ``mode="drop"``). Later inputs
    overwrite the dead tail of earlier ones, as the JAX scatters in order."""
    trail = _plane_shape(planes)
    dst = torch.zeros((cap + 1,) + trail, dtype=planes[0].dtype, device=planes[0].device)
    for p, live, idx in zip(planes, lives, rows):
        p = _pad_axes(p, trail)
        mask = live.reshape((-1,) + (1,) * (p.ndim - 1))
        dst[idx] = torch.where(mask, p, torch.zeros((), dtype=p.dtype, device=p.device))
    return dst[:cap]


def _scatter_column(parts: list, lives: list, rows: list, cap: int) -> DeviceColumn:
    """One column of the output, its children's planes included (the JAX
    package's ``_concat_col``)."""
    first = parts[0]

    def plane(name):
        if getattr(first, name) is None:
            return None
        return _scatter_plane([getattr(p, name) for p in parts], lives, rows, cap)

    kids = None
    if first.children is not None:
        kids = tuple(
            _scatter_column([p.children[k] for p in parts], lives, rows, cap)
            for k in range(len(first.children))
        )
    return DeviceColumn(first.dtype, plane("data"), plane("validity"), plane("lengths"), kids)


def _counted_plane(planes: list, counts: list, cap: int) -> torch.Tensor:
    trail = _plane_shape(planes)
    dst = torch.zeros((cap,) + trail, dtype=planes[0].dtype, device=planes[0].device)
    off = 0
    for p, k in zip(planes, counts):
        dst[(slice(off, off + k),) + tuple(slice(0, d) for d in p.shape[1:])] = p[:k]
        off += k
    return dst


def _counted_column(parts: list, counts: list, cap: int) -> DeviceColumn:
    first = parts[0]

    def plane(name):
        if getattr(first, name) is None:
            return None
        return _counted_plane([getattr(p, name) for p in parts], counts, cap)

    kids = None
    if first.children is not None:
        kids = tuple(
            _counted_column([p.children[k] for p in parts], counts, cap)
            for k in range(len(first.children))
        )
    return DeviceColumn(first.dtype, plane("data"), plane("validity"), plane("lengths"), kids)


def _concat_counted(batches: list, counts: list) -> DeviceBatch:
    """Concat with the live-row counts known on the host: slices of the live
    prefixes, into a capacity bucketed to their total."""
    total = sum(counts)
    cap = bucket_capacity(max(total, 1))
    device = batches[0].device
    cols = [
        _counted_column([b.columns[i] for b in batches], counts, cap)
        for i in range(len(batches[0].schema))
    ]
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
    cols = [
        _scatter_column([b.columns[i] for b in batches], lives, rows, cap)
        for i in range(len(batches[0].schema))
    ]
    return DeviceBatch(batches[0].schema, cols, off.to(torch.int32))
