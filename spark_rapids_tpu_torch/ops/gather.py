"""Row gather/compaction primitives over DeviceBatch — the analogues of
cudf's gather / Table.filter (reference: basicPhysicalOperators.scala
GpuFilterExec; Table.filter applies a boolean-mask gather).

The port of ``spark_rapids_tpu/ops/gather.py`` (``gather_column``,
``gather_batch``, ``compact``, ``shrink_one``, ``bulk_shrink``) plus the
batch concatenation of ``spark_rapids_tpu/ops/concat.py``. Compaction keeps
the input capacity and permutes kept rows to the front in their order, as
in the JAX package; the permutation is the kept rows' indices followed by
the dropped rows' (what the JAX package's stable argsort of ``~keep``
yields), built by ``scan.first_k_positions`` without a sort or a host sync.
"""
from __future__ import annotations

import torch

from ..columnar.device import DeviceBatch, DeviceColumn, bucket_capacity, dc_replace
from .scan import first_k_positions


def gather_column(col: DeviceColumn, idx: torch.Tensor, idx_valid=None) -> DeviceColumn:
    data = col.data[idx] if col.data is not None else None
    validity = col.validity[idx]
    if idx_valid is not None:
        validity = validity & idx_valid
    lengths = col.lengths[idx] if col.lengths is not None else None
    return DeviceColumn(col.dtype, data, validity, lengths)


def gather_batch(batch: DeviceBatch, idx: torch.Tensor, new_num_rows) -> DeviceBatch:
    cols = [gather_column(c, idx) for c in batch.columns]
    n = torch.as_tensor(new_num_rows, dtype=torch.int32, device=batch.device)
    return DeviceBatch(batch.schema, cols, n)


def compact(batch: DeviceBatch, keep: torch.Tensor) -> DeviceBatch:
    """Stable-compact rows where ``keep`` (bool[cap]) into the prefix."""
    keep = keep & batch.row_mask()
    perm = first_k_positions(keep)
    n = keep.sum().to(torch.int32)
    out = gather_batch(batch, perm, n)
    # zero validity in the tail so padding rows are inert and deterministic
    live = torch.arange(batch.capacity, dtype=torch.int32, device=batch.device) < n
    cols = [dc_replace(c, validity=c.validity & live) for c in out.columns]
    return DeviceBatch(out.schema, cols, n)


def shrink_one(batch: DeviceBatch, n: int) -> DeviceBatch:
    """Re-bucket a batch to the capacity its ``n`` live rows need (no-op when
    already tight): the live prefix, as the JAX package's ``shrink_one``
    with ``tight=True`` (the port's capacities have no shape-bucket floor)."""
    cap2 = bucket_capacity(max(n, 1))
    if cap2 >= batch.capacity:
        return batch
    cols = [
        DeviceColumn(
            c.dtype,
            c.data[:cap2],
            c.validity[:cap2],
            None if c.lengths is None else c.lengths[:cap2],
        )
        for c in batch.columns
    ]
    return DeviceBatch(batch.schema, cols, batch.num_rows)


def row_counts(batches: list) -> list:
    """The live-row counts of device batches in ONE fetch: the work feeding
    every batch is already queued, so the wait overlaps all of it instead
    of serializing per batch."""
    return [int(n) for n in torch.stack([b.num_rows for b in batches]).tolist()]


def bulk_shrink(batches: list) -> tuple:
    """Re-bucket batches whose live prefix is much smaller than capacity
    (partial-aggregate outputs) after one row-count fetch. Returns the
    batches and their counts, so a concat that follows need not fetch
    them again."""
    if not batches:
        return batches, []
    counts = row_counts(batches)
    return [shrink_one(b, n) for b, n in zip(batches, counts)], counts


def concat_device(batches: list, counts=None) -> DeviceBatch:
    """Concatenate the live rows of device batches into one batch of the
    bucketed capacity; string planes widen to the widest input. ``counts``
    (the batches' live rows, if the caller has them) saves the one fetch."""
    if len(batches) == 1:
        return batches[0]
    if counts is None:
        counts = row_counts(batches)
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
