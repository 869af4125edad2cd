"""Row gather/compaction primitives over DeviceBatch — the analogues of
cudf's gather / Table.filter (reference: basicPhysicalOperators.scala
GpuFilterExec; Table.filter applies a boolean-mask gather).

The port of ``spark_rapids_tpu/ops/gather.py`` (``gather_column``,
``gather_batch``, ``compact``) plus the batch concatenation of
``spark_rapids_tpu/ops/concat.py``. ``shrink_one`` has no counterpart:
``device_to_host`` reads the live prefix directly, so nothing re-buckets a
batch before the download. Compaction keeps the input capacity
and permutes kept rows to the front in their order, as in the JAX package;
the permutation is the kept rows' indices followed by the dropped rows'
(what the JAX package's stable argsort of ``~keep`` yields), built with two
``nonzero`` calls instead of a sort.
"""
from __future__ import annotations

import torch

from ..columnar.device import DeviceBatch, DeviceColumn, bucket_capacity, dc_replace


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


def compact_permutation(keep: torch.Tensor) -> torch.Tensor:
    """Stable compaction permutation: position k holds the row index of the
    k-th kept row, then the dropped rows in order."""
    return torch.cat(
        [torch.nonzero(keep).reshape(-1), torch.nonzero(~keep).reshape(-1)]
    )


def compact(batch: DeviceBatch, keep: torch.Tensor) -> DeviceBatch:
    """Stable-compact rows where ``keep`` (bool[cap]) into the prefix."""
    keep = keep & batch.row_mask()
    perm = compact_permutation(keep)
    n = keep.sum().to(torch.int32)
    out = gather_batch(batch, perm, n)
    # zero validity in the tail so padding rows are inert and deterministic
    live = torch.arange(batch.capacity, dtype=torch.int32, device=batch.device) < n
    cols = [dc_replace(c, validity=c.validity & live) for c in out.columns]
    return DeviceBatch(out.schema, cols, n)


def concat_device(batches: list) -> DeviceBatch:
    """Concatenate the live rows of device batches into one batch of the
    bucketed capacity; string planes widen to the widest input."""
    if len(batches) == 1:
        return batches[0]
    counts = [b.row_count() for b in batches]
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
