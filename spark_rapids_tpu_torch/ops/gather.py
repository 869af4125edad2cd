"""Row gather/compaction primitives over DeviceBatch — the analogues of
cudf's gather / Table.filter (reference: basicPhysicalOperators.scala
GpuFilterExec; Table.filter applies a boolean-mask gather).

The port of ``spark_rapids_tpu/ops/gather.py`` (``gather_column``,
``gather_batch``, ``compact``, ``shrink_one``, ``bulk_shrink``,
``partition_slices``) and of ``slice_head`` (``spark_rapids_tpu/exec/tpu.py``,
shared by the limit and, later, top-N). Compaction keeps
the input capacity and permutes kept rows to the front in their order, as
in the JAX package; the permutation is the kept rows' indices followed by
the dropped rows' (what the JAX package's stable argsort of ``~keep``
yields), built by ``scan.first_k_positions`` without a sort or a host sync.
"""
from __future__ import annotations

import torch

from ..columnar.device import DeviceBatch, DeviceColumn, bucket_capacity, dc_replace, map_planes
from .scan import first_k_positions


def gather_column(col: DeviceColumn, idx: torch.Tensor, idx_valid=None) -> DeviceColumn:
    data = col.data[idx] if col.data is not None else None
    validity = col.validity[idx]
    if idx_valid is not None:
        validity = validity & idx_valid
    lengths = col.lengths[idx] if col.lengths is not None else None
    children = None
    if col.children is not None:  # nested planes share the row axis
        children = tuple(gather_column(c, idx) for c in col.children)
    return DeviceColumn(col.dtype, data, validity, lengths, children)


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
    cols = [map_planes(c, lambda t: t[:cap2]) for c in batch.columns]
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


def partition_slices(batch: DeviceBatch, pids: torch.Tensor, nparts: int, live=None) -> list:
    """Slice a batch into per-partition batches with ONE stable sort by
    partition id instead of ``nparts`` compaction sorts (the exchange's
    hot path; a fused filter predicate rides in as ``live``). Sorted rows
    for partition p occupy [bounds[p], bounds[p+1]); each slice gathers
    its shifted window at full capacity, as the JAX package does. Bounds
    and counts stay on the device: no host sync."""
    cap = batch.capacity
    device = batch.device
    live = batch.row_mask() if live is None else live & batch.row_mask()
    key = torch.where(live, pids.to(torch.int32), nparts)
    order = torch.sort(key, stable=True).indices
    bounds = torch.searchsorted(
        key[order], torch.arange(nparts + 1, dtype=torch.int32, device=device)
    ).to(torch.int32)
    iota = torch.arange(cap, dtype=torch.int64, device=device)
    outs = []
    for p in range(nparts):
        start = bounds[p]
        cnt = bounds[p + 1] - start
        # compose through the int64 permutation: ONE wide gather per slice
        # straight from the input, no intermediate sorted copy
        row_idx = order[torch.clamp(start + iota, 0, cap - 1)]
        sb = gather_batch(batch, row_idx, cnt)
        live_p = iota < cnt
        cols = [dc_replace(c, validity=c.validity & live_p) for c in sb.columns]
        outs.append(DeviceBatch(sb.schema, cols, cnt))
    return outs


def slice_head(batch: DeviceBatch, take: int) -> DeviceBatch:
    """First min(num_rows, take) rows (the JAX package's ``_slice_head_impl``):
    the tail's validity cleared, the count a device scalar."""
    take = torch.clamp(batch.num_rows, max=take).to(torch.int32)
    live = torch.arange(batch.capacity, dtype=torch.int32, device=batch.device) < take
    cols = [dc_replace(c, validity=c.validity & live) for c in batch.columns]
    return DeviceBatch(batch.schema, cols, take)
