"""Mesh execution: the engine's shuffle over a single-controller device mesh.

This is what makes planner-built queries run data-parallel over several
devices: ``GpuShuffleExchangeExec`` hands its per-member batches and per-row
partition ids to ``mesh_exchange``, which re-partitions every member's rows
and returns one batch per member, each left on its member's device, so
every downstream per-partition operator (join, aggregate, sort) runs there.

Reference parity: the accelerated shuffle wired INTO query execution
(RapidsShuffleInternalManagerBase.scala:200-396 + GpuShuffleExchangeExec
.scala:78); the UCX tag-matched data plane (shuffle-plugin UCX.scala).
Partition ids are an *input*, so hash, range and round-robin partitionings
all ride the same exchange.

The port of ``spark_rapids_tpu/parallel/mesh.py``. The JAX mesh is
single-controller: one process drives n devices, and the exchange is one
``lax.all_to_all`` inside ``shard_map``. The port keeps that shape — one
process, a ``MeshContext`` of n member devices, no ``torch.distributed``
(NCCL wants one GPU per rank; the card's machine has one H100) — and does
the exchange's three steps with torch ops:

1. **scatter**: each member sorts its rows by destination (a stable sort;
   dead rows and out-of-range ids go last) and counts them per
   destination; every member's counts come to the host in ONE fetch;
2. **move**: each (source, destination) run of rows is gathered on its
   source and moved with ``.to(dst, non_blocking=True)`` — a peer copy
   between two GPUs; a device-local slice when the members share a device
   (one card's members copy within device memory, not over NVLink);
3. **compact**: each member concatenates what it received, in source order.

No capacity escalation: the JAX exchange runs at a static receive
capacity and re-runs the ``all_to_all`` at a larger one when hash skew
overflows a member (up to ``max_rounds`` rounds, then it fails). Torch
shapes are dynamic and the counts are on the host after step 1, so each
member receives exactly its rows at once and nothing is re-run; rows are
never dropped. ``stats["max_received"]`` records the skew instead: the
most rows one member received in one exchange. A caller that wants the
JAX fixed-capacity contract passes ``capacity`` (``ici.build_ici_exchange``
does).
"""
from __future__ import annotations

import threading
import time
from typing import List, Optional, Sequence

import torch

from ..columnar.device import (
    DeviceBatch,
    bucket_capacity,
    empty_batch,
    map_planes,
)
from ..ops.concat import concat_device
from ..ops.gather import gather_column
from ..types import NullType, Schema


class MeshContext:
    """Session-held mesh state: the member devices, reused across queries
    (the DeviceManager analogue for the multi-device case), and the
    exchange counters the session's callers read."""

    def __init__(self, devices: Sequence):
        if not devices:
            raise ValueError("a mesh needs at least one member device")
        self.devices = [torch.device(d) for d in devices]
        self.n = len(self.devices)
        self.lock = threading.Lock()
        #: exchanges run, the most rows one member received in one exchange,
        #: bytes moved between members on different devices / kept on one
        #: device, host wall (ns)
        self.stats = {"exchanges": 0, "max_received": 0, "bytes_moved": 0,
                      "bytes_local": 0, "wall_ns": 0}

    def device_for(self, partition_index: int) -> torch.device:
        return self.devices[partition_index % self.n]

    def reset_stats(self) -> None:
        with self.lock:
            for k in self.stats:
                self.stats[k] = 0


def _leaf_kids(dt) -> list:
    from ..types import ArrayType, MapType, StructType

    if isinstance(dt, StructType):
        return [f.data_type for f in dt.fields]
    if isinstance(dt, ArrayType):
        return [dt.element_type]
    if isinstance(dt, MapType):
        return [dt.key_type, dt.value_type]
    return []


def mesh_supported_schema(schema: Schema) -> bool:
    """Every column whose device layout follows the dtype-derived planes
    rides the mesh exchange, arrays, structs and maps included (their
    element planes share the row axis). A ``NullType`` column does not."""

    def ok(dt) -> bool:
        if isinstance(dt, NullType):
            return False
        return all(ok(k) for k in _leaf_kids(dt))

    return all(ok(f.data_type) for f in schema)


def put_batch(batch: DeviceBatch, device) -> DeviceBatch:
    """``batch`` on ``device`` (itself when it is already there); the copy
    is queued, not waited for."""
    device = torch.device(device)
    if batch.device == device:
        return batch

    def move(t):
        return t.to(device, non_blocking=True)

    return DeviceBatch(
        batch.schema, [map_planes(c, move) for c in batch.columns], move(batch.num_rows)
    )


def _scatter(batch: DeviceBatch, pid: torch.Tensor, n: int):
    """(row order by destination, live rows per destination [n]) of one
    member; pid outside [0, n) or a dead row goes to the dropped slot n."""
    cap = batch.capacity
    pid = pid[:cap].to(torch.int64)
    live = batch.row_mask() & (pid >= 0) & (pid < n)
    key = torch.where(live, pid, n)
    order = torch.sort(key, stable=True).indices
    counts = torch.bincount(key, minlength=n + 1)[:n]
    return order, counts


def _run(batch: DeviceBatch, order: torch.Tensor, start: int, k: int) -> DeviceBatch:
    """Rows ``order[start:start + k]`` of ``batch``, gathered on its device
    into a bucketed capacity (dead tail rows null)."""
    iota = torch.arange(bucket_capacity(k), dtype=torch.int64, device=batch.device)
    idx = order[torch.clamp(start + iota, max=order.shape[0] - 1)]
    live = iota < k
    return DeviceBatch(
        batch.schema,
        [gather_column(c, idx, live) for c in batch.columns],
        torch.tensor(k, dtype=torch.int32, device=batch.device),
    )


def mesh_exchange(
    mc: MeshContext,
    schema: Schema,
    batches: List[DeviceBatch],
    pids: List[torch.Tensor],
    capacity: Optional[int] = None,
) -> List[DeviceBatch]:
    """Re-partition n per-member batches by per-row partition ids (module
    docstring: scatter, move, compact). One host fetch of every member's
    counts per exchange. With ``capacity``, a member that would receive
    more rows raises instead (the JAX exchange's fixed capacity)."""
    assert len(batches) == mc.n and len(pids) == mc.n
    t0 = time.perf_counter_ns()
    n = mc.n
    scattered = [_scatter(b, p, n) for b, p in zip(batches, pids)]
    home = mc.devices[0]
    counts = torch.stack([c.to(home, non_blocking=True) for _o, c in scattered]).cpu().tolist()
    totals = [sum(counts[s][d] for s in range(n)) for d in range(n)]
    if capacity is not None and max(totals) > capacity:
        raise ValueError(
            f"mesh exchange: a member would receive {max(totals)} rows, over its "
            f"capacity {capacity}"
        )
    starts = []
    for s in range(n):
        acc, row = 0, []
        for d in range(n):
            row.append(acc)
            acc += counts[s][d]
        starts.append(row)
    moved = local = 0
    out = []
    for d in range(n):
        dev = mc.devices[d]
        parts, ks = [], []
        for s in range(n):
            k = counts[s][d]
            if not k:
                continue
            src, (order, _c) = batches[s], scattered[s]
            run = _run(src, order, starts[s][d], k)
            nbytes = run.size_bytes()
            if run.device != dev:
                run = put_batch(run, dev)
                moved += nbytes
            else:
                local += nbytes
            parts.append(run)
            ks.append(k)
        if parts:
            out.append(concat_device(parts, counts=ks))
        else:
            out.append(empty_batch(schema, dev))
    with mc.lock:
        st = mc.stats
        st["exchanges"] += 1
        st["max_received"] = max(st["max_received"], max(totals))
        st["bytes_moved"] += moved
        st["bytes_local"] += local
        st["wall_ns"] += time.perf_counter_ns() - t0
    return out

