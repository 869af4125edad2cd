"""Mesh device-plane shuffle: hash-partitioned exchange of whole batches.

The replacement for the reference's UCX data plane (shuffle-plugin
UCX.scala): every member buckets its rows by ``murmur3(keys) % n`` and the
mesh exchange moves all buckets member to member — no serialization, no
host round trip but the one count fetch, no per-block handshakes. Any
DeviceBatch rides it (strings as their padded byte planes, nested columns
as their element planes); the fused partial → exchange → final aggregate
lives in distributed.py.

The port of ``spark_rapids_tpu/parallel/ici.py``, over the port's
single-controller ``parallel/mesh.py::mesh_exchange`` in place of a
``shard_map``-ed ``lax.all_to_all``. ``build_ici_exchange`` keeps the JAX
function's fixed capacity: a member that receives more rows than the input
capacity fails loudly, naming the skew. ``ici_exchange`` delivers a skewed
exchange whole in one pass (torch shapes are dynamic, so the JAX function's
capacity escalation over ``max_rounds`` rounds has no counterpart here).
"""
from __future__ import annotations

from typing import Callable, List, Sequence

from ..columnar.device import DeviceBatch
from ..expr.base import Ctx
from ..ops.hash import murmur3_rows, partition_ids
from .mesh import MeshContext, mesh_exchange


def _hash_pids(batch: DeviceBatch, key_indices: Sequence[int], n: int):
    c = Ctx.for_device(batch)
    cols = []
    for ki in key_indices:
        col = batch.columns[ki]
        cols.append((col.dtype, col.data, col.validity, col.lengths))
    return partition_ids(c.xp, murmur3_rows(c.xp, cols, batch.capacity), n)


def _exchange(mc: MeshContext, schema, key_indices, batches, capacity=None):
    pids = [_hash_pids(b, key_indices, mc.n) for b in batches]
    return mesh_exchange(mc, schema, batches, pids, capacity=capacity)


def build_ici_exchange(mc: MeshContext, schema, key_indices: Sequence[int]) -> Callable:
    """A hash exchange of n per-member batches → n re-partitioned batches,
    each on its member, at a fixed receive capacity (the largest input
    capacity): a member receiving more raises, naming the skew."""

    def fn(batches: List[DeviceBatch]) -> List[DeviceBatch]:
        try:
            cap = max(max(b.capacity for b in batches), 1)
            return _exchange(mc, schema, key_indices, batches, capacity=cap)
        except ValueError as e:
            raise ValueError(
                "ICI exchange overflow: a member received more rows than its "
                f"capacity — increase per-member capacity (hash skew): {e}"
            ) from e

    return fn


def ici_exchange(
    mc: MeshContext,
    schema,
    key_indices: Sequence[int],
    batches: List[DeviceBatch],
) -> List[DeviceBatch]:
    """Hash-exchange that survives skew: a member that a hot key sends more
    rows than any input held receives them all, instead of failing the
    query — the reference's windowed multi-round sends never drop data
    either (BufferSendState.scala, WindowedBlockIterator.scala)."""
    return _exchange(mc, schema, key_indices, batches)
