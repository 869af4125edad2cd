"""Exchange/subplan reuse via plan canonicalization.

Reference: GpuExec.doCanonicalize + Spark's ReuseExchange rule
(GpuExec.scala:251-276): TPC-DS-style plans repeat whole subtrees
(self-joins of an aggregate, CTE fan-out); without reuse every consumer
re-executes the exchange's entire input pipeline.

Design: a post-override pass walks the physical plan bottom-up, builds a
*structural key* for every exchange subtree (class + parameters + child
keys; expressions compare by their frozen-dataclass equality), and replaces
later duplicates with the FIRST instance — physically sharing the Exec
node. The shared exchange memoizes its ``execute()`` PartitionSet per
ExecContext (``GpuShuffleExchangeExec``; a ``GpuBroadcastExchangeExec``
builds its table once per node anyway), so the
partition buckets materialize once regardless of consumer count.

False negatives are safe (duplicate work, correct results), false
positives are not — any parameter this walk cannot prove comparable makes
the subtree non-reusable.

Copied from ``spark_rapids_tpu/plan/reuse.py`` without pyarrow: an
in-memory table is the port's ``HostBatch``, compared by identity, and a
scan's columns are its pruned batch's names. A file scan's key holds its
pruned schema, which the JAX package's key leaves out (its ``_schema`` is
private), so two scans of the same files that read different columns are
not taken for one. The session applies the pass
after whole-stage fusion, as the JAX session does.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from ..columnar.host import HostBatch
from ..expr.base import Expression
from ..types import Schema
from .physical import Exec


class _NotCanonical(Exception):
    pass


# Underscore attributes are derived/private state (compiled kernels, locks,
# caches, schemas recomputed from public params) — never part of identity.
_SKIP_ATTRS = {"metrics"}


def _val_key(v):
    if v is None or isinstance(v, (bool, int, float, str, bytes)):
        return v
    if isinstance(v, Expression):
        return v  # frozen dataclasses: semantic __eq__
    if isinstance(v, (list, tuple)):
        return tuple(_val_key(x) for x in v)
    if isinstance(v, Schema):
        return tuple((f.name, f.data_type, f.nullable) for f in v)
    if isinstance(v, HostBatch):
        return ("table", id(v))  # identity: same in-memory source only
    if isinstance(v, type):
        return v
    if isinstance(v, dict):  # option maps (CpuFileScanExec.options)
        try:
            return ("dict", tuple((k, _val_key(x)) for k, x in sorted(v.items())))
        except TypeError:  # unsortable keys
            raise _NotCanonical("dict") from None
    # dataclass-ish parameter objects (SortOrder, partitionings): compare
    # by type + public attribute dict, recursively
    d = getattr(v, "__dict__", None)
    if d is not None:
        return (
            type(v),
            tuple((k, _val_key(x)) for k, x in sorted(d.items())
                  if not k.startswith("_")),
        )
    slots = getattr(type(v), "__slots__", None)
    if slots is not None:  # slotted value objects (CoalesceGoal)
        return (
            type(v),
            tuple((k, _val_key(getattr(v, k))) for k in slots
                  if not k.startswith("_")),
        )
    raise _NotCanonical(type(v).__name__)


def canonical_key(node: Exec):
    """Structural identity of an Exec subtree; raises _NotCanonical when any
    parameter resists comparison."""
    from ..exec.cpu import CpuScanExec

    if isinstance(node, CpuScanExec):
        # column pruning hands each consumer its own pruned batch; identity
        # lives in the un-pruned source + the projected columns
        return (
            CpuScanExec,
            ("src", id(node.source)),
            tuple(node.table.schema.names),
            node.num_partitions,
        )
    params = tuple(
        (k, _val_key(v))
        for k, v in sorted(vars(node).items())
        if k not in _SKIP_ATTRS and not k.startswith("_")
    )
    if type(node).__name__ == "CpuFileScanExec":
        params += (("output", _val_key(node.output)),)
    return (type(node), params, tuple(canonical_key(c) for c in node.children))


def _keys_equal(a, b) -> bool:
    try:
        return bool(a == b)
    except Exception:  # noqa: BLE001 - array-valued literal etc.
        return False


def reuse_exchanges(plan: Exec) -> Tuple[Exec, int]:
    """Replace duplicate exchange subtrees with the first instance. Returns
    (new plan, number of reused nodes). Spark's spark.sql.exchange.reuse."""
    from ..exec.gpu import GpuShuffleExchangeExec
    from ..exec.gpu_join import GpuBroadcastExchangeExec

    rebuilt: dict = {}  # id(old node) -> new node (ancestors of a dedupe)
    reused = 0
    # One `seen` scope per broadcast-build boundary: a shuffle exchange
    # executes differently inside a broadcast build (whole, in-process)
    # than outside (managed / rank-split), and its memoized PartitionSet
    # captures that decision — sharing one node across the boundary would
    # leak a rank-split set into a broadcast (partial build table) or an
    # unsplit set into a regular consumer (duplicated rows).
    scopes: List[List[Tuple[object, Exec]]] = [[]]

    def walk(node: Exec) -> Exec:
        nonlocal reused
        old = node
        is_bcast = isinstance(node, GpuBroadcastExchangeExec)
        if is_bcast:
            scopes.append([])
        new_children = [walk(c) for c in node.children]
        if is_bcast:
            scopes.pop()
        if any(nc is not oc for nc, oc in zip(new_children, node.children)):
            node = node.with_new_children(new_children)
            rebuilt[id(old)] = node
        if isinstance(node, (GpuShuffleExchangeExec, GpuBroadcastExchangeExec)):
            try:
                k = canonical_key(node)
            except _NotCanonical:
                return node
            seen = scopes[-1]
            for k2, hit in seen:
                if _keys_equal(k, k2):
                    hit._reuse_shared = True
                    # AQE grouping is pairwise between a join's two feeding
                    # exchanges; a node shared by several consumers cannot
                    # follow one join's assignment without desyncing the
                    # other, so the shared node reverts to identity
                    # partitions (its peers fall back the same way).
                    hit._aqe_disabled = True
                    reused += 1
                    return hit
            seen.append((k, node))
        return node

    out = walk(plan)
    if rebuilt:
        # AQE peer links are identity-based (ctx.aqe_size_providers keyed on
        # id); a rebuilt exchange must point at its peer's REBUILT instance
        # or the join's two sides would compute different groupings.
        def relink(node: Exec, visited: set):
            if id(node) in visited:
                return
            visited.add(id(node))
            peer = getattr(node, "_aqe_peer", None)
            if peer is not None and id(peer) in rebuilt:
                node._aqe_peer = rebuilt[id(peer)]
            for c in node.children:
                relink(c, visited)

        relink(out, set())
    return out, reused
