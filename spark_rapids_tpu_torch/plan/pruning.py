"""Logical column pruning — Catalyst's ColumnPruning analogue.

The reference receives plans that Spark has already pruned (scans carry
pushed-down schemas — GpuParquetScan reads only requested columns); running
standalone, this pass provides that: projections and aggregates propagate
the set of referenced column names down to the scan, which then neither
decodes nor uploads unused columns. On TPU this matters doubly — every
pruned column saves host decode, H2D transfer bytes, and padded-string
packing work.

Pruning is deliberately conservative: only node types whose column flow is
fully modeled participate; anything else (joins, expands, windows…) resets
the requirement to "all columns" beneath it.

Copied from ``spark_rapids_tpu/plan/pruning.py``; unlike the JAX package, a
projection also drops the outputs that nothing above it reads. In the port a pruned
``LocalRelation`` selects its ``HostBatch``'s columns without copying them
(``HostBatch.select``) and keeps the original batch as ``source``, which the
session's upload cache keys on.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Set

from ..expr import Expression, UnresolvedAttribute, output_name
from ..types import Schema
from . import logical as L


def _expr_names(e: Expression, out: Set[str]) -> None:
    if isinstance(e, UnresolvedAttribute):
        out.add(e.name)
    for c in e.children():
        _expr_names(c, out)


def _names_of(exprs) -> Set[str]:
    out: Set[str] = set()
    for e in exprs:
        _expr_names(e, out)
    return out


def prune_columns(plan: L.LogicalPlan, required: Optional[Set[str]] = None):
    """Rewrite ``plan`` so scans materialize only referenced columns.
    ``required=None`` means every column of the subtree's output is needed
    (the top of the query, or beneath an unmodeled node)."""
    if isinstance(plan, (L.LocalRelation, L.FileScan)):
        if required is None:
            return plan
        names = [n for n in plan.schema.names if n in required]
        if not names or len(names) == len(plan.schema.names):
            return plan
        sub = Schema([plan.schema[n] for n in names])
        if isinstance(plan, L.LocalRelation):
            return L.LocalRelation(
                plan.table.select(names),
                sub,
                plan.num_partitions,
                source=plan.source if plan.source is not None else plan.table,
            )
        return L.FileScan(plan.paths, plan.file_format, sub, dict(plan.options))
    if isinstance(plan, L.Project):
        exprs = plan.exprs
        if required is not None:
            # outputs no parent reads go too (Catalyst's ColumnPruning; the
            # JAX package keeps them): a renaming projection over a whole
            # table, as the SQL compiler makes for a self-joined dimension,
            # would otherwise carry every column through each join above
            kept = [e for e in exprs if output_name(e) in required]
            exprs = kept or exprs[:1]
        child = prune_columns(plan.child, _names_of(exprs))
        return dataclasses.replace(plan, exprs=list(exprs), child=child)
    if isinstance(plan, L.Aggregate):
        child = prune_columns(
            plan.child, _names_of(plan.grouping) | _names_of(plan.aggregates)
        )
        return dataclasses.replace(plan, child=child)
    if isinstance(plan, L.Filter):
        req = None
        if required is not None:
            req = set(required)
            _expr_names(plan.condition, req)
        return dataclasses.replace(plan, child=prune_columns(plan.child, req))
    if isinstance(plan, L.Sort):
        req = None
        if required is not None:
            req = set(required) | _names_of(o.child for o in plan.order)
        return dataclasses.replace(plan, child=prune_columns(plan.child, req))
    if isinstance(plan, L.Limit):
        return dataclasses.replace(plan, child=prune_columns(plan.child, required))
    if isinstance(plan, L.Join):
        # split the requirement by side; keys and residual inputs are
        # always needed. A name on both sides goes to both (superset is
        # safe). Joins were previously unmodeled, which left e.g. TPC-H q3
        # dragging all 8 lineitem columns through filter + exchange + join
        # when 4 are referenced — every gather/upload pays per column.
        need = None
        if required is not None:
            need = (
                set(required)
                | _names_of(plan.left_keys)
                | _names_of(plan.right_keys)
            )
            if plan.residual is not None:
                _expr_names(plan.residual, need)
        lreq = None if need is None else need & set(plan.left.schema.names)
        rreq = None if need is None else need & set(plan.right.schema.names)
        return dataclasses.replace(
            plan,
            left=prune_columns(plan.left, lreq),
            right=prune_columns(plan.right, rreq),
        )
    if isinstance(plan, L.Window):
        # output = child columns ++ window columns: the child must provide
        # the required pass-through names plus every spec/function input.
        # Window exprs are BOUND at select time (_extract_windows), so (a)
        # collect their inputs by ordinal→name, and (b) after pruning, remap
        # surviving BoundReference ordinals — dropping ANY earlier child
        # column shifts them (this broke `select few_cols, rank() over
        # (partition by unprojected_col ...)`).
        old_names = list(plan.child.schema.names)

        def _win_exprs(we):
            yield we
            for p in we.spec.partition_by:
                yield p
            for o in we.spec.order_by:
                yield o.child

        def _bound_names(e: Expression, out: Set[str]) -> None:
            from ..expr.base import BoundReference

            if isinstance(e, BoundReference):
                out.add(old_names[e.ordinal])
            for c in e.children():
                _bound_names(c, out)

        if required is None:
            req = None
        else:
            win_names = {name for name, _ in plan.window_cols}
            req = set(required) - win_names
            for _, we in plan.window_cols:
                for e in _win_exprs(we):
                    _expr_names(e, req)
                    _bound_names(e, req)
        child = prune_columns(plan.child, req)
        new_names = list(child.schema.names)
        if new_names != old_names:
            from ..expr.base import BoundReference, map_child_exprs
            from ..expr.windows import WindowExpression, WindowOrder, WindowSpec

            index = {n: i for i, n in enumerate(new_names)}

            def remap(e: Expression) -> Expression:
                if isinstance(e, BoundReference):
                    return dataclasses.replace(
                        e, ordinal=index[old_names[e.ordinal]]
                    )
                if not e.children():
                    return e
                return map_child_exprs(e, remap)

            new_cols = []
            for name, we in plan.window_cols:
                spec = WindowSpec(
                    tuple(remap(p) for p in we.spec.partition_by),
                    tuple(
                        WindowOrder(remap(o.child), o.ascending, o.nulls_first)
                        for o in we.spec.order_by
                    ),
                    we.spec.frame,
                )
                new_cols.append((name, WindowExpression(remap(we.function), spec)))
            return dataclasses.replace(plan, window_cols=new_cols, child=child)
        return dataclasses.replace(plan, child=child)
    # unmodeled node: recurse with "all columns" required beneath it
    kids = list(plan.children())
    if not kids:
        return plan
    fields = {}
    for f in dataclasses.fields(plan):
        v = getattr(plan, f.name)
        if isinstance(v, L.LogicalPlan):
            fields[f.name] = prune_columns(v, None)
        elif isinstance(v, list) and v and isinstance(v[0], L.LogicalPlan):
            fields[f.name] = [prune_columns(c, None) for c in v]
    return dataclasses.replace(plan, **fields) if fields else plan
