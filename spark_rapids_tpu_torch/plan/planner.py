"""Logical → CPU physical planning.

Produces the "Spark plan" that the override pass (overrides.py) then rewrites
onto the device — mirroring how the reference receives Catalyst physical
plans. Aggregations are split into partial → hash exchange → final exactly
like Spark's physical aggregation strategy (which the reference inherits).

Copied from ``spark_rapids_tpu/plan/planner.py``, cut to the logical nodes
the port's DataFrame builds: local relations, project, filter, aggregate
(with the DISTINCT rewrites: stacked aggregates for one DISTINCT column
set, an Expand under them for several), sort, limit, union, repartition, joins
(shuffled and broadcast hash joins with the JAX package's build-side
choice, nested-loop and cartesian joins) and windows (a hash exchange on
the partition keys, or a coalesce, under each window node), range,
generate (explode), the four pandas nodes (map, grouped map, cogrouped
map and grouped-aggregate pandas UDFs, with the JAX package's exchanges
under them), file scans (a filter's ``col <op> literal`` conjuncts pushed
into the scan as ``__predicates`` for row-group, partition and bucket
pruning) and file writes. A global sort over several partitions
range-partitions on its keys and sorts each partition, as in the JAX
package. Cached relations are resolved by the session before planning. One
plan shape differs from the JAX package's: an ungrouped aggregate over
several partitions exchanges its partials into one partition
(``SinglePartitioning``) instead of coalescing them.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from .. import config as cfg
from ..config import TpuConf
from ..expr import Alias, Expression, UnresolvedAttribute, bind, output_name
from ..expr.aggregates import AggregateFunction
from ..expr.base import BoundReference
from ..exec.cpu import (
    CpuCoalescePartitionsExec,
    CpuExpandExec,
    CpuFilterExec,
    CpuHashAggregateExec,
    CpuLimitExec,
    CpuProjectExec,
    CpuScanExec,
    CpuShuffleExchangeExec,
    CpuSortExec,
    CpuTakeOrderedAndProjectExec,
    CpuUnionExec,
)
from ..exec.cpu_join import (
    CpuBroadcastExchangeExec,
    CpuBroadcastHashJoinExec,
    CpuCartesianProductExec,
    CpuNestedLoopJoinExec,
    CpuShuffledHashJoinExec,
)
from ..plan import logical as L
from ..plan import partitioning as P
from ..plan.physical import Exec


def plan_physical(lp: L.LogicalPlan, conf: TpuConf) -> Exec:
    if isinstance(lp, L.LocalRelation):
        return CpuScanExec(lp.table, lp.schema, lp.num_partitions, lp.source)
    if isinstance(lp, L.FileScan):
        from ..io.files import CpuFileScanExec

        return CpuFileScanExec(lp.paths, lp.file_format, lp.schema, lp.options, conf)
    if isinstance(lp, L.WriteFiles):
        from ..io.writer import CpuWriteFilesExec

        return CpuWriteFilesExec(plan_physical(lp.child, conf), lp.path, lp.file_format,
                                 lp.partition_by, lp.options)
    if isinstance(lp, L.Range):
        from ..exec.cpu import CpuRangeExec

        return CpuRangeExec(lp.start, lp.end, lp.step, lp.num_partitions)
    if isinstance(lp, L.Generate):
        from ..exec.cpu import CpuGenerateExec

        return CpuGenerateExec(lp.generator, lp.out_names, plan_physical(lp.child, conf))
    if isinstance(lp, (L.MapInPandas, L.FlatMapGroupsInPandas, L.FlatMapCoGroupsInPandas,
                       L.AggregateInPandas)):
        return _plan_pandas(lp, conf)
    if isinstance(lp, L.Project):
        return CpuProjectExec(lp.exprs, plan_physical(lp.child, conf))
    if isinstance(lp, L.Filter):
        child = lp.child
        if isinstance(child, L.FileScan):
            # predicate pushdown: conjuncts of col-vs-literal comparisons go
            # to the scan for row-group + partition-value pruning (reference:
            # GpuParquetFileFilterHandler; the Filter stays — stats pruning
            # is conservative)
            preds = _extract_pushdown(lp.condition)
            if preds:
                opts = dict(child.options)
                opts["__predicates"] = tuple(preds)
                child = dataclasses.replace(child, options=opts)
        return CpuFilterExec(lp.condition, plan_physical(child, conf))
    if isinstance(lp, L.Aggregate):
        return _plan_aggregate(lp, conf)
    if isinstance(lp, L.Sort):
        child = plan_physical(lp.child, conf)
        if lp.is_global and _num_partitions_hint(child) != 1:
            # Distributed total sort: range-partition on the sort keys, then
            # sort each partition locally; partition order == global order
            # (Spark's SortExec + range exchange; GpuRangePartitioning).
            nparts = cfg.SHUFFLE_PARTITIONS.get(conf)
            if nparts > 1:
                child = CpuShuffleExchangeExec(
                    P.RangePartitioning(nparts, lp.order), child
                )
            else:
                child = CpuCoalescePartitionsExec(child)
        return CpuSortExec(lp.order, child)
    if isinstance(lp, L.Limit):
        # Limit over a global Sort plans as TopN (Spark's
        # TakeOrderedAndProject strategy; reference limit.scala)
        if isinstance(lp.child, L.Sort) and lp.child.is_global:
            return CpuTakeOrderedAndProjectExec(
                lp.n, lp.child.order, plan_physical(lp.child.child, conf)
            )
        return CpuLimitExec(lp.n, plan_physical(lp.child, conf))
    if isinstance(lp, L.Union):
        return CpuUnionExec([plan_physical(p, conf) for p in lp.plans])
    if isinstance(lp, L.Repartition):
        child = plan_physical(lp.child, conf)
        if lp.exprs:
            part = P.HashPartitioning(lp.num_partitions, lp.exprs)
        else:
            part = P.RoundRobinPartitioning(lp.num_partitions)
        return CpuShuffleExchangeExec(part, child)
    if isinstance(lp, L.Expand):
        return CpuExpandExec(lp.projections, lp.names, plan_physical(lp.child, conf))
    if isinstance(lp, L.Hint):
        return plan_physical(lp.child, conf)
    if isinstance(lp, L.Join):
        return _plan_join(lp, conf)
    if isinstance(lp, L.Window):
        from ..exec.cpu_window import CpuWindowExec

        child = plan_physical(lp.child, conf)
        spec = lp.window_cols[0][1].spec
        if spec.partition_by:
            child = CpuShuffleExchangeExec(
                P.HashPartitioning(
                    cfg.SHUFFLE_PARTITIONS.get(conf), list(spec.partition_by)
                ),
                child,
            )
        elif _num_partitions_hint(child) != 1:
            child = CpuCoalescePartitionsExec(child)
        return CpuWindowExec(lp.window_cols, child)
    raise NotImplementedError(
        f"no physical plan for {type(lp).__name__} in the torch port yet"
    )


def _extract_pushdown(e: Expression):
    """Conjuncts shaped ``col <op> literal`` → (name, op, value) triples."""
    from ..expr import predicates as prd
    from ..expr.base import Literal

    ops = {
        prd.GreaterThan: ">",
        prd.GreaterThanOrEqual: ">=",
        prd.LessThan: "<",
        prd.LessThanOrEqual: "<=",
        prd.EqualTo: "=",
    }
    flip = {">": "<", ">=": "<=", "<": ">", "<=": ">=", "=": "="}
    out = []

    def walk(x):
        if isinstance(x, prd.And):
            for c in x.children():
                walk(c)
            return
        op = ops.get(type(x))
        if not op:
            return
        l, r = x.children()
        if isinstance(l, UnresolvedAttribute) and isinstance(r, Literal):
            if r.value is not None:
                out.append((l.name, op, r.value))
        elif isinstance(r, UnresolvedAttribute) and isinstance(l, Literal):
            if l.value is not None:
                out.append((r.name, flip[op], l.value))

    walk(e)
    return out


def _plan_pandas(lp: L.LogicalPlan, conf: TpuConf) -> Exec:
    """The pandas nodes (the JAX package's ``plan_physical`` branches):
    whole key groups per partition behind a hash exchange on the grouping
    keys (both sides of a cogroup co-partitioned on the common key type), or
    one partition for a keyless group."""
    from ..exec import cpu_pandas as CP

    if isinstance(lp, L.MapInPandas):
        return CP.CpuMapInPandasExec(lp.fn, lp.schema, plan_physical(lp.child, conf))
    if isinstance(lp, L.FlatMapCoGroupsInPandas):
        left = plan_physical(lp.left, conf)
        right = plan_physical(lp.right, conf)
        if _num_partitions_hint(left) != 1 or _num_partitions_hint(right) != 1:
            # co-partition both sides on their keys with the same arity so
            # matching key groups meet in the same partition pair. Mismatched
            # key dtypes hash differently (murmur3 of int32 5 != int64 5);
            # the PARTITIONING keys are cast to the common type — the frames
            # the user's fn sees keep their own types
            from ..expr.cast import Cast
            from ..types import numeric_promote

            lkeys: list = [UnresolvedAttribute(n) for n in lp.left_keys]
            rkeys: list = [UnresolvedAttribute(n) for n in lp.right_keys]
            for i, (ln, rn) in enumerate(zip(lp.left_keys, lp.right_keys)):
                ta = lp.left.schema[ln].data_type
                tb = lp.right.schema[rn].data_type
                if type(ta) is type(tb):
                    continue
                try:
                    common = numeric_promote(ta, tb)
                except Exception:
                    raise ValueError(
                        f"cogroup keys {ln}:{ta.simple_string} and "
                        f"{rn}:{tb.simple_string} are incompatible"
                    )
                if type(ta) is not type(common):
                    lkeys[i] = Cast(lkeys[i], common)
                if type(tb) is not type(common):
                    rkeys[i] = Cast(rkeys[i], common)
            nparts = cfg.SHUFFLE_PARTITIONS.get(conf)
            left = CpuShuffleExchangeExec(P.HashPartitioning(nparts, lkeys), left)
            right = CpuShuffleExchangeExec(P.HashPartitioning(nparts, rkeys), right)
        return CP.CpuFlatMapCoGroupsInPandasExec(
            lp.left_keys, lp.right_keys, lp.fn, lp.schema, left, right
        )
    child = plan_physical(lp.child, conf)
    if _num_partitions_hint(child) != 1:
        if lp.grouping:
            # whole groups per partition (the reference plans its python
            # exec behind a hash exchange on the grouping keys too)
            child = CpuShuffleExchangeExec(
                P.HashPartitioning(
                    cfg.SHUFFLE_PARTITIONS.get(conf),
                    [UnresolvedAttribute(n) for n in lp.grouping],
                ),
                child,
            )
        else:
            # groupBy().applyInPandas: the whole frame is one group
            child = CpuCoalescePartitionsExec(child)
    if isinstance(lp, L.FlatMapGroupsInPandas):
        return CP.CpuFlatMapGroupsInPandasExec(lp.grouping, lp.fn, lp.schema, child)
    return CP.CpuAggregateInPandasExec(lp.grouping, lp.udfs, lp.schema, child)


def _estimate_size(lp: L.LogicalPlan) -> Optional[int]:
    """Best-effort logical size estimate in bytes (Spark's statistics
    sizeInBytes analogue) used only for broadcast-side selection."""
    if isinstance(lp, L.LocalRelation):
        return lp.table.nbytes
    if isinstance(lp, L.FileScan):
        import os

        try:
            return sum(os.path.getsize(p) for p in lp.paths)
        except OSError:
            return None
    if isinstance(lp, (L.Project, L.Filter, L.Sort, L.Limit, L.Hint, L.Repartition)):
        return _estimate_size(lp.children()[0])
    if isinstance(lp, L.Union):
        sizes = [_estimate_size(p) for p in lp.plans]
        return None if any(s is None for s in sizes) else sum(sizes)
    return None  # aggregates/joins: unknown → never auto-broadcast


def _has_broadcast_hint(lp: L.LogicalPlan) -> bool:
    """Hint detection looking through unary nodes (Spark propagates hints
    up through unary operators)."""
    if isinstance(lp, L.Hint):
        return lp.name == "broadcast" or _has_broadcast_hint(lp.child)
    if isinstance(lp, (L.Project, L.Filter, L.Sort, L.Limit, L.Repartition)):
        return _has_broadcast_hint(lp.children()[0])
    return False


def _num_partitions_hint(e: Exec) -> int:
    from ..exec.cpu import CpuRangeExec
    from ..io.files import CpuFileScanExec

    if isinstance(e, (CpuScanExec, CpuShuffleExchangeExec, CpuRangeExec, CpuFileScanExec)):
        # a file scan's count is before pruning, which only takes files away
        # (the JAX package counts a file scan as one partition whatever its
        # files, and so aggregates a multi-file PERFILE scan per file)
        return e.num_partitions
    if isinstance(e, (CpuCoalescePartitionsExec, CpuLimitExec)):
        return 1
    if isinstance(e, CpuCartesianProductExec):
        # pairwise fan-out: n_left × n_right tasks
        return _num_partitions_hint(e.children[0]) * _num_partitions_hint(
            e.children[1]
        )
    if isinstance(e, CpuUnionExec):
        # union CONCATENATES its children's partitions — reporting only the
        # first child's count made aggregates over a union of
        # single-partition inputs skip their merge exchange and aggregate
        # each branch separately (wrong results)
        return sum(_num_partitions_hint(c) for c in e.children)
    if e.children:
        return _num_partitions_hint(e.children[0])
    return 1


def _extract_aggs(
    e: Expression, agg_fns: List[AggregateFunction]
) -> Expression:
    """Replace AggregateFunction nodes with placeholders indexing agg_fns."""
    if isinstance(e, AggregateFunction):
        try:
            i = agg_fns.index(e)
        except ValueError:
            i = len(agg_fns)
            agg_fns.append(e)
        return _AggResultRef(i, e)
    if not e.children():
        return e
    from ..expr.base import map_child_exprs

    return map_child_exprs(e, lambda c: _extract_aggs(c, agg_fns))


@dataclasses.dataclass(frozen=True)
class _AggResultRef(Expression):
    """Placeholder resolved to a BoundReference over [keys ++ agg results]."""

    index: int
    fn: AggregateFunction

    @property
    def data_type(self):
        return self.fn.data_type

    @property
    def nullable(self):
        return self.fn.nullable


def _finalize_result_expr(e: Expression, num_keys: int, key_exprs) -> Expression:
    """Rewrite grouping-expr occurrences and agg placeholders to bound refs
    over the virtual post-aggregation schema [key0..k, agg0..m]."""
    if isinstance(e, _AggResultRef):
        return BoundReference(num_keys + e.index, e.fn.data_type, e.fn.nullable)
    for i, k in enumerate(key_exprs):
        # grouping exprs may arrive Alias-wrapped (SQL compiler emits
        # Alias(expr, "__g0") keys); the result expr references the BARE
        # expr — match through the alias or the ordinal binds to the CHILD
        # schema and reads the wrong post-aggregation column
        kc = k.child if isinstance(k, Alias) else k
        if e == k or e == kc:
            return BoundReference(i, kc.data_type, kc.nullable)
    if not e.children():
        return e
    from ..expr.base import map_child_exprs

    return map_child_exprs(e, lambda c: _finalize_result_expr(c, num_keys, key_exprs))


def _merge_regular_agg(
    e: AggregateFunction,
    name: str,
    inner_out: List[Expression],
    child: Expression,
    sum_type,
) -> Expression:
    """Split a non-distinct aggregate into an inner partial (appended to
    ``inner_out``) and the outer merge expression returned. ``child`` is
    the expression the partial aggregates over (the original child for the
    one-distinct shape; an Expand-projected column for multi-distinct)."""
    import dataclasses as _dc

    from ..expr import Literal
    from ..expr.aggregates import (
        Average,
        Count,
        First,
        Last,
        Max,
        Min,
        Sum,
        _CentralMoment,
    )
    from ..expr.cast import Cast
    from ..expr.conditional import Coalesce
    from ..expr.arithmetic import Divide
    from ..types import DOUBLE, LONG

    if isinstance(e, (Min, Max, First, Last)):
        inner_out.append(Alias(_dc.replace(e, child=child), name))
        return _dc.replace(e, child=UnresolvedAttribute(name))
    if isinstance(e, Sum):
        # re-summing widens again (decimal p+10): cast back
        inner_out.append(Alias(_dc.replace(e, child=child), name))
        return Cast(Sum(UnresolvedAttribute(name)), sum_type)
    if isinstance(e, Count):
        inner_out.append(Alias(_dc.replace(e, child=child), name))
        return Coalesce((Sum(UnresolvedAttribute(name)), Literal(0, LONG)))
    if isinstance(e, Average):
        sname, cname = name + "s", name + "c"
        inner_out.append(Alias(Sum(Cast(child, DOUBLE)), sname))
        inner_out.append(Alias(Count(child), cname))
        return Divide(
            Sum(UnresolvedAttribute(sname)),
            Cast(Sum(UnresolvedAttribute(cname)), DOUBLE),
        )
    if isinstance(e, _CentralMoment):
        # (count, Σx, Σx²) partials re-sum; the result expression
        # mirrors _CentralMoment.evaluate term for term
        from ..expr.arithmetic import Multiply, Subtract
        from ..expr.conditional import If
        from ..expr.math import Sqrt
        from ..expr.predicates import GreaterThan, LessThan

        cname, sname, ssn = name + "c", name + "s", name + "ss"
        xd = Cast(child, DOUBLE)
        inner_out.append(Alias(Count(child), cname))
        inner_out.append(Alias(Sum(xd), sname))
        inner_out.append(Alias(Sum(Multiply(xd, xd)), ssn))
        nD = Cast(
            Coalesce((Sum(UnresolvedAttribute(cname)), Literal(0, LONG))),
            DOUBLE,
        )
        sS = Sum(UnresolvedAttribute(sname))
        m2 = Subtract(
            Sum(UnresolvedAttribute(ssn)), Multiply(sS, Divide(sS, nD))
        )
        div = Subtract(nD, Literal(1.0, DOUBLE)) if e.sample else nD
        var = If(
            GreaterThan(div, Literal(0.0, DOUBLE)),
            Divide(m2, div),
            Literal(float("nan"), DOUBLE),
        )
        var = If(
            GreaterThan(nD, Literal(0.0, DOUBLE)),
            var,
            Literal(None, DOUBLE),
        )
        var = If(LessThan(var, Literal(0.0, DOUBLE)), Literal(0.0, DOUBLE), var)
        return Sqrt(var) if e.sqrt else var
    from ..expr.aggregates import CollectList, CollectSet, MergeLists, MergeSets

    if isinstance(e, CollectList):
        # partial collect per inner group, merged at the outer aggregate
        # (Spark's Collect merge phase; MergeLists/Sets are CPU-executed)
        inner_out.append(Alias(_dc.replace(e, child=child), name))
        merge_cls = MergeSets if isinstance(e, CollectSet) else MergeLists
        return merge_cls(UnresolvedAttribute(name))
    raise NotImplementedError(
        f"{type(e).__name__} combined with DISTINCT aggregates"
    )


def _rewrite_distinct(lp: L.Aggregate) -> L.Aggregate:
    """Plan DISTINCT aggregates as two stacked aggregations — Spark's
    AggUtils.planAggregateWithOneDistinct shape (reference relies on it:
    distinct arrives at the plugin already rewritten):

        Aggregate(keys, [sum(y), count(DISTINCT x)])
        ⇒ inner:  Aggregate(keys ++ [x], partial non-distinct aggs)
          outer:  Aggregate(keys, re-aggregate partials + agg over x)

    Multiple DISTINCT column sets take the Expand-based rewrite
    (_rewrite_multi_distinct)."""
    import dataclasses as _dc

    from ..expr.base import map_child_exprs

    # the single distinct child
    dchildren = []

    def find(e):
        if isinstance(e, AggregateFunction) and getattr(e, "distinct", False):
            if e.child not in dchildren:
                dchildren.append(e.child)
        for c in e.children():
            find(c)

    for e in lp.aggregates:
        find(e)
    if len(dchildren) > 1:
        return _rewrite_multi_distinct(lp, dchildren)
    first_child = dchildren[0]

    key_names = [f"__k{i}" for i in range(len(lp.grouping))]
    inner_out: List[Expression] = [
        Alias(g, n) for g, n in zip(lp.grouping, key_names)
    ]
    inner_out.append(Alias(first_child, "__dk"))
    nd_count = [0]

    def replace_agg(e: Expression) -> Expression:
        if isinstance(e, AggregateFunction):
            if getattr(e, "distinct", False):
                return _dc.replace(e, child=UnresolvedAttribute("__dk"), distinct=False)
            name = f"__nd{nd_count[0]}"
            nd_count[0] += 1
            sum_type = bind(e, lp.child.schema).data_type
            return _merge_regular_agg(e, name, inner_out, e.child, sum_type)
        if not e.children():
            return e
        return map_child_exprs(e, replace_agg)

    outer_out: List[Expression] = []
    for e in lp.aggregates:
        name = output_name(e)
        target = e.child if isinstance(e, Alias) else e
        mapped = None
        for i, g in enumerate(lp.grouping):
            # grouping items may be Alias-wrapped (SQL compiler) — match
            # through the alias like _finalize_result_expr does
            gc = g.child if isinstance(g, Alias) else g
            if target == g or target == gc:
                mapped = UnresolvedAttribute(key_names[i])
                break
        if mapped is None:
            mapped = replace_agg(target)
        outer_out.append(Alias(mapped, name))

    inner = L.Aggregate(list(lp.grouping) + [first_child], inner_out, lp.child)
    outer_grouping = [UnresolvedAttribute(n) for n in key_names]
    return L.Aggregate(outer_grouping, outer_out, inner)


def _rewrite_multi_distinct(
    lp: L.Aggregate, dchildren: List[Expression]
) -> L.Aggregate:
    """Multiple DISTINCT column sets — Spark's RewriteDistinctAggregates:
    fan each input row out through an Expand, one projection per distinct
    group (gid=i carries only that group's child value) plus a gid=0
    projection carrying the regular aggregates' inputs, then aggregate
    twice:

        inner: group by keys ++ [d1..dm, gid]   (dedupes each distinct set)
        outer: group by keys; distinct agg i over if(gid=i, di, null),
               regular aggs re-aggregate their gid=0 partials

    (Catalyst's RewriteDistinctAggregates rule; the reference receives this
    plan shape from Spark and runs it through GpuExpandExec —
    GpuExpandExec.scala.)"""
    import dataclasses as _dc

    from ..expr import Literal
    from ..expr.base import map_child_exprs
    from ..expr.conditional import If
    from ..expr.predicates import EqualTo
    from ..types import INT

    child_schema = lp.child.schema
    m = len(dchildren)

    # regular (non-distinct) aggregate children, deduped; each becomes an
    # Expand column live only in the gid=0 projection (count(*)'s literal
    # too, so expanded duplicate rows are not double-counted)
    reg_children: List[Expression] = []

    def collect_regular(e):
        if isinstance(e, AggregateFunction) and not getattr(e, "distinct", False):
            if e.child not in reg_children:
                reg_children.append(e.child)
        for c in e.children():
            collect_regular(c)

    for e in lp.aggregates:
        collect_regular(e)

    key_names = [f"__k{i}" for i in range(len(lp.grouping))]
    d_names = [f"__d{i}" for i in range(m)]
    r_names = [f"__r{j}" for j in range(len(reg_children))]
    gid_name = "__gid"
    out_names = key_names + d_names + r_names + [gid_name]

    def null_of(expr):
        return Literal(None, bind(expr, child_schema).data_type)

    projections: List[List[Expression]] = []
    proj0: List[Expression] = [
        Alias(g, n) for g, n in zip(lp.grouping, key_names)
    ]
    proj0 += [Alias(null_of(d), n) for d, n in zip(dchildren, d_names)]
    proj0 += [Alias(c, n) for c, n in zip(reg_children, r_names)]
    proj0.append(Alias(Literal(0, INT), gid_name))
    projections.append(proj0)
    for i, d in enumerate(dchildren):
        proj: List[Expression] = [
            Alias(g, n) for g, n in zip(lp.grouping, key_names)
        ]
        proj += [
            Alias(dj if j == i else null_of(dj), n)
            for j, (dj, n) in enumerate(zip(dchildren, d_names))
        ]
        proj += [Alias(null_of(c), n) for c, n in zip(reg_children, r_names)]
        proj.append(Alias(Literal(i + 1, INT), gid_name))
        projections.append(proj)

    expand = L.Expand(projections, out_names, lp.child)

    inner_grouping = [
        UnresolvedAttribute(n) for n in key_names + d_names + [gid_name]
    ]
    inner_out: List[Expression] = [
        Alias(UnresolvedAttribute(n), n)
        for n in key_names + d_names + [gid_name]
    ]
    nd_count = [0]

    def replace_agg(e: Expression) -> Expression:
        if isinstance(e, AggregateFunction):
            if getattr(e, "distinct", False):
                i = dchildren.index(e.child)
                guarded = If(
                    EqualTo(UnresolvedAttribute(gid_name), Literal(i + 1, INT)),
                    UnresolvedAttribute(d_names[i]),
                    null_of(e.child),
                )
                return _dc.replace(e, child=guarded, distinct=False)
            name = f"__nd{nd_count[0]}"
            nd_count[0] += 1
            sum_type = bind(e, child_schema).data_type
            j = reg_children.index(e.child)
            from ..expr.aggregates import First, Last

            if isinstance(e, (First, Last)):
                # gid!=0 inner groups carry all-null partials (their __r
                # column is the Expand-projected null); a null-blind merge
                # could pick one, so the outer merge must skip null
                # partials — there is exactly one gid=0 partial per key
                inner_out.append(
                    Alias(
                        _dc.replace(e, child=UnresolvedAttribute(r_names[j])),
                        name,
                    )
                )
                return _dc.replace(
                    e, child=UnresolvedAttribute(name), ignore_nulls=True
                )
            return _merge_regular_agg(
                e, name, inner_out, UnresolvedAttribute(r_names[j]), sum_type
            )
        if not e.children():
            return e
        return map_child_exprs(e, replace_agg)

    outer_out: List[Expression] = []
    for e in lp.aggregates:
        name = output_name(e)
        target = e.child if isinstance(e, Alias) else e
        mapped = None
        for i, g in enumerate(lp.grouping):
            # grouping items may be Alias-wrapped (SQL compiler) — match
            # through the alias like _finalize_result_expr does
            gc = g.child if isinstance(g, Alias) else g
            if target == g or target == gc:
                mapped = UnresolvedAttribute(key_names[i])
                break
        if mapped is None:
            mapped = replace_agg(target)
        outer_out.append(Alias(mapped, name))

    inner = L.Aggregate(inner_grouping, inner_out, expand)
    outer_grouping = [UnresolvedAttribute(n) for n in key_names]
    return L.Aggregate(outer_grouping, outer_out, inner)


def _plan_aggregate(lp: L.Aggregate, conf: TpuConf) -> Exec:
    from ..expr.aggregates import contains_distinct

    if any(contains_distinct(e) for e in lp.aggregates):
        lp = _rewrite_distinct(lp)
    child = plan_physical(lp.child, conf)
    child_schema = child.output
    bound_grouping = [bind(g, child_schema) for g in lp.grouping]
    # resolve aggregate list, splitting agg fns from result expressions
    agg_fns: List[AggregateFunction] = []
    result_exprs: List[Expression] = []
    result_names: List[str] = []
    for e in lp.aggregates:
        name = output_name(e)
        inner = e.child if isinstance(e, Alias) else e
        bound = bind(inner, child_schema)
        rewritten = _extract_aggs(bound, agg_fns)
        result_exprs.append(
            _finalize_result_expr(rewritten, len(bound_grouping), bound_grouping)
        )
        result_names.append(name)
    partial_grouping = [
        Alias(g, f"key{i}") for i, g in enumerate(bound_grouping)
    ]
    if _num_partitions_hint(child) == 1:
        # single upstream partition: one complete-mode pass — no partial/
        # exchange/final chain (Spark's partial-merge pair is pure overhead
        # here, and every extra operator costs a device round trip)
        return CpuHashAggregateExec(
            "complete", partial_grouping, agg_fns, result_exprs, result_names, child
        )
    nparts = cfg.SHUFFLE_PARTITIONS.get(conf)
    from ..expr.aggregates import CollectList, MergeLists

    if any(isinstance(f, (CollectList, MergeLists)) for f in agg_fns):
        # collect_list/set has no fixed-width merge buffer: exchange the RAW
        # rows by the grouping keys, then one complete aggregate per
        # partition — result identical to Spark's partial+merge, and the
        # device kernel only ever builds final list planes (the reference's
        # GpuCollectList merges device lists; this engine trades that merge
        # for a row exchange)
        if bound_grouping:
            pre = CpuShuffleExchangeExec(
                P.HashPartitioning(nparts, list(bound_grouping)), child
            )
        else:
            pre = CpuCoalescePartitionsExec(child)
        return CpuHashAggregateExec(
            "complete", partial_grouping, agg_fns, result_exprs, result_names, pre
        )
    partial = CpuHashAggregateExec(
        "partial", partial_grouping, agg_fns, None, None, child
    )
    if bound_grouping:
        exchange = CpuShuffleExchangeExec(
            P.HashPartitioning(
                nparts,
                [UnresolvedAttribute(f"key{i}") for i in range(len(bound_grouping))],
            ),
            partial,
        )
    else:
        # one partition for the final merge. The JAX package coalesces here;
        # the port plans a single-partition exchange, whose device form
        # shrinks each partial (one live row at its input's capacity) with
        # one row-count fetch before the final aggregate concatenates them
        exchange = CpuShuffleExchangeExec(P.SinglePartitioning(1), partial)
    final_grouping = [
        Alias(UnresolvedAttribute(f"key{i}"), f"key{i}")
        for i in range(len(bound_grouping))
    ]
    return CpuHashAggregateExec(
        "final", final_grouping, agg_fns, result_exprs, result_names, exchange
    )


def _coerce_join_keys(lp: L.Join) -> L.Join:
    """Catalyst coerces mismatched equi-join key types at analysis (casts
    the narrower side); without it, hash partitioning and word-encoded
    matchers see different representations of equal values and silently
    drop matches. Integral pairs widen to the wider side; integral/float
    pairs promote to double."""
    if not lp.left_keys:
        return lp
    from ..expr.cast import Cast
    from ..types import DOUBLE, DoubleType, FloatType, IntegralType

    lk, rk = list(lp.left_keys), list(lp.right_keys)
    changed = False
    for i, (a, b) in enumerate(zip(lk, rk)):
        try:
            ta = bind(a, lp.left.schema).data_type
            tb = bind(b, lp.right.schema).data_type
        except Exception:
            continue
        if type(ta) is type(tb):
            continue
        if isinstance(ta, IntegralType) and isinstance(tb, IntegralType):
            wide = ta if ta.np_dtype.itemsize >= tb.np_dtype.itemsize else tb
            if type(ta) is not type(wide):
                lk[i] = Cast(a, wide)
                changed = True
            if type(tb) is not type(wide):
                rk[i] = Cast(b, wide)
                changed = True
            continue
        num = (IntegralType, FloatType, DoubleType)
        if isinstance(ta, num) and isinstance(tb, num):
            if not isinstance(ta, DoubleType):
                lk[i] = Cast(a, DOUBLE)
                changed = True
            if not isinstance(tb, DoubleType):
                rk[i] = Cast(b, DOUBLE)
                changed = True
    if not changed:
        return lp
    return dataclasses.replace(lp, left_keys=lk, right_keys=rk)


def _plan_join(lp: L.Join, conf: TpuConf) -> Exec:
    lp = _coerce_join_keys(lp)
    nparts = cfg.SHUFFLE_PARTITIONS.get(conf)
    if lp.left_keys:
        jt = lp.join_type
        # Build-side selection (hint, or estimated size under the threshold).
        # build-right supports every type: right/full ride the broadcast
        # exec's global build-matched tracking, which emits the
        # unmatched-build tail exactly once across stream partitions.
        # build-left is realized by swapping sides + a column-reordering
        # projection.
        threshold = cfg.AUTO_BROADCAST_THRESHOLD.get(conf)
        l_hint, r_hint = _has_broadcast_hint(lp.left), _has_broadcast_hint(lp.right)

        def fits(sz):
            return threshold >= 0 and sz is not None and sz <= threshold

        bc_right_ok = jt in (
            "inner", "left", "left_semi", "left_anti", "right", "full",
        )
        bc_left_ok = jt in ("inner", "right", "left", "full") and not lp.using
        want_right = bc_right_ok and (r_hint or fits(_estimate_size(lp.right)))
        want_left = bc_left_ok and (l_hint or fits(_estimate_size(lp.left)))
        if want_left and (not want_right or (l_hint and not r_hint)):
            names = lp.schema.names
            if len(set(names)) == len(names):  # unambiguous re-projection
                swapped = L.Join(
                    lp.right,
                    lp.left,
                    {"inner": "inner", "right": "left", "left": "right",
                     "full": "full"}[jt],
                    lp.right_keys,
                    lp.left_keys,
                    lp.residual,
                    False,
                )
                return plan_physical(
                    L.Project([UnresolvedAttribute(n) for n in names], swapped),
                    conf,
                )
        if want_right:
            drop = [output_name(k) for k in lp.right_keys] if lp.using else None
            return CpuBroadcastHashJoinExec(
                jt,
                lp.left_keys,
                lp.right_keys,
                lp.residual,
                plan_physical(lp.left, conf),
                CpuBroadcastExchangeExec(plan_physical(lp.right, conf)),
                drop,
            )
    left = plan_physical(lp.left, conf)
    right = plan_physical(lp.right, conf)
    if lp.left_keys:
        drop = [output_name(k) for k in lp.right_keys] if lp.using else None
        lex = CpuShuffleExchangeExec(P.HashPartitioning(nparts, lp.left_keys), left)
        rex = CpuShuffleExchangeExec(P.HashPartitioning(nparts, lp.right_keys), right)
        return CpuShuffledHashJoinExec(
            lp.join_type, lp.left_keys, lp.right_keys, lp.residual, lex, rex, drop
        )
    if lp.join_type in ("cross", "inner"):
        # pairwise-partition cartesian product (GpuCartesianProductExec:349);
        # outer/semi shapes need global matched-set bookkeeping → NLJ below
        return CpuCartesianProductExec(lp.residual, left, right)
    return CpuNestedLoopJoinExec(
        lp.join_type,
        lp.residual,
        CpuCoalescePartitionsExec(left),
        CpuCoalescePartitionsExec(right),
    )
