"""Logical plans — the slice of Catalyst the framework provides itself.

The reference plugs into Spark and receives resolved physical plans; running
standalone, this module supplies the minimal logical algebra (resolution +
schema propagation) that feeds the physical planner. Node vocabulary mirrors
Spark's: Project, Filter, Aggregate, Join, Sort, Limit, Union, Expand, etc.

Copied from ``spark_rapids_tpu/plan/logical.py``. The port's planner plans
the subset its DataFrame builds.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

from ..expr import (
    Alias,
    Expression,
    UnresolvedAttribute,
    bind,
    output_name,
)
from ..expr.base import BoundReference
from ..types import BOOLEAN, DataType, LONG, Schema, StructField


class LogicalPlan:
    """Nodes are never mutated once built (rewrites make new nodes with
    ``dataclasses.replace``), so each subclass's ``schema`` is computed
    once per node and kept. Without the memo a ``Project`` binds each of
    its expressions against ``child.schema`` twice, each of those calls
    recomputes the subtree, and the cost doubles with every level: a
    SQL-compiled TPC-DS plan then takes minutes to plan."""

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        prop = cls.__dict__.get("schema")
        if isinstance(prop, property):
            cls.schema = property(_memo_schema(prop.fget))

    def children(self) -> Sequence["LogicalPlan"]:
        return []

    @property
    def schema(self) -> Schema:
        raise NotImplementedError

    def __str__(self):
        return self._tree_string(0)

    def _tree_string(self, indent: int) -> str:
        line = " " * indent + self._node_string()
        return "\n".join([line] + [c._tree_string(indent + 2) for c in self.children()])

    def _node_string(self) -> str:
        return type(self).__name__


def _memo_schema(fget):
    def schema(self) -> Schema:
        memo = self.__dict__.get("_schema_memo")
        if memo is None:
            memo = fget(self)
            self.__dict__["_schema_memo"] = memo
        return memo

    return schema


@dataclass
class LocalRelation(LogicalPlan):
    """In-memory table source (a ``HostBatch`` in the port).

    ``source`` pins the ORIGINAL user batch through column pruning (which
    rebuilds ``table`` via select, a new object every planning pass) so
    the session's device-upload cache can key on a stable identity —
    without it every collect() re-uploads the whole table."""

    table: object  # columnar.host.HostBatch
    _schema: Schema
    num_partitions: int = 1
    source: object = None  # the original HostBatch (identity anchor)

    @property
    def schema(self) -> Schema:
        return self._schema

    def _node_string(self):
        return f"LocalRelation{self._schema.names}"


@dataclass
class FileScan(LogicalPlan):
    """File source (parquet/orc/csv)."""

    paths: list[str]
    file_format: str
    _schema: Schema
    options: dict = field(default_factory=dict)

    @property
    def schema(self) -> Schema:
        return self._schema

    def _node_string(self):
        return f"FileScan {self.file_format} {self.paths[:1]}..."


@dataclass
class Project(LogicalPlan):
    exprs: list[Expression]  # resolved on construction via resolve()
    child: LogicalPlan

    def children(self):
        return [self.child]

    @property
    def schema(self) -> Schema:
        return Schema(
            [
                StructField(output_name(e), _bound(e, self.child.schema).data_type,
                            _bound(e, self.child.schema).nullable)
                for e in self.exprs
            ]
        )

    def _node_string(self):
        return f"Project [{', '.join(map(str, self.exprs))}]"


@dataclass
class Filter(LogicalPlan):
    condition: Expression
    child: LogicalPlan

    def children(self):
        return [self.child]

    @property
    def schema(self) -> Schema:
        return self.child.schema

    def _node_string(self):
        return f"Filter {self.condition}"


@dataclass
class Aggregate(LogicalPlan):
    grouping: list[Expression]
    aggregates: list[Expression]  # mix of grouping refs and AggregateExpression trees
    child: LogicalPlan

    def children(self):
        return [self.child]

    @property
    def schema(self) -> Schema:
        fields = []
        for e in self.aggregates:
            b = _bound(e, self.child.schema)
            fields.append(StructField(output_name(e), b.data_type, b.nullable))
        return Schema(fields)

    def _node_string(self):
        return f"Aggregate [{', '.join(map(str, self.grouping))}] [{', '.join(map(str, self.aggregates))}]"


@dataclass
class Generate(LogicalPlan):
    """explode/posexplode over an array/map column (Spark's Generate;
    reference GpuGenerateExec.scala). Output = child columns ++ generator
    columns (pos?, col | key, value)."""

    generator: Expression  # expr.complex.Explode
    out_names: list  # generator output column names
    child: LogicalPlan

    def children(self):
        return [self.child]

    @property
    def schema(self) -> Schema:
        from ..expr.complex import Explode
        from ..types import MapType, StructType

        g: Explode = _bound(self.generator, self.child.schema)
        ct = g.child.data_type
        fields = list(self.child.schema.fields)
        i = 0
        if g.position:
            from ..types import INT

            fields.append(StructField(self.out_names[i], INT, False))
            i += 1
        if isinstance(ct, MapType):
            fields.append(StructField(self.out_names[i], ct.key_type, False))
            fields.append(StructField(self.out_names[i + 1], ct.value_type, True))
        else:
            fields.append(StructField(self.out_names[i], ct.element_type, True))
        return Schema(fields)

    def _node_string(self):
        return f"Generate {self.generator}"


@dataclass
class SortOrder:
    child: Expression
    ascending: bool = True
    nulls_first: Optional[bool] = None  # Spark default: asc→nulls first, desc→nulls last

    def resolved_nulls_first(self) -> bool:
        if self.nulls_first is None:
            return self.ascending
        return self.nulls_first

    def __str__(self):
        d = "ASC" if self.ascending else "DESC"
        nf = "NULLS FIRST" if self.resolved_nulls_first() else "NULLS LAST"
        return f"{self.child} {d} {nf}"


@dataclass
class Sort(LogicalPlan):
    order: list[SortOrder]
    is_global: bool
    child: LogicalPlan

    def children(self):
        return [self.child]

    @property
    def schema(self) -> Schema:
        return self.child.schema

    def _node_string(self):
        return f"Sort [{', '.join(map(str, self.order))}] global={self.is_global}"


@dataclass
class Limit(LogicalPlan):
    n: int
    child: LogicalPlan

    def children(self):
        return [self.child]

    @property
    def schema(self) -> Schema:
        return self.child.schema

    def _node_string(self):
        return f"Limit {self.n}"


@dataclass
class Join(LogicalPlan):
    left: LogicalPlan
    right: LogicalPlan
    join_type: str  # inner, left, right, full, left_semi, left_anti, cross
    left_keys: list  # exprs over left (empty → cross/conditional join)
    right_keys: list  # exprs over right, same length
    residual: Optional[Expression] = None  # evaluated over joined rows
    using: bool = False  # USING join: right key columns dropped from output

    def children(self):
        return [self.left, self.right]

    @property
    def schema(self) -> Schema:
        lt = list(self.left.schema.fields)
        rt = list(self.right.schema.fields)
        if self.using:
            drop = {output_name(k) for k in self.right_keys}
            rt = [f for f in rt if f.name not in drop]
        if self.join_type in ("left_semi", "left_anti"):
            return Schema(lt)
        if self.join_type in ("left", "full"):
            rt = [dataclasses.replace(f, nullable=True) for f in rt]
        if self.join_type in ("right", "full"):
            lt = [dataclasses.replace(f, nullable=True) for f in lt]
        return Schema(lt + rt)

    def _node_string(self):
        keys = ", ".join(
            f"{l}={r}" for l, r in zip(self.left_keys, self.right_keys)
        )
        return f"Join {self.join_type} [{keys}] {self.residual or ''}"


@dataclass
class Expand(LogicalPlan):
    """Projection fan-out (rollup/cube/grouping sets substrate)."""

    projections: list[list[Expression]]  # all the same arity
    names: list[str]
    child: LogicalPlan

    def children(self):
        return [self.child]

    @property
    def schema(self) -> Schema:
        from ..types import NullType

        cs = self.child.schema
        fields = []
        for i, name in enumerate(self.names):
            es = [_bound(p[i], cs) for p in self.projections]
            dt = next(
                (e.data_type for e in es if not isinstance(e.data_type, NullType)),
                es[0].data_type,
            )
            fields.append(StructField(name, dt, any(e.nullable for e in es)))
        return Schema(fields)

    def _node_string(self):
        return f"Expand x{len(self.projections)}"


@dataclass
class Window(LogicalPlan):
    """Window-function node (Spark's Window logical operator): appends one
    column per window expression to the child's output. All expressions in
    one node share a single (partition_by, order_by) spec."""

    window_cols: list  # [(name, WindowExpression)]
    child: LogicalPlan

    def children(self):
        return [self.child]

    @property
    def schema(self) -> Schema:
        fields = list(self.child.schema.fields)
        for name, we in self.window_cols:
            fields.append(StructField(name, we.data_type, we.nullable))
        return Schema(fields)

    def _node_string(self):
        return f"Window [{', '.join(n for n, _ in self.window_cols)}]"


@dataclass
class Hint(LogicalPlan):
    """Planner hint wrapper (Spark's ResolvedHint; only 'broadcast' for now)."""

    name: str
    child: LogicalPlan

    def children(self):
        return [self.child]

    @property
    def schema(self) -> Schema:
        return self.child.schema

    def _node_string(self):
        return f"Hint({self.name})"


@dataclass
class Union(LogicalPlan):
    plans: list[LogicalPlan]

    def children(self):
        return self.plans

    @property
    def schema(self) -> Schema:
        return self.plans[0].schema

    def _node_string(self):
        return "Union"


@dataclass
class Repartition(LogicalPlan):
    num_partitions: int
    exprs: Optional[list[Expression]]  # None → round robin
    child: LogicalPlan

    def children(self):
        return [self.child]

    @property
    def schema(self) -> Schema:
        return self.child.schema


@dataclass
class Range(LogicalPlan):
    """spark.range() — reference analogue GpuRangeExec."""

    start: int
    end: int
    step: int
    num_partitions: int

    @property
    def schema(self) -> Schema:
        return Schema([StructField("id", LONG, False)])

    def _node_string(self):
        return f"Range({self.start}, {self.end}, {self.step})"


def _bound(e: Expression, schema: Schema) -> Expression:
    """Resolve an expression against a child schema (idempotent)."""
    return bind(e, schema)


@dataclass
class InMemoryRelation(LogicalPlan):
    """df.cache(): the subtree's result is materialized once and served
    from a parquet-compressed in-memory store thereafter (the
    ParquetCachedBatchSerializer analogue — columnar bytes, not rows).
    The session resolves this node before planning."""

    child: LogicalPlan
    cache_key: int
    num_partitions: int = 1

    def children(self):
        return [self.child]

    @property
    def schema(self) -> Schema:
        return self.child.schema

    def _node_string(self):
        return f"InMemoryRelation #{self.cache_key}"


@dataclass
class MapInPandas(LogicalPlan):
    """fn(iter[pd.DataFrame]) → iter[pd.DataFrame] over each partition
    (pyspark mapInPandas; reference GpuMapInPandasExec)."""

    fn: object
    _schema: Schema
    child: LogicalPlan

    def children(self):
        return [self.child]

    @property
    def schema(self) -> Schema:
        return self._schema

    def _node_string(self):
        return f"MapInPandas {getattr(self.fn, '__name__', 'fn')}"


@dataclass
class FlatMapGroupsInPandas(LogicalPlan):
    """group_by(keys).apply_in_pandas(fn): fn(pd.DataFrame) → pd.DataFrame
    per key group (pyspark applyInPandas; reference
    GpuFlatMapGroupsInPandasExec)."""

    grouping: list  # key column names
    fn: object
    _schema: Schema
    child: LogicalPlan

    def children(self):
        return [self.child]

    @property
    def schema(self) -> Schema:
        return self._schema

    def _node_string(self):
        return (
            f"FlatMapGroupsInPandas {self.grouping} "
            f"{getattr(self.fn, '__name__', 'fn')}"
        )


@dataclass
class FlatMapCoGroupsInPandas(LogicalPlan):
    """``df1.groupBy(k).cogroup(df2.groupBy(k)).applyInPandas(fn)``:
    ``fn(left_pd, right_pd) -> pd.DataFrame`` once per key group present on
    EITHER side (pyspark cogroup; reference
    GpuFlatMapCoGroupsInPandasExec)."""

    left_keys: list
    right_keys: list
    fn: object
    _schema: Schema
    left: LogicalPlan
    right: LogicalPlan

    def children(self):
        return [self.left, self.right]

    @property
    def schema(self) -> Schema:
        return self._schema

    def _node_string(self):
        return (
            f"FlatMapCoGroupsInPandas {self.left_keys}/{self.right_keys} "
            f"{getattr(self.fn, '__name__', 'fn')}"
        )


@dataclass
class AggregateInPandas(LogicalPlan):
    """``groupBy(keys).agg(grouped_agg_pandas_udf(...))``: each UDF sees the
    group's Series and returns one scalar (pyspark GROUPED_AGG pandas UDF;
    reference GpuAggregateInPandasExec). ``udfs`` is a list of
    ``(out_name, fn, return_type, arg_names)`` over columns the session
    pre-projected."""

    grouping: list  # key column names
    udfs: list
    _schema: Schema
    child: LogicalPlan

    def children(self):
        return [self.child]

    @property
    def schema(self) -> Schema:
        return self._schema

    def _node_string(self):
        return (
            f"AggregateInPandas {self.grouping} "
            f"[{', '.join(u[0] for u in self.udfs)}]"
        )


@dataclass
class WriteFiles(LogicalPlan):
    """Write command node (GpuDataWritingCommandExec analogue); output is
    the per-file write stats."""

    child: LogicalPlan
    path: str
    file_format: str
    partition_by: list
    options: dict

    def children(self):
        return [self.child]

    @property
    def schema(self) -> Schema:
        from ..io.writer import STATS_SCHEMA

        return STATS_SCHEMA

    def _node_string(self):
        return f"WriteFiles {self.file_format} {self.path}"


def output_round_columns(plan: LogicalPlan):
    """Indices of output columns tainted by a float ``round()``/``bround()``
    — the column either computes one or references a child column that
    does. Scopes the bench/differential float slack to only the columns
    the incompat device round can actually perturb (a device bug in an
    UNROUNDED column must not ride the tolerance). Returns None when the
    taint cannot be tracked (round hidden under a plan shape this walk
    does not model) — callers fall back to applying slack everywhere."""
    flags = _round_flags(plan)
    return None if flags is None else frozenset(
        i for i, f in enumerate(flags) if f
    )


def _round_flags(plan: LogicalPlan):
    from ..expr.base import UnresolvedAttribute
    from ..expr.math import _RoundBase

    def contains_round(e) -> bool:
        if isinstance(e, _RoundBase):
            return True
        return any(contains_round(c) for c in e.children())

    def refs(e, out: set) -> None:
        if isinstance(e, UnresolvedAttribute):
            out.add(e.name.lower())
        for c in e.children():
            refs(c, out)

    if isinstance(plan, (Limit, Sort, Filter)):
        return _round_flags(plan.child)
    if isinstance(plan, (Project, Aggregate)):
        exprs = plan.exprs if isinstance(plan, Project) else plan.aggregates
        child_flags = _round_flags(plan.child)
        if child_flags is None:
            return None
        tainted = {
            n.lower()
            for n, f in zip(plan.child.schema.names, child_flags)
            if f
        }
        out = []
        for e in exprs:
            if contains_round(e):
                out.append(True)
                continue
            names: set = set()
            refs(e, names)
            out.append(bool(names & tainted))
        return out
    # any other node: clean only if NO round appears anywhere below —
    # otherwise the taint path is unmodeled and the caller must stay
    # conservative
    seen = [False]

    def probe(e):
        if contains_round(e):
            seen[0] = True
        return e

    transform_expressions(plan, probe)
    if seen[0]:
        return None
    try:
        width = len(plan.schema.names)
    except Exception:
        return None
    return [False] * width


def transform_expressions(lp: LogicalPlan, f) -> LogicalPlan:
    """Rebuild the plan tree with ``f`` applied bottom-up to every expression
    (the analogue of Catalyst's ``transformAllExpressions``); used by the
    session's ANSI rewrite and the column-pruning pass."""
    import dataclasses as _dc

    from ..expr.base import Expression, map_child_exprs

    def fe(e):
        return f(map_child_exprs(e, fe))

    def conv(v):
        if isinstance(v, Expression):
            return fe(v)
        if isinstance(v, LogicalPlan):
            return walk(v)
        if isinstance(v, SortOrder):
            return _dc.replace(v, child=fe(v.child))
        if isinstance(v, (list, tuple)):
            return type(v)(conv(x) for x in v)
        return v

    def walk(node: LogicalPlan) -> LogicalPlan:
        kw = {}
        changed = False
        for fld in _dc.fields(node):
            v = getattr(node, fld.name)
            nv = conv(v)
            kw[fld.name] = nv
            if nv is not v:
                changed = True
        return _dc.replace(node, **kw) if changed else node

    return walk(lp)
