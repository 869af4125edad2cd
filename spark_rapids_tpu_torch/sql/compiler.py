"""AST → DataFrame compiler for the SELECT subset.

Design (the standalone slice of Catalyst's analyzer this engine needs):

- **Scopes**: every FROM item contributes an ``Entry`` (alias + sql-name →
  actual-frame-column map). Joins disambiguate colliding actual names by
  renaming the right side; the scope keeps resolving the ORIGINAL sql names,
  so ``alias.col`` works across self-joins.
- **Comma joins** (the TPC idiom ``FROM a, b, c WHERE a.k = b.k ...``):
  single-relation conjuncts are pushed onto their relation, equality
  conjuncts linking the accumulated join tree to the next relation become
  hash-join keys (greedy left-to-right, the order query authors already
  chose), everything else stays a post-join filter.
- **Aggregation**: aggregate-function subtrees are pulled out of select /
  having / order expressions into an Aggregate with internal names
  (``__a{i}``), grouping exprs into ``__g{i}``; the select items then
  compile against the aggregate's output (Spark's two-stage
  ExtractAggregateExpressions shape). ROLLUP/CUBE/GROUPING SETS ride the
  existing GroupedData grouping-sets machinery; ``grouping(x)`` reads the
  grouping-id bit.
- **Subqueries**: uncorrelated scalar/IN become ScalarSubquery/InSubquery
  (resolved by the session before planning). Correlated EXISTS / IN /
  scalar-aggregate subqueries are decorrelated into left_semi / left_anti /
  grouped-join rewrites — the same relational rewrites the hand-written
  TPC-H translations use (tpch/queries.py), applied mechanically.

Reference anchor: the engine's QA target is the reference's SQL battery
(integration_tests/src/main/python/qa_nightly_sql.py); Spark itself does the
parsing there (sql/catalyst SqlParser), which this module replaces.

Copied from ``spark_rapids_tpu/sql/compiler.py``; the one-row relation of a
FROM-less SELECT is a ``HostBatch``, not an Arrow table.
"""
from __future__ import annotations

import datetime as _dt
import itertools
from typing import Dict, List, Optional, Tuple

from .. import functions as F
from ..expr.base import Alias, Expression, Literal, UnresolvedAttribute, output_name
from ..functions import Column, col, lit
from ..plan import logical as L
from ..types import parse_ddl_type
from ..window import WindowSpecBuilder
from ..expr.windows import (
    CURRENT_ROW,
    UNBOUNDED_FOLLOWING,
    UNBOUNDED_PRECEDING,
    WindowOrder,
    WindowSpec,
)
from .parser import (
    JoinRel,
    Node,
    OrderItem,
    QueryExpr,
    Select,
    SetOp,
    SqlError,
    SubqueryRef,
    TableRef,
)

# ── scope ──────────────────────────────────────────────────────────────────


class Entry:
    """One FROM item's columns: sql name (lower) → actual frame column."""

    def __init__(self, alias: Optional[str], names: List[str]):
        self.alias = alias.lower() if alias else None
        self.cols: Dict[str, str] = {n.lower(): n for n in names}
        self.order: List[str] = [n.lower() for n in names]

    def rename(self, sql_name: str, new_actual: str):
        self.cols[sql_name] = new_actual


class Scope:
    def __init__(self, entries: List[Entry], outer: Optional["Scope"] = None):
        self.entries = entries
        self.outer = outer

    def resolve_local(self, name: str, qualifier: Optional[str]):
        name = name.lower()
        hits = []
        for e in self.entries:
            if qualifier is not None and e.alias != qualifier.lower():
                continue
            if name in e.cols:
                hits.append(e.cols[name])
        if len(hits) > 1 and len(set(hits)) > 1:
            q = f"{qualifier}." if qualifier else ""
            raise SqlError(f"ambiguous column {q}{name}")
        return hits[0] if hits else None

    def resolve(self, name: str, qualifier: Optional[str]):
        """→ ('local', actual) | ('outer', actual) | None"""
        actual = self.resolve_local(name, qualifier)
        if actual is not None:
            return ("local", actual)
        s = self.outer
        while s is not None:
            actual = s.resolve_local(name, qualifier)
            if actual is not None:
                return ("outer", actual)
            s = s.outer
        return None

    def all_columns(self) -> List[Tuple[str, str]]:
        out = []
        for e in self.entries:
            for sql in e.order:
                out.append((sql, e.cols[sql]))
        return out


class _Correlated(Exception):
    """Raised while probing a subquery compile: it references outer scope."""


# ── AST walking helpers ────────────────────────────────────────────────────

_AGG_FUNCS = {
    "sum", "avg", "mean", "min", "max", "count", "stddev", "stddev_samp",
    "stddev_pop", "variance", "var_samp", "var_pop", "corr", "covar_pop",
    "covar_samp", "collect_list", "collect_set", "first", "last",
    "approx_count_distinct",
}

_WINDOW_ONLY_FUNCS = {
    "row_number", "rank", "dense_rank", "percent_rank", "cume_dist",
    "ntile", "lag", "lead",
}


def _child_nodes(n: Node) -> List[Node]:
    out = []
    for v in n.f.values():
        if isinstance(v, Node):
            out.append(v)
        elif isinstance(v, list):
            for x in v:
                if isinstance(x, Node):
                    out.append(x)
                elif isinstance(x, tuple):
                    out.extend(y for y in x if isinstance(y, Node))
                elif isinstance(x, OrderItem):
                    out.append(x.expr)
    return out


def _walk(n: Node):
    yield n
    for c in _child_nodes(n):
        yield from _walk(c)


def _map_nodes(n: Node, fn) -> Node:
    """Bottom-up rewrite EXCEPT inside subquery nodes (they have their own
    scope)."""
    replaced = fn(n)
    if replaced is not None:
        return replaced
    if n.kind in ("exists", "in_query", "scalar_query"):
        return n
    newf = {}
    changed = False
    for k, v in n.f.items():
        if isinstance(v, Node):
            nv = _map_nodes(v, fn)
            changed |= nv is not v
            newf[k] = nv
        elif isinstance(v, list):
            nl = []
            for x in v:
                if isinstance(x, Node):
                    nx = _map_nodes(x, fn)
                    changed |= nx is not x
                    nl.append(nx)
                elif isinstance(x, tuple):
                    nt = tuple(
                        _map_nodes(y, fn) if isinstance(y, Node) else y
                        for y in x
                    )
                    changed |= nt != x
                    nl.append(nt)
                elif isinstance(x, OrderItem):
                    ne = _map_nodes(x.expr, fn)
                    changed |= ne is not x.expr
                    nl.append(OrderItem(ne, x.ascending, x.nulls_first))
                else:
                    nl.append(x)
            newf[k] = nl
        else:
            newf[k] = v
    if not changed:
        return n
    return Node(n.kind, **newf)


def _conjuncts(n: Optional[Node]) -> List[Node]:
    if n is None:
        return []
    if n.kind == "and":
        return _conjuncts(n.f["l"]) + _conjuncts(n.f["r"])
    return [n]


def _and_all(nodes: List[Node]) -> Optional[Node]:
    out = None
    for n in nodes:
        out = n if out is None else Node("and", l=out, r=n)
    return out


def _has_subquery(n: Node) -> bool:
    return any(
        x.kind in ("exists", "in_query", "scalar_query") for x in _walk(n)
    )


def _has_aggregate(n: Node) -> bool:
    """GROUP-aggregate detection: a window's own function (sum(x) OVER ..)
    is NOT a group aggregate, but aggregates nested in its arguments /
    partition / order (rank() over (order by sum(x))) are."""
    if n.kind == "window":
        subs = (
            list(n.f["fn"].f["args"])
            + list(n.f["partition"])
            + [oi.expr for oi in n.f["order"]]
        )
        return any(_has_aggregate(x) for x in subs)
    if n.kind == "func" and (n.f["name"] in _AGG_FUNCS or n.f.get("star")):
        return True
    return any(_has_aggregate(c) for c in _child_nodes(n))


def _has_window(n: Node) -> bool:
    return any(x.kind == "window" for x in _walk(n))


# ── compiler ───────────────────────────────────────────────────────────────


class Rel:
    def __init__(self, df, entries: List[Entry]):
        self.df = df
        self.entries = entries


class Compiler:
    def __init__(self, session):
        self.session = session
        self._uid = itertools.count()
        # views visible to the query being compiled (temp views + CTEs);
        # expression-level subqueries (scalar/IN inside general exprs)
        # resolve against the innermost entry
        self._views_stack: List[dict] = []
        # correlated SELECT-list scalar subqueries decorrelated by the
        # pre-pass: ast node id → replacement Column over the joined rel
        self._scalar_subs: Dict[int, Column] = {}

    def _current_views(self) -> dict:
        if self._views_stack:
            return self._views_stack[-1]
        return dict(getattr(self.session, "_temp_views", {}))

    def fresh(self, stem: str) -> str:
        return f"__{stem}{next(self._uid)}"

    # ── entry point ──────────────────────────────────────────────────────
    def compile(self, q: QueryExpr):
        views = dict(getattr(self.session, "_temp_views", {}))
        rel = self.compile_query(q, views, outer=None)
        return rel.df

    # ── query / set ops ─────────────────────────────────────────────────
    def compile_query(
        self, q: QueryExpr, views: dict, outer: Optional[Scope]
    ) -> Rel:
        views = dict(views)
        for name, cols_, sub in q.ctes:
            sub_rel = self.compile_query(sub, views, outer=None)
            df = sub_rel.df
            if cols_:
                df = df.select(
                    *[
                        col(c).alias(n)
                        for c, n in zip(df.columns, cols_)
                    ]
                )
            views[name.lower()] = df
        self._views_stack.append(views)
        try:
            body = q.body
            if isinstance(body, Select):
                return self.compile_select(
                    body, views, outer, q.order, q.limit
                )
            # set operation (or parenthesized query)
            rel = self.compile_body(body, views, outer)
            df = rel.df
            df = self._apply_order_limit_simple(df, q.order, q.limit)
            return Rel(df, rel.entries)
        finally:
            self._views_stack.pop()

    def compile_body(self, body, views, outer) -> Rel:
        if isinstance(body, QueryExpr):
            return self.compile_query(body, views, outer)
        if isinstance(body, Select):
            return self.compile_select(body, views, outer, [], None)
        assert isinstance(body, SetOp)
        left = self.compile_body(body.left, views, outer)
        right = self.compile_body(body.right, views, outer)
        lcols, rcols = left.df.columns, right.df.columns
        if len(lcols) != len(rcols):
            raise SqlError(
                f"{body.op}: column counts differ ({len(lcols)} vs {len(rcols)})"
            )
        rdf = right.df.select(
            *[col(rc).alias(lc) for rc, lc in zip(rcols, lcols)]
        )
        if body.op == "union":
            df = left.df.union(rdf)
            if not body.all:
                df = df.distinct()
        elif body.op == "intersect":
            df = left.df.intersect(rdf)
        else:
            df = left.df.subtract(rdf)
        return Rel(df, [Entry(None, df.columns)])

    def _apply_order_limit_simple(self, df, order: List[OrderItem], limit):
        """Order/limit over a set-op result: output columns + ordinals only."""
        if order:
            sos = []
            for oi in order:
                e = oi.expr
                if e.kind == "lit" and isinstance(e.f["value"], int):
                    name = df.columns[e.f["value"] - 1]
                elif e.kind == "col" and e.f["qualifier"] is None:
                    name = self._match_output(df.columns, e.f["name"])
                else:
                    raise SqlError(
                        "ORDER BY over a set operation supports output "
                        "columns and ordinals only"
                    )
                sos.append(
                    L.SortOrder(
                        UnresolvedAttribute(name), oi.ascending, oi.nulls_first
                    )
                )
            from ..session import DataFrame

            df = DataFrame(df._session, L.Sort(sos, True, df._plan))
        if limit is not None:
            df = df.limit(limit)
        return df

    @staticmethod
    def _match_output(columns: List[str], name: str) -> str:
        for c in columns:
            if c.lower() == name.lower():
                return c
        raise SqlError(f"ORDER BY column {name!r} not in output")

    # ── FROM ────────────────────────────────────────────────────────────
    def compile_from_item(self, item, views, outer) -> Rel:
        if isinstance(item, TableRef):
            key = item.name.lower()
            if key not in views:
                raise SqlError(f"unknown table {item.name!r}")
            df = views[key]
            return Rel(df, [Entry(item.alias or item.name, df.columns)])
        if isinstance(item, SubqueryRef):
            rel = self.compile_query(item.query, views, outer=None)
            df = rel.df
            if item.col_aliases:
                df = df.select(
                    *[
                        col(c).alias(n)
                        for c, n in zip(df.columns, item.col_aliases)
                    ]
                )
            return Rel(df, [Entry(item.alias, df.columns)])
        assert isinstance(item, JoinRel)
        left = self.compile_from_item(item.left, views, outer)
        right = self.compile_from_item(item.right, views, outer)
        return self.join_rels(left, right, item.how, item.cond, outer)

    def _disambiguate(self, left: Rel, right: Rel, keep: set = frozenset()):
        """Rename right-side actual columns colliding with the left; one
        Project total. ``keep`` names are left untouched (USING joins).
        Returns ``(rel, renames)`` so already-compiled expressions over the
        right side (decorrelation key pairs) can be remapped."""
        lnames = {c for c in left.df.columns}
        renames: Dict[str, str] = {}
        for c in right.df.columns:
            if c in lnames and c not in keep:
                renames[c] = self.fresh(c.lower().strip("_") or "c")
        if not renames:
            return right, renames
        df = right.df.select(
            *[
                (col(c).alias(renames[c]) if c in renames else col(c))
                for c in right.df.columns
            ]
        )
        for e in right.entries:
            for sql, actual in list(e.cols.items()):
                if actual in renames:
                    e.rename(sql, renames[actual])
        return Rel(df, right.entries), renames

    @staticmethod
    def _remap_expr(e: Expression, renames: Dict[str, str]) -> Expression:
        if not renames:
            return e
        from ..expr.base import map_child_exprs

        def rec(x: Expression) -> Expression:
            if isinstance(x, UnresolvedAttribute) and x.name in renames:
                return UnresolvedAttribute(renames[x.name])
            if not x.children():
                return x
            return map_child_exprs(x, rec)

        return rec(e)

    def join_rels(
        self,
        left: Rel,
        right: Rel,
        how: str,
        cond: Optional[Node],
        outer: Optional[Scope],
        extra_keys: Optional[List[Tuple[Expression, Expression]]] = None,
    ) -> Rel:
        using_cols = None
        if cond is not None and cond.kind == "using":
            using_cols = [c.lower() for c in cond.f["cols"]]
            keep = {
                e.cols[c]
                for e in right.entries
                for c in using_cols
                if c in e.cols
            }
            right, renames = self._disambiguate(left, right, keep=keep)
        else:
            right, renames = self._disambiguate(left, right)
        if extra_keys:
            # decorrelation key pairs were compiled against the PRE-rename
            # right side — remap their inner exprs
            extra_keys = [
                (le, self._remap_expr(re_, renames)) for le, re_ in extra_keys
            ]
        joined_entries = left.entries + right.entries
        scope = Scope(joined_entries, outer)
        lk: List[Expression] = []
        rk: List[Expression] = []
        residual = None
        using = False
        if using_cols is not None:
            lk = [UnresolvedAttribute(Scope(left.entries).resolve_local(c, None)) for c in using_cols]
            rk = [UnresolvedAttribute(Scope(right.entries).resolve_local(c, None)) for c in using_cols]
            using = True
        elif cond is not None:
            e = self.compile_expr(cond, scope).expr
            from ..exec.cpu_join import extract_equi_join_keys

            lk, rk, residual = extract_equi_join_keys(
                e, left.df.schema, right.df.schema
            )
        if extra_keys:
            for le, re_ in extra_keys:
                lk.append(le)
                rk.append(re_)
        df = self._session_df(
            L.Join(left.df._plan, right.df._plan, how, lk, rk, residual, using)
        )
        if how in ("left_semi", "left_anti"):
            return Rel(df, left.entries)
        if using:
            # USING drops the right key columns from the output
            dropped = {output_name(k) for k in rk}
            for e in right.entries:
                for sql in list(e.cols):
                    if e.cols[sql] in dropped:
                        del e.cols[sql]
                        e.order.remove(sql)
        return Rel(df, joined_entries)

    def _session_df(self, plan):
        from ..session import DataFrame

        return DataFrame(self.session, plan)

    # ── SELECT core ─────────────────────────────────────────────────────
    def compile_select(
        self,
        sel: Select,
        views: dict,
        outer: Optional[Scope],
        order: List[OrderItem],
        limit: Optional[int],
    ) -> Rel:
        # 1. FROM --------------------------------------------------------
        if not sel.from_items:
            import numpy as np

            df = self.session.create_dataframe(
                {"__one": np.ones(1, dtype=np.int64)}
            )
            rel = Rel(df, [Entry(None, [])])
            where_conj: List[Node] = _conjuncts(sel.where)
        else:
            rels = [
                self.compile_from_item(it, views, outer)
                for it in sel.from_items
            ]
            where_conj = _conjuncts(sel.where)
            rel, where_conj = self._assemble_from(rels, where_conj, outer)

        scope = Scope(rel.entries, outer)

        # 2. WHERE (simple conjuncts, then subquery conjuncts) -----------
        plain = [c for c in where_conj if not _has_subquery(c)]
        subq = [c for c in where_conj if _has_subquery(c)]
        if plain:
            rel = Rel(
                rel.df.filter(self.compile_expr(_and_all(plain), scope)),
                rel.entries,
            )
        for c in subq:
            rel = self._apply_subquery_conjunct(rel, c, views, outer)
        scope = Scope(rel.entries, outer)

        # 3. aggregation / select compilation ----------------------------
        items = self._expand_stars(sel.items, scope)
        rel2 = self._decorrelate_scalar_selects(items, rel, scope, views)
        if rel2 is not rel:
            rel = rel2
            scope = Scope(rel.entries, outer)
        has_agg = (
            sel.group_by is not None
            or any(_has_aggregate(e) for e, _ in items)
            or (sel.having is not None and _has_aggregate(sel.having))
        )
        if has_agg:
            return self._compile_aggregate_select(
                sel, items, rel, scope, views, order, limit
            )

        if sel.having is not None:
            raise SqlError("HAVING without GROUP BY/aggregates")

        # plain projection (maybe with windows)
        out_cols, out_names = self._compile_items(items, scope)
        return self._finish(
            rel, scope, out_cols, out_names, None, sel.distinct, order, limit
        )

    # FROM assembly: pushdown + greedy equi-join ordering ---------------
    def _assemble_from(
        self, rels: List[Rel], conjuncts: List[Node], outer
    ) -> Tuple[Rel, List[Node]]:
        if len(rels) == 1:
            return rels[0], conjuncts
        scopes = [Scope(r.entries) for r in rels]

        def owners(node: Node) -> Optional[set]:
            """Which rels does this conjunct reference? None = not fully
            resolvable here (outer refs / select aliases / subqueries)."""
            if _has_subquery(node):
                return None
            idxs = set()
            for x in _walk(node):
                if x.kind == "col":
                    found = None
                    for i, s in enumerate(scopes):
                        if s.resolve_local(x.f["name"], x.f["qualifier"]):
                            found = i
                            break
                    if found is None:
                        return None
                    idxs.add(found)
            return idxs

        remaining: List[Node] = []
        per_rel: List[List[Node]] = [[] for _ in rels]
        joinable: List[Node] = []
        for cj in conjuncts:
            o = owners(cj)
            if o is None:
                remaining.append(cj)
            elif len(o) == 1:
                per_rel[o.pop()].append(cj)
            else:
                joinable.append(cj)
        # single-relation predicate pushdown (pre-join filters)
        for i, cjs in enumerate(per_rel):
            if cjs:
                rels[i] = Rel(
                    rels[i].df.filter(
                        self.compile_expr(_and_all(cjs), scopes[i])
                    ),
                    rels[i].entries,
                )

        def is_equi_between(cj: Node, done: set, nxt: int) -> bool:
            if cj.kind != "cmp" or cj.f["op"] != "=":
                return False
            lo = owners_of(cj.f["l"])
            ro = owners_of(cj.f["r"])
            if lo is None or ro is None:
                return False
            return (lo <= done and ro == {nxt}) or (ro <= done and lo == {nxt})

        def owners_of(node: Node) -> Optional[set]:
            idxs = set()
            for x in _walk(node):
                if x.kind == "col":
                    found = None
                    for i, s in enumerate(scopes):
                        if s.resolve_local(x.f["name"], x.f["qualifier"]):
                            found = i
                            break
                    if found is None:
                        return None
                    idxs.add(found)
            return idxs

        done = {0}
        acc = rels[0]
        todo = list(range(1, len(rels)))
        unused = list(joinable)
        while todo:
            pick = None
            for cand in todo:
                keys = [
                    cj for cj in unused if is_equi_between(cj, done, cand)
                ]
                if keys:
                    pick = (cand, keys)
                    break
            if pick is None:
                cand = todo[0]
                pick = (cand, [])
            cand, keys = pick
            cond = _and_all(keys)
            how = "inner" if keys else "cross"
            acc = self.join_rels(acc, rels[cand], how, cond, outer)
            for k in keys:
                unused.remove(k)
            todo.remove(cand)
            done.add(cand)
        # whatever equi conjuncts never linked (e.g. a=b where both already
        # joined) plus everything non-equi stays a post-join filter
        remaining.extend(unused)
        return acc, remaining

    # subquery conjuncts ------------------------------------------------
    def _apply_subquery_conjunct(
        self, rel: Rel, cj: Node, views, outer
    ) -> Rel:
        scope = Scope(rel.entries, outer)
        # normalize NOT wrappers
        negated = False
        inner = cj
        while inner.kind == "not":
            negated = not negated
            inner = inner.f["e"]

        if inner.kind == "exists":
            return self._compile_exists(
                rel, inner.f["query"], negated, views, scope
            )
        if inner.kind == "in_query":
            return self._compile_in_query(
                rel,
                inner.f["e"],
                inner.f["query"],
                negated != bool(inner.f["negated"]),
                views,
                scope,
            )
        if inner.kind == "or" and not negated:
            ors = self._or_branches(inner)
            if all(b.kind == "exists" for b in ors):
                return self._compile_exists_union(rel, ors, views, scope)
        # general conjunct containing scalar subqueries: decorrelate each
        new_ast, rel = self._lift_scalar_subqueries(cj, rel, views, scope)
        scope = Scope(rel.entries, outer)
        return Rel(
            rel.df.filter(self.compile_expr(new_ast, scope)), rel.entries
        )

    @staticmethod
    def _or_branches(n: Node) -> List[Node]:
        if n.kind == "or":
            return Compiler._or_branches(n.f["l"]) + Compiler._or_branches(
                n.f["r"]
            )
        return [n]

    def _decorrelate_scalar_selects(
        self, items, rel: Rel, scope: Scope, views
    ) -> Rel:
        """Correlated scalar subqueries in the SELECT list: group the inner
        side by its correlation keys, LEFT JOIN onto the outer rel, and
        replace the subquery with the joined aggregate column (Spark's
        RewriteCorrelatedScalarSubquery). COUNT over an empty group is 0,
        not NULL — the classic count bug — so count-like aggregates ride a
        post-join coalesce."""
        from ..expr.aggregates import Count

        for e, _name in items:
            for node in _walk(e):
                if node.kind != "scalar_query":
                    continue
                if id(node) in self._scalar_subs:
                    continue
                q = node.f["query"]
                try:
                    inner_rel, keys, residual, inner_scope, isel = (
                        self._subquery_parts(q, views, scope)
                    )
                except SqlError:
                    continue  # shape the splitter can't take apart: the
                    # uncorrelated path will compile it (or error honestly)
                if not keys and not residual:
                    continue  # uncorrelated: normal scalar_subquery path
                if residual:
                    raise SqlError(
                        "correlated scalar subquery supports only equality "
                        "correlation"
                    )
                if len(isel.items) != 1:
                    raise SqlError(
                        "scalar subquery must select exactly one column"
                    )
                if isel.group_by or isel.distinct or isel.having:
                    raise SqlError(
                        "unsupported correlated scalar subquery shape"
                    )
                item_ast, _alias = isel.items[0]
                if item_ast.kind != "func":
                    raise SqlError(
                        "correlated scalar subquery must select one "
                        "aggregate"
                    )
                agg_col = self.compile_agg_func(item_ast, inner_scope)
                i = next(self._uid)
                vname = f"__sq{i}_v"
                knames = [f"__sq{i}_k{j}" for j in range(len(keys))]
                gdf = inner_rel.df.group_by(
                    *[Column(ie).alias(kn)
                      for (_oe, ie), kn in zip(keys, knames)]
                ).agg(agg_col.alias(vname))
                left_df, onames = rel.df, []
                for j, (oe, _ie) in enumerate(keys):
                    on_ = f"__sq{i}_o{j}"
                    left_df = left_df.with_column(on_, Column(oe))
                    onames.append(on_)
                joined = left_df.join(
                    gdf, on=list(zip(onames, knames)), how="left"
                )
                val = col(vname)
                if isinstance(agg_col.expr, Count):
                    val = F.coalesce(val, lit(0))
                self._scalar_subs[id(node)] = val
                rel = Rel(joined, rel.entries)
        return rel

    def _subquery_parts(self, q: QueryExpr, views, outer_scope: Scope):
        """Compile a (possibly correlated) subquery's FROM+WHERE. Returns
        (inner_rel, key_pairs, residual_conjs, inner_scope, select_items)
        where key_pairs are (outer_expr, inner_expr) Expression pairs from
        equality correlation."""
        if q.ctes or not isinstance(q.body, Select):
            raise SqlError("unsupported subquery shape for decorrelation")
        sel = q.body
        rels = [
            self.compile_from_item(it, views, None) for it in sel.from_items
        ]
        conjs = _conjuncts(sel.where)

        # classify each conjunct: inner-only / equality-correlated / other
        def refs_outer(node: Node) -> bool:
            probe = Scope(
                [e for r in rels for e in r.entries], outer_scope
            )
            for x in _walk(node):
                if x.kind == "col":
                    r = probe.resolve(x.f["name"], x.f["qualifier"])
                    if r is not None and r[0] == "outer":
                        return True
            return False

        inner_only = [c for c in conjs if not refs_outer(c)]
        correlated = [c for c in conjs if refs_outer(c)]
        inner_rel, leftover = self._assemble_from(rels, inner_only, None)
        inner_scope = Scope(inner_rel.entries)
        if leftover:
            plain = [c for c in leftover if not _has_subquery(c)]
            subq = [c for c in leftover if _has_subquery(c)]
            if plain:
                inner_rel = Rel(
                    inner_rel.df.filter(
                        self.compile_expr(_and_all(plain), inner_scope)
                    ),
                    inner_rel.entries,
                )
            for c in subq:
                inner_rel = self._apply_subquery_conjunct(
                    inner_rel, c, views, None
                )
            inner_scope = Scope(inner_rel.entries)

        key_pairs: List[Tuple[Expression, Expression]] = []
        residual: List[Node] = []
        for c in correlated:
            pair = self._equality_pair(c, inner_scope, outer_scope)
            if pair is not None:
                key_pairs.append(pair)
            else:
                residual.append(c)
        return inner_rel, key_pairs, residual, inner_scope, sel

    def _equality_pair(self, c: Node, inner_scope: Scope, outer_scope: Scope):
        if c.kind != "cmp" or c.f["op"] != "=":
            return None

        def side(node: Node):
            """'inner' | 'outer' | None (mixed/unresolved)"""
            kinds = set()
            for x in _walk(node):
                if x.kind == "col":
                    ri = inner_scope.resolve_local(
                        x.f["name"], x.f["qualifier"]
                    )
                    if ri is not None:
                        kinds.add("inner")
                        continue
                    ro = outer_scope.resolve(x.f["name"], x.f["qualifier"])
                    if ro is not None:
                        kinds.add("outer")
                        continue
                    return None
            if kinds == {"inner"}:
                return "inner"
            if kinds == {"outer"}:
                return "outer"
            return None

        ls, rs = side(c.f["l"]), side(c.f["r"])
        if {ls, rs} == {"inner", "outer"}:
            inner_ast = c.f["l"] if ls == "inner" else c.f["r"]
            outer_ast = c.f["l"] if ls == "outer" else c.f["r"]
            ie = self.compile_expr(inner_ast, inner_scope).expr
            oe = self.compile_expr(outer_ast, outer_scope).expr
            return (oe, ie)
        return None

    def _compile_exists(
        self, rel: Rel, q: QueryExpr, negated: bool, views, scope: Scope
    ) -> Rel:
        inner_rel, keys, residual, inner_scope, _sel = self._subquery_parts(
            q, views, scope
        )
        how = "left_anti" if negated else "left_semi"
        res_ast = _and_all(residual)
        if res_ast is not None:
            # residual must see both sides during matching
            joined = self._join_with_residual(
                rel, inner_rel, how, keys, res_ast, scope
            )
        else:
            joined = self.join_rels(
                rel, inner_rel, how, None, scope.outer, extra_keys=keys
            )
        return Rel(joined.df, rel.entries)

    def _join_with_residual(
        self, left: Rel, right: Rel, how, keys, res_ast, scope: Scope
    ) -> Rel:
        right, renames = self._disambiguate(left, right)
        joined_scope = Scope(left.entries + right.entries, scope.outer)
        res = self.compile_expr(res_ast, joined_scope).expr
        lk = [k[0] for k in keys]
        rk = [self._remap_expr(k[1], renames) for k in keys]
        df = self._session_df(
            L.Join(left.df._plan, right.df._plan, how, lk, rk, res, False)
        )
        return Rel(df, left.entries)

    def _compile_exists_union(
        self, rel: Rel, branches: List[Node], views, scope: Scope
    ) -> Rel:
        """exists(A) or exists(B) [or ...] where every branch correlates by
        equality on the SAME outer expressions → one semi join against the
        union of the branches' correlation keysets (TPC-DS q10/q35 shape)."""
        per_branch = []
        for b in branches:
            inner_rel, keys, residual, inner_scope, _ = self._subquery_parts(
                b.f["query"], views, scope
            )
            if residual or not keys:
                raise SqlError(
                    "OR of EXISTS requires pure equality correlation"
                )
            per_branch.append((inner_rel, keys))
        outer_keys0 = [str(k[0]) for k in per_branch[0][1]]
        for _, keys in per_branch[1:]:
            if [str(k[0]) for k in keys] != outer_keys0:
                raise SqlError(
                    "OR of EXISTS branches must correlate on the same "
                    "outer expressions"
                )
        names = [self.fresh("ek") for _ in per_branch[0][1]]
        unioned = None
        for inner_rel, keys in per_branch:
            proj = inner_rel.df.select(
                *[
                    Column(k[1]).alias(n)
                    for k, n in zip(keys, names)
                ]
            )
            unioned = proj if unioned is None else unioned.union(proj)
        right = Rel(unioned, [Entry(None, unioned.columns)])
        pairs = [
            (k[0], UnresolvedAttribute(n))
            for k, n in zip(per_branch[0][1], names)
        ]
        joined = self.join_rels(
            rel, right, "left_semi", None, scope.outer, extra_keys=pairs
        )
        return Rel(joined.df, rel.entries)

    def _compile_in_query(
        self, rel: Rel, probe: Node, q: QueryExpr, negated: bool, views, scope
    ) -> Rel:
        # uncorrelated → InSubquery expression (session resolves to InSet)
        if not self._is_correlated(q, views, scope):
            inner = self.compile_query(q, views, outer=None).df
            probe_c = self.compile_expr(probe, scope)
            e = probe_c.isin(inner)
            if negated:
                e = ~e
            return Rel(rel.df.filter(e), rel.entries)
        inner_rel, keys, residual, inner_scope, sel = self._subquery_parts(
            q, views, scope
        )
        if len(sel.items) != 1:
            raise SqlError("IN subquery must select exactly one column")
        item_e = self.compile_expr(sel.items[0][0], inner_scope).expr
        probe_e = self.compile_expr(probe, scope).expr
        keys = [(probe_e, item_e)] + keys
        how = "left_anti" if negated else "left_semi"
        if residual:
            joined = self._join_with_residual(
                rel, inner_rel, how, keys, _and_all(residual), scope
            )
        else:
            joined = self.join_rels(
                rel, inner_rel, how, None, scope.outer, extra_keys=keys
            )
        return Rel(joined.df, rel.entries)

    def _is_correlated(self, q: QueryExpr, views, scope: Scope) -> bool:
        try:
            probe = Compiler(self.session)
            probe._probe_outer = scope

            class _Trap(Scope):
                pass

            # cheap structural test: walk FROM-resolvable names
            sel = q.body
            if not isinstance(sel, Select):
                return False
            rels = [
                self.compile_from_item(it, views, None)
                for it in sel.from_items
            ]
            inner = Scope([e for r in rels for e in r.entries])
            for part in [sel.where, sel.having] + [e for e, _ in sel.items]:
                if part is None:
                    continue
                for x in _walk(part):
                    if x.kind == "col":
                        if inner.resolve_local(
                            x.f["name"], x.f["qualifier"]
                        ) is None and scope.resolve(
                            x.f["name"], x.f["qualifier"]
                        ):
                            return True
            return False
        except SqlError:
            return False

    def _lift_scalar_subqueries(self, ast: Node, rel: Rel, views, scope):
        """Replace scalar_query nodes: uncorrelated → ScalarSubquery expr;
        correlated aggregate → grouped join + column reference."""
        state = {"rel": rel}

        def fn(n: Node):
            if n.kind != "scalar_query":
                return None
            q = n.f["query"]
            if not self._is_correlated(q, views, scope):
                inner = self.compile_query(q, views, outer=None).df
                return Node("_compiled", column=F.scalar_subquery(inner))
            (
                inner_rel,
                keys,
                residual,
                inner_scope,
                sel,
            ) = self._subquery_parts(q, views, scope)
            if residual:
                raise SqlError(
                    "correlated scalar subquery supports equality "
                    "correlation only"
                )
            if len(sel.items) != 1 or not _has_aggregate(sel.items[0][0]):
                raise SqlError(
                    "correlated scalar subquery must be a single aggregate"
                )
            gnames = [self.fresh("ck") for _ in keys]
            vname = self.fresh("sv")
            from ..session import GroupedData

            gd = GroupedData(
                inner_rel.df,
                [Alias(k[1], n) for k, n in zip(keys, gnames)],
            )
            agg_c = self._compile_simple_agg(
                sel.items[0][0], inner_scope
            ).alias(vname)
            agg_df = gd.agg(agg_c)
            right = Rel(agg_df, [Entry(None, agg_df.columns)])
            cur = state["rel"]
            pairs = [
                (k[0], UnresolvedAttribute(n)) for k, n in zip(keys, gnames)
            ]
            joined = self.join_rels(
                cur, right, "left", None, scope.outer, extra_keys=pairs
            )
            # the grouped value column may have been renamed by
            # disambiguation — resolve through the joined entries
            actual = Scope(joined.entries).resolve_local(vname, None)
            state["rel"] = joined
            return Node("_compiled", column=col(actual))

        new_ast = _map_nodes(ast, fn)
        return new_ast, state["rel"]

    def _compile_simple_agg(self, ast: Node, scope: Scope) -> Column:
        """An aggregate expression tree with NO group refs (correlated
        scalar subquery bodies: avg(x), 0.5*sum(q), min(a*b)...). The
        planner's _extract_aggs handles arbitrary trees over aggregate
        functions, so a direct compile suffices."""
        return self.compile_expr(ast, scope)

    # aggregation --------------------------------------------------------
    def _compile_aggregate_select(
        self, sel, items, rel: Rel, scope: Scope, views, order, limit
    ) -> Rel:
        from ..session import GROUPING_ID, GroupedData

        group_asts: List[Node] = []
        if sel.group_by:
            for g in sel.group_by:
                group_asts.append(self._resolve_group_ast(g, items))

        # collect GROUP-aggregate subtrees everywhere they can appear; a
        # window's own function is a window aggregate, but aggregates in
        # its args/partition/order are group aggregates (sum over sum)
        agg_asts: List[Node] = []

        def collect(ast: Node):
            if ast.kind == "window":
                for x in ast.f["fn"].f["args"]:
                    collect(x)
                for x in ast.f["partition"]:
                    collect(x)
                for oi in ast.f["order"]:
                    collect(oi.expr)
                return
            if ast.kind == "func" and (
                ast.f["name"] in _AGG_FUNCS or ast.f.get("star")
            ):
                if ast not in agg_asts:
                    agg_asts.append(ast)
                return
            for c in _child_nodes(ast):
                collect(c)

        for e, _ in items:
            collect(e)
        if sel.having is not None:
            collect(sel.having)
        for oi in order:
            if not (
                oi.expr.kind == "lit" or oi.expr.kind == "col"
            ):
                collect(oi.expr)

        uses_grouping_fn = any(
            x.kind == "func" and x.f["name"] in ("grouping", "grouping_id")
            for e, _ in items
            for x in _walk(e)
        ) or (
            sel.having is not None
            and any(
                x.kind == "func" and x.f["name"] in ("grouping", "grouping_id")
                for x in _walk(sel.having)
            )
        ) or any(
            x.kind == "func" and x.f["name"] in ("grouping", "grouping_id")
            for oi in order
            for x in _walk(oi.expr)
        )

        gnames = [f"__g{i}" for i in range(len(group_asts))]
        anames = [f"__a{i}" for i in range(len(agg_asts))]
        g_aliased = [
            Alias(self.compile_expr(g, scope).expr, n)
            for g, n in zip(group_asts, gnames)
        ]
        a_cols = [
            self.compile_agg_func_or_tree(a, scope).alias(n)
            for a, n in zip(agg_asts, anames)
        ]
        gid_name = None
        if uses_grouping_fn:
            gid_name = self.fresh("gid")
            a_cols.append(
                Column(UnresolvedAttribute(GROUPING_ID)).alias(gid_name)
            )

        grouping_sets = None
        if sel.group_mode == "rollup":
            grouping_sets = [
                list(range(k)) for k in range(len(group_asts), -1, -1)
            ]
        elif sel.group_mode == "cube":
            n = len(group_asts)
            grouping_sets = [
                [i for i in range(n) if mask & (1 << i)]
                for mask in range(2**n - 1, -1, -1)
            ]
        elif sel.group_mode == "sets":
            grouping_sets = [
                [group_asts.index(e) for e in s] for s in sel.group_sets
            ]

        gd = GroupedData(rel.df, g_aliased, grouping_sets=grouping_sets)
        agg_df = gd.agg(*a_cols)
        # aggregate output keeps the ALIASED grouping names (__g{i})
        post_entries = [Entry(None, agg_df.columns)]
        # map original sql names of bare-column group exprs so stray refs
        # (select k+1 ... group by k) still resolve
        for g, n in zip(group_asts, gnames):
            if g.kind == "col":
                post_entries[0].cols.setdefault(g.f["name"].lower(), n)
        post_scope = Scope(post_entries, scope.outer)
        post_rel = Rel(agg_df, post_entries)

        n_keys = len(group_asts)

        def substitute(ast: Node) -> Node:
            def fn(n: Node):
                if n.kind == "window":
                    # keep the window's own function a function; substitute
                    # inside its args / partition / order only
                    f0 = n.f["fn"]
                    newfn = Node(
                        "func",
                        name=f0.f["name"],
                        args=[substitute(a) for a in f0.f["args"]],
                        distinct=f0.f.get("distinct", False),
                        star=f0.f.get("star", False),
                    )
                    return Node(
                        "window",
                        fn=newfn,
                        partition=[substitute(p) for p in n.f["partition"]],
                        order=[
                            OrderItem(
                                substitute(oi.expr),
                                oi.ascending,
                                oi.nulls_first,
                            )
                            for oi in n.f["order"]
                        ],
                        frame=n.f["frame"],
                    )
                if n.kind == "func" and n.f["name"] == "grouping":
                    arg = n.f["args"][0]
                    if arg not in group_asts:
                        raise SqlError(
                            f"grouping() argument must be a GROUP BY column"
                        )
                    i = group_asts.index(arg)
                    if grouping_sets is None:
                        return Node("lit", value=0)
                    bit = n_keys - 1 - i
                    return Node(
                        "_compiled",
                        column=(
                            (
                                Column(UnresolvedAttribute(gid_name))
                                / lit(2**bit)
                            ).cast(parse_ddl_type("int"))
                            % 2
                        ).cast(parse_ddl_type("int")),
                    )
                if n.kind == "func" and n.f["name"] == "grouping_id":
                    if grouping_sets is None:
                        return Node("lit", value=0)
                    return Node(
                        "_compiled",
                        column=Column(UnresolvedAttribute(gid_name)),
                    )
                if n in agg_asts:
                    return Node(
                        "col",
                        name=anames[agg_asts.index(n)],
                        qualifier=None,
                    )
                if n in group_asts:
                    return Node(
                        "col",
                        name=gnames[group_asts.index(n)],
                        qualifier=None,
                    )
                return None

            return _map_nodes(ast, fn)

        # HAVING
        if sel.having is not None:
            h_ast = substitute(sel.having)
            if _has_subquery(h_ast):
                h_ast, post_rel = self._lift_scalar_subqueries(
                    h_ast, post_rel, views, post_scope
                )
                post_scope = Scope(post_rel.entries, scope.outer)
            post_rel = Rel(
                post_rel.df.filter(self.compile_expr(h_ast, post_scope)),
                post_rel.entries,
            )

        # derive output names from the ORIGINAL asts (substitution rewrites
        # bare group columns to internal __g refs, which must not leak into
        # output column names)
        sub_items = [
            (
                substitute(e),
                a if a is not None else (e.f["name"] if e.kind == "col" else None),
            )
            for e, a in items
        ]
        out_cols, out_names = self._compile_items(sub_items, post_scope)
        return self._finish(
            post_rel,
            post_scope,
            out_cols,
            out_names,
            substitute,
            sel.distinct,
            order,
            limit,
        )

    def _resolve_group_ast(self, g: Node, items) -> Node:
        # ordinal → select item; bare name matching a select alias → its expr
        if g.kind == "lit" and isinstance(g.f["value"], int):
            i = g.f["value"] - 1
            if not (0 <= i < len(items)):
                raise SqlError(f"GROUP BY ordinal {g.f['value']} out of range")
            return items[i][0]
        if g.kind == "col" and g.f["qualifier"] is None:
            for e, a in items:
                if a is not None and a.lower() == g.f["name"].lower():
                    return e
        return g

    # projection / order / limit ----------------------------------------
    def _compile_items(self, items, scope: Scope):
        out_cols: List[Column] = []
        out_names: List[str] = []
        for i, (e, a) in enumerate(items):
            c = self.compile_expr(e, scope)
            if a is not None:
                name = a
            elif e.kind == "col":
                name = e.f["name"]
            else:
                name = output_name(c.expr)
                if name is None or name.startswith("__"):
                    name = f"col{i}"
            out_cols.append(c.alias(name))
            out_names.append(name)
        return out_cols, out_names

    def _expand_stars(self, items, scope: Scope):
        out = []
        for e, a in items:
            if isinstance(e, Node) and e.kind == "star":
                for sql, _actual in scope.all_columns():
                    out.append((Node("col", name=sql, qualifier=None), sql))
            elif isinstance(e, Node) and e.kind == "qstar":
                q = e.f["q"].lower()
                matched = False
                for entry in scope.entries:
                    if entry.alias == q:
                        matched = True
                        for sql in entry.order:
                            out.append(
                                (
                                    Node("col", name=sql, qualifier=q),
                                    sql,
                                )
                            )
                if not matched:
                    raise SqlError(f"unknown table alias {q!r} for {q}.*")
            else:
                out.append((e, a))
        return out

    def _finish(
        self,
        rel: Rel,
        scope: Scope,
        out_cols: List[Column],
        out_names: List[str],
        substitute,
        distinct: bool,
        order: List[OrderItem],
        limit: Optional[int],
    ) -> Rel:
        # ORDER BY resolution: ordinal → output position; name → output
        # column; any other expression compiles as a hidden column against
        # the pre-projection scope, with aggregate substitution AND select
        # aliases expanded to their source expressions (q36's `case when
        # lochierarchy = 0 then i_category end` shape)
        alias_map = {
            n.lower(): c.expr for c, n in zip(out_cols, out_names)
        }

        def expand_aliases(ast: Node) -> Node:
            def fn(n: Node):
                if (
                    n.kind == "col"
                    and n.f["qualifier"] is None
                    and n.f["name"].lower() in alias_map
                ):
                    ex = alias_map[n.f["name"].lower()]
                    inner = ex.child if isinstance(ex, Alias) else ex
                    return Node("_compiled", column=Column(inner))
                return None

            return _map_nodes(ast, fn)

        hidden: List[Column] = []
        sort_orders: List[L.SortOrder] = []
        for oi in order:
            e = oi.expr
            target: Optional[str] = None
            if e.kind == "lit" and isinstance(e.f["value"], int):
                idx = e.f["value"] - 1
                if not (0 <= idx < len(out_names)):
                    raise SqlError(f"ORDER BY ordinal {e.f['value']} out of range")
                target = out_names[idx]
            elif e.kind == "col" and e.f["qualifier"] is None and any(
                n.lower() == e.f["name"].lower() for n in out_names
            ):
                target = next(
                    n for n in out_names if n.lower() == e.f["name"].lower()
                )
            if target is None:
                ast = substitute(e) if substitute is not None else e
                ast = expand_aliases(ast)
                c = self.compile_expr(ast, scope)
                name = self.fresh("ord")
                hidden.append(c.alias(name))
                target = name
            sort_orders.append(
                L.SortOrder(
                    UnresolvedAttribute(target), oi.ascending, oi.nulls_first
                )
            )

        df = rel.df.select(*(out_cols + hidden))
        if distinct:
            if hidden:
                raise SqlError(
                    "ORDER BY over SELECT DISTINCT must use output columns"
                )
            df = df.distinct()
        if sort_orders:
            df = self._session_df(L.Sort(sort_orders, True, df._plan))
        if hidden:
            df = df.select(*[col(n) for n in out_names])
        if limit is not None:
            df = df.limit(limit)
        return Rel(df, [Entry(None, df.columns)])

    # ── expressions ─────────────────────────────────────────────────────
    def compile_expr(self, n: Node, scope: Scope) -> Column:
        k = n.kind
        f = n.f
        if k == "_compiled":
            return f["column"]
        if k == "lit":
            return lit(f["value"])
        if k == "param":
            raise SqlError(
                f"unbound parameter placeholder ?{f['index'] + 1} — bind "
                "values with sql(text, params=[...]) or PREPARE/BIND "
                "before execution"
            )
        if k == "datelit":
            return lit(_dt.date.fromisoformat(f["s"]))
        if k == "tslit":
            s = f["s"]
            return lit(_dt.datetime.fromisoformat(s))
        if k == "interval":
            amount = int(str(f["n"]))
            unit = f["unit"]
            if unit == "year":
                return F.expr_interval(months=12 * amount)
            if unit == "month":
                return F.expr_interval(months=amount)
            if unit == "week":
                return F.expr_interval(days=7 * amount)
            if unit == "day":
                return F.expr_interval(days=amount)
            if unit == "hour":
                return F.expr_interval(microseconds=amount * 3_600_000_000)
            if unit == "minute":
                return F.expr_interval(microseconds=amount * 60_000_000)
            if unit == "second":
                return F.expr_interval(microseconds=amount * 1_000_000)
            raise SqlError(f"unsupported interval unit {unit!r}")
        if k == "col":
            r = scope.resolve(f["name"], f["qualifier"])
            if r is None:
                q = f"{f['qualifier']}." if f["qualifier"] else ""
                raise SqlError(f"cannot resolve column {q}{f['name']}")
            if r[0] == "outer":
                raise _Correlated(f["name"])
            return Column(UnresolvedAttribute(r[1]))
        if k == "neg":
            return -self.compile_expr(f["e"], scope)
        if k == "binop":
            l = self.compile_expr(f["l"], scope)
            r = self.compile_expr(f["r"], scope)
            return {
                "+": l + r,
                "-": l - r,
                "*": l * r,
                "/": l / r,
                "%": l % r,
            }[f["op"]]
        if k == "concat":
            return F.concat(
                self.compile_expr(f["l"], scope),
                self.compile_expr(f["r"], scope),
            )
        if k == "cmp":
            l = self.compile_expr(f["l"], scope)
            r = self.compile_expr(f["r"], scope)
            op = f["op"]
            if op == "=":
                return l == r
            if op in ("<>", "!="):
                return l != r
            if op == "<":
                return l < r
            if op == "<=":
                return l <= r
            if op == ">":
                return l > r
            return l >= r
        if k == "and":
            return self.compile_expr(f["l"], scope) & self.compile_expr(
                f["r"], scope
            )
        if k == "or":
            return self.compile_expr(f["l"], scope) | self.compile_expr(
                f["r"], scope
            )
        if k == "not":
            return ~self.compile_expr(f["e"], scope)
        if k == "isnull":
            c = self.compile_expr(f["e"], scope).is_null()
            return ~c if f["negated"] else c
        if k == "between":
            e = self.compile_expr(f["e"], scope)
            lo = self.compile_expr(f["lo"], scope)
            hi = self.compile_expr(f["hi"], scope)
            c = (e >= lo) & (e <= hi)
            return ~c if f["negated"] else c
        if k == "like":
            pat = f["pat"]
            if pat.kind != "lit" or not isinstance(pat.f["value"], str):
                raise SqlError("LIKE pattern must be a string literal")
            c = self.compile_expr(f["e"], scope).like(pat.f["value"])
            return ~c if f["negated"] else c
        if k == "in_list":
            e = self.compile_expr(f["e"], scope)
            vals = [self.compile_expr(v, scope) for v in f["values"]]
            c = e.isin(*vals)
            return ~c if f["negated"] else c
        if k == "in_query":
            # only reachable in boolean positions already handled; support
            # uncorrelated use inside general expressions too
            inner = self.compile_query(f["query"], self._current_views(), None).df
            c = self.compile_expr(f["e"], scope).isin(inner)
            return ~c if f["negated"] else c
        if k == "scalar_query":
            hit = self._scalar_subs.get(id(n))
            if hit is not None:  # decorrelated by the SELECT-list pre-pass
                return hit
            inner = self.compile_query(f["query"], self._current_views(), None).df
            return F.scalar_subquery(inner)
        if k == "case":
            return self._compile_case(n, scope)
        if k == "cast":
            return self.compile_expr(f["e"], scope).cast(
                parse_ddl_type(f["type"])
            )
        if k == "extract":
            e = self.compile_expr(f["e"], scope)
            fld = f["field"]
            m = {
                "year": F.year,
                "month": F.month,
                "day": F.dayofmonth,
                "quarter": F.quarter,
                "week": F.weekofyear,
                "hour": F.hour,
                "minute": F.minute,
                "second": F.second,
                "dow": F.dayofweek,
                "doy": F.dayofyear,
            }
            if fld not in m:
                raise SqlError(f"unsupported EXTRACT field {fld!r}")
            return m[fld](e)
        if k == "func":
            return self.compile_func(n, scope)
        if k == "window":
            return self.compile_window(n, scope)
        if k == "exists":
            raise SqlError(
                "EXISTS is only supported in WHERE/HAVING conjuncts"
            )
        raise SqlError(f"unsupported expression kind {k!r}")

    def _compile_case(self, n: Node, scope: Scope) -> Column:
        operand = n.f["operand"]
        whens = n.f["whens"]
        else_ = n.f["else_"]
        built = None
        for cond_ast, val_ast in whens:
            if operand is not None:
                cond_ast = Node("cmp", op="=", l=operand, r=cond_ast)
            cond = self.compile_expr(cond_ast, scope)
            val = self.compile_expr(val_ast, scope)
            if built is None:
                built = F.when(cond, val)
            else:
                built = built.when(cond, val)
        if else_ is not None:
            return built.otherwise(self.compile_expr(else_, scope))
        return built

    def compile_agg_func_or_tree(self, n: Node, scope: Scope) -> Column:
        return self.compile_agg_func(n, scope)

    def compile_agg_func(self, n: Node, scope: Scope) -> Column:
        name = n.f["name"]
        if n.f.get("star"):
            if name != "count":
                raise SqlError(f"{name}(*) is not a valid aggregate")
            return F.count("*")
        args = [self.compile_expr(a, scope) for a in n.f["args"]]
        distinct = n.f.get("distinct")
        if distinct:
            if name == "count":
                return F.count_distinct(args[0])
            if name == "sum":
                return F.sum_distinct(args[0])
            raise SqlError(f"DISTINCT is not supported for {name}()")
        m = {
            "sum": F.sum,
            "avg": F.avg,
            "mean": F.avg,
            "min": F.min,
            "max": F.max,
            "count": F.count,
            "stddev": F.stddev,
            "stddev_samp": F.stddev,
            "stddev_pop": F.stddev_pop,
            "variance": F.variance,
            "var_samp": F.variance,
            "var_pop": F.var_pop,
            "collect_list": F.collect_list,
            "collect_set": F.collect_set,
            "first": F.first,
            "last": F.last,
        }
        if name in ("corr", "covar_pop", "covar_samp"):
            return {"corr": F.corr, "covar_pop": F.covar_pop,
                    "covar_samp": F.covar_samp}[name](args[0], args[1])
        if name not in m:
            raise SqlError(f"unknown aggregate function {name!r}")
        return m[name](args[0])

    def compile_func(self, n: Node, scope: Scope) -> Column:
        name = n.f["name"]
        if name in _AGG_FUNCS or n.f.get("star"):
            # bare aggregate outside an aggregate select — the aggregate
            # rewrite should have replaced it; reaching here means a window
            # body (sum(x) over (...)) compiled directly
            return self.compile_agg_func(n, scope)
        args = [self.compile_expr(a, scope) for a in n.f["args"]]
        raw = n.f["args"]

        def need(k):
            if len(args) != k:
                raise SqlError(f"{name}() expects {k} arguments")

        if name in ("substr", "substring"):
            if len(args) == 2:
                return F.substring(args[0], raw[1].f["value"], 1 << 30)
            need(3)
            return F.substring(args[0], raw[1].f["value"], raw[2].f["value"])
        if name == "nullif":
            need(2)
            return F.when(args[0] == args[1], lit(None)).otherwise(args[0])
        if name in ("nvl", "ifnull"):
            need(2)
            return F.nvl(args[0], args[1])
        if name == "position":
            need(2)
            return F.locate(raw[0].f["value"], args[1])
        if name == "mod":
            need(2)
            return args[0] % args[1]
        if name == "power":
            need(2)
            return F.pow(args[0], args[1])
        if name == "ln":
            need(1)
            return F.log(args[0])
        if name == "ceiling":
            need(1)
            return F.ceil(args[0])
        if name == "char_length" or name == "character_length" or name == "len":
            need(1)
            return F.length(args[0])
        if name == "lcase":
            return F.lower(args[0])
        if name == "ucase":
            return F.upper(args[0])
        if name == "day":
            return F.dayofmonth(args[0])
        if name in ("date_add", "date_sub", "datediff", "add_months"):
            need(2)
            fn = {
                "date_add": F.date_add,
                "date_sub": F.date_sub,
                "datediff": F.datediff,
                "add_months": F.add_months,
            }[name]
            return fn(args[0], args[1])
        if name in ("round", "bround"):
            fn = F.round if name == "round" else F.bround
            if len(args) == 1:
                return fn(args[0])
            return fn(args[0], raw[1].f["value"])
        if name in ("lpad", "rpad"):
            fn = F.lpad if name == "lpad" else F.rpad
            pad = raw[2].f["value"] if len(args) == 3 else " "
            return fn(args[0], raw[1].f["value"], pad)
        if name == "locate":
            return F.locate(raw[0].f["value"], args[1],
                            raw[2].f["value"] if len(args) == 3 else 1)
        if name == "instr":
            need(2)
            return F.instr(args[0], raw[1].f["value"])
        if name == "coalesce":
            return F.coalesce(*args)
        if name == "concat":
            return F.concat(*args)
        if name == "concat_ws":
            return F.concat_ws(raw[0].f["value"], *args[1:])
        if name == "greatest":
            return F.greatest(*args)
        if name == "least":
            return F.least(*args)
        if name in ("grouping", "grouping_id"):
            raise SqlError(f"{name}() requires GROUP BY ROLLUP/CUBE/SETS")
        if name in ("regexp_replace",):
            return F.regexp_replace(args[0], raw[1].f["value"], raw[2].f["value"])
        if name in ("regexp_extract",):
            return F.regexp_extract(args[0], raw[1].f["value"],
                                    raw[2].f["value"] if len(args) == 3 else 1)
        if name == "split":
            return F.split(args[0], raw[1].f["value"])
        if name == "translate":
            return F.translate(args[0], raw[1].f["value"], raw[2].f["value"])
        if name == "replace":
            return F.replace(args[0], raw[1].f["value"], raw[2].f["value"])
        if name == "date_format":
            need(2)
            return F.date_format(args[0], raw[1].f["value"])
        if name == "to_date":
            if len(args) == 1:
                return F.to_date(args[0])
            return F.to_date(args[0], raw[1].f["value"])
        if name == "to_timestamp":
            if len(args) == 1:
                return F.to_timestamp(args[0])
            return F.to_timestamp(args[0], raw[1].f["value"])
        if name in _WINDOW_ONLY_FUNCS:
            return self._window_func(n, scope)
        simple = {
            "abs": F.abs, "sqrt": F.sqrt, "exp": F.exp, "floor": F.floor,
            "ceil": F.ceil, "log10": F.log10, "log2": F.log2,
            "upper": F.upper, "lower": F.lower, "length": F.length,
            "trim": F.trim, "ltrim": F.ltrim, "rtrim": F.rtrim,
            "initcap": F.initcap, "reverse": F.reverse, "ascii": F.ascii,
            "year": F.year, "month": F.month, "quarter": F.quarter,
            "dayofmonth": F.dayofmonth, "dayofweek": F.dayofweek,
            "weekofyear": F.weekofyear, "dayofyear": F.dayofyear,
            "last_day": F.last_day, "hour": F.hour, "minute": F.minute,
            "second": F.second, "signum": F.signum, "sign": F.signum,
            "md5": F.md5, "isnan": F.isnan,
        }
        if name == "log":
            if len(args) == 2:
                return F.log(args[0], args[1])
            return F.log(args[0])
        if name in simple:
            need(1)
            return simple[name](args[0])
        raise SqlError(f"unknown function {name!r}")

    def _window_func(self, n: Node, scope: Scope) -> Column:
        name = n.f["name"]
        args = n.f["args"]
        if name == "row_number":
            return F.row_number()
        if name == "rank":
            return F.rank()
        if name == "dense_rank":
            return F.dense_rank()
        if name == "percent_rank":
            return F.percent_rank()
        if name == "cume_dist":
            return F.cume_dist()
        if name == "ntile":
            return F.ntile(self._lit_arg(args[0], scope, "ntile"))
        if name in ("lag", "lead"):
            c = self.compile_expr(args[0], scope)
            offset = (
                self._lit_arg(args[1], scope, name) if len(args) > 1 else 1
            )
            default = None
            if len(args) > 2:
                default = self._lit_arg(args[2], scope, name)
            fn = F.lag if name == "lag" else F.lead
            return fn(c, offset, default)
        raise SqlError(f"unknown window function {name!r}")

    def _lit_arg(self, node: Node, scope: Scope, fname: str):
        """Literal argument value — folds signs (LEAD(x, 1, -1) parses the
        default as unary minus over a literal, not a literal node)."""
        from ..expr.arithmetic import UnaryMinus
        from ..expr.base import Literal

        e = self.compile_expr(node, scope).expr
        if isinstance(e, Literal):
            return e.value
        if isinstance(e, UnaryMinus) and isinstance(e.child, Literal):
            return -e.child.value
        raise SqlError(f"{fname} argument must be a literal")

    def compile_window(self, n: Node, scope: Scope) -> Column:
        fn_ast = n.f["fn"]
        name = fn_ast.f["name"]
        if name in _WINDOW_ONLY_FUNCS:
            func = self._window_func(fn_ast, scope)
        else:
            func = self.compile_agg_func(fn_ast, scope)
        partition = tuple(
            self.compile_expr(p, scope).expr for p in n.f["partition"]
        )
        orders = tuple(
            WindowOrder(
                self.compile_expr(oi.expr, scope).expr,
                oi.ascending,
                oi.nulls_first,
            )
            for oi in n.f["order"]
        )
        spec = WindowSpec(partition, orders)
        frame = n.f["frame"]
        if frame is not None:
            def bound(b, lo: bool):
                kind, v = b
                if kind == "unbounded_preceding":
                    return UNBOUNDED_PRECEDING
                if kind == "unbounded_following":
                    return UNBOUNDED_FOLLOWING
                if kind == "current":
                    return CURRENT_ROW
                return -v if kind == "preceding" else v

            builder = WindowSpecBuilder(spec)
            start = bound(frame.f["start"], True)
            end = bound(frame.f["end"], False)
            if frame.f["fkind"] == "rows":
                spec = builder.rows_between(start, end).spec
            else:
                spec = builder.range_between(start, end).spec
        return func.over(WindowSpecBuilder(spec))
