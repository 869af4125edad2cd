"""Recursive-descent parser for the SELECT subset (see package docstring).

Produces a small AST: ``Node`` for expressions (structural equality is used
by the compiler's aggregate/group-by rewrites), dataclasses for the query
skeleton. No dependency on the engine — the compiler binds names later.

Copied from ``spark_rapids_tpu/sql/parser.py``.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import List, Optional, Tuple


class SqlError(ValueError):
    pass


# ── expression AST ─────────────────────────────────────────────────────────


class Node:
    """Generic expression node; ``kind`` + keyword payload. Equality is
    structural (the compiler matches GROUP BY exprs / aggregate subtrees
    against select items with ``==``)."""

    __slots__ = ("kind", "f")

    def __init__(self, kind: str, **f):
        self.kind = kind
        self.f = f

    def __getattr__(self, name):
        try:
            return self.f[name]
        except KeyError:
            raise AttributeError(name) from None

    def __eq__(self, other):
        return (
            isinstance(other, Node)
            and self.kind == other.kind
            and self.f == other.f
        )

    def __ne__(self, other):
        return not self.__eq__(other)

    def __hash__(self):
        return hash(self.kind)  # cheap; dict use is rare and small

    def __repr__(self):
        inner = ", ".join(f"{k}={v!r}" for k, v in self.f.items())
        return f"Node({self.kind}, {inner})"


# ── query AST ──────────────────────────────────────────────────────────────


@dataclass
class TableRef:
    name: str
    alias: Optional[str] = None


@dataclass
class SubqueryRef:
    query: "QueryExpr"
    alias: Optional[str] = None
    col_aliases: Optional[List[str]] = None


@dataclass
class JoinRel:
    left: object
    right: object
    how: str  # inner, left, right, full, cross
    cond: Optional[Node] = None


@dataclass
class OrderItem:
    expr: Node
    ascending: bool = True
    nulls_first: Optional[bool] = None


@dataclass
class Select:
    items: List[Tuple[Node, Optional[str]]] = field(default_factory=list)
    from_items: List[object] = field(default_factory=list)
    where: Optional[Node] = None
    group_by: Optional[List[Node]] = None
    group_mode: str = "plain"  # plain | rollup | cube | sets
    group_sets: Optional[List[List[Node]]] = None  # for mode == sets
    having: Optional[Node] = None
    distinct: bool = False


@dataclass
class SetOp:
    op: str  # union | intersect | except
    all: bool
    left: object  # Select | SetOp
    right: object


@dataclass
class QueryExpr:
    body: object  # Select | SetOp
    ctes: List[Tuple[str, Optional[List[str]], "QueryExpr"]] = field(
        default_factory=list
    )
    order: List[OrderItem] = field(default_factory=list)
    limit: Optional[int] = None
    # number of '?' placeholders lexed (set on the TOP-LEVEL QueryExpr by
    # parse()); bind_parameters substitutes them before compilation
    n_params: int = 0


# ── lexer ──────────────────────────────────────────────────────────────────

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+|--[^\n]*\n?|/\*.*?\*/)
  | (?P<number>\d+\.\d*(?:[eE][+-]?\d+)?|\.\d+(?:[eE][+-]?\d+)?|\d+(?:[eE][+-]?\d+)?)
  | (?P<string>'(?:[^']|'')*')
  | (?P<qident>"(?:[^"]|"")*"|`(?:[^`]|``)*`)
  | (?P<ident>[A-Za-z_][A-Za-z_0-9]*)
  | (?P<op><>|!=|>=|<=|\|\||=|<|>|\+|-|\*|/|%|\(|\)|,|\.|;|\?)
    """,
    re.VERBOSE | re.DOTALL,
)

_KEYWORDS = {
    # every word with grammatical meaning; identifiers may NOT collide
    "select", "from", "where", "group", "by", "having", "order", "limit",
    "as", "on", "using", "join", "inner", "left", "right", "full", "outer",
    "cross", "semi", "anti", "union", "intersect", "except", "all",
    "distinct", "and", "or", "not", "in", "exists", "between", "like",
    "is", "null", "case", "when", "then", "else", "end", "cast", "with",
    "asc", "desc", "nulls", "first", "last", "rollup", "cube", "grouping",
    "sets", "over", "partition", "rows", "range", "unbounded", "preceding",
    "following", "current", "row", "interval", "extract", "true", "false",
    "date", "timestamp",
}


@dataclass
class Tok:
    kind: str  # kw | ident | number | string | op | eof
    value: str
    pos: int


def _lex(text: str) -> List[Tok]:
    toks: List[Tok] = []
    i, n = 0, len(text)
    while i < n:
        m = _TOKEN_RE.match(text, i)
        if not m:
            raise SqlError(f"cannot tokenize at {text[i:i+30]!r}")
        i = m.end()
        kind = m.lastgroup
        v = m.group()
        if kind == "ws":
            continue
        if kind == "ident":
            lo = v.lower()
            toks.append(
                Tok("kw" if lo in _KEYWORDS else "ident", lo, m.start())
            )
        elif kind == "qident":
            q = v[0]
            toks.append(Tok("ident", v[1:-1].replace(q + q, q), m.start()))
        elif kind == "string":
            toks.append(Tok("string", v[1:-1].replace("''", "'"), m.start()))
        else:
            toks.append(Tok(kind, v, m.start()))
    toks.append(Tok("eof", "", n))
    return toks


# ── parser ─────────────────────────────────────────────────────────────────


class _Parser:
    def __init__(self, text: str):
        self.text = text
        self.toks = _lex(text)
        self.i = 0
        self.n_params = 0  # '?' placeholders seen, numbered lexically

    # token helpers -------------------------------------------------------
    def peek(self, k: int = 0) -> Tok:
        return self.toks[min(self.i + k, len(self.toks) - 1)]

    def next(self) -> Tok:
        t = self.toks[self.i]
        self.i += 1
        return t

    def at_kw(self, *words: str) -> bool:
        t = self.peek()
        return t.kind == "kw" and t.value in words

    def take_kw(self, *words: str) -> bool:
        if self.at_kw(*words):
            self.next()
            return True
        return False

    def expect_kw(self, word: str):
        if not self.take_kw(word):
            self.error(f"expected {word.upper()}")

    def at_op(self, *ops: str) -> bool:
        t = self.peek()
        return t.kind == "op" and t.value in ops

    def take_op(self, *ops: str) -> bool:
        if self.at_op(*ops):
            self.next()
            return True
        return False

    def expect_op(self, op: str):
        if not self.take_op(op):
            self.error(f"expected {op!r}")

    def error(self, msg: str):
        t = self.peek()
        ctx = self.text[max(0, t.pos - 20) : t.pos + 20]
        raise SqlError(f"{msg} at position {t.pos} near {ctx!r} (got {t.value!r})")

    # query ---------------------------------------------------------------
    def parse_query(self) -> QueryExpr:
        ctes: List[Tuple[str, Optional[List[str]], QueryExpr]] = []
        if self.take_kw("with"):
            while True:
                name = self.ident()
                cols = None
                if self.take_op("("):
                    cols = [self.ident()]
                    while self.take_op(","):
                        cols.append(self.ident())
                    self.expect_op(")")
                self.expect_kw("as")
                self.expect_op("(")
                sub = self.parse_query()
                self.expect_op(")")
                ctes.append((name, cols, sub))
                if not self.take_op(","):
                    break
        body = self.parse_set_expr()
        order: List[OrderItem] = []
        limit = None
        if self.at_kw("order"):
            self.next()
            self.expect_kw("by")
            order = [self.parse_order_item()]
            while self.take_op(","):
                order.append(self.parse_order_item())
        if self.take_kw("limit"):
            t = self.next()
            if t.kind != "number":
                self.error("expected LIMIT count")
            limit = int(t.value)
        return QueryExpr(body, ctes, order, limit)

    def parse_order_item(self) -> OrderItem:
        e = self.parse_expr()
        asc = True
        if self.take_kw("desc"):
            asc = False
        else:
            self.take_kw("asc")
        nf = None
        if self.take_kw("nulls"):
            if self.take_kw("first"):
                nf = True
            elif self.take_kw("last"):
                nf = False
            else:
                self.error("expected FIRST or LAST")
        return OrderItem(e, asc, nf)

    def parse_set_expr(self):
        left = self.parse_select_core()
        while self.at_kw("union", "intersect", "except"):
            op = self.next().value
            all_ = self.take_kw("all")
            self.take_kw("distinct")
            right = self.parse_select_core()
            left = SetOp(op, all_, left, right)
        return left

    def parse_select_core(self):
        if self.at_op("("):
            # parenthesized query as a set-op operand
            self.expect_op("(")
            q = self.parse_query()
            self.expect_op(")")
            return q
        self.expect_kw("select")
        sel = Select()
        sel.distinct = self.take_kw("distinct")
        self.take_kw("all")
        sel.items = [self.parse_select_item()]
        while self.take_op(","):
            sel.items.append(self.parse_select_item())
        if self.take_kw("from"):
            sel.from_items = [self.parse_from_item()]
            while self.take_op(","):
                sel.from_items.append(self.parse_from_item())
        if self.take_kw("where"):
            sel.where = self.parse_expr()
        if self.at_kw("group"):
            self.next()
            self.expect_kw("by")
            self.parse_group_by(sel)
        if self.take_kw("having"):
            sel.having = self.parse_expr()
        return sel

    def parse_group_by(self, sel: Select):
        if self.at_kw("rollup", "cube"):
            mode = self.next().value
            self.expect_op("(")
            exprs = [self.parse_expr()]
            while self.take_op(","):
                exprs.append(self.parse_expr())
            self.expect_op(")")
            sel.group_by, sel.group_mode = exprs, mode
            return
        if self.at_kw("grouping"):
            self.next()
            self.expect_kw("sets")
            self.expect_op("(")
            sets: List[List[Node]] = []
            while True:
                self.expect_op("(")
                one: List[Node] = []
                if not self.at_op(")"):
                    one = [self.parse_expr()]
                    while self.take_op(","):
                        one.append(self.parse_expr())
                self.expect_op(")")
                sets.append(one)
                if not self.take_op(","):
                    break
            self.expect_op(")")
            # flattened distinct expr list preserves first-appearance order
            flat: List[Node] = []
            for s in sets:
                for e in s:
                    if e not in flat:
                        flat.append(e)
            sel.group_by, sel.group_mode, sel.group_sets = flat, "sets", sets
            return
        sel.group_by = [self.parse_expr()]
        while self.take_op(","):
            sel.group_by.append(self.parse_expr())

    def parse_select_item(self) -> Tuple[Node, Optional[str]]:
        if self.at_op("*"):
            self.next()
            return Node("star"), None
        # qualified star: ident . *
        if (
            self.peek().kind == "ident"
            and self.peek(1).kind == "op"
            and self.peek(1).value == "."
            and self.peek(2).kind == "op"
            and self.peek(2).value == "*"
        ):
            q = self.next().value
            self.next()
            self.next()
            return Node("qstar", q=q), None
        e = self.parse_expr()
        alias = None
        if self.take_kw("as"):
            alias = self.ident()
        elif self.peek().kind == "ident":
            alias = self.next().value
        return e, alias

    def ident(self) -> str:
        t = self.peek()
        if t.kind == "ident":
            return self.next().value
        # soft keywords usable as aliases/names in TPC texts
        if t.kind == "kw" and t.value in (
            "date", "timestamp", "first", "last", "year", "row", "range",
            "current", "sets",
        ):
            return self.next().value
        self.error("expected identifier")

    # FROM ----------------------------------------------------------------
    def parse_from_item(self):
        left = self.parse_table_primary()
        while True:
            how = None
            if self.take_kw("cross"):
                self.expect_kw("join")
                how = "cross"
            elif self.at_kw("join"):
                self.next()
                how = "inner"
            elif self.at_kw("inner") and self.peek(1).value == "join":
                self.next(), self.next()
                how = "inner"
            elif self.at_kw("left", "right", "full") and self.peek(1).value in (
                "join",
                "outer",
                "semi",
                "anti",
            ):
                base = self.next().value
                if self.take_kw("outer"):
                    how = base
                elif self.take_kw("semi"):
                    how = "left_semi"
                elif self.take_kw("anti"):
                    how = "left_anti"
                else:
                    how = base
                self.expect_kw("join")
            else:
                return left
            right = self.parse_table_primary()
            cond = None
            using_cols = None
            if how != "cross":
                if self.take_kw("on"):
                    cond = self.parse_expr()
                elif self.take_kw("using"):
                    self.expect_op("(")
                    using_cols = [self.ident()]
                    while self.take_op(","):
                        using_cols.append(self.ident())
                    self.expect_op(")")
            j = JoinRel(left, right, how, cond)
            if using_cols is not None:
                j.cond = Node("using", cols=using_cols)
            left = j

    def parse_table_primary(self):
        if self.take_op("("):
            q = self.parse_query()
            self.expect_op(")")
            alias, cols = self.parse_alias_clause()
            return SubqueryRef(q, alias, cols)
        name = self.ident()
        alias, _cols = self.parse_alias_clause()
        return TableRef(name, alias)

    def parse_alias_clause(self):
        alias, cols = None, None
        if self.take_kw("as"):
            alias = self.ident()
        elif self.peek().kind == "ident":
            alias = self.next().value
        if alias is not None and self.at_op("(") and self._looks_like_col_list():
            self.expect_op("(")
            cols = [self.ident()]
            while self.take_op(","):
                cols.append(self.ident())
            self.expect_op(")")
        return alias, cols

    def _looks_like_col_list(self) -> bool:
        # disambiguate "alias (c1, c2)" from a following parenthesized join
        j = self.i + 1
        depth = 1
        while j < len(self.toks) and depth:
            t = self.toks[j]
            if t.kind == "op" and t.value == "(":
                return False
            if t.kind == "op" and t.value == ")":
                depth -= 1
            elif t.kind not in ("ident", "op") or (
                t.kind == "op" and t.value not in (",",)
            ):
                return False
            j += 1
        return depth == 0

    # expressions ---------------------------------------------------------
    def parse_expr(self) -> Node:
        return self.parse_or()

    def parse_or(self) -> Node:
        left = self.parse_and()
        while self.take_kw("or"):
            left = Node("or", l=left, r=self.parse_and())
        return left

    def parse_and(self) -> Node:
        left = self.parse_not()
        while self.take_kw("and"):
            left = Node("and", l=left, r=self.parse_not())
        return left

    def parse_not(self) -> Node:
        if self.take_kw("not"):
            return Node("not", e=self.parse_not())
        return self.parse_predicate()

    def parse_predicate(self) -> Node:
        if self.at_kw("exists"):
            self.next()
            self.expect_op("(")
            q = self.parse_query()
            self.expect_op(")")
            return Node("exists", query=q, negated=False)
        left = self.parse_additive()
        while True:
            if self.at_op("=", "<>", "!=", "<", "<=", ">", ">="):
                op = self.next().value
                right = self.parse_additive()
                left = Node("cmp", op=op, l=left, r=right)
                continue
            negated = False
            save = self.i
            if self.take_kw("not"):
                negated = True
            if self.take_kw("between"):
                lo = self.parse_additive()
                self.expect_kw("and")
                hi = self.parse_additive()
                left = Node("between", e=left, lo=lo, hi=hi, negated=negated)
                continue
            if self.take_kw("like"):
                pat = self.parse_additive()
                left = Node("like", e=left, pat=pat, negated=negated)
                continue
            if self.take_kw("in"):
                self.expect_op("(")
                if self.at_kw("select", "with"):
                    q = self.parse_query()
                    self.expect_op(")")
                    left = Node("in_query", e=left, query=q, negated=negated)
                else:
                    vals = [self.parse_expr()]
                    while self.take_op(","):
                        vals.append(self.parse_expr())
                    self.expect_op(")")
                    left = Node("in_list", e=left, values=vals, negated=negated)
                continue
            if negated:
                self.i = save  # the NOT belonged to something else
                break
            if self.take_kw("is"):
                neg = self.take_kw("not")
                self.expect_kw("null")
                left = Node("isnull", e=left, negated=neg)
                continue
            break
        return left

    def parse_additive(self) -> Node:
        left = self.parse_multiplicative()
        while True:
            if self.at_op("+", "-"):
                op = self.next().value
                left = Node("binop", op=op, l=left, r=self.parse_multiplicative())
            elif self.at_op("||"):
                self.next()
                left = Node("concat", l=left, r=self.parse_multiplicative())
            else:
                return left

    def parse_multiplicative(self) -> Node:
        left = self.parse_unary()
        while self.at_op("*", "/", "%"):
            op = self.next().value
            left = Node("binop", op=op, l=left, r=self.parse_unary())
        return left

    def parse_unary(self) -> Node:
        if self.take_op("-"):
            return Node("neg", e=self.parse_unary())
        if self.take_op("+"):
            return self.parse_unary()
        return self.parse_primary()

    def parse_primary(self) -> Node:
        t = self.peek()
        if t.kind == "number":
            self.next()
            v = t.value
            if "." in v or "e" in v or "E" in v:
                return Node("lit", value=float(v))
            return Node("lit", value=int(v))
        if t.kind == "string":
            self.next()
            return Node("lit", value=t.value)
        if self.at_op("?"):
            # positional parameter placeholder (PREPARE/BIND): numbered in
            # lexical order; bind_parameters substitutes literal nodes
            self.next()
            idx = self.n_params
            self.n_params += 1
            return Node("param", index=idx)
        if self.at_kw("null"):
            self.next()
            return Node("lit", value=None)
        if self.at_kw("true"):
            self.next()
            return Node("lit", value=True)
        if self.at_kw("false"):
            self.next()
            return Node("lit", value=False)
        if self.at_kw("date") and self.peek(1).kind == "string":
            self.next()
            return Node("datelit", s=self.next().value)
        if self.at_kw("timestamp") and self.peek(1).kind == "string":
            self.next()
            return Node("tslit", s=self.next().value)
        if self.at_kw("interval"):
            self.next()
            t2 = self.next()
            if t2.kind == "string":
                n = t2.value
            elif t2.kind == "number":
                n = t2.value
            else:
                self.error("expected INTERVAL amount")
            unit = self.next().value.lower().rstrip("s")
            return Node("interval", n=n, unit=unit)
        if self.at_kw("case"):
            return self.parse_case()
        if self.at_kw("cast"):
            self.next()
            self.expect_op("(")
            e = self.parse_expr()
            self.expect_kw("as")
            ty = self.parse_type_name()
            self.expect_op(")")
            return Node("cast", e=e, type=ty)
        if self.at_kw("extract"):
            self.next()
            self.expect_op("(")
            fld = self.next().value.lower()
            self.expect_kw("from")
            e = self.parse_expr()
            self.expect_op(")")
            return Node("extract", field=fld, e=e)
        if self.at_op("("):
            self.next()
            if self.at_kw("select", "with"):
                q = self.parse_query()
                self.expect_op(")")
                return Node("scalar_query", query=q)
            e = self.parse_expr()
            self.expect_op(")")
            return e
        if t.kind in ("ident", "kw"):
            return self.parse_name_or_call()
        self.error("expected expression")

    def parse_case(self) -> Node:
        self.expect_kw("case")
        operand = None
        if not self.at_kw("when"):
            operand = self.parse_expr()
        whens = []
        while self.take_kw("when"):
            c = self.parse_expr()
            self.expect_kw("then")
            v = self.parse_expr()
            whens.append((c, v))
        else_ = None
        if self.take_kw("else"):
            else_ = self.parse_expr()
        self.expect_kw("end")
        return Node("case", operand=operand, whens=whens, else_=else_)

    def parse_type_name(self) -> str:
        parts = [self.next().value]
        if parts[0] == "double" and self.peek().value == "precision":
            self.next()
        if self.take_op("("):
            args = [self.next().value]
            while self.take_op(","):
                args.append(self.next().value)
            self.expect_op(")")
            parts.append("(" + ",".join(args) + ")")
        return "".join(parts)

    def parse_name_or_call(self) -> Node:
        name = self.ident_or_funcword()
        if self.take_op("."):
            col = self.ident_or_funcword()
            return Node("col", name=col, qualifier=name)
        if not self.at_op("("):
            return Node("col", name=name, qualifier=None)
        # function call
        self.expect_op("(")
        distinct = False
        args: List[Node] = []
        star = False
        if self.at_op("*"):
            self.next()
            star = True
        elif not self.at_op(")"):
            distinct = self.take_kw("distinct")
            args = [self.parse_expr()]
            while self.take_op(","):
                args.append(self.parse_expr())
        self.expect_op(")")
        fn = Node("func", name=name, args=args, distinct=distinct, star=star)
        if self.at_kw("over"):
            self.next()
            return self.parse_over(fn)
        return fn

    def ident_or_funcword(self) -> str:
        t = self.peek()
        if t.kind == "ident":
            return self.next().value
        if t.kind == "kw" and t.value in (
            "date", "timestamp", "first", "last", "grouping", "current",
            "left", "right", "year", "row", "range", "sets",
        ):
            return self.next().value
        self.error("expected name")

    def parse_over(self, fn: Node) -> Node:
        self.expect_op("(")
        partition: List[Node] = []
        order: List[OrderItem] = []
        frame = None
        if self.take_kw("partition"):
            self.expect_kw("by")
            partition = [self.parse_expr()]
            while self.take_op(","):
                partition.append(self.parse_expr())
        if self.at_kw("order"):
            self.next()
            self.expect_kw("by")
            order = [self.parse_order_item()]
            while self.take_op(","):
                order.append(self.parse_order_item())
        if self.at_kw("rows", "range"):
            kind = self.next().value
            if self.take_kw("between"):
                start = self.parse_frame_bound()
                self.expect_kw("and")
                end = self.parse_frame_bound()
            else:
                start = self.parse_frame_bound()
                end = ("current", 0)
            frame = Node("frame", fkind=kind, start=start, end=end)
        self.expect_op(")")
        return Node("window", fn=fn, partition=partition, order=order, frame=frame)

    def parse_frame_bound(self):
        if self.take_kw("unbounded"):
            if self.take_kw("preceding"):
                return ("unbounded_preceding", None)
            self.expect_kw("following")
            return ("unbounded_following", None)
        if self.take_kw("current"):
            self.expect_kw("row")
            return ("current", 0)
        t = self.next()
        if t.kind != "number":
            self.error("expected frame bound")
        n = int(t.value)
        if self.take_kw("preceding"):
            return ("preceding", n)
        self.expect_kw("following")
        return ("following", n)


def parse(text: str) -> QueryExpr:
    """Parse one SELECT statement (a trailing ';' is tolerated)."""
    p = _Parser(text)
    q = p.parse_query()
    p.take_op(";")
    if p.peek().kind != "eof":
        p.error("unexpected trailing input")
    q.n_params = p.n_params
    return q


# ── parameter binding (PREPARE/BIND) ───────────────────────────────────────


def _map_ast(obj, fn):
    """Structural copy-transform over the query AST: ``fn`` maps Nodes (a
    changed node is taken as-is, an unchanged one recurses into its
    payload); dataclasses, lists, and tuples rebuild around the mapped
    children. Non-mutating — a prepared statement's AST is bound many
    times with different values."""
    import dataclasses as _dc

    if isinstance(obj, Node):
        mapped = fn(obj)
        if mapped is not obj:
            return mapped
        return Node(obj.kind, **{k: _map_ast(v, fn) for k, v in obj.f.items()})
    if isinstance(obj, list):
        return [_map_ast(x, fn) for x in obj]
    if isinstance(obj, tuple):
        return tuple(_map_ast(x, fn) for x in obj)
    if _dc.is_dataclass(obj) and not isinstance(obj, type):
        return _dc.replace(
            obj,
            **{
                f.name: _map_ast(getattr(obj, f.name), fn)
                for f in _dc.fields(obj)
            },
        )
    return obj


def _param_literal(v) -> Node:
    """One bound value → its literal AST node. This is SUBSTITUTION AT THE
    AST LEVEL, never text splicing: a string value containing quotes or
    SQL fragments stays one literal — injection-shaped inputs cannot
    change the query's structure. Python types coerce to their natural SQL
    literal (bool/int/float/str/None; date/datetime to the typed
    literals)."""
    import datetime as _dt

    if v is None or isinstance(v, (bool, int, float, str)):
        return Node("lit", value=v)
    # datetime first: datetime.datetime subclasses datetime.date
    if isinstance(v, _dt.datetime):
        return Node("tslit", s=v.isoformat(sep=" "))
    if isinstance(v, _dt.date):
        return Node("datelit", s=v.isoformat())
    raise SqlError(
        f"unsupported parameter type {type(v).__name__} "
        "(supported: None, bool, int, float, str, date, datetime)"
    )


def bind_parameters(query: QueryExpr, params) -> QueryExpr:
    """Substitute the query's ``?`` placeholders with literal values, in
    lexical order. Exactly ``query.n_params`` values are required; the
    result is a new, fully-bound AST (the input is untouched, so a
    prepared statement re-binds freely)."""
    values = list(params)
    n = getattr(query, "n_params", 0)
    if len(values) != n:
        raise SqlError(
            f"query has {n} parameter placeholder(s) but {len(values)} "
            "value(s) were bound"
        )

    def fix(node: Node):
        if node.kind == "param":
            return _param_literal(values[node.f["index"]])
        return node

    return _map_ast(query, fix)
