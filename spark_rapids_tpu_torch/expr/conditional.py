"""Conditional expressions — reference: conditionalExpressions.scala,
nullExpressions.scala (coalesce/nvl).

Copied from ``spark_rapids_tpu/expr/conditional.py``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

from ..types import DataType, NullType, StringType
from .base import Ctx, Expression, Val


def _select(ctx: Ctx, cond, a: Val, b: Val, dtype: DataType) -> Val:
    """where(cond, a, b) handling device strings (pad to common width).
    A typeless NULL branch (un-coerced ``lit(None)``) materializes as an
    all-null string column here."""
    xp = ctx.xp
    condb = ctx.broadcast_bool(cond)
    if isinstance(dtype, StringType) and ctx.is_device:

        def as_str(v: Val) -> Val:
            if getattr(v.data, "ndim", 0) == 0 or v.lengths is None:
                from ..columnar.device import MIN_STR_WIDTH

                return Val(
                    xp.zeros((ctx.n, MIN_STR_WIDTH), dtype=xp.uint8),
                    xp.zeros(ctx.n, dtype=bool),
                    xp.zeros(ctx.n, dtype=xp.int32),
                )
            return v

        a, b = as_str(a), as_str(b)
        la = a.data if a.data.ndim == 2 else xp.broadcast_to(a.data[None, :], (ctx.n, a.data.shape[-1]))
        lb = b.data if b.data.ndim == 2 else xp.broadcast_to(b.data[None, :], (ctx.n, b.data.shape[-1]))
        w = max(la.shape[-1], lb.shape[-1])
        if la.shape[-1] < w:
            la = xp.pad(la, ((0, 0), (0, w - la.shape[-1])))
        if lb.shape[-1] < w:
            lb = xp.pad(lb, ((0, 0), (0, w - lb.shape[-1])))
        data = xp.where(condb[:, None], la, lb)
        lengths = xp.where(
            condb,
            xp.broadcast_to(xp.asarray(a.lengths), (ctx.n,)),
            xp.broadcast_to(xp.asarray(b.lengths), (ctx.n,)),
        )
        valid = xp.where(condb, a.full_valid(ctx), b.full_valid(ctx))
        return Val(data, valid, lengths)
    data = xp.where(condb, a.full_data(ctx), b.full_data(ctx))
    valid = xp.where(condb, a.full_valid(ctx), b.full_valid(ctx))
    return Val(data, valid)


@dataclass(frozen=True)
class If(Expression):
    pred: Expression
    t: Expression
    f: Expression

    @property
    def data_type(self) -> DataType:
        return self.t.data_type if not isinstance(self.t.data_type, NullType) else self.f.data_type

    @property
    def nullable(self) -> bool:
        return self.t.nullable or self.f.nullable

    def eval(self, ctx: Ctx) -> Val:
        p = self.pred.eval(ctx)
        cond = ctx.broadcast_bool(p.data) & p.full_valid(ctx)  # NULL pred → else
        # branch evals are scoped so ANSI error sites in the untaken branch
        # don't fire (Spark evaluates branches per-row)
        with ctx.error_scope(cond):
            tv = self.t.eval(ctx)
        with ctx.error_scope(~cond):
            fv = self.f.eval(ctx)
        return _select(ctx, cond, tv, fv, self.data_type)

    def __str__(self):
        return f"if({self.pred}, {self.t}, {self.f})"


@dataclass(frozen=True)
class CaseWhen(Expression):
    branches: Tuple[Tuple[Expression, Expression], ...]
    else_value: Expression

    def children(self):
        out = []
        for c, v in self.branches:
            out.extend([c, v])
        out.append(self.else_value)
        return out

    @property
    def data_type(self) -> DataType:
        for _, v in self.branches:
            if not isinstance(v.data_type, NullType):
                return v.data_type
        return self.else_value.data_type

    def eval(self, ctx: Ctx) -> Val:
        # effective (disjoint) branch masks, with conditions themselves
        # scoped by "no earlier branch matched" — Spark's per-row laziness
        # for ANSI error sites
        not_prev = None
        effs = []
        for cond_e, _ in self.branches:
            if not_prev is None:
                p = cond_e.eval(ctx)
            else:
                with ctx.error_scope(not_prev):
                    p = cond_e.eval(ctx)
            c = ctx.broadcast_bool(p.data) & p.full_valid(ctx)
            effs.append(c if not_prev is None else (c & not_prev))
            not_prev = ~c if not_prev is None else (not_prev & ~c)
        with ctx.error_scope(not_prev):
            result = self.else_value.eval(ctx)
        for eff, (_, val_e) in reversed(list(zip(effs, self.branches))):
            with ctx.error_scope(eff):
                v = val_e.eval(ctx)
            result = _select(ctx, eff, v, result, self.data_type)
        return result


@dataclass(frozen=True)
class Coalesce(Expression):
    exprs: Tuple[Expression, ...]

    @property
    def data_type(self) -> DataType:
        for e in self.exprs:
            if not isinstance(e.data_type, NullType):
                return e.data_type
        return self.exprs[0].data_type

    @property
    def nullable(self) -> bool:
        return all(e.nullable for e in self.exprs)

    def eval(self, ctx: Ctx) -> Val:
        # expr i is only consulted where all earlier exprs were null — scope
        # ANSI error sites accordingly (Spark short-circuits per-row)
        prev_null = None
        vals = []
        for e in self.exprs:
            if prev_null is None:
                v = e.eval(ctx)
            else:
                with ctx.error_scope(prev_null):
                    v = e.eval(ctx)
            vals.append(v)
            nv = ~v.full_valid(ctx)
            prev_null = nv if prev_null is None else (prev_null & nv)
        result = vals[-1]
        for v in reversed(vals[:-1]):
            result = _select(ctx, v.full_valid(ctx), v, result, self.data_type)
        return result
