"""Scalar subqueries, IN (subquery), and large-set membership.

Reference: GpuScalarSubquery.scala (the plugin executes the subquery plan
and inlines its single value) and GpuInSet.scala (set membership compiled
against a literal value set instead of an OR chain). TPC-DS leans on both
(`where x in (select ...)`, `where y > (select avg ...)`).

Execution model mirrors Spark's: subqueries run BEFORE the main query —
the session's resolution pass (`TorchSession._resolve_subqueries`) executes
each subquery plan through the full engine and replaces

    ScalarSubquery(plan)   → Literal(value)
    InSubquery(c, plan)    → InSet(c, sorted result values)

so the main query's kernels see only literals — no runtime plan nesting,
nothing dynamic under jit.

InSet's device path is ONE fused vectorized membership test: numerics
binary-search a sorted constant array (`searchsorted`); strings compare
against a stacked [k, w] byte matrix in k-chunks (bounded program size).
Null semantics match Spark's IN: NULL input → NULL; no match with a null
in the set → NULL.

Copied from ``spark_rapids_tpu/expr/subquery.py``; ``_encode_values`` also
takes the UTC-aware timestamps the port's ``collect()`` returns.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

from ..types import BOOLEAN, BooleanType, DataType, StringType
from .base import Ctx, Expression, Val


@dataclass(frozen=True)
class ScalarSubquery(Expression):
    """A single-value subquery; resolved to a Literal before planning."""

    plan: object  # LogicalPlan (untyped to avoid the import cycle)

    @property
    def data_type(self) -> DataType:
        return self.plan.schema.fields[0].data_type

    @property
    def nullable(self) -> bool:
        return True  # empty subquery result is NULL

    def children(self):
        return []

    def eval(self, ctx: Ctx) -> Val:
        raise RuntimeError(
            "unresolved scalar subquery reached execution — "
            "TorchSession._resolve_subqueries must run first"
        )

    def __str__(self):
        return "scalar-subquery#(...)"


@dataclass(frozen=True)
class InSubquery(Expression):
    """``c IN (subquery)``; resolved to InSet before planning."""

    c: Expression
    plan: object

    @property
    def data_type(self) -> DataType:
        return BOOLEAN

    def eval(self, ctx: Ctx) -> Val:
        raise RuntimeError(
            "unresolved IN-subquery reached execution — "
            "TorchSession._resolve_subqueries must run first"
        )

    def __str__(self):
        return f"{self.c} IN (subquery)"


_STR_CHUNK = 64  # set values compared per fused chunk (bounds [n,chunk,w])


@dataclass(frozen=True)
class InSet(Expression):
    """Membership in a literal value set (GpuInSet analogue).

    ``values`` holds python values (may include None). Unlike ``In`` —
    whose per-item OR chain is right for short hand-written lists — the
    whole set compiles to constant arrays: one ``searchsorted`` for
    numerics, chunked matrix equality for strings."""

    c: Expression
    values: Tuple

    @property
    def data_type(self) -> DataType:
        return BOOLEAN

    def eval(self, ctx: Ctx) -> Val:
        xp = ctx.xp
        v = self.c.eval(ctx)
        has_null = any(x is None for x in self.values)
        nn = [x for x in self.values if x is not None]
        dt = self.c.data_type
        if not nn:
            match = xp.zeros((ctx.n,), dtype=bool)
        elif isinstance(dt, StringType):
            match = self._str_match(ctx, v, nn)
        else:
            match = self._num_match(ctx, v, nn, dt)
        valid = v.full_valid(ctx)
        if has_null:
            valid = valid & match  # unmatched → NULL when the set has NULL
        return Val(match & valid, valid)

    def _num_match(self, ctx: Ctx, v: Val, nn: list, dt) -> "np.ndarray":
        xp = ctx.xp
        data = ctx.broadcast(v.data)
        if isinstance(dt, BooleanType):
            tv = any(x is True for x in nn)
            fv = any(x is False for x in nn)
            return (data & xp.asarray(tv)) | (~data & xp.asarray(fv))
        np_dt = dt.np_dtype
        arr = np.sort(np.asarray(self._encode_values(nn, dt), dtype=np_dt))
        sarr = xp.asarray(arr)
        pos = xp.searchsorted(sarr, data)
        pos_c = xp.clip(pos, 0, len(arr) - 1)
        return sarr[pos_c] == data

    @staticmethod
    def _encode_values(nn: list, dt) -> list:
        """Python values → the engine's physical representation."""
        from ..types import DateType, DecimalType, TimestampType

        if isinstance(dt, DecimalType):
            import decimal

            return [
                int(
                    decimal.Decimal(str(x)).scaleb(dt.scale).to_integral_value(
                        rounding=decimal.ROUND_HALF_UP
                    )
                )
                for x in nn
            ]
        if isinstance(dt, DateType):
            import datetime

            return [
                (x - datetime.date(1970, 1, 1)).days
                if isinstance(x, datetime.date)
                else int(x)
                for x in nn
            ]
        if isinstance(dt, TimestampType):
            import datetime

            out = []
            for x in nn:
                if isinstance(x, datetime.datetime):
                    # collect() gives UTC-aware values: subtract an epoch
                    # of the same awareness
                    epoch = datetime.datetime(1970, 1, 1, tzinfo=x.tzinfo)
                    # integer micros — total_seconds() is float64 and loses
                    # microsecond precision past ~2004
                    out.append((x - epoch) // datetime.timedelta(microseconds=1))
                else:
                    out.append(int(x))
            return out
        return nn

    def _str_match(self, ctx: Ctx, v: Val, nn: list):
        xp = ctx.xp
        if not ctx.is_device:
            s = set(nn)
            data = np.broadcast_to(np.asarray(v.data, dtype=object), (ctx.n,))
            return np.asarray([x in s for x in data])
        from .strings import dev_str

        ch, lengths = dev_str(ctx, v)
        w = ch.shape[1]
        enc = []
        for s in nn:
            b = s.encode("utf-8")
            enc.append((b[:w] + b"\x00" * max(0, w - len(b)), len(b)))
        match = xp.zeros((ctx.n,), dtype=bool)
        for i in range(0, len(enc), _STR_CHUNK):
            chunk = enc[i : i + _STR_CHUNK]
            setm = xp.asarray(
                np.frombuffer(
                    b"".join(c[0] for c in chunk), dtype=np.uint8
                ).reshape(len(chunk), w)
            )
            setl = xp.asarray(np.asarray([c[1] for c in chunk], dtype=np.int32))
            # values longer than the column's padded width can never match
            fits = xp.asarray(
                np.asarray([c[1] <= w for c in chunk], dtype=bool)
            )
            # bytes beyond each row's length are not guaranteed zeroed:
            # compare only positions < length (lengths must match anyway)
            pos_ok = (
                xp.arange(w, dtype=xp.int32)[None, None, :]
                >= lengths[:, None, None]
            )
            eq = ((ch[:, None, :] == setm[None, :, :]) | pos_ok).all(axis=2)
            eq = eq & (lengths[:, None] == setl[None, :]) & fits[None, :]
            match = match | eq.any(axis=1)
        return match

    def __str__(self):
        show = ", ".join(repr(x) for x in list(self.values)[:5])
        more = ", ..." if len(self.values) > 5 else ""
        return f"{self.c} INSET ({show}{more})"
