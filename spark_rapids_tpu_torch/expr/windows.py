"""Window expressions — reference: GpuWindowExpression.scala (831 LoC;
rows & range frames, rank/rownumber/lead/lag) and GpuWindowExec.scala.

A ``WindowExpression`` pairs a window function (ranking, lead/lag, or an
aggregate) with a ``WindowSpec`` (partition keys, ordering, frame). Spark
frame semantics implemented:

* default frame: RANGE UNBOUNDED PRECEDING..CURRENT ROW when ordered,
  ROWS UNBOUNDED..UNBOUNDED otherwise;
* ranking functions always use the whole-partition ordering and ignore the
  frame; rank/dense_rank rank *peer groups* (rows equal on the order keys);
* RANGE CURRENT ROW bounds include the full peer group.

Copied from ``spark_rapids_tpu/expr/windows.py``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

from ..types import DataType, IntegerType, INT, LONG
from .base import Expression, Literal, to_expr

# Spark's Window.unboundedPreceding/Following sentinels
UNBOUNDED_PRECEDING = -(1 << 62)
UNBOUNDED_FOLLOWING = 1 << 62
CURRENT_ROW = 0


@dataclass(frozen=True)
class WindowOrder:
    """Ordering inside a window spec (SortOrder twin, kept here to avoid an
    expr→plan import cycle)."""

    child: Expression
    ascending: bool = True
    nulls_first: Optional[bool] = None

    def resolved_nulls_first(self) -> bool:
        # Spark default: nulls first for ASC, nulls last for DESC
        if self.nulls_first is None:
            return self.ascending
        return self.nulls_first

    def __str__(self):
        d = "ASC" if self.ascending else "DESC"
        nf = "NULLS FIRST" if self.resolved_nulls_first() else "NULLS LAST"
        return f"{self.child} {d} {nf}"


@dataclass(frozen=True)
class WindowFrame:
    frame_type: str  # "rows" | "range"
    lower: int  # <= 0 preceding; sentinels above
    upper: int

    def scaled_for_decimal(self, order_dt) -> "WindowFrame":
        """RANGE offsets over a decimal order key compare against the
        UNSCALED int64 representation: scale the integer bounds by
        10^scale (5 PRECEDING over decimal(_,2) means 500 unscaled).
        Shared by the device and CPU window execs so the oracle cannot
        diverge from the device path."""
        from ..types import DecimalType

        if not isinstance(order_dt, DecimalType):
            return self
        import dataclasses as _dc

        pow10 = 10 ** order_dt.scale
        sent = (UNBOUNDED_PRECEDING, CURRENT_ROW, UNBOUNDED_FOLLOWING)
        return _dc.replace(
            self,
            lower=self.lower if self.lower in sent else self.lower * pow10,
            upper=self.upper if self.upper in sent else self.upper * pow10,
        )

    def _b(self, v, pre):
        if v == UNBOUNDED_PRECEDING:
            return "UNBOUNDED PRECEDING"
        if v == UNBOUNDED_FOLLOWING:
            return "UNBOUNDED FOLLOWING"
        if v == 0:
            return "CURRENT ROW"
        return f"{-v} PRECEDING" if v < 0 else f"{v} FOLLOWING"

    def __str__(self):
        return (
            f"{self.frame_type.upper()} BETWEEN {self._b(self.lower, True)} "
            f"AND {self._b(self.upper, False)}"
        )


@dataclass(frozen=True)
class WindowSpec:
    partition_by: Tuple[Expression, ...] = ()
    order_by: Tuple[WindowOrder, ...] = ()
    frame: Optional[WindowFrame] = None  # None → Spark default

    def resolved_frame(self) -> WindowFrame:
        if self.frame is not None:
            return self.frame
        if self.order_by:
            return WindowFrame("range", UNBOUNDED_PRECEDING, CURRENT_ROW)
        return WindowFrame("rows", UNBOUNDED_PRECEDING, UNBOUNDED_FOLLOWING)


# ── window functions without an aggregate analogue ─────────────────────────


@dataclass(frozen=True)
class RankingFunction(Expression):
    """Base for row_number/rank/dense_rank/ntile."""

    @property
    def data_type(self) -> DataType:
        return INT

    @property
    def nullable(self) -> bool:
        return False

    def children(self):
        return []


@dataclass(frozen=True)
class RowNumber(RankingFunction):
    def __str__(self):
        return "row_number()"


@dataclass(frozen=True)
class Rank(RankingFunction):
    def __str__(self):
        return "rank()"


@dataclass(frozen=True)
class DenseRank(RankingFunction):
    def __str__(self):
        return "dense_rank()"


@dataclass(frozen=True)
class PercentRank(RankingFunction):
    """(rank − 1) / (partition rows − 1); 0.0 for single-row partitions."""

    @property
    def data_type(self) -> DataType:
        from ..types import DOUBLE

        return DOUBLE

    def __str__(self):
        return "percent_rank()"


@dataclass(frozen=True)
class CumeDist(RankingFunction):
    """rows ≤ current peer group / partition rows."""

    @property
    def data_type(self) -> DataType:
        from ..types import DOUBLE

        return DOUBLE

    def __str__(self):
        return "cume_dist()"


@dataclass(frozen=True)
class NTile(RankingFunction):
    """Spark NTile: n rows into ``buckets`` groups; the first n % buckets
    groups get one extra row."""

    buckets: int

    def __str__(self):
        return f"ntile({self.buckets})"


@dataclass(frozen=True)
class Lead(Expression):
    child: Expression
    offset: int = 1
    default: Expression = field(default_factory=lambda: Literal(None))

    @property
    def data_type(self) -> DataType:
        return self.child.data_type

    @property
    def nullable(self) -> bool:
        return True

    def children(self):
        return [self.child, self.default]

    def __str__(self):
        return f"lead({self.child}, {self.offset})"


@dataclass(frozen=True)
class Lag(Expression):
    child: Expression
    offset: int = 1
    default: Expression = field(default_factory=lambda: Literal(None))

    @property
    def data_type(self) -> DataType:
        return self.child.data_type

    @property
    def nullable(self) -> bool:
        return True

    def children(self):
        return [self.child, self.default]

    def __str__(self):
        return f"lag({self.child}, {self.offset})"


@dataclass(frozen=True)
class WindowExpression(Expression):
    """function OVER (spec) — the planner pulls these out of projections into
    a Window node (Spark's ExtractWindowExpressions)."""

    function: Expression
    spec: WindowSpec

    @property
    def data_type(self) -> DataType:
        return self.function.data_type

    @property
    def nullable(self) -> bool:
        return getattr(self.function, "nullable", True)

    def children(self):
        return [self.function]

    def __str__(self):
        parts = []
        if self.spec.partition_by:
            parts.append(
                "PARTITION BY " + ", ".join(map(str, self.spec.partition_by))
            )
        if self.spec.order_by:
            parts.append("ORDER BY " + ", ".join(map(str, self.spec.order_by)))
        parts.append(str(self.spec.resolved_frame()))
        return f"{self.function} OVER ({' '.join(parts)})"


def contains_window(e: Expression) -> bool:
    if isinstance(e, WindowExpression):
        return True
    return any(contains_window(c) for c in e.children())
