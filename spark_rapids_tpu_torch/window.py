"""Window spec builder — the pyspark ``Window`` API surface.

Usage::

    from spark_rapids_tpu_torch.window import Window
    w = Window.partition_by("k").order_by("ts").rows_between(-3, Window.currentRow)
    df.with_column("s", F.sum(F.col("v")).over(w))

Copied from ``spark_rapids_tpu/window.py``.
"""
from __future__ import annotations

from typing import Union

from .expr.windows import (
    CURRENT_ROW,
    UNBOUNDED_FOLLOWING,
    UNBOUNDED_PRECEDING,
    WindowFrame,
    WindowOrder,
    WindowSpec,
)
from .expr import UnresolvedAttribute
from .functions import Column, _e


def _c2e(c):
    """Column-name semantics: strings are column references, not literals."""
    if isinstance(c, str):
        return UnresolvedAttribute(c)
    return _e(c)


def _to_orders(cols) -> tuple:
    orders = []
    for c in cols:
        if isinstance(c, WindowOrder):
            orders.append(c)
            continue
        if isinstance(c, Column) and getattr(c, "_sort_desc", False):
            orders.append(WindowOrder(_c2e(c), False, None))
            continue
        orders.append(WindowOrder(_c2e(c), True, None))
    return tuple(orders)


class WindowSpecBuilder:
    def __init__(self, spec: WindowSpec):
        self.spec = spec

    def partition_by(self, *cols) -> "WindowSpecBuilder":
        return WindowSpecBuilder(
            WindowSpec(tuple(_c2e(c) for c in cols), self.spec.order_by, self.spec.frame)
        )

    def order_by(self, *cols) -> "WindowSpecBuilder":
        return WindowSpecBuilder(
            WindowSpec(self.spec.partition_by, _to_orders(cols), self.spec.frame)
        )

    def rows_between(self, start: int, end: int) -> "WindowSpecBuilder":
        return WindowSpecBuilder(
            WindowSpec(
                self.spec.partition_by,
                self.spec.order_by,
                WindowFrame("rows", int(start), int(end)),
            )
        )

    def range_between(self, start: int, end: int) -> "WindowSpecBuilder":
        return WindowSpecBuilder(
            WindowSpec(
                self.spec.partition_by,
                self.spec.order_by,
                WindowFrame("range", int(start), int(end)),
            )
        )


class Window:
    unboundedPreceding = UNBOUNDED_PRECEDING
    unboundedFollowing = UNBOUNDED_FOLLOWING
    currentRow = CURRENT_ROW
    # snake_case aliases
    unbounded_preceding = UNBOUNDED_PRECEDING
    unbounded_following = UNBOUNDED_FOLLOWING
    current_row = CURRENT_ROW

    @staticmethod
    def partition_by(*cols) -> WindowSpecBuilder:
        return WindowSpecBuilder(WindowSpec()).partition_by(*cols)

    partitionBy = partition_by

    @staticmethod
    def order_by(*cols) -> WindowSpecBuilder:
        return WindowSpecBuilder(WindowSpec()).order_by(*cols)

    orderBy = order_by
