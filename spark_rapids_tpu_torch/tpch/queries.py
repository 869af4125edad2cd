"""TPC-H queries as DataFrame functions, and the string-search queries of the
port's first slice.

Copied from ``spark_rapids_tpu/tpch/queries.py``: ``q6`` as the JAX package
writes it. The other 21 need joins, grouped aggregation and sorts on the
device and come with later slices of the port (ROADMAP.md, Queue A).
``contains_agg`` and ``contains_rows`` are the slice's own queries: they put
``Column.contains`` — and with it the hand-written ``match_starts`` kernel —
on the main path, once fused into an aggregate and once as a standalone
filter whose rows (strings included) come back to the host.

Each function takes ``t`` — a ``name -> DataFrame`` accessor — and returns an
un-collected DataFrame.
"""
from __future__ import annotations

from datetime import date as D

from .. import functions as F
from ..functions import col, count, lit


def q6(t):
    return (
        t("lineitem")
        .filter(
            (col("l_shipdate") >= D(1994, 1, 1))
            & (col("l_shipdate") < D(1995, 1, 1))
            & (col("l_discount") >= 0.05)
            & (col("l_discount") <= 0.07)
            & (col("l_quantity") < 24)
        )
        .agg(F.sum(col("l_extendedprice") * col("l_discount")).alias("revenue"))
    )


def contains_agg(t):
    """Orders whose comment mentions "special": how many, and their total."""
    return (
        t("orders")
        .filter(col("o_comment").contains("special"))
        .agg(count(lit(1)), F.sum(col("o_totalprice")))
    )


def contains_rows(t):
    """The same orders, with their key, priority and comment."""
    return (
        t("orders")
        .filter(col("o_comment").contains("special"))
        .select("o_orderkey", "o_orderpriority", "o_comment")
    )


#: the slice's queries, by name, with the tables each reads
SLICE_QUERIES = {
    "q6": (q6, ("lineitem",)),
    "contains_agg": (contains_agg, ("orders",)),
    "contains_rows": (contains_rows, ("orders",)),
}
