"""TPC-H queries as DataFrame functions, and the port's own slice queries.

Copied from ``spark_rapids_tpu/tpch/queries.py``: ``q1`` and ``q6`` as the
JAX package writes them. The other 20 need joins and top-N on the device
and come with later slices of the port (ROADMAP.md, Queue A).
``contains_agg`` and ``contains_rows`` put ``Column.contains`` — and with it
the hand-written ``match_starts`` kernel — on the main path, once fused into
an aggregate and once as a standalone filter whose rows (strings included)
come back to the host. ``orders_by_priority`` sorts all of ``orders`` by a
string, a descending double and a long key: q1's own sort sees only its
four groups, so this query is what puts the device sort to work at full
size. ``q18_big_orders`` is q18's inner aggregate, sorted: over several
partitions its partial aggregates hold a group per order, so it puts a
full-size hash exchange on a long key to work (q1's exchange moves four
groups). ``union_limit`` unions two filtered lineitem scans and takes the
first 100,000 rows, in partition order.

Each function takes ``t`` — a ``name -> DataFrame`` accessor — and returns an
un-collected DataFrame.
"""
from __future__ import annotations

from datetime import date as D

from .. import functions as F
from ..functions import col, count, lit


def q1(t):
    li = t("lineitem")
    disc_price = col("l_extendedprice") * (1 - col("l_discount"))
    return (
        li.filter(col("l_shipdate") <= D(1998, 9, 2))
        .group_by("l_returnflag", "l_linestatus")
        .agg(
            F.sum(col("l_quantity")).alias("sum_qty"),
            F.sum(col("l_extendedprice")).alias("sum_base_price"),
            F.sum(disc_price).alias("sum_disc_price"),
            F.sum(disc_price * (1 + col("l_tax"))).alias("sum_charge"),
            F.avg(col("l_quantity")).alias("avg_qty"),
            F.avg(col("l_extendedprice")).alias("avg_price"),
            F.avg(col("l_discount")).alias("avg_disc"),
            count("*").alias("count_order"),
        )
        .order_by("l_returnflag", "l_linestatus")
    )


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


def orders_by_priority(t):
    """Every order's key, priority and price, by priority, then the dearest
    first, then by key."""
    return (
        t("orders")
        .select("o_orderkey", "o_orderpriority", "o_totalprice")
        .order_by(col("o_orderpriority"), col("o_totalprice").desc(), col("o_orderkey"))
    )


def q18_big_orders(t):
    """q18's inner aggregate: the orders whose lines hold more than 300
    units, by key."""
    return (
        t("lineitem").select("l_orderkey", "l_quantity")
        .group_by("l_orderkey")
        .agg(F.sum(col("l_quantity")).alias("o_qty"))
        .filter(col("o_qty") > 300)
        .select(col("l_orderkey").alias("big_okey"))
        .order_by("big_okey")
    )


def union_limit(t):
    """The first 100,000 lines shipped by air, then by regular air."""
    li = t("lineitem")
    cols = ("l_orderkey", "l_partkey", "l_quantity", "l_shipmode")
    air = li.filter(col("l_shipmode") == "AIR").select(*cols)
    reg = li.filter(col("l_shipmode") == "REG AIR").select(*cols)
    return air.union(reg).limit(100000)


#: the slice's queries, by name, with the tables each reads
SLICE_QUERIES = {
    "q1": (q1, ("lineitem",)),
    "q6": (q6, ("lineitem",)),
    "contains_agg": (contains_agg, ("orders",)),
    "contains_rows": (contains_rows, ("orders",)),
    "orders_by_priority": (orders_by_priority, ("orders",)),
    "q18_big_orders": (q18_big_orders, ("lineitem",)),
    "union_limit": (union_limit, ("lineitem",)),
}
