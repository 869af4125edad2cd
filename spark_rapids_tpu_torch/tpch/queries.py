"""TPC-H queries as DataFrame functions, and the port's own slice queries.

Copied from ``spark_rapids_tpu/tpch/queries.py``: all 22 TPC-H queries as
the JAX package writes them (``QUERIES``, ``tpch_query``; Q11's fraction is
the spec's ``0.0001 / SF``), with the join queries ``q4``, ``q5``, ``q7``,
``q8``, ``q12``, ``q17`` and ``q19`` also in ``JOIN_QUERIES`` beside the
tables each reads. None needs a decimal, a cast or a date function on the
device: q11, q15 and q22 hold scalar subqueries (resolved before planning),
q2, q3, q10, q18 and q21 a top-N, q2, q9, q13, q14, q16 and q20 ``Like``,
and q22 ``Substring``.
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
from ..functions import col, count, lit, scalar_subquery, when


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


def q4(t):
    late = t("lineitem").filter(
        col("l_commitdate") < col("l_receiptdate")
    ).select("l_orderkey")
    return (
        t("orders")
        .filter((col("o_orderdate") >= D(1993, 7, 1))
                & (col("o_orderdate") < D(1993, 10, 1)))
        .join(late, on=[("o_orderkey", "l_orderkey")], how="left_semi")
        .group_by("o_orderpriority")
        .agg(count("*").alias("order_count"))
        .order_by("o_orderpriority")
    )


def q5(t):
    nat = (
        t("nation")
        .join(t("region").filter(col("r_name") == "ASIA"),
              on=[("n_regionkey", "r_regionkey")])
        .select("n_nationkey", "n_name")
    )
    supp = t("supplier").select("s_suppkey", "s_nationkey").join(
        nat, on=[("s_nationkey", "n_nationkey")]
    )
    orders = t("orders").filter(
        (col("o_orderdate") >= D(1994, 1, 1))
        & (col("o_orderdate") < D(1995, 1, 1))
    ).select("o_orderkey", "o_custkey")
    cust = t("customer").select("c_custkey", "c_nationkey")
    return (
        cust.join(orders, on=[("c_custkey", "o_custkey")])
        .join(t("lineitem").select("l_orderkey", "l_suppkey",
                                   "l_extendedprice", "l_discount"),
              on=[("o_orderkey", "l_orderkey")])
        .join(supp, on=[("l_suppkey", "s_suppkey"),
                        ("c_nationkey", "s_nationkey")])
        .group_by("n_name")
        .agg(F.sum(col("l_extendedprice") * (1 - col("l_discount"))).alias(
            "revenue"))
        .order_by(col("revenue").desc())
    )


def q7(t):
    n1 = t("nation").select(col("n_nationkey").alias("n1_key"),
                            col("n_name").alias("supp_nation"))
    n2 = t("nation").select(col("n_nationkey").alias("n2_key"),
                            col("n_name").alias("cust_nation"))
    li = t("lineitem").filter(
        (col("l_shipdate") >= D(1995, 1, 1))
        & (col("l_shipdate") <= D(1996, 12, 31))
    ).select("l_orderkey", "l_suppkey", "l_shipdate", "l_extendedprice",
             "l_discount")
    return (
        li.join(t("orders").select("o_orderkey", "o_custkey"),
                on=[("l_orderkey", "o_orderkey")])
        .join(t("customer").select("c_custkey", "c_nationkey"),
              on=[("o_custkey", "c_custkey")])
        .join(t("supplier").select("s_suppkey", "s_nationkey"),
              on=[("l_suppkey", "s_suppkey")])
        .join(n1, on=[("s_nationkey", "n1_key")])
        .join(n2, on=[("c_nationkey", "n2_key")])
        .filter(
            ((col("supp_nation") == "FRANCE") & (col("cust_nation") == "GERMANY"))
            | ((col("supp_nation") == "GERMANY") & (col("cust_nation") == "FRANCE"))
        )
        .with_column("l_year", F.year(col("l_shipdate")))
        .group_by("supp_nation", "cust_nation", "l_year")
        .agg(F.sum(col("l_extendedprice") * (1 - col("l_discount"))).alias(
            "revenue"))
        .order_by("supp_nation", "cust_nation", "l_year")
    )


def q8(t):
    amer = (
        t("nation")
        .join(t("region").filter(col("r_name") == "AMERICA"),
              on=[("n_regionkey", "r_regionkey")])
        .select(col("n_nationkey").alias("rn_key"))
    )
    n2 = t("nation").select(col("n_nationkey").alias("n2_key"),
                            col("n_name").alias("nation"))
    part = t("part").filter(
        col("p_type") == "ECONOMY ANODIZED STEEL"
    ).select("p_partkey")
    orders = t("orders").filter(
        (col("o_orderdate") >= D(1995, 1, 1))
        & (col("o_orderdate") <= D(1996, 12, 31))
    ).select("o_orderkey", "o_custkey", "o_orderdate")
    vol = col("l_extendedprice") * (1 - col("l_discount"))
    return (
        part.join(t("lineitem").select("l_partkey", "l_orderkey", "l_suppkey",
                                       "l_extendedprice", "l_discount"),
                  on=[("p_partkey", "l_partkey")])
        .join(orders, on=[("l_orderkey", "o_orderkey")])
        .join(t("customer").select("c_custkey", "c_nationkey"),
              on=[("o_custkey", "c_custkey")])
        .join(amer, on=[("c_nationkey", "rn_key")])
        .join(t("supplier").select("s_suppkey", "s_nationkey"),
              on=[("l_suppkey", "s_suppkey")])
        .join(n2, on=[("s_nationkey", "n2_key")])
        .with_column("o_year", F.year(col("o_orderdate")))
        .with_column("volume", vol)
        .group_by("o_year")
        .agg(
            (F.sum(when(col("nation") == "BRAZIL", col("volume")).otherwise(0.0))
             / F.sum(col("volume"))).alias("mkt_share")
        )
        .order_by("o_year")
    )


def q12(t):
    li = t("lineitem").filter(
        col("l_shipmode").isin("MAIL", "SHIP")
        & (col("l_commitdate") < col("l_receiptdate"))
        & (col("l_shipdate") < col("l_commitdate"))
        & (col("l_receiptdate") >= D(1994, 1, 1))
        & (col("l_receiptdate") < D(1995, 1, 1))
    ).select("l_orderkey", "l_shipmode")
    high = when(
        col("o_orderpriority").isin("1-URGENT", "2-HIGH"), 1
    ).otherwise(0)
    return (
        t("orders").select("o_orderkey", "o_orderpriority")
        .join(li, on=[("o_orderkey", "l_orderkey")])
        .group_by("l_shipmode")
        .agg(
            F.sum(high).alias("high_line_count"),
            F.sum(1 - high).alias("low_line_count"),
        )
        .order_by("l_shipmode")
    )


def q17(t):
    part = t("part").filter(
        (col("p_brand") == "Brand#23") & (col("p_container") == "MED BOX")
    ).select("p_partkey")
    li = t("lineitem").select("l_partkey", "l_quantity", "l_extendedprice")
    avg_qty = (
        li.join(part, on=[("l_partkey", "p_partkey")])
        .group_by("l_partkey")
        .agg((F.avg(col("l_quantity")) * 0.2).alias("qty_limit"))
        .with_column_renamed("l_partkey", "a_partkey")
    )
    return (
        li.join(part, on=[("l_partkey", "p_partkey")])
        .join(avg_qty, on=[("l_partkey", "a_partkey")])
        .filter(col("l_quantity") < col("qty_limit"))
        .agg((F.sum(col("l_extendedprice")) / 7.0).alias("avg_yearly"))
    )


def q19(t):
    li = t("lineitem").filter(
        col("l_shipmode").isin("AIR", "AIR REG")
        & (col("l_shipinstruct") == "DELIVER IN PERSON")
    ).select("l_partkey", "l_quantity", "l_extendedprice", "l_discount")
    joined = li.join(
        t("part").select("p_partkey", "p_brand", "p_container", "p_size"),
        on=[("l_partkey", "p_partkey")],
    )
    c1 = (
        (col("p_brand") == "Brand#12")
        & col("p_container").isin("SM CASE", "SM BOX", "SM PACK", "SM PKG")
        & (col("l_quantity") >= 1) & (col("l_quantity") <= 11)
        & (col("p_size") >= 1) & (col("p_size") <= 5)
    )
    c2 = (
        (col("p_brand") == "Brand#23")
        & col("p_container").isin("MED BAG", "MED BOX", "MED PKG", "MED PACK")
        & (col("l_quantity") >= 10) & (col("l_quantity") <= 20)
        & (col("p_size") >= 1) & (col("p_size") <= 10)
    )
    c3 = (
        (col("p_brand") == "Brand#34")
        & col("p_container").isin("LG CASE", "LG BOX", "LG PACK", "LG PKG")
        & (col("l_quantity") >= 20) & (col("l_quantity") <= 30)
        & (col("p_size") >= 1) & (col("p_size") <= 15)
    )
    return joined.filter(c1 | c2 | c3).agg(
        F.sum(col("l_extendedprice") * (1 - col("l_discount"))).alias("revenue")
    )


def _europe_partsupp(t):
    nat = (
        t("nation")
        .join(t("region").filter(col("r_name") == "EUROPE"),
              on=[("n_regionkey", "r_regionkey")])
        .select("n_nationkey", "n_name")
    )
    supp = t("supplier").join(nat, on=[("s_nationkey", "n_nationkey")])
    return (
        t("partsupp")
        .select("ps_partkey", "ps_suppkey", "ps_supplycost")
        .join(supp, on=[("ps_suppkey", "s_suppkey")])
    )



def q2(t):
    ps = _europe_partsupp(t)
    min_cost = ps.group_by("ps_partkey").agg(
        F.min(col("ps_supplycost")).alias("min_cost")
    ).with_column_renamed("ps_partkey", "mc_partkey")
    part = t("part").filter(
        (col("p_size") == 15) & col("p_type").like("%BRASS")
    ).select("p_partkey", "p_mfgr")
    return (
        part.join(ps, on=[("p_partkey", "ps_partkey")])
        .join(min_cost, on=[("p_partkey", "mc_partkey")])
        .filter(col("ps_supplycost") == col("min_cost"))
        .select("s_acctbal", "s_name", "n_name", "p_partkey", "p_mfgr",
                "s_address", "s_phone", "s_comment")
        .order_by(col("s_acctbal").desc(), col("n_name"), col("s_name"),
                  col("p_partkey"))
        .limit(100)
    )



def q3(t):
    cust = t("customer").filter(col("c_mktsegment") == "BUILDING").select(
        "c_custkey"
    )
    orders = t("orders").filter(col("o_orderdate") < D(1995, 3, 15)).select(
        "o_orderkey", "o_custkey", "o_orderdate", "o_shippriority"
    )
    li = t("lineitem").filter(col("l_shipdate") > D(1995, 3, 15)).select(
        "l_orderkey", "l_extendedprice", "l_discount"
    )
    return (
        cust.join(orders, on=[("c_custkey", "o_custkey")])
        .join(li, on=[("o_orderkey", "l_orderkey")])
        .group_by("l_orderkey", "o_orderdate", "o_shippriority")
        .agg(
            F.sum(col("l_extendedprice") * (1 - col("l_discount"))).alias(
                "revenue"
            )
        )
        .order_by(col("revenue").desc(), col("o_orderdate"))
        .limit(10)
    )



def q9(t):
    part = t("part").filter(col("p_name").like("%green%")).select("p_partkey")
    nat = t("nation").select("n_nationkey", col("n_name").alias("nation"))
    return (
        part.join(
            t("lineitem").select("l_partkey", "l_suppkey", "l_orderkey",
                                 "l_quantity", "l_extendedprice", "l_discount"),
            on=[("p_partkey", "l_partkey")])
        .join(t("supplier").select("s_suppkey", "s_nationkey"),
              on=[("l_suppkey", "s_suppkey")])
        .join(t("partsupp").select("ps_partkey", "ps_suppkey", "ps_supplycost"),
              on=[("l_suppkey", "ps_suppkey"), ("l_partkey", "ps_partkey")])
        .join(t("orders").select("o_orderkey", "o_orderdate"),
              on=[("l_orderkey", "o_orderkey")])
        .join(nat, on=[("s_nationkey", "n_nationkey")])
        .with_column("o_year", F.year(col("o_orderdate")))
        .with_column(
            "amount",
            col("l_extendedprice") * (1 - col("l_discount"))
            - col("ps_supplycost") * col("l_quantity"),
        )
        .group_by("nation", "o_year")
        .agg(F.sum(col("amount")).alias("sum_profit"))
        .order_by(col("nation"), col("o_year").desc())
    )



def q10(t):
    orders = t("orders").filter(
        (col("o_orderdate") >= D(1993, 10, 1))
        & (col("o_orderdate") < D(1994, 1, 1))
    ).select("o_orderkey", "o_custkey")
    li = t("lineitem").filter(col("l_returnflag") == "R").select(
        "l_orderkey", "l_extendedprice", "l_discount"
    )
    return (
        t("customer")
        .join(orders, on=[("c_custkey", "o_custkey")])
        .join(li, on=[("o_orderkey", "l_orderkey")])
        .join(t("nation").select("n_nationkey", "n_name"),
              on=[("c_nationkey", "n_nationkey")])
        .group_by("c_custkey", "c_name", "c_acctbal", "c_phone", "n_name",
                  "c_address", "c_comment")
        .agg(F.sum(col("l_extendedprice") * (1 - col("l_discount"))).alias(
            "revenue"))
        .order_by(col("revenue").desc())
        .limit(20)
    )



def q11(t, sf: float = 1.0):
    base = (
        t("partsupp")
        .select("ps_partkey", "ps_suppkey", "ps_availqty", "ps_supplycost")
        .join(t("supplier").select("s_suppkey", "s_nationkey"),
              on=[("ps_suppkey", "s_suppkey")])
        .join(t("nation").filter(col("n_name") == "GERMANY")
              .select("n_nationkey"),
              on=[("s_nationkey", "n_nationkey")])
        .with_column("value", col("ps_supplycost") * col("ps_availqty"))
    )
    threshold = base.agg(
        (F.sum(col("value")) * lit(0.0001 / sf)).alias("threshold")
    )
    return (
        base.group_by("ps_partkey")
        .agg(F.sum(col("value")).alias("value"))
        .filter(col("value") > scalar_subquery(threshold))
        .order_by(col("value").desc())
    )



def q13(t):
    orders = t("orders").filter(
        ~col("o_comment").like("%special%requests%")
    ).select("o_orderkey", "o_custkey")
    return (
        t("customer").select("c_custkey")
        .join(orders, on=[("c_custkey", "o_custkey")], how="left")
        .group_by("c_custkey")
        .agg(count(col("o_orderkey")).alias("c_count"))
        .group_by("c_count")
        .agg(count("*").alias("custdist"))
        .order_by(col("custdist").desc(), col("c_count").desc())
    )



def q14(t):
    li = t("lineitem").filter(
        (col("l_shipdate") >= D(1995, 9, 1)) & (col("l_shipdate") < D(1995, 10, 1))
    ).select("l_partkey", "l_extendedprice", "l_discount")
    rev = col("l_extendedprice") * (1 - col("l_discount"))
    return (
        li.join(t("part").select("p_partkey", "p_type"),
                on=[("l_partkey", "p_partkey")])
        .agg(
            (
                F.sum(when(col("p_type").like("PROMO%"), rev).otherwise(0.0))
                * 100.0 / F.sum(rev)
            ).alias("promo_revenue")
        )
    )



def q15(t):
    revenue = (
        t("lineitem")
        .filter((col("l_shipdate") >= D(1996, 1, 1))
                & (col("l_shipdate") < D(1996, 4, 1)))
        .group_by("l_suppkey")
        .agg(F.sum(col("l_extendedprice") * (1 - col("l_discount"))).alias(
            "total_revenue"))
    )
    best = revenue.agg(F.max(col("total_revenue")).alias("m"))
    return (
        t("supplier").select("s_suppkey", "s_name", "s_address", "s_phone")
        .join(revenue, on=[("s_suppkey", "l_suppkey")])
        .filter(col("total_revenue") == scalar_subquery(best))
        .select("s_suppkey", "s_name", "s_address", "s_phone", "total_revenue")
        .order_by("s_suppkey")
    )



def q16(t):
    part = t("part").filter(
        (col("p_brand") != "Brand#45")
        & ~col("p_type").like("MEDIUM POLISHED%")
        & col("p_size").isin(49, 14, 23, 45, 19, 3, 36, 9)
    ).select("p_partkey", "p_brand", "p_type", "p_size")
    bad_supp = t("supplier").filter(
        col("s_comment").like("%Customer%Complaints%")
    ).select("s_suppkey")
    return (
        t("partsupp").select("ps_partkey", "ps_suppkey")
        .join(part, on=[("ps_partkey", "p_partkey")])
        .join(bad_supp, on=[("ps_suppkey", "s_suppkey")], how="left_anti")
        .group_by("p_brand", "p_type", "p_size")
        .agg(F.count_distinct(col("ps_suppkey")).alias("supplier_cnt"))
        .order_by(col("supplier_cnt").desc(), col("p_brand"), col("p_type"),
                  col("p_size"))
    )



def q18(t):
    big = (
        t("lineitem").select("l_orderkey", "l_quantity")
        .group_by("l_orderkey")
        .agg(F.sum(col("l_quantity")).alias("o_qty"))
        .filter(col("o_qty") > 300)
        .select(col("l_orderkey").alias("big_okey"))
    )
    return (
        t("orders").select("o_orderkey", "o_custkey", "o_orderdate",
                           "o_totalprice")
        .join(big, on=[("o_orderkey", "big_okey")], how="left_semi")
        .join(t("customer").select("c_custkey", "c_name"),
              on=[("o_custkey", "c_custkey")])
        .join(t("lineitem").select("l_orderkey", "l_quantity"),
              on=[("o_orderkey", "l_orderkey")])
        .group_by("c_name", "c_custkey", "o_orderkey", "o_orderdate",
                  "o_totalprice")
        .agg(F.sum(col("l_quantity")).alias("sum_qty"))
        .order_by(col("o_totalprice").desc(), col("o_orderdate"))
        .limit(100)
    )



def q20(t):
    forest_parts = t("part").filter(col("p_name").like("forest%")).select(
        "p_partkey"
    )
    shipped = (
        t("lineitem")
        .filter((col("l_shipdate") >= D(1994, 1, 1))
                & (col("l_shipdate") < D(1995, 1, 1)))
        .group_by("l_partkey", "l_suppkey")
        .agg((F.sum(col("l_quantity")) * 0.5).alias("half_qty"))
    )
    eligible_ps = (
        t("partsupp").select("ps_partkey", "ps_suppkey", "ps_availqty")
        .join(forest_parts, on=[("ps_partkey", "p_partkey")], how="left_semi")
        .join(shipped, on=[("ps_partkey", "l_partkey"),
                           ("ps_suppkey", "l_suppkey")])
        .filter(col("ps_availqty") > col("half_qty"))
        .select("ps_suppkey")
    )
    return (
        t("supplier").select("s_suppkey", "s_name", "s_address", "s_nationkey")
        .join(t("nation").filter(col("n_name") == "CANADA")
              .select("n_nationkey"),
              on=[("s_nationkey", "n_nationkey")])
        .join(eligible_ps, on=[("s_suppkey", "ps_suppkey")], how="left_semi")
        .select("s_name", "s_address")
        .order_by("s_name")
    )



def q21(t):
    late = t("lineitem").filter(
        col("l_receiptdate") > col("l_commitdate")
    ).select("l_orderkey", "l_suppkey")
    n_supp = (
        t("lineitem").select("l_orderkey", "l_suppkey")
        .group_by("l_orderkey")
        .agg(F.count_distinct(col("l_suppkey")).alias("n_supp"))
        .with_column_renamed("l_orderkey", "ns_okey")
    )
    n_late = (
        late.group_by("l_orderkey")
        .agg(F.count_distinct(col("l_suppkey")).alias("n_late"))
        .with_column_renamed("l_orderkey", "nl_okey")
    )
    return (
        late.join(t("orders").filter(col("o_orderstatus") == "F")
                  .select("o_orderkey"),
                  on=[("l_orderkey", "o_orderkey")])
        .join(t("supplier").select("s_suppkey", "s_name", "s_nationkey"),
              on=[("l_suppkey", "s_suppkey")])
        .join(t("nation").filter(col("n_name") == "SAUDI ARABIA")
              .select("n_nationkey"),
              on=[("s_nationkey", "n_nationkey")])
        .join(n_supp, on=[("l_orderkey", "ns_okey")])
        .join(n_late, on=[("l_orderkey", "nl_okey")])
        .filter((col("n_supp") > 1) & (col("n_late") == 1))
        .group_by("s_name")
        .agg(count("*").alias("numwait"))
        .order_by(col("numwait").desc(), col("s_name"))
        .limit(100)
    )



def q22(t):
    codes = ("13", "31", "23", "29", "30", "18", "17")
    cust = (
        t("customer").select("c_custkey", "c_phone", "c_acctbal")
        .with_column("cntrycode", F.substring(col("c_phone"), 1, 2))
        .filter(col("cntrycode").isin(*codes))
    )
    avg_bal = cust.filter(col("c_acctbal") > 0.0).agg(
        F.avg(col("c_acctbal")).alias("a")
    )
    return (
        cust.filter(col("c_acctbal") > scalar_subquery(avg_bal))
        .join(t("orders").select("o_custkey"),
              on=[("c_custkey", "o_custkey")], how="left_anti")
        .group_by("cntrycode")
        .agg(count("*").alias("numcust"), F.sum(col("c_acctbal")).alias("totacctbal"))
        .order_by("cntrycode")
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

#: the TPC-H queries this slice adds, by name, with the tables each reads
JOIN_QUERIES = {
    "q4": (q4, ("orders", "lineitem")),
    "q5": (q5, ("nation", "region", "supplier", "orders", "customer", "lineitem")),
    "q7": (q7, ("nation", "lineitem", "orders", "customer", "supplier")),
    "q8": (q8, ("nation", "region", "part", "orders", "lineitem", "customer", "supplier")),
    "q12": (q12, ("lineitem", "orders")),
    "q17": (q17, ("part", "lineitem")),
    "q19": (q19, ("lineitem", "part")),
}


#: all 22 TPC-H queries by number, as the JAX package's ``QUERIES``
QUERIES = {
    1: q1, 2: q2, 3: q3, 4: q4, 5: q5, 6: q6, 7: q7, 8: q8, 9: q9, 10: q10,
    11: q11, 12: q12, 13: q13, 14: q14, 15: q15, 16: q16, 17: q17, 18: q18,
    19: q19, 20: q20, 21: q21, 22: q22,
}


def tpch_query(n: int, t, sf: float = 1.0):
    """Build TPC-H query ``n`` over accessor ``t``; ``sf`` parameterizes
    Q11's spec-defined ``0.0001 / SF`` fraction."""
    fn = QUERIES[n]
    if n == 11:
        return fn(t, sf)
    return fn(t)
