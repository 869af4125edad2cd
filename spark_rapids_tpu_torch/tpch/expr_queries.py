"""Scalar-expression queries over the TPC-H tables, one per family of the
expression surface: dates and date patterns, casts (decimals and the
float/string casts among them), strings over ``match_starts``, and math,
bitwise and null handling. ``chip_smoke.py`` runs them at SF 1 and holds
each column to the port's CPU engine; ``tests/test_torch_gpu.py`` runs
them at a small scale.

Each query is ``fn(t) -> DataFrame`` over ``t(name)``, the DataFrame of a
TPC-H table, as in ``queries.py``; :data:`EXPR_QUERIES` maps each family
to its function and the tables it reads. :data:`EXPR_CONF` turns on the
gated float <-> string casts, which the casts family uses.

:func:`ansi_queries` builds the ANSI pair over lineitem: an ANSI cast and
an ANSI add that overflow in exactly one row, and the same two shifted by
one so that no row overflows.
"""
from __future__ import annotations

import numpy as np

from .. import functions as F
from ..functions import col
from ..types import DATE, DOUBLE, INT, LONG, STRING, TIMESTAMP, DecimalType

#: the conf the families run under (besides ``spark.rapids.sql.enabled``)
EXPR_CONF = {
    "spark.rapids.sql.castFloatToString.enabled": True,
    "spark.rapids.sql.castStringToFloat.enabled": True,
}


def expr_dates(t):
    """Date fields, date arithmetic, and ``l_shipdate`` formatted and parsed
    back; hours and seconds of a timestamp moved by an interval."""
    sd, rd = col("l_shipdate"), col("l_receiptdate")
    text = F.date_format(sd, "yyyy-MM-dd")
    ts = sd.cast(TIMESTAMP) + F.make_interval(hours=13, mins=7, secs=11)
    return t("lineitem").select(
        F.year(sd).alias("year"),
        F.month(sd).alias("month"),
        F.dayofmonth(sd).alias("dom"),
        F.dayofyear(sd).alias("doy"),
        F.dayofweek(sd).alias("dow"),
        F.weekday(sd).alias("wd"),
        F.weekofyear(sd).alias("woy"),
        F.quarter(sd).alias("q"),
        F.last_day(sd).alias("last"),
        F.date_add(sd, 30).alias("plus30"),
        F.date_sub(sd, 7).alias("minus7"),
        F.datediff(rd, sd).alias("transit"),
        F.add_months(sd, 13).alias("plus13m"),
        text.alias("text"),
        F.to_date(text, "yyyy-MM-dd").alias("back"),
        F.unix_timestamp(text, "yyyy-MM-dd").alias("secs"),
        F.from_unixtime(F.unix_timestamp(ts), "yyyy/MM/dd HH:mm:ss").alias("ts_text"),
        F.hour(ts).alias("hour"),
        F.minute(ts).alias("minute"),
        F.second(ts).alias("second"),
    )


def expr_casts(t):
    """date -> string -> date, floats -> string, long -> string -> long,
    comment -> int (all null but digit runs), and a decimal product."""
    price = col("l_extendedprice").cast(DecimalType(9, 2))
    disc = col("l_discount").cast(DecimalType(3, 2))
    return t("lineitem").select(
        col("l_shipdate").cast(STRING).alias("ship_text"),
        col("l_shipdate").cast(STRING).cast(DATE).alias("ship_back"),
        col("l_quantity").cast(STRING).alias("qty_text"),
        col("l_extendedprice").cast(STRING).alias("price_text"),
        col("l_extendedprice").cast(STRING).cast(DOUBLE).alias("price_back"),
        col("l_orderkey").cast(STRING).alias("key_text"),
        col("l_orderkey").cast(STRING).cast(LONG).alias("key_back"),
        col("l_comment").cast(INT).alias("comment_int"),
        price.alias("price_dec"),
        (price * disc).alias("disc_amount"),
        (price * disc).cast(STRING).alias("disc_text"),
    )


def expr_strings(t):
    """The string functions over ``o_comment``, ``o_clerk`` and
    ``o_orderpriority``; ``locate``, ``substring_index`` and ``replace``
    launch ``match_starts``."""
    c, k, p = col("o_comment"), col("o_clerk"), col("o_orderpriority")
    return t("orders").select(
        F.length(c).alias("len"),
        F.upper(c).alias("up"),
        F.lower(k).alias("low"),
        F.initcap(c).alias("cap"),
        F.reverse(c).alias("rev"),
        F.ascii(c).alias("asc"),
        F.trim(p).alias("trim"),
        F.ltrim(F.lpad(p, 20, " ")).alias("ltrim"),
        F.rtrim(F.rpad(p, 20, " ")).alias("rtrim"),
        F.lpad(c, 100, "*").alias("lpad"),
        F.rpad(k, 100, "-").alias("rpad"),
        F.repeat(p, 2).alias("rep"),
        F.translate(c, "aeiou", "AEIO").alias("tr"),
        F.concat_ws("|", k, p, c).alias("cws"),
        F.locate("special", c).alias("loc"),
        F.locate("special", c, 10).alias("loc10"),
        F.substring_index(c, " ", 2).alias("head2"),
        F.substring_index(c, " ", -2).alias("tail2"),
        F.replace(c, "special", "X").alias("repl"),
        F.md5(k).alias("md5"),
    )


def expr_math(t):
    """Math over the price, discount and quantity; bitwise ops, ``pmod``
    and ``div`` over the order key; ``greatest``/``least``, ``nanvl``,
    ``nvl2`` and ``<=>``."""
    from ..expr.arithmetic import IntegralDivide

    price, disc, qty = col("l_extendedprice"), col("l_discount"), col("l_quantity")
    key = col("l_orderkey")
    small = disc * 10.0 - 0.5  # in [-0.5, 0.5]: the inverse trig domain
    return t("lineitem").select(
        F.sqrt(price).alias("sqrt"),
        F.cbrt(price).alias("cbrt"),
        F.exp(disc).alias("exp"),
        F.expm1(disc).alias("expm1"),
        F.log(price).alias("ln"),
        F.log10(price).alias("log10"),
        F.log2(qty).alias("log2"),
        F.log1p(disc).alias("log1p"),
        F.log(2.0, qty).alias("log_b"),
        F.sin(price).alias("sin"),
        F.cos(price).alias("cos"),
        F.tan(disc).alias("tan"),
        F.asin(small).alias("asin"),
        F.acos(small).alias("acos"),
        F.atan(price).alias("atan"),
        F.sinh(disc).alias("sinh"),
        F.cosh(disc).alias("cosh"),
        F.tanh(small).alias("tanh"),
        F.asinh(small).alias("asinh"),
        F.acosh(qty).alias("acosh"),
        F.atanh(small).alias("atanh"),
        F.cot(qty).alias("cot"),
        F.degrees(disc).alias("deg"),
        F.radians(qty).alias("rad"),
        F.rint(price / 7.0).alias("rint"),
        F.signum(small).alias("sign"),
        F.floor(price / 7.0).alias("floor"),
        F.ceil(price / 7.0).alias("ceil"),
        F.pow(disc, qty / 10.0).alias("pow"),
        F.atan2(small, disc).alias("atan2"),
        F.hypot(qty, disc).alias("hypot"),
        key.bitwiseAND(0xFF).alias("band"),
        key.bitwiseOR(col("l_linenumber").cast(LONG)).alias("bor"),
        key.bitwiseXOR(0x5555).alias("bxor"),
        F.bitwise_not(key).alias("bnot"),
        F.shiftleft(key, 40).alias("shl"),
        F.shiftright(-key, 3).alias("shr"),
        F.shiftrightunsigned(-key, 3).alias("shru"),
        F.pmod(-key, 7).alias("pmod"),
        F.expr_col(IntegralDivide(key.expr, F.lit(7).cast(LONG).expr)).alias("div"),
        (key % 13).alias("rem"),
        F.greatest(price / 1000.0, qty, disc * 100.0).alias("greatest"),
        F.least(price / 1000.0, qty, disc * 100.0).alias("least"),
        F.nanvl(F.log(small + 0.5) * 0.0, disc).alias("nanvl"),
        F.nvl2(F.when(disc > 0.05, qty), price, disc).alias("nvl2"),
        F.when(disc > 0.05, qty).eq_null_safe(F.when(disc < 0.08, qty)).alias("eqns"),
        F.isnan(F.log(small + 0.5) * 0.0).alias("isnan"),
    )


#: family → (query, tables it reads)
EXPR_QUERIES = {
    "expr_dates": (expr_dates, ["lineitem"]),
    "expr_casts": (expr_casts, ["lineitem"]),
    "expr_strings": (expr_strings, ["orders"]),
    "expr_math": (expr_math, ["lineitem"]),
}


def row_key(lineitem) -> np.ndarray:
    """``l_orderkey * 8 + l_linenumber`` of a lineitem ``HostBatch``: one
    distinct value a row (line numbers run from 1 to 7)."""
    i = lineitem.schema.index_of("l_orderkey")
    j = lineitem.schema.index_of("l_linenumber")
    return lineitem.columns[i].data.astype(np.int64) * 8 + lineitem.columns[j].data


def ansi_queries(lineitem, overflow: bool) -> dict:
    """The ANSI pair over a lineitem ``HostBatch``: name → query. With
    ``overflow``, the row with the largest :func:`row_key` (and only that
    row) overflows INT: in the cast of the key moved up to ``2**31``, and in
    the INT add that moves it there. Without, each is one smaller."""
    top = int(row_key(lineitem).max())
    shift = 2**31 - top - (0 if overflow else 1)
    key = col("l_orderkey") * 8 + col("l_linenumber").cast(LONG)
    return {
        "ansi_cast": lambda t: t("lineitem").select((key + shift).cast(INT).alias("k")),
        "ansi_add": lambda t: t("lineitem").select(
            (key.cast(INT) + F.lit(shift).cast(INT)).alias("k")
        ),
    }
