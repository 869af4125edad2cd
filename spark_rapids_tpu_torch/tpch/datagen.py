"""TPC-H table generator (dbgen-shaped, vectorized numpy, deterministic).

Copied from ``spark_rapids_tpu/tpch/datagen.py``: the same tables, the same
random draws in the same order, so a seed gives the same values in both
packages. What differs is the output: each table is a ``HostBatch`` whose
string columns are built straight into Arrow layout (offsets and bytes) by
numpy, never as Python strings, so SF 1 (6M lineitem rows) generates in
seconds and without pyarrow. Parquet output is left out.

Produces the eight standard tables at any scale factor with the spec's
cardinalities and value distributions where queries depend on them:
selective text columns (p_name words, p_type triples, comment trigger
phrases for Q13/Q16), the customer-without-orders thirds rule (Q13/Q22),
date chains o_orderdate -> l_shipdate/commitdate/receiptdate (Q1/Q4/Q12),
returnflag/linestatus derivation (Q1), and o_orderstatus/o_totalprice
computed exactly from the order's lineitems (Q18/Q21).

Monetary columns are float64 ("useDoubleForDecimal" variant, the common
columnar-benchmark configuration).
"""
from __future__ import annotations

from datetime import date
from typing import Dict, List

import numpy as np

from ..columnar.host import HostBatch, HostColumn
from ..types import DATE, DOUBLE, INT, LONG, STRING, Schema, StructField

EPOCH = date(1970, 1, 1)


def _d(y: int, m: int, d_: int) -> int:
    return (date(y, m, d_) - EPOCH).days


START_DATE = _d(1992, 1, 1)
END_DATE = _d(1998, 8, 2)  # o_orderdate upper bound (spec: end.date - 121)
CURRENT_DATE = _d(1995, 6, 17)

REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
NATIONS = [
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
]

# p_name is 5 words from this list (dbgen's colour list, abridged but
# including every colour a TPC-H query predicate names).
P_NAME_WORDS = [
    "almond", "antique", "aquamarine", "azure", "beige", "bisque", "black",
    "blanched", "blue", "blush", "brown", "burlywood", "burnished", "chartreuse",
    "chiffon", "chocolate", "coral", "cornflower", "cornsilk", "cream", "cyan",
    "dark", "deep", "dim", "dodger", "drab", "firebrick", "floral", "forest",
    "frosted", "gainsboro", "ghost", "goldenrod", "green", "grey", "honeydew",
    "hot", "indian", "ivory", "khaki", "lace", "lavender", "lawn", "lemon",
    "light", "lime", "linen", "magenta", "maroon", "medium", "metallic",
    "midnight", "mint", "misty", "moccasin", "navajo", "navy", "olive",
    "orange", "orchid", "pale", "papaya", "peach", "peru", "pink", "plum",
    "powder", "puff", "purple", "red", "rose", "rosy", "royal", "saddle",
    "salmon", "sandy", "seashell", "sienna", "sky", "slate", "smoke", "snow",
    "spring", "steel", "tan", "thistle", "tomato", "turquoise", "violet",
    "wheat", "white", "yellow",
]
TYPE_SYL1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
TYPE_SYL2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
TYPE_SYL3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
CONTAINER_SYL1 = ["SM", "LG", "MED", "JUMBO", "WRAP"]
CONTAINER_SYL2 = ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"]
SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
SHIP_MODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
SHIP_INSTRUCT = [
    "DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN",
]
_FILLER = [
    "carefully", "final", "deposits", "accounts", "packages", "ideas",
    "quickly", "furiously", "slyly", "blithely", "pending", "express",
    "regular", "even", "silent", "bold", "unusual", "ironic", "special",
    "requests", "theodolites", "instructions", "foxes", "platelets",
    "dependencies", "excuses", "waters", "sauternes", "asymptotes",
]

TABLES = [
    "region", "nation", "supplier", "customer", "part", "partsupp",
    "orders", "lineitem",
]


# ── string columns in Arrow layout ──────────────────────────────────────────
#
# A row's string is a concatenation of segments. A segment is (mat, lens):
# row i contributes mat[i, :lens[i]]. Joining lays the segments side by side
# and keeps the bytes under the lengths — row-major boolean indexing hands
# them back row after row, segment after segment, which is Arrow's layout.


def _vocab(words: List[str], idx: np.ndarray):
    """Segment choosing ``words[idx[i]]`` for row i."""
    enc = [w.encode("utf-8") for w in words]
    width = max(1, max(len(b) for b in enc))
    mat = np.zeros((len(enc), width), dtype=np.uint8)
    for k, b in enumerate(enc):
        mat[k, : len(b)] = np.frombuffer(b, dtype=np.uint8)
    lens = np.asarray([len(b) for b in enc], dtype=np.int64)
    idx = np.asarray(idx, dtype=np.int64)
    return mat[idx], lens[idx]


def _lit(text: str, n: int):
    """Segment of the same literal in every row."""
    buf = np.frombuffer(text.encode("utf-8"), dtype=np.uint8)
    return np.broadcast_to(buf, (n, len(buf))), np.full(n, len(buf), dtype=np.int64)


def _digits(values: np.ndarray, width: int):
    """Segment of each value as ``width`` zero-padded decimal digits (the
    values must fit ``width`` digits)."""
    v = np.asarray(values, dtype=np.int64)
    pows = 10 ** np.arange(width - 1, -1, -1, dtype=np.int64)
    mat = ((v[:, None] // pows[None, :]) % 10 + 48).astype(np.uint8)
    return mat, np.full(len(v), width, dtype=np.int64)


def _concat(segments, n: int) -> HostColumn:
    """Join segments row by row into an Arrow-layout string column."""
    mat = np.concatenate([m for m, _ in segments], axis=1)
    keep = np.concatenate(
        [np.arange(m.shape[1])[None, :] < ln[:, None] for m, ln in segments], axis=1
    )
    lens = np.zeros(n, dtype=np.int64)
    for _, ln in segments:
        lens += ln
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    return HostColumn(STRING, mat[keep], np.ones(n, dtype=bool), offsets.astype(np.int32))


def _words_idx(rng: np.random.Generator, vocab: List[str], n_rows: int, n_words: int):
    """The draw of ``n_rows`` strings of ``n_words`` words from vocab, as the
    word segments joined by single spaces."""
    idx = rng.integers(0, len(vocab), (n_rows, n_words))
    segs = []
    for j in range(n_words):
        if j:
            segs.append(_lit(" ", n_rows))
        segs.append(_vocab(vocab, idx[:, j]))
    return segs


def _words(rng: np.random.Generator, vocab: List[str], n_rows: int,
           n_words: int) -> HostColumn:
    """n_rows strings of n_words space-joined words from vocab."""
    return _concat(_words_idx(rng, vocab, n_rows, n_words), n_rows)


def _suffix(rows: np.ndarray, text: str):
    """Segment appending ``text`` to the rows where ``rows`` is True."""
    return _vocab(["", text], rows.astype(np.int64))


def _choice(vocab: List[str], idx: np.ndarray) -> HostColumn:
    return _concat([_vocab(vocab, idx)], len(idx))


def _money(rng: np.random.Generator, lo: float, hi: float, n: int) -> np.ndarray:
    return np.round(rng.uniform(lo, hi, n), 2)


def _col(values: np.ndarray, dt) -> HostColumn:
    values = np.ascontiguousarray(values, dtype=dt.np_dtype)
    return HostColumn(dt, values, np.ones(len(values), dtype=bool))


def _table(cols: Dict[str, HostColumn]) -> HostBatch:
    schema = Schema([StructField(name, c.dtype) for name, c in cols.items()])
    n = len(next(iter(cols.values())))
    return HostBatch(schema, list(cols.values()), n)


def _phone(nk, p, q, r) -> HostColumn:
    """``f"{nk + 10}-{p:03d}-{q:03d}-{r:04d}"`` for nation keys 0..24."""
    n = len(nk)
    return _concat(
        [
            _digits(np.asarray(nk) + 10, 2), _lit("-", n), _digits(p, 3),
            _lit("-", n), _digits(q, 3), _lit("-", n), _digits(r, 4),
        ],
        n,
    )


def gen_table(name: str, sf: float, seed: int = 19980802) -> HostBatch:
    """One TPC-H table at scale factor ``sf`` as a HostBatch."""
    rng = np.random.default_rng([seed, TABLES.index(name)])
    if name == "region":
        return _table({
            "r_regionkey": _col(np.arange(5), LONG),
            "r_name": _choice(REGIONS, np.arange(5)),
            "r_comment": _choice([" ".join(REGIONS)], np.zeros(5, np.int64)),
        })
    if name == "nation":
        return _table({
            "n_nationkey": _col(np.arange(25), LONG),
            "n_name": _choice([n for n, _ in NATIONS], np.arange(25)),
            "n_regionkey": _col([r for _, r in NATIONS], LONG),
            "n_comment": _words(rng, _FILLER, 25, 6),
        })
    if name == "supplier":
        n = max(int(sf * 10_000), 25)
        keys = np.arange(1, n + 1, dtype=np.int64)
        comment_segs = _words_idx(rng, _FILLER, n, 8)
        # dbgen: 5 per 10k get "Customer ... Complaints" (Q16 excludes them)
        bad = rng.choice(n, size=max(n // 2000, 1), replace=False)
        is_bad = np.zeros(n, dtype=bool)
        is_bad[bad] = True
        comments = _concat(comment_segs + [_suffix(is_bad, " Customer stuff Complaints")], n)
        # round-robin-then-shuffle: uniform marginal AND every nation is
        # present whenever n >= 25
        s_nk = np.arange(n, dtype=np.int64) % 25
        rng.shuffle(s_nk)
        s_name = _concat([_lit("Supplier#", n), _digits(keys, 9)], n)
        s_address = _words(rng, _FILLER, n, 3)
        s_phone = _phone(
            rng.integers(0, 25, n), rng.integers(100, 1000, n),
            rng.integers(100, 1000, n), rng.integers(1000, 10000, n),
        )
        return _table({
            "s_suppkey": _col(keys, LONG),
            "s_name": s_name,
            "s_address": s_address,
            "s_nationkey": _col(s_nk, LONG),
            "s_phone": s_phone,
            "s_acctbal": _col(_money(rng, -999.99, 9999.99, n), DOUBLE),
            "s_comment": comments,
        })
    if name == "customer":
        n = max(int(sf * 150_000), 30)
        keys = np.arange(1, n + 1, dtype=np.int64)
        nk = rng.integers(0, 25, n)
        c_name = _concat([_lit("Customer#", n), _digits(keys, 9)], n)
        c_address = _words(rng, _FILLER, n, 3)
        c_phone = _phone(
            nk, rng.integers(100, 1000, n), rng.integers(100, 1000, n),
            rng.integers(1000, 10000, n),
        )
        c_acctbal = _money(rng, -999.99, 9999.99, n)
        c_mktsegment = _choice(SEGMENTS, rng.integers(0, 5, n))
        return _table({
            "c_custkey": _col(keys, LONG),
            "c_name": c_name,
            "c_address": c_address,
            "c_nationkey": _col(nk, LONG),
            "c_phone": c_phone,
            "c_acctbal": _col(c_acctbal, DOUBLE),
            "c_mktsegment": c_mktsegment,
            "c_comment": _words(rng, _FILLER, n, 8),
        })
    if name == "part":
        n = max(int(sf * 200_000), 50)
        keys = np.arange(1, n + 1, dtype=np.int64)
        m = rng.integers(1, 6, n)
        nn = rng.integers(1, 6, n)
        p_name = _words(rng, P_NAME_WORDS, n, 5)
        p_type = _concat(
            _words_idx(rng, TYPE_SYL1, n, 1) + [_lit(" ", n)]
            + _words_idx(rng, TYPE_SYL2, n, 1) + [_lit(" ", n)]
            + _words_idx(rng, TYPE_SYL3, n, 1),
            n,
        )
        p_size = rng.integers(1, 51, n)
        p_container = _concat(
            _words_idx(rng, CONTAINER_SYL1, n, 1) + [_lit(" ", n)]
            + _words_idx(rng, CONTAINER_SYL2, n, 1),
            n,
        )
        return _table({
            "p_partkey": _col(keys, LONG),
            "p_name": p_name,
            "p_mfgr": _concat([_lit("Manufacturer#", n), _digits(m, 1)], n),
            "p_brand": _concat([_lit("Brand#", n), _digits(m, 1), _digits(nn, 1)], n),
            "p_type": p_type,
            "p_size": _col(p_size, INT),
            "p_container": p_container,
            "p_retailprice": _col(
                np.round((90000 + (keys % 200) * 100 + keys % 1000) / 100.0, 2), DOUBLE
            ),
            "p_comment": _words(rng, _FILLER, n, 4),
        })
    if name == "partsupp":
        n_part = max(int(sf * 200_000), 50)
        n_supp = max(int(sf * 10_000), 25)
        pk = np.repeat(np.arange(1, n_part + 1, dtype=np.int64), 4)
        i = np.tile(np.arange(4, dtype=np.int64), n_part)
        # dbgen's supplier spread: 4 distinct suppliers per part
        sk = (pk + i * ((n_supp // 4) + 1)) % n_supp + 1
        n = len(pk)
        availqty = rng.integers(1, 10_000, n)
        supplycost = _money(rng, 1.0, 1000.0, n)
        return _table({
            "ps_partkey": _col(pk, LONG),
            "ps_suppkey": _col(sk, LONG),
            "ps_availqty": _col(availqty, INT),
            "ps_supplycost": _col(supplycost, DOUBLE),
            "ps_comment": _words(rng, _FILLER, n, 6),
        })
    if name == "orders":
        return gen_orders_lineitem(sf, seed)[0]
    if name == "lineitem":
        return gen_orders_lineitem(sf, seed)[1]
    raise KeyError(name)


def gen_orders_lineitem(sf: float, seed: int = 19980802) -> tuple:
    """orders + lineitem generated together: lineitem dates chain off
    o_orderdate and o_orderstatus/o_totalprice are exact reductions of the
    order's lineitems (spec 4.2.3)."""
    rng = np.random.default_rng([seed, 101])
    n_ord = max(int(sf * 1_500_000), 150)
    n_cust = max(int(sf * 150_000), 30)
    n_part = max(int(sf * 200_000), 50)
    n_supp = max(int(sf * 10_000), 25)

    okey = np.arange(1, n_ord + 1, dtype=np.int64)
    # only customers with custkey % 3 != 0 place orders (dbgen rule)
    ck = rng.integers(1, n_cust + 1, n_ord).astype(np.int64)
    ck = np.where(ck % 3 == 0, np.maximum((ck + 1) % (n_cust + 1), 1), ck)
    ck = np.where(ck % 3 == 0, np.maximum((ck + 1) % (n_cust + 1), 1), ck)
    odate = rng.integers(START_DATE, END_DATE + 1, n_ord).astype(np.int32)

    n_li = rng.integers(1, 8, n_ord)
    # seed one near-maximal order (7 items, qty 50 below) so Q18's
    # sum(l_quantity) > 300 predicate is non-vacuous at EVERY scale factor
    n_li[0] = 7
    starts = np.concatenate([[0], np.cumsum(n_li)[:-1]])
    total = int(n_li.sum())
    li_order = np.repeat(okey, n_li)
    li_odate = np.repeat(odate, n_li)

    lk = rng.integers(1, n_part + 1, total).astype(np.int64)
    supp_i = rng.integers(0, 4, total).astype(np.int64)
    lsk = (lk + supp_i * ((n_supp // 4) + 1)) % n_supp + 1
    linenumber = (np.arange(total) - np.repeat(starts, n_li) + 1).astype(np.int32)

    qty = rng.integers(1, 51, total).astype(np.float64)
    qty[:7] = 50.0  # the seeded Q18 order
    retail = np.round((90000 + (lk % 200) * 100 + lk % 1000) / 100.0, 2)
    eprice = np.round(qty * retail, 2)
    disc = np.round(rng.integers(0, 11, total) / 100.0, 2)
    tax = np.round(rng.integers(0, 9, total) / 100.0, 2)

    sdate = (li_odate + rng.integers(1, 122, total)).astype(np.int32)
    cdate = (li_odate + rng.integers(30, 91, total)).astype(np.int32)
    rdate = (sdate + rng.integers(1, 31, total)).astype(np.int32)

    returned = rdate <= CURRENT_DATE
    # returnflag: R/A for returned items (a coin flip), N otherwise
    rf_idx = np.where(returned, np.where(rng.random(total) < 0.5, 0, 1), 2)
    shipped = sdate > CURRENT_DATE

    # exact per-order reductions
    li_rev = eprice * (1.0 + tax) * (1.0 - disc)
    totalprice = np.round(np.add.reduceat(li_rev, starts), 2)
    n_open = np.add.reduceat(shipped.astype(np.int64), starts)
    ostatus_idx = np.where(n_open == 0, 0, np.where(n_open == n_li, 1, 2))

    comment_segs = _words_idx(rng, _FILLER, n_ord, 6)
    special = rng.random(n_ord) < 0.01  # Q13's exclusion phrase
    comments = _concat(comment_segs + [_suffix(special, " special packages requests")], n_ord)

    priority = rng.integers(0, 5, n_ord)
    clerk = rng.integers(1, max(int(sf * 1000), 10) + 1, n_ord)
    orders = _table({
        "o_orderkey": _col(okey, LONG),
        "o_custkey": _col(ck, LONG),
        "o_orderstatus": _choice(["F", "O", "P"], ostatus_idx),
        "o_totalprice": _col(totalprice, DOUBLE),
        "o_orderdate": _col(odate, DATE),
        "o_orderpriority": _choice(PRIORITIES, priority),
        "o_clerk": _concat([_lit("Clerk#", n_ord), _digits(clerk, 9)], n_ord),
        "o_shippriority": _col(np.zeros(n_ord), INT),
        "o_comment": comments,
    })
    shipinstruct = rng.integers(0, 4, total)
    shipmode = rng.integers(0, 7, total)
    lineitem = _table({
        "l_orderkey": _col(li_order, LONG),
        "l_partkey": _col(lk, LONG),
        "l_suppkey": _col(lsk, LONG),
        "l_linenumber": _col(linenumber, INT),
        "l_quantity": _col(qty, DOUBLE),
        "l_extendedprice": _col(eprice, DOUBLE),
        "l_discount": _col(disc, DOUBLE),
        "l_tax": _col(tax, DOUBLE),
        "l_returnflag": _choice(["R", "A", "N"], rf_idx),
        "l_linestatus": _choice(["F", "O"], shipped.astype(np.int64)),
        "l_shipdate": _col(sdate, DATE),
        "l_commitdate": _col(cdate, DATE),
        "l_receiptdate": _col(rdate, DATE),
        "l_shipinstruct": _choice(SHIP_INSTRUCT, shipinstruct),
        "l_shipmode": _choice(SHIP_MODES, shipmode),
        "l_comment": _words(rng, _FILLER, total, 4),
    })
    return orders, lineitem
