"""The port's SQL front-end (``spark_rapids_tpu_torch/sql/``), against the JAX
package's.

- Every TPC-H (22) and TPC-DS (99) text parses to the same tree in both
  packages (dataclass reprs).
- The statements of ``tests/test_sql.py`` run through the port's CPU
  engine and its device engine (``device="cpu"``) and give the JAX CPU
  engine's rows; its DataFrame twins, parse errors and unknown names too.
- A mirror of ``tests/test_sql_params.py`` (placeholders bound on the AST).
- The 22 TPC-H SQL texts give the rows of the port's own DataFrame queries
  at SF 0.002 (``tests/test_tpch_sql.py``'s check), on the port's device
  engine (``device="cpu"``). q19's text keeps its join keys inside OR
  branches, so it crosses lineitem with part (4.8 M pairs) before its
  filter: about 40 s here.
- TPC-DS q2 compiles in under a second (the memoized logical ``schema``).
"""
from __future__ import annotations

import datetime as dt
import time

import pytest
import torch

pytest.importorskip("jax")  # the reference; absent on a machine with only the port

import pyarrow as pa  # noqa: E402

from harness import _normalize, _values_equal, cpu_session  # noqa: E402
from spark_rapids_tpu import functions as JF  # noqa: E402
from spark_rapids_tpu.sql import parse as jax_parse  # noqa: E402
from spark_rapids_tpu.tpcds import tpcds_sql as jax_tpcds_sql  # noqa: E402
from spark_rapids_tpu.tpch.sql_queries import tpch_sql as jax_tpch_sql  # noqa: E402
from spark_rapids_tpu_torch import TorchSession  # noqa: E402
from spark_rapids_tpu_torch import functions as PF  # noqa: E402
from spark_rapids_tpu_torch.sql import bind_parameters, parse  # noqa: E402
from spark_rapids_tpu_torch.sql.parser import Node, SqlError  # noqa: E402
from spark_rapids_tpu_torch.tpcds import QUERY_IDS, register_tables, tpcds_sql  # noqa: E402
from spark_rapids_tpu_torch.tpch.datagen import TABLES as TPCH_TABLES  # noqa: E402
from spark_rapids_tpu_torch.tpch.datagen import gen_table as tpch_gen_table  # noqa: E402
from spark_rapids_tpu_torch.tpch.queries import QUERIES as TPCH_QUERIES  # noqa: E402
from spark_rapids_tpu_torch.tpch.queries import tpch_query  # noqa: E402
from spark_rapids_tpu_torch.tpch.sql_queries import tpch_sql  # noqa: E402
from test_sql import QUERIES as SQL_QUERIES  # noqa: E402
from test_sql import _tables  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in several
    worker processes at once, and torch's thread pools oversubscribe the
    cores (queries slow down tenfold and more)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_rows_equal(a, b, what):
    a, b = _normalize(a, True), _normalize(b, True)
    assert len(a) == len(b), f"{what}: {len(a)} vs {len(b)} rows\n{a[:5]}\n{b[:5]}"
    for i, (ra, rb) in enumerate(zip(a, b)):
        assert len(ra) == len(rb), f"{what} row {i}: {ra} vs {rb}"
        for j, (x, y) in enumerate(zip(ra, rb)):
            assert _values_equal(x, y, approx_float=True), f"{what} row {i} col {j}: {x!r} vs {y!r}"


# ── parser ──────────────────────────────────────────────────────────────────


@pytest.mark.parametrize("n", range(1, 23))
def test_tpch_text_parses_like_the_jax_package(n):
    assert repr(parse(tpch_sql(n, sf=1.0))) == repr(jax_parse(jax_tpch_sql(n, sf=1.0)))


@pytest.mark.parametrize("n", QUERY_IDS)
def test_tpcds_text_parses_like_the_jax_package(n):
    assert tpcds_sql(n) == jax_tpcds_sql(n)
    assert repr(parse(tpcds_sql(n))) == repr(jax_parse(jax_tpcds_sql(n)))


# ── tests/test_sql.py, through both port engines ────────────────────────────


def _views(s):
    orders, cust = _tables()
    s.create_dataframe(orders).create_or_replace_temp_view("orders")
    s.create_dataframe(cust).create_or_replace_temp_view("cust")
    return s


@pytest.fixture(scope="module")
def sql_sessions():
    jax_cpu = _views(cpu_session())
    port_cpu = _views(TorchSession({"spark.rapids.sql.enabled": False}, device="cpu"))
    port_dev = _views(
        TorchSession(
            {"spark.rapids.sql.enabled": True, "spark.sql.shuffle.partitions": 2},
            device="cpu",
        )
    )
    return jax_cpu, port_cpu, port_dev


@pytest.mark.parametrize("i", range(len(SQL_QUERIES)))
def test_sql_statement_matches_jax(sql_sessions, i):
    jax_cpu, port_cpu, port_dev = sql_sessions
    want = jax_cpu.sql(SQL_QUERIES[i]).collect()
    assert_rows_equal(port_cpu.sql(SQL_QUERIES[i]).collect(), want, f"port CPU engine #{i}")
    assert_rows_equal(port_dev.sql(SQL_QUERIES[i]).collect(), want, f"port device engine #{i}")


def _dataframe_twins(s, F):
    o = s.table("orders")
    c = s.table("cust")
    col = F.col
    return [
        (
            "select tag, sum(amt) s from orders where amt > 25 group by tag order by tag",
            o.filter(col("amt") > 25).group_by("tag").agg(F.sum(col("amt")).alias("s")).order_by("tag"),
        ),
        (
            "select o.o_id, c.city from orders o join cust c on o.c_id = c.c_id order by o.o_id limit 12",
            o.join(c, on=[("c_id", "c_id")]).select("o_id", "city").order_by("o_id").limit(12),
        ),
        (
            "select c_id, count(distinct tag) dt from orders group by c_id order by c_id",
            o.group_by("c_id").agg(F.count_distinct(col("tag")).alias("dt")).order_by("c_id"),
        ),
    ]


def test_sql_matches_dataframe_api(sql_sessions):
    _, port_cpu, port_dev = sql_sessions
    for s in (port_cpu, port_dev):
        for sql, df in _dataframe_twins(s, PF):
            assert _normalize(s.sql(sql).collect(), True) == _normalize(df.collect(), True), sql


def test_parse_errors_are_loud():
    for bad in [
        "select from orders",
        "select * from",
        "select o_id from orders extra_token)",
        "select * from orders where",
        "select * from orders group by",
    ]:
        with pytest.raises(SqlError):
            parse(bad)


def test_unknown_names_are_loud(sql_sessions):
    port_cpu = sql_sessions[1]
    for bad in ("select nope from orders", "select * from nonexistent", "select x.o_id from orders o"):
        with pytest.raises(SqlError):
            port_cpu.sql(bad)


def test_temp_views_and_table(sql_sessions):
    s = sql_sessions[1]
    assert s.table("ORDERS") is s.table("orders")
    s.create_or_replace_temp_view("o2", s.table("orders").limit(3))
    assert len(s.sql("select * from o2").collect()) == 3
    assert s.drop_temp_view("o2") and not s.drop_temp_view("o2")
    with pytest.raises(ValueError):
        s.table("o2")


def test_set_ops_rollup_cube_match_jax(sql_sessions):
    """The DataFrame forms the compiler builds on: intersect, subtract,
    distinct, drop_duplicates, drop, rollup and cube."""
    jax_cpu, port_cpu, port_dev = sql_sessions

    def build(s, F):
        o, c = s.table("orders"), s.table("cust")
        a = o.select("c_id")
        b = c.filter(F.col("city") != "city0").select("c_id")
        return [
            a.intersect(b),
            a.subtract(b),
            o.select("tag", "c_id").distinct(),
            o.drop_duplicates(["tag"]).select("tag"),
            o.drop("amt", "d", "nope"),
            o.rollup("tag", "c_id").agg(F.count(F.col("o_id")).alias("n")),
            c.cube("city", "name").agg(F.count(F.col("c_id")).alias("n")),
        ]

    for want, got_c, got_d in zip(build(jax_cpu, JF), build(port_cpu, PF), build(port_dev, PF)):
        w = want.collect()
        assert_rows_equal(got_c.collect(), w, "port CPU engine")
        assert_rows_equal(got_d.collect(), w, "port device engine")


# ── tests/test_sql_params.py ────────────────────────────────────────────────


@pytest.fixture(scope="module")
def param_session():
    s = TorchSession({"spark.rapids.sql.enabled": True}, device="cpu")
    s.create_dataframe(
        pa.table(
            {
                "n": pa.array([1, 2, 3, 4, 5], type=pa.int64()),
                "name": ["a", "b", "x' or '1'='1", "d; drop table t --", "e"],
                "price": [1.5, 2.5, 3.5, 4.5, 5.5],
                "day": pa.array([dt.date(2024, 1, d) for d in range(1, 6)], type=pa.date32()),
            }
        )
    ).create_or_replace_temp_view("t")
    return s


def _walk_nodes(n):
    out = [n]
    if isinstance(n, Node):
        for v in n.f.values():
            if isinstance(v, Node):
                out.extend(_walk_nodes(v))
    return out


def test_placeholders_parse_and_count():
    assert parse("select n from t where n < ? and name = ? or price > ?").n_params == 3
    assert parse("select 1").n_params == 0
    assert parse("select '?' as q, ? as p from t").n_params == 1


def test_placeholder_binding():
    bound = bind_parameters(parse("select ? as a, ? as b from t"), [10, 20])
    assert bound.body.items[0][0] == Node("lit", value=10)
    assert bound.body.items[1][0] == Node("lit", value=20)
    q = parse("select n from t where n = ?")
    b1, b2 = bind_parameters(q, [1]), bind_parameters(q, [2])
    assert b1.body.where != b2.body.where
    assert any(n.kind == "param" for n in _walk_nodes(q.body.where))


def test_param_arity_and_type_errors(param_session):
    with pytest.raises(SqlError, match="2 parameter"):
        bind_parameters(parse("select ? + ?"), [1])
    with pytest.raises(SqlError, match="0 parameter"):
        bind_parameters(parse("select 1"), [1])
    with pytest.raises(SqlError, match="unsupported parameter type"):
        bind_parameters(parse("select ?"), [object()])
    with pytest.raises(SqlError, match="unbound parameter"):
        param_session.sql("select n from t where n = ?").collect()


@pytest.mark.parametrize(
    "sql,params,want",
    [
        ("select n, price from t where n >= ? and price < ? order by n", [2, 4.0], [(2, 2.5), (3, 3.5)]),
        ("select n from t where name = ?", ["b"], [(2,)]),
        ("select n from t where name = ?", [None], []),
        ("select n from t where (n < 3) = ? order by n", [True], [(1,), (2,)]),
        ("select n from t where day = ?", [dt.date(2024, 1, 3)], [(3,)]),
        ("select n from t where cast(day as timestamp) = ?", [dt.datetime(2024, 1, 2)], [(2,)]),
        ("select ? as tag, count(*) as c from t", ["all"], [("all", 5)]),
        ("select n from t where name = ?", ["x' or '1'='1"], [(3,)]),
        ("select n from t where name = ?", ["d; drop table t --"], [(4,)]),
        ("select count(*) from t where name = ?", ["why?"], [(0,)]),
    ],
)
def test_params_execute(param_session, sql, params, want):
    assert param_session.sql(sql, params=params).collect() == want
    assert param_session.sql("select count(*) from t").collect() == [(5,)]


# ── TPC-H from SQL text against the port's DataFrame queries ────────────────

TPCH_SF = 0.002


@pytest.fixture(scope="module")
def tpch_session():
    s = TorchSession({"spark.rapids.sql.enabled": True}, device="cpu")
    for name in TPCH_TABLES:
        s.create_dataframe(tpch_gen_table(name, TPCH_SF)).create_or_replace_temp_view(name)
    return s


@pytest.mark.parametrize("n", sorted(TPCH_QUERIES))
def test_tpch_sql_matches_dataframe(n, tpch_session):
    s = tpch_session
    hand = tpch_query(n, s.table, sf=1.0)
    sql_df = s.sql(tpch_sql(n, sf=1.0))
    # the hand translations do not keep the spec's column order
    by_name = {c.lower(): c for c in hand.columns}
    assert all(c.lower() in by_name for c in sql_df.columns), (sql_df.columns, hand.columns)
    want = hand.select(*[by_name[c.lower()] for c in sql_df.columns]).collect()
    assert_rows_equal(sql_df.collect(), want, f"q{n}")


def test_tpcds_q2_compiles_in_under_a_second():
    s = TorchSession({}, device="cpu")
    register_tables(s, 0.002)
    t0 = time.perf_counter()
    df = s.sql(tpcds_sql(2))
    names = df.columns
    took = time.perf_counter() - t0
    assert names and took < 1.0, f"q2 compiled in {took:.2f} s"


def test_renamed_self_join_reads_only_the_columns_it_uses():
    """The compiler renames the right side of a self-join with a projection
    over every column; the port's pruning drops the outputs nothing reads,
    so each scan of date_dim uploads only the columns the query uses, and
    the rows stay the JAX CPU engine's."""
    from spark_rapids_tpu.tpcds import register_tables as jax_register

    text = (
        "select a.d_year, count(*) c from date_dim a join date_dim b "
        "on a.d_date_sk = b.d_date_sk where b.d_moy = 1 group by a.d_year"
    )
    s = TorchSession({"spark.rapids.sql.test.enabled": True}, device="cpu")
    register_tables(s, 0.002)
    got = s.sql(text).collect()
    scans = [e.node for e in s._last_overrides.explain if e.node.startswith("CpuScan")]
    assert sorted(scans) == ["CpuScan['d_date_sk', 'd_moy']", "CpuScan['d_date_sk', 'd_year']"], scans
    j = cpu_session()
    jax_register(j, 0.002)
    assert_rows_equal(got, j.sql(text).collect(), "pruned self-join")
