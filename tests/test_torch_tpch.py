"""All 22 TPC-H queries through the port, against the JAX package.

Each query at SF 0.002 goes through both of the port's engines — its device
engine (``device="cpu"``, strict mode) and its CPU engine — on one input
partition and on 3 input partitions at 2 shuffle partitions, and the rows
of each are held against the JAX CPU engine's (``cpu_session()``) within
the harness's tolerance (rel 1e-9, abs 1e-11), in order. The device plan
keeps nothing off the device but the scans, the subqueries' plans
included. q3 (top-N over a join and an aggregate), q13 (``Like`` under an
outer join) and q22 (``Substring`` and a scalar subquery) are also held
against the JAX device engine on one partition; only those three, to bound
its compiles. q11 uses the SF-1 fraction, as ``tests/test_tpch.py`` does:
at SF 0.002 the spec's ``0.0001 / SF`` keeps no part.

Also the subqueries on their own: a scalar subquery in a filter, an
``isin(df)`` whose set holds a NULL, the reference's errors for a
subquery of two columns or two rows, and a multi-DISTINCT aggregate (the
Expand rewrite) on both port engines."""
from __future__ import annotations

import pytest

pytest.importorskip("jax")  # the reference; absent on a machine with only the port

import pyarrow as pa  # noqa: E402

import spark_rapids_tpu.functions as JF  # noqa: E402
from harness import _normalize, _values_equal, cpu_session, tpu_session  # noqa: E402
from spark_rapids_tpu.tpch import queries as jq  # noqa: E402
from spark_rapids_tpu.tpch.datagen import gen_table as jax_gen_table  # noqa: E402
from spark_rapids_tpu_torch import TorchSession  # noqa: E402
from spark_rapids_tpu_torch import functions as PF  # noqa: E402
from spark_rapids_tpu_torch.tpch.datagen import TABLES  # noqa: E402
from spark_rapids_tpu_torch.tpch.datagen import gen_table as port_gen_table  # noqa: E402
from spark_rapids_tpu_torch.tpch.queries import QUERIES, tpch_query  # noqa: E402

SF = 0.002
Q11_SF = 1.0

#: (conf, input partitions) of the two plan shapes
_MODES = {
    "one": ({}, 1),
    "partitioned": ({"spark.sql.shuffle.partitions": 2}, 3),
}


@pytest.fixture(scope="module")
def port_tables():
    return {n: port_gen_table(n, SF) for n in TABLES}


@pytest.fixture(scope="module")
def jax_tables():
    return {n: jax_gen_table(n, SF) for n in TABLES}


def _port(enabled: bool, conf: dict) -> TorchSession:
    return TorchSession(
        {"spark.rapids.sql.enabled": enabled, "spark.rapids.sql.test.enabled": enabled, **conf},
        device="cpu",
    )


def assert_rows_equal(a, b, what):
    a, b = _normalize(a, True), _normalize(b, True)
    assert len(a) == len(b), f"{what}: {len(a)} vs {len(b)} rows"
    for i, (ra, rb) in enumerate(zip(a, b)):
        assert len(ra) == len(rb), f"{what} row {i}: {ra} vs {rb}"
        for j, (x, y) in enumerate(zip(ra, rb)):
            assert _values_equal(x, y, approx_float=True), f"{what} row {i} col {j}: {x!r} vs {y!r}"


def assert_no_compute_fallback(session):
    bad = [
        (e.node, e.reasons)
        for e in session._last_overrides.explain
        if not e.on_device and not e.node.startswith("CpuScan")
    ]
    assert not bad, f"compute fallbacks: {bad}"


@pytest.mark.parametrize("mode", list(_MODES))
@pytest.mark.parametrize("n", sorted(QUERIES))
def test_tpch_query_matches_jax(n, mode, port_tables, jax_tables):
    conf, parts = _MODES[mode]
    dev = _port(True, conf)
    got = tpch_query(n, lambda t: dev.create_dataframe(port_tables[t], num_partitions=parts), Q11_SF).collect()
    assert_no_compute_fallback(dev)
    cpu = _port(False, conf)
    cpu_rows = tpch_query(
        n, lambda t: cpu.create_dataframe(port_tables[t], num_partitions=parts), Q11_SF
    ).collect()
    sessions = [cpu_session(conf)]
    if mode == "one" and n in (3, 13, 22):
        sessions.append(tpu_session(conf))
    for session in sessions:
        want = jq.tpch_query(
            n, lambda t: session.create_dataframe(jax_tables[t], num_partitions=parts), Q11_SF
        ).collect()
        assert_rows_equal(got, want, f"q{n} ({mode}) port device engine vs JAX")
        assert_rows_equal(cpu_rows, want, f"q{n} ({mode}) port CPU engine vs JAX")
    if n != 20:  # q20 keeps no supplier at this scale, in every engine
        assert got, f"q{n}"


# ── subqueries ──────────────────────────────────────────────────────────────

_SUB = {
    "k": [1, 2, 3, 4, 5, 6, 7, 8],
    "b": [10.0, 25.0, None, 40.0, 5.0, 30.0, 20.0, None],
    "s": ["a", "b", None, "c", "a", "d", "e", "b"],
}
_SET = {"x": ["a", None, "c", "a", "zz"], "y": [1, 2, 3, 4, 5]}


def _frames(s):
    """The main table and the subqueries' table, from Arrow in both
    packages."""
    main = s.create_dataframe(pa.table({k: pa.array(v) for k, v in _SUB.items()}))
    other = s.create_dataframe(pa.table({k: pa.array(v) for k, v in _SET.items()}))
    return main, other


def _subquery_cases():
    def scalar(F, main, other):
        avg_b = main.agg(F.avg(F.col("b")).alias("a"))
        return main.filter(F.col("b") > F.scalar_subquery(avg_b)).select("k", "b")

    def scalar_empty(F, main, other):
        none = other.filter(F.col("y") > 100).select("y")
        return main.filter(F.col("k") > F.scalar_subquery(none)).select("k")

    def in_set_with_null(F, main, other):
        # NULL in the set: rows that match stay, the others are NULL (not
        # false) — so NOT IN keeps none of them
        return main.select("k", F.col("s").isin(other.select("x")).alias("m"))

    def not_in_set_with_null(F, main, other):
        return main.filter(~F.col("s").isin(other.select("x"))).select("k")

    def in_set_numeric(F, main, other):
        return main.filter(F.col("k").isin(other.filter(F.col("y") > 2).select("y"))).select("k", "s")

    return {
        "scalar": scalar,
        "scalar_empty": scalar_empty,
        "in_set_with_null": in_set_with_null,
        "not_in_set_with_null": not_in_set_with_null,
        "in_set_numeric": in_set_numeric,
    }


_SUBQUERY_CASES = _subquery_cases()


@pytest.mark.parametrize("name", list(_SUBQUERY_CASES))
def test_subquery_matches_jax(name):
    """Scalar and IN subqueries resolved before planning: both port engines
    against the JAX CPU engine; the device plan (``InSet`` on the device)
    and the subqueries' own plans keep nothing off the device."""
    build = _SUBQUERY_CASES[name]
    results = []
    for enabled in (True, False):
        s = _port(enabled, {})
        main, other = _frames(s)
        results.append(build(PF, main, other).collect())
        if enabled:
            assert_no_compute_fallback(s)
    js = cpu_session()
    main, other = _frames(js)
    want = build(JF, main, other).collect()
    for got, what in zip(results, ("device", "CPU")):
        assert_rows_equal(got, want, f"{name}: port {what} engine vs JAX")


@pytest.mark.parametrize("enabled", [True, False])
def test_subquery_errors_are_the_references(enabled):
    s = _port(enabled, {})
    main, other = _frames(s)
    with pytest.raises(ValueError, match="scalar subquery must return one column, got 2"):
        main.filter(PF.col("k") > PF.scalar_subquery(other)).collect()
    with pytest.raises(ValueError, match="scalar subquery returned more than one row"):
        main.filter(PF.col("k") > PF.scalar_subquery(other.select("y"))).collect()
    with pytest.raises(ValueError, match="IN-subquery must return one column, got 2"):
        main.filter(PF.col("s").isin(other)).collect()


# ── several DISTINCT column sets: the Expand rewrite ────────────────────────

_DISTINCT = {
    "g": [1, 1, 2, 2, 2, 3, 3, 1, 2, 3, 1, 2],
    "a": [1, 1, 2, None, 2, 3, 4, 5, 6, 3, 1, 2],
    "b": ["x", "y", "x", "x", None, "y", "y", "z", "x", "w", "x", None],
    "v": [1.5, 2.5, None, 4.0, 5.0, 6.5, 7.0, 8.0, 9.0, 10.0, 11.0, 12.0],
}


@pytest.mark.parametrize("parts", [1, 3])
def test_multi_distinct_aggregate_matches_jax(parts):
    """count(DISTINCT a), count(DISTINCT b) with sum, count, min, avg and
    first beside them: planned as Expand → two aggregates, on the device
    (``GpuExpand``) and on the port's CPU engine, equal to the JAX CPU
    engine."""
    table = pa.table({k: pa.array(v) for k, v in _DISTINCT.items()})

    def build(F, s):
        return s.create_dataframe(table, num_partitions=parts).group_by("g").agg(
            F.count_distinct(F.col("a")).alias("da"),
            F.count_distinct(F.col("b")).alias("db"),
            F.sum(F.col("v")).alias("sv"),
            F.count(F.col("v")).alias("cv"),
            F.min(F.col("a")).alias("ma"),
            F.avg(F.col("v")).alias("av"),
        )

    conf = {"spark.sql.shuffle.partitions": 2}
    dev = _port(True, conf)
    df = build(PF, dev)
    got = df.collect()
    assert_no_compute_fallback(dev)
    assert "GpuExpand x3" in df.explain()
    cpu_rows = build(PF, _port(False, conf)).collect()
    want = build(JF, cpu_session(conf)).collect()
    assert_rows_equal(got, want, "device engine vs JAX")
    assert_rows_equal(cpu_rows, want, "CPU engine vs JAX")
    assert len(got) == 3
