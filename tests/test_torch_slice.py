"""The port's slices end to end: TPC-H q1 and q6, the two ``contains``
queries and ``orders_by_priority`` through TorchSession (device="cpu"), held
against the JAX package's device engine on JAX-CPU and its CPU engine, rows
within the harness's tolerance (rel 1e-9, abs 1e-11), with no compute
fallback in the port's plan; q1, q6, ``orders_by_priority``,
``q18_big_orders`` and ``union_limit`` also from 3 input partitions at 2
shuffle partitions, through the device exchange. The TPC-H join queries
q4, q5, q7, q8, q12, q17 and q19 over all eight tables, under broadcast
plans (the default threshold) and shuffled ones (threshold -1, 3 input
partitions at 2 shuffle partitions), against the JAX CPU engine; q4 and
q12 (both plans) and q5 (broadcast plans) also against the JAX device
engine, with the same join execs in the plan. Also the partial aggregate's merge of several batches, the
out-of-core sort, and the port's import and device rules."""
from __future__ import annotations

import pathlib
import subprocess
import sys

import pytest
import torch

pytest.importorskip("jax")  # the reference; absent on a machine with only the port

from harness import _normalize, _values_equal, cpu_session, tpu_session
from spark_rapids_tpu.tpch.datagen import gen_table as jax_gen_table
from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch import functions as PF
from spark_rapids_tpu_torch.ops import strings_kernels as SK
from spark_rapids_tpu_torch.tpch.datagen import gen_orders_lineitem
from spark_rapids_tpu_torch.tpch.datagen import gen_table as port_gen_table
from spark_rapids_tpu_torch.tpch.queries import JOIN_QUERIES, SLICE_QUERIES

import spark_rapids_tpu.functions as JF
from spark_rapids_tpu.config import SQL_ENABLED as _JAX_SQL_ENABLED

SF = 0.002


@pytest.fixture(scope="module")
def tables():
    o, l = gen_orders_lineitem(SF)
    return {"orders": o, "lineitem": l}


@pytest.fixture(scope="module")
def jax_tables():
    return {n: jax_gen_table(n, SF) for n in ("orders", "lineitem")}


_ALL_TABLES = ("nation", "region", "supplier", "customer", "part", "orders", "lineitem")


@pytest.fixture(scope="module")
def all_tables(tables):
    out = {n: port_gen_table(n, SF) for n in _ALL_TABLES if n not in tables}
    return {**out, **tables}


@pytest.fixture(scope="module")
def all_jax_tables(jax_tables):
    out = {n: jax_gen_table(n, SF) for n in _ALL_TABLES if n not in jax_tables}
    return {**out, **jax_tables}


def _port_session(enabled=True, device="cpu"):
    return TorchSession(
        {"spark.rapids.sql.enabled": enabled, "spark.rapids.sql.test.enabled": enabled},
        device=device,
    )


def _assert_rows_equal(a, b, what):
    a, b = _normalize(a, True), _normalize(b, True)
    assert len(a) == len(b), f"{what}: {len(a)} vs {len(b)} rows"
    for i, (ra, rb) in enumerate(zip(a, b)):
        assert len(ra) == len(rb), f"{what} row {i}: {ra} vs {rb}"
        for j, (x, y) in enumerate(zip(ra, rb)):
            assert _values_equal(x, y, approx_float=True), f"{what} row {i} col {j}: {x!r} vs {y!r}"


def _no_compute_fallback(session, allowed=("CpuScan",)):
    bad = [
        (e.node, e.reasons)
        for e in session._last_overrides.explain
        if not e.on_device and not e.node.startswith(allowed)
    ]
    assert not bad, f"compute fallbacks: {bad}"


def _explain(session) -> dict:
    """The last plan's explain entries by node name."""
    return {e.node.split(" ")[0].split("[")[0]: e for e in session._last_overrides.explain}


def _jax_query(name):
    """The slice's queries written against the JAX package's functions."""
    col, count, lit = JF.col, JF.count, JF.lit
    if name in ("q1", "q6"):
        from spark_rapids_tpu.tpch import queries

        return getattr(queries, name)
    if name == "orders_by_priority":
        return lambda t: t("orders").select("o_orderkey", "o_orderpriority", "o_totalprice").order_by(
            col("o_orderpriority"), col("o_totalprice").desc(), col("o_orderkey")
        )
    if name == "q18_big_orders":
        return lambda t: (
            t("lineitem").select("l_orderkey", "l_quantity")
            .group_by("l_orderkey")
            .agg(JF.sum(col("l_quantity")).alias("o_qty"))
            .filter(col("o_qty") > 300)
            .select(col("l_orderkey").alias("big_okey"))
            .order_by("big_okey")
        )
    if name == "union_limit":

        def union_limit(t):
            li = t("lineitem")
            cols = ("l_orderkey", "l_partkey", "l_quantity", "l_shipmode")
            air = li.filter(col("l_shipmode") == "AIR").select(*cols)
            reg = li.filter(col("l_shipmode") == "REG AIR").select(*cols)
            return air.union(reg).limit(100000)

        return union_limit
    if name == "contains_agg":
        return lambda t: t("orders").filter(col("o_comment").contains("special")).agg(
            count(lit(1)), JF.sum(col("o_totalprice"))
        )
    return lambda t: t("orders").filter(col("o_comment").contains("special")).select(
        "o_orderkey", "o_orderpriority", "o_comment"
    )


@pytest.mark.parametrize("parts", [1, 3])
@pytest.mark.parametrize("name", ["q6", "contains_agg", "contains_rows"])
def test_slice_query_matches_both_jax_engines(name, parts, tables, jax_tables):
    """The first slice's queries. One partition plans the aggregate
    complete; three plan it partial → single-partition exchange → final,
    all on the device."""
    fn, used = SLICE_QUERIES[name]
    port = _port_session()
    port_rows = fn(lambda t: port.create_dataframe(tables[t], num_partitions=parts)).collect()
    _no_compute_fallback(port)
    assert any(e.on_device and e.node.startswith("CpuFilter") for e in port._last_overrides.explain)
    jfn = _jax_query(name)
    for session in (tpu_session(), cpu_session()):
        rows = jfn(
            lambda t: session.create_dataframe(jax_tables[t], num_partitions=parts)
        ).collect()
        _assert_rows_equal(port_rows, rows, f"{name} port vs JAX")
    assert port_rows, name


@pytest.mark.parametrize("name", ["q1", "q6", "orders_by_priority", "q18_big_orders", "union_limit"])
def test_partitioned_slice_query_matches_both_jax_engines(name, tables, jax_tables):
    """From 3 input partitions at 2 shuffle partitions (the JAX TPC-H gate's
    setting): nothing off the device but the scans, every exchange a
    ``GpuShuffleExchange`` (union_limit has none), and the rows equal to
    both JAX engines', in order."""
    fn, _ = SLICE_QUERIES[name]
    conf = {"spark.sql.shuffle.partitions": 2}
    port = TorchSession(
        {"spark.rapids.sql.enabled": True, "spark.rapids.sql.test.enabled": True, **conf},
        device="cpu",
    )
    df = fn(lambda t: port.create_dataframe(tables[t], num_partitions=3))
    got = df.collect()
    _no_compute_fallback(port)
    plan = df.explain()
    assert ("GpuShuffleExchange" in plan) == (name != "union_limit"), plan
    assert "CpuShuffleExchange" not in plan
    if name == "union_limit":
        assert "GpuLimit" in plan and "GpuUnionExec" in plan
    assert got, name
    jfn = _jax_query(name)
    for session in (tpu_session(conf), cpu_session(conf)):
        want = jfn(lambda t: session.create_dataframe(jax_tables[t], num_partitions=3)).collect()
        _assert_rows_equal(got, want, f"{name} port vs JAX")


def test_slice_plans_fuse_the_filter_into_the_aggregate(tables):
    port = _port_session()
    fn, _ = SLICE_QUERIES["contains_agg"]
    df = fn(lambda t: port.create_dataframe(tables[t]))
    plan = df.explain()
    assert "GpuHashAggregate(complete)" in plan and "GpuFilter contains" in plan
    from spark_rapids_tpu_torch.exec.gpu import GpuFilterExec, GpuHashAggregateExec

    node = port._prepare_plan(df._plan)
    while not isinstance(node, GpuHashAggregateExec):
        node = node.children[0]
    child, pre_filter = node._fused_child()
    assert pre_filter is not None and not isinstance(child, GpuFilterExec)


def test_device_aggregates_and_predicates_match_cpu_engine(tables):
    """The rest of the slice's device surface: ungrouped min/max/avg/first,
    or/not/null tests and string equality, against the port's CPU engine."""
    col, lit = PF.col, PF.lit

    def build(s):
        o = s.create_dataframe(tables["orders"])
        return o.filter(
            ((col("o_orderstatus") == "F") | ~(col("o_totalprice") > 100000.0))
            & col("o_comment").is_not_null()
            & (col("o_custkey") + lit(1) - lit(1) >= 0)
        ).agg(
            PF.min(col("o_totalprice")),
            PF.max(col("o_orderdate")),
            PF.avg(col("o_totalprice")),
            PF.count(col("o_custkey")),
            PF.sum(col("o_custkey") * lit(2)),
            PF.first(col("o_orderkey")),
        )

    dev = _port_session()
    got = build(dev).collect()
    _no_compute_fallback(dev)
    want = build(_port_session(enabled=False)).collect()
    _assert_rows_equal(got, want, "device vs CPU engine")


def test_unported_nodes_fall_back_with_a_reason(tables):
    """A collect alongside a DISTINCT aggregate merges partial arrays, which
    stays on the CPU engine (as in the JAX package), says why in the
    explain, and still gives the CPU engine's rows; the top-N above it runs
    on the device (``GpuTakeOrderedAndProject``)."""
    col = PF.col
    dev = TorchSession({"spark.rapids.sql.enabled": True}, device="cpu")

    def build(s):
        return (
            s.create_dataframe(tables["orders"])
            .filter(col("o_comment").contains("special"))
            .group_by("o_orderpriority")
            .agg(
                PF.size(PF.collect_list(col("o_orderstatus"))).alias("st"),
                PF.count_distinct(col("o_orderkey")).alias("n"),
            )
            .order_by("o_orderpriority")
            .limit(3)
        )

    df = build(dev)
    got = df.collect()
    reasons = [r for e in dev._last_overrides.explain for r in e.reasons]
    assert ("merging partial collect arrays (collect alongside DISTINCT aggregates) runs on "
            "the CPU engine") in reasons
    assert _explain(dev)["CpuTakeOrderedAndProject"].on_device
    assert "GpuTakeOrderedAndProject" in df.explain()
    assert _explain(dev)["CpuFilter"].on_device
    want = build(_port_session(enabled=False)).collect()
    assert got == want and len(got) == 3


def test_torch_session_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchSession()
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchSession(device="cuda")


def test_port_imports_no_jax_and_no_jax_package():
    """Importing the port and running its slice queries and all 22 TPC-H
    queries leaves jax and every spark_rapids_tpu module out of
    sys.modules (module names compared exactly: the port's own name shares
    the prefix)."""
    code = """
import sys
from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch.tpch.datagen import TABLES, gen_table
from spark_rapids_tpu_torch.tpch.queries import QUERIES, SLICE_QUERIES, tpch_query
tables = {n: gen_table(n, 0.0002) for n in TABLES}
s = TorchSession({"spark.rapids.sql.enabled": True}, device="cpu")
for fn, _ in SLICE_QUERIES.values():
    fn(lambda t: s.create_dataframe(tables[t])).collect()
for n in QUERIES:
    tpch_query(n, lambda t: s.create_dataframe(tables[t])).collect()
bad = sorted(
    m for m in sys.modules
    if m == "jax" or m.startswith("jax.") or m == "jaxlib" or m.startswith("jaxlib.")
    or m == "spark_rapids_tpu" or m.startswith("spark_rapids_tpu.")
)
print("BAD", bad)
print("ARROW", "pyarrow" in sys.modules)
"""
    root = pathlib.Path(__file__).resolve().parents[1]
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120, cwd=root
    )
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    assert "ARROW False" in out.stdout, out.stdout


def test_runtime_modules_import_no_jax_and_no_jax_package():
    """Importing every module of the query runtime, and running a traced,
    ledgered, fused, pipelined and concurrent query through admission,
    leaves jax and every spark_rapids_tpu module out of sys.modules."""
    code = """
import importlib, sys
mods = ["spark_rapids_tpu_torch.obs.metrics", "spark_rapids_tpu_torch.obs.trace",
        "spark_rapids_tpu_torch.obs.ledger", "spark_rapids_tpu_torch.obs.export",
        "spark_rapids_tpu_torch.obs.scrape", "spark_rapids_tpu_torch.obs.calibration",
        "spark_rapids_tpu_torch.profiling", "spark_rapids_tpu_torch.exec.pipeline",
        "spark_rapids_tpu_torch.sched.estimate", "spark_rapids_tpu_torch.sched.admission",
        "spark_rapids_tpu_torch.sched.scheduler", "spark_rapids_tpu_torch.sched.speculation",
        "spark_rapids_tpu_torch.resilience.watchdog", "spark_rapids_tpu_torch.plan.fusion"]
for m in mods:
    importlib.import_module(m)
import numpy as np
from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch.functions import col, lit
s = TorchSession({"spark.rapids.tpu.trace.enabled": True}, device="cpu")
df = s.create_dataframe({"a": np.arange(100, dtype=np.int64)}, num_partitions=4)
assert df.filter(col("a") > 3).select((col("a") + lit(1)).alias("b")).collect()
assert s._last_fused_stages == 1 and s._last_tracer is not None and s._last_ledger is not None
bad = sorted(
    m for m in sys.modules
    if m == "jax" or m.startswith("jax.") or m == "jaxlib" or m.startswith("jaxlib.")
    or m == "spark_rapids_tpu" or m.startswith("spark_rapids_tpu.")
)
print("BAD", bad)
"""
    root = pathlib.Path(__file__).resolve().parents[1]
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120, cwd=root
    )
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def test_cpu_run_launches_no_kernel(tables):
    before = SK.LAUNCHES
    port = _port_session()
    fn, _ = SLICE_QUERIES["contains_rows"]
    fn(lambda t: port.create_dataframe(tables[t])).collect()
    assert SK.LAUNCHES == before


def test_q1_falls_back_per_node_and_matches_jax(tables, jax_tables):
    """q1 runs on the device end to end: the filter fused into the complete
    aggregate, the sort on the device, nothing off it but the scan; the rows
    are the JAX engines', in order, as the sort gives them."""
    port = _port_session()
    df = SLICE_QUERIES["q1"][0](lambda t: port.create_dataframe(tables[t]))
    got = df.collect()
    _no_compute_fallback(port)
    explain = _explain(port)
    assert explain["CpuHashAggregate(complete)"].on_device and explain["CpuSortExec"].on_device
    plan = df.explain()
    assert "GpuSort" in plan and "GpuHashAggregate(complete)" in plan
    for session in (tpu_session(), cpu_session()):
        want = _jax_query("q1")(lambda t: session.create_dataframe(jax_tables[t])).collect()
        assert len(got) == len(want) == 4
        _assert_rows_equal(got, want, "q1 port vs JAX")


def test_orders_by_priority_matches_both_jax_engines(tables, jax_tables):
    """All of orders sorted on the device by a string, a descending double
    and a long key, rows in order."""
    port = _port_session()
    got = SLICE_QUERIES["orders_by_priority"][0](lambda t: port.create_dataframe(tables[t])).collect()
    _no_compute_fallback(port)
    assert len(got) == tables["orders"].num_rows
    for session in (tpu_session(), cpu_session()):
        want = _jax_query("orders_by_priority")(
            lambda t: session.create_dataframe(jax_tables[t])
        ).collect()
        _assert_rows_equal(got, want, "orders_by_priority port vs JAX")


def _q1_rows(tables, conf, parts):
    port = TorchSession(
        {"spark.rapids.sql.enabled": True, "spark.rapids.sql.test.enabled": True, **conf},
        device="cpu",
    )
    rows = SLICE_QUERIES["q1"][0](
        lambda t: port.create_dataframe(tables[t], num_partitions=parts)
    ).collect()
    return port, rows


def test_q1_two_partitions_partial_and_final_on_device(tables, jax_tables):
    """Two input partitions plan partial → hash exchange → final → range
    exchange → sort, every node on the device (strict mode, nothing
    allowed off it): both exchanges are ``GpuShuffleExchange``."""
    port, got = _q1_rows(tables, {"spark.sql.shuffle.partitions": 2}, parts=2)
    _no_compute_fallback(port)
    explain = _explain(port)
    assert explain["CpuHashAggregate(partial)"].on_device
    assert explain["CpuHashAggregate(final)"].on_device
    exchanges = [e for e in port._last_overrides.explain if e.node.startswith("CpuShuffleExchange")]
    assert len(exchanges) == 2 and all(e.on_device for e in exchanges)
    plan = SLICE_QUERIES["q1"][0](lambda t: port.create_dataframe(tables[t], num_partitions=2)).explain()
    assert "GpuShuffleExchange HashPartitioning" in plan
    assert "GpuShuffleExchange RangePartitioning" in plan
    want = _jax_query("q1")(
        lambda t: cpu_session().create_dataframe(jax_tables[t], num_partitions=2)
    ).collect()
    _assert_rows_equal(got, want, "q1 at 2 partitions vs the JAX CPU engine")


def test_q1_several_batches_per_partition_merge_on_device(tables, jax_tables, monkeypatch):
    """A batch size of a few hundred rows cuts each partition into many
    batches: the partial aggregate updates each, shrinks the partials with
    one row-count fetch, concatenates and merges them. The hash exchange
    then shrinks the two partitions' merged partials with one more fetch."""
    from spark_rapids_tpu_torch.exec import gpu as G

    shrunk = []
    real = G.bulk_shrink
    monkeypatch.setattr(G, "bulk_shrink", lambda bs: shrunk.append(len(bs)) or real(bs))
    _, got = _q1_rows(tables, {"spark.rapids.sql.batchSizeBytes": 32 << 10}, parts=2)
    assert len(shrunk) == 3 and min(shrunk[:2]) > 10 and shrunk[2] == 2, shrunk
    want = _jax_query("q1")(lambda t: cpu_session().create_dataframe(jax_tables[t])).collect()
    _assert_rows_equal(got, want, "q1 from many batches vs the JAX CPU engine")


def test_sort_out_of_core_equals_single_batch_sort(tables, jax_tables, monkeypatch):
    """Past a tiny out-of-core threshold the sort makes a run of each batch
    and merges runs pairwise; the rows equal the single-batch sort's."""
    from spark_rapids_tpu_torch.exec import gpu as G

    merges = []
    real = G.device_merge_fn

    def counting(order):
        merge = real(order)
        return lambda a, b: merges.append(1) or merge(a, b)

    fn = SLICE_QUERIES["orders_by_priority"][0]
    single = fn(lambda t: _port_session().create_dataframe(tables[t])).collect()
    assert not merges
    monkeypatch.setattr(G, "device_merge_fn", counting)
    port = TorchSession(
        {
            "spark.rapids.sql.enabled": True,
            "spark.rapids.sql.test.enabled": True,
            "spark.rapids.sql.batchSizeBytes": 16 << 10,
            "spark.rapids.tpu.sort.outOfCoreThresholdBytes": 1,
        },
        device="cpu",
    )
    runs = fn(lambda t: port.create_dataframe(tables[t])).collect()
    assert len(merges) >= 3  # at least four runs
    assert runs == single


_EDGE = {
    "s": ["abc special", None, "", "xspecialx", "nothing", None, "specia", "special"],
    "v": [1.5, 2.0, float("nan"), -0.0, 4.0, 5.0, 6.0, 7.0],
    "k": list(range(8)),
}


def _edge_query(F, s, data, pat, rows):
    col, lit = F.col, F.lit
    df = s.create_dataframe(data).filter(col("s").contains(pat))
    if rows:
        return df.select("k", "s", "v")
    return df.agg(
        F.count(lit(1)), F.sum(col("v")), F.min(col("v")), F.max(col("v")),
        F.first(col("s")), F.count(col("s")),
    )


@pytest.mark.parametrize("rows", [False, True])
@pytest.mark.parametrize("pat", ["special", "zzz", "", "x" * 40])
def test_contains_edge_cases_match_jax(pat, rows):
    """Null and empty strings, NaN and -0.0, no match, the empty pattern and
    one longer than the plane: the port's device path, its CPU engine and
    the JAX CPU engine agree."""
    import numpy as np
    import pyarrow as pa

    port_data = {
        "s": _EDGE["s"],
        "v": np.asarray(_EDGE["v"]),
        "k": np.asarray(_EDGE["k"], dtype=np.int64),
    }
    dev = _port_session()
    got = _edge_query(PF, dev, port_data, pat, rows).collect()
    _no_compute_fallback(dev)
    cpu = _edge_query(PF, _port_session(enabled=False), port_data, pat, rows).collect()
    jax_rows = _edge_query(
        JF, cpu_session(), pa.table({k: pa.array(v) for k, v in _EDGE.items()}), pat, rows
    ).collect()
    _assert_rows_equal(got, cpu, "device vs CPU engine")
    _assert_rows_equal(got, jax_rows, "port vs JAX CPU engine")


#: the join queries' two plan shapes: every join that may broadcast does
#: (the default threshold, one input partition), or none does (threshold
#: -1, 3 input partitions at 2 shuffle partitions)
_JOIN_MODES = {
    "broadcast": ({}, 1, "GpuBroadcastHashJoin"),
    "shuffled": (
        {"spark.sql.autoBroadcastJoinThreshold": -1, "spark.sql.shuffle.partitions": 2},
        3,
        "GpuShuffledHashJoin",
    ),
}


def _join_kinds(plan: str) -> list:
    """The plan's hash joins in tree order, without the engine's prefix."""
    return [
        ln.strip().lstrip("* ").split(" ")[0][3:]
        for ln in plan.splitlines()
        if "HashJoin" in ln
    ]


@pytest.mark.parametrize("mode", list(_JOIN_MODES))
@pytest.mark.parametrize("name", list(JOIN_QUERIES))
def test_join_query_matches_jax(name, mode, all_tables, all_jax_tables):
    """A TPC-H join query through the port (device="cpu", strict mode):
    nothing off the device but the scans, the mode's join exec in the plan,
    and the rows equal to the JAX CPU engine's within the harness's
    tolerance, in order. q4 and q12 in both modes, and q5 under broadcast
    plans, are also held against the JAX device engine, whose plan must
    hold the same hash joins (its compiles on JAX-CPU bound how many)."""
    from spark_rapids_tpu.tpch import queries as jq

    conf, parts, kind = _JOIN_MODES[mode]
    fn, used = JOIN_QUERIES[name]
    port = TorchSession(
        {"spark.rapids.sql.enabled": True, "spark.rapids.sql.test.enabled": True, **conf},
        device="cpu",
    )
    df = fn(lambda t: port.create_dataframe(all_tables[t], num_partitions=parts))
    got = df.collect()
    _no_compute_fallback(port)
    plan = df.explain()
    assert kind in plan, plan
    if mode == "shuffled":
        assert "BroadcastHashJoin" not in plan, plan
    assert got, name
    jfn = getattr(jq, name)
    sessions = [cpu_session(conf)]
    if name in ("q4", "q12") or (name, mode) == ("q5", "broadcast"):
        sessions.append(tpu_session(conf))
    for session in sessions:
        jdf = jfn(lambda t: session.create_dataframe(all_jax_tables[t], num_partitions=parts))
        _assert_rows_equal(got, jdf.collect(), f"{name} ({mode}) port vs JAX")
        if session.conf.is_enabled(_JAX_SQL_ENABLED):
            assert _join_kinds(plan) == _join_kinds(jdf.explain()), (plan, jdf.explain())
