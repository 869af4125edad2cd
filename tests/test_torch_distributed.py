"""Multi-device execution on the port's single-controller mesh with 8 CPU
members (``spark_rapids_tpu_torch/parallel/``), the mirror of
``tests/test_distributed.py``: planner-built queries (group-by, shuffled
join, global sort, rollup, window, multi-DISTINCT, nested columns) run with
``spark.rapids.sql.mesh.enabled`` and each exchange lowered to the mesh
exchange, held against the JAX CPU engine to the harness tolerance; and
the standalone partial → exchange → final group-sum step. The JAX package's
``test_mesh_nested_types_ride_ici`` is held against the JAX CPU engine only
here as there (its JAX mesh worker segfaults; the port's mesh does not
involve it).
"""
from __future__ import annotations

import numpy as np
import pytest

pytest.importorskip("jax")  # the reference; absent on a machine with only the port

import pyarrow as pa  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

from harness import _normalize, _values_equal, cpu_session  # noqa: E402

import spark_rapids_tpu.functions as JF  # noqa: E402
import spark_rapids_tpu_torch.functions as PF  # noqa: E402
from spark_rapids_tpu_torch import TorchSession  # noqa: E402
from spark_rapids_tpu_torch.parallel.distributed import (  # noqa: E402
    distributed_group_sum_step,
    make_mesh,
)
from spark_rapids_tpu_torch.plan.physical import Exec, PartitionSet  # noqa: E402

MESH_CONF = {
    "spark.rapids.sql.mesh.enabled": True,
    "spark.rapids.sql.mesh.size": 8,
    "spark.sql.autoBroadcastJoinThreshold": "-1",
    "spark.rapids.sql.test.enabled": True,
}


def mesh_session(extra=None) -> TorchSession:
    conf = dict(MESH_CONF)
    conf.update(extra or {})
    return TorchSession(conf, device="cpu")


def assert_mesh_equals_cpu(build_df, conf=None, sort=True):
    """``build_df(F, session)`` on the JAX CPU engine and on the port's
    mesh; rows equal to the harness tolerance; the mesh exchange ran."""
    want = _normalize(build_df(JF, cpu_session(conf)).collect(), sort)
    s = mesh_session(conf)
    got = _normalize(build_df(PF, s).collect(), sort)
    assert len(got) == len(want), f"{len(got)} vs {len(want)} rows; {got[:5]} vs {want[:5]}"
    for i, (a, b) in enumerate(zip(got, want)):
        assert _values_equal(tuple(a), tuple(b), True), f"row {i}: {a} vs {b}"
    assert s.mesh_context().stats["exchanges"] > 0, "no exchange took the mesh path"
    return s


# ── engine mesh mode: planner-built queries ────────────────────────────────


def test_mesh_group_by():
    rng = np.random.default_rng(31)
    t = pa.table({"k": rng.integers(0, 23, 4000), "x": rng.integers(-100, 100, 4000)})
    assert_mesh_equals_cpu(
        lambda F, s: s.create_dataframe(t, num_partitions=8).group_by("k").agg(
            F.sum(F.col("x")).alias("sx"), F.count(F.col("x")).alias("cx"),
            F.max(F.col("x")).alias("mx"))
    )


@pytest.mark.parametrize("how", ["inner", "left", "full"])
def test_mesh_shuffled_join(how):
    rng = np.random.default_rng(32)
    lt = pa.table({"k": rng.integers(0, 30, 3000), "lv": rng.integers(0, 99, 3000)})
    rt = pa.table({"k": rng.integers(0, 30, 400), "rv": rng.integers(0, 99, 400)})
    assert_mesh_equals_cpu(
        lambda F, s: s.create_dataframe(lt, num_partitions=8).join(
            s.create_dataframe(rt, num_partitions=4), on="k", how=how)
    )


def test_mesh_global_sort():
    rng = np.random.default_rng(33)
    t = pa.table({"a": rng.integers(-999, 999, 4000), "b": rng.random(4000)})
    # order matters: the collect output is compared unsorted
    assert_mesh_equals_cpu(
        lambda F, s: s.create_dataframe(t, num_partitions=8).order_by(F.col("a"), F.col("b")),
        sort=False,
    )


def test_mesh_string_keys():
    rng = np.random.default_rng(34)
    ks = [f"key_{int(i) % 19}" for i in rng.integers(0, 1000, 2500)]
    t = pa.table({"k": ks, "x": rng.integers(0, 50, 2500)})
    assert_mesh_equals_cpu(
        lambda F, s: s.create_dataframe(t, num_partitions=6).group_by("k").agg(
            F.count(F.col("x")).alias("c"), F.avg(F.col("x")).alias("a"))
    )


def test_mesh_empty_shards():
    """Fewer rows than members: most members are empty through the
    exchange."""
    t = pa.table({"k": [1, 2, 3], "x": [10, 20, 30]})
    assert_mesh_equals_cpu(
        lambda F, s: s.create_dataframe(t, num_partitions=8).group_by("k").agg(
            F.sum(F.col("x")).alias("sx"))
    )


def test_mesh_skew_escalation():
    """One hot key sends every row to one member: that member receives
    them all (the JAX exchange escalates its capacity for it; the port's
    dynamic shapes need no escalation) and no row is dropped."""
    n = 4000
    t = pa.table({"k": ["hot"] * (n - 100) + [f"c{i}" for i in range(100)], "x": np.arange(n)})
    assert_mesh_equals_cpu(
        lambda F, s: s.create_dataframe(t, num_partitions=8).group_by("k").agg(
            F.sum(F.col("x")).alias("sx"), F.count(F.col("x")).alias("c"))
    )
    # the partial aggregate folds the hot key before the exchange; a
    # repartition by it moves every hot row to one member
    s = mesh_session()
    got = s.create_dataframe(t, num_partitions=8).repartition(8, "k").collect()
    assert sorted(got) == sorted(zip(t.column("k").to_pylist(), t.column("x").to_pylist()))
    assert s.mesh_context().stats["max_received"] >= n - 100


def test_mesh_nulls_in_keys():
    rng = np.random.default_rng(36)
    ks = [int(v) if v % 5 else None for v in rng.integers(0, 25, 2000)]
    t = pa.table({"k": ks, "x": rng.integers(0, 9, 2000)})
    assert_mesh_equals_cpu(
        lambda F, s: s.create_dataframe(t, num_partitions=7).group_by("k").agg(
            F.count(F.col("x")).alias("c"))
    )


def test_mesh_join_then_agg():
    """Two exchanges deep: a join feeds a grouped aggregate."""
    rng = np.random.default_rng(37)
    lt = pa.table({"k": rng.integers(0, 15, 2000), "x": rng.integers(0, 50, 2000)})
    rt = pa.table({"k": list(range(15)), "w": list(range(0, 30, 2))})
    assert_mesh_equals_cpu(
        lambda F, s: s.create_dataframe(lt, num_partitions=8)
        .join(s.create_dataframe(rt, num_partitions=3), on="k", how="inner")
        .group_by("k").agg(F.sum(F.col("x")).alias("sx"), F.sum(F.col("w")).alias("sw"))
    )


def test_mesh_rollup():
    """Grouping sets ride the Expand exec, then a mesh exchange."""
    rng = np.random.default_rng(41)
    t = pa.table({"a": rng.integers(0, 5, 600), "b": rng.integers(0, 7, 600),
                  "x": rng.integers(0, 100, 600)})
    assert_mesh_equals_cpu(
        lambda F, s: s.create_dataframe(t, num_partitions=4).rollup("a", "b").agg(
            F.sum(F.col("x")).alias("t"), F.count("*").alias("n"))
    )


def test_mesh_window_after_exchange():
    """A window over mesh-exchanged partitions (partition_by keys hash to
    members; frames never cross members)."""
    from spark_rapids_tpu.window import Window as JW
    from spark_rapids_tpu_torch.window import Window as PW

    rng = np.random.default_rng(42)
    t = pa.table({"k": rng.integers(0, 16, 800), "d": rng.integers(0, 50, 800),
                  "v": rng.integers(0, 1000, 800) / 8.0})

    def q(F, s):
        W = JW if F is JF else PW
        w = W.partition_by("k").order_by("d", "v").rows_between(-2, 0)
        return s.create_dataframe(t, num_partitions=4).with_column("m", F.sum(F.col("v")).over(w))

    assert_mesh_equals_cpu(q)


def test_mesh_multi_distinct():
    """The Expand-based multi-DISTINCT rewrite under mesh execution."""
    rng = np.random.default_rng(43)
    t = pa.table({"k": rng.integers(0, 6, 700), "a": rng.integers(0, 40, 700),
                  "b": rng.integers(0, 25, 700)})
    assert_mesh_equals_cpu(
        lambda F, s: s.create_dataframe(t, num_partitions=4).group_by("k").agg(
            F.count_distinct(F.col("a")).alias("da"), F.count_distinct(F.col("b")).alias("db"))
    )


def test_mesh_task_retry_interplay():
    """Mesh queries run under the task-retry wrapper without running an
    exchange twice (one clean pass, exact rows)."""
    rng = np.random.default_rng(44)
    t = pa.table({"k": rng.integers(0, 10, 500), "v": rng.integers(0, 9, 500)})
    s = mesh_session({"spark.task.maxFailures": 3})
    rows = s.create_dataframe(t, num_partitions=4).group_by("k").agg(
        PF.sum(PF.col("v")).alias("s")).collect()
    assert s._task_retries == 0
    exp = {}
    for k, v in zip(t.column("k").to_pylist(), t.column("v").to_pylist()):
        exp[k] = exp.get(k, 0) + v
    assert sorted(rows) == sorted(exp.items())
    assert s.mesh_context().stats["exchanges"] == 1


def _nested_table(n=2000):
    rng = np.random.default_rng(41)
    return pa.table({
        "k": rng.integers(0, 17, n),
        "arr": pa.array(
            [None if i % 11 == 0 else [int(x) for x in rng.integers(0, 9, i % 4)] for i in range(n)],
            type=pa.list_(pa.int64())),
        "st": pa.array([{"a": int(i % 7), "b": f"s{i % 5}"} for i in range(n)],
                       type=pa.struct([("a", pa.int64()), ("b", pa.string())])),
    })


def test_mesh_nested_types_ride_ici():
    """Arrays and structs cross the mesh exchange (their element planes
    share the row axis), held against the JAX CPU engine."""
    t = _nested_table()
    assert_mesh_equals_cpu(
        lambda F, s: s.create_dataframe(t, num_partitions=8).group_by("k").agg(
            F.count(F.col("arr")).alias("ca"), F.max(F.col("st")["a"]).alias("ma"))
    )
    # nested values surviving a repartition: group by a struct FIELD,
    # carrying the array through the exchange
    assert_mesh_equals_cpu(
        lambda F, s: s.create_dataframe(t, num_partitions=8).with_column("f", F.col("st")["a"])
        .group_by("f").agg(F.sum(F.size(F.col("arr"))).alias("sz"), F.count("*").alias("c"))
    )


def test_mesh_tpch_q5_stays_on_device():
    """TPC-H q5 at SF 0.002 on the mesh with every join shuffled, strict:
    nothing off the device, the JAX CPU engine's rows."""
    from spark_rapids_tpu.tpch import gen_table as jgen
    from spark_rapids_tpu.tpch import tpch_query as jq
    from spark_rapids_tpu_torch.tpch.datagen import gen_table
    from spark_rapids_tpu_torch.tpch.queries import tpch_query

    names = ("customer", "orders", "lineitem", "supplier", "nation", "region")
    tables = {True: {n: jgen(n, 0.002) for n in names}, False: {n: gen_table(n, 0.002) for n in names}}

    def q5(F, s):
        t = tables[F is JF]
        return (jq if F is JF else tpch_query)(5, lambda n: s.create_dataframe(t[n], num_partitions=4))

    s = assert_mesh_equals_cpu(q5)
    assert all(e.on_device for e in s._last_overrides.explain if not e.node.startswith("CpuScan"))


def test_mesh_exchange_plan_used_for_nested():
    """The mesh path is taken for nested schemas (not a silent
    single-device exchange), as the JAX package decides it."""
    from spark_rapids_tpu.parallel.mesh import mesh_supported_schema as jsupported
    from spark_rapids_tpu.types import Schema as JSchema
    from spark_rapids_tpu_torch.parallel.mesh import mesh_supported_schema
    from spark_rapids_tpu_torch.types import Schema

    t = pa.table({"k": np.arange(500) % 8,
                  "arr": pa.array([[int(i)] * (i % 3) for i in range(500)], type=pa.list_(pa.int64()))})
    assert mesh_supported_schema(Schema.from_arrow(t.schema))
    assert jsupported(JSchema.from_arrow(t.schema))
    assert not mesh_supported_schema(Schema.from_arrow(pa.schema([("n", pa.null())])))


# ── the standalone distributed step ────────────────────────────────────────


@pytest.mark.parametrize("n_chips", [2, 8])
def test_distributed_group_sum(n_chips):
    mesh = make_mesh(n_chips, "cpu")
    step = distributed_group_sum_step(mesh)
    per = 64
    total = per * n_chips
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 17, total).astype(np.int64)
    kvalid = rng.random(total) > 0.05
    vals = rng.integers(-1000, 1000, total).astype(np.int64)
    vvalid = rng.random(total) > 0.1
    num_rows = np.full(n_chips, per, dtype=np.int32)
    num_rows[0] = per // 2  # a partially empty member
    ok, okv, osum, ocnt, on_groups = (
        t.numpy() for t in step(*map(torch.from_numpy, (keys, kvalid, vals, vvalid, num_rows)))
    )
    got: dict = {}
    okr, okvr = ok.reshape(n_chips, -1), okv.reshape(n_chips, -1)
    osumr, ocntr = osum.reshape(n_chips, -1), ocnt.reshape(n_chips, -1)
    for c in range(n_chips):
        for g in range(on_groups[c]):
            key = okr[c, g] if okvr[c, g] else None
            assert key not in got, f"group {key} appeared on two members"
            got[key] = (osumr[c, g], ocntr[c, g])
    expect: dict = {}
    for c in range(n_chips):
        for i in range(c * per, c * per + num_rows[c]):
            key = int(keys[i]) if kvalid[i] else None
            s, n = expect.get(key, (0, 0))
            expect[key] = (s + (int(vals[i]) if vvalid[i] else 0), n + 1)
    assert set(got) == set(expect)
    for k, (s, n) in expect.items():
        assert got[k][0] == s and got[k][1] == n, f"group {k}: {got[k]} != {(s, n)}"


# ── placement across member devices ─────────────────────────────────────────
#
# Every mesh above has its 8 members on one device, so the branches that
# move a batch between members return early. Here four members compare
# unequal (``cpu:0`` … ``cpu:3``) while every tensor still computes on the
# CPU: a batch reports the member ``put_batch`` placed it on, and
# ``put_batch`` records each move and tags the batch instead of copying.

MEMBERS = [torch.device("cpu", i) for i in range(4)]


@pytest.fixture
def member_moves(monkeypatch):
    """The moves ``put_batch`` makes, as (from, to, rows), with batches that
    report the member they were placed on."""
    import dataclasses

    from spark_rapids_tpu_torch.columnar.device import DeviceBatch
    from spark_rapids_tpu_torch.parallel import mesh as M

    moves = []
    monkeypatch.setattr(DeviceBatch, "device",
                        property(lambda b: b.__dict__.get("_member", b.num_rows.device)))

    def put(batch, device):
        device = torch.device(device)
        if batch.device == device:
            return batch
        moves.append((batch.device, device, batch.row_count()))
        return _on(dataclasses.replace(batch), device)

    monkeypatch.setattr(M, "put_batch", put)
    return moves


def _on(batch, member):
    batch._member = member
    return batch


def _dev(tbl, member=None):
    from spark_rapids_tpu_torch.columnar.device import host_to_device
    from spark_rapids_tpu_torch.columnar.host import from_arrow

    db = host_to_device(from_arrow(tbl), "cpu")
    return db if member is None else _on(db, member)


class _Placed(Exec):
    """A leaf operator yielding fixed device batches per partition (each
    already on its member): the operators below a join, in a test."""

    def __init__(self, parts):
        super().__init__([])
        self.parts = parts

    @property
    def output(self):
        return self.parts[0][0].schema

    @property
    def is_device(self):
        return True

    def execute(self, ctx):
        return PartitionSet([lambda p=p: iter(p) for p in self.parts])


def _join_tables(seed=14):
    rng = np.random.default_rng(seed)
    left = pa.table({"lk": rng.integers(0, 20, 60), "lv": rng.integers(0, 1000, 60)})
    right = pa.table({"rk": np.arange(30, dtype=np.int64), "rv": rng.integers(0, 1000, 30)})
    return left, right


def _exec_rows(node):
    from spark_rapids_tpu_torch.columnar.device import device_to_host
    from spark_rapids_tpu_torch.columnar.host import batch_rows
    from spark_rapids_tpu_torch.config import TpuConf
    from spark_rapids_tpu_torch.plan.physical import ExecContext

    parts = node.execute(ExecContext(TpuConf({}), device="cpu")).materialize()
    return [r for p in parts for db in p for r in batch_rows(device_to_host(db))]


def _assert_join_rows(got, left, right, how):
    s = cpu_session()
    want = s.create_dataframe(left).join(s.create_dataframe(right), on=[("lk", "rk")],
                                         how=how).collect()
    got, want = _normalize(got, True), _normalize(want, True)
    assert len(got) == len(want), f"{len(got)} vs {len(want)} rows"
    for i, (a, b) in enumerate(zip(got, want)):
        assert _values_equal(tuple(a), tuple(b), True), f"row {i}: {a} vs {b}"


@pytest.mark.parametrize("case", ["placed_upload", "broadcast_right_outer", "mixed_shuffled_join"])
def test_mesh_members_on_distinct_devices(case, member_moves):
    """The cross-device branches: uploads placed on member p % n
    (``_placed_partitions``); a broadcast right-outer join whose build is
    replicated once per probe member (``broadcast_batch_like``'s replica
    cache) and whose unmatched build rows come out once; a shuffled join
    whose one side took the mesh path and whose other did not, the probe
    moved to the build's device (``_colocate_with``). Rows held against the
    JAX CPU engine."""
    from spark_rapids_tpu_torch.exec import gpu as G
    from spark_rapids_tpu_torch.exec import gpu_join as GJ
    from spark_rapids_tpu_torch.parallel.mesh import MeshContext

    left, right = _join_tables()
    if case == "placed_upload":
        from spark_rapids_tpu_torch.config import TpuConf
        from spark_rapids_tpu_torch.plan.physical import ExecContext

        ctx = ExecContext(TpuConf({}), device="cpu")
        pset = PartitionSet([lambda i=i: iter([_dev(left.slice(10 * i, 10))]) for i in range(6)])
        ctx.mesh = MeshContext([torch.device("cpu")] * 4)
        assert G._placed_partitions(ctx, pset) is pset  # members share the session's device
        ctx.mesh = MeshContext(MEMBERS)
        out = G._placed_partitions(ctx, pset).materialize()
        assert [p[0].device for p in out] == [MEMBERS[i % 4] for i in range(6)]
        assert [(m[1], m[2]) for m in member_moves] == [(MEMBERS[i % 4], 10) for i in range(6)]
        return
    lk, rk = PF.col("lk").expr, PF.col("rk").expr
    if case == "broadcast_right_outer":
        # three probe partitions on members 1, 2, 1 (the first of two
        # batches); the build from member 0
        probe = _Placed([
            [_dev(left.slice(0, 15), MEMBERS[1]), _dev(left.slice(15, 15), MEMBERS[1])],
            [_dev(left.slice(30, 15), MEMBERS[2])],
            [_dev(left.slice(45, 15), MEMBERS[1])],
        ])
        build = GJ.GpuBroadcastExchangeExec(_Placed([[_dev(right, MEMBERS[0])]]))
        got = _exec_rows(GJ.GpuBroadcastHashJoinExec("right", [lk], [rk], None, probe, build))
        # one replica per probe member, none for the second batch or the
        # third partition; the probes stay where they are
        assert sorted(m[1].index for m in member_moves) == [1, 2]
        assert all(m[2] == 30 for m in member_moves)
        _assert_join_rows(got, left, right, "right")
        # a match mask from another member moves to the accumulator's device
        anchor = torch.zeros(4, dtype=torch.bool, device="meta")
        assert GJ._colocated(anchor, torch.ones(4, dtype=torch.bool)).device == anchor.device
        return
    # co-partitioned by key parity: the left side on members 1 and 2 (it
    # took the mesh path), the right side on the session's device
    def parity(tbl, key, i):
        return tbl.filter(pa.array(np.asarray(tbl[key]) % 2 == i))

    probe = _Placed([[_dev(parity(left, "lk", i), MEMBERS[1 + i])] for i in (0, 1)])
    build = _Placed([[_dev(parity(right, "rk", i))] for i in (0, 1)])
    got = _exec_rows(GJ.GpuShuffledHashJoinExec("left", [lk], [rk], None, probe, build))
    assert [(m[0], m[1]) for m in member_moves] == [(MEMBERS[1], torch.device("cpu")),
                                                    (MEMBERS[2], torch.device("cpu"))]
    _assert_join_rows(got, left, right, "left")
