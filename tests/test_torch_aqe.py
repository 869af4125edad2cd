"""Adaptive execution, exchange reuse and calibrated routing on the port,
held to the JAX package.

* Mirrors of ``tests/test_aqe_cbo.py`` and ``tests/test_exchange_reuse.py``
  (the mechanism of ``tests/test_torch_dataframe_api.py``: each reference
  test runs unchanged against the port's device engine, its plan finders
  pointed at the port's operators).
* Each of those cases once more on both device engines: the port's
  ``aqe_groups`` and ``aqe_splits`` per exchange, its runtime broadcast
  switch and its reused-exchange count equal the JAX device engine's on
  JAX-CPU, and its rows equal the JAX CPU engine's.
* ``_aqe_join_plan`` against the JAX function over 200 size vectors made
  from a seed; ``_row_range_slice`` against its definition.
* The concurrency rules of the port's adaptive read: one size fetch and
  one assignment per exchange under four partition tasks, one
  materialization of a shared exchange under a task re-attempted from
  lineage, the build side measured once and its semaphore permit given
  back.
* Calibrated routing (the port of ``tests/test_fusion.py``'s routing
  cases) and the host-side opTime the calibration harvests.
"""
from __future__ import annotations

import importlib
import json

import numpy as np
import pyarrow as pa
import pytest

from tests.test_torch_dataframe_api import (
    PortSession,
    check_covers,
    mirrored_cases,
    patch_module,
    run_reference,
)

REF_MODULES = ("test_aqe_cbo", "test_exchange_reuse")

NOT_IN_SLICE: dict = {}

#: reference tests whose check reads the JAX package's own classes; each has
#: a port test of its own below
MIRRORED_ELSEWHERE = {
    "test_aqe_cbo::test_cbo_unconverts_trivial_island":
        "test_cbo_unconverts_trivial_island (its plan names are the JAX package's)",
    "test_exchange_reuse::test_self_join_aggregate_reuses_exchange":
        "test_self_join_aggregate_reuses_exchange (it counts TpuShuffleExchangeExec calls)",
}

CASES = mirrored_cases(REF_MODULES, NOT_IN_SLICE, MIRRORED_ELSEWHERE)


@pytest.mark.parametrize("module,fname,kwargs", CASES)
def test_mirror(module, fname, kwargs, monkeypatch, request):
    mod = importlib.import_module(module)
    patch_module(mod, monkeypatch)
    run_reference(mod, getattr(mod, fname), kwargs, request)


def test_mirror_covers_every_suite():
    check_covers(REF_MODULES, CASES, NOT_IN_SLICE, MIRRORED_ELSEWHERE)


# ── the port's adaptive decisions equal the JAX device engine's ───────────


def _grouped(n, groups, seed, cols=("lv",)):
    from data_gen import gen_grouped_table
    from spark_rapids_tpu.types import LONG

    return gen_grouped_table([(c, LONG) for c in cols], n, num_groups=groups, seed=seed)


def _skewed(seed, n, hot, frac, keys):
    rng = np.random.default_rng(seed)
    ks = np.where(rng.random(n) < frac, hot, rng.integers(0, keys, n))
    return pa.table({"k": ks, "lv": rng.integers(0, 100, n)})


def _join(lt, rt, how, parts):
    return lambda s: s.create_dataframe(lt, num_partitions=parts).join(
        s.create_dataframe(rt, num_partitions=parts), on="k", how=how
    )


def _self_join_agg(t):
    from spark_rapids_tpu import functions as F
    from spark_rapids_tpu.functions import col

    def build(s):
        df = s.create_dataframe(t, num_partitions=2)
        agg = df.group_by("k").agg(F.sum(col("v")).alias("s"))
        right = agg.with_column_renamed("k", "k2").with_column_renamed("s", "s2")
        return agg.join(right, on=[("k", "k2")]).select("k", "s", "s2")

    return build


def _reuse_table(n):
    rng = np.random.default_rng(3)
    return pa.table({"k": rng.integers(0, 50, n).astype(np.int64),
                     "v": rng.integers(-100, 100, n).astype(np.int64)})


_AQE = {"spark.sql.adaptive.enabled": True}
_NO_BC = {**_AQE, "spark.sql.autoBroadcastJoinThreshold": "-1"}
_SKEW = {
    **_NO_BC,
    "spark.sql.adaptive.advisoryPartitionSizeInBytes": str(8 * 1024),
    "spark.sql.adaptive.skewJoin.skewedPartitionThresholdInBytes": str(16 * 1024),
    "spark.sql.adaptive.skewJoin.skewedPartitionFactor": 2,
}


def _aqe_cases():
    """(id, build, conf): every query of the two reference suites."""
    from spark_rapids_tpu.functions import col, sum as sum_

    out = [(
        "coalesces_small_partitions",
        lambda s, t=_grouped(400, 6, 2, ("x",)): s.create_dataframe(t, num_partitions=3)
        .group_by("k").agg(sum_(col("x")).alias("s")),
        _AQE,
    ), (
        "join_shares_one_coalesce_assignment",
        _join(_grouped(5000, 40, 7, ("lv", "lw")), _grouped(100, 40, 8, ("rv",)), "inner", 4),
        {**_NO_BC, "spark.sql.adaptive.advisoryPartitionSizeInBytes": str(16 * 1024)},
    )]
    for how in ("left", "full", "left_anti"):
        out.append((
            f"join_outer_types[{how}]",
            _join(_grouped(3000, 30, 9), _grouped(120, 50, 10, ("rv",)), how, 5),
            {**_NO_BC, "spark.sql.adaptive.advisoryPartitionSizeInBytes": str(8 * 1024)},
        ))
    rt = pa.table({"k": list(range(40)), "rv": list(range(0, 80, 2))})
    for how in ("inner", "left"):
        out.append((f"skew_join_split[{how}]", _join(_skewed(91, 6000, 7, 0.85, 40), rt, how, 6),
                    _SKEW))
    rt = pa.table({"k": list(range(0, 30, 2)), "rv": list(range(15))})
    out.append(("skew_split_disabled_for_full_join",
                _join(_skewed(92, 4000, 3, 0.9, 30), rt, "full", 5), _SKEW))
    rng = np.random.default_rng(93)
    lt = pa.table({"k": rng.integers(0, 200, 4000), "lv": rng.standard_normal(4000)})
    rt = pa.table({"k": np.arange(150), "rv": rng.standard_normal(150)})
    for how in ("inner", "left", "right"):
        out.append((f"runtime_broadcast_switch[{how}]", _join(lt, rt, how, 3),
                    {**_NO_BC, "spark.sql.adaptive.autoBroadcastJoinThreshold": "10m"}))
    out.append(("broadcast_switch_respects_threshold", _join(lt, rt, "inner", 3),
                {**_NO_BC, "spark.sql.adaptive.autoBroadcastJoinThreshold": "64"}))
    t = _reuse_table(4000)
    out.append(("self_join_aggregate_reuses_exchange", _self_join_agg(t), {}))
    out.append(("reuse_respects_kill_switch", _self_join_agg(_reuse_table(500)),
                {"spark.sql.exchange.reuse": "false"}))
    out.append(("reuse_under_aqe", _self_join_agg(t), _AQE))
    return out


_CASES = _aqe_cases()


def _decisions(session, exchange_cls, join_cls):
    """(per-exchange (aqe_groups, aqe_splits) in plan order, per-join switch
    flags, reused exchanges) of a session's last query."""
    ex, joins = [], []
    stack = [session._last_plan]
    while stack:
        n = stack.pop(0)
        if isinstance(n, exchange_cls):
            ex.append((getattr(n, "aqe_groups", None), getattr(n, "aqe_splits", 0)))
        if isinstance(n, join_cls):
            joins.append(bool(getattr(n, "aqe_broadcast_switched", False)))
        stack.extend(n.children)
    return ex, joins, session._last_reused_exchanges


@pytest.mark.parametrize("case", _CASES, ids=[c[0] for c in _CASES])
def test_adaptive_decisions_equal_jax_device_engine(case):
    """The same query on the JAX device engine (JAX-CPU) and on the port:
    equal groupings, splits, switches and reuse counts, and the port's rows
    equal to the JAX CPU engine's."""
    from spark_rapids_tpu.exec.tpu import TpuShuffleExchangeExec
    from spark_rapids_tpu.exec.tpu_join import TpuShuffledHashJoinExec
    from spark_rapids_tpu_torch.exec.gpu import GpuShuffleExchangeExec
    from spark_rapids_tpu_torch.exec.gpu_join import GpuShuffledHashJoinExec
    from tests.harness import _normalize, _values_equal, cpu_session, tpu_session

    _, build, conf = case
    js = tpu_session(conf)
    build(js).collect()
    ps = PortSession(conf)
    got = build(ps).collect()
    want = _decisions(js, TpuShuffleExchangeExec, TpuShuffledHashJoinExec)
    mine = _decisions(ps._s, GpuShuffleExchangeExec, GpuShuffledHashJoinExec)
    assert mine == want
    ref = _normalize(build(cpu_session(conf)).collect(), True)
    got = _normalize(got, True)
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert all(_values_equal(x, y, False) for x, y in zip(a, b)), (a, b)


def test_aqe_join_plan_equals_jax():
    """``_aqe_join_plan`` is the JAX function's copy: the same plans for 200
    size vectors (skewed and not, with and without split sides)."""
    from spark_rapids_tpu.exec.tpu import _SPLITTABLE_SIDES as JSIDES
    from spark_rapids_tpu.exec.tpu import _aqe_join_plan as jplan
    from spark_rapids_tpu_torch.exec.gpu import _SPLITTABLE_SIDES, _aqe_join_plan

    assert _SPLITTABLE_SIDES == JSIDES
    rng = np.random.default_rng(2024)
    for i in range(200):
        n = int(rng.integers(1, 17))
        sa = [int(x) for x in rng.integers(0, 1 << 16, n)]
        sb = [int(x) for x in rng.integers(0, 1 << 12, n)]
        if i % 2:
            sa[int(rng.integers(0, n))] = int(rng.integers(1 << 20, 1 << 23))
        if i % 5 == 0:
            sb[int(rng.integers(0, n))] = int(rng.integers(1 << 20, 1 << 23))
        advisory = int(rng.choice([1 << 10, 1 << 14, 1 << 17, 64 << 20]))
        sides = list(_SPLITTABLE_SIDES.values())[i % len(_SPLITTABLE_SIDES)]
        args = (sa, sb, n, advisory, sides, int(rng.choice([0, 1 << 15, 1 << 18])),
                int(rng.integers(1, 6)))
        assert _aqe_join_plan(*args) == jplan(*args), args


@pytest.mark.parametrize("n,k", [(0, 2), (1, 3), (7, 2), (1000, 3), (1023, 4)])
def test_row_range_slice(n, k):
    """Slice j of k holds live rows ``[n*j//k, n*(j+1)//k)`` in order, at
    the batch's capacity, its padding masked; the slices together are the
    batch's rows."""
    import torch

    from spark_rapids_tpu_torch.columnar.device import host_to_device
    from spark_rapids_tpu_torch.columnar.host import HostBatch, HostColumn, string_column
    from spark_rapids_tpu_torch.exec.gpu import _row_range_slice
    from spark_rapids_tpu_torch.types import LONG, STRING, Schema, StructField

    vals = np.arange(n, dtype=np.int64) * 3
    strs = [f"r{i}" for i in range(n)]
    hb = HostBatch(Schema([StructField("v", LONG), StructField("s", STRING)]),
                   [HostColumn(LONG, vals, np.ones(n, bool)), string_column(strs)], n)
    db = host_to_device(hb, torch.device("cpu"))
    seen = []
    for j in range(k):
        part = _row_range_slice(db, j, k)
        lo, hi = n * j // k, n * (j + 1) // k
        assert part.capacity == db.capacity and int(part.num_rows) == hi - lo
        live = part.columns[0].validity
        assert bool(live[: hi - lo].all()) and not bool(live[hi - lo:].any())
        assert not bool(part.columns[1].validity[hi - lo:].any())
        seen += part.columns[0].data[: hi - lo].tolist()
    assert seen == vals.tolist()


# ── the concurrency rules of the port's adaptive read ─────────────────────


def _port(conf):
    from spark_rapids_tpu_torch import TorchSession

    return TorchSession({"spark.rapids.sql.enabled": True, "spark.rapids.sql.test.enabled": True,
                         "spark.sql.shuffle.partitions": 8, **conf}, device="cpu")


def _port_df(s, t, parts):
    return s.create_dataframe(t, num_partitions=parts)


def test_one_size_fetch_and_one_assignment_under_four_tasks(monkeypatch):
    """Four partition tasks read both linked exchanges of a skewed join at
    once: each exchange fetches its sizes once and plans once, and the
    rows equal the serial run's."""
    from spark_rapids_tpu_torch.exec import gpu as G

    calls = []
    real = G._aqe_join_plan
    monkeypatch.setattr(G, "_aqe_join_plan", lambda *a: (calls.append(1), real(*a))[1])
    lt = _skewed(91, 6000, 7, 0.85, 40)
    rt = pa.table({"k": list(range(40)), "rv": list(range(0, 80, 2))})
    rows = []
    for tasks in (4, 1):
        s = _port({**_SKEW, "spark.rapids.sql.concurrentGpuTasks": tasks})
        rows.append(sorted(_port_df(s, lt, 6).join(_port_df(s, rt, 6), on="k").collect()))
        assert s._last_metrics["aqeSizeSyncs"] == 2
    assert rows[0] == rows[1]
    assert len(calls) == 4  # one plan per exchange per query


def test_shared_exchange_materializes_once_under_lineage_retry(monkeypatch):
    """A task re-attempted from lineage re-reads the shared exchange's
    buckets: every exchange materializes once, and the rows are right."""
    from spark_rapids_tpu_torch.exec import gpu as G
    from spark_rapids_tpu_torch.session import TorchSession

    mats = []
    real_mat = G.GpuShuffleExchangeExec._materialize
    monkeypatch.setattr(G.GpuShuffleExchangeExec, "_materialize",
                        lambda self, *a: (mats.append(id(self)), real_mat(self, *a))[1])
    real_drain = TorchSession._drain
    failed = []

    def drain_once_failing(thunk, token, ledger=None):
        out = real_drain(thunk, token, ledger)
        if not failed:
            failed.append(1)
            raise RuntimeError("injected task failure after a full read")
        return out

    monkeypatch.setattr(TorchSession, "_drain", staticmethod(drain_once_failing))
    t = _reuse_table(2000)
    s = _port({"spark.rapids.sql.concurrentGpuTasks": 1})
    from spark_rapids_tpu_torch import functions as F

    df = _port_df(s, t, 2)
    agg = df.group_by("k").agg(F.sum(F.col("v")).alias("s"))
    right = agg.with_column_renamed("k", "k2").with_column_renamed("s", "s2")
    got = sorted(agg.join(right, on=[("k", "k2")]).select("k", "s", "s2").collect())
    assert s._task_retries == 1 and s._last_reused_exchanges == 1
    assert len(mats) == len(set(mats))
    want = {}
    for k, v in zip(t.column("k").to_pylist(), t.column("v").to_pylist()):
        want[k] = want.get(k, 0) + v
    assert got == sorted((k, v, v) for k, v in want.items())


def test_broadcast_switch_measures_once_and_returns_the_permit(monkeypatch):
    """The switch measures the build side on the calling thread: its
    semaphore permit is given back, and a declined switch hands the
    executed build partitions on (one materialization)."""
    from spark_rapids_tpu_torch.exec import gpu as G
    from spark_rapids_tpu_torch.mem.semaphore import DeviceSemaphore

    released = []
    real_rel = DeviceSemaphore.release_if_necessary
    monkeypatch.setattr(DeviceSemaphore, "release_if_necessary",
                        lambda self: (released.append(1), real_rel(self))[1])
    mats = []
    real_mat = G.GpuShuffleExchangeExec._materialize
    monkeypatch.setattr(G.GpuShuffleExchangeExec, "_materialize",
                        lambda self, *a: (mats.append(id(self)), real_mat(self, *a))[1])
    rng = np.random.default_rng(94)
    lt = pa.table({"k": rng.integers(0, 50, 2000), "lv": rng.standard_normal(2000)})
    rt = pa.table({"k": np.arange(50), "rv": rng.standard_normal(50)})
    for thresh, switched in (("10m", True), ("64", False)):
        released.clear()
        mats.clear()
        s = _port({**_NO_BC, "spark.sql.adaptive.autoBroadcastJoinThreshold": thresh})
        _port_df(s, lt, 3).join(_port_df(s, rt, 3), on="k").collect()
        from tests.test_torch_dataframe_api import FINDERS

        j = FINDERS["_find_join"](s._last_plan)
        assert bool(getattr(j, "aqe_broadcast_switched", False)) is switched
        assert j.aqe_build_bytes == 50 * (8 + 1 + 8 + 1)  # live rows x _row_bytes
        assert released, "the measuring thread kept its permit"
        assert len(mats) == len(set(mats)) == (1 if switched else 2)


# ── the two JAX-class-bound reference tests, on the port's classes ────────


def test_self_join_aggregate_reuses_exchange(monkeypatch):
    """``tests/test_exchange_reuse.py``'s case: the shared exchange's
    pipeline runs once, and the rows equal the JAX CPU engine's."""
    from spark_rapids_tpu_torch.exec.gpu import GpuShuffleExchangeExec
    from tests.harness import _normalize, cpu_session

    calls = []
    orig = GpuShuffleExchangeExec._execute_impl
    monkeypatch.setattr(GpuShuffleExchangeExec, "_execute_impl",
                        lambda self, ctx: (calls.append(id(self)), orig(self, ctx))[1])
    t = _reuse_table(4000)
    s = PortSession()
    rows = _self_join_agg(t)(s).collect()
    assert s._s._last_reused_exchanges >= 1
    assert len(calls) == len(set(calls))
    assert _normalize(rows, True) == _normalize(_self_join_agg(t)(cpu_session()).collect(), True)


def test_cbo_unconverts_trivial_island():
    """``tests/test_aqe_cbo.py``'s case: a one-filter island goes back to the
    CPU engine under the optimizer; an aggregate stays on the device."""
    from spark_rapids_tpu.functions import col, sum as sum_
    from tests.test_torch_dataframe_api import assert_jax_cpu_and_port_equal

    t = pa.table({"a": list(range(100))})
    conf = {"spark.rapids.sql.optimizer.enabled": True}

    def build(s):
        return s.create_dataframe(t).filter(col("a") > 50)

    assert_jax_cpu_and_port_equal(build, conf=conf, allowed_non_tpu=["Filter", "CpuFilter"])
    s = PortSession(conf, strict=False)
    assert len(build(s).collect()) == 49
    assert "GpuFilter" not in s._s._last_plan.tree_string()
    s2 = PortSession(conf, strict=False)
    assert s2.create_dataframe(t).group_by().agg(sum_(col("a")).alias("s")).collect() == [
        (sum(range(100)),)
    ]
    assert "GpuHashAggregate" in s2._s._last_plan.tree_string()


# ── calibrated routing ─────────────────────────────────────────────────────


def _write_cal(path, dev_ns, host_ns):
    from spark_rapids_tpu_torch.obs import calibration as obs_cal

    ops = {}
    for dev, cpu in (("GpuProjectExec", "CpuProjectExec"), ("GpuFilterExec", "CpuFilterExec")):
        ops[dev] = {"device_ns_per_row": dev_ns, "rows": 10_000, "updates": 3}
        ops[cpu] = {"host_ns_per_row": host_ns, "rows": 10_000, "updates": 3}
    with open(path, "w") as f:
        json.dump({"version": 1, "ops": ops}, f)
    obs_cal.invalidate(str(path))


def _chain(df):
    from spark_rapids_tpu_torch import functions as F

    return (df.filter(F.col("a") > 10)
            .select((F.col("a") + 1).alias("x"), (F.col("b") * 2.0).alias("y"))
            .filter(F.col("x") < 10**9))


def _chain_table(n):
    return {"a": np.arange(n, dtype=np.int64), "b": np.arange(n, dtype=np.float64) * 0.5}


def _routing(path, strict=False, **extra):
    return _port({"spark.rapids.tpu.routing.enabled": True,
                  "spark.rapids.tpu.cbo.calibrationFile": str(path),
                  "spark.rapids.sql.test.enabled": strict, **extra})


def test_routing_flips_plan_to_host(tmp_path):
    """Slow device + tiny input: the island routes to the CPU engine with
    the predicted numbers in the explain reason, and the rows are right."""
    p = tmp_path / "cal.json"
    _write_cal(p, dev_ns=500.0, host_ns=5.0)
    s = _routing(p)
    rows = _chain(s.create_dataframe(_chain_table(50))).collect()
    tree = s._last_plan.tree_string()
    assert "Gpu" not in tree and "CpuProject" in tree and "CpuFilter" in tree
    reasons = [r for e in s._last_overrides.explain for r in e.reasons
               if "calibrated routing" in r]
    assert reasons and "predicted device" in reasons[0] and "ms > host" in reasons[0]
    assert "GpuProjectExec 500ns/row vs CpuProjectExec 5ns/row" in reasons[0]
    assert rows == [(i + 1, i * 1.0) for i in range(11, 50)]


def test_routing_keeps_fast_device_plan(tmp_path):
    p = tmp_path / "cal.json"
    _write_cal(p, dev_ns=1.0, host_ns=500_000.0)
    s = _routing(p, strict=True)
    _chain(s.create_dataframe(_chain_table(50))).collect()
    assert not any("calibrated routing" in r for e in s._last_overrides.explain
                   for r in e.reasons)


def test_routing_off_or_uncalibrated_changes_nothing(tmp_path):
    """Routing off, or on over an empty table: the plan is the default's."""
    p = tmp_path / "cal.json"
    _write_cal(p, dev_ns=500.0, host_ns=5.0)
    base = _port({})
    _chain(base.create_dataframe(_chain_table(50))).collect()
    off = _port({"spark.rapids.tpu.cbo.calibrationFile": str(p)})
    _chain(off.create_dataframe(_chain_table(50))).collect()
    empty = tmp_path / "none.json"
    on_empty = _routing(empty, strict=True)
    _chain(on_empty.create_dataframe(_chain_table(50))).collect()
    trees = {x._last_plan.tree_string() for x in (base, off, on_empty)}
    assert len(trees) == 1


def test_harvested_calibration_routes_a_small_query(tmp_path):
    """What the card's routing check does, small: the calibration harvested
    from a device run and a CPU-engine run (each host node's opTime is its
    own pull time, so its ns/row is measured, not ~0) routes a 1,000-row
    query to the CPU engine, whose launch and transfer overheads dwarf its
    work, with the rows unchanged."""
    from spark_rapids_tpu_torch.obs import calibration as obs_cal

    p = tmp_path / "cal.json"
    obs_cal.invalidate(str(p))
    harvest = {"spark.rapids.tpu.cbo.calibration.enabled": True,
               "spark.rapids.tpu.cbo.calibrationFile": str(p),
               "spark.rapids.tpu.fusion.enabled": False}
    big = _chain_table(100_000)
    for enabled in (True, False):
        s = _port({**harvest, "spark.rapids.sql.enabled": enabled,
                   "spark.rapids.sql.test.enabled": False})
        _chain(s.create_dataframe(big)).collect()
    cal = obs_cal.get(str(p))
    for op in ("CpuFilterExec", "CpuProjectExec"):
        assert cal.ns_per_row(op, device=False) > 0.0, op
    for op in ("GpuFilterExec", "GpuProjectExec"):
        assert cal.ns_per_row(op, device=True) > 0.0, op
    small = _routing(p, strict=False)
    rows = _chain(small.create_dataframe(_chain_table(1000))).collect()
    assert any("calibrated routing: predicted device" in r
               for e in small._last_overrides.explain for r in e.reasons)
    assert rows == [(i + 1, i * 1.0) for i in range(11, 1000)]


def test_harvested_calibration_routes_small_q6_past_its_fused_filter(tmp_path):
    """q6's filter folds into its aggregate, so it is never measured on the
    device: routing charges it its host ns/row and no launch. A 1,000-row
    q6 harvested from SF 0.002 runs routes to the CPU engine with the same
    rows."""
    from spark_rapids_tpu_torch.obs import calibration as obs_cal
    from spark_rapids_tpu_torch.tpch.datagen import gen_orders_lineitem
    from spark_rapids_tpu_torch.tpch.queries import tpch_query

    _, li = gen_orders_lineitem(0.002, 19980802)
    p = tmp_path / "cal.json"
    obs_cal.invalidate(str(p))
    harvest = {"spark.rapids.tpu.cbo.calibration.enabled": True,
               "spark.rapids.tpu.cbo.calibrationFile": str(p)}
    for enabled in (True, False):
        s = _port({**harvest, "spark.rapids.sql.enabled": enabled,
                   "spark.rapids.sql.test.enabled": False, "spark.sql.shuffle.partitions": 1})
        tpch_query(6, lambda t: s.create_dataframe(li)).collect()
    small = li.slice(0, 1000)
    s = _routing(p, strict=False, **{"spark.sql.shuffle.partitions": 1})
    rows = tpch_query(6, lambda t: s.create_dataframe(small)).collect()
    reasons = [r for e in s._last_overrides.explain for r in e.reasons
               if "calibrated routing" in r]
    assert reasons and "GpuFilterExec fused vs CpuFilterExec" in reasons[0], reasons
    cpu = _port({"spark.rapids.sql.enabled": False})
    assert rows == tpch_query(6, lambda t: cpu.create_dataframe(small)).collect()


def test_nested_shared_exchanges_execute_once_each(monkeypatch):
    """A shared exchange whose subtree holds another shared exchange (the
    TPC-DS q47 shape: a self-joined CTE over a self-joined aggregate): each
    takes its own memo lock, so the inner one's execute inside the outer
    one's cannot wait on itself, and each pipeline runs once; the rows
    equal the JAX CPU engine's."""
    from spark_rapids_tpu import functions as JF
    from spark_rapids_tpu.functions import col
    from spark_rapids_tpu_torch.exec.gpu import GpuShuffleExchangeExec
    from tests.harness import _normalize, cpu_session

    def build(s):
        df = s.create_dataframe(_reuse_table(1500), num_partitions=2)
        agg = df.group_by("k").agg(JF.sum(col("v")).alias("s"))
        inner = agg.join(agg.with_column_renamed("k", "k2").with_column_renamed("s", "s2"),
                         on=[("k", "k2")]).select("k", (col("s") + col("s2")).alias("t"))
        outer = inner.group_by((col("k") % 5).alias("g")).agg(JF.sum(col("t")).alias("u"))
        return outer.join(outer.with_column_renamed("g", "g2").with_column_renamed("u", "u2"),
                          on=[("g", "g2")]).select("g", "u", "u2")

    calls = []
    orig = GpuShuffleExchangeExec._execute_impl
    monkeypatch.setattr(GpuShuffleExchangeExec, "_execute_impl",
                        lambda self, ctx: (calls.append(id(self)), orig(self, ctx))[1])
    ps = PortSession({"spark.rapids.sql.concurrentGpuTasks": 4})
    got = build(ps).collect()
    assert ps._s._last_reused_exchanges >= 2
    assert len(calls) == len(set(calls))
    assert _normalize(got, True) == _normalize(build(cpu_session()).collect(), True)
