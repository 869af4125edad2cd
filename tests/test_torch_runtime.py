"""The port's query runtime on the CPU: the dispatch-ahead pipeline
(``exec/pipeline.py``), whole-stage fusion (``plan/fusion.py``), concurrent
partition tasks (the root coalesce and ``session._run_plan``), straggler
speculation (``sched/speculation.py``) and the progress watchdog
(``resilience/watchdog.py``).

Ported from the JAX package's ``tests/test_pipeline.py`` and
``tests/test_fusion.py``. The port is held against the JAX package where
the JAX side needs no XLA compile: the stages ``fuse_stages`` forms on each
of the 22 TPC-H plans at SF 0.002, from both packages' planners (the JAX
session's subqueries resolved through its CPU engine), and the rows of the
fused, unfused, pipelined and 4-task runs against the JAX CPU engine's.
Every thread a test starts is bounded: waits take a timeout and the
pipeline, pools and monitors shut down in a ``finally``.
"""
from __future__ import annotations

import threading
import time

import numpy as np
import pytest

pytest.importorskip("jax")  # the reference; absent on a machine with only the port

import torch  # noqa: E402

from harness import _normalize, _values_equal, cpu_session, tpu_session  # noqa: E402
from spark_rapids_tpu.tpch import queries as jq  # noqa: E402
from spark_rapids_tpu.tpch.datagen import gen_table as jax_gen_table  # noqa: E402
from spark_rapids_tpu_torch import TorchSession  # noqa: E402
from spark_rapids_tpu_torch import functions as F  # noqa: E402
from spark_rapids_tpu_torch.exec.pipeline import PipelinedIterator, pipelined_partition  # noqa: E402
from spark_rapids_tpu_torch.obs.metrics import GLOBAL, Metric, MetricKind  # noqa: E402
from spark_rapids_tpu_torch.plan.fusion import StageExec  # noqa: E402
from spark_rapids_tpu_torch.tpch.datagen import TABLES  # noqa: E402
from spark_rapids_tpu_torch.tpch.datagen import gen_table as port_gen_table  # noqa: E402
from spark_rapids_tpu_torch.tpch.queries import QUERIES, SLICE_QUERIES, tpch_query  # noqa: E402

torch.set_num_threads(1)

SF = 0.002
Q11_SF = 1.0


class _Item:
    """Stand-in batch with a static size_bytes (like DeviceBatch)."""

    def __init__(self, i: int, size: int = 100):
        self.i = i
        self._size = size

    def size_bytes(self) -> int:
        return self._size


class _Source:
    """Instrumented upstream: tracks produced count, max in-flight
    (produced - consumed), and whether the generator was closed."""

    def __init__(self, n: int, size: int = 100, fail_at: int = -1):
        self.n = n
        self.size = size
        self.fail_at = fail_at
        self.produced = 0
        self.consumed = 0
        self.max_inflight = 0
        self.closed = False
        self._lock = threading.Lock()

    def note_consumed(self):
        with self._lock:
            self.consumed += 1

    def gen(self):
        try:
            for i in range(self.n):
                if i == self.fail_at:
                    raise RuntimeError(f"operator failure at batch {i}")
                with self._lock:
                    self.produced += 1
                    self.max_inflight = max(self.max_inflight, self.produced - self.consumed)
                yield _Item(i, self.size)
        finally:
            self.closed = True


def _wait_for(pred, timeout: float = 5.0) -> bool:
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.01)
    return True


# ── the pipeline's window contract ──────────────────────────────────────────


def test_window_batch_bound_respected():
    src = _Source(50)
    pipe = PipelinedIterator(src.gen(), depth=3, max_bytes=0)
    out = []
    try:
        for item in pipe:
            time.sleep(0.001)  # slow consumer: the producer must wait, not run
            src.note_consumed()
            out.append(item.i)
    finally:
        pipe.close()
    assert out == list(range(50)), "batches lost, duplicated, or reordered"
    assert src.max_inflight <= 3 + 1, f"in-flight window exceeded depth: {src.max_inflight}"
    assert src.closed


def test_window_byte_bound_respected():
    src = _Source(40, size=100)
    pipe = PipelinedIterator(src.gen(), depth=100, max_bytes=250)
    out = []
    try:
        for item in pipe:
            time.sleep(0.001)
            src.note_consumed()
            out.append(item.i)
    finally:
        pipe.close()
    assert out == list(range(40))
    assert src.max_inflight <= 4, f"byte bound did not hold the window: {src.max_inflight}"


def test_oversized_batch_still_flows():
    """The bytes bound never blocks an empty window, or it would deadlock."""
    src = _Source(5, size=10_000)
    pipe = PipelinedIterator(src.gen(), depth=4, max_bytes=100)
    try:
        assert [item.i for item in pipe] == list(range(5))
    finally:
        pipe.close()


def test_early_exit_stops_producer_and_closes_upstream():
    src = _Source(10_000)
    depth = 4
    pipe = PipelinedIterator(src.gen(), depth=depth, max_bytes=0)
    try:
        taken = [next(pipe).i for _ in range(2)]
    finally:
        pipe.close()
    assert taken == [0, 1]
    assert src.produced <= 2 + depth + 1, f"producer ran past the window: {src.produced}"
    assert _wait_for(lambda: src.closed), "upstream generator was not closed on early exit"


def test_error_surfaces_on_consumer_after_prior_batches():
    src = _Source(10, fail_at=3)
    pipe = PipelinedIterator(src.gen(), depth=2, max_bytes=0)
    got = []
    try:
        with pytest.raises(RuntimeError, match="operator failure at batch 3"):
            for item in pipe:
                src.note_consumed()
                got.append(item.i)
    finally:
        pipe.close()
    assert got == [0, 1, 2], "batches before the failure must all arrive"
    assert src.closed


def test_release_callback_runs_once_production_ends():
    released = threading.Event()
    src = _Source(3)
    pipe = PipelinedIterator(src.gen(), depth=2, max_bytes=0, release=released.set)
    try:
        assert [i.i for i in pipe] == [0, 1, 2]
        assert released.wait(5), "semaphore release callback never ran"
    finally:
        pipe.close()


def test_spill_pressure_requests_headroom():
    class _Catalog:
        def __init__(self):
            self.calls = []

        def ensure_headroom(self, want, dev=None):
            self.calls.append(want)

    cat = _Catalog()
    src = _Source(10, size=64)
    pipe = PipelinedIterator(src.gen(), depth=2, max_bytes=0, catalog=cat)
    try:
        assert [i.i for i in pipe] == list(range(10))
    finally:
        pipe.close()
    assert cat.calls and all(w == 64 for w in cat.calls)


def test_metrics_feed_depth_and_counts():
    metrics = {
        "depth": Metric("pipeDispatchDepth", kind=MetricKind.WATERMARK),
        "stall": Metric("pipeStallTime", kind=MetricKind.NANOS),
        "producer": Metric("pipeProducerTime", kind=MetricKind.NANOS),
        "batches": Metric("pipeBatches"),
    }
    before = GLOBAL.histogram("pipeline.dispatchHist").state()[2]
    src = _Source(20)
    pipe = PipelinedIterator(src.gen(), depth=3, max_bytes=0, metrics=metrics)
    try:
        list(pipe)
    finally:
        pipe.close()
    assert metrics["batches"].value == 20
    assert 1 <= metrics["depth"].value <= 3
    assert GLOBAL.histogram("pipeline.dispatchHist").state()[2] - before == 20


def test_producer_carries_token_ledger_and_trace():
    """The producer checks the consumer's cancel token before each pull
    (a cancelled query's producer stops at a batch boundary), bills its
    pulls to the consumer's ledger's ``dispatch`` phase and records its
    spans under the consumer's span."""
    from spark_rapids_tpu_torch.obs import ledger as OL
    from spark_rapids_tpu_torch.obs import trace as OT
    from spark_rapids_tpu_torch.sched import CancelToken, QueryCancelledError

    led = OL.PhaseLedger()
    tracer = OT.Tracer()
    tok = CancelToken("qp")
    seen = []

    def gen():
        for i in range(100):
            with OT.span("pull", "batch"):
                seen.append(threading.get_ident())
                time.sleep(0.001)
            yield _Item(i)

    with OL.ledger_scope(led), OT.query_scope(tracer, "query-p"):
        with OT.span("op", "operator") as op:
            pipe = PipelinedIterator(gen(), depth=2, cancel_token=tok)
            try:
                assert next(pipe).i == 0
                tok.cancel("user")
                with pytest.raises(QueryCancelledError):
                    for _ in pipe:
                        pass
            finally:
                pipe.close()
    assert seen and threading.get_ident() not in seen, "pulls ran on the consumer"
    assert led.snapshot().get("dispatch", 0) > 0
    pulls = [s for s in tracer.spans() if s.name == "pull"]
    assert pulls and all(s.parent == op.sid for s in pulls)
    assert all(s.tid != threading.get_ident() for s in pulls)


def test_pipeline_releases_the_permit_with_one_task():
    """With concurrentGpuTasks=1 and the pipeline on, each producer takes
    the device semaphore's only permit in its upload. Without the release
    callback a producer would end still holding it, and the consumer of
    the next partition's producer would wait forever: the LIMIT below
    reads three partitions, each through its own producer."""
    s = TorchSession({"spark.rapids.sql.concurrentGpuTasks": 1}, device="cpu")
    df = s.create_dataframe({"a": np.arange(300, dtype=np.int64)}, num_partitions=3).limit(250)
    out = {}

    def run():
        out["rows"] = df.collect()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=20)
    assert not t.is_alive(), "the limit over three pipelined partitions deadlocked"
    assert [r[0] for r in out["rows"]] == list(range(250))


def test_consumer_holding_the_permit_is_released_by_the_producer_callback():
    """The semaphore case itself, under a bounded wait: one permit, a
    producer that takes it per partition, a consumer that drives three
    partitions one after another (pipelined_partition's release callback
    returns it at the end of each)."""
    from spark_rapids_tpu_torch.mem.semaphore import DeviceSemaphore

    class _Ctx:
        conf = None
        ledger = None
        cancel_token = None
        catalog = None

    ctx = _Ctx()
    ctx.semaphore = DeviceSemaphore(1)
    pconf = {"depth": 2, "max_bytes": 0}

    def part(p):
        for i in range(5):
            ctx.semaphore.acquire_if_necessary()  # the upload's acquire
            yield _Item(p * 10 + i)

    out = []

    def drive():
        for p in range(3):
            out.extend(x.i for x in pipelined_partition(pconf, ctx, part(p), lambda it: it))

    t = threading.Thread(target=drive, daemon=True)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive(), "the second partition's producer never got the permit"
    assert out == [p * 10 + i for p in range(3) for i in range(5)]


# ── end to end: the pipeline, fusion and tasks do not change rows ───────────


@pytest.fixture(scope="module")
def port_tables():
    return {n: port_gen_table(n, SF) for n in TABLES}


@pytest.fixture(scope="module")
def jax_tables():
    return {n: jax_gen_table(n, SF) for n in TABLES}


#: the four runtime settings of the chip check (b) plus fusion off
_SETTINGS = {
    "default": {},
    "unfused": {"spark.rapids.tpu.fusion.enabled": False},
    "pipeline_off": {"spark.rapids.tpu.pipeline.enabled": False},
    "one_task": {"spark.rapids.sql.concurrentGpuTasks": 1},
    "one_task_pipeline_off": {
        "spark.rapids.sql.concurrentGpuTasks": 1,
        "spark.rapids.tpu.pipeline.enabled": False,
    },
}


def _assert_rows_close(a, b, what):
    a, b = _normalize(a, True), _normalize(b, True)
    assert len(a) == len(b), f"{what}: {len(a)} vs {len(b)} rows"
    for i, (ra, rb) in enumerate(zip(a, b)):
        for j, (x, y) in enumerate(zip(ra, rb)):
            assert _values_equal(x, y, approx_float=True), f"{what} row {i} col {j}: {x!r} vs {y!r}"


@pytest.mark.parametrize("n", [1, 3, 5, 18])
def test_runtime_settings_bit_identical_and_match_jax(n, port_tables, jax_tables):
    """q1, q3, q5 and q18 from 3 input partitions at 2 shuffle partitions
    under each runtime setting: the rows are bit-identical across the
    settings (partitions commit in map-partition order whatever task ends
    first), and equal to the JAX CPU engine's."""
    rows = {}
    for name, conf in _SETTINGS.items():
        s = TorchSession(
            {"spark.sql.shuffle.partitions": 2, "spark.rapids.sql.test.enabled": True, **conf},
            device="cpu",
        )
        rows[name] = tpch_query(
            n, lambda t: s.create_dataframe(port_tables[t], num_partitions=3), Q11_SF
        ).collect()
        if name == "unfused":
            assert s._last_fused_stages == 0
    base = rows["default"]
    for name, got in rows.items():
        assert got == base, f"q{n}: {name} rows differ from the default run"
    js = cpu_session({"spark.sql.shuffle.partitions": 2})
    want = jq.tpch_query(
        n, lambda t: js.create_dataframe(jax_tables[t], num_partitions=3), Q11_SF
    ).collect()
    _assert_rows_close(base, want, f"q{n} port vs JAX CPU engine")


# ── fusion ──────────────────────────────────────────────────────────────────


def _stages(plan) -> list:
    """(step kinds, parent kind) of every StageExec in a pre-order walk,
    with the node kinds stripped of their package's prefix."""

    def kind(node) -> str:
        name = type(node).__name__
        for p in ("Tpu", "Gpu"):
            if name.startswith(p):
                name = name[len(p):]
        return name

    out = []

    def walk(node, parent):
        if type(node).__name__ == "StageExec":
            out.append((tuple(step[0] for step in node.fused), kind(parent) if parent else None))
        for c in node.children:
            walk(c, node)

    walk(plan, None)
    return out


@pytest.fixture(scope="module")
def jax_planner():
    """A JAX device session that plans without compiling: no kernel
    pre-compilation, and its subqueries resolved through a JAX CPU-engine
    session (the device engine would compile them)."""
    s = tpu_session({"spark.rapids.tpu.precompile.enabled": False}, strict=False)
    cpu = cpu_session()
    s._resolve_subqueries = cpu._resolve_subqueries
    return s


@pytest.mark.parametrize("n", sorted(QUERIES))
def test_tpch_stages_match_jax_planner(n, port_tables, jax_tables, jax_planner):
    """The stages fuse_stages forms on each TPC-H plan (one input
    partition), from both packages' planners: the same number, the same
    step kinds in the same order, under the same parent operator."""
    port = TorchSession({}, device="cpu")
    pplan, _ = port._physical_plan(
        tpch_query(n, lambda t: port.create_dataframe(port_tables[t]), Q11_SF)._plan
    )
    jdf = jq.tpch_query(n, lambda t: jax_planner.create_dataframe(jax_tables[t]), Q11_SF)
    jplan, _ = jax_planner._prepare_plan(jdf._plan)
    assert _stages(pplan) == _stages(jplan), f"q{n}"


@pytest.mark.parametrize("n", sorted(QUERIES))
def test_tpch_fused_vs_unfused_bit_identical(n, port_tables):
    """The JAX package's ``test_tpch_fused_vs_unfused``: fusion changes no
    bit of any TPC-H result."""
    fused = TorchSession({}, device="cpu")
    unfused = TorchSession({"spark.rapids.tpu.fusion.enabled": False}, device="cpu")
    a = tpch_query(n, lambda t: fused.create_dataframe(port_tables[t]), Q11_SF).collect()
    b = tpch_query(n, lambda t: unfused.create_dataframe(port_tables[t]), Q11_SF).collect()
    assert a == b, f"q{n}"
    assert unfused._last_fused_stages == 0


def _chain_df(s):
    from spark_rapids_tpu_torch.functions import col, lit

    df = s.create_dataframe(
        {"a": np.arange(100, dtype=np.int64), "b": np.arange(100, dtype=np.float64) / 3}
    )
    return (
        df.filter(col("a") > 5)
        .select((col("a") + lit(1)).alias("a1"), (col("b") * lit(2.0)).alias("b2"))
        .filter(col("b2") < lit(50.0))
    )


def test_chain_fuses_into_stage_exec_and_kill_switch():
    s = TorchSession({}, device="cpu")
    df = _chain_df(s)
    plan, _ = s._physical_plan(df._plan)
    stages = [n for n in _walk(plan) if isinstance(n, StageExec)]
    assert len(stages) == 1 and [st[0] for st in stages[0].fused] == ["filter", "project", "filter"]
    assert "Stage(3)" in plan.tree_string()
    off = TorchSession({"spark.rapids.tpu.fusion.enabled": False}, device="cpu")
    off_plan, _ = off._physical_plan(_chain_df(off)._plan)
    assert not any(isinstance(n, StageExec) for n in _walk(off_plan))
    assert df.collect() == _chain_df(off).collect()


def test_max_ops_splits_chain():
    s = TorchSession({"spark.rapids.tpu.fusion.maxOps": 2}, device="cpu")
    plan, _ = s._physical_plan(_chain_df(s)._plan)
    stages = [n for n in _walk(plan) if isinstance(n, StageExec)]
    assert [len(st.fused) for st in stages] == [2]  # the third op stays alone


def test_single_op_task_dependent_and_ansi_stay_unfused():
    from spark_rapids_tpu_torch.functions import col, lit, spark_partition_id

    s = TorchSession({}, device="cpu")
    df = s.create_dataframe({"a": np.arange(10, dtype=np.int64)})
    lone = df.filter(col("a") > 3)
    plan, _ = s._physical_plan(lone._plan)
    assert not any(isinstance(n, StageExec) for n in _walk(plan))
    task_dep = df.filter(col("a") > 1).select(spark_partition_id().alias("p"), col("a"))
    plan, _ = s._physical_plan(task_dep._plan)
    assert not any(isinstance(n, StageExec) for n in _walk(plan))
    ansi = TorchSession({"spark.sql.ansi.enabled": True}, device="cpu")
    adf = ansi.create_dataframe({"a": np.arange(10, dtype=np.int64)})
    chained = adf.filter(col("a") > 1).select((col("a") + lit(1)).alias("b"))
    plan, _ = ansi._physical_plan(chained._plan)
    assert not any(isinstance(n, StageExec) for n in _walk(plan))


def test_breaker_open_stage_rebuilds_unfused():
    from spark_rapids_tpu_torch.plan.fusion import stage_signature

    s = TorchSession({}, device="cpu")
    plan, _ = s._physical_plan(_chain_df(s)._plan)
    st = next(n for n in _walk(plan) if isinstance(n, StageExec))
    before = GLOBAL.counter("fusion.breakerFallbacks").value
    s._breaker.force_open(stage_signature(st.fused), RuntimeError("stage failed"))
    plan2, _ = s._physical_plan(_chain_df(s)._plan)
    assert not any(isinstance(n, StageExec) for n in _walk(plan2))
    assert GLOBAL.counter("fusion.breakerFallbacks").value == before + 1
    assert s._last_fused_stages == 0


def test_contains_rows_fuses_with_contains():
    """The slice's string filter: ``contains_rows`` becomes a two-step
    stage holding ``Contains``, and its rows equal the unfused run's."""
    orders = port_gen_table("orders", SF)
    s = TorchSession({}, device="cpu")
    fn, _ = SLICE_QUERIES["contains_rows"]
    df = fn(lambda t: s.create_dataframe(orders))
    got = df.collect()
    plan = s._last_plan
    stages = [n for n in _walk(plan) if isinstance(n, StageExec)]
    assert len(stages) == 1 and "contains(" in stages[0].node_string()
    assert [step[0] for step in stages[0].fused] == ["filter", "project"]
    off = TorchSession({"spark.rapids.tpu.fusion.enabled": False}, device="cpu")
    assert got == fn(lambda t: off.create_dataframe(orders)).collect()


def _walk(node):
    yield node
    for c in node.children:
        yield from _walk(c)


# ── concurrency, speculation and the watchdog ──────────────────────────────


def test_concurrent_coalesce_commits_in_partition_order():
    """Partitions whose tasks finish in reverse order still come out in
    partition order: the coalesce commits by index."""
    s = TorchSession({"spark.rapids.sql.concurrentGpuTasks": 4}, device="cpu")
    df = s.create_dataframe({"a": np.arange(400, dtype=np.int64)}, num_partitions=4)
    from spark_rapids_tpu_torch.columnar.host import HostBatch  # noqa: F401
    from spark_rapids_tpu_torch.exec import gpu as G

    real = G.HostToDeviceExec.execute

    def slow_first(self, ctx):
        pset = real(self, ctx)

        def delayed(p, thunk):
            def it():
                time.sleep(0.05 * (4 - p))
                yield from thunk()

            return it

        from spark_rapids_tpu_torch.plan.physical import PartitionSet

        return PartitionSet([delayed(p, t) for p, t in enumerate(pset.parts)])

    G.HostToDeviceExec.execute = slow_first
    try:
        rows = df.select((F.col("a") * F.lit(2)).alias("b")).collect()
    finally:
        G.HostToDeviceExec.execute = real
    assert [r[0] for r in rows] == [2 * i for i in range(400)]


def test_speculation_overtakes_a_straggler():
    """The straggler fault point stalls partition 2's first attempt; with
    speculation on, a duplicate wins and the rows equal the plain run."""
    from spark_rapids_tpu_torch.functions import col, sum as sum_

    conf = {
        "spark.rapids.tpu.speculation.enabled": True,
        "spark.rapids.tpu.speculation.minRuntime": 0.05,
        "spark.rapids.tpu.speculation.quantile": 0.5,
        "spark.rapids.tpu.faults.enabled": True,
        "spark.rapids.tpu.faults.stallPartition": 2,
        "spark.rapids.tpu.faults.stallPartitionSeconds": 5.0,
        "spark.sql.shuffle.partitions": 4,
    }
    data = {"k": np.arange(1000, dtype=np.int64) % 7, "v": np.arange(1000, dtype=np.float64)}

    def query(s):
        return (
            s.create_dataframe(data, num_partitions=4)
            .group_by("k").agg(sum_(col("v")).alias("s")).sort("k")
        )

    plain = query(TorchSession({"spark.sql.shuffle.partitions": 4}, device="cpu")).collect()
    launched = GLOBAL.counter("speculation.launched").value
    won = GLOBAL.counter("speculation.won").value
    s = TorchSession(conf, device="cpu")
    t0 = time.monotonic()
    got = query(s).collect()
    assert time.monotonic() - t0 < 4.5, "the straggler was waited out, not overtaken"
    assert got == plain
    assert GLOBAL.counter("speculation.launched").value >= launched + 1
    assert GLOBAL.counter("speculation.won").value >= won + 1


def test_watchdog_cancels_a_stalled_query_and_classifies_it():
    """An injected device-launch stall with no progress beat past a 0.3 s
    stallTimeout: the watchdog cancels the query with reason
    ``stall:launch``, counts it per site, and the session runs on."""
    from spark_rapids_tpu_torch.functions import col, lit
    from spark_rapids_tpu_torch.sched import QueryCancelledError

    conf = {
        "spark.rapids.tpu.watchdog.stallTimeout": 0.3,
        "spark.rapids.tpu.watchdog.beatInterval": 0.05,
        "spark.rapids.tpu.faults.enabled": True,
        "spark.rapids.tpu.faults.kernelStallEveryN": 1,
        "spark.rapids.tpu.faults.kernelStallMs": 900.0,
    }
    s = TorchSession(conf, device="cpu")
    stalls = GLOBAL.counter("watchdog.stalls").value
    df = s.create_dataframe({"a": np.arange(50, dtype=np.int64)}).select((col("a") + lit(1)).alias("b"))
    t0 = time.monotonic()
    with pytest.raises(QueryCancelledError) as ei:
        df.collect()
    assert time.monotonic() - t0 < 10
    assert ei.value.reason.startswith("stall:launch")
    assert GLOBAL.counter("watchdog.stalls").value == stalls + 1
    assert GLOBAL.counter("watchdog.stalls.site.launch").value >= 1
    assert s.active_queries() == {}
    ok = TorchSession({}, device="cpu")
    assert ok.create_dataframe({"a": np.arange(3, dtype=np.int64)}).collect() == [(0,), (1,), (2,)]
