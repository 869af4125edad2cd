"""The port's resilience runtime (``spark_rapids_tpu_torch/resilience/``,
the session's task retry and the overrides' breaker) held against the JAX
package's: OOM classification and the retry state machine
(``tests/test_resilience.py``, with ``torch.cuda.OutOfMemoryError`` in the
place of the JAX wrappers), lineage and attempts (``tests/test_recovery.py``),
task retry (``tests/test_task_retry.py``) and the chaos cases
(``tests/test_chaos.py``: q6 under injected OOM, split-and-retry, the split
floor, the out-of-core sort under spill write errors, the counters). Since
the shuffle slice also the shuffle, heartbeat and TCP cases: heartbeat
liveness and eviction, the client's retry, backoff, blacklist and
cancellable throttle and the handshake deadline (``test_resilience.py``),
the attempt-striped commit, abort and map-output recomputation
(``test_recovery.py``), dropped DATA frames (``test_chaos.py``), the
fault-and-peer-loss storm (``test_chaos_recovery.py``), the managed
shuffle's re-runnable thunks (``test_task_retry.py``) and the watchdog's
stale-peer sweep (``test_survivability.py``). Each query runs on the port
(``device="cpu"``) under faults and without, and on the JAX CPU engine.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

pytest.importorskip("jax")  # the reference; absent on a machine with only the port

import pyarrow as pa  # noqa: E402
from harness import _normalize, cpu_session  # noqa: E402

from spark_rapids_tpu.resilience import retry as JR  # noqa: E402
from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch.columnar import device as PD
from spark_rapids_tpu_torch.columnar.host import HostBatch, HostColumn, batch_rows, from_arrow
from spark_rapids_tpu_torch.exec import task as task_mod
from spark_rapids_tpu_torch.mem.spill import BufferCatalog, SpillError, StorageTier, with_oom_retry
from spark_rapids_tpu_torch.obs.metrics import GLOBAL
from spark_rapids_tpu_torch.plan.physical import Exec, ExecContext, PartitionSet
from spark_rapids_tpu_torch.resilience import (
    CircuitBreaker,
    FaultConfig,
    InjectedFault,
    RetryPolicy,
    faults,
    is_device_error,
    is_oom_error,
    is_sticky_device_error,
    lineage,
    run_once,
    run_with_retry,
    split_batch,
)
from spark_rapids_tpu_torch.resilience import retry as R
from spark_rapids_tpu_torch.sched.cancel import CancelToken, LinkedCancelToken, QueryCancelledError
from spark_rapids_tpu_torch.types import LONG, Schema, StructField

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _reset_counters():
    R.reset()
    JR.reset()
    yield
    R.reset()
    JR.reset()


def _batch(n=100, seed=0):
    rng = np.random.default_rng(seed)
    rb = pa.record_batch(
        {
            "a": pa.array(rng.integers(0, 1000, n).astype(np.int64)),
            "s": pa.array([f"val{i % 17}" for i in range(n)]),
        }
    )
    return PD.host_to_device(from_arrow(rb), "cpu")


def _rows(db):
    return batch_rows(PD.device_to_host(db))


def _counter(name: str) -> int:
    return GLOBAL.counter(name).value


# ── classification ──────────────────────────────────────────────────────────


def test_oom_classified_through_cause_chain():
    """A clean top-level message wrapping torch's OOM (explicit cause, or the
    implicit context of a re-raise) classifies as OOM — in both packages for
    the shared wording, in the port for torch's class."""
    inner = torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 8.00 GiB")
    try:
        raise RuntimeError("partition task failed") from inner
    except RuntimeError as outer:
        assert is_oom_error(outer) and not is_device_error(outer)
    try:
        try:
            raise inner
        except torch.cuda.OutOfMemoryError:
            raise RuntimeError("launch failed")  # implicit __context__ link
    except RuntimeError as outer:
        assert is_oom_error(outer)
    shared = RuntimeError("task died")
    shared.__cause__ = RuntimeError("CUDA error: out of memory")
    assert is_oom_error(shared) and JR.is_oom_error(shared)


@pytest.mark.parametrize("err", [ValueError("boom"), KeyError("k"), RuntimeError("bad shape")])
def test_non_oom_not_classified(err):
    assert is_oom_error(err) == JR.is_oom_error(err) is False
    assert is_device_error(err) == JR.is_device_error(err) is False


def test_memory_error_and_injected_fault_are_ooms():
    for err in (MemoryError(), InjectedFault("oom", "CUDA out of memory: injected")):
        assert is_oom_error(err)
    assert not is_oom_error(InjectedFault("kernel", "CUDA error: injected"))
    assert is_device_error(InjectedFault("kernel", "CUDA error: injected"))


def test_cause_cycle_terminates():
    a, b = RuntimeError("a"), RuntimeError("b")
    a.__cause__, b.__cause__ = b, a
    assert not is_oom_error(a) and not JR.is_oom_error(a)


@pytest.mark.parametrize(
    "msg",
    [
        "CUDA error: an illegal memory access was encountered",
        "CUDA error: device-side assert triggered",
        "CUDA error: unspecified launch failure",
        "CUDA error: misaligned address",
    ],
)
def test_sticky_cuda_errors(msg):
    """Sticky CUDA errors are device errors, never OOMs, never recoverable
    — even when the context of one holds an OOM's wording."""
    err = RuntimeError(msg)
    err.__context__ = RuntimeError("CUDA out of memory")
    assert is_sticky_device_error(err) and is_device_error(err)
    assert not is_oom_error(err)
    assert not lineage.is_recoverable(err)
    assert lineage.is_recoverable(RuntimeError("CUDA error: invalid configuration argument"))


def test_with_oom_retry_recovers_wrapped_error():
    cat = BufferCatalog()
    h = cat.register(_batch())
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("task died") from torch.cuda.OutOfMemoryError("CUDA out of memory")
        return 7

    assert with_oom_retry(cat, flaky) == 7
    assert calls["n"] == 2 and cat.spill_count == 1
    assert R.report()["oom_retries"] == 1
    h.close()


# ── split-and-retry state machine ──────────────────────────────────────────


def test_split_batch_preserves_rows():
    """The halves hold the batch's rows in order — the JAX package's halves
    of the same rows give the same rows."""
    from spark_rapids_tpu.columnar.device import device_to_host as jd2h
    from spark_rapids_tpu.columnar.device import host_to_device as jh2d

    rb = pa.record_batch({"a": pa.array(np.arange(100, dtype=np.int64)),
                          "s": pa.array([f"v{i}" for i in range(100)])})
    db = PD.host_to_device(from_arrow(rb), "cpu")
    lo, hi = split_batch(db)
    assert lo.capacity == db.capacity // 2 and hi.capacity == db.capacity // 2
    assert _rows(lo) + _rows(hi) == _rows(db)
    jlo, jhi = JR.split_batch(jh2d(rb))

    def jrows(b):
        t = jd2h(b)
        return [tuple(c[i].as_py() for c in t.columns) for i in range(t.num_rows)]

    # the JAX capacity may carry a shape-bucket floor: each package's halves
    # hold its first cap/2 rows and the rest
    jdb = jh2d(rb)
    assert jrows(jlo) + jrows(jhi) == _rows(lo) + _rows(hi)
    assert len(jrows(jlo)) == min(100, jdb.capacity // 2) and len(_rows(lo)) == min(100, db.capacity // 2)
    # padding rows of each half stay inert
    assert not bool(hi.columns[0].validity[int(hi.num_rows):].any())


def test_run_with_retry_splits_to_fit():
    db = _batch(200)
    want = _rows(db)

    def kernel(b):
        if b.capacity > 64:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory: injected")
        return b

    policy = RetryPolicy(max_retries=0, split_enabled=True, min_split_rows=2)
    outs = list(run_with_retry(None, kernel, db, policy))
    assert [r for o in outs for r in _rows(o)] == want
    assert all(o.capacity <= 64 for o in outs)
    assert R.report()["splits"] > 0


def test_run_with_retry_spills_before_splitting():
    cat = BufferCatalog()
    parked = cat.register(_batch(seed=3))
    db = _batch(100)
    calls = {"n": 0}

    def kernel(b):
        calls["n"] += 1
        if calls["n"] == 1:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory: first launch")
        return b

    outs = list(run_with_retry(cat, kernel, db, RetryPolicy(max_retries=2)))
    assert len(outs) == 1 and _rows(outs[0]) == _rows(db)
    assert cat.spill_count >= 1  # the retry spilled the parked buffer
    assert R.report()["oom_retries"] == 1 and R.report()["splits"] == 0
    parked.close()


def test_run_with_retry_floor_reraises():
    def kernel(b):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory: always")

    policy = RetryPolicy(max_retries=0, split_enabled=True, min_split_rows=64)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        list(run_with_retry(None, kernel, _batch(100), policy))


def test_run_with_retry_non_oom_propagates_and_feeds_breaker():
    breaker = CircuitBreaker(threshold=2)

    def kernel(b):
        raise InjectedFault("kernel", "CUDA error: bad kernel")

    for _ in range(2):
        with pytest.raises(InjectedFault):
            list(run_with_retry(None, kernel, _batch(10), op="ProjectExec", breaker=breaker))
    assert breaker.is_open("ProjectExec")
    assert "circuit breaker open" in breaker.check("ProjectExec")
    assert R.report()["circuit_breaker_trips"] == 1


def test_run_once_never_splits():
    def kernel(b):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory: always")

    with pytest.raises(torch.cuda.OutOfMemoryError):
        run_once(None, kernel, _batch(100), RetryPolicy(max_retries=0))
    assert R.report()["splits"] == 0


def test_sticky_error_is_not_retried_nor_pinned_on_the_op(monkeypatch):
    """An asynchronous CUDA fault surfaces in whichever op syncs: it is never
    retried, never split, and the breaker records it unattributed; with
    synchronous launches it counts against the op."""
    breaker = CircuitBreaker(threshold=1)
    calls = {"n": 0}

    def kernel(b):
        calls["n"] += 1
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    cat = BufferCatalog()
    with pytest.raises(RuntimeError, match="illegal memory access"):
        list(run_with_retry(cat, kernel, _batch(100), RetryPolicy(max_retries=2, min_split_rows=2),
                            op="FilterExec", breaker=breaker))
    assert calls["n"] == 1 and R.report()["oom_retries"] == 0 and R.report()["splits"] == 0
    state = breaker.state()
    assert state["open"] == [] and state["failures"] == {}
    assert state["device_faults"][0][0] == "FilterExec"
    monkeypatch.setenv("CUDA_LAUNCH_BLOCKING", "1")
    with pytest.raises(RuntimeError):
        run_once(cat, kernel, _batch(10), op="FilterExec", breaker=breaker)
    assert breaker.is_open("FilterExec")


def test_oom_pressure_clamps_the_join_window():
    """A query that has handled a device OOM closes its join's probe window
    and output cut to a quarter of the batch size; the rows do not change,
    and the next query, with no OOM of its own, is not clamped."""
    from spark_rapids_tpu_torch.functions import col

    t1 = pa.table({"k": np.arange(3000, dtype=np.int64) % 50, "v": np.arange(3000, dtype=np.int64)})
    t2 = pa.table({"k": np.arange(50, dtype=np.int64), "w": np.arange(50, dtype=np.int64) * 2})
    conf = {"spark.rapids.sql.batchSizeBytes": "65536", "spark.sql.autoBroadcastJoinThreshold": -1}

    def q(s):
        rows = sorted(s.create_dataframe(t1, num_partitions=2)
                      .join(s.create_dataframe(t2), on="k")
                      .filter(col("v") > 10).collect())
        return rows, s._last_metrics["joinProbeSyncs"]

    base, base_syncs = q(TorchSession(conf, device="cpu"))
    got, syncs = q(TorchSession({**conf, **_FAULTS, "spark.rapids.tpu.faults.deviceOomEveryN": 2},
                                device="cpu"))
    assert R.report()["oom_retries"] > 0
    assert got == base and syncs > base_syncs
    assert q(TorchSession(conf, device="cpu")) == (base, base_syncs)


# ── spill disk-tier error paths ────────────────────────────────────────────


def _spill_to_disk(cat, h):
    cat.synchronous_spill(h.size_bytes)
    cat.host_limit = 0
    cat.synchronous_spill(0)
    assert cat.disk_bytes > 0


def test_disk_rematerialize_missing_file_names_buffer(tmp_path):
    cat = BufferCatalog(spill_dir=str(tmp_path))
    h = cat.register(_batch())
    _spill_to_disk(cat, h)
    for f in tmp_path.iterdir():
        f.unlink()
    with pytest.raises(SpillError) as ei:
        h.get_batch()
    assert f"buffer {h.id}" in str(ei.value) and "DISK" in str(ei.value)


def test_disk_rematerialize_corrupt_file_names_buffer(tmp_path):
    cat = BufferCatalog(spill_dir=str(tmp_path))
    h = cat.register(_batch())
    _spill_to_disk(cat, h)
    (path,) = tmp_path.iterdir()
    path.write_bytes(b"not a spill file")
    with pytest.raises(SpillError) as ei:
        h.get_batch()
    assert f"buffer {h.id}" in str(ei.value) and "DISK" in str(ei.value)


def test_spill_write_error_degrades_to_host_tier(tmp_path):
    cat = BufferCatalog(spill_dir=str(tmp_path))
    h = cat.register(_batch())
    want = _rows(h.get_batch())
    h.unpin()
    cat.synchronous_spill(h.size_bytes)
    with faults.scoped(FaultConfig(spill_write_error_every_n=1)):
        cat.host_limit = 0
        cat.synchronous_spill(0)
    assert cat.disk_bytes == 0 and cat.host_bytes == h.size_bytes
    assert cat._buffers[h.id].tier == StorageTier.HOST
    assert R.report()["spill_write_errors"] == 1
    assert _rows(h.get_batch()) == want
    h.close()


# ── circuit breaker → planner fallback (session integration) ───────────────


def test_circuit_breaker_marks_op_cpu_fallback():
    """Repeated device failures of the project open its breaker; the next
    plan puts it on the CPU engine with the breaker's reason, as the JAX
    session does."""
    from spark_rapids_tpu_torch.functions import col

    t = pa.table({"a": np.arange(64, dtype=np.int64)})
    s = TorchSession(
        {
            "spark.rapids.tpu.faults.enabled": True,
            "spark.rapids.tpu.faults.kernelErrorEveryN": 1,
            "spark.rapids.tpu.retry.circuitBreaker.threshold": 2,
            "spark.task.maxFailures": 3,
        },
        device="cpu",
    )

    def q():
        return s.create_dataframe(t).select((col("a") + 1).alias("b")).collect()

    with pytest.raises(InjectedFault):
        q()
    assert s._breaker.is_open("ProjectExec")
    s._fault_injector = None  # the faults heal
    assert [r[0] for r in q()] == list(range(1, 65))
    reasons = [r for e in s._last_overrides.explain if not e.on_device for r in e.reasons]
    assert any("circuit breaker open" in r for r in reasons), reasons


# ── lineage and attempts (tests/test_recovery.py) ──────────────────────────


def test_linked_token_child_cancel_leaves_parent_running():
    parent = CancelToken("q1")
    child = LinkedCancelToken(parent)
    child.cancel("speculation")
    assert child.cancelled and not parent.cancelled
    parent.check()
    with pytest.raises(QueryCancelledError) as ei:
        child.check()
    assert ei.value.reason == "speculation"


def test_linked_token_parent_cancel_propagates_to_child():
    parent = CancelToken("q2")
    child = LinkedCancelToken(parent)
    parent.cancel("user")
    assert child.cancelled
    with pytest.raises(QueryCancelledError):
        child.check()


def test_attempt_scope_sets_thread_local_task_attempt():
    assert task_mod.current_attempt() == 0
    with lineage.attempt_scope(2):
        assert task_mod.current_attempt() == 2
        info = task_mod.TaskInfo(5, attempt=task_mod.current_attempt())
        assert (info.partition_id, info.attempt) == (5, 2)
    assert task_mod.current_attempt() == 0


def test_task_descriptor_lineage_identity():
    d = lineage.TaskDescriptor(3, plan_label="scan", query_id="q9")
    assert (d.plan_label, d.partition_id, d.attempt) == ("scan", 3, 0)
    assert d.next_attempt() == 1
    assert d.attempt == 1 and d.partition_id == 3


def test_failed_attempt_reexecutes_only_that_partition():
    s = TorchSession({"spark.task.maxFailures": 3}, device="cpu")
    calls = {"n": 0}

    def flaky_thunk():
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("injected transient partition failure")
        assert task_mod.current_attempt() == 1  # re-run under attempt 1
        return iter([])

    base = _counter("task.reattempts")
    assert s._run_task(flaky_thunk, attempts=3, partition_id=7) == []
    assert calls["n"] == 2
    assert _counter("task.reattempts") == base + 1


def test_deterministic_errors_never_retry():
    s = TorchSession({"spark.task.maxFailures": 4}, device="cpu")
    calls = {"n": 0}

    def broken_thunk():
        calls["n"] += 1
        raise AssertionError("semantic: retrying cannot help")

    with pytest.raises(AssertionError):
        s._run_task(broken_thunk, attempts=4, partition_id=0)
    assert calls["n"] == 1


def test_is_recoverable_classification():
    from spark_rapids_tpu.resilience import lineage as jlineage
    from spark_rapids_tpu.sched.cancel import QueryCancelledError as JQCE

    cases = [RuntimeError("boom"), TimeoutError("fetch"), AssertionError("no"), KeyboardInterrupt()]
    assert [lineage.is_recoverable(e) for e in cases] == [jlineage.is_recoverable(e) for e in cases]
    assert not lineage.is_recoverable(QueryCancelledError("q", "user"))
    assert not jlineage.is_recoverable(JQCE("q", "user"))


def test_cancelled_query_stops_at_a_batch_boundary_and_is_not_retried():
    """The run loops check the query's token once per batch: a cancelled
    query raises the typed error, and the task loop never retries it."""
    from spark_rapids_tpu_torch.functions import col

    s = TorchSession({"spark.rapids.sql.batchSizeBytes": "2048"}, device="cpu")
    df = s.create_dataframe(pa.table({"a": np.arange(5000, dtype=np.int64)})).filter(col("a") > 3)
    tok = CancelToken("q7")
    tok.cancel("user")
    with pytest.raises(QueryCancelledError):
        s._execute(df._plan, token=tok)
    assert s._task_retries == 0
    assert len(s._execute(df._plan, token=CancelToken("q8")).columns[0]) == 4996


# ── task retry on the partition lineage (tests/test_task_retry.py) ──────────

_X = Schema([StructField("x", LONG, True)])


def _host(values) -> HostBatch:
    arr = np.asarray(values, dtype=np.int64)
    return HostBatch(_X, [HostColumn(LONG, arr, np.ones(len(arr), dtype=bool))], len(arr))


class FlakyScanExec(Exec):
    """One batch per partition; each partition fails its first
    ``fail_times`` attempts with a transient error."""

    def __init__(self, fail_times: int):
        super().__init__([])
        self.fail_times = fail_times
        self.attempts: dict = {}

    @property
    def output(self) -> Schema:
        return _X

    def execute(self, ctx: ExecContext) -> PartitionSet:
        def make(p):
            def it():
                n = self.attempts.get(p, 0)
                self.attempts[p] = n + 1
                if n < self.fail_times:
                    raise ConnectionError(f"transient failure p={p} attempt={n}")
                yield _host([p * 10, p * 10 + 1])

            return it

        return PartitionSet([make(p) for p in range(3)])


class PartialThenFailExec(Exec):
    """Yields one batch, then fails: the failed attempt's partial stream is
    discarded, not duplicated, when the retry succeeds."""

    def __init__(self):
        super().__init__([])
        self.attempts = 0

    @property
    def output(self) -> Schema:
        return _X

    def execute(self, ctx: ExecContext) -> PartitionSet:
        def it():
            self.attempts += 1
            yield _host([1, 2])
            if self.attempts == 1:
                raise TimeoutError("died mid-stream")
            yield _host([3])

        return PartitionSet([it])


def _run(session, plan):
    return session._run_plan(plan, ExecContext(session.conf, session))


def _xs(hb: HostBatch) -> list:
    return sorted(r[0] for r in batch_rows(hb))


def test_transient_failure_retried_from_lineage():
    s = TorchSession({}, device="cpu")
    plan = FlakyScanExec(fail_times=1)
    assert _xs(_run(s, plan)) == [0, 1, 10, 11, 20, 21]
    assert s._task_retries == 3  # one failed attempt per partition
    assert all(n == 2 for n in plan.attempts.values())


def test_retry_budget_exhausted_fails_loudly():
    s = TorchSession({"spark.task.maxFailures": 2}, device="cpu")
    with pytest.raises(ConnectionError):
        _run(s, FlakyScanExec(fail_times=5))


def test_partial_stream_not_duplicated():
    s = TorchSession({}, device="cpu")
    assert _xs(_run(s, PartialThenFailExec())) == [1, 2, 3]


def test_deterministic_ansi_error_not_retried():
    from spark_rapids_tpu_torch.expr.base import AnsiError

    class AnsiFailExec(Exec):
        def __init__(self):
            super().__init__([])
            self.attempts = 0

        @property
        def output(self):
            return _X

        def execute(self, ctx):
            def it():
                self.attempts += 1
                raise AnsiError("overflow")
                yield  # pragma: no cover

            return PartitionSet([it])

    s = TorchSession({}, device="cpu")
    plan = AnsiFailExec()
    with pytest.raises(AnsiError):
        _run(s, plan)
    assert plan.attempts == 1


def test_device_ansi_error_is_not_retried_nor_fed_to_the_breaker():
    """The device error channel's AnsiError leaves the project at its batch,
    untried again, with the breaker untouched."""
    from spark_rapids_tpu_torch.expr.base import AnsiError
    from spark_rapids_tpu_torch.functions import col

    s = TorchSession({"spark.sql.ansi.enabled": True}, device="cpu")
    t = pa.table({"a": np.array([1, 2, 2**62], dtype=np.int64)})
    with pytest.raises(AnsiError):
        s.create_dataframe(t).select((col("a") * 4).alias("b")).collect()
    assert s._task_retries == 0 and R.report()["oom_retries"] == 0
    assert s._breaker.state()["failures"] == {}


def test_end_to_end_query_unaffected():
    from spark_rapids_tpu_torch.functions import col
    from spark_rapids_tpu_torch.functions import sum as sum_

    s = TorchSession({}, device="cpu")
    t = pa.table({"k": [1, 1, 2], "v": [1.0, 2.0, 3.0]})
    r = sorted(s.create_dataframe(t).group_by("k").agg(sum_(col("v")).alias("s")).collect())
    assert r == [(1, 3.0), (2, 3.0)]
    assert s._task_retries == 0


# ── chaos (tests/test_chaos.py) ─────────────────────────────────────────────

_FAULTS = {"spark.rapids.tpu.faults.enabled": True}


@pytest.fixture(scope="module")
def tpch_tables():
    from spark_rapids_tpu.tpch import gen_table
    from spark_rapids_tpu.tpch.datagen import TABLES

    return {name: gen_table(name, 0.002) for name in TABLES}


def _tpch(session, tables, n, jax: bool):
    if jax:
        from spark_rapids_tpu.tpch import tpch_query
    else:
        from spark_rapids_tpu_torch.tpch.queries import tpch_query

    def t(name):
        parts = 2 if tables[name].num_rows > 1000 else 1
        return session.create_dataframe(tables[name], num_partitions=parts)

    return _normalize(tpch_query(n, t, sf=1.0).collect(), True)


@pytest.mark.parametrize("n", [6, 1])
def test_tpch_bit_identical_under_injected_oom(n, tpch_tables):
    """q6 (ungrouped) and q1 (grouped) with an injected OOM on every 2nd
    launch under a recovery scope: bit-identical to the fault-free port,
    floats included, and within the harness tolerance of the JAX CPU
    engine; the retry counters show the faults fired."""
    from spark_rapids_tpu_torch.testing import rows_equal

    conf = {"spark.sql.shuffle.partitions": 2}
    base = _tpch(TorchSession(conf, device="cpu"), tpch_tables, n, False)
    got = _tpch(TorchSession({**conf, **_FAULTS, "spark.rapids.tpu.faults.deviceOomEveryN": 2},
                             device="cpu"), tpch_tables, n, False)
    assert got == base
    rep = R.report()
    assert rep["faults_injected"] > 0, "no faults fired — the test is inert"
    assert rep["oom_retries"] >= rep["faults_injected"]
    ok, msg = rows_equal(_tpch(cpu_session(conf), tpch_tables, n, True), got)
    assert ok, msg


def _int_agg_query(F, session):
    col, count, max_, min_, sum_ = F.col, F.count, F.max, F.min, F.sum
    rng = np.random.default_rng(7)
    n = 6000
    t = pa.table({"k": (np.arange(n) % 13).astype(np.int64),
                  "v": rng.integers(0, 1000, n).astype(np.int64)})
    return _normalize(
        session.create_dataframe(t, num_partitions=2)
        .filter(col("v") > 100)
        .group_by("k")
        .agg(sum_(col("v")).alias("s"), count(col("v")).alias("c"),
             min_(col("v")).alias("mn"), max_(col("v")).alias("mx"))
        .collect(),
        True,
    )


def test_split_and_retry_executes_oversized_batch():
    """A batch over the injected device budget completes by recursive
    halving: splits > 0, rows equal to the fault-free port and the JAX CPU
    engine."""
    from spark_rapids_tpu import functions as JF
    from spark_rapids_tpu_torch import functions as PF

    conf = {"spark.sql.shuffle.partitions": 4}
    base = _int_agg_query(PF, TorchSession(conf, device="cpu"))
    R.reset()
    got = _int_agg_query(PF, TorchSession({
        **conf, **_FAULTS,
        # any splittable launch over 48 KiB OOMs: the 3k-row scan batches
        # are far over it, so completion REQUIRES splitting
        "spark.rapids.tpu.faults.oomAboveBytes": 48 * 1024,
        "spark.rapids.tpu.retry.oom.maxRetries": 0,
        "spark.rapids.tpu.retry.oom.minSplitRows": 512,
    }, device="cpu"))
    assert got == base == _int_agg_query(JF, cpu_session(conf))
    rep = R.report()
    assert rep["splits"] > 0 and rep["faults_injected"] > 0


def test_split_floor_fails_loudly():
    """Below the min-rows floor the state machine re-raises instead of
    splitting forever."""
    from spark_rapids_tpu_torch import functions as PF

    s = TorchSession({
        "spark.sql.shuffle.partitions": 2, **_FAULTS,
        "spark.rapids.tpu.faults.oomAboveBytes": 1,  # nothing ever fits
        "spark.rapids.tpu.retry.oom.maxRetries": 0,
        "spark.rapids.tpu.retry.oom.minSplitRows": 1 << 20,  # floor ≈ cap
        "spark.task.maxFailures": 1,
    }, device="cpu")
    with pytest.raises(InjectedFault, match="out of memory"):
        _int_agg_query(PF, s)


def test_out_of_core_sort_survives_spill_write_errors(tmp_path):
    """The out-of-core sort parks runs in the catalog with a tiny device and
    host budget, so runs overflow to disk constantly; injected write errors
    leave runs at the host tier and the rows equal the fault-free port's
    and the JAX CPU engine's."""
    rng = np.random.default_rng(11)
    n = 600
    t = pa.table({"k": pa.array(rng.integers(-500, 500, n).astype(np.int64)),
                  "s": pa.array([f"s{int(x)}" for x in rng.integers(0, 50, n)])})
    conf = {
        "spark.sql.shuffle.partitions": 2,
        "spark.rapids.tpu.sort.outOfCoreThresholdBytes": "1",
        "spark.rapids.sql.batchSizeBytes": "2048",
        "spark.rapids.tpu.memory.deviceLimitBytes": "16384",
        "spark.rapids.memory.host.spillStorageSize": "4096",
    }

    def q(session):
        return session.create_dataframe(t, num_partitions=3).sort("k", "s").collect()

    base = q(TorchSession({**conf, "spark.rapids.memory.spillDir": str(tmp_path / "clean")},
                          device="cpu"))
    got = q(TorchSession({**conf, **_FAULTS,
                          "spark.rapids.memory.spillDir": str(tmp_path / "chaos"),
                          "spark.rapids.tpu.faults.spill.writeErrorEveryN": 2}, device="cpu"))
    assert got == base == [tuple(r) for r in q(cpu_session(conf))]
    assert R.report()["spill_write_errors"] > 0, "no disk writes were hit"


def test_out_of_core_sort_spill_read_errors_fail_loudly(tmp_path):
    """``spark.rapids.tpu.faults.spill.readErrorEveryN``: a run parked on
    disk that cannot be read back fails the query with a ``SpillError``
    naming the buffer and its DISK tier, after the task's attempts; it
    never yields rows."""
    rng = np.random.default_rng(11)
    n = 600
    t = pa.table({"k": pa.array(rng.integers(-500, 500, n).astype(np.int64))})
    s = TorchSession({
        "spark.sql.shuffle.partitions": 2,
        "spark.rapids.tpu.sort.outOfCoreThresholdBytes": "1",
        "spark.rapids.sql.batchSizeBytes": "2048",
        "spark.rapids.tpu.memory.deviceLimitBytes": "16384",
        "spark.rapids.memory.host.spillStorageSize": "0",
        "spark.rapids.memory.spillDir": str(tmp_path),
        "spark.task.maxFailures": 2,
        **_FAULTS,
        "spark.rapids.tpu.faults.spill.readErrorEveryN": 1,
    }, device="cpu")
    reattempts = GLOBAL.counter("task.reattempts").value
    with pytest.raises(SpillError, match=r"buffer \d+ .*DISK tier.*injected spill-disk read"):
        s.create_dataframe(t, num_partitions=3).sort("k").collect()
    assert R.report()["faults_injected"] >= 2  # one per attempt
    assert GLOBAL.counter("task.reattempts").value > reattempts


def test_resilience_report_counters_present():
    rep = R.report()
    for key in ("oom_retries", "splits", "circuit_breaker_trips", "spill_write_errors",
                "faults_injected"):
        assert key in rep
    assert TorchSession({}, device="cpu")._breaker.state()["open"] == []


# ── the port's splits beyond the JAX package's ─────────────────────────────


def test_sort_last_merge_splits_by_key_rank(monkeypatch):
    """The out-of-core sort's last merge, under an OOM that spills cannot
    cure, splits by key rank (recursively) and still gives the rows of the
    JAX CPU engine in order: ties across the two runs, nulls and strings
    included."""
    from spark_rapids_tpu_torch.exec import gpu as G

    real = G.device_merge_fn

    def small_only(order):
        merge = real(order)

        def run(a, b):
            if a.capacity + b.capacity > 256:
                raise torch.cuda.OutOfMemoryError("CUDA out of memory: merge too large")
            return merge(a, b)

        return run

    monkeypatch.setattr(G, "device_merge_fn", small_only)
    rng = np.random.default_rng(5)
    n = 1500
    k = rng.integers(0, 40, n).astype(np.int64)
    t = pa.table({
        "k": pa.array([None if i % 17 == 0 else int(x) for i, x in enumerate(k)], type=pa.int64()),
        "s": pa.array([f"s{int(x) % 7}" for x in rng.integers(0, 100, n)]),
        "v": pa.array(np.arange(n, dtype=np.int64)),
    })
    # two upload chunks of ~750 rows: two runs, so the merge that fails is
    # the last one
    conf = {"spark.rapids.tpu.sort.outOfCoreThresholdBytes": "1",
            "spark.rapids.sql.batchSizeBytes": "63000",
            "spark.rapids.tpu.retry.oom.minSplitRows": 16}
    got = (TorchSession(conf, device="cpu").create_dataframe(t)
           .sort("k", "s").collect())
    want = cpu_session(conf).create_dataframe(t).sort("k", "s").collect()
    # both sorts are stable: equal keys keep their input order (v)
    assert got == [tuple(r) for r in want]
    assert R.report()["splits"] > 0


@pytest.mark.parametrize("how", ["inner", "left", "full"])
def test_join_phase2_splits_its_probe_rows(monkeypatch, how):
    """Phase 2 of a probe chunk whose output would pass an (injected) OOM
    threshold halves the chunk's probe rows until each half fits; inner,
    left (the probe's null extension per half) and full (the build's match
    bits over the halves) give the JAX CPU engine's rows."""
    from spark_rapids_tpu_torch.exec import gpu_join as GJ

    real = GJ.GpuShuffledHashJoinExec._phase2

    def guarded(self):
        phase2 = real(self)

        def run(build, probe, build_order, lower, counts, out_cap):
            if out_cap > 256:
                raise torch.cuda.OutOfMemoryError("CUDA out of memory: pairs too many")
            return phase2(build, probe, build_order, lower, counts, out_cap)

        return run

    monkeypatch.setattr(GJ.GpuShuffledHashJoinExec, "_phase2", guarded)
    rng = np.random.default_rng(9)
    left = pa.table({"k": rng.integers(0, 60, 800).astype(np.int64),
                     "a": np.arange(800, dtype=np.int64)})
    right = pa.table({"k": rng.integers(20, 80, 200).astype(np.int64),
                      "b": np.arange(200, dtype=np.int64)})
    conf = {"spark.sql.autoBroadcastJoinThreshold": -1, "spark.sql.shuffle.partitions": 2,
            "spark.rapids.tpu.retry.oom.minSplitRows": 2}

    def q(s):
        return _normalize(
            s.create_dataframe(left, num_partitions=2)
            .join(s.create_dataframe(right), on="k", how=how).collect(), True)

    assert q(TorchSession(conf, device="cpu")) == q(cpu_session(conf))
    assert R.report()["splits"] > 0


# ── shuffle: heartbeat liveness and eviction (tests/test_resilience.py) ─────

import threading  # noqa: E402
import time  # noqa: E402

from spark_rapids_tpu_torch.shuffle import meta as SM  # noqa: E402
from spark_rapids_tpu_torch.shuffle.catalog import ShuffleReceivedBufferCatalog  # noqa: E402
from spark_rapids_tpu_torch.shuffle.client import ShuffleClient, ShuffleFetchError  # noqa: E402
from spark_rapids_tpu_torch.shuffle.heartbeat import (  # noqa: E402
    HeartbeatEndpoint,
    ShuffleHeartbeatManager,
)
from spark_rapids_tpu_torch.shuffle.transport import (  # noqa: E402
    REQ_METADATA,
    FetchCancelled,
    InflightThrottle,
    TransactionStatus,
    new_transaction,
)


def _manager_with_clock():
    clock = {"t": 0.0}
    return ShuffleHeartbeatManager(now_fn=lambda: clock["t"]), clock


def test_heartbeat_records_last_beat_and_evicts_stale():
    mgr, clock = _manager_with_clock()
    mgr.register_executor("e0", ("h", 1))
    mgr.register_executor("e1", ("h", 2))
    assert mgr.last_heartbeat("e0") == 0.0
    clock["t"] = 100.0
    mgr.executor_heartbeat("e1")
    assert mgr.evict_stale(30.0) == ["e0"]
    assert [e.executor_id for e in mgr.all_executors()] == ["e1"]
    # an evicted peer is gone from later deltas until it re-registers
    assert mgr.executor_heartbeat("e1") == []
    assert R.report()["peers_evicted"] == 1


def test_evicted_peer_reappears_only_on_reregistration():
    mgr, clock = _manager_with_clock()
    mgr.register_executor("e0", ("h", 1))
    mgr.register_executor("e1", ("h", 2))
    clock["t"] = 50.0
    mgr.executor_heartbeat("e1")
    mgr.evict_stale(10.0)
    mgr.register_executor("e0", ("h", 9))  # restart with a new address
    delta = mgr.executor_heartbeat("e1")
    assert [p.executor_id for p in delta] == ["e0"] and delta[0].address == ("h", 9)


def test_endpoint_sweeps_stale_peers_on_heartbeat():
    """heartbeatMaxAgeSeconds: the endpoint's heartbeat evicts quiet
    executors and drops them from its peer table."""
    mgr, clock = _manager_with_clock()
    mgr.register_executor("dead", ("h", 1))
    ep = HeartbeatEndpoint("live", mgr, ("h", 2), max_age_s=10.0)
    assert ep.peer("dead") is not None
    clock["t"] = 60.0
    ep.heartbeat()
    assert ep.peer("dead") is None
    assert [e.executor_id for e in mgr.all_executors()] == ["live"]


def test_registry_stays_bounded_across_evictions():
    mgr, clock = _manager_with_clock()
    for i in range(50):
        clock["t"] = float(i)
        mgr.register_executor(f"e{i}", ("h", i))
        assert all(int(e[1:]) < i - 5 for e in mgr.evict_stale(5.0))
    assert len(mgr._entries) <= 7  # compacted, not grown without bound


def test_watchdog_runs_periodic_evict_stale():
    """The watchdog thread sweeps every shuffle heartbeat registry on the
    jittered ``evictStalePeriod`` (the JAX ``test_survivability.py`` case):
    a dead peer vanishes without any heartbeat call, counted on
    ``shuffle.evictedStale``."""
    s = TorchSession({"spark.rapids.tpu.watchdog.evictStalePeriod": 0.05,
                      "spark.rapids.tpu.shuffle.heartbeatMaxAgeSeconds": 0.15}, device="cpu")
    mgr = ShuffleHeartbeatManager()
    mgr.register_executor("doomed-peer", ("127.0.0.1", 1))
    before = _counter("shuffle.evictedStale")
    assert s.range(0, 10).count() == 10  # an admission starts the watchdog
    deadline = time.monotonic() + 20.0
    while mgr.all_executors() or _counter("shuffle.evictedStale") <= before:
        assert time.monotonic() < deadline, "stale peer not evicted by the watchdog sweep"
        time.sleep(0.05)


# ── shuffle client: retry, backoff, blacklist, cancellation ─────────────────


class _MetaOnlyConnection:
    """Metadata succeeds; transfers are accepted but frames never arrive."""

    peer_executor_id = "deadpeer"

    def request(self, req_type, payload):
        tx = new_transaction()
        if req_type == REQ_METADATA:
            tm = SM.TableMeta(1, 0, 0, 0, 10, SM.BufferMeta(11, 4096, 4096, SM.CODEC_NONE), b"")
            tx.complete(TransactionStatus.SUCCESS, SM.pack_metadata_response([tm]))
        else:
            tx.complete(TransactionStatus.SUCCESS, SM.TransferResponse((0,)).pack())
        return tx

    def set_frame_handler(self, h):
        pass


class _FlakyMetadataConnection(_MetaOnlyConnection):
    """The first metadata request errors (a transient transport fault)."""

    peer_executor_id = "flaky"

    def __init__(self):
        self.calls = 0

    def request(self, req_type, payload):
        if req_type == REQ_METADATA:
            self.calls += 1
            if self.calls == 1:
                tx = new_transaction()
                tx.complete(TransactionStatus.ERROR, error="connection reset")
                return tx
        return super().request(req_type, payload)


def test_timed_out_fetch_leaves_no_live_threads():
    before = set(threading.enumerate())
    client = ShuffleClient(_MetaOnlyConnection(), ShuffleReceivedBufferCatalog(),
                           throttle=InflightThrottle(1 << 20), fetch_timeout_s=0.3)
    with pytest.raises(ShuffleFetchError):
        list(client.fetch_blocks([SM.BlockId(1, 0, 0, 1)]))
    deadline = time.monotonic() + 2.0
    while time.monotonic() < deadline:
        leaked = [t for t in threading.enumerate() if t not in before and t.is_alive()]
        if not leaked:
            break
        time.sleep(0.05)
    assert not leaked, f"fetch leaked threads: {leaked}"


def test_metadata_retry_with_backoff():
    conn = _FlakyMetadataConnection()
    client = ShuffleClient(conn, ShuffleReceivedBufferCatalog(), throttle=InflightThrottle(1 << 20),
                           fetch_timeout_s=0.3, max_retries=2, backoff_ms=5)
    # metadata retried past the transient error; the frame-less transfer
    # then times out after its own retry budget
    with pytest.raises(ShuffleFetchError, match="timed out"):
        list(client.fetch_blocks([SM.BlockId(1, 0, 0, 1)]))
    assert conn.calls == 2
    assert R.report()["fetch_retries"] >= 1


def test_fetch_failure_callback_drives_blacklist():
    from spark_rapids_tpu_torch.shuffle.local import InProcessRegistry, InProcessTransport
    from spark_rapids_tpu_torch.shuffle.manager import ShuffleEnv

    env = ShuffleEnv("execL", InProcessTransport("execL", InProcessRegistry()), BufferCatalog(),
                     ShuffleHeartbeatManager(), blacklist_after=2)
    env._on_fetch_result("peerZ", False)
    assert not env.blacklisted("peerZ")
    env._on_fetch_result("peerZ", False)
    assert env.blacklisted("peerZ")
    with pytest.raises(ShuffleFetchError, match="blacklisted"):
        env.client_to("peerZ")
    assert R.report()["peers_evicted"] == 1
    # success resets the count
    env._on_fetch_result("peerY", False)
    env._on_fetch_result("peerY", True)
    env._on_fetch_result("peerY", False)
    assert not env.blacklisted("peerY")


def test_throttle_acquire_cancellable():
    th = InflightThrottle(100)
    th.acquire(100)
    cancel = threading.Event()
    errs = []

    def waiter():
        try:
            th.acquire(50, timeout=30.0, cancel=cancel)
        except FetchCancelled as e:
            errs.append(e)

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.1)
    cancel.set()
    th.kick()
    t.join(timeout=2.0)
    assert not t.is_alive() and len(errs) == 1
    th.release(100)
    th.acquire(100, timeout=1.0)  # the cancelled waiter left no residue
    th.release(100)


def test_tcp_handshake_timeout_conf_driven():
    import socket

    from spark_rapids_tpu_torch import config as cfg
    from spark_rapids_tpu_torch.config import TpuConf
    from spark_rapids_tpu_torch.shuffle.tcp import TcpTransport

    assert cfg.SHUFFLE_HANDSHAKE_TIMEOUT_S.get(TpuConf({})) == 10.0
    conf = TpuConf({"spark.rapids.tpu.shuffle.handshakeTimeout": "0.25"})
    t = TcpTransport("hs", handshake_timeout_s=cfg.SHUFFLE_HANDSHAKE_TIMEOUT_S.get(conf))
    try:
        assert t.handshake_timeout_s == 0.25
        # a dialer that never sends HELLO is dropped after the deadline, and
        # the listener stays healthy for real peers
        bad = socket.create_connection(t.address)
        time.sleep(0.6)
        t.register_address()
        t2 = TcpTransport("hs2")
        tx = t2.connect("hs").request(REQ_METADATA, b"")  # no handler -> error reply
        tx.wait(5.0)
        assert tx.status == TransactionStatus.ERROR
        bad.close()
        t2.shutdown()
    finally:
        t.shutdown()


# ── shuffle: attempts, lost map output, dropped frames (test_recovery.py,
#    test_chaos.py, test_chaos_recovery.py, test_task_retry.py) ─────────────


def _local_shuffle_manager():
    from spark_rapids_tpu_torch.shuffle.local import InProcessRegistry, InProcessTransport
    from spark_rapids_tpu_torch.shuffle.manager import MapOutputRegistry, ShuffleEnv, TpuShuffleManager

    env = ShuffleEnv("recov", InProcessTransport("recov", InProcessRegistry()), BufferCatalog(),
                     ShuffleHeartbeatManager())
    return TpuShuffleManager(env, MapOutputRegistry())


def test_shuffle_writer_commit_is_attempt_striped():
    from spark_rapids_tpu_torch.shuffle.manager import ATTEMPT_STRIDE

    mgr = _local_shuffle_manager()
    w0 = mgr.get_writer(shuffle_id=1, map_id=0, num_partitions=2, attempt=0)
    w1 = mgr.get_writer(shuffle_id=1, map_id=0, num_partitions=2, attempt=2)
    assert w0.map_id == 0 and w0.logical_map_id == 0 and w0.attempt == 0
    assert w1.map_id == 2 * ATTEMPT_STRIDE and w1.logical_map_id == 0 and w1.attempt == 2
    for w in (w0, w1):
        w.write(0, _batch(3))
        assert w.commit().logical_map_id == 0
    # replacement: ONE registered output per logical map id
    outs = mgr.registry.outputs_for(1)
    assert len(outs) == 1 and outs[0].attempt == 2


def test_shuffle_writer_abort_removes_partial_output():
    mgr = _local_shuffle_manager()
    w = mgr.get_writer(shuffle_id=9, map_id=1, num_partitions=2, attempt=0)
    w.write(0, _batch(2))
    assert mgr.env.catalog.stats()["cached_batches"] > 0
    w.abort()
    assert mgr.env.catalog.stats()["cached_batches"] == 0
    assert not mgr.registry.outputs_for(9)


def _shuffle_agg_query(F, session, n=4000, parts=2):
    rng = np.random.default_rng(5)
    t = pa.table({"k": (np.arange(n) % 9).astype(np.int64),
                  "v": rng.integers(0, 100, n).astype(np.int64)})
    return _normalize(
        session.create_dataframe(t, num_partitions=parts).group_by("k")
        .agg(F.sum(F.col("v")).alias("s"), F.count(F.col("v")).alias("c")).collect(),
        True,
    )


_MANAGED = {"spark.sql.shuffle.partitions": 2, "spark.rapids.shuffle.manager.enabled": True}


def test_lost_map_output_recomputed_from_lineage(monkeypatch):
    """A lost map output mid-read re-runs the map stage from lineage under a
    new generation: the JAX CPU engine's rows, the recovery counted, no
    whole-query restart."""
    from spark_rapids_tpu import functions as JF
    from spark_rapids_tpu_torch import functions as PF

    fired = []

    def lose_once():
        if not fired:
            fired.append(1)
            return True
        return False

    monkeypatch.setattr(faults, "lose_map_output", lose_once)
    s = TorchSession({**_MANAGED, "spark.task.maxFailures": 4,
                      "spark.rapids.sql.test.enabled": True}, device="cpu")
    recomputed0, reattempts0 = _counter("shuffle.recomputedPartitions"), _counter("task.reattempts")
    got = _shuffle_agg_query(PF, s)
    assert got == _shuffle_agg_query(JF, cpu_session({"spark.sql.shuffle.partitions": 2}))
    assert fired, "loss injection never fired — the test is inert"
    assert _counter("shuffle.recomputedPartitions") > recomputed0
    assert _counter("task.reattempts") > reattempts0


def test_map_output_loss_exhausts_recompute_budget(monkeypatch):
    """With recomputation off the loss surfaces instead of silently
    returning empty partitions (the zero-row-read guard)."""
    from spark_rapids_tpu_torch import functions as PF
    from spark_rapids_tpu_torch.shuffle.manager import MapOutputLostError

    monkeypatch.setattr(faults, "lose_map_output", lambda: True)
    s = TorchSession({**_MANAGED, "spark.rapids.tpu.recovery.recomputeMapOutputs": False,
                      "spark.task.maxFailures": 1}, device="cpu")
    with pytest.raises(MapOutputLostError):
        _shuffle_agg_query(PF, s)


def test_device_fault_and_peer_loss_storm_bit_identical_vs_cpu_oracle(monkeypatch):
    """Injected device OOMs on every 3rd recoverable launch AND a lost map
    output (twice): one plan execution absorbs every fault — losses
    recompute from lineage, OOMs spill-retry, failed attempts re-run — and
    the rows equal the JAX CPU engine's."""
    from spark_rapids_tpu import functions as JF
    from spark_rapids_tpu_torch import functions as PF

    losses = []

    def lose_twice() -> bool:
        if len(losses) < 2:
            losses.append(1)
            return True
        return False

    monkeypatch.setattr(faults, "lose_map_output", lose_twice)
    s = TorchSession({"spark.sql.shuffle.partitions": 4, "spark.rapids.shuffle.manager.enabled": True,
                      "spark.task.maxFailures": 8, "spark.rapids.tpu.recovery.maxMapRecomputes": 8,
                      "spark.rapids.tpu.faults.enabled": True,
                      "spark.rapids.tpu.faults.deviceOomEveryN": 3}, device="cpu")
    runs = {"n": 0}
    orig = s._run_plan

    def count_runs(final_plan, ctx):
        runs["n"] += 1
        return orig(final_plan, ctx)

    s._run_plan = count_runs
    recomputed0, reattempts0 = _counter("shuffle.recomputedPartitions"), _counter("task.reattempts")
    got = _shuffle_agg_query(PF, s, n=6000, parts=3)
    assert got == _shuffle_agg_query(JF, cpu_session({}), n=6000, parts=3)
    assert runs["n"] == 1
    rep = R.report()
    assert rep["faults_injected"] > 0 and rep["oom_retries"] > 0, "the storm never fired"
    assert losses and _counter("shuffle.recomputedPartitions") > recomputed0
    assert _counter("task.reattempts") > reattempts0


def test_shuffle_fetch_survives_dropped_data_frames():
    """Every 2nd outgoing DATA frame on the TCP transport vanishes; the
    per-fetch retry (timeout → backoff → re-request of the missing blocks)
    delivers every row exactly once."""
    from spark_rapids_tpu_torch.shuffle.manager import MapOutputRegistry, ShuffleEnv, TpuShuffleManager
    from spark_rapids_tpu_torch.shuffle.tcp import TcpTransport

    hb, outputs = ShuffleHeartbeatManager(), MapOutputRegistry()
    ta, tb = TcpTransport("chA"), TcpTransport("chB")
    ta.register_address()
    tb.register_address()
    try:
        kw = dict(fetch_timeout_s=1.0, fetch_max_retries=5, fetch_backoff_ms=10)
        env_a = ShuffleEnv("chA", ta, BufferCatalog(), hb, address=ta.address, **kw)
        env_b = ShuffleEnv("chB", tb, BufferCatalog(), hb, address=tb.address, **kw)
        mgr_a, mgr_b = TpuShuffleManager(env_a, outputs), TpuShuffleManager(env_b, outputs)
        batches = [_batch(200, seed=i) for i in range(3)]
        want = sorted(_rows(b) for b in batches)
        w = mgr_a.get_writer(shuffle_id=31, map_id=0, num_partitions=3)
        for p, b in enumerate(batches):
            w.write(p, b)
        w.commit()
        with faults.scoped(FaultConfig(tcp_drop_every_n=2)):
            got = list(mgr_b.get_reader().read_partitions(31, 0, 3))
        assert sorted(_rows(g) for g in got) == want
        assert R.report()["fetch_retries"] > 0, "no retry fired — inert test"
        assert env_b.throttle.inflight == 0
    finally:
        ta.shutdown()
        tb.shutdown()


def test_managed_shuffle_thunk_rerunnable_after_release():
    """The managed exchange's partition thunks stay re-runnable after the
    map output was freed: a re-run re-executes the map stage from lineage
    under a fresh shuffle id instead of reading zero rows."""
    s = TorchSession({"spark.rapids.shuffle.manager.enabled": True,
                      "spark.sql.adaptive.enabled": False}, device="cpu")
    t = {"k": np.arange(100, dtype=np.int64), "v": np.arange(100, dtype=np.float64)}
    df = s.create_dataframe(t, num_partitions=2).repartition(4, "k")
    assert len(df.collect()) == 100
    parts = s._last_plan.execute(ExecContext(s.conf, s))
    assert sum(hb.num_rows for th in parts.parts for hb in th()) == 100
    # every thunk again, after all were drained and the shuffle released
    assert sum(hb.num_rows for th in parts.parts for hb in th()) == 100

