"""The port's multi-tenant scheduler on the CPU (``sched/``): admission
through the weighted permit pool, fair-share pools, the bounded queue,
cancellation, deadlines, the working-set estimate, and concurrent queries
bit-identical to their serial runs.

Ported from the JAX package's ``tests/test_scheduler.py``, its df.cache()
single-flight cases included. The port's ``WeightedPermitPool`` is
held against the JAX package's under one scripted sequence of requests:
the same admission order. A query that must stay running long enough to
be cancelled runs under the kernel-stall fault point (each device launch
sleeps 20 ms), so no test depends on the machine's speed; every wait is
bounded.
"""
from __future__ import annotations

import threading
import time

import numpy as np
import pytest

pytest.importorskip("jax")  # the reference; absent on a machine with only the port

import torch  # noqa: E402

from spark_rapids_tpu.sched import WeightedPermitPool as JaxPool  # noqa: E402
from spark_rapids_tpu.sched import parse_pool_spec as jax_parse  # noqa: E402
from spark_rapids_tpu_torch import TorchSession  # noqa: E402
from spark_rapids_tpu_torch.functions import col, lit  # noqa: E402
from spark_rapids_tpu_torch.functions import sum as sum_  # noqa: E402
from spark_rapids_tpu_torch.obs.export import prometheus_text  # noqa: E402
from spark_rapids_tpu_torch.obs.metrics import GLOBAL  # noqa: E402
from spark_rapids_tpu_torch.sched import (  # noqa: E402
    CancelToken,
    QueryCancelledError,
    QueryQueueFull,
    QueryTimeoutError,
    WeightedPermitPool,
    estimate_plan_bytes,
    parse_pool_spec,
)

torch.set_num_threads(1)

#: every device launch sleeps 20 ms: a query of many batches stays running
SLOW = {
    "spark.rapids.tpu.faults.enabled": True,
    "spark.rapids.tpu.faults.kernelStallEveryN": 1,
    "spark.rapids.tpu.faults.kernelStallMs": 20.0,
    "spark.rapids.sql.batchSizeBytes": 800,
}


def _slow_df(s, rows: int = 20_000):
    """100 rows per upload chunk: ``rows / 100`` batches, each through a
    project whose launch sleeps."""
    return s.create_dataframe({"id": np.arange(rows, dtype=np.int64)}).select(
        (col("id") + lit(1)).alias("x")
    )


def _poll(pred, timeout_s: float = 10.0, what: str = "condition"):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.005)
    raise AssertionError(f"timed out waiting for {what}")


def _session(conf=None) -> TorchSession:
    return TorchSession(conf or {}, device="cpu")


# ── concurrent correctness ─────────────────────────────────────────────────


def test_concurrent_queries_bit_identical_with_metrics():
    """4 threads run mixed TPC-H queries on ONE session; every result is
    bit-identical to the same session's serial run, and the admission
    counter and queue-wait histogram appear in the Prometheus export. The
    pool is held full while the clients arrive, so each of their first
    admissions queues and observes its wait."""
    from spark_rapids_tpu_torch.tpch.datagen import TABLES, gen_table
    from spark_rapids_tpu_torch.tpch.queries import tpch_query

    tables = {n: gen_table(n, 0.002) for n in TABLES}
    s = _session({"spark.sql.shuffle.partitions": 2})
    qs = (1, 3, 5, 6, 18)

    def run(n):
        return tpch_query(n, lambda t: s.create_dataframe(tables[t], num_partitions=2)).collect()

    serial = {n: run(n) for n in qs}
    admitted = GLOBAL.counter("scheduler.admitted").value
    waits = GLOBAL.histogram("scheduler.queueWaitHist").state()[2]
    got: dict = {}
    errs: list = []

    def client(i):
        try:
            for n in qs[i % len(qs):] + qs[: i % len(qs)]:
                got.setdefault(i, {})[n] = run(n)
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    pool = s.scheduler.pool
    held = pool.acquire(pool.permits)
    threads = [threading.Thread(target=client, args=(i,), daemon=True) for i in range(4)]
    try:
        for t in threads:
            t.start()
        deadline = time.monotonic() + 30
        while pool.queued < 4 and time.monotonic() < deadline and not errs:
            time.sleep(0.005)
        assert pool.queued == 4, pool.queued
    finally:
        pool.release(held)
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errs, errs
    for i in range(4):
        for n in qs:
            assert got[i][n] == serial[n], f"client {i} q{n}"
    assert GLOBAL.counter("scheduler.admitted").value - admitted >= 4 * len(qs)
    assert GLOBAL.histogram("scheduler.queueWaitHist").state()[2] - waits >= 4
    text = prometheus_text(session=s)
    assert "spark_rapids_tpu_scheduler_admitted " in text
    assert "spark_rapids_tpu_scheduler_queue_wait_hist_count " in text
    assert s.scheduler.pool.in_use == 0


# ── cancellation ───────────────────────────────────────────────────────────


def test_cancel_releases_permits_and_session_stays_usable():
    s = _session(SLOW)
    raised: list = []

    def run():
        try:
            _slow_df(s).collect()
            raised.append(None)
        except QueryCancelledError as e:
            raised.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    _poll(lambda: any(a["granted"] for a in s.active_queries().values()), what="admission")
    active = [q for q, a in s.active_queries().items() if a["granted"]]
    assert s.cancel(active[0], reason="test cancel")
    t.join(timeout=20)
    assert not t.is_alive()
    assert isinstance(raised[0], QueryCancelledError)
    assert s.scheduler.pool.in_use == 0
    assert s.active_queries() == {}
    ok = _session()
    assert ok.create_dataframe({"a": np.arange(3, dtype=np.int64)}).collect() == [(0,), (1,), (2,)]
    assert s.create_dataframe({"a": np.arange(2, dtype=np.int64)}).collect() == [(0,), (1,)]


def test_cancel_all_flags_every_active_query():
    s = _session(SLOW)
    outcomes: list = []

    def run():
        try:
            _slow_df(s).collect()
            outcomes.append("finished")
        except QueryCancelledError:
            outcomes.append("cancelled")

    threads = [threading.Thread(target=run, daemon=True) for _ in range(3)]
    for t in threads:
        t.start()
    _poll(lambda: len(s.active_queries()) == 3, what="3 active queries")
    assert s.cancel_all(reason="shutdown") == 3
    for t in threads:
        t.join(timeout=20)
    assert outcomes.count("cancelled") == 3
    assert s.scheduler.pool.in_use == 0


def test_cancel_unknown_query_is_false():
    assert _session().cancel("q999") is False


def test_query_timeout_typed_error():
    s = _session({**SLOW, "spark.rapids.tpu.scheduler.queryTimeout": 0.3})
    t0 = time.monotonic()
    with pytest.raises(QueryTimeoutError):
        _slow_df(s).collect()
    assert time.monotonic() - t0 < 10
    assert s.scheduler.pool.in_use == 0
    assert GLOBAL.counter("scheduler.timeouts").value >= 1


def test_cancel_token_deadline_semantics():
    tok = CancelToken("q1", timeout_s=0.05)
    tok.check()
    time.sleep(0.08)
    assert tok.expired and tok.cancelled
    with pytest.raises(QueryTimeoutError):
        tok.check()
    tok2 = CancelToken("q2")
    assert tok2.remaining_s() is None
    tok2.cancel("because")
    with pytest.raises(QueryCancelledError, match="because"):
        tok2.check()


def test_scheduler_disabled_still_cancellable():
    s = _session({**SLOW, "spark.rapids.tpu.scheduler.enabled": False})
    admitted = GLOBAL.counter("scheduler.admitted").value
    raised: list = []

    def run():
        try:
            _slow_df(s).collect()
        except QueryCancelledError as e:
            raised.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    _poll(lambda: len(s.active_queries()) == 1, what="registration")
    (qid,) = s.active_queries()
    assert s.active_queries()[qid]["running"]
    assert s.cancel(qid)
    t.join(timeout=20)
    assert raised and GLOBAL.counter("scheduler.admitted").value == admitted


# ── the permit pool ────────────────────────────────────────────────────────


def test_queue_full_typed_rejection():
    pool = WeightedPermitPool(permits=1, max_queued=0)
    pool.acquire(1, "default")
    try:
        with pytest.raises(QueryQueueFull):
            pool.acquire(1, "default")
    finally:
        pool.release(1, "default")
    assert pool.acquire(1, "default") == 1
    pool.release(1, "default")


def test_session_queue_full_rejects_and_recovers():
    s = _session({**SLOW, "spark.rapids.tpu.scheduler.permits": 1,
                  "spark.rapids.tpu.scheduler.maxQueued": 0})
    holder: list = []

    def run():
        try:
            _slow_df(s).collect()
        except QueryCancelledError as e:
            holder.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    try:
        _poll(lambda: any(a["granted"] for a in s.active_queries().values()), what="holder")
        rejected = GLOBAL.counter("scheduler.rejected").value
        with pytest.raises(QueryQueueFull):
            s.create_dataframe({"a": np.arange(3, dtype=np.int64)}).collect()
        assert GLOBAL.counter("scheduler.rejected").value == rejected + 1
    finally:
        s.cancel_all("test over")
        t.join(timeout=20)
    assert not t.is_alive()
    assert s.scheduler.pool.in_use == 0


def test_cancel_while_queued():
    pool = WeightedPermitPool(permits=1, max_queued=4)
    pool.acquire(1, "default")
    tok = CancelToken("queued-query")
    err: list = []

    def waiter():
        try:
            pool.acquire(1, "default", tok)
        except QueryCancelledError as e:
            err.append(e)

    t = threading.Thread(target=waiter, daemon=True)
    t.start()
    _poll(lambda: pool.queued == 1, what="waiter enqueued")
    tok.cancel("no longer needed")
    t.join(timeout=10)
    assert err and pool.queued == 0
    pool.release(1, "default")
    assert pool.in_use == 0


def _scripted_order(pool_cls, parse) -> list:
    """One scripted sequence of requests: saturate, queue 12 waiters across
    three weighted pools in a fixed order (each enqueued before the next
    starts), release, and record the grant order. Every request needs 2 or
    3 of the 3 permits, so no two are ever granted together: each grant
    waits for the previous holder's release, after its append, and the
    recorded order is the dispatcher's."""
    pool = pool_cls(permits=3, max_queued=100)
    pool.configure(pools=parse("heavy:3,light:1,mid:2"))
    pool.acquire(3, "warmup")
    order: list = []
    lock = threading.Lock()
    script = [("heavy", 2), ("light", 3), ("mid", 2), ("heavy", 3), ("light", 2), ("mid", 3),
              ("heavy", 2), ("heavy", 2), ("light", 2), ("mid", 2), ("light", 3), ("heavy", 3)]

    def client(i, name, need):
        got = pool.acquire(need, name)
        with lock:
            order.append(i)
        pool.release(got, name)

    threads = []
    for i, (name, need) in enumerate(script):
        th = threading.Thread(target=client, args=(i, name, need), daemon=True)
        th.start()
        _poll(lambda n=i: pool.queued == n + 1, what=f"waiter {i} queued")
        threads.append(th)
    pool.release(3, "warmup")
    for th in threads:
        th.join(timeout=10)
    assert pool.in_use == 0 and pool.queued == 0
    return order


def test_admission_order_matches_jax_pool():
    port = _scripted_order(WeightedPermitPool, parse_pool_spec)
    jax = _scripted_order(JaxPool, jax_parse)
    assert sorted(port) == list(range(12))
    assert port == jax


def test_weighted_pools_proportional_admissions():
    pool = WeightedPermitPool(permits=2, max_queued=100)
    pool.configure(pools=parse_pool_spec("heavy:3,light:1"))
    pool.acquire(2, "warmup")
    order: list = []
    order_lock = threading.Lock()

    def client(name: str) -> None:
        pool.acquire(2, name)
        with order_lock:
            order.append(name)
        pool.release(2, name)

    threads = []
    for name in ("heavy", "light"):
        for _ in range(16):
            th = threading.Thread(target=client, args=(name,), daemon=True)
            th.start()
            threads.append(th)
    _poll(lambda: pool.queued == 32, what="all waiters queued")
    pool.release(2, "warmup")
    for th in threads:
        th.join(timeout=30)
    window = order[:20]
    heavy = window.count("heavy")
    assert 13 <= heavy <= 17, f"heavy={heavy} of 20 (want ~15:5)"
    assert pool.in_use == 0 and pool.queued == 0


def test_live_permit_shrink_reclamps_queued_waiter():
    pool = WeightedPermitPool(permits=8, max_queued=4)
    pool.acquire(8, "a")
    got: list = []

    def waiter():
        n = pool.acquire(8, "b")
        got.append(n)
        pool.release(n, "b")

    t = threading.Thread(target=waiter, daemon=True)
    t.start()
    _poll(lambda: pool.queued == 1, what="waiter queued")
    pool.configure(permits=4)
    pool.release(8, "a")
    t.join(timeout=10)
    assert got == [4], got
    assert pool.in_use == 0 and pool.queued == 0


def test_oom_pressure_halves_effective_permits():
    from spark_rapids_tpu_torch.resilience import retry as R

    pool = WeightedPermitPool(permits=8, max_queued=4)
    assert pool.effective_permits() == 8
    R._note_oom(None)
    try:
        assert pool.effective_permits() == 4
        assert WeightedPermitPool(permits=1, max_queued=4).effective_permits() == 1
    finally:
        R.reset()
    assert pool.effective_permits() == 8


def test_oversized_request_clamps_to_pool_size():
    pool = WeightedPermitPool(permits=4, max_queued=4)
    got = pool.acquire(100, "big")
    assert got == 4
    pool.release(got, "big")
    assert pool.in_use == 0


def test_try_acquire_never_queues():
    pool = WeightedPermitPool(permits=2, max_queued=4)
    assert pool.try_acquire(1) == 1
    assert pool.try_acquire(2) == 0
    assert pool.queued == 0
    pool.release(1)


# ── footprint estimation ───────────────────────────────────────────────────


def test_estimate_scales_with_input_width_and_strings():
    s = _session()
    small = {"a": np.arange(100, dtype=np.int64)}
    big = {f"c{i}": np.arange(5000, dtype=np.int64) for i in range(8)}

    def plan_of(df):
        return s._prepare_plan(df._plan)

    e_small = estimate_plan_bytes(plan_of(s.create_dataframe(small).select("a")))
    e_big = estimate_plan_bytes(plan_of(s.create_dataframe(big).select(*[f"c{i}" for i in range(8)])))
    assert 0 < e_small < e_big
    e_join = estimate_plan_bytes(plan_of(s.create_dataframe(big).join(s.create_dataframe(big), on="c0")))
    assert e_join > e_big
    # strings count at their padded [n, W] plane: wider values, more bytes
    narrow = {"s": ["ab"] * 1000}
    wide = {"s": ["x" * 200] * 1000}
    e_narrow = estimate_plan_bytes(plan_of(s.create_dataframe(narrow).select("s")))
    e_wide = estimate_plan_bytes(plan_of(s.create_dataframe(wide).select("s")))
    assert e_wide > e_narrow


def test_estimate_default_and_permits():
    from spark_rapids_tpu_torch.sched.estimate import permits_for_plan

    s = _session({"spark.rapids.tpu.scheduler.bytesPerPermit": "1mb"})
    plan = s._prepare_plan(s.create_dataframe({"a": np.arange(200_000, dtype=np.int64)}).select("a")._plan)
    n = permits_for_plan(plan, s.conf, pool_size=8)
    assert 2 <= n <= 8


def test_scheduler_confs_reread_per_query():
    s = _session()
    df = s.create_dataframe({"a": np.arange(10, dtype=np.int64)})
    df.collect()
    assert s.scheduler.pool.permits == 8
    s.conf = s.conf.set("spark.rapids.tpu.scheduler.permits", 3)
    df.collect()
    assert s.scheduler.pool.permits == 3


def test_queued_span_recorded_in_trace():
    """A query that waits for admission records a ``queued`` span (cat
    ``sched``) in its trace."""
    s = _session({**SLOW, "spark.rapids.tpu.scheduler.permits": 1,
                  "spark.rapids.tpu.trace.enabled": True})
    tracers: list = []
    export = s._export_trace

    def keep(tracer, *a, **k):
        tracers.append(tracer)
        return export(tracer, *a, **k)

    s._export_trace = keep
    t = threading.Thread(target=lambda: _slow_df(s, 2_000).collect(), daemon=True)
    t.start()
    _poll(lambda: any(a["granted"] for a in s.active_queries().values()), what="holder")
    s.create_dataframe({"a": np.arange(3, dtype=np.int64)}).collect()
    t.join(timeout=20)
    assert not t.is_alive()
    assert len(tracers) == 2
    queued = [sp for tr in tracers for sp in tr.spans() if sp.name == "queued"]
    assert queued and all(sp.cat == "sched" for sp in queued)


def test_to_torch_exports_the_device_result():
    s = _session()
    df = s.create_dataframe({"a": np.arange(100, dtype=np.int64)}, num_partitions=3).filter(
        col("a") % lit(2) == lit(0)
    ).group_by().agg(sum_(col("a")).alias("s"))
    b = df.to_torch()
    assert b.row_count() == 1
    assert int(b.columns[0].data[0]) == sum(range(0, 100, 2))
    assert s.scheduler.pool.in_use == 0
    from torch.utils.dlpack import from_dlpack, to_dlpack

    assert int(from_dlpack(to_dlpack(b.columns[0].data))[0]) == 2450


def test_oom_pressure_shrinks_a_large_admission_instead_of_waiting():
    """While the OOM pressure halves the limit, a query that needs the
    whole pool is granted the halved share at once on an idle device (the
    JAX pool makes it wait out the pressure window)."""
    from spark_rapids_tpu_torch.resilience import retry as R

    pool = WeightedPermitPool(permits=8, max_queued=4)
    R._note_oom(None)
    try:
        out: list = []
        t = threading.Thread(target=lambda: out.append(pool.acquire(8)), daemon=True)
        t.start()
        t.join(timeout=5)
        assert out == [4], out
        pool.release(4)
    finally:
        R.reset()
    assert pool.acquire(8) == 8
    pool.release(8)


def test_cache_cold_hit_single_flight():
    """Two threads racing the same cold cache key execute the subtree
    exactly once; both read identical results."""
    pytest.importorskip("pandas")
    s = TorchSession({}, device="cpu")
    runs = [0]
    runs_lock = threading.Lock()

    def fn(it):
        with runs_lock:
            runs[0] += 1
        for pdf in it:
            time.sleep(0.05)  # widen the race window
            yield pdf

    cached = s.create_dataframe({"a": np.arange(50)}).map_in_pandas(fn, "a long").cache()
    results: list = [None, None]

    def client(i: int) -> None:
        results[i] = sorted(cached.collect())

    th = [threading.Thread(target=client, args=(i,)) for i in range(2)]
    for x in th:
        x.start()
    for x in th:
        x.join(timeout=60)
    assert results[0] == results[1] == [(i,) for i in range(50)]
    assert runs[0] == 1, f"cached subtree executed {runs[0]} times"


def test_cache_failed_materialization_retries():
    """A failed materialization clears its entry: the next touch runs the
    subtree again and succeeds."""
    pytest.importorskip("pandas")
    s = TorchSession({}, device="cpu")
    failing = [True]  # persists across task-retry attempts (lineage re-run)

    def fn(it):
        if failing[0]:
            raise ValueError("flaky source")
        yield from it

    cached = s.create_dataframe({"a": np.array([1, 2, 3])}).map_in_pandas(fn, "a long").cache()
    with pytest.raises(Exception, match="flaky source"):
        cached.collect()
    assert not s._cache_store
    failing[0] = False
    assert sorted(cached.collect()) == [(1,), (2,), (3,)]
