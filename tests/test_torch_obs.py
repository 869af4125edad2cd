"""The port's observability layer on the CPU (``obs/`` and
``profiling.py``): the span trace, the phase ledger, the histograms, the
exporters, the live scrape endpoint and the measured cost calibration.

Ported from the JAX package's ``tests/test_obs.py`` and the ledger,
histogram, scrape and calibration cases of ``tests/test_attribution.py``
(its serve and shuffle trace cases wait for those slices). The port is
held against the JAX package where the JAX side needs no XLA compile: the
same ledger phase names, and the same Chrome-trace and Prometheus shapes
(the JAX side's from its CPU engine, which traces without compiling).
The scrape listener binds 127.0.0.1 on an ephemeral port, every request
has a timeout, and every listener stops in a ``finally``.
"""
from __future__ import annotations

import json
import os
import threading
import time
import urllib.request

import numpy as np
import pytest

pytest.importorskip("jax")  # the reference; absent on a machine with only the port

import torch  # noqa: E402

from harness import cpu_session  # noqa: E402
from spark_rapids_tpu.functions import col as jcol  # noqa: E402
from spark_rapids_tpu.functions import sum as jsum  # noqa: E402
from spark_rapids_tpu.obs import export as JE  # noqa: E402
from spark_rapids_tpu.obs import ledger as JL  # noqa: E402
from spark_rapids_tpu_torch import TorchSession  # noqa: E402
from spark_rapids_tpu_torch.functions import col, lit  # noqa: E402
from spark_rapids_tpu_torch.functions import sum as sum_  # noqa: E402
from spark_rapids_tpu_torch.obs import export as OE  # noqa: E402
from spark_rapids_tpu_torch.obs import ledger as OL  # noqa: E402
from spark_rapids_tpu_torch.obs import metrics as OM  # noqa: E402
from spark_rapids_tpu_torch.obs import trace as OT  # noqa: E402

torch.set_num_threads(1)

_DATA = {"a": np.arange(400, dtype=np.int64), "b": np.arange(400, dtype=np.float64)}


def _session(conf=None) -> TorchSession:
    return TorchSession(conf or {}, device="cpu")


def _run_query(s, partitions: int = 2):
    df = (
        s.create_dataframe(_DATA, num_partitions=partitions)
        .filter(col("a") > 10)
        .select(col("a"), (col("b") * lit(2.0)).alias("b"))
        .filter(col("a") < 390)
        .group_by()
        .agg(sum_(col("b")).alias("s"))
    )
    assert df.collect()
    return df


def _get(url: str) -> str:
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.read().decode("utf-8")


# ── metrics and histograms ─────────────────────────────────────────────────


def test_histogram_buckets_sum_and_quantiles():
    h = OM.Histogram("t.hist")
    for v in (1, 2, 3, 100, 1000, 1000):
        h.observe(v)
    counts, total, n = h.state()
    assert n == 6 and total == 2106 and sum(counts) == 6
    assert h.quantile(0.5) <= h.quantile(0.99)


def test_histogram_delta_windows():
    h = OM.Histogram("t.delta")
    h.observe(5)
    before = h.state()
    h.observe(7)
    h.observe(9)
    counts, total, n = OM.histogram_delta(h.state(), before)
    assert n == 2 and total == 16 and sum(counts) == 2


def test_runtime_series_are_in_the_catalog():
    for name, kind in (
        ("scheduler.admitted", OM.MetricKind.COUNTER),
        ("scheduler.queueWaitHist", OM.MetricKind.HISTOGRAM),
        ("pipeline.dispatchHist", OM.MetricKind.HISTOGRAM),
        ("fusion.breakerFallbacks", OM.MetricKind.COUNTER),
        ("speculation.launched", OM.MetricKind.COUNTER),
        ("speculation.won", OM.MetricKind.COUNTER),
        ("watchdog.stalls", OM.MetricKind.COUNTER),
        ("kernel.builds", OM.MetricKind.COUNTER),
        ("trace.droppedSpans", OM.MetricKind.COUNTER),
    ):
        assert name in OM.GLOBAL and OM.GLOBAL[name].kind == kind, name


def test_histogram_prometheus_rendering():
    h = OM.GLOBAL.histogram("scheduler.queueWaitHist")
    h.observe(3)
    text = OE.prometheus_text()
    lines = [ln for ln in text.splitlines() if ln.startswith("spark_rapids_tpu_scheduler_queue_wait_hist")]
    buckets = [ln for ln in lines if "_bucket{" in ln]
    cum = [int(ln.rsplit(" ", 1)[1]) for ln in buckets]
    assert cum == sorted(cum), "bucket counts must be cumulative"
    inf = [ln for ln in buckets if 'le="+Inf"' in ln][0]
    count = [ln for ln in lines if ln.startswith("spark_rapids_tpu_scheduler_queue_wait_hist_count ")][0]
    assert inf.rsplit(" ", 1)[1] == count.rsplit(" ", 1)[1]


# ── the phase ledger ───────────────────────────────────────────────────────


def test_ledger_phase_names_match_jax():
    assert OL.PHASES == JL.PHASES


def test_ledger_nested_scopes_are_exclusive():
    led = OL.PhaseLedger()
    led.wall_start()
    with led.scope("dispatch"):
        with led.scope("h2d"):
            with led.scope("pad"):
                pass
    led.wall_stop()
    snap = led.snapshot()
    assert {"dispatch", "h2d", "pad"} <= set(snap)
    bd = led.breakdown()
    assert bd["parallel_overlap_ms"] == 0.0
    assert abs(sum(bd["phases_ms"].values()) - bd["wall_ms"]) <= 0.01 + 0.05 * bd["wall_ms"]


def test_ledger_timed_iter_bills_each_pull():
    led = OL.PhaseLedger()

    def gen():
        for i in range(3):
            yield i

    assert list(led.timed_iter("dispatch", gen())) == [0, 1, 2]
    assert led.snapshot().get("dispatch", 0) > 0


def test_ledger_module_hooks_are_noops_without_current():
    assert OL.current() is None
    with OL.phase("compile"):
        pass
    assert OL.phase("x") is OL.phase("y")
    assert OL.scope_or_null(None, "x") is OL.scope_or_null(None, "y")


@pytest.mark.parametrize("q", [1, 6])
def test_tpch_ledger_exhaustive_and_ranked(q):
    """The phases of q1 and q6 (one partition, serial: pipeline off, one
    task) sum to the wall within 5%, ranked, from the documented set."""
    from spark_rapids_tpu_torch.tpch.datagen import gen_table
    from spark_rapids_tpu_torch.tpch.queries import tpch_query

    lineitem = gen_table("lineitem", 0.003)
    s = _session({"spark.rapids.tpu.pipeline.enabled": False, "spark.rapids.sql.concurrentGpuTasks": 1})
    assert tpch_query(q, lambda t: s.create_dataframe(lineitem)).collect()
    bd = s._last_ledger.breakdown()
    wall = bd["wall_ms"]
    assert wall > 0
    assert abs(sum(bd["phases_ms"].values()) - wall) <= 0.05 * wall, bd
    assert bd["parallel_overlap_ms"] <= 0.05 * wall, bd
    assert bd["coverage_frac"] >= 0.5, bd
    vals = list(bd["phases_ms"].values())
    assert vals == sorted(vals, reverse=True)
    assert set(bd["phases_ms"]) <= set(OL.PHASES), bd
    assert {"parse_plan", "dispatch", "h2d", "d2h", "serialize"} <= set(bd["phases_ms"]), bd


def test_ledger_in_explain_and_artifact():
    s = _session()
    df = _run_query(s)
    out = df.explain("metrics")
    assert "host-overhead ledger" in out and "wall" in out
    assert "numOutputRows" in out and "HostToDeviceExec" in out and "Stage(3)" in out
    art = OE.query_artifact(plan=s._last_plan, session=s)
    assert art["ledger"]["wall_ms"] > 0
    assert {"operators", "pipeline", "resilience", "process", "breakdown"} <= set(art)


def test_ledger_kill_switch():
    s = _session({"spark.rapids.tpu.ledger.enabled": False})
    _run_query(s)
    assert s._last_ledger is None


def test_recovery_phase_bills_a_reexecuted_task():
    from spark_rapids_tpu_torch.resilience import lineage

    led = OL.PhaseLedger()
    before = OM.GLOBAL.counter("task.reattempts").value
    with lineage.recovery_scope(led):
        time.sleep(0.002)
    assert led.snapshot()["recovery"] >= 2_000_000
    assert OM.GLOBAL.counter("task.reattempts").value == before + 1


# ── spans ──────────────────────────────────────────────────────────────────


def test_span_nesting_and_ring_buffer():
    tr = OT.Tracer(capacity=16)
    with OT.query_scope(tr, "query-t"):
        with OT.span("opA", "operator") as a:
            with OT.span("batch", "batch") as b:
                pass
    spans = {s.sid: s for s in tr.spans()}
    assert spans[b.sid].parent == a.sid
    dropped = OM.GLOBAL.counter("trace.droppedSpans").value
    tr2 = OT.Tracer(capacity=16)
    with OT.query_scope(tr2, "q"):
        for i in range(40):
            with OT.span(f"s{i}"):
                pass
    assert tr2.span_count == 41 and tr2.dropped == 25 and len(list(tr2.spans())) == 16
    assert OM.GLOBAL.counter("trace.droppedSpans").value == dropped + 25
    assert tr2.to_chrome()["otherData"]["dropped_spans"] == 25


def test_trace_hooks_are_noops_when_inactive():
    assert OT.active() is None
    assert OT.span("x") is OT.span("y")
    assert OT.capture_context() is None
    OT.attach_context(None)


def _chain_reaches(by_sid, e, root_sid) -> bool:
    seen = set()
    while True:
        p = e["args"]["parent_id"]
        if p == root_sid:
            return True
        if p is None or p in seen or p not in by_sid:
            return False
        seen.add(p)
        e = by_sid[p]


def test_query_trace_export_nests_query_operator_batch(tmp_path):
    td = str(tmp_path / "traces")
    s = _session({"spark.rapids.tpu.trace.dir": td})
    _run_query(s, partitions=4)
    files = sorted(os.listdir(td))
    trace_files = [f for f in files if f.endswith(".trace.json")]
    art_files = [f for f in files if f.endswith(".metrics.json")]
    assert trace_files and art_files
    doc = json.load(open(os.path.join(td, trace_files[0])))
    events = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    by_sid = {e["args"]["span_id"]: e for e in events}
    roots = [e for e in events if e["cat"] == "query"]
    assert len(roots) == 1 and roots[0]["args"]["parent_id"] is None
    root_sid = roots[0]["args"]["span_id"]
    ops = [e for e in events if e["cat"] == "operator"]
    batches = [e for e in events if e["cat"] == "batch"]
    assert ops and batches
    op_sids = {e["args"]["span_id"] for e in ops}
    assert all(_chain_reaches(by_sid, e, root_sid) for e in ops)
    assert all(e["args"]["parent_id"] in op_sids for e in batches)
    off_thread = [e for e in events if e["tid"] != roots[0]["tid"]]
    assert off_thread, "no span from a pipeline producer or task thread"
    assert all(_chain_reaches(by_sid, e, root_sid) for e in off_thread)
    for e in events:
        assert {"ph", "name", "cat", "ts", "dur", "pid", "tid"} <= set(e)
    art = json.load(open(os.path.join(td, art_files[0])))
    assert {"operators", "pipeline", "resilience", "process", "trace"} <= set(art)
    assert art["trace"]["spans"] > 0


def test_trace_sampling_zero_disables(tmp_path):
    td = str(tmp_path / "traces")
    s = _session({"spark.rapids.tpu.trace.dir": td, "spark.rapids.tpu.trace.sample": 0.0})
    _run_query(s)
    assert s._last_tracer is None
    assert not os.path.exists(td) or not os.listdir(td)


def test_chrome_trace_and_prometheus_shapes_match_jax():
    """The port's Chrome-trace document and Prometheus exposition have
    the JAX package's shapes: the same top-level and event keys and span
    categories, and the same metric family and type for every process
    series both registries hold."""
    s = _session({"spark.rapids.tpu.trace.enabled": True})
    _run_query(s)
    port_doc = s._last_tracer.to_chrome()
    js = cpu_session({"spark.rapids.tpu.trace.enabled": True})
    t = __import__("pyarrow").table({k: list(v) for k, v in _DATA.items()})
    jdf = js.create_dataframe(t, num_partitions=2).filter(jcol("a") > 10).group_by().agg(
        jsum(jcol("b")).alias("s")
    )
    assert jdf.collect()
    jax_doc = js._last_tracer.to_chrome()
    assert set(port_doc) == set(jax_doc)
    assert set(port_doc["otherData"]) == set(jax_doc["otherData"])

    def event_keys(doc):
        return {tuple(sorted(e)) for e in doc["traceEvents"] if e["ph"] == "X"}

    assert event_keys(port_doc) == event_keys(jax_doc)
    cats = lambda doc: {e["cat"] for e in doc["traceEvents"] if e["ph"] == "X"}  # noqa: E731
    assert {"query", "operator", "batch"} <= cats(port_doc) & cats(jax_doc)

    def types(text):
        return {ln.split()[2]: ln.split()[3] for ln in text.splitlines() if ln.startswith("# TYPE ")}

    pt, jt = types(OE.prometheus_text(session=s)), types(JE.prometheus_text(session=js))
    common = set(pt) & set(jt)
    assert len(common) >= 20
    assert {k: pt[k] for k in common} == {k: jt[k] for k in common}
    assert "spark_rapids_tpu_scheduler_admitted" in common


def test_prometheus_dump_contains_required_series():
    s = _session()
    _run_query(s)
    text = OE.prometheus_text(plan=s._last_plan, session=s)
    for series in (
        "spark_rapids_tpu_kernel_builds",
        "spark_rapids_tpu_spill_bytes_device_to_host",
        "spark_rapids_tpu_resilience_oom_retries",
        "spark_rapids_tpu_scheduler_admitted",
        "spark_rapids_tpu_speculation_launched",
        "spark_rapids_tpu_watchdog_stalls",
    ):
        assert f"# TYPE {series} " in text, series
    assert 'spark_rapids_tpu_operator_metric{op="HostToDeviceExec"' in text
    assert "spark_rapids_tpu_circuit_breaker_open" in text


def test_profiling_facade_and_optime(tmp_path):
    from spark_rapids_tpu_torch import profiling as P

    s = _session({"spark.rapids.sql.profile.opTime.enabled": True,
                  "spark.rapids.sql.profile.path": str(tmp_path / "prof")})
    _run_query(s)
    rep = P.metrics_report(s._last_plan)
    assert "opTime" in rep
    bd = P.device_host_breakdown(s._last_plan)
    assert bd["op_time_ms"] > 0
    assert "dispatch_depth" in P.pipeline_report(s._last_plan)
    assert "oom_retries" in P.resilience_report(s)
    files = os.listdir(tmp_path / "prof")
    assert files and json.load(open(tmp_path / "prof" / files[0]))


def test_essential_level_publishes_no_pipe_metrics():
    s = _session({"spark.rapids.tpu.metrics.level": "ESSENTIAL"})
    _run_query(s)
    names = {n for node in OE.walk(s._last_plan) for n in node.metrics}
    assert not any(n.startswith("pipe") for n in names)
    assert "numOutputRows" in names


# ── the live scrape endpoint ───────────────────────────────────────────────


def test_scrape_endpoint_serves_metrics_and_health():
    from spark_rapids_tpu_torch.obs.scrape import ScrapeServer

    s = _session()
    _run_query(s)
    srv = ScrapeServer(session=s, port=0)
    srv.start()
    try:
        text = _get(f"http://{srv.host}:{srv.port}/metrics")
        assert "# TYPE spark_rapids_tpu_scheduler_admitted counter" in text
        assert "_bucket{le=" in text
        health = json.loads(_get(f"http://{srv.host}:{srv.port}/healthz"))
        assert health["status"] == "ok" and health["live"] is True
        assert health["active_queries"] == 0
        with pytest.raises(Exception):
            _get(f"http://{srv.host}:{srv.port}/nope")
    finally:
        srv.stop()


def test_scrape_conf_starts_with_session_and_close_stops_it():
    s = _session({"spark.rapids.tpu.metrics.httpPort": -1})
    srv = s._scrape_server
    assert srv is not None and srv.port > 0 and srv.host == "127.0.0.1"
    try:
        assert "spark_rapids_tpu" in _get(f"http://{srv.host}:{srv.port}/metrics")
    finally:
        s.close()
    assert s._scrape_server is None
    assert _session()._scrape_server is None  # httpPort 0: off


def test_concurrent_queries_with_live_scrapes():
    s = _session({"spark.rapids.tpu.metrics.httpPort": -1})
    srv = s._scrape_server
    errs: list = []
    stop = threading.Event()

    def scraper():
        while not stop.is_set():
            try:
                _get(f"http://{srv.host}:{srv.port}/metrics")
            except Exception as e:  # noqa: BLE001
                errs.append(e)
            stop.wait(0.01)

    th = threading.Thread(target=scraper, daemon=True)
    th.start()
    try:
        qs = [threading.Thread(target=_run_query, args=(s,), daemon=True) for _ in range(4)]
        for q in qs:
            q.start()
        for q in qs:
            q.join(timeout=30)
        assert not any(q.is_alive() for q in qs)
    finally:
        stop.set()
        th.join(timeout=10)
        s.close()
    assert not errs, errs


# ── measured cost calibration ──────────────────────────────────────────────


def _calib_file(d, ops: dict) -> str:
    os.makedirs(str(d), exist_ok=True)
    path = str(d / "calib.json")
    with open(path, "w") as f:
        json.dump({"version": 1, "ops": ops}, f)
    from spark_rapids_tpu_torch.obs import calibration as C

    C.invalidate(path)
    return path


def test_calibration_harvest_persists_measured_costs(tmp_path):
    from spark_rapids_tpu_torch.obs import calibration as C

    path = str(tmp_path / "harvest.json")
    C.invalidate(path)
    s = _session({"spark.rapids.tpu.cbo.calibration.enabled": True,
                  "spark.rapids.tpu.cbo.calibrationFile": path})
    _run_query(s)
    doc = json.load(open(path))
    device_ops = {op: e for op, e in doc["ops"].items() if "device_ns_per_row" in e}
    assert device_ops and all(op.startswith(("Gpu", "Stage", "Host")) for op in device_ops), doc
    for e in device_ops.values():
        assert e["device_ns_per_row"] > 0 and e["updates"] >= 1
    C.invalidate(path)
    weights = C.load_weights(path)
    assert weights and all(isinstance(w, int) for w in weights.values())


def test_measured_weights_flip_unconversion_decision(tmp_path):
    """A synthetic calibration table flips the CBO island decision, the
    reason (with the measured source) shows in the explain entries, and
    disabled or absent calibration plans as the hardcoded table does."""
    base = {"spark.rapids.sql.optimizer.enabled": True}

    def build(s):
        return s.create_dataframe({"a": np.arange(100, dtype=np.int64)}).filter(col("a") > 50)

    s0 = _session(base)
    assert len(build(s0).collect()) == 49
    baseline = s0._last_plan.tree_string()
    assert "GpuFilter" not in baseline
    keep = _calib_file(tmp_path / "keep", {"GpuProjectExec": {"device_ns_per_row": 10.0},
                                          "GpuFilterExec": {"device_ns_per_row": 30.0}})
    s1 = _session({**base, "spark.rapids.tpu.cbo.measuredWeights": True,
                   "spark.rapids.tpu.cbo.calibrationFile": keep})
    assert len(build(s1).collect()) == 49
    assert "GpuFilter" in s1._last_plan.tree_string()
    drop = _calib_file(tmp_path / "drop", {"GpuProjectExec": {"device_ns_per_row": 10.0},
                                          "GpuFilterExec": {"device_ns_per_row": 10.0}})
    s2 = _session({**base, "spark.rapids.tpu.cbo.measuredWeights": True,
                   "spark.rapids.tpu.cbo.calibrationFile": drop})
    assert len(build(s2).collect()) == 49
    assert "GpuFilter" not in s2._last_plan.tree_string()
    reasons = [r for e in s2._last_overrides.explain for r in e.reasons if "cost-based optimizer" in r]
    assert reasons and any("measured weights" in r and "island" in r for r in reasons), reasons
    s3 = _session({**base, "spark.rapids.tpu.cbo.measuredWeights": True,
                   "spark.rapids.tpu.cbo.calibrationFile": str(tmp_path / "absent.json")})
    assert len(build(s3).collect()) == 49
    assert s3._last_plan.tree_string() == baseline
