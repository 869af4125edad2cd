"""Tests of the port that need an NVIDIA GPU: the hand-written match_starts
kernel against its plain torch version, bit for bit, and the slice's
queries on the card against the port's CPU engine, from one partition and
from 4 input partitions at 8 shuffle partitions (through the device
exchange and the upload cache); TPC-H queries with top-N and ``Like`` on
the card against the CPU engine, and the byte-NFA and the radix select on
a CUDA tensor against the same functions on the CPU; the window operator and
the nested-loop and cartesian joins on the card against the CPU engine,
TPC-DS q2, q47, q64, q67 and q95 from SQL text at SF 0.01; the golden
corpus, the expression families at SF 0.01, ``locate``,
``substring_index`` and ``replace`` over the kernel, and the ANSI error
channel on the card; nested columns uploaded, gathered, concatenated,
downloaded and spilled on the card, split's delimiter scan and token
planes, explode and the collect family's width pass, and a range born on
the card; a real OOM under a per-process cap recovered to equal
rows, injected OOMs around ``Contains`` with the kernel's masks exact, and
a spill-catalog buffer's walk device → pinned host → disk → device; and
the query runtime's checks (a)–(e): fused = unfused, the four task and
pipeline settings bit-identical, concurrent = serial with a deadline,
speculation and the watchdog, the ledger and the trace; and files: a
Parquet write read back into a device aggregate with row-group pruning,
and a cached file read served from its store; and the shuffle slice: two
executor processes on the card over TCP (``contains_agg`` and a grouped
aggregate, merged rows against the CPU engine, ``match_starts`` launched
in each) and a mesh of 4 members on one card against single-device runs.
Each test decides
in its body whether a card is present and skips where none is.

This file imports neither jax nor the JAX package, so it runs on a machine
that has only the port: ``python -m pytest --noconftest -m gpu
tests/test_torch_gpu.py`` (tests/conftest.py sets up JAX for the reference's
suites)."""
from __future__ import annotations

import pytest
import torch

from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch.ops import strings_kernels as SK
from spark_rapids_tpu_torch import functions as F
from spark_rapids_tpu_torch.testing import (
    GRID,
    SPLIT_GRID,
    check_match_starts,
    grid_lengths,
    rows_equal,
    tpcds_check,
)
from spark_rapids_tpu_torch.window import Window
from spark_rapids_tpu_torch.tpch.datagen import TABLES, gen_orders_lineitem, gen_table
from spark_rapids_tpu_torch.tpch.queries import SLICE_QUERIES, tpch_query


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel and the device path run only on a GPU")


@pytest.mark.gpu
@pytest.mark.parametrize("W", [W for W, _ in GRID + SPLIT_GRID])
def test_match_starts_kernel_matches_plain(W):
    """Bytes past each row's length are noise, and some rows hold the
    pattern across their end: the fit test must use the row's length. One
    pattern length also runs on views at storage offsets W and 1, and each
    launch takes the kernel path its shape and alignment ask for."""
    _need_gpu()
    assert check_match_starts(W, 4099 if W <= 2048 else 257, seed=W) == len(grid_lengths(W)) + 2


@pytest.mark.gpu
def test_match_starts_slice_shape_takes_vec16():
    """The slice's plane shape (2^21 rows of W = 128, the last quarter
    capacity padding of length 0) takes the 16-byte path and matches the
    plain version."""
    _need_gpu()
    g = torch.Generator(device="cuda").manual_seed(7)
    n, w, live = 1 << 21, 128, 1_500_000
    data = torch.randint(
        ord("a"), ord("z") + 1, (n, w), dtype=torch.uint8, device="cuda", generator=g
    )
    lens = torch.zeros(n, dtype=torch.int32, device="cuda")
    lens[:live] = torch.randint(19, 95, (live,), dtype=torch.int32, device="cuda", generator=g)
    pat = b"special"
    rows = torch.arange(0, live, 97, device="cuda")
    data[rows[:, None], 10 + torch.arange(len(pat), device="cuda")] = torch.tensor(
        list(pat), dtype=torch.uint8, device="cuda"
    )
    before = dict(SK.LAUNCHES_BY_PATH)
    got = SK.match_starts(data, lens, pat)
    assert SK.LAUNCHES_BY_PATH["vec16"] == before["vec16"] + 1
    assert SK.LAUNCHES_BY_PATH["bytes"] == before["bytes"]
    assert torch.equal(got, SK.match_starts_plain(data, lens, pat))
    assert int(got.sum()) >= rows.numel()


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(SLICE_QUERIES))
def test_slice_query_on_gpu_matches_cpu_engine(name):
    _need_gpu()
    o, l = gen_orders_lineitem(0.01)
    tables = {"orders": o, "lineitem": l}
    fn, _ = SLICE_QUERIES[name]
    gpu = TorchSession({"spark.rapids.sql.test.enabled": True}, device="cuda")
    before = SK.LAUNCHES
    got = fn(lambda t: gpu.create_dataframe(tables[t])).collect()
    torch.cuda.synchronize()
    cpu = TorchSession({"spark.rapids.sql.enabled": False}, device="cpu")
    want = fn(lambda t: cpu.create_dataframe(tables[t])).collect()
    ok, msg = rows_equal(got, want)
    assert want and ok, msg
    if name.startswith("contains"):
        assert SK.LAUNCHES > before


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["q1", "q6", "orders_by_priority", "q18_big_orders", "union_limit"])
def test_partitioned_slice_query_on_gpu_matches_cpu_engine(name):
    """From 4 input partitions at 8 shuffle partitions on the card: every
    node but the scans on the device (strict mode), the rows equal to the
    CPU engine's, and a second run served from the upload cache."""
    _need_gpu()
    o, l = gen_orders_lineitem(0.01)
    tables = {"orders": o, "lineitem": l}
    fn, _ = SLICE_QUERIES[name]
    gpu = TorchSession(
        {"spark.rapids.sql.test.enabled": True, "spark.sql.shuffle.partitions": 8}, device="cuda"
    )
    runs = []
    for _ in range(2):
        runs.append(fn(lambda t: gpu.create_dataframe(tables[t], num_partitions=4)).collect())
        runs.append(gpu._last_metrics["hostToDeviceBytes"])
    cpu = TorchSession({"spark.rapids.sql.enabled": False}, device="cpu")
    want = fn(lambda t: cpu.create_dataframe(tables[t])).collect()
    for got in runs[::2]:
        ok, msg = rows_equal(got, want)
        assert want and ok, msg
    assert runs[1] > 0 and runs[3] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("n", [3, 10, 13, 18])
def test_topn_and_like_queries_on_gpu_match_cpu_engine(n):
    """TPC-H q3, q10 and q18 (top-N) and q13 (``Like``) at SF 0.01 on the
    card, every node but the scans on the device (strict mode), the rows
    equal to the port's CPU engine's."""
    _need_gpu()
    tables = {t: gen_table(t, 0.01) for t in TABLES}
    gpu = TorchSession({"spark.rapids.sql.test.enabled": True}, device="cuda")
    got = tpch_query(n, lambda t: gpu.create_dataframe(tables[t])).collect()
    torch.cuda.synchronize()
    cpu = TorchSession({"spark.rapids.sql.enabled": False}, device="cpu")
    want = tpch_query(n, lambda t: cpu.create_dataframe(tables[t])).collect()
    ok, msg = rows_equal(got, want)
    assert want and ok, msg


@pytest.mark.gpu
def test_like_nfa_and_radix_select_on_gpu_match_cpu():
    """The byte-NFA and the radix select on a CUDA tensor equal the same
    functions on the CPU, bit for bit."""
    _need_gpu()
    from spark_rapids_tpu_torch.expr.strings import like_nfa, like_tokens
    from spark_rapids_tpu_torch.ops.sortkeys import radix_select_kth

    g = torch.Generator().manual_seed(90)
    plane = torch.randint(0, 256, (5000, 64), generator=g, dtype=torch.uint8)
    plane[:, :8] = torch.tensor(list(b"ab\xc3\xa9cdab"), dtype=torch.uint8)
    lengths = torch.randint(0, 65, (5000,), generator=g, dtype=torch.int32)
    for pat in ("ab%", "%cd%", "_b_%", "%a_", "ab\\_%"):
        toks = like_tokens(pat)
        want = like_nfa(plane, lengths, toks)
        got = like_nfa(plane.cuda(), lengths.cuda(), toks)
        assert torch.equal(got.cpu(), want), pat
    words = torch.randint(-(2**63), 2**63 - 1, (100_000,), generator=g, dtype=torch.int64)
    words[::7] = words[0]
    for k in (1, 50, 50_000, 100_000):
        assert int(radix_select_kth(words.cuda(), k)) == int(radix_select_kth(words, k)) == int(
            torch.sort(words).values[k - 1]
        ), k


def _window_join_table(n: int, seed: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    return {
        "k": rng.integers(0, 40, n).astype(np.int64),
        "o": rng.integers(0, 50, n).astype(np.int64),
        "v": rng.standard_normal(n),
        "s": [f"s{int(x)}" for x in rng.integers(0, 30, n)],
    }


@pytest.mark.gpu
def test_window_operator_on_gpu_matches_cpu_engine():
    """Ranks, lead/lag, running, bounded, numeric RANGE and whole-partition
    frames (sum, avg, min, max, string min) over 20,000 rows on the card
    (strict mode) against the port's CPU engine."""
    _need_gpu()
    data = _window_join_table(20_000, 91)

    def build(s):
        w = Window.partition_by("k").order_by("o", "s")
        return (s.create_dataframe(data, num_partitions=2)
                .with_column("rn", F.row_number().over(w))
                .with_column("r", F.rank().over(Window.partition_by("k").order_by("o")))
                .with_column("dr", F.dense_rank().over(Window.partition_by("k").order_by("o")))
                .with_column("lg", F.lag(F.col("v"), 2).over(w))
                .with_column("run", F.sum(F.col("v")).over(w.rows_between(Window.unbounded_preceding, 0)))
                .with_column("bmax", F.max(F.col("v")).over(w.rows_between(-5, 3)))
                .with_column("rng", F.avg(F.col("v")).over(
                    Window.partition_by("k").order_by("o").range_between(-3, 3)))
                .with_column("smin", F.min(F.col("s")).over(Window.partition_by("k"))))

    got = build(TorchSession({"spark.rapids.sql.test.enabled": True,
                              "spark.sql.shuffle.partitions": 4}, device="cuda")).collect()
    torch.cuda.synchronize()
    want = build(TorchSession({"spark.rapids.sql.enabled": False}, device="cpu")).collect()
    ok, msg = rows_equal(got, want)
    assert ok, msg


@pytest.mark.gpu
@pytest.mark.parametrize("how", ["cross", "inner", "left", "full", "semi", "anti"])
def test_nested_loop_and_cartesian_joins_on_gpu_match_cpu_engine(how):
    """A cross join and a non-equi join of every type on the card (strict
    mode; the pair space over ``MAX_PAIR_CAP``, so the stream is chunked)
    against the port's CPU engine."""
    _need_gpu()
    left = _window_join_table(1500, 92)
    right = _window_join_table(700, 93)

    def build(s):
        lt = s.create_dataframe(left, num_partitions=2)
        rt = s.create_dataframe({"b": right["o"], "w": right["v"]})
        if how == "cross":
            return lt.cross_join(rt)
        return lt.join(rt, on=(F.col("o") < F.col("b") - 40) & (F.col("v") < F.col("w")), how=how)

    gpu = TorchSession({"spark.rapids.sql.test.enabled": True}, device="cuda")
    got = build(gpu).collect()
    torch.cuda.synchronize()
    want = build(TorchSession({"spark.rapids.sql.enabled": False}, device="cpu")).collect()
    ok, msg = rows_equal(got, want)
    assert want and ok, msg


@pytest.mark.gpu
@pytest.mark.parametrize("q", [2, 47, 64, 67, 95])
def test_tpcds_query_on_gpu_matches_cpu_engine(q):
    """TPC-DS from SQL text at SF 0.01 on the card, nothing off the device
    but the scans (strict mode), rows equal to the port's CPU engine within
    ``tests/test_tpcds.py``'s tolerance."""
    _need_gpu()
    from spark_rapids_tpu_torch.tpcds import register_tables, tpcds_sql

    conf = {"spark.rapids.sql.incompatibleOps.enabled": True}
    gpu = TorchSession({**conf, "spark.rapids.sql.test.enabled": True}, device="cuda")
    register_tables(gpu, 0.01)
    df = gpu.sql(tpcds_sql(q))
    got = df.collect()
    torch.cuda.synchronize()
    cpu = TorchSession({**conf, "spark.rapids.sql.enabled": False}, device="cpu")
    register_tables(cpu, 0.01)
    ok, msg = tpcds_check(tpcds_sql(q), df, cpu.sql(tpcds_sql(q)).collect(), got)
    assert ok, msg


@pytest.mark.gpu
def test_golden_corpus_on_gpu():
    """The golden corpus on the card: every expression fixture but
    ``split_at`` equal to its literal through ``TorchSession(device=None)``
    in test mode (only the fixtures the JAX package keeps off the device
    may stay off), and the 48 query fixtures from SQL text."""
    _need_gpu()
    import json
    import os

    from spark_rapids_tpu_torch import testing as TT

    golden = os.path.join(os.path.dirname(__file__), "golden")
    bad = []
    for case in TT.golden_cases(golden):
        conf = dict(TT.GOLDEN_CONF)
        if case.label in TT.GOLDEN_OFF_DEVICE:
            conf["spark.rapids.sql.test.allowedNonGpu"] = "CpuProject"
        ok, msg = TT.run_golden_case(TorchSession(conf), case)
        if not ok:
            bad.append((case.label, msg))
    with open(os.path.join(golden, "golden_queries.json")) as f:
        for fx in json.load(f):
            ok, msg = TT.run_golden_query(TorchSession(dict(TT.GOLDEN_QUERY_CONF)), fx)
            if not ok:
                bad.append((fx["name"], msg))
    assert not bad, bad[:10]


@pytest.fixture(scope="module")
def expr_tables():
    orders, lineitem = gen_orders_lineitem(0.01, 19980802)
    return {"orders": orders, "lineitem": lineitem}


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["expr_dates", "expr_casts", "expr_strings", "expr_math"])
def test_expr_family_on_gpu_matches_cpu_engine(family, expr_tables):
    """The expression families at SF 0.01 on the card, nothing off the
    device but the scans, each column equal to the CPU engine's."""
    _need_gpu()
    from spark_rapids_tpu_torch.testing import columns_equal
    from spark_rapids_tpu_torch.tpch.expr_queries import EXPR_CONF, EXPR_QUERIES

    fn, _ = EXPR_QUERIES[family]
    gpu = TorchSession({**EXPR_CONF, "spark.rapids.sql.test.enabled": True}, device="cuda")
    cpu = TorchSession({**EXPR_CONF, "spark.rapids.sql.enabled": False}, device="cpu")
    got = fn(lambda n: gpu.create_dataframe(expr_tables[n])).to_host()
    ok, msg = columns_equal(fn(lambda n: cpu.create_dataframe(expr_tables[n])).to_host(), got)
    assert ok, f"{family}: {msg}"


@pytest.mark.gpu
@pytest.mark.parametrize("consumer", ["locate", "substring_index", "replace"])
def test_match_starts_consumers_on_gpu(consumer, expr_tables, monkeypatch):
    """``locate``, ``substring_index`` and ``replace`` on the card launch
    ``match_starts`` (counted under their own name) and equal the CPU
    engine; the kernel equals ``match_starts_plain`` bit for bit on the
    planes those expressions hand it."""
    _need_gpu()
    from spark_rapids_tpu_torch.functions import col

    build = {
        "locate": lambda c: F.locate("special", c, 3),
        "substring_index": lambda c: F.substring_index(c, " ", -2),
        "replace": lambda c: F.replace(c, "special", "X"),
    }[consumer]
    seen = []
    real = SK.match_starts

    def record(data, lengths, pat, consumer="direct"):
        seen.append((data, lengths, pat, consumer))
        return real(data, lengths, pat, consumer)

    monkeypatch.setattr(SK, "match_starts", record)
    before = dict(SK.LAUNCHES_BY_CONSUMER)
    gpu = TorchSession({"spark.rapids.sql.test.enabled": True}, device="cuda")
    cpu = TorchSession({"spark.rapids.sql.enabled": False}, device="cpu")
    q = lambda s: s.create_dataframe(expr_tables["orders"]).select(  # noqa: E731
        build(col("o_comment")).alias("r"))
    got = q(gpu).collect()
    torch.cuda.synchronize()
    assert SK.LAUNCHES_BY_CONSUMER[consumer] - before.get(consumer, 0) >= 1
    ok, msg = rows_equal(q(cpu).collect(), got)
    assert ok, msg
    for data, lengths, pat, who in seen:
        assert who == consumer
        assert torch.equal(real(data, lengths, pat), SK.match_starts_plain(data, lengths, pat))


@pytest.mark.gpu
def test_ansi_overflow_raises_on_gpu(expr_tables):
    """An ANSI cast and an ANSI add that overflow in one row raise through
    the device error channel on the card; one short of it, they equal the
    non-ANSI rows."""
    _need_gpu()
    from spark_rapids_tpu_torch.expr.base import AnsiError
    from spark_rapids_tpu_torch.testing import columns_equal
    from spark_rapids_tpu_torch.tpch.expr_queries import ansi_queries

    li = expr_tables["lineitem"]
    t = {"lineitem": li}
    ansi = TorchSession({"spark.sql.ansi.enabled": True, "spark.rapids.sql.test.enabled": True})
    plain = TorchSession({"spark.rapids.sql.test.enabled": True})
    for name, fn in ansi_queries(li, True).items():
        with pytest.raises(AnsiError):
            fn(lambda n: ansi.create_dataframe(t[n])).to_host()
    for name, fn in ansi_queries(li, False).items():
        ok, msg = columns_equal(fn(lambda n: plain.create_dataframe(t[n])).to_host(),
                                fn(lambda n: ansi.create_dataframe(t[n])).to_host())
        assert ok, f"{name}: {msg}"


# ── memory and resilience on the card ───────────────────────────────────────


@pytest.mark.gpu
def test_real_oom_under_a_cap_is_spilled_and_retried():
    """A real ``torch.cuda.OutOfMemoryError`` under a per-process cap below
    the query's peak is recovered (the exchange's slices spill, the launch
    retries) and the rows equal the uncapped run. The query is q18's inner
    aggregate at SF 0.1 over 4 input and 8 shuffle partitions, its upload
    cache warm, so the cap bounds its working memory."""
    _need_gpu()
    import gc

    from spark_rapids_tpu_torch.resilience import retry as R

    _, li = gen_orders_lineitem(0.1, 19980802)
    fn = SLICE_QUERIES["q18_big_orders"][0]
    s = TorchSession({"spark.sql.shuffle.partitions": 8}, device="cuda")

    def run():
        return fn(lambda t: s.create_dataframe(li, num_partitions=4)).collect()

    run()  # fills the upload cache
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    want = run()
    peak = torch.cuda.max_memory_allocated() - held
    gc.collect()
    torch.cuda.empty_cache()
    R.reset()
    total = torch.cuda.get_device_properties(0).total_memory
    torch.cuda.set_per_process_memory_fraction((held + 0.8 * peak) / total)
    try:
        got = run()
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)
    rep = R.report()
    R.reset()
    assert rep["oom_retries"] + rep["splits"] > 0 and rep["faults_injected"] == 0, rep
    ok, msg = rows_equal(want, got)
    assert ok, msg


@pytest.mark.gpu
def test_injected_ooms_around_contains_keep_match_starts_exact(monkeypatch):
    """Injected OOMs on every second launch under a recovery scope around a
    ``Contains`` filter: the rows equal the fault-free run and every plane
    handed to ``match_starts`` gives the plain version's mask."""
    _need_gpu()
    from spark_rapids_tpu_torch.resilience import retry as R

    o, li = gen_orders_lineitem(0.01, 19980802)
    fn = SLICE_QUERIES["contains_agg"][0]
    want = fn(lambda t: TorchSession({}, device="cuda").create_dataframe(o)).collect()
    seen = []
    real = SK.match_starts

    def record(data, lengths, pat, consumer="direct"):
        seen.append((data, lengths, pat))
        return real(data, lengths, pat, consumer)

    monkeypatch.setattr(SK, "match_starts", record)
    R.reset()
    faulty = TorchSession({"spark.rapids.tpu.faults.enabled": True,
                           "spark.rapids.tpu.faults.deviceOomEveryN": 2}, device="cuda")
    assert fn(lambda t: faulty.create_dataframe(o)).collect() == want
    assert R.report()["faults_injected"] > 0 and seen
    for data, lengths, pat in seen:
        assert torch.equal(real(data, lengths, pat), SK.match_starts_plain(data, lengths, pat))


@pytest.mark.gpu
def test_catalog_buffer_round_trips_pinned_host_and_disk(tmp_path):
    """A registered batch on the card goes device → pinned host → disk →
    device bit for bit, and the spill counts what the allocator freed."""
    _need_gpu()
    import numpy as np

    from spark_rapids_tpu_torch.columnar.device import host_to_device
    from spark_rapids_tpu_torch.mem.spill import BufferCatalog, StorageTier, _tensors

    o, _ = gen_orders_lineitem(0.01, 19980802)
    db = host_to_device(o, "cuda")
    want = [t.clone() for t in _tensors(db)]
    cat = BufferCatalog(spill_dir=str(tmp_path))
    h = cat.register(db)
    del db
    # the allocator's drop: each storage's block is rounded up to 512 bytes
    freed = cat.synchronous_spill(h.size_bytes)
    assert h.size_bytes <= freed <= h.size_bytes + 512 * len(want)
    buf = cat._buffers[h.id]
    assert buf.tier == StorageTier.HOST
    assert all(t is None or t.is_pinned() for c in buf.host[0] for t in c[1:])
    cat.host_limit = 0
    cat.synchronous_spill(0)
    assert buf.tier == StorageTier.DISK and len(list(tmp_path.iterdir())) == 1
    got = _tensors(h.get_batch())
    assert all(g.device.type == "cuda" for g in got)
    assert len(got) == len(want) and all(torch.equal(a, b) for a, b in zip(want, got))
    assert np.isclose(cat.device_bytes, h.size_bytes)
    h.close()


# ── the query runtime on the card ──────────────────────────────────────────


def _runtime_tables():
    return {t: gen_table(t, 0.01) for t in TABLES}


def _bits(rows):
    return [tuple(v.hex() if isinstance(v, float) and v == v else v for v in r) for r in rows]


@pytest.mark.gpu
def test_runtime_fusion_on_gpu_bit_identical_and_contains_in_stage(monkeypatch):
    """(a) TPC-H q1, q3, q5 and contains_rows fused and unfused on the
    card, bit-identical; contains_rows's match_starts launches inside its
    stage and equals the plain version on the plane it was handed."""
    _need_gpu()
    import threading

    from spark_rapids_tpu_torch.plan import fusion as FU

    tables = _runtime_tables()
    for n in (1, 3, 5):
        a = tpch_query(n, lambda t: TorchSession({}, device="cuda").create_dataframe(tables[t])).collect()
        off = TorchSession({"spark.rapids.tpu.fusion.enabled": False}, device="cuda")
        b = tpch_query(n, lambda t: off.create_dataframe(tables[t])).collect()
        assert _bits(a) == _bits(b), f"q{n}"
    inside = threading.local()
    seen = []
    real_ms, real_stage_fn = SK.match_starts, FU.stage_fn

    def stage_fn(fused):
        fn = real_stage_fn(fused)

        def marked(batch, tvals=None):
            inside.on = True
            try:
                return fn(batch, tvals)
            finally:
                inside.on = False

        return marked

    def record(data, lengths, pat, consumer="direct"):
        seen.append((data, lengths, pat, getattr(inside, "on", False)))
        return real_ms(data, lengths, pat, consumer)

    monkeypatch.setattr(SK, "match_starts", record)
    monkeypatch.setattr(FU, "stage_fn", stage_fn)
    fn, _ = SLICE_QUERIES["contains_rows"]
    gpu = TorchSession({}, device="cuda")
    got = fn(lambda t: gpu.create_dataframe(tables[t])).collect()
    assert gpu._last_fused_stages >= 1 and any(s[3] for s in seen)
    for data, lengths, pat, _ in seen:
        assert torch.equal(real_ms(data, lengths, pat), SK.match_starts_plain(data, lengths, pat))
    cpu = TorchSession({"spark.rapids.sql.enabled": False}, device="cpu")
    ok, msg = rows_equal(got, fn(lambda t: cpu.create_dataframe(tables[t])).collect())
    assert ok, msg


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 5])
def test_runtime_settings_on_gpu_bit_identical(n):
    """(b) q1 and q5 at 4 input x 8 shuffle partitions under tasks (4, 1)
    x pipeline (on, off): the rows bit-identical across the settings."""
    _need_gpu()
    tables = _runtime_tables()
    out = []
    for conf in ({}, {"spark.rapids.tpu.pipeline.enabled": False},
                 {"spark.rapids.sql.concurrentGpuTasks": 1},
                 {"spark.rapids.sql.concurrentGpuTasks": 1, "spark.rapids.tpu.pipeline.enabled": False}):
        s = TorchSession({"spark.sql.shuffle.partitions": 8, **conf}, device="cuda")
        out.append(_bits(tpch_query(n, lambda t: s.create_dataframe(tables[t], num_partitions=4)).collect()))
    assert all(o == out[0] for o in out)


@pytest.mark.gpu
def test_runtime_scheduler_on_gpu_concurrent_equal_serial_and_timeout():
    """(c) four threads at once on one session, each bit-identical to its
    serial run, the admissions counted; a query past its deadline times out
    and returns its permits."""
    _need_gpu()
    import threading

    from spark_rapids_tpu_torch.obs.metrics import GLOBAL
    from spark_rapids_tpu_torch.sched import QueryTimeoutError

    tables = _runtime_tables()
    s = TorchSession({"spark.sql.shuffle.partitions": 8}, device="cuda")

    def run(n):
        return _bits(tpch_query(n, lambda t: s.create_dataframe(tables[t], num_partitions=4)).collect())

    serial = {n: run(n) for n in (1, 5, 18, 6)}
    admitted = GLOBAL.counter("scheduler.admitted").value
    got = {}
    threads = [threading.Thread(target=lambda n=n: got.__setitem__(n, run(n))) for n in serial]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert got == serial
    assert GLOBAL.counter("scheduler.admitted").value - admitted >= 4
    assert s.scheduler.pool.in_use == 0
    slow = TorchSession({"spark.rapids.tpu.scheduler.queryTimeout": 0.2,
                         "spark.rapids.tpu.faults.enabled": True,
                         "spark.rapids.tpu.faults.kernelStallEveryN": 1,
                         "spark.rapids.tpu.faults.kernelStallMs": 100.0,
                         "spark.sql.shuffle.partitions": 8}, device="cuda")
    with pytest.raises(QueryTimeoutError):
        tpch_query(5, lambda t: slow.create_dataframe(tables[t], num_partitions=4)).collect()
    assert slow.scheduler.pool.in_use == 0


@pytest.mark.gpu
def test_runtime_speculation_and_watchdog_on_gpu():
    """(d) a straggler in q5 overtaken by a duplicate with equal rows; a
    query stalled past the watchdog's timeout cancelled as a stall."""
    _need_gpu()
    import time

    from spark_rapids_tpu_torch.obs.metrics import GLOBAL
    from spark_rapids_tpu_torch.sched import QueryCancelledError

    tables = _runtime_tables()
    plain = TorchSession({"spark.sql.shuffle.partitions": 8}, device="cuda")
    want = tpch_query(5, lambda t: plain.create_dataframe(tables[t], num_partitions=4)).collect()
    won = GLOBAL.counter("speculation.won").value
    s = TorchSession({"spark.sql.shuffle.partitions": 8,
                      "spark.rapids.tpu.speculation.enabled": True,
                      "spark.rapids.tpu.speculation.minRuntime": 0.05,
                      "spark.rapids.tpu.speculation.quantile": 0.5,
                      "spark.rapids.tpu.faults.enabled": True,
                      "spark.rapids.tpu.faults.stallPartition": 2,
                      "spark.rapids.tpu.faults.stallPartitionSeconds": 20.0}, device="cuda")
    t0 = time.monotonic()
    got = tpch_query(5, lambda t: s.create_dataframe(tables[t], num_partitions=4)).collect()
    assert time.monotonic() - t0 < 15
    assert _bits(got) == _bits(want)
    assert GLOBAL.counter("speculation.won").value > won
    wd = TorchSession({"spark.rapids.tpu.watchdog.stallTimeout": 0.5,
                       "spark.rapids.tpu.faults.enabled": True,
                       "spark.rapids.tpu.faults.kernelStallEveryN": 1,
                       "spark.rapids.tpu.faults.kernelStallMs": 1000.0}, device="cuda")
    with pytest.raises(QueryCancelledError) as ei:
        tpch_query(6, lambda t: wd.create_dataframe(tables[t])).collect()
    assert ei.value.reason.startswith("stall:")


@pytest.mark.gpu
def test_runtime_ledger_and_trace_on_gpu(tmp_path):
    """(e) q6's phases sum to its wall within 5% in the serial setting;
    q5 traced at 4 x 8 nests query -> operator -> batch with spans from
    other threads inside the tree."""
    _need_gpu()
    import json
    import os

    tables = _runtime_tables()
    s = TorchSession({"spark.rapids.sql.concurrentGpuTasks": 1,
                      "spark.rapids.tpu.pipeline.enabled": False}, device="cuda")
    for _ in range(2):
        tpch_query(6, lambda t: s.create_dataframe(tables[t])).collect()
    bd = s._last_ledger.breakdown()
    assert abs(sum(bd["phases_ms"].values()) - bd["wall_ms"]) <= 0.05 * bd["wall_ms"], bd
    assert "device_execute" in bd["phases_ms"], bd
    td = str(tmp_path / "traces")
    t = TorchSession({"spark.sql.shuffle.partitions": 8, "spark.rapids.tpu.trace.dir": td}, device="cuda")
    tpch_query(5, lambda x: t.create_dataframe(tables[x], num_partitions=4)).collect()
    (f,) = [f for f in os.listdir(td) if f.endswith(".trace.json")]
    events = [e for e in json.load(open(os.path.join(td, f)))["traceEvents"] if e["ph"] == "X"]
    root = [e for e in events if e["cat"] == "query"]
    ops = {e["args"]["span_id"] for e in events if e["cat"] == "operator"}
    assert len(root) == 1 and ops
    assert all(e["args"]["parent_id"] in ops for e in events if e["cat"] == "batch")
    assert any(e["tid"] != root[0]["tid"] for e in events)


# ── adaptive execution and exchange reuse on the card ─────────────────────


def _aqe_sides(hot_fraction=0.0, n=200_000, keys=5_000, seed=11):
    import numpy as np

    rng = np.random.default_rng(seed)
    k = rng.integers(0, keys, n)
    if hot_fraction:
        k = np.where(rng.random(n) < hot_fraction, 7, k)
    left = {"k": k.astype(np.int64), "lv": rng.integers(0, 1000, n).astype(np.int64)}
    right = {"k": np.arange(keys, dtype=np.int64), "rv": rng.standard_normal(keys)}
    return left, right


def _aqe_join(conf, left, right, how="inner", parts=4):
    """(device rows, CPU-engine rows, device session) of one join."""
    out = []
    for enabled, device in ((True, "cuda"), (False, "cpu")):
        s = TorchSession({"spark.sql.shuffle.partitions": 8, "spark.rapids.sql.enabled": enabled,
                          "spark.rapids.sql.test.enabled": enabled,
                          "spark.sql.autoBroadcastJoinThreshold": "-1", **conf}, device=device)
        df = s.create_dataframe(left, num_partitions=parts).join(
            s.create_dataframe(right, num_partitions=parts), on="k", how=how)
        out.append((df.collect(), s))
    return out[0][0], out[1][0], out[0][1]


def _exchanges(plan):
    from spark_rapids_tpu_torch.exec.gpu import GpuShuffleExchangeExec

    found, stack = [], [plan]
    while stack:
        n = stack.pop(0)
        if isinstance(n, GpuShuffleExchangeExec):
            found.append(n)
        stack.extend(n.children)
    return found


@pytest.mark.gpu
def test_aqe_coalesced_join_on_gpu():
    """Both linked exchanges of a shuffled join coalesce to one shared
    grouping on the card; the rows equal the CPU engine's."""
    _need_gpu()
    left, right = _aqe_sides()
    got, ref, s = _aqe_join({"spark.rapids.tpu.sparkVersion": "3.2",
                             "spark.sql.adaptive.advisoryPartitionSizeInBytes": "1m"}, left, right)
    ok, msg = rows_equal(ref, got)
    assert ok, msg
    groups = [ex.aqe_groups for ex in _exchanges(s._last_plan)]
    assert len(groups) == 2 and groups[0] == groups[1] and 1 <= groups[0] < 8, groups
    assert s._last_metrics["aqeSizeSyncs"] == 2


@pytest.mark.gpu
def test_aqe_skew_split_on_gpu():
    """A key carrying 60% of the rows splits its partition on the card; a
    full outer join of the same sides splits nothing; rows equal."""
    _need_gpu()
    left, right = _aqe_sides(hot_fraction=0.6)
    conf = {"spark.sql.adaptive.enabled": True,
            "spark.sql.adaptive.advisoryPartitionSizeInBytes": "1m",
            "spark.sql.adaptive.skewJoin.skewedPartitionThresholdInBytes": "512k",
            "spark.sql.adaptive.skewJoin.skewedPartitionFactor": 2}
    for how, splits in (("inner", True), ("full", False)):
        got, ref, s = _aqe_join(conf, left, right, how)
        ok, msg = rows_equal(ref, got)
        assert ok, (how, msg)
        n = sum(getattr(ex, "aqe_splits", 0) for ex in _exchanges(s._last_plan))
        assert (n >= 1) is splits, (how, n)


@pytest.mark.gpu
def test_aqe_broadcast_switch_on_gpu():
    """A filtered build side under the runtime threshold switches the
    shuffled join to a broadcast on the card; a right outer join does not;
    rows equal."""
    _need_gpu()
    from spark_rapids_tpu_torch.exec.gpu_join import GpuShuffledHashJoinExec

    left, right = _aqe_sides()
    conf = {"spark.sql.adaptive.enabled": True,
            "spark.sql.adaptive.autoBroadcastJoinThreshold": "1m"}
    for how, switched in (("inner", True), ("right", False)):
        got, ref, s = _aqe_join(conf, left, right, how)
        ok, msg = rows_equal(ref, got)
        assert ok, (how, msg)
        (j,) = [n for n in _walk(s._last_plan) if isinstance(n, GpuShuffledHashJoinExec)]
        assert bool(getattr(j, "aqe_broadcast_switched", False)) is switched, how


def _walk(plan):
    stack = [plan]
    while stack:
        n = stack.pop()
        yield n
        stack.extend(n.children)


@pytest.mark.gpu
def test_reused_exchange_on_gpu(monkeypatch):
    """A self-joined aggregate shares its exchange on the card: one
    materialization per exchange node, rows equal to the CPU engine's and
    to the run with reuse off."""
    _need_gpu()
    from spark_rapids_tpu_torch.exec import gpu as G

    mats = []
    real = G.GpuShuffleExchangeExec._materialize
    monkeypatch.setattr(G.GpuShuffleExchangeExec, "_materialize",
                        lambda self, *a: (mats.append(id(self)), real(self, *a))[1])
    left, _ = _aqe_sides()
    rows = {}
    for name, enabled, reuse, device in (("reuse", True, True, "cuda"),
                                         ("no_reuse", True, False, "cuda"),
                                         ("cpu", False, True, "cpu")):
        s = TorchSession({"spark.sql.shuffle.partitions": 8, "spark.rapids.sql.enabled": enabled,
                          "spark.sql.exchange.reuse": reuse}, device=device)
        agg = s.create_dataframe(left, num_partitions=4).group_by("k").agg(
            F.sum(F.col("lv")).alias("s"))
        right = agg.with_column_renamed("k", "k2").with_column_renamed("s", "s2")
        mats.clear()
        rows[name] = agg.join(right, on=[("k", "k2")]).select("k", "s", "s2").collect()
        if name == "reuse":
            assert s._last_reused_exchanges >= 1 and len(mats) == len(set(mats))
    for name in ("reuse", "no_reuse"):
        ok, msg = rows_equal(rows["cpu"], rows[name])
        assert ok, (name, msg)


# ── nested types on the card ───────────────────────────────────────────────


def _nested_host_batch(n=3000, seed=12):
    """array<long>, array<string>, struct<x, y> and map<string, double>
    columns with nulls, built on the host from a seed (no pyarrow)."""
    import numpy as np

    from spark_rapids_tpu_torch.columnar.host import HostBatch, column_from_pylist
    from spark_rapids_tpu_torch.types import (
        DOUBLE, LONG, STRING, ArrayType, MapType, Schema, StructField, StructType,
    )

    rng = np.random.default_rng(seed)

    def maybe(v):
        return None if rng.random() < 0.1 else v

    cols = {
        "a": (ArrayType(LONG), [maybe([maybe(int(x)) for x in rng.integers(-9, 9, rng.integers(0, 12))])
                                for _ in range(n)]),
        "sa": (ArrayType(STRING), [maybe([maybe("w" * int(k)) for k in rng.integers(0, 40, rng.integers(0, 5))])
                                   for _ in range(n)]),
        "s": (StructType((StructField("x", LONG), StructField("y", STRING))),
              [maybe({"x": int(rng.integers(0, 99)), "y": maybe(f"s{rng.integers(0, 9)}")})
               for _ in range(n)]),
        "m": (MapType(STRING, DOUBLE), [maybe({f"k{j}": maybe(float(j)) for j in range(rng.integers(0, 4))})
                                        for _ in range(n)]),
        "id": (LONG, list(range(n))),
    }
    schema = Schema([StructField(k, dt) for k, (dt, _) in cols.items()])
    return HostBatch(schema, [column_from_pylist(v, dt) for dt, v in cols.values()], n)


@pytest.mark.gpu
def test_nested_planes_on_gpu_equal_cpu():
    """Upload, gather, concat (both paths) and download of nested columns on
    the card give the CPU planes and the host batch back, plane for plane."""
    _need_gpu()
    from spark_rapids_tpu_torch.columnar.device import column_planes, device_to_host, host_to_device
    from spark_rapids_tpu_torch.columnar.host import batch_rows
    from spark_rapids_tpu_torch.ops.concat import concat_device
    from spark_rapids_tpu_torch.ops.gather import gather_batch

    hb = _nested_host_batch()
    g, c = host_to_device(hb, "cuda"), host_to_device(hb, "cpu")

    def same(a, b):
        pa = [t for col in a.columns for t in column_planes(col)]
        pb = [t for col in b.columns for t in column_planes(col)]
        assert len(pa) == len(pb)
        assert all(torch.equal(x.cpu(), y) for x, y in zip(pa, pb))

    same(g, c)
    assert batch_rows(device_to_host(g)) == batch_rows(hb)
    idx = torch.randint(0, hb.num_rows, (g.capacity,), generator=torch.Generator().manual_seed(3))
    same(gather_batch(g, idx.cuda(), hb.num_rows), gather_batch(c, idx, hb.num_rows))
    same(concat_device([g, g]), concat_device([c, c]))
    same(concat_device([g, g], counts=[hb.num_rows] * 2), concat_device([c, c], counts=[hb.num_rows] * 2))


@pytest.mark.gpu
def test_nested_spill_on_gpu_restores_bit_for_bit(tmp_path):
    _need_gpu()
    from spark_rapids_tpu_torch.columnar.device import column_planes, host_to_device
    from spark_rapids_tpu_torch.mem import spill as PS

    db = host_to_device(_nested_host_batch(), "cuda")
    want = [t.clone() for col in db.columns for t in column_planes(col)]
    cat = PS.BufferCatalog(spill_dir=str(tmp_path))
    h = cat.register(db)
    del db
    assert cat.synchronous_spill(h.size_bytes) > 0
    cat.host_limit = 0
    cat.synchronous_spill(0)
    assert cat._buffers[h.id].tier == PS.StorageTier.DISK
    got = [t for col in h.get_batch().columns for t in column_planes(col)]
    assert got[0].device.type == "cuda"
    assert all(torch.equal(a, b) for a, b in zip(want, got))


@pytest.mark.gpu
@pytest.mark.parametrize("pattern", [" ", "ly ", "[ ,]"])
def test_split_planes_on_gpu_equal_cpu(pattern):
    """split's delimiter scan and token planes on the card equal the same
    functions on the CPU, and split's rows equal the CPU engine's."""
    _need_gpu()
    from spark_rapids_tpu_torch.expr.strings_ext import (
        split_delimiter_starts,
        split_device_pattern,
        split_token_planes,
    )

    orders, _ = gen_orders_lineitem(0.01, 19980802)
    comment = orders.columns[orders.schema.index_of("o_comment")]
    from spark_rapids_tpu_torch.columnar.device import host_to_device
    from spark_rapids_tpu_torch.columnar.host import HostBatch
    from spark_rapids_tpu_torch.types import Schema, StructField, STRING

    hb = HostBatch(Schema([StructField("c", STRING)]), [comment], orders.num_rows)
    kind, payload = split_device_pattern(pattern)
    for dev in ("cuda", "cpu"):
        col = host_to_device(hb, dev).columns[0]
        take = split_delimiter_starts(col.data, col.lengths, kind, payload)
        starts = torch.zeros((col.capacity, 2), dtype=torch.int32, device=col.data.device)
        starts[:, 1] = 3
        planes = split_token_planes(col.data, starts, torch.full_like(starts, 5))
        if dev == "cuda":
            got = (take.cpu(), planes.cpu())
        else:
            assert torch.equal(got[0], take) and torch.equal(got[1], planes)
    q = lambda s: s.create_dataframe(orders).select(F.split(F.col("o_comment"), pattern).alias("p"))
    assert rows_equal(q(TorchSession({"spark.rapids.sql.enabled": False}, device="cpu")).collect(),
                      q(TorchSession({"spark.rapids.sql.test.enabled": True})).collect())[0]


@pytest.mark.gpu
def test_generate_and_collect_width_on_gpu():
    """posexplode on the card, and the collect family's width pass, against
    the CPU engine; the range is born on the card."""
    _need_gpu()
    _, lineitem = gen_orders_lineitem(0.01, 19980802)

    def q(s):
        lists = s.create_dataframe(lineitem, num_partitions=2).group_by("l_orderkey").agg(
            F.collect_list(F.col("l_partkey")).alias("ps"),
            F.collect_set(F.col("l_suppkey")).alias("ss"))
        return lists.select(F.col("l_orderkey"), F.col("ss"), F.posexplode(F.col("ps")))

    gpu = TorchSession({"spark.rapids.sql.test.enabled": True})
    cpu = TorchSession({"spark.rapids.sql.enabled": False}, device="cpu")
    ok, msg = rows_equal(q(cpu).collect(), q(gpu).collect())
    assert ok, msg
    assert "GpuGenerate" in q(gpu).explain()
    r = gpu.range(0, 10_000_000, 3, 4).agg(F.sum(F.col("id")).alias("s")).collect()
    n = (10_000_000 + 2) // 3
    assert r == [(3 * n * (n - 1) // 2,)]
    assert gpu._last_metrics["hostToDeviceBytes"] == 0


@pytest.mark.gpu
def test_files_write_read_aggregate_on_gpu(tmp_path):
    """TPC-H lineitem at SF 0.01 written with the port's Parquet writer and
    read back (COALESCING) into q1 and a pruned q6-shaped aggregate on the
    card: rows equal to the CPU engine over the in-memory table, at least
    one row group pruned by the ``l_orderkey`` range."""
    _need_gpu()
    _orders, li = gen_orders_lineitem(0.01, 7)
    path = str(tmp_path / "lineitem")
    cpu = TorchSession({"spark.rapids.sql.enabled": False}, device="cpu")
    from spark_rapids_tpu_torch.io import parquet as P

    monkey_rows = P.ROW_GROUP_ROWS
    P.ROW_GROUP_ROWS = 8192  # several row groups at this size
    try:
        cpu.create_dataframe(li, num_partitions=2).write.parquet(path)
    finally:
        P.ROW_GROUP_ROWS = monkey_rows
    gpu = TorchSession({"spark.rapids.sql.enabled": True, "spark.rapids.sql.test.enabled": True},
                       device="cuda")
    got = tpch_query(1, lambda t: gpu.read.parquet(path), 0.01).collect()
    want = tpch_query(1, lambda t: cpu.create_dataframe(li), 0.01).collect()
    ok, msg = rows_equal(got, want)
    assert ok, msg
    hi = int(li.column("l_orderkey").data.max()) // 4

    def ranged(s, df):
        return df.filter(F.col("l_orderkey") < hi).agg(
            F.sum(F.col("l_extendedprice") * F.col("l_discount")).alias("revenue"),
            F.count(F.col("l_orderkey")).alias("n"))

    got = ranged(gpu, gpu.read.parquet(path)).collect()
    assert gpu._last_metrics["fileScanFiles"] == 2
    scans = []
    stack = [gpu._last_plan]
    while stack:
        n = stack.pop()
        if type(n).__name__ == "CpuFileScanExec":
            scans.append(n)
        stack.extend(n.children)
    assert scans and scans[0].pruned_row_groups >= 1
    ok, msg = rows_equal(got, ranged(cpu, cpu.create_dataframe(li)).collect())
    assert ok, msg


@pytest.mark.gpu
def test_files_cached_read_on_gpu(tmp_path):
    """A cached filtered file read: two device aggregates over it equal the
    CPU engine's, the second reads no file and uploads nothing, and
    ``unpersist()`` empties the store."""
    _need_gpu()
    orders = gen_table("orders", 0.01, 7)
    path = str(tmp_path / "orders")
    cpu = TorchSession({"spark.rapids.sql.enabled": False}, device="cpu")
    cpu.create_dataframe(orders).write.parquet(path)
    gpu = TorchSession({"spark.rapids.sql.enabled": True, "spark.rapids.sql.test.enabled": True},
                       device="cuda")
    base = gpu.read.parquet(path).filter(F.col("o_totalprice") > 1000.0).cache()

    def agg(df):
        return df.group_by("o_orderpriority").agg(F.count(F.col("o_orderkey")).alias("n"),
                                                 F.sum(F.col("o_totalprice")).alias("p"))

    first = sorted(agg(base).collect())
    second = sorted(agg(base).collect())
    assert gpu._last_metrics["fileScanFiles"] == 0
    assert gpu._last_metrics["hostToDeviceBytes"] == 0
    want = sorted(agg(cpu.read.parquet(path).filter(F.col("o_totalprice") > 1000.0)).collect())
    for rows in (first, second):
        ok, msg = rows_equal(rows, want)
        assert ok, msg
    assert len(gpu._cache_store) == 1
    base.unpersist()
    assert len(gpu._cache_store) == 0


_EXECUTOR = """
import json, sys
import numpy as np
import torch
from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch.ops import strings_kernels as SK
from spark_rapids_tpu_torch.tpch.datagen import gen_table
from spark_rapids_tpu_torch.tpch.queries import SLICE_QUERIES
from spark_rapids_tpu_torch import functions as F

rank, driver = int(sys.argv[1]), sys.argv[2]
orders = gen_table("orders", 0.01, 7)
s = TorchSession({
    "spark.rapids.sql.test.enabled": True,
    "spark.sql.shuffle.partitions": 4,
    "spark.rapids.shuffle.manager.enabled": True,
    "spark.rapids.shuffle.multiproc.driver": driver,
    "spark.rapids.shuffle.multiproc.rank": rank,
    "spark.rapids.shuffle.multiproc.size": 2,
    "spark.rapids.memory.gpu.allocFraction": 0.2,
}, device="cuda:0")
df = lambda t: s.create_dataframe(orders, num_partitions=4)
SK.reset_counts()
out = {"contains_agg": [list(r) for r in SLICE_QUERIES["contains_agg"][0](df).collect()]}
out["launches"] = SK.LAUNCHES
out["agg"] = [list(r) for r in df("orders").group_by("o_orderpriority").agg(
    F.count(F.col("o_orderkey")).alias("n"), F.sum(F.col("o_totalprice")).alias("p")).collect()]
print("RESULT" + json.dumps(out), flush=True)
sys.stdin.read()
"""


@pytest.mark.gpu
def test_multiproc_executors_on_gpu_over_tcp(tmp_path):
    """Two executor processes on the card, each its own CUDA context with a
    fifth of its memory for spill accounting, run ``contains_agg`` and a
    grouped aggregate over orders at SF 0.01 through the shuffle manager
    over TCP; the merged rows equal the port's CPU engine's, and each
    executor launched ``match_starts``."""
    _need_gpu()
    import os
    import sys

    from spark_rapids_tpu_torch.testing import run_executors

    script = tmp_path / "executor.py"
    script.write_text(_EXECUTOR)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = run_executors(lambda rank, driver: [sys.executable, str(script), str(rank), driver],
                        env=env, timeout_s=300)
    assert all(r["launches"] > 0 for r in res), [r["launches"] for r in res]
    orders = gen_table("orders", 0.01, 7)
    cpu = TorchSession({"spark.rapids.sql.enabled": False, "spark.sql.shuffle.partitions": 4},
                       device="cpu")
    df = lambda t: cpu.create_dataframe(orders, num_partitions=4)
    want_c = [tuple(r) for r in SLICE_QUERIES["contains_agg"][0](df).collect()]
    want_a = [tuple(r) for r in df("orders").group_by("o_orderpriority").agg(
        F.count(F.col("o_orderkey")).alias("n"), F.sum(F.col("o_totalprice")).alias("p")).collect()]
    for key, want in (("contains_agg", want_c), ("agg", want_a)):
        got = [tuple(r) for rank in res for r in rank[key]]
        ok, msg = rows_equal(want, got)
        assert ok, f"{key}: {msg}"


@pytest.mark.gpu
def test_mesh_on_gpu_equals_single_device():
    """A mesh of 4 members on cuda:0: a group-by, a shuffled join and a
    global sort equal the single-device runs, every exchange on the mesh."""
    _need_gpu()
    orders, lineitem = gen_orders_lineitem(0.01, 7)
    tables = {"orders": orders, "lineitem": lineitem}
    base = {"spark.sql.autoBroadcastJoinThreshold": -1, "spark.rapids.sql.test.enabled": True}
    mesh = TorchSession({**base, "spark.rapids.sql.mesh.enabled": True,
                         "spark.rapids.sql.mesh.size": 4}, device="cuda:0")
    flat = TorchSession({**base, "spark.sql.shuffle.partitions": 4}, device="cuda:0")

    def queries(s):
        t = lambda n: s.create_dataframe(tables[n], num_partitions=4)
        return [
            t("lineitem").group_by("l_orderkey").agg(F.sum(F.col("l_quantity")).alias("q")).collect(),
            t("lineitem").join(t("orders"), on=[("l_orderkey", "o_orderkey")])
            .group_by("o_orderpriority").agg(F.count(F.col("l_linenumber")).alias("n")).collect(),
            t("orders").select("o_orderkey", "o_totalprice")
            .order_by(F.col("o_totalprice").desc(), F.col("o_orderkey")).collect(),
        ]

    for want, got in zip(queries(flat), queries(mesh)):
        ok, msg = rows_equal(want, got)
        assert ok, msg
    st = mesh.mesh_context().stats
    assert st["exchanges"] >= 4 and st["bytes_moved"] == 0 and st["bytes_local"] > 0
