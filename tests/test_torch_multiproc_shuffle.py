"""A real query across OS processes on the port: two executor processes run
the same plan, each maps only its rank's input partitions and reduces only
its rank's output partitions, and fetches the peer's map output over the
TCP transport (``spark_rapids_tpu_torch/shuffle/tcp.py``), with
``shuffle/driver_service.py`` in this process as the driver — the mirror of
``tests/test_multiproc_shuffle.py``.

The executors import only torch, numpy and the port and run with
``device="cpu"``. This process merges their rows and holds them against
the JAX CPU engine (``tests/harness.py::cpu_session``). One pair of
executors runs every query of the suite in one session each (the shuffle
ids are namespaced per query, so a second run of the aggregate in the same
session must give the same rows); a second pair runs the aggregate under
injected link latency and a bandwidth cap. Every subprocess has its own
timeout.
"""
from __future__ import annotations

import os
import sys
import textwrap
import threading
import time

import numpy as np
import pytest

pytest.importorskip("jax")  # the reference; absent on a machine with only the port

import pyarrow as pa  # noqa: E402
from harness import _values_equal, cpu_session  # noqa: E402

from spark_rapids_tpu import functions as JF  # noqa: E402
from spark_rapids_tpu.functions import col as jcol  # noqa: E402

N_ROWS = 6_000
SEED = 77
CHILD_TIMEOUT_S = 240

_CHILD = textwrap.dedent(
    """
    import json, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from spark_rapids_tpu_torch import TorchSession
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.functions import col

    driver, rank, which = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    rng = np.random.default_rng({seed})
    n = {n_rows}
    t = {{
        "k": rng.integers(0, 100, n).astype(np.int64),
        "v": rng.integers(-50, 50, n).astype(np.int64),
        "s": np.array([f"g{{i % 13}}" for i in range(n)], dtype=object),
        "id": np.arange(n, dtype=np.int64),
    }}
    s = TorchSession({{
        "spark.rapids.sql.enabled": True,
        "spark.rapids.sql.test.enabled": True,
        "spark.rapids.shuffle.manager.enabled": True,
        "spark.rapids.shuffle.multiproc.driver": driver,
        "spark.rapids.shuffle.multiproc.rank": rank,
        "spark.rapids.shuffle.multiproc.size": 2,
        "spark.sql.shuffle.partitions": 4,
        "spark.sql.adaptive.enabled": False,
    }}, device="cpu")
    df = s.create_dataframe(t, num_partitions=4)
    out = {{}}
    q = df.group_by("k", "s").agg(F.sum(col("v")).alias("sv"), F.count("*").alias("c"))
    out["agg"] = [list(r) for r in q.collect()]
    if which == "all":
        # a second query in the SAME session: shuffle ids are namespaced
        # per query, so no cross-query contamination
        out["agg2"] = [list(r) for r in q.collect()]
        a = df.group_by("k").agg(F.sum(col("v")).alias("sv"))
        b = (df.filter(col("v") > 0).group_by("k").agg(F.count("*").alias("pc"))
             .with_column_renamed("k", "k2"))
        out["join"] = [list(r) for r in a.join(b, on=[("k", "k2")], how="left").collect()]
        # ORDER BY: a range exchange whose bounds every rank shares
        out["sort"] = [list(r) for r in df.order_by(col("v").desc(), "id").collect()]
        # a broadcast whose BUILD side holds an exchange runs whole per
        # executor; the aggregate above it still splits by rank
        small = (df.group_by("k").agg(F.max(col("v")).alias("mv"))
                 .filter(col("mv") > 30).with_column_renamed("k", "k2"))
        out["bcast"] = [list(r) for r in (
            df.join(F.broadcast(small), on=[("k", "k2")], how="inner")
            .group_by("s").agg(F.count("*").alias("c"), F.sum(col("mv")).alias("sm"))
        ).collect()]
        # TPC-H q5 at SF 0.002 (strict, like every query here)
        from spark_rapids_tpu_torch.tpch.datagen import gen_table
        from spark_rapids_tpu_torch.tpch.queries import tpch_query
        tt = {{n: gen_table(n, 0.002) for n in
              ("customer", "orders", "lineitem", "supplier", "nation", "region")}}
        out["q5"] = [list(r) for r in tpch_query(
            5, lambda n: s.create_dataframe(tt[n], num_partitions=4)).collect()]
    print("RESULT" + json.dumps(out), flush=True)
    # stay alive until the parent says every executor finished: a peer may
    # still be fetching this executor's map output
    sys.stdin.read()
    """
)


def _run_multiproc(which: str, tmp_path, extra_env=None):
    """Per-rank {query: rows}, through ``testing.run_executors`` (the
    children hold their shuffle servers open until both produced results)."""
    from spark_rapids_tpu_torch.testing import run_executors

    script = tmp_path / f"executor_child_{which}.py"
    script.write_text(_CHILD.format(seed=SEED, n_rows=N_ROWS))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env.update(extra_env or {})
    return run_executors(
        lambda rank, driver: [sys.executable, str(script), driver, str(rank), which],
        env=env, timeout_s=CHILD_TIMEOUT_S,
    )


@pytest.fixture(scope="module")
def all_runs(tmp_path_factory):
    return _run_multiproc("all", tmp_path_factory.mktemp("mp"))


def _table():
    rng = np.random.default_rng(SEED)
    return pa.table({
        "k": rng.integers(0, 100, N_ROWS).astype(np.int64),
        "v": rng.integers(-50, 50, N_ROWS).astype(np.int64),
        "s": pa.array([f"g{i % 13}" for i in range(N_ROWS)]),
        "id": np.arange(N_ROWS, dtype=np.int64),
    })


def _expect(which: str) -> list:
    df = cpu_session().create_dataframe(_table(), num_partitions=4)
    if which in ("agg", "agg2"):
        q = df.group_by("k", "s").agg(JF.sum(jcol("v")).alias("sv"), JF.count("*").alias("c"))
    elif which == "join":
        a = df.group_by("k").agg(JF.sum(jcol("v")).alias("sv"))
        b = (df.filter(jcol("v") > 0).group_by("k").agg(JF.count("*").alias("pc"))
             .with_column_renamed("k", "k2"))
        q = a.join(b, on=[("k", "k2")], how="left")
    elif which == "sort":
        q = df.order_by(jcol("v").desc(), "id")
    elif which == "q5":
        from spark_rapids_tpu.tpch import gen_table, tpch_query

        tt = {n: gen_table(n, 0.002)
              for n in ("customer", "orders", "lineitem", "supplier", "nation", "region")}
        s = cpu_session({"spark.sql.shuffle.partitions": 4})
        q = tpch_query(5, lambda n: s.create_dataframe(tt[n], num_partitions=4))
    else:
        small = (df.group_by("k").agg(JF.max(jcol("v")).alias("mv"))
                 .filter(jcol("mv") > 30).with_column_renamed("k", "k2"))
        q = (df.join(JF.broadcast(small), on=[("k", "k2")], how="inner")
             .group_by("s").agg(JF.count("*").alias("c"), JF.sum(jcol("mv")).alias("sm")))
    return [tuple(r) for r in q.collect()]


@pytest.mark.parametrize("which", ["agg", "join", "bcast", "q5"])
def test_multiproc_query_over_tcp(which, all_runs):
    got = sorted(tuple(r) for rank in all_runs for r in rank[which])
    want = sorted(_expect(which))
    assert len(got) == len(want), f"{which}: merged rows {len(got)} vs {len(want)}"
    assert all(_values_equal(a, b, True) for a, b in zip(got, want)), (
        f"{which}: first diffs {[p for p in zip(got, want) if p[0] != p[1]][:5]}")
    if which == "agg":
        assert sorted(tuple(r) for rank in all_runs for r in rank["agg2"]) == got


def test_multiproc_global_sort_shared_bounds(all_runs):
    """ORDER BY across processes: with ONE set of bounds gathered through
    the driver service, reduce partition p is the p-th contiguous slice of
    the global order, so each rank's output (its pids ascending) splits
    into contiguous slices of the single-process sorted rows."""
    g = _expect("sort")
    flat = [[tuple(r) for r in rank["sort"]] for rank in all_runs]
    assert sorted(flat[0] + flat[1]) == sorted(g)

    def lcp(xs, ref):
        n = 0
        while n < len(xs) and n < len(ref) and xs[n] == ref[n]:
            n += 1
        return n

    # the 4 partition slices: rank 0 owns pids {0, 2}, rank 1 {1, 3}
    c1 = lcp(flat[0], g)
    c2 = lcp(flat[1], g[c1:])
    tail0, tail1 = flat[0][c1:], flat[1][c2:]
    p2_end = c1 + c2 + len(tail0)
    assert tail0 == g[c1 + c2 : p2_end], "rank0's 2nd slice not contiguous"
    assert tail1 == g[p2_end:], "rank1's 2nd slice not contiguous"


def test_multiproc_results_are_split_across_executors(all_runs):
    """Both executors contribute rows, and no reduce partition is read by
    both."""
    keys0 = {tuple(r[:2]) for r in all_runs[0]["agg"]}
    keys1 = {tuple(r[:2]) for r in all_runs[1]["agg"]}
    assert keys0 and keys1
    assert not (keys0 & keys1), "reduce partitions overlapped across executors"


def test_multiproc_under_injected_dcn_latency(tmp_path):
    """The two-process aggregate under 25 ms one-way frame latency and a
    200 MB/s cap in the TCP transport (the executors' environment): same
    rows as the JAX CPU engine."""
    per_rank = _run_multiproc("agg", tmp_path, extra_env={
        "SRT_TCP_INJECT_LATENCY_MS": "25", "SRT_TCP_INJECT_BW_MBPS": "200",
    })
    merged = sorted(tuple(r) for rank in per_rank for r in rank["agg"])
    assert merged == sorted(_expect("agg"))


def test_tcp_injection_adds_latency_and_caps_bandwidth():
    """set_injection shapes the link: every frame pays the one-way latency
    and payload bytes serialize at the configured bandwidth; frames arrive
    intact, each DATA frame with its payload's checksum (the JAX
    package's ``frame_checksum`` gives the same value)."""
    import socket

    from spark_rapids_tpu.utils.checksum import frame_checksum as jcrc
    from spark_rapids_tpu_torch.shuffle import tcp as T
    from spark_rapids_tpu_torch.utils.checksum import frame_checksum

    a, b = socket.socketpair()
    lock = threading.Lock()
    T.set_injection(latency_ms=20, bandwidth_mbps=1)
    try:
        payload = b"x" * 50_000  # 0.05 s serialization at 1 MB/s
        t0 = time.monotonic()
        for i in range(4):
            T._send_frame(a, lock, T._DATA, i, 0, payload)
            kind, tag, _seq, data, crc = T._recv_frame(b)
            assert kind == T._DATA and tag == i and len(data) == len(payload)
            assert crc == frame_checksum(data) == jcrc(data)
        elapsed = time.monotonic() - t0
        # 4 frames x (20 ms latency + 50 ms serialization) = 0.28 s floor
        assert elapsed >= 0.25, f"injection not applied: {elapsed:.3f}s"
    finally:
        T.set_injection()
        a.close()
        b.close()
