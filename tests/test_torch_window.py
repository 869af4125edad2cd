"""The port's window operator (``exec/gpu_window.py``, ``exec/cpu_window.py``),
against the JAX package.

- A mirror of ``tests/test_window.py``: each query runs through the port's
  device engine (``device="cpu"``, strict mode: the window and its
  exchange on the device) and its CPU engine, and both give the JAX CPU
  engine's rows within the harness's tolerance.
- The device building blocks held to the JAX functions on seeded numpy
  inputs: ``sparse_minmax`` (``_sparse_minmax``), ``bsearch_first``
  (``_bsearch_first``), ``range_frame_bounds`` (``_range_frame_bounds``)
  and ``compute_window_column`` (``_compute_window_column``, with a
  tie-heavy ``row_number``/``rank``/``dense_rank`` case).
"""
from __future__ import annotations

import decimal

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; absent on a machine with only the port

import jax.numpy as jnp  # noqa: E402
import pyarrow as pa  # noqa: E402

import spark_rapids_tpu.expr.windows as JW  # noqa: E402
import spark_rapids_tpu.functions as JF  # noqa: E402
import spark_rapids_tpu.types as JT  # noqa: E402
from harness import _normalize, _values_equal, cpu_session  # noqa: E402
from spark_rapids_tpu.columnar.device import DeviceBatch as JBatch  # noqa: E402
from spark_rapids_tpu.columnar.device import DeviceColumn as JColumn  # noqa: E402
from spark_rapids_tpu.exec import tpu_window as jwin  # noqa: E402
from spark_rapids_tpu.expr import aggregates as JA  # noqa: E402
from spark_rapids_tpu.expr import base as JB  # noqa: E402
from spark_rapids_tpu.window import Window as JWindow  # noqa: E402
from spark_rapids_tpu_torch import TorchSession  # noqa: E402
from spark_rapids_tpu_torch import functions as PF  # noqa: E402
from spark_rapids_tpu_torch import types as PT  # noqa: E402
from spark_rapids_tpu_torch.columnar.device import DeviceBatch, DeviceColumn  # noqa: E402
from spark_rapids_tpu_torch.exec import gpu_window as pwin  # noqa: E402
from spark_rapids_tpu_torch.expr import aggregates as PA  # noqa: E402
from spark_rapids_tpu_torch.expr import base as PB  # noqa: E402
from spark_rapids_tpu_torch.expr import windows as PW  # noqa: E402
from spark_rapids_tpu_torch.window import Window as PWindow  # noqa: E402

#: the package's functions module and Window class, for a query written once
JAX_API = (JF, JWindow)
PORT_API = (PF, PWindow)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in several
    worker processes at once, and torch's thread pools oversubscribe the
    cores (queries slow down tenfold and more)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_rows_equal(a, b, what):
    a, b = _normalize(a, True), _normalize(b, True)
    assert len(a) == len(b), f"{what}: {len(a)} vs {len(b)} rows"
    for i, (ra, rb) in enumerate(zip(a, b)):
        assert len(ra) == len(rb), f"{what} row {i}: {ra} vs {rb}"
        for j, (x, y) in enumerate(zip(ra, rb)):
            assert _values_equal(x, y, approx_float=True), f"{what} row {i} col {j}: {x!r} vs {y!r}"


def check(build, shuffle_partitions: int = 8):
    """``build(F, Window, session)`` through the port's device engine (strict
    mode) and CPU engine, each held to the JAX CPU engine."""
    want = build(*JAX_API, cpu_session()).collect()
    dev = TorchSession(
        {
            "spark.rapids.sql.enabled": True,
            "spark.rapids.sql.test.enabled": True,
            "spark.sql.shuffle.partitions": shuffle_partitions,
        },
        device="cpu",
    )
    got = build(*PORT_API, dev).collect()
    assert any(e.node.startswith("CpuWindowExec") and e.on_device for e in dev._last_overrides.explain)
    assert_rows_equal(got, want, "port device engine")
    cpu = TorchSession({"spark.rapids.sql.enabled": False}, device="cpu")
    assert_rows_equal(build(*PORT_API, cpu).collect(), want, "port CPU engine")
    return got


# ── the mirror of tests/test_window.py ──────────────────────────────────────


def _table(n=300, groups=12, seed=21, with_ties=True):
    rng = np.random.default_rng(seed)
    ts = rng.integers(0, 40 if with_ties else 10_000_000, n).astype(np.int64)
    v = rng.integers(-100, 100, n).astype(np.int64)
    vmask = rng.random(n) < 0.1
    return pa.table(
        {
            "k": pa.array(rng.integers(0, groups, n).astype(np.int64)),
            "ts": pa.array(ts),
            "v": pa.array(v, mask=vmask),
            "f": pa.array(np.where(rng.random(n) < 0.05, np.nan, rng.random(n))),
            "s": pa.array([f"s{int(x)}" for x in rng.integers(0, 25, n)]),
        }
    )


def _w(W):
    return W.partition_by("k").order_by("ts", "s")


def test_row_number():
    t = _table()
    check(lambda F, W, s: s.create_dataframe(t, num_partitions=3).with_column(
        "rn", F.row_number().over(_w(W))))


def test_rank_dense_rank_with_ties():
    t = _table(with_ties=True)
    check(lambda F, W, s: s.create_dataframe(t, num_partitions=3)
          .with_column("r", F.rank().over(W.partition_by("k").order_by("ts")))
          .with_column("dr", F.dense_rank().over(W.partition_by("k").order_by("ts"))))


def test_running_sum_default_frame_peers():
    t = _table(with_ties=True)
    check(lambda F, W, s: s.create_dataframe(t, num_partitions=2).with_column(
        "rs", F.sum(F.col("v")).over(W.partition_by("k").order_by("ts"))))


def test_partition_total_no_order():
    t = _table()

    def build(F, W, s):
        w = W.partition_by("k")
        return (s.create_dataframe(t, num_partitions=3)
                .with_column("tot", F.sum(F.col("v")).over(w))
                .with_column("cnt", F.count(F.col("v")).over(w))
                .with_column("mean", F.avg(F.col("v")).over(w)))

    check(build)


def test_lead_lag():
    t = _table(with_ties=False)
    check(lambda F, W, s: s.create_dataframe(t, num_partitions=2)
          .with_column("lg", F.lag(F.col("v"), 1).over(_w(W)))
          .with_column("ld", F.lead(F.col("v"), 2, -999).over(_w(W)))
          .with_column("sl", F.lag(F.col("s"), 1, "none").over(_w(W))))


@pytest.mark.parametrize("lo,hi", [(-3, 0), (-2, 2), (0, 3), (-5, -1), (1, 4)])
def test_bounded_rows_sum_min_max(lo, hi):
    t = _table(with_ties=False)

    def build(F, W, s):
        w = _w(W).rows_between(lo, hi)
        return (s.create_dataframe(t, num_partitions=2)
                .with_column("bs", F.sum(F.col("v")).over(w))
                .with_column("bmin", F.min(F.col("v")).over(w))
                .with_column("bmax", F.max(F.col("v")).over(w))
                .with_column("bc", F.count(F.col("v")).over(w)))

    check(build)


def test_unbounded_prefix_suffix_min_max():
    t = _table(with_ties=False)

    def build(F, W, s):
        w1 = _w(W).rows_between(W.unbounded_preceding, W.current_row)
        w2 = _w(W).rows_between(W.current_row, W.unbounded_following)
        return (s.create_dataframe(t, num_partitions=2)
                .with_column("pmin", F.min(F.col("v")).over(w1))
                .with_column("smax", F.max(F.col("v")).over(w2)))

    check(build)


def test_float_window_with_nans():
    t = _table()
    check(lambda F, W, s: s.create_dataframe(t, num_partitions=2)
          .with_column("fmin", F.min(F.col("f")).over(W.partition_by("k")))
          .with_column("fmax", F.max(F.col("f")).over(W.partition_by("k"))))


def test_desc_order_window():
    t = _table(with_ties=False)
    check(lambda F, W, s: s.create_dataframe(t, num_partitions=2).with_column(
        "rn", F.row_number().over(W.partition_by("k").order_by(F.col("ts").desc()))))


def test_no_partition_window():
    t = _table(n=120)
    check(lambda F, W, s: s.create_dataframe(t, num_partitions=3).with_column(
        "rn", F.row_number().over(W.order_by("ts", "s"))))


def test_multiple_specs_one_select():
    t = _table(with_ties=False)
    check(lambda F, W, s: s.create_dataframe(t, num_partitions=2)
          .with_column("rn", F.row_number().over(W.partition_by("k").order_by("ts", "s")))
          .with_column("tot", F.count(F.col("v")).over(W.partition_by("s"))))


def test_window_fallback_wide_minmax_frame():
    """The JAX package once sent frames this wide to the CPU engine; the
    sparse table runs them on the device in both packages."""
    t = _table(n=100, with_ties=False)
    check(lambda F, W, s: s.create_dataframe(t, num_partitions=2).with_column(
        "m", F.min(F.col("v")).over(_w(W).rows_between(-300, 300))))


def _range_table(n=260, seed=33):
    rng = np.random.default_rng(seed)
    v = rng.integers(0, 60, n).astype(np.int64)  # heavy ties
    nulls = rng.random(n) < 0.08
    return pa.table(
        {
            "k": pa.array(rng.integers(0, 6, n).astype(np.int32)),
            "o": pa.array([None if m else int(x) for x, m in zip(v, nulls)], type=pa.int64()),
            "v": pa.array(rng.standard_normal(n)),
        }
    )


@pytest.mark.parametrize("lo,hi", [(-5, 0), (-3, 3), (0, 10), (-10, -2), (2, 8)])
def test_numeric_range_frames(lo, hi):
    t = _range_table()

    def build(F, W, s):
        w = W.partition_by("k").order_by("o").range_between(lo, hi)
        return (s.create_dataframe(t, num_partitions=2)
                .with_column("rs", F.sum(F.col("v")).over(w))
                .with_column("rmin", F.min(F.col("v")).over(w))
                .with_column("rmax", F.max(F.col("v")).over(w))
                .with_column("rc", F.count(F.col("v")).over(w)))

    check(build)


def test_numeric_range_desc_order():
    t = _range_table(seed=34)

    def build(F, W, s):
        w = W.partition_by("k").order_by(F.col("o").desc()).range_between(-4, 4)
        return (s.create_dataframe(t, num_partitions=2)
                .with_column("rs", F.sum(F.col("v")).over(w))
                .with_column("rc", F.count(F.col("v")).over(w)))

    check(build)


def test_numeric_range_one_side_unbounded():
    t = _range_table(seed=35)

    def build(F, W, s):
        w = W.partition_by("k").order_by("o").range_between(W.unboundedPreceding, 5)
        return (s.create_dataframe(t, num_partitions=2)
                .with_column("rs", F.sum(F.col("v")).over(w))
                .with_column("rmax", F.max(F.col("v")).over(w)))

    check(build)


def test_wide_bounded_rows_min_max_on_device():
    t = _table(n=600, with_ties=False)

    def build(F, W, s):
        w = _w(W).rows_between(-400, 400)
        return (s.create_dataframe(t, num_partitions=2)
                .with_column("bmin", F.min(F.col("v")).over(w))
                .with_column("bmax", F.max(F.col("v")).over(w)))

    check(build)


@pytest.mark.parametrize("frame", ["bounded", "unbounded", "growing"])
def test_string_min_max_over_window(frame):
    t = _table(n=400, seed=61)

    def build(F, W, s):
        w = _w(W)
        if frame == "bounded":
            w = w.rows_between(-3, 2)
        elif frame == "growing":
            w = w.rows_between(W.unbounded_preceding, W.current_row)
        return (s.create_dataframe(t, num_partitions=2)
                .with_column("smin", F.min(F.col("s")).over(w))
                .with_column("smax", F.max(F.col("s")).over(w)))

    check(build)


def test_string_min_max_window_with_nulls_and_empty():
    ss = ["b", None, "", "zz", None, "a", None, None]
    t = pa.table({"k": [1, 1, 1, 1, 2, 2, 3, 3], "o": list(range(8)), "s": ss})

    def build(F, W, s):
        w = W.partition_by("k").order_by("o").rows_between(-1, 0)
        return (s.create_dataframe(t)
                .with_column("mn", F.min(F.col("s")).over(w))
                .with_column("mx", F.max(F.col("s")).over(w)))

    check(build)


def test_decimal_range_frame():
    rng = np.random.default_rng(62)
    n = 300
    vals = [decimal.Decimal(f"{int(v)}.{int(v) % 100:02d}") for v in rng.integers(0, 60, n)]
    t = pa.table({
        "k": pa.array(rng.integers(0, 6, n).astype(np.int64)),
        "d": pa.array(vals, type=pa.decimal128(10, 2)),
        "x": pa.array(rng.integers(0, 100, n).astype(np.int64)),
    })

    def build(F, W, s, table=t):
        w = W.partition_by("k").order_by("d").range_between(-5, 5)
        return (s.create_dataframe(table, num_partitions=2)
                .with_column("sx", F.sum(F.col("x")).over(w))
                .with_column("cx", F.count(F.col("x")).over(w)))

    check(build)
    # the frame is ±5 in value space, not in unscaled space
    t2 = pa.table({
        "k": [1] * 3,
        "d": pa.array([decimal.Decimal(x) for x in ("1.00", "4.00", "9.00")],
                      type=pa.decimal128(10, 2)),
        "x": [10, 20, 40],
    })
    rows = check(lambda F, W, s: build(F, W, s, t2))
    assert {str(r[1]): r[3] for r in rows} == {"1.00": 30, "4.00": 70, "9.00": 60}


def test_percent_rank_cume_dist_ntile():
    t = pa.table({
        "k": [1, 1, 1, 1, 2, 2, 2],
        "d": [10, 20, 20, 30, 5, 5, 7],
        "v": [1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0],
    })

    def build(F, W, s):
        w = W.partition_by("k").order_by("d")
        return (s.create_dataframe(t)
                .with_column("pr", F.percent_rank().over(w))
                .with_column("cd", F.cume_dist().over(w))
                .with_column("nt", F.ntile(2).over(w)))

    rows = {(r[0], r[1], r[2]): r[3:] for r in check(build)}
    assert rows[(1, 10, 1.0)] == (0.0, 0.25, 1)
    assert rows[(1, 20, 2.0)][0] == pytest.approx(1 / 3)
    assert rows[(1, 20, 2.0)][1] == 0.75
    assert rows[(1, 30, 4.0)] == (1.0, 1.0, 2)
    assert [rows[(2, 5, 5.0)][2], rows[(2, 5, 6.0)][2], rows[(2, 7, 7.0)][2]] == [1, 1, 2]


def test_ntile_more_buckets_than_rows():
    t = pa.table({"k": [1, 1], "d": [1, 2]})
    rows = check(lambda F, W, s: s.create_dataframe(t).with_column(
        "nt", F.ntile(5).over(W.partition_by("k").order_by("d"))))
    assert sorted(r[2] for r in rows) == [1, 2]


# ── the device building blocks against the JAX functions ────────────────────

CAP = 256


def _segments(rng, cap: int, n: int, groups: int):
    """Sorted segment ids over n live rows (padding its own segment), and
    the per-row first/last indices of each segment."""
    seg = np.sort(rng.integers(0, groups, n))
    starts = np.zeros(cap, dtype=bool)
    starts[0] = True
    starts[1:n] = seg[1:] != seg[:-1]
    starts[n:n + 1] = True
    idx = np.arange(cap)
    first = np.maximum.accumulate(np.where(starts, idx, 0))
    ends = np.append(starts[1:], True)
    last = np.minimum.accumulate(np.where(ends, idx, cap - 1)[::-1])[::-1]
    return starts, first, np.ascontiguousarray(last)


@pytest.mark.parametrize("dtype", ["int64", "float64"])
def test_sparse_minmax_matches_jax(dtype):
    rng = np.random.default_rng(71)
    if dtype == "int64":
        work = rng.integers(-1000, 1000, CAP).astype(np.int64)
    else:
        work = rng.standard_normal(CAP)
    valid = rng.random(CAP) < 0.8
    aux = rng.random(CAP) < 0.1
    lo = rng.integers(0, CAP, CAP)
    hi = np.minimum(lo + rng.integers(-2, 40, CAP), CAP - 1)
    for op, jop in (("min", jnp.minimum), ("max", jnp.maximum)):
        ident = (np.iinfo(np.int64).max if op == "min" else np.iinfo(np.int64).min) \
            if dtype == "int64" else (np.inf if op == "min" else -np.inf)
        w = np.where(valid, work, ident).astype(work.dtype)
        got = pwin.sparse_minmax(
            torch.from_numpy(w), torch.from_numpy(valid), torch.from_numpy(aux),
            torch.from_numpy(lo), torch.from_numpy(hi), CAP, op, ident.item() if hasattr(ident, "item") else ident,
        )
        want = jwin._sparse_minmax(
            jnp.asarray(w), jnp.asarray(valid), jnp.asarray(aux),
            jnp.asarray(lo, jnp.int32), jnp.asarray(hi, jnp.int32), CAP, jop,
            jnp.asarray(ident, dtype=w.dtype),
        )
        ok = lo <= hi
        for g, j in zip(got, want):
            np.testing.assert_array_equal(g.numpy()[ok], np.asarray(j)[ok], err_msg=op)


def test_bsearch_first_and_range_frame_bounds_match_jax():
    rng = np.random.default_rng(72)
    n = 200
    starts, first, last = _segments(rng, CAP, n, 9)
    seg_id = np.cumsum(starts) - 1
    # ascending within each segment, heavy ties, a null block first in some
    sval = (seg_id * 0 + rng.integers(0, 30, CAP)).astype(np.int64)
    order = np.lexsort((sval, seg_id))
    sval = sval[order]
    ovalid = rng.random(CAP) < 0.9
    ovalid[n:] = False
    sval = np.where(ovalid, sval, np.iinfo(np.int64).min)
    order2 = np.lexsort((sval, seg_id))
    sval, ovalid = sval[order2], ovalid[order2]
    targets = sval + rng.integers(-5, 6, CAP)
    for strict in (False, True):
        got = pwin.bsearch_first(
            torch.from_numpy(sval), torch.from_numpy(first), torch.from_numpy(last),
            torch.from_numpy(targets), CAP, strict,
        )
        want = jwin._bsearch_first(
            jnp.asarray(sval), jnp.asarray(first, jnp.int32), jnp.asarray(last, jnp.int32),
            jnp.asarray(targets), CAP, strict,
        )
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for lo_b, hi_b in ((-5, 0), (-3, 3), (0, 10), (PW.UNBOUNDED_PRECEDING, 5), (-2, PW.UNBOUNDED_FOLLOWING)):
        pf = PW.WindowFrame("range", lo_b, hi_b)
        jf = JW.WindowFrame("range", lo_b, hi_b)
        got = pwin.range_frame_bounds(
            pf, torch.from_numpy(sval), torch.from_numpy(ovalid), torch.from_numpy(first),
            torch.from_numpy(last), torch.from_numpy(first), torch.from_numpy(last), CAP,
        )
        want = jwin._range_frame_bounds(
            jf, jnp.asarray(sval), jnp.asarray(ovalid), jnp.asarray(first, jnp.int32),
            jnp.asarray(last, jnp.int32), jnp.asarray(first, jnp.int32),
            jnp.asarray(last, jnp.int32), CAP,
        )
        for g, j in zip(got, want):
            np.testing.assert_array_equal(g.numpy()[:n], np.asarray(j)[:n], err_msg=str(pf))


def _sorted_window_inputs(rng, n: int):
    """k (segments) and o (order, tie-heavy) sorted, v and s payloads."""
    k = np.sort(rng.integers(0, 7, n)).astype(np.int64)
    o = rng.integers(0, 4, n).astype(np.int64)
    perm = np.lexsort((o, k))
    k, o = k[perm], o[perm]
    v = rng.integers(-50, 50, n).astype(np.int64)
    vvalid = rng.random(n) < 0.85
    f = rng.standard_normal(n)
    return k, o, v, vvalid, f


_FUNCS = {
    "row_number": lambda M, A: M.RowNumber(),
    "rank": lambda M, A: M.Rank(),
    "dense_rank": lambda M, A: M.DenseRank(),
    "percent_rank": lambda M, A: M.PercentRank(),
    "cume_dist": lambda M, A: M.CumeDist(),
    "ntile3": lambda M, A: M.NTile(3),
    "lag_v": lambda M, A: M.Lag(A.UnresolvedAttribute("v"), 1, A.to_expr(None)),
    "lead_v2": lambda M, A: M.Lead(A.UnresolvedAttribute("v"), 2, A.to_expr(-7)),
}


def _window_case(M, A, Agg, name: str):
    if name in _FUNCS:
        return _FUNCS[name](M, A), None
    agg, frame = name.split("@")
    fn = {"sum": Agg.Sum, "count": Agg.Count, "avg": Agg.Average,
          "min": Agg.Min, "max": Agg.Max}[agg](A.UnresolvedAttribute("f" if agg in ("avg", "max") else "v"))
    lo, hi = {"running": (M.UNBOUNDED_PRECEDING, M.CURRENT_ROW),
              "bounded": (-2, 1),
              "whole": (M.UNBOUNDED_PRECEDING, M.UNBOUNDED_FOLLOWING),
              "suffix": (M.CURRENT_ROW, M.UNBOUNDED_FOLLOWING)}[frame]
    return fn, M.WindowFrame("rows", lo, hi)


@pytest.mark.parametrize(
    "name",
    list(_FUNCS) + [f"{a}@{f}" for a in ("sum", "count", "avg", "min", "max")
                    for f in ("running", "bounded", "whole", "suffix")],
)
def test_compute_window_column_matches_jax(name):
    """One window column over a sorted, tie-heavy batch (7 segments, 4 order
    values, so peers are many): the port's ``compute_window_column`` and
    the JAX ``_compute_window_column`` on the same segment and peer
    bounds."""
    rng = np.random.default_rng(73)
    n = 200
    k, o, v, vvalid, f = _sorted_window_inputs(rng, n)
    pad = CAP - n

    def padded(x, fill=0):
        return np.concatenate([x, np.full(pad, fill, dtype=x.dtype)])

    live = np.arange(CAP) < n
    seg_start = np.zeros(CAP, bool)
    seg_start[0] = True
    seg_start[1:n] = k[1:] != k[:-1]
    peer_start = seg_start.copy()
    peer_start[1:n] |= o[1:] != o[:-1]
    seg_start[n] = peer_start[n] = True
    idx = np.arange(CAP)

    def firsts(s):
        return np.maximum.accumulate(np.where(s, idx, 0))

    def lasts(s):
        ends = np.append(s[1:], True)
        return np.ascontiguousarray(np.minimum.accumulate(np.where(ends, idx, CAP - 1)[::-1])[::-1])

    bounds = (seg_start, firsts(seg_start), lasts(seg_start), peer_start, firsts(peer_start), lasts(peer_start))
    cols = {"k": (padded(k), live), "o": (padded(o), live), "v": (padded(v), padded(vvalid, False)),
            "f": (padded(f), live)}
    fields = [("k", "LONG"), ("o", "LONG"), ("v", "LONG"), ("f", "DOUBLE")]

    def run(T, M, A, Agg, mk_col, mk_batch, to_dev, fn_call, idx_dtype):
        schema = T.Schema([T.StructField(nm, getattr(T, t)) for nm, t in fields])
        batch = mk_batch(schema, [mk_col(getattr(T, t), *cols[nm]) for nm, t in fields])
        ctx = A.Ctx.for_device(batch)
        fn, frame = _window_case(M, A, Agg, name)
        spec = M.WindowSpec((A.BoundReference(0, T.LONG, False),),
                            (M.WindowOrder(A.BoundReference(1, T.LONG, False)),), frame)
        we = M.WindowExpression(A.bind(fn, schema), spec)
        b = [to_dev(x, idx_dtype) for x in bounds]
        return fn_call(we, ctx, schema, CAP, to_dev(live, None), b[0], b[1], b[2], b[3], b[4], b[5],
                       to_dev(idx, idx_dtype))

    got = run(PT, PW, PB, PA,
              lambda dt, d, vv: DeviceColumn(dt, torch.from_numpy(d), torch.from_numpy(vv)),
              lambda s, c: DeviceBatch(s, c, torch.tensor(n, dtype=torch.int32)),
              lambda x, dt: torch.from_numpy(x) if x.dtype == bool else torch.from_numpy(x.astype(np.int64)),
              pwin.compute_window_column, None)
    want = run(JT, JW, JB, JA,
               lambda dt, d, vv: JColumn(dt, jnp.asarray(d), jnp.asarray(vv)),
               lambda s, c: JBatch(s, c, jnp.int32(n)),
               lambda x, dt: jnp.asarray(x) if x.dtype == bool else jnp.asarray(x, jnp.int32),
               jwin._compute_window_column, None)
    gv, wv = got.validity.numpy()[:n], np.asarray(want.validity)[:n]
    np.testing.assert_array_equal(gv, wv, err_msg=name)
    gd, wd = got.data.numpy()[:n][gv], np.asarray(want.data)[:n][wv]
    assert str(got.data.dtype).split(".")[-1] == str(np.asarray(want.data).dtype), name
    if gd.dtype.kind == "f":
        np.testing.assert_allclose(gd, wd, rtol=1e-9, atol=1e-11, err_msg=name)
    else:
        np.testing.assert_array_equal(gd, wd, err_msg=name)
