"""The port's grouped aggregation and sort (spark_rapids_tpu_torch/ops/
sortkeys.py, scan.py, aggregate.py; GpuHashAggregateExec, GpuSortExec)
against the JAX package, on the CPU at a small size.

* Radix words: after un-flipping (``to_uint64``), the port's int64 words
  equal the JAX package's uint64 words bit for bit; ``sort_permutation``
  and ``merge_permutation`` give the JAX package's permutations exactly.
* ``segscan`` against the JAX ``segscan``: integers exact, floats within
  rel 1e-12.
* ``group_aggregate`` on one batch against the JAX ``group_aggregate`` on
  JAX-CPU: keys and integer aggregates exact, floats within the harness's
  tolerance (rel 1e-9, abs 1e-11).
* Mirrors of ``tests/test_aggregates.py`` and ``tests/test_sort.py`` over the
  same ``data_gen`` tables and queries: the port (device="cpu", strict
  mode, every node on the device) against the JAX engine
  each reference test holds its device rows to (``_check_mirror``).

Inputs come from numpy seeds and enter both packages as the same arrays."""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; absent on a machine with only the port

import jax.numpy as jnp  # noqa: E402
import pyarrow as pa  # noqa: E402

import spark_rapids_tpu.functions as JF  # noqa: E402
import spark_rapids_tpu.types as JT  # noqa: E402
from data_gen import gen_grouped_table, gen_table  # noqa: E402
from harness import _normalize, _values_equal, cpu_session, tpu_session  # noqa: E402
from spark_rapids_tpu.columnar.device import DeviceBatch as JBatch  # noqa: E402
from spark_rapids_tpu.columnar.device import DeviceColumn as JColumn  # noqa: E402
from spark_rapids_tpu.ops import aggregate as jagg  # noqa: E402
from spark_rapids_tpu.ops import scan as jscan  # noqa: E402
from spark_rapids_tpu.ops import sortkeys as jsk  # noqa: E402
from spark_rapids_tpu.plan import logical as JL  # noqa: E402
from spark_rapids_tpu.session import DataFrame as JDataFrame  # noqa: E402
from spark_rapids_tpu_torch import TorchSession  # noqa: E402
from spark_rapids_tpu_torch import functions as PF  # noqa: E402
from spark_rapids_tpu_torch import types as PT  # noqa: E402
from spark_rapids_tpu_torch.columnar.device import DeviceBatch, DeviceColumn  # noqa: E402
from spark_rapids_tpu_torch.ops import aggregate as pagg  # noqa: E402
from spark_rapids_tpu_torch.ops import scan as pscan  # noqa: E402
from spark_rapids_tpu_torch.ops import sortkeys as psk  # noqa: E402
from spark_rapids_tpu_torch.plan import logical as PL  # noqa: E402
from spark_rapids_tpu_torch.session import DataFrame as PDataFrame  # noqa: E402

N = 300
CAP = 512


# ── column pairs: the same arrays in both packages ─────────────────────────


def _pair(tname: str, data: np.ndarray, valid: np.ndarray, lengths=None):
    """(port DeviceColumn, JAX DeviceColumn) over the same numpy arrays."""
    pc = DeviceColumn(
        getattr(PT, tname),
        torch.from_numpy(data.copy()),
        torch.from_numpy(valid.copy()),
        None if lengths is None else torch.from_numpy(lengths.copy()),
    )
    jc = JColumn(
        getattr(JT, tname),
        jnp.asarray(data),
        jnp.asarray(valid),
        None if lengths is None else jnp.asarray(lengths),
    )
    return pc, jc


def _strings(rng, n, width, low_card=False):
    """A zero-padded ``uint8[n, width]`` plane with empty strings, multi-byte
    UTF-8 (bytes >= 0x80, also in the top byte of a word) and interior NULs."""
    pool = [b"", b"a", b"ab", b"abc", "héllo".encode(), "é".encode(), b"a\x00b",
            b"a\x00", b"\xff\xfe", b"zz", "日本".encode()]
    if not low_card:
        pool += [bytes(rng.integers(0, 256, rng.integers(0, width + 1)).astype(np.uint8))
                 for _ in range(40)]
    pool = [p[:width] for p in pool]
    pick = rng.integers(0, len(pool), n)
    plane = np.zeros((n, width), dtype=np.uint8)
    lengths = np.zeros(n, dtype=np.int32)
    for i, k in enumerate(pick):
        b = pool[k]
        plane[i, : len(b)] = np.frombuffer(b, dtype=np.uint8)
        lengths[i] = len(b)
    return plane, lengths


def _column(tname: str, seed: int, n: int = N, width: int = 16, low_card=False):
    """A column of ``tname`` with nulls (data zeroed under them, as device
    batches hold them) and the type's special values."""
    rng = np.random.default_rng(seed)
    valid = rng.random(n) >= 0.15
    lengths = None
    if tname == "STRING":
        data, lengths = _strings(rng, n, width, low_card)
        lengths = np.where(valid, lengths, 0).astype(np.int32)
        data = np.where(valid[:, None], data, 0).astype(np.uint8)
    elif tname in ("DOUBLE", "FLOAT"):
        dt = np.float64 if tname == "DOUBLE" else np.float32
        base = np.round(rng.standard_normal(n) * 4) if low_card else rng.standard_normal(n) * 1e3
        specials = np.array(
            [np.nan, -np.nan, 0.0, -0.0, np.inf, -np.inf, 1.5, -1.5], dtype=np.float64
        )
        sp = rng.random(n) < 0.3
        data = np.where(sp, specials[rng.integers(0, len(specials), n)], base).astype(dt)
        # a NaN with another payload must collapse with the canonical one
        if dt == np.float64:
            bits = np.array([0x7FF0000000000123, 0xFFF8000000000001, 0x7FF8000000000000], np.uint64)
        else:
            bits = np.array([0x7F800123, 0xFFC00001, 0x7FC00000], np.uint32)
        data[:3] = bits.view(dt)
    elif tname == "BOOLEAN":
        data = rng.random(n) < 0.5
    else:
        dt = {"INT": np.int32, "DATE": np.int32, "LONG": np.int64}[tname]
        info = np.iinfo(dt)
        hi = 5 if low_card else info.max
        lo = -5 if low_card else info.min
        data = rng.integers(lo, hi, n, endpoint=True, dtype=np.int64).astype(dt)
        if not low_card:
            data[:4] = [info.min, info.max, 0, -1]
    if tname != "STRING":
        data = np.where(valid, data, np.zeros((), data.dtype))
    return _pair(tname, data, valid, lengths)


def _assert_words_equal(pwords, jwords):
    assert len(pwords) == len(jwords)
    for k, (pw, jw) in enumerate(zip(pwords, jwords)):
        np.testing.assert_array_equal(psk.to_uint64(pw), np.asarray(jw), err_msg=f"word {k}")


_TYPES = ["INT", "LONG", "DOUBLE", "FLOAT", "STRING8", "STRING130", "BOOLEAN", "DATE"]


def _typed_column(t: str, seed: int, low_card=False):
    if t.startswith("STRING"):
        return _column("STRING", seed, width=int(t[6:]), low_card=low_card)
    return _column(t, seed, low_card=low_card)


@pytest.mark.parametrize("nulls_first", [True, False])
@pytest.mark.parametrize("ascending", [True, False])
@pytest.mark.parametrize("t", _TYPES)
def test_column_radix_words_match_jax(t, ascending, nulls_first):
    pc, jc = _typed_column(t, seed=len(t) * 7 + ascending)
    _assert_words_equal(
        psk.column_radix_words(pc, ascending, nulls_first),
        jsk.column_radix_words(jc, ascending, nulls_first),
    )
    # the classic widened layout the string min/max and the join read
    _assert_words_equal(
        psk.column_radix_words(pc, ascending, nulls_first, value_only=True),
        jsk.column_radix_words(jc, ascending, nulls_first, value_only=True),
    )


def _pad_pair(t, pc):
    pad = CAP - N
    arrs = []
    for x in (pc.data, pc.validity, pc.lengths):
        if x is None:
            arrs.append(None)
            continue
        x = x.numpy()
        arrs.append(np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)]))
    return _pair(t, *arrs)


def _key_columns(types, seed):
    """Low-cardinality key columns padded to CAP rows (live rows first)."""
    pairs = [
        _pad_pair(t[:6] if t.startswith("STRING") else t,
                  _typed_column(t, seed + i, low_card=True)[0])
        for i, t in enumerate(types)
    ]
    return [p for p, _ in pairs], [j for _, j in pairs]


_KEY_SETS = [("INT",), ("STRING8", "DOUBLE"), ("LONG", "STRING130", "BOOLEAN", "FLOAT")]


@pytest.mark.parametrize("types", _KEY_SETS, ids="-".join)
def test_sort_and_merge_permutations_match_jax(types):
    """Ties everywhere (low-cardinality keys) and padding rows: the LSD
    passes must give the JAX package's permutation, and the two-run merge
    its merge."""
    pcs, jcs = _key_columns(types, seed=len(types))
    asc = [i % 2 == 0 for i in range(len(types))]
    nf = [i % 3 != 1 for i in range(len(types))]
    pw = psk.batch_radix_words(pcs, asc, nf)
    jw = jsk.batch_radix_words(jcs, asc, nf)
    _assert_words_equal(pw, jw)
    live = np.arange(CAP) < N
    perm = psk.sort_permutation(pw, torch.from_numpy(live))
    jperm = jsk.sort_permutation(jw, jnp.asarray(live))
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))

    # two runs, each sorted by the words: rows [0, na) and [na, na + nb)
    na, nb = 170, N - 170
    u = [psk.to_uint64(w) for w in pw]
    sa = np.lexsort([x[:na] for x in u][::-1])
    sb = na + np.lexsort([x[na:N] for x in u][::-1])
    order = np.concatenate([sa, sb, np.arange(N, CAP)])
    pw2 = [w[torch.from_numpy(order)] for w in pw]
    jw2 = [w[jnp.asarray(order)] for w in jw]
    mperm = psk.merge_permutation(pw2, torch.tensor(na, dtype=torch.int32), torch.tensor(nb))
    jmperm = jsk.merge_permutation(jw2, jnp.int32(na), jnp.int32(nb))
    np.testing.assert_array_equal(mperm.numpy(), np.asarray(jmperm))
    # the merge is a sort: merged words ascend lexicographically
    merged = np.stack([psk.to_uint64(w[mperm[:N]]) for w in pw2], axis=1)
    assert all(tuple(merged[i]) <= tuple(merged[i + 1]) for i in range(N - 1))


def _segments(seed, n=N):
    rng = np.random.default_rng(seed)
    starts = rng.random(n) < 0.08
    starts[0] = True
    return starts


@pytest.mark.parametrize("op", ["add", "min", "max"])
@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.float64])
def test_segscan_matches_jax(op, dtype):
    rng = np.random.default_rng(5)
    starts = _segments(6)
    if dtype == np.float64:
        # a small segment behind a large one: a cumsum-minus-start scan
        # would lose the small one's digits
        vals = rng.standard_normal(N) * np.where(rng.random(N) < 0.3, 1e12, 1.0)
    else:
        info = np.iinfo(dtype)
        vals = rng.integers(info.min, info.max, N, endpoint=True, dtype=np.int64).astype(dtype)
    jop = {"add": jnp.add, "min": jnp.minimum, "max": jnp.maximum}[op]
    want = np.asarray(jax.jit(lambda v, f: jscan.segscan(v, f, jop))(vals, starts))
    got = pscan.segscan(torch.from_numpy(vals), torch.from_numpy(starts), op).numpy()
    assert got.dtype == want.dtype
    if dtype == np.float64:
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    else:
        np.testing.assert_array_equal(got, want)


def test_first_k_positions_and_seg_end_flags_match_jax():
    flags = _segments(7)
    np.testing.assert_array_equal(
        pscan.first_k_positions(torch.from_numpy(flags)).numpy(),
        np.asarray(jscan.first_k_positions(jnp.asarray(flags))),
    )
    np.testing.assert_array_equal(
        pscan.seg_end_flags(torch.from_numpy(flags)).numpy(),
        np.asarray(jscan.seg_end_flags(jnp.asarray(flags))),
    )


# ── group_aggregate on one batch ────────────────────────────────────────────

_AGGS = [  # (column type, op)
    ("LONG", "sum"),
    ("DOUBLE", "sum"),
    ("LONG", "count"),
    ("STRING", "count"),
    ("INT", "min"),
    ("LONG", "max"),
    ("DOUBLE", "min"),
    ("DOUBLE", "max"),
    ("FLOAT", "min"),
    ("STRING", "min"),
    ("STRING", "max"),
    ("DOUBLE", "first"),
    ("STRING", "last"),
    ("INT", "first_ignore_nulls"),
    ("DOUBLE", "last_ignore_nulls"),
]


def _assert_col_close(pc, jc, n, what):
    """Live prefix of two aggregate columns: validity exact; data exact for
    integers and strings, within rel 1e-9 / abs 1e-11 for floats."""
    pv, jv = pc.validity.numpy()[:n], np.asarray(jc.validity)[:n]
    np.testing.assert_array_equal(pv, jv, err_msg=what)
    pd, jd = pc.data.numpy()[:n][pv], np.asarray(jc.data)[:n][jv]
    if pd.dtype.kind == "f":
        assert np.array_equal(np.isnan(pd), np.isnan(jd)), what
        np.testing.assert_allclose(pd[~np.isnan(pd)], jd[~np.isnan(jd)], rtol=1e-9, atol=1e-11,
                                   err_msg=what)
    else:
        np.testing.assert_array_equal(pd, jd, err_msg=what)
    if pc.lengths is not None:
        np.testing.assert_array_equal(pc.lengths.numpy()[:n][pv], np.asarray(jc.lengths)[:n][jv],
                                      err_msg=what)


@pytest.mark.parametrize("fused", [False, True], ids=["row_mask", "live_mask"])
def test_group_aggregate_matches_jax(fused):
    """Keys of three kinds (a string, a double with NaN and -0.0, an int, all
    with nulls), every op but the collect family."""
    types = ("STRING8", "DOUBLE", "INT")
    pkeys, jkeys = _key_columns(types, seed=11)
    pin, jin, ops = [], [], []
    for i, (t, op) in enumerate(_AGGS):
        pc, jc = _pad_pair(t, _column(t, 40 + i, low_card=t == "STRING")[0])
        pin.append(pc)
        jin.append(jc)
        ops.append(op)
    live = np.arange(CAP) < N
    if fused:
        live &= np.random.default_rng(3).random(CAP) < 0.7
    pschema = PT.Schema([PT.StructField(f"k{i}", k.dtype) for i, k in enumerate(pkeys)])
    jschema = JT.Schema([JT.StructField(f"k{i}", k.dtype) for i, k in enumerate(jkeys)])
    pb = DeviceBatch(pschema, pkeys, torch.tensor(N, dtype=torch.int32))
    jb = JBatch(jschema, jkeys, jnp.int32(N))
    ords = list(range(len(types)))
    pk, pa_, png = pagg.group_aggregate(
        pb, ords, pin, ops, live_mask=torch.from_numpy(live) if fused else None
    )
    jk, ja, jng = jax.jit(
        lambda b, cols, m: jagg.group_aggregate(b, ords, cols, ops, live_mask=m)
    )(jb, jin, jnp.asarray(live) if fused else None)
    ng = int(png)
    assert ng == int(jng) and ng > 1
    for i, (p, j) in enumerate(zip(pk, jk)):
        _assert_col_close(p, j, ng, f"key {i}")
    for (t, op), p, j in zip(_AGGS, pa_, ja):
        assert str(p.dtype) == str(j.dtype) or (op == "count" and p.dtype == PT.LONG)
        _assert_col_close(p, j, ng, f"{op}({t})")
        assert not p.validity.numpy()[ng:].any()


def test_min_over_inf_and_nan_is_inf_and_long_sums_wrap():
    """Spark: min(+inf, NaN) = +inf, NaN only for an all-NaN group; a long
    sum wraps; count is never null, also for an all-null group."""
    keys = np.array([1, 1, 2, 2, 3, 3, 0, 0], dtype=np.int64)
    v = np.array([np.inf, np.nan, np.nan, np.nan, 1.0, 2.0, 0, 0])
    big = np.array([2**62, 2**62, 1, 2, 5, 6, 0, 0], dtype=np.int64)
    live = np.arange(8) < 6
    pk, _ = _pair("LONG", keys, live)
    pv, _ = _pair("DOUBLE", v, live)
    pbig, _ = _pair("LONG", big, live)
    pnull, _ = _pair("LONG", big, np.zeros(8, dtype=bool))
    b = DeviceBatch(PT.Schema([PT.StructField("k", PT.LONG)]), [pk], torch.tensor(6, dtype=torch.int32))
    _, (mn, mx, s, c), ng = pagg.group_aggregate(
        b, [0], [pv, pv, pbig, pnull], ["min", "max", "sum", "count"]
    )
    assert int(ng) == 3
    assert mn.data[0] == math.inf and math.isnan(mn.data[1]) and mn.data[2] == 1.0
    assert math.isnan(mx.data[0]) and math.isnan(mx.data[1]) and mx.data[2] == 2.0
    assert int(s.data[0]) == -(2**63)  # 2**62 + 2**62 wraps
    assert c.validity[:3].all() and not c.data[:3].any()


# ── mirrors of tests/test_aggregates.py and tests/test_sort.py ─────────────


# two exchange partitions in every engine: each is one run of the final
# aggregate
_FEW_PARTS = {"spark.sql.shuffle.partitions": 2}


def _port_session(enabled=True):
    if not enabled:
        return TorchSession({"spark.rapids.sql.enabled": False}, device="cpu")
    return TorchSession(
        {
            "spark.rapids.sql.enabled": True,
            "spark.rapids.sql.test.enabled": True,
            **_FEW_PARTS,
        },
        device="cpu",
    )


def _check_mirror(build, sort_result=True, approx_float=False, port_rows=None, engine="cpu"):
    """``build(F, session)`` over each package: the port's device path
    against the JAX engine the reference test holds its device rows to,
    rows compared as ``harness.assert_cpu_and_tpu_equal`` compares them.

    That engine is the JAX CPU engine: the reference test asserts it equal
    to the JAX device engine on the identical table and query, so a port
    equal to it is equal to both — and running the JAX device engine here
    again would cost seconds of XLA compiles a case. Where the reference
    test reads the device engine alone (``engine="device"``), the mirror
    does the same."""
    got = build(PF, _port_session()).collect() if port_rows is None else port_rows
    if engine == "device":
        want = build(JF, tpu_session(_FEW_PARTS)).collect()
    else:
        want = build(JF, cpu_session(_FEW_PARTS)).collect()
    a, b = _normalize(got, sort_result), _normalize(want, sort_result)
    assert len(a) == len(b), f"JAX {engine}: {len(a)} vs {len(b)} rows\n{a[:5]}\n{b[:5]}"
    for i, (ra, rb) in enumerate(zip(a, b)):
        assert len(ra) == len(rb) and all(
            _values_equal(x, y, approx_float) for x, y in zip(ra, rb)
        ), f"JAX {engine} engine row {i}: port {ra} vs {rb}"
    return got


def _df(F, s, t, parts=3):
    return s.create_dataframe(t, num_partitions=parts)


_INT_TYPES = ["BYTE", "SHORT", "INT", "LONG", "FLOAT", "DOUBLE"]


def _agg_cases():
    """(id, build, kwargs) for each test of tests/test_aggregates.py, one
    case per parameter."""
    cases = []
    for dt in _INT_TYPES:
        t = gen_grouped_table([("v", getattr(JT, dt))], 500, num_groups=20, seed=20)
        cases.append((
            f"groupby_sum_count[{dt.lower()}]",
            lambda F, s, t=t: _df(F, s, t).group_by("k").agg(
                F.sum(F.col("v")).alias("s"), F.count(F.col("v")).alias("c"),
                F.count("*").alias("cs")),
            {"approx_float": dt in ("FLOAT", "DOUBLE")},
        ))
    for dt in ("INT", "LONG", "DOUBLE"):
        t = gen_grouped_table([("v", getattr(JT, dt))], 400, num_groups=15, seed=21)
        cases.append((
            f"groupby_min_max[{dt.lower()}]",
            lambda F, s, t=t: _df(F, s, t).group_by("k").agg(
                F.min(F.col("v")).alias("mn"), F.max(F.col("v")).alias("mx")),
            {},
        ))
    nan = float("nan")
    t = pa.table({"k": [1, 1, 1, 2, 2, 3, 3], "v": [1.0, nan, 2.0, nan, nan, None, 5.0]})
    cases.append(("groupby_min_max_nan", lambda F, s, t=t: _df(F, s, t).group_by("k").agg(
        F.min(F.col("v")).alias("mn"), F.max(F.col("v")).alias("mx")), {}))
    t = gen_grouped_table([("v", JT.INT)], 500, num_groups=12, seed=22)
    cases.append(("groupby_avg", lambda F, s, t=t: _df(F, s, t).group_by("k").agg(
        F.avg(F.col("v")).alias("a")), {"approx_float": True}))
    t = gen_table([("s", JT.STRING), ("v", JT.LONG)], 400, seed=23)
    cases.append(("groupby_string_key", lambda F, s, t=t: _df(F, s, t).group_by("s").agg(
        F.sum(F.col("v")).alias("sv"), F.count("*").alias("c")), {}))
    t = gen_grouped_table([("k2", JT.INT), ("v", JT.LONG)], 600, num_groups=8, seed=24)
    cases.append(("groupby_multi_key", lambda F, s, t=t: _df(F, s, t).group_by("k", "k2").agg(
        F.sum(F.col("v")).alias("s"), F.count("*").alias("c")), {}))
    t = pa.table({"k": [0.0, -0.0, nan, nan, 1.0, None], "v": [1, 2, 3, 4, 5, 6]})
    cases.append(("groupby_float_key_normalization", lambda F, s, t=t: _df(F, s, t).group_by(
        "k").agg(F.sum(F.col("v")).alias("s")), {}))
    t = gen_table([("v", JT.LONG)], 300, seed=25)
    cases.append(("reduction_no_groups", lambda F, s, t=t: _df(F, s, t).agg(
        F.sum(F.col("v")).alias("s"), F.count("*").alias("c"), F.min(F.col("v")).alias("m")), {}))
    t = pa.table({"v": pa.array([], type=pa.int64())})
    cases.append(("reduction_empty_input", lambda F, s, t=t: _df(F, s, t, parts=1).agg(
        F.sum(F.col("v")).alias("s"), F.count("*").alias("c")), {}))
    t = gen_grouped_table([("v", JT.LONG)], 400, num_groups=10, seed=26)
    cases.append(("groupby_expression_key_and_result", lambda F, s, t=t: _df(F, s, t).group_by(
        (F.col("k") % 3).alias("km")).agg((F.sum(F.col("v")) + F.count("*")).alias("sc")), {}))
    t = gen_table([("v", JT.INT)], 250, seed=27)
    cases.append(("count_dataframe", lambda F, s, t=t: _df(F, s, t).filter(
        F.col("v").is_not_null()).agg(F.count("*").alias("c")), {}))
    inf = float("inf")
    t = pa.table({"g": [1, 1, 2, 2], "v": [inf, nan, nan, nan]})
    # as tests/test_aggregates.py checks it: against the device engine (the
    # JAX CPU engine gives NaN for min(+inf, NaN); the port's gives +inf)
    cases.append(("min_inf_with_nan_is_inf", lambda F, s, t=t: _df(F, s, t, parts=1).group_by(
        "g").agg(F.min(F.col("v")).alias("m")), {"engine": "device"}))
    t = gen_grouped_table([("s", JT.STRING)], 400, num_groups=7, seed=17)
    cases.append(("string_min_max_on_device", lambda F, s, t=t: _df(F, s, t).group_by("k").agg(
        F.min(F.col("s")).alias("mn"), F.max(F.col("s")).alias("mx")), {}))
    cases.append(("string_min_max_on_device[ungrouped]", lambda F, s, t=t: _df(F, s, t, 2).agg(
        F.min(F.col("s")).alias("mn"), F.max(F.col("s")).alias("mx")), {}))
    t = pa.table({"k": [1, 1, 1, 2, 2, 2], "s": ["", "abc", None, "héllo", "zz", "hé"]})
    cases.append(("string_min_max_multibyte_and_empty", lambda F, s, t=t: _df(
        F, s, t, parts=1).group_by("k").agg(F.min(F.col("s")).alias("mn"),
                                             F.max(F.col("s")).alias("mx")), {}))
    t = pa.table({"k": [1, 1, 1], "s": ["xx", "", "ab"]})

    def residual(F, s, t=t):
        # s == 'xx' → NULL, but the branch leaves 'xx' bytes behind the
        # invalid slot on the device (with_column as a select)
        df = _df(F, s, t, parts=1).select(
            F.col("k"), F.when(F.col("s") == "xx", F.lit(None)).otherwise(F.col("s")).alias("s2"))
        return df.group_by("k").agg(F.max(F.col("s2")).alias("mx"), F.min(F.col("s2")).alias("mn"))

    cases.append(("string_max_null_rows_with_residual_bytes_lose", residual, {}))
    return cases


_AGG_CASES = _agg_cases()


@pytest.mark.parametrize("case", _AGG_CASES, ids=[c[0] for c in _AGG_CASES])
def test_aggregates_mirror(case):
    _, build, kw = case
    got = _check_mirror(build, **kw)
    if case[0] == "min_inf_with_nan_is_inf":
        rows = sorted(got)
        assert rows[0][1] == math.inf and math.isnan(rows[1][1])
        ung = PF.min(PF.col("v")).alias("m")
        s = _port_session()
        one = s.create_dataframe({"v": np.array([math.inf, math.nan])}).agg(ung).collect()
        assert one[0][0] == math.inf
    if case[0] == "string_max_null_rows_with_residual_bytes_lose":
        assert got == [(1, "ab", "")]


def _sort_df(F, s, t, order, parts):
    """A global sort with explicit SortOrders, through each package's
    logical plan (as tests/test_sort.py builds its nulls-first/last case)."""
    L, DF = (PL, PDataFrame) if F is PF else (JL, JDataFrame)
    df = s.create_dataframe(t, num_partitions=parts)
    return DF(s, L.Sort([L.SortOrder(F.col(c).expr, a, nf) for c, a, nf in order], True, df._plan))


def _sort_cases():
    cases = []
    for dt in ("INT", "LONG", "DOUBLE", "STRING"):
        for asc in (True, False):
            t = gen_table([("v", getattr(JT, dt)), ("x", JT.INT)], 300, seed=60,
                          special_fraction=0.2)
            cases.append((f"sort_single_column[{str(asc)}-{dt.lower()}]",
                          lambda F, s, t=t, asc=asc: s.create_dataframe(
                              t, num_partitions=3).sort("v", ascending=asc)))
    t = gen_table([("a", JT.INT), ("b", JT.DOUBLE), ("s", JT.STRING)], 400, seed=61)
    cases.append(("sort_multi_column", lambda F, s, t=t: s.create_dataframe(
        t, num_partitions=2).sort("a", "s", ascending=[True, False])))
    t = gen_table([("v", JT.INT)], 100, seed=62, null_fraction=0.3)
    for nf in (True, False):
        cases.append((f"sort_nulls_first_last[{nf}]",
                      lambda F, s, t=t, nf=nf: _sort_df(F, s, t, [("v", True, nf)], 2)))
    nan = float("nan")
    t = pa.table({"v": [1.0, nan, -0.0, None, float("inf"), -float("inf"), 0.0, nan]})
    for asc in (True, False):
        cases.append((f"sort_nan_greatest[{asc}]",
                      lambda F, s, t=t, asc=asc: s.create_dataframe(t).sort("v", ascending=asc)))
    t = gen_table([("a", JT.INT), ("b", JT.INT)], 200, seed=64)
    cases.append(("sort_by_expression", lambda F, s, t=t: s.create_dataframe(
        t, num_partitions=2).sort((F.col("a") % 7).alias("m"), "b")))
    return cases


_SORT_CASES = _sort_cases()


@pytest.mark.parametrize("case", _SORT_CASES, ids=[c[0] for c in _SORT_CASES])
def test_sort_mirror(case):
    _check_mirror(case[1], sort_result=False)


def test_sort_stability_via_limit_mirror():
    """tests/test_sort.py's sort + limit: the port plans it as top-N, as the
    JAX engines do, and runs it on the device (``GpuTakeOrderedAndProject``:
    a stable sort and head per partition, then of the partials); the first
    20 rows equal the JAX engine's only if that sort is stable."""
    t = gen_table([("v", JT.INT), ("x", JT.LONG)], 500, seed=63)
    port = _port_session()
    df = port.create_dataframe(t, num_partitions=3).sort("v").limit(20)
    got = df.collect()
    assert "GpuTakeOrderedAndProject" in df.explain()
    _check_mirror(lambda F, s: s.create_dataframe(t, num_partitions=3).sort("v").limit(20),
                  sort_result=False, port_rows=got)
