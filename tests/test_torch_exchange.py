"""The port's exchange slice (spark_rapids_tpu_torch/ops/hash.py,
ops/gather.py::partition_slices, ops/concat.py, plan/partitioning.py,
plan/pruning.py; GpuShuffleExchangeExec, GpuUnionExec, GpuLimitExec and the
upload cache of HostToDeviceExec) against the JAX package, on the CPU at a
small size.

* Murmur3: the port's torch path bit for bit against the JAX ``murmur3_rows``
  on JAX-CPU and against ``tests/golden/golden_murmur3.json``.
* ``partition_slices`` and the range helpers (after ``to_uint64`` for the
  words) against the JAX functions; the device exchange's range bounds
  against the JAX device engine's.
* Mirrors of ``tests/test_partitioning.py``, ``tests/test_limits_expand.py::
  test_limit`` and ``tests/test_basic_ops.py::test_union_and_limit``: the
  port (device="cpu", strict mode, nothing allowed off the device) against
  the JAX device engine on JAX-CPU and the JAX CPU engine.
* The upload cache (reuse, no writes into cached tensors, eviction, one
  upload under concurrent queries) and column pruning.
* The port's CPU engine gives Spark's ``min(+inf, NaN) = +inf``.

Inputs come from numpy seeds and enter both packages as the same arrays."""
from __future__ import annotations

import hashlib
import math
import threading

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; absent on a machine with only the port

import jax.numpy as jnp  # noqa: E402
import pyarrow as pa  # noqa: E402

import spark_rapids_tpu.functions as JF  # noqa: E402
import spark_rapids_tpu.types as JT  # noqa: E402
from data_gen import gen_table  # noqa: E402
from harness import _normalize, _values_equal, cpu_session, tpu_session  # noqa: E402
from spark_rapids_tpu.columnar.device import DeviceBatch as JBatch  # noqa: E402
from spark_rapids_tpu.columnar.device import DeviceColumn as JColumn  # noqa: E402
from spark_rapids_tpu.ops import gather as jgather  # noqa: E402
from spark_rapids_tpu.ops import hash as jhash  # noqa: E402
from spark_rapids_tpu.ops import sortkeys as jsk  # noqa: E402
from spark_rapids_tpu.plan import logical as JL  # noqa: E402
from spark_rapids_tpu.plan import partitioning as jpart  # noqa: E402
from spark_rapids_tpu.plan.pruning import prune_columns as jax_prune  # noqa: E402
from spark_rapids_tpu.tpch.datagen import gen_table as jax_gen_table  # noqa: E402
from spark_rapids_tpu_torch import TorchSession  # noqa: E402
from spark_rapids_tpu_torch import functions as PF  # noqa: E402
from spark_rapids_tpu_torch import types as PT  # noqa: E402
from spark_rapids_tpu_torch.columnar.device import DeviceBatch, DeviceColumn  # noqa: E402
from spark_rapids_tpu_torch.exec import gpu as G  # noqa: E402
from spark_rapids_tpu_torch.ops import gather as pgather  # noqa: E402
from spark_rapids_tpu_torch.ops import hash as phash  # noqa: E402
from spark_rapids_tpu_torch.ops import sortkeys as psk  # noqa: E402
from spark_rapids_tpu_torch.plan import logical as PL  # noqa: E402
from spark_rapids_tpu_torch.plan import partitioning as ppart  # noqa: E402
from spark_rapids_tpu_torch.plan.pruning import prune_columns as port_prune  # noqa: E402
from spark_rapids_tpu_torch.tpch.datagen import gen_orders_lineitem  # noqa: E402
from spark_rapids_tpu_torch.tpch.queries import SLICE_QUERIES  # noqa: E402
from spark_rapids_tpu_torch.xp import namespace  # noqa: E402

N = 300
SF = 0.002


# ── columns: the same arrays in both packages ──────────────────────────────


def _strings(rng, n: int, width: int):
    """A zero-padded ``uint8[n, width]`` plane and its lengths: empty
    strings, multi-byte UTF-8 (bytes >= 0x80, so the tail bytes sign-extend),
    interior NULs, and rows that fill the plane."""
    pool = [b"", b"a", b"ab", b"abc", b"abcd", "héllo".encode(), "日本".encode(),
            b"a\x00b", b"\x00", b"\xff\xfe\x80", bytes(range(200, 200 + width % 50))]
    pool += [bytes(rng.integers(0, 256, rng.integers(0, width + 1)).astype(np.uint8))
             for _ in range(30)]
    pool.append(bytes(rng.integers(0, 256, width).astype(np.uint8)))
    pool = [p[:width] for p in pool]
    plane = np.zeros((n, width), dtype=np.uint8)
    lengths = np.zeros(n, dtype=np.int32)
    for i, k in enumerate(rng.integers(0, len(pool), n)):
        plane[i, : len(pool[k])] = np.frombuffer(pool[k], dtype=np.uint8)
        lengths[i] = len(pool[k])
    return plane, lengths


def _column(tname: str, seed: int, n: int = N, width: int = 16):
    """(type name, data, validity, lengths) with nulls and the type's
    special values; data and lengths are zeroed under nulls, as device
    batches hold them."""
    rng = np.random.default_rng(seed)
    valid = rng.random(n) >= 0.15
    lengths = None
    if tname == "STRING":
        data, lengths = _strings(rng, n, width)
        lengths = np.where(valid, lengths, 0).astype(np.int32)
        data = np.where(valid[:, None], data, 0).astype(np.uint8)
    elif tname in ("DOUBLE", "FLOAT"):
        dt = np.float64 if tname == "DOUBLE" else np.float32
        specials = np.array([np.nan, -np.nan, 0.0, -0.0, np.inf, -np.inf, 1.5], dtype=np.float64)
        sp = rng.random(n) < 0.3
        data = np.where(sp, specials[rng.integers(0, len(specials), n)],
                        rng.standard_normal(n) * 1e3).astype(dt)
        # NaNs with other payloads must hash as the canonical NaN
        if dt == np.float64:
            bits = np.array([0x7FF0000000000123, 0xFFF8000000000001], np.uint64)
        else:
            bits = np.array([0x7F800123, 0xFFC00001], np.uint32)
        data[:2] = bits.view(dt)
        valid[:2] = True
        data = np.where(valid, data, 0).astype(dt)
    elif tname == "BOOLEAN":
        data = np.where(valid, rng.random(n) < 0.5, False)
    elif tname == "INT":
        data = rng.integers(-(2**31), 2**31, n).astype(np.int32)
        data[:4] = [0, -1, 2**31 - 1, -(2**31)]
        data = np.where(valid, data, 0).astype(np.int32)
    elif tname == "DATE":
        data = np.where(valid, rng.integers(-20000, 40000, n), 0).astype(np.int32)
    else:  # LONG
        data = rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64)
        data[:4] = [0, -1, 2**63 - 1, -(2**63)]
        data = np.where(valid, data, 0).astype(np.int64)
    return tname, data, valid, lengths


def _port_cols(cols):
    return [
        (getattr(PT, t), torch.from_numpy(d.copy()), torch.from_numpy(v.copy()),
         None if lens is None else torch.from_numpy(lens.copy()))
        for t, d, v, lens in cols
    ]


def _np_cols(cols):
    return [(getattr(PT, t), d, v, lens) for t, d, v, lens in cols]


def _jax_cols(cols):
    return [
        (getattr(JT, t), jnp.asarray(d), jnp.asarray(v), None if lens is None else jnp.asarray(lens))
        for t, d, v, lens in cols
    ]


# ── murmur3 ────────────────────────────────────────────────────────────────

_HASH_CASES = {
    "int": [("INT", 1)],
    "long": [("LONG", 2)],
    "float": [("FLOAT", 3)],
    "double": [("DOUBLE", 4)],
    "boolean": [("BOOLEAN", 5)],
    "date": [("DATE", 6)],
    "string_w8": [("STRING", 7, 8)],
    "string_w130": [("STRING", 8, 130)],
    "fold_of_five": [("LONG", 9), ("STRING", 10, 16), ("DOUBLE", 11), ("INT", 12), ("BOOLEAN", 13)],
}


@pytest.mark.parametrize("case", list(_HASH_CASES))
def test_murmur3_rows_matches_jax(case):
    """Row hashes over torch tensors equal the JAX ``murmur3_rows`` on
    JAX-CPU bit for bit, nulls leaving the running hash unchanged; then
    ``partition_ids`` (negative hashes included) too."""
    cols = [_column(t, seed, width=w[0] if w else 16) for t, seed, *w in _HASH_CASES[case]]
    got = phash.murmur3_rows(namespace("cpu"), _port_cols(cols), N)
    want = np.asarray(jhash.murmur3_rows(jnp, _jax_cols(cols), N))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the numpy path of the CPU engine agrees as well
    np.testing.assert_array_equal(phash.murmur3_rows(np, _np_cols(cols), N), want)
    assert (want < 0).any()
    for nparts in (1, 3, 8, 200):
        np.testing.assert_array_equal(
            phash.partition_ids(namespace("cpu"), got, nparts).numpy(),
            np.asarray(jhash.partition_ids(jnp, jnp.asarray(want), nparts)),
        )


def _golden_rows(engine: str):
    """``tests/test_golden.py::test_golden_murmur3``'s queries through the
    port: (got, expected, what) per fixture group."""
    from test_golden import _ARROW, _decode, _load

    if engine == "cpu":
        s = TorchSession({"spark.rapids.sql.enabled": False}, device="cpu")
    else:
        s = TorchSession(
            {"spark.rapids.sql.enabled": True, "spark.rapids.sql.test.enabled": True}, device="cpu"
        )
    cases = _load("golden_murmur3.json")
    by_type: dict = {}
    for c in cases:
        if c["op"] == "hash":
            by_type.setdefault(c["type"], []).append(c)
    out = []
    for typ, cs in by_type.items():
        t = pa.table({"c": pa.array([_decode(c["input"], typ) for c in cs], type=_ARROW[typ])})
        rows = s.create_dataframe(t).select(PF.hash(PF.col("c")).alias("r")).collect()
        out.append(([r[0] for r in rows], [c["expected"] for c in cs], f"hash({typ})"))
    for c in cases:
        if c["op"] == "hash2":
            t = pa.table({
                "a": pa.array([c["inputs"][0]], type=_ARROW[c["types"][0]]),
                "b": pa.array([c["inputs"][1]], type=_ARROW[c["types"][1]]),
            })
            rows = s.create_dataframe(t).select(PF.hash(PF.col("a"), PF.col("b")).alias("r")).collect()
            out.append(([rows[0][0]], [c["expected"]], "hash2"))
    return s, out


@pytest.mark.parametrize("engine", ["cpu", "device"])
def test_golden_murmur3(engine):
    s, groups = _golden_rows(engine)
    for got, want, what in groups:
        assert got == want, f"{what} [{engine}]"
    if engine == "device":
        assert all(e.on_device for e in s._last_overrides.explain if not e.node.startswith("CpuScan"))


# ── partition_slices and the range helpers ─────────────────────────────────


def _batch_pair(cols, num_rows: int):
    """(port DeviceBatch, JAX DeviceBatch) over the same arrays."""
    pschema = PT.Schema([PT.StructField(f"c{i}", getattr(PT, c[0])) for i, c in enumerate(cols)])
    jschema = JT.Schema([JT.StructField(f"c{i}", getattr(JT, c[0])) for i, c in enumerate(cols)])
    pcols = [DeviceColumn(dt, d, v, lens) for dt, d, v, lens in _port_cols(cols)]
    jcols = [JColumn(dt, d, v, lens) for dt, d, v, lens in _jax_cols(cols)]
    pb = DeviceBatch(pschema, pcols, torch.tensor(num_rows, dtype=torch.int32))
    jb = JBatch(jschema, jcols, jnp.asarray(num_rows, jnp.int32))
    return pb, jb


@pytest.mark.parametrize("fused", [False, True])
def test_partition_slices_matches_jax(fused):
    """The same partition ids (and fused liveness) slice into the same rows,
    in the same order, with the same counts."""
    cols = [_column("LONG", 20), _column("STRING", 21, width=16), _column("DOUBLE", 22)]
    n = 250  # the last 50 rows are padding
    pb, jb = _batch_pair(cols, n)
    rng = np.random.default_rng(23)
    pids = rng.integers(0, 5, N).astype(np.int32)
    live = rng.random(N) < 0.6 if fused else None
    got = pgather.partition_slices(
        pb, torch.from_numpy(pids), 5, None if live is None else torch.from_numpy(live)
    )
    want = jgather.partition_slices(jb, jnp.asarray(pids), 5, None if live is None else jnp.asarray(live))
    assert len(got) == len(want) == 5
    for p, (g, w) in enumerate(zip(got, want)):
        k = int(w.num_rows)
        assert int(g.num_rows) == k and g.capacity == w.capacity
        for gc, wc in zip(g.columns, w.columns):
            np.testing.assert_array_equal(gc.validity.numpy(), np.asarray(wc.validity), f"slice {p}")
            np.testing.assert_array_equal(gc.data.numpy()[:k], np.asarray(wc.data)[:k], f"slice {p}")
            if wc.lengths is not None:
                np.testing.assert_array_equal(gc.lengths.numpy()[:k], np.asarray(wc.lengths)[:k])


@pytest.mark.parametrize("ascending", [True, False])
def test_range_words_bounds_and_ids_match_jax(ascending):
    """Two batches whose string column pads to different widths (8 and 16
    bytes): the aligned words (after ``to_uint64``), the bounds from their
    sample and each row's partition id equal the JAX functions' — on the
    device words and on the CPU engine's numpy twin."""
    batches = [
        [_column("STRING", 30, width=8), _column("INT", 31)],
        [_column("STRING", 32, width=16), _column("INT", 33)],
    ]
    porders = [PL.SortOrder(None, ascending, None), PL.SortOrder(None, True, None)]
    jorders = [JL.SortOrder(None, ascending, None), JL.SortOrder(None, True, None)]
    pgroups, jgroups, npgroups, jnpgroups = [], [], [], []
    for cols in batches:
        pb, jb = _batch_pair(cols, N)
        pgroups.append([psk.column_radix_words(c, o.ascending, True) for c, o in zip(pb.columns, porders)])
        jgroups.append([jsk.column_radix_words(c, o.ascending, True) for c, o in zip(jb.columns, jorders)])
        # the CPU engine's twin over the same values (strings as the padded plane)
        npgroups.append([psk.np_column_radix_words(c.dtype, c.data.numpy(), c.validity.numpy(),
                                                   None if c.lengths is None else c.lengths.numpy(),
                                                   o.ascending, True)
                         for c, o in zip(pb.columns, porders)])
        jnpgroups.append([jsk.np_column_radix_words(c.dtype, np.asarray(c.data), np.asarray(c.validity),
                                                    None if c.lengths is None else np.asarray(c.lengths),
                                                    o.ascending, True)
                          for c, o in zip(jb.columns, jorders)])
    for mine, theirs, xp in ((pgroups, jgroups, jnp), (npgroups, jnpgroups, np)):
        got, gt = ppart.align_word_groups(mine, porders)
        want, wt = jpart.align_word_groups(theirs, jorders, xp)
        assert gt == wt and wt[0] == 4  # validity, two char words, length
        for g, w in zip(got, want):
            assert [psk.to_uint64(x).tolist() for x in g] == [np.asarray(x).tolist() for x in w]
        # re-padding a narrow batch's flat words to wider targets
        wider = [t + 2 for t in gt]
        repad = ppart.pad_flat_words(got[0], gt, wider, porders)
        jrepad = jpart.pad_flat_words(want[0], wt, wider, jorders, xp)
        assert [psk.to_uint64(x).tolist() for x in repad] == [np.asarray(x).tolist() for x in jrepad]
        sample = [np.concatenate([np.asarray(psk.to_uint64(b[i]).view(np.int64) ^ np.int64(psk.WORD_MIN))
                                  for b in got])[::7] for i in range(len(got[0]))]
        jsample = [np.concatenate([np.asarray(b[i]) for b in want])[::7] for i in range(len(want[0]))]
        bounds = ppart.compute_range_bounds(sample, 6)
        jbounds = jpart.compute_range_bounds(jsample, 6)
        assert [psk.to_uint64(b).tolist() for b in bounds] == [b.tolist() for b in jbounds]
        for g, w in zip(got, want):
            words = g if xp is np else list(g)
            pb_ = bounds if xp is np else [torch.from_numpy(b) for b in bounds]
            pids = ppart.words_partition_ids(words, pb_)
            jpids = jpart.words_partition_ids(xp, w, jbounds if xp is np else [jnp.asarray(b) for b in jbounds])
            pids = pids if xp is np else pids.numpy()
            np.testing.assert_array_equal(pids, np.asarray(jpids))
            assert len(set(pids.tolist())) > 3


def _capture_bounds(monkeypatch, module) -> list:
    seen = []
    real = module.compute_range_bounds

    def capture(words, nparts):
        out = real(words, nparts)
        seen.append(out)
        return out

    monkeypatch.setattr(module, "compute_range_bounds", capture)
    return seen


# ── mirrors of tests/test_partitioning.py, test_limit, test_union_and_limit ─


def _table(n=500, seed=11):
    rng = np.random.default_rng(seed)
    return pa.table(
        {
            "k": pa.array(rng.integers(-50, 50, n).astype(np.int64)),
            "v": pa.array(rng.random(n)),
            "s": pa.array([f"g{int(x)}" for x in rng.integers(0, 30, n)]),
        }
    )


def _mirror_session(conf=None):
    """The port's device session as ``harness.tpu_session`` configures the
    JAX one: strict mode, nothing allowed off the device, 8 shuffle
    partitions unless the case sets its own."""
    return TorchSession(
        {
            "spark.rapids.sql.enabled": True,
            "spark.rapids.sql.test.enabled": True,
            "spark.sql.shuffle.partitions": 8,
            **(conf or {}),
        },
        device="cpu",
    )


def _assert_rows(got, want, sort_result, what):
    a, b = _normalize(got, sort_result), _normalize(want, sort_result)
    assert len(a) == len(b), f"{what}: {len(a)} vs {len(b)} rows\n{a[:5]}\n{b[:5]}"
    for i, (ra, rb) in enumerate(zip(a, b)):
        assert len(ra) == len(rb) and all(
            _values_equal(x, y, False) for x, y in zip(ra, rb)
        ), f"{what} row {i}: {ra} vs {rb}"


def _mirror_cases():
    """(id, build(F, session), conf, sort_result) per reference test."""
    cases = []
    t = _table()
    cases.append(("round_robin_repartition_preserves_rows",
                  lambda F, s, t=t: s.create_dataframe(t, num_partitions=3).repartition(5), {}, True))
    cases.append(("hash_repartition_by_key",
                  lambda F, s, t=t: s.create_dataframe(t, num_partitions=3).repartition(4, "k"),
                  {}, True))
    t = _table(n=2000)
    cases.append(("global_sort_via_range_partitioning_multi_partition",
                  lambda F, s, t=t: s.create_dataframe(t, num_partitions=4).sort(
                      "k", "v", ascending=[False, True]),
                  {"spark.sql.shuffle.partitions": "6"}, False))
    vals = ["zeta", None, "alpha", "beta", None, "omega", "a", "zz", ""] * 30
    t = pa.table({"s": pa.array(vals), "i": pa.array(range(len(vals)))})
    cases.append(("global_sort_strings_desc_nulls",
                  lambda F, s, t=t: s.create_dataframe(t, num_partitions=3).sort(
                      "s", "i", ascending=[False, True]),
                  {"spark.sql.shuffle.partitions": "4"}, False))
    short = [f"s{i % 7}" for i in range(300)]
    long_ = [f"long-string-{i % 13:04d}" for i in range(300)]
    t = pa.table({"s": pa.array(short + long_), "i": pa.array(range(600))})
    cases.append(("range_partition_mixed_string_widths",
                  lambda F, s, t=t: s.create_dataframe(t, num_partitions=2).sort("s", "i"),
                  {"spark.sql.shuffle.partitions": "4"}, False))
    t = gen_table([("a", JT.INT)], 300, seed=50)
    for n in (0, 1, 10, 500):
        cases.append((f"limit[{n}]",
                      lambda F, s, t=t, n=n: s.create_dataframe(t, num_partitions=3).limit(n),
                      {}, True))
    t = gen_table([("a", JT.INT), ("s", JT.STRING)], 100, seed=10)
    cases.append(("union_and_limit",
                  lambda F, s, t=t: s.create_dataframe(t, num_partitions=3).union(
                      s.create_dataframe(t, num_partitions=3)).limit(150),
                  {}, True))
    return cases


_MIRRORS = _mirror_cases()


@pytest.mark.parametrize("case", _MIRRORS, ids=[c[0] for c in _MIRRORS])
def test_exchange_union_limit_mirror(case, monkeypatch):
    """Each case's rows through the port's device path equal the JAX device
    engine's and the JAX CPU engine's. Where the case range-partitions a
    long and a double key, the device exchange's bounds also equal the JAX
    device engine's: both sample each batch at ``arange(128) * n // 128``
    (the CPU engines sample every ``n // 128``-th row and pick other bounds;
    the sorted rows must not differ)."""
    name, build, conf, sort_result = case
    pseen = _capture_bounds(monkeypatch, G)
    jseen = _capture_bounds(monkeypatch, jpart)
    port = _mirror_session(conf)
    got = build(PF, port).collect()
    off = [e.node for e in port._last_overrides.explain if not e.on_device]
    assert all(n.startswith("CpuScan") for n in off), off
    _assert_rows(got, build(JF, tpu_session(conf)).collect(), sort_result, "JAX device")
    if name == "global_sort_via_range_partitioning_multi_partition":
        assert len(pseen) == len(jseen) == 1
        assert [psk.to_uint64(b).tolist() for b in pseen[0]] == [b.tolist() for b in jseen[0]]
    _assert_rows(got, build(JF, cpu_session(conf)).collect(), sort_result, "JAX CPU")


def _round_robin_sizes(C, P, schema, ExecContext, TpuConf, t, device_exec):
    """Bucket sizes of a round-robin exchange into 4 over 2 scan partitions;
    ``device_exec`` is (exchange class, upload class) for a device engine."""
    scan = C.CpuScanExec(t, schema, 2)
    child = device_exec[1](scan) if device_exec else scan
    ex = (device_exec[0] if device_exec else C.CpuShuffleExchangeExec)(
        P.RoundRobinPartitioning(4), child)
    # the port's context has no default device
    kw = {"device": "cpu"} if ExecContext.__module__.startswith("spark_rapids_tpu_torch") else {}
    parts = ex.execute(ExecContext(TpuConf({}), **kw)).materialize()
    return [sum(int(b.num_rows) for b in p) for p in parts]


def test_round_robin_spreads_rows_mirror():
    """The distribution property of tests/test_partitioning.py: round-robin
    buckets are balanced — and the port's device exchange, the JAX device
    exchange and the JAX CPU exchange give the same bucket sizes."""
    from spark_rapids_tpu.config import TpuConf as JConf
    from spark_rapids_tpu.exec import cpu as JC
    from spark_rapids_tpu.exec import tpu as JX
    from spark_rapids_tpu.plan.physical import ExecContext as JCtx
    from spark_rapids_tpu_torch.columnar.host import from_arrow
    from spark_rapids_tpu_torch.config import TpuConf as PConf
    from spark_rapids_tpu_torch.exec import cpu as PC
    from spark_rapids_tpu_torch.plan.physical import ExecContext as PCtx

    t = _table(n=400)
    host = from_arrow(t)
    port = _round_robin_sizes(PC, ppart, host.schema, PCtx, PConf, host,
                              (G.GpuShuffleExchangeExec, G.HostToDeviceExec))
    jschema = JT.Schema.from_arrow(t.schema)
    jdev = _round_robin_sizes(JC, jpart, jschema, JCtx, JConf, t,
                              (JX.TpuShuffleExchangeExec, JX.HostToDeviceExec))
    jcpu = _round_robin_sizes(JC, jpart, jschema, JCtx, JConf, t, None)
    assert port == jdev == jcpu
    assert sum(port) == 400 and min(port) >= 90 and max(port) <= 110


def test_single_partition_exchange_shrinks_into_one_partition():
    """The single-partition exchange gathers every input batch into
    partition 0, each shrunk to the capacity its live rows need (the port
    plans it under an ungrouped aggregate over several partitions)."""
    from spark_rapids_tpu_torch.columnar.host import from_arrow
    from spark_rapids_tpu_torch.config import TpuConf
    from spark_rapids_tpu_torch.exec import cpu as PC
    from spark_rapids_tpu_torch.plan.physical import ExecContext

    host = from_arrow(_table(n=400))
    scan = PC.CpuScanExec(host, host.schema, 3)
    filt = G.GpuFilterExec((PF.col("k") == 7).expr, G.HostToDeviceExec(scan))
    ex = G.GpuShuffleExchangeExec(ppart.SinglePartitioning(1), filt)
    (part,) = ex.execute(ExecContext(TpuConf({}), device="cpu")).materialize()
    want = int((np.asarray(_table(n=400).column("k")) == 7).sum())
    assert len(part) == 3 and sum(int(b.num_rows) for b in part) == want
    assert all(b.capacity == max(8, 1 << (int(b.num_rows) - 1).bit_length()) for b in part)


def test_range_bounds_quantiles():
    """tests/test_partitioning.py's quantile case, in the port's int64 words."""
    u = np.asarray([5, 1, 9, 3, 7, 2, 8, 4, 6, 0], dtype=np.uint64)
    words = [(u ^ np.uint64(1 << 63)).view(np.int64)]
    bounds = ppart.compute_range_bounds(words, 4)
    assert [int(b) for b in psk.to_uint64(bounds[0])] == [2, 5, 7]
    pids = ppart.words_partition_ids(words, bounds)
    assert pids.tolist() == [1, 0, 3, 1, 2, 0, 3, 1, 2, 0]
    tpids = ppart.words_partition_ids([torch.from_numpy(words[0])], [torch.from_numpy(bounds[0])])
    assert tpids.tolist() == pids.tolist() and tpids.dtype == torch.int32
    assert ppart.compute_range_bounds([np.zeros(0, dtype=np.int64)], 4) is None


# ── the upload cache and column pruning ────────────────────────────────────


@pytest.fixture(scope="module")
def tables():
    o, l = gen_orders_lineitem(SF)
    return {"orders": o, "lineitem": l}


def _session(conf=None):
    return TorchSession(
        {"spark.rapids.sql.enabled": True, "spark.rapids.sql.test.enabled": True,
         "spark.sql.shuffle.partitions": 2, **(conf or {})},
        device="cpu",
    )


def _run(session, tables, name, parts=3):
    return SLICE_QUERIES[name][0](
        lambda t: session.create_dataframe(tables[t], num_partitions=parts)).collect()


def _cached_tensors(session) -> list:
    out = []
    for entry in session._h2d_cache.values():
        for batches in entry["parts"]:
            for b in batches or []:
                for c in b.columns:
                    out.extend(x for x in (c.data, c.validity, c.lengths) if x is not None)
    return out


def _checksum(tensors) -> str:
    h = hashlib.sha256()
    for x in tensors:
        h.update(x.contiguous().numpy().tobytes())
    return h.hexdigest()


def test_upload_cache_reuses_device_tensors(tables, monkeypatch):
    """The second collect of a query uploads nothing: the scan's batches are
    the cached tensors (same storage), and hostToDeviceBytes counts 0."""
    uploads = []
    real = G.host_to_device
    monkeypatch.setattr(G, "host_to_device", lambda *a, **k: uploads.append(1) or real(*a, **k))
    s = _session()
    first = _run(s, tables, "q1")
    cold_bytes, cold_uploads = s._last_metrics["hostToDeviceBytes"], len(uploads)
    ptrs = [x.data_ptr() for x in _cached_tensors(s)]
    assert cold_bytes > 0 and cold_uploads == 3 and len(s._h2d_cache) == 1
    seen = []
    real_coalesce = G.GpuCoalesceBatchesExec.execute

    def spy(self, ctx):
        parts = real_coalesce(self, ctx)
        return parts.map_partitions(lambda it: (seen.append(b) or b for b in it))

    monkeypatch.setattr(G.GpuCoalesceBatchesExec, "execute", spy)
    second = _run(s, tables, "q1")
    assert second == first
    assert s._last_metrics["hostToDeviceBytes"] == 0 and len(uploads) == cold_uploads
    assert [x.data_ptr() for x in _cached_tensors(s)] == ptrs
    assert {c.data.data_ptr() for b in seen for c in b.columns} <= set(ptrs)


def test_cached_tensors_unchanged_by_queries(tables):
    """No operator writes into a cached input: the cached tensors' checksums
    are the same after every slice query has run twice over them."""
    s = _session()
    for name in SLICE_QUERIES:
        _run(s, tables, name)
    before = _checksum(_cached_tensors(s))
    rows = {name: _run(s, tables, name) for name in SLICE_QUERIES}
    rows2 = {name: _run(s, tables, name) for name in SLICE_QUERIES}
    assert rows == rows2
    assert _checksum(_cached_tensors(s)) == before


def test_tiny_upload_cache_budget_evicts(tables):
    s = _session({"spark.rapids.tpu.uploadCache.maxBytes": 1})
    _run(s, tables, "q1")
    _run(s, tables, "q6")
    assert len(s._h2d_cache) == 1  # q6's entry evicted q1's
    _run(s, tables, "q1")
    assert s._last_metrics["hostToDeviceBytes"] > 0


def test_concurrent_queries_upload_each_partition_once(tables, monkeypatch):
    """Queries racing on one session upload each partition once (single
    flight), and each gets the right rows."""
    uploads = []
    lock = threading.Lock()
    real = G.host_to_device

    def counting(*a, **k):
        with lock:
            uploads.append(1)
        return real(*a, **k)

    monkeypatch.setattr(G, "host_to_device", counting)
    want = _run(_session(), tables, "q6")
    single = len(uploads)
    uploads.clear()
    s = _session()
    results, errors = [], []
    old = __import__("sys").getswitchinterval()
    __import__("sys").setswitchinterval(1e-5)
    try:
        def work():
            try:
                results.append(_run(s, tables, "q6"))
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(e)

        threads = [threading.Thread(target=work) for _ in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
    finally:
        __import__("sys").setswitchinterval(old)
    assert not errors, errors
    assert len(results) == 4 and all(r == want for r in results)
    assert len(uploads) == single


def _scan_names(plan, relation_cls) -> list:
    out = []

    def walk(p):
        if isinstance(p, relation_cls):
            out.append(list(p.schema.names))
        for c in p.children():
            walk(c)

    walk(plan)
    return out


@pytest.mark.parametrize("name", list(SLICE_QUERIES))
def test_prune_columns_matches_jax(name, tables):
    """Each slice query's scans keep the columns the JAX ``prune_columns``
    keeps, and q1 and q6 upload 7 and 4 lineitem columns, not 16."""
    from test_torch_slice import _jax_query

    port = _session()
    plan = SLICE_QUERIES[name][0](lambda t: port.create_dataframe(tables[t]))._plan
    jt = {n: jax_gen_table(n, 0.0002) for n in SLICE_QUERIES[name][1]}
    jsess = cpu_session()
    jplan = _jax_query(name)(lambda t: jsess.create_dataframe(jt[t]))._plan
    got = _scan_names(port_prune(plan), PL.LocalRelation)
    assert got == _scan_names(jax_prune(jplan), JL.LocalRelation)
    if name in ("q1", "q6"):
        assert [len(g) for g in got] == [7 if name == "q1" else 4]


# ── ROADMAP Queue C: min(+inf, NaN) in the port's CPU engine ───────────────


def test_cpu_engine_min_inf_with_nan_is_inf():
    """``tests/test_aggregates.py::test_min_inf_with_nan_is_inf``'s data
    through the port's CPU engine: Spark's NaN-greatest order gives +inf,
    and NaN only for an all-NaN group, grouped and ungrouped."""
    s = TorchSession({"spark.rapids.sql.enabled": False}, device="cpu")
    t = {"g": np.array([1, 1, 2, 2], dtype=np.int64),
         "v": np.array([math.inf, math.nan, math.nan, math.nan])}
    rows = sorted(s.create_dataframe(t).group_by("g").agg(PF.min(PF.col("v")).alias("m")).collect())
    assert rows[0] == (1, math.inf) and rows[1][0] == 2 and math.isnan(rows[1][1])
    ung = s.create_dataframe({"v": np.array([math.inf, math.nan])}).agg(
        PF.min(PF.col("v")).alias("m")).collect()
    assert ung == [(math.inf,)]
    both = s.create_dataframe({"v": np.array([math.inf, math.nan, -1.0])}).agg(
        PF.min(PF.col("v")), PF.max(PF.col("v"))).collect()
    assert both[0][0] == -1.0 and math.isnan(both[0][1])
