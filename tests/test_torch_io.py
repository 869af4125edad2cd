"""The port's I/O layer (``spark_rapids_tpu_torch/io/``) against the JAX
package's, and its native host plane (``spark_rapids_tpu_torch/native.py``)
against the JAX loader of the same ``native/srt_host.cc``.

* ``tests/test_io.py`` runs unchanged, with its harness names swapped as
  ``tests/test_torch_dataframe_api.py`` swaps them, and ``cpu_session``
  (which the suite writes its files with) pointed at the port's CPU engine:
  the port writes every file, the JAX CPU engine and the port's device
  engine (``device="cpu"``, test mode) read them, and the rows are held
  equal; ``_find_scan`` finds the port's ``CpuFileScanExec``. Its ORC cases
  wait for ROADMAP item 10b (:data:`NOT_IN_SLICE`); its one case that builds
  the JAX scan exec directly is ported by hand here
  (:data:`PORTED_HERE`).
* ``tests/test_native.py``'s cases, each ported here (:data:`NATIVE`):
  murmur3 and ``pmod`` bit-identical to the numpy path and to the JAX
  loader, frames byte for byte with the JAX loader's, the allocator, the
  ``.srtf`` spill; ``rows_decode`` waits for item 10b.
* CSV inference over a grid of column kinds, held to the JAX reader.
"""
from __future__ import annotations

import importlib
import inspect
import os

import numpy as np
import pytest
import torch

pytest.importorskip("jax")  # the reference; absent on a machine with only the port

import pyarrow as pa  # noqa: E402

from tests.test_torch_dataframe_api import (  # noqa: E402
    PortSession,
    _finder,
    _param_sets,
    assert_jax_cpu_and_port_equal,
    run_reference,
)

#: reference cases not mirrored, each with the ROADMAP item it waits for
NOT_IN_SLICE = {
    "test_io::test_write_read_round_trip[orc]": "ORC reader and writer (item 10b)",
    "test_io::test_orc_stripe_pruning_skips_stripes": "ORC stripe statistics (item 10b)",
    "test_io::test_orc_stripe_pruning_string_stats": "ORC stripe statistics (item 10b)",
    "test_io::test_orc_column_pruning_reads_subset": "ORC reader (item 10b)",
}

#: reference cases ported by hand in this file (name of the port test)
PORTED_HERE = {
    "test_io::test_reader_type_auto_selection": "test_reader_type_auto_selection",
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _port_cpu_session(extra=None):
    """``cpu_session``'s conf on the port's CPU engine."""
    conf = {"spark.rapids.sql.enabled": False}
    conf.update(extra or {})
    return PortSession(conf, strict=False)


def _io_cases():
    mod = importlib.import_module("test_io")
    out = []
    for fname, fn in inspect.getmembers(mod, inspect.isfunction):
        if not fname.startswith("test_") or fn.__module__ != mod.__name__:
            continue
        if f"test_io::{fname}" in NOT_IN_SLICE or f"test_io::{fname}" in PORTED_HERE:
            continue
        for kwargs, label in _param_sets(fn):
            case = f"test_io::{fname}" + (f"[{label}]" if label else "")
            if case in NOT_IN_SLICE:
                continue
            out.append(pytest.param(fname, kwargs, id=case))
    return out


IO_CASES = _io_cases()


def _patch_io(mod, monkeypatch) -> None:
    from spark_rapids_tpu.plan import planner as jax_planner
    from spark_rapids_tpu_torch.plan import planner as port_planner

    monkeypatch.setattr(mod, "assert_cpu_and_tpu_equal", assert_jax_cpu_and_port_equal)
    monkeypatch.setattr(mod, "tpu_session", PortSession)
    monkeypatch.setattr(mod, "cpu_session", _port_cpu_session)
    monkeypatch.setattr(mod, "_find_scan",
                        _finder("spark_rapids_tpu_torch.io.files:CpuFileScanExec"))
    jax_plan = jax_planner.plan_physical

    def plan_physical(lp, conf):
        # the coalescing case plans its DataFrame through the JAX planner's
        # module path: a port plan goes to the port's planner
        if type(lp).__module__.startswith("spark_rapids_tpu_torch."):
            return port_planner.plan_physical(lp, conf)
        return jax_plan(lp, conf)

    monkeypatch.setattr(jax_planner, "plan_physical", plan_physical)


@pytest.mark.parametrize("fname,kwargs", IO_CASES)
def test_io_mirror(fname, kwargs, monkeypatch, request):
    mod = importlib.import_module("test_io")
    _patch_io(mod, monkeypatch)
    run_reference(mod, getattr(mod, fname), kwargs, request)


def test_io_mirror_covers_the_suite():
    """Every case of ``tests/test_io.py`` is mirrored, ported here or waits
    for a named item; every name listed exists."""
    mod = importlib.import_module("test_io")
    mirrored = {p.id for p in IO_CASES}
    for fname, fn in inspect.getmembers(mod, inspect.isfunction):
        if not fname.startswith("test_") or fn.__module__ != mod.__name__:
            continue
        key = f"test_io::{fname}"
        for _kw, label in _param_sets(fn):
            case = key + (f"[{label}]" if label else "")
            assert case in mirrored or case in NOT_IN_SLICE or key in NOT_IN_SLICE \
                or key in PORTED_HERE, case
    for key in NOT_IN_SLICE:
        assert hasattr(mod, key.split("::")[1].split("[")[0]), key
    here = importlib.import_module(__name__)
    for target in PORTED_HERE.values():
        assert hasattr(here, target), target
    for why in NOT_IN_SLICE.values():
        assert "item 10b" in why, why


def test_reader_type_auto_selection(tmp_path):
    """AUTO (the default, like the reference): COALESCING for local paths,
    MULTITHREADED when a path scheme is in spark.rapids.cloudSchemes; the
    ``readerType`` option pins one — as the JAX scan chooses."""
    import pyarrow.parquet as pq

    from spark_rapids_tpu.config import TpuConf as JConf
    from spark_rapids_tpu.io.files import CpuFileScanExec as JScan
    from spark_rapids_tpu.types import LONG as JLONG
    from spark_rapids_tpu.types import Schema as JSchema
    from spark_rapids_tpu.types import StructField as JField
    from spark_rapids_tpu_torch.config import TpuConf
    from spark_rapids_tpu_torch.io.files import CpuFileScanExec
    from spark_rapids_tpu_torch.types import LONG, Schema, StructField

    p = str(tmp_path / "t.parquet")
    pq.write_table(pa.table({"x": [1, 2, 3]}), p)
    sch = Schema([StructField("x", LONG, True)])
    jsch = JSchema([JField("x", JLONG, True)])
    for files, opts, want in (
        ([p], {}, "COALESCING"),
        (["s3a://bucket/t.parquet"], {}, "MULTITHREADED"),
        (["S3A://bucket/t.parquet"], {}, "MULTITHREADED"),
        ([p], {"readerType": "PERFILE"}, "PERFILE"),
    ):
        got = CpuFileScanExec(files, "parquet", sch, opts, TpuConf({})).reader_type
        assert got == want == JScan(files, "parquet", jsch, opts, JConf({})).reader_type
    custom = TpuConf({"spark.rapids.cloudSchemes": "myfs"})
    assert CpuFileScanExec(["myfs://x/t.parquet"], "parquet", sch, {},
                           custom).reader_type == "MULTITHREADED"


# ── the files of a multi-file scan, planned as several partitions ──────────


def test_multi_file_aggregate_merges_partitions(tmp_path):
    """A PERFILE scan of several files is several partitions: an ungrouped
    aggregate over it merges them (the JAX planner counts a file scan as one
    partition; the port counts its files)."""
    from spark_rapids_tpu_torch.functions import col, count, sum as sum_

    t = pa.table({"x": np.arange(300), "k": np.arange(300) % 3})
    s = _port_cpu_session()
    s.create_dataframe(t, num_partitions=3).write.parquet(str(tmp_path / "m"))
    for conf in ({}, {"spark.rapids.sql.enabled": True}):
        s2 = PortSession(conf)
        df = s2.read.option("readerType", "PERFILE").parquet(str(tmp_path / "m"))
        assert df.agg(sum_(col("x")).alias("s"), count(col("k")).alias("n")).collect() \
            == [(sum(range(300)), 300)]
        rows = sorted(df.group_by("k").agg(count(col("x")).alias("n")).collect())
        assert rows == [(0, 100), (1, 100), (2, 100)]


# ── CSV inference, held to the JAX reader ──────────────────────────────────

CSV_KINDS = {
    "ints": ["1", "-2", "30"],
    "bools": ["true", "False", "TRUE"],
    "ones_and_true": ["1", "0", "true"],
    "ones": ["1", "0", "1"],
    "floats": ["1.5", "NaN", "-inf"],
    "int_and_float": ["1", "2.5", "3"],
    "dates": ["2020-01-02", "1999-12-31", "0001-01-01"],
    "timestamps": ["2020-01-02 03:04:05", "2020-01-02T03:04:05.123", "2020-01-02T03"],
    "zoned": ["1970-01-01 00:00:00Z", "2020-01-02 03:04:05+01:00", "2021-01-01T00:00Z"],
    "zone_mixed": ["2020-01-02 03:04:05", "2020-01-02 03:04:05Z", "2020-01-02 03:04"],
    "date_and_ts": ["2020-01-02", "2020-01-02 03:04", "2020-01-03"],
    "strings": ["a", "b,c", 'q"x'],
    "mixed": ["1", "a", "2020-01-01"],
    "all_null": ["", "", ""],
    "some_null": ["1", "", "3"],
    "too_big": ["99999999999999999999", "1", "2"],
    "times": ["12:34:56", "01:02:03", "23:59"],
}


def _csv_line(v: str) -> str:
    return '"' + v.replace('"', '""') + '"' if ("," in v or '"' in v) else v


@pytest.mark.parametrize("kind", sorted(CSV_KINDS))
def test_csv_inference_grid(kind, tmp_path):
    from tests.harness import cpu_session

    p = str(tmp_path / f"{kind}.csv")
    with open(p, "w") as f:
        f.write("c,n\n" + "".join(f"{_csv_line(v)},{i}\n" for i, v in enumerate(CSV_KINDS[kind])))

    def read(s):
        return s.read.option("header", "true").csv(p)

    try:
        jax = read(cpu_session())
    except Exception as e:  # the JAX reader's own refusal: the port's is alike
        with pytest.raises(type(e)):
            read(_port_cpu_session())
        return
    port = read(_port_cpu_session())
    assert repr(port.schema) == repr(jax.schema)
    assert_jax_cpu_and_port_equal(read)


def test_csv_options_and_writer(tmp_path):
    """``sep``, no header (``f0``, ``f1``), a ``schema``, ``nullValue``; and
    the port's CSV writer read back by the JAX reader to the same rows."""
    from tests.harness import cpu_session
    from spark_rapids_tpu.types import DOUBLE, LONG, STRING, Schema, StructField

    p = str(tmp_path / "x.csv")
    with open(p, "w") as f:
        f.write("1;2.5;a\n2;;NA\n")
    for opts in ({"sep": ";"}, {"sep": ";", "nullValue": "NA"},
                 {"sep": ";", "schema": Schema([StructField("a", LONG), StructField("b", DOUBLE),
                                                StructField("c", STRING)])}):
        def read(s, opts=opts):
            r = s.read
            for k, v in opts.items():
                r = r.option(k, v)
            return r.csv(p)

        assert repr(read(_port_cpu_session()).schema) == repr(read(cpu_session()).schema)
        assert_jax_cpu_and_port_equal(read)
    from spark_rapids_tpu_torch.io.csv import read_csv

    assert read_csv(p, {"sep": ";"}).schema.names == ["f0", "f1", "f2"]
    import datetime as dt
    import decimal

    t = pa.table({
        "i": pa.array([1, None, -3]), "f": pa.array([1.5, float("nan"), None]),
        "s": pa.array(['x"y', None, "a,b\nc"]), "b": pa.array([True, None, False]),
        "d": pa.array([dt.date(2020, 1, 2), None, dt.date(1, 1, 1)]),
        "t": pa.array([dt.datetime(2021, 3, 4, 5, 6, 7, 890000), None, dt.datetime(1970, 1, 1)],
                      type=pa.timestamp("us", tz="UTC")),
        "m": pa.array([decimal.Decimal("1.25"), None, decimal.Decimal("-3.50")],
                      type=pa.decimal128(7, 2)),
    })
    out = str(tmp_path / "w")
    _port_cpu_session().create_dataframe(t).write.option("header", "true").csv(out)
    assert_jax_cpu_and_port_equal(lambda s: s.read.option("header", "true").csv(out))


# ── tests/test_native.py, ported ────────────────────────────────────────────

#: test_native case → the port test here, or the item it waits for
NATIVE = {
    "test_murmur3_matches_numpy": "test_native_murmur3_matches_numpy",
    "test_murmur3_strings_match_numpy": "test_native_murmur3_strings_match_numpy",
    "test_murmur3_rows_multi_column": "test_native_murmur3_rows_multi_column",
    "test_pmod_partition_ids": "test_native_pmod_partition_ids",
    "test_frame_roundtrip": "test_native_frame_roundtrip",
    "test_frame_malformed": "test_native_frame_malformed",
    "test_allocator_best_fit_and_coalesce": "test_native_allocator_best_fit_and_coalesce",
    "test_allocator_fragmentation_reuse": "test_native_allocator_fragmentation_reuse",
    "test_spill_disk_contiguous_frame": "test_native_spill_disk_contiguous_frame",
    "test_rows_decode_matches_python_path": "item 10b (rows_decode over HostBatch)",
    "test_rows_decode_collect_end_to_end": "item 10b (rows_decode over HostBatch)",
}


def test_native_suite_covered():
    mod = importlib.import_module("test_native")
    here = importlib.import_module(__name__)
    names = {f for f, fn in inspect.getmembers(mod, inspect.isfunction)
             if f.startswith("test_") and fn.__module__ == mod.__name__}
    assert names == set(NATIVE)
    for target in NATIVE.values():
        assert target.startswith("item 10b") or hasattr(here, target), target


def _hash_both(dt, data, valid, seed):
    """The port's hash_column with its native plane off, then on, and the
    JAX loader's murmur3 of the same column."""
    from spark_rapids_tpu import native as JN
    from spark_rapids_tpu_torch import native as PN
    from spark_rapids_tpu_torch.ops import hash as H

    PN.set_enabled(False)
    try:
        ref = H.hash_column(np, dt, data, valid, None, seed)
    finally:
        PN.set_enabled(True)
    got = H.hash_column(np, dt, data, valid, None, seed)
    return ref, got, JN


_MM3_COLUMNS = {
    "int": ("IntegerType", lambda r, n: r.integers(-(2**31), 2**31, n).astype(np.int32)),
    "short": ("ShortType", lambda r, n: r.integers(-(2**15), 2**15, n).astype(np.int16)),
    "date": ("DateType", lambda r, n: r.integers(-10000, 20000, n).astype(np.int32)),
    "long": ("LongType", lambda r, n: r.integers(-(2**62), 2**62, n).astype(np.int64)),
    "timestamp": ("TimestampType", lambda r, n: r.integers(0, 2**48, n).astype(np.int64)),
    "bool": ("BooleanType", lambda r, n: r.integers(0, 2, n).astype(bool)),
    "float": ("FloatType", lambda r, n: np.where(
        r.random(n) < 0.1, np.float32(-0.0), r.standard_normal(n).astype(np.float32))),
    "double": ("DoubleType", lambda r, n: np.where(r.random(n) < 0.1, np.nan,
                                                   r.standard_normal(n))),
}


@pytest.mark.parametrize("kind", sorted(_MM3_COLUMNS))
def test_native_murmur3_matches_numpy(kind):
    from spark_rapids_tpu import types as JT
    from spark_rapids_tpu.ops import hash as JH
    from spark_rapids_tpu_torch import native as PN
    from spark_rapids_tpu_torch import types as PT

    assert PN.available()
    cls, gen = _MM3_COLUMNS[kind]
    rng = np.random.default_rng(7)
    n = 4096
    data = gen(rng, n)
    valid = rng.random(n) > 0.15
    seed = np.uint32(42)
    ref, got, _ = _hash_both(getattr(PT, cls)(), data, valid, seed)
    assert np.array_equal(ref, got)
    assert np.array_equal(got, JH.hash_column(np, getattr(JT, cls)(), data, valid, None, seed))
    ref2, got2, _ = _hash_both(getattr(PT, cls)(), data, valid, ref)  # chained row seeds
    assert np.array_equal(ref2, got2)


def test_native_murmur3_strings_match_numpy():
    from spark_rapids_tpu_torch.types import STRING

    rng = np.random.default_rng(8)
    strs = np.array(["", "a", "ab", "abc", "abcd", "abcde"]
                    + [("xyz%d" % i) * (i % 11) for i in range(500)]
                    + ["ünïcødé", "日本語テキスト", "\x00\x01\xff"], dtype=object)
    valid = rng.random(len(strs)) > 0.2
    ref, got, _ = _hash_both(STRING, strs, valid, np.uint32(42))
    assert np.array_equal(ref, got)


def test_native_murmur3_rows_multi_column():
    from spark_rapids_tpu_torch import native as PN
    from spark_rapids_tpu_torch.ops import hash as H
    from spark_rapids_tpu_torch.types import DOUBLE, LONG, STRING

    rng = np.random.default_rng(9)
    n = 2000
    cols = [
        (LONG, rng.integers(0, 1000, n).astype(np.int64), rng.random(n) > 0.1, None),
        (DOUBLE, rng.standard_normal(n), rng.random(n) > 0.1, None),
        (STRING, np.array([f"k{i % 37}" for i in range(n)], dtype=object), np.ones(n, bool), None),
    ]
    PN.set_enabled(False)
    try:
        ref = H.murmur3_rows(np, cols, n)
    finally:
        PN.set_enabled(True)
    assert np.array_equal(ref, H.murmur3_rows(np, cols, n))


def test_native_pmod_partition_ids():
    from spark_rapids_tpu import native as JN
    from spark_rapids_tpu_torch import native as PN
    from spark_rapids_tpu_torch.ops import hash as H

    h = np.random.default_rng(10).integers(-(2**31), 2**31, 5000).astype(np.int32)
    PN.set_enabled(False)
    try:
        ref = H.partition_ids(np, h, 7)
    finally:
        PN.set_enabled(True)
    got = PN.pmod(h, 7)
    assert np.array_equal(ref, got) and np.array_equal(got, JN.pmod(h, 7))
    assert np.array_equal(H.partition_ids(np, h, 7), got)
    assert got.min() >= 0 and got.max() < 7


def _frame_buffers():
    return [b"", b"hello world", np.arange(1000, dtype=np.int64),
            np.random.default_rng(0).standard_normal(333), b"\x00" * 4097]


def test_native_frame_roundtrip():
    """Frames pack, stream and unpack byte for byte as the JAX loader's do."""
    import io as _io

    from spark_rapids_tpu import native as JN
    from spark_rapids_tpu_torch import native as PN

    bufs = _frame_buffers()
    frame = PN.frame_pack(bufs)
    assert bytes(frame) == bytes(JN.frame_pack(bufs))
    stream = _io.BytesIO()
    assert PN.frame_write(stream, bufs) == len(frame)
    assert stream.getvalue() == bytes(frame)
    views = PN.frame_unpack(frame)
    assert [bytes(v) for v in views] == [bytes(v) for v in JN.frame_unpack(bytes(frame))]
    assert bytes(views[1]) == b"hello world"
    assert np.array_equal(np.frombuffer(views[2], np.int64), bufs[2])
    assert np.array_equal(np.frombuffer(views[3], np.float64), bufs[3])
    assert bytes(views[4]) == b"\x00" * 4097


def test_native_frame_malformed():
    from spark_rapids_tpu_torch import native as PN

    with pytest.raises(ValueError):
        PN.frame_unpack(b"not a frame at all")


def test_native_allocator_best_fit_and_coalesce():
    from spark_rapids_tpu_torch import native as PN

    a = PN.AddressSpaceAllocator(1 << 16)
    try:
        o1, o2, o3 = a.alloc(1000), a.alloc(5000), a.alloc(100)
        assert a.allocated == 6100
        a.free(o2)
        o4 = a.alloc(4000)  # best fit: the 5000-byte hole, not the tail
        assert o4 == o2
        for o in (o1, o3, o4):
            a.free(o)
        assert a.allocated == 0 and a.largest_free == 1 << 16
        assert a.alloc((1 << 16) + 1) is None
        with pytest.raises(ValueError):
            a.free(12345)
    finally:
        a.close()


def test_native_allocator_fragmentation_reuse():
    from spark_rapids_tpu_torch import native as PN

    a = PN.AddressSpaceAllocator(4096)
    try:
        offs = [a.alloc(256) for _ in range(16)]
        assert all(o is not None for o in offs) and a.alloc(1) is None
        for o in offs[::2]:
            a.free(o)
        assert a.largest_free == 256  # alternating holes, no coalesce
        assert a.alloc(257) is None and a.alloc(256) is not None
    finally:
        a.close()


def test_native_spill_disk_contiguous_frame(tmp_path):
    """The port's DISK spill tier writes one ``.srtf`` frame the JAX loader
    unpacks, and restores the batch bit for bit (more in
    tests/test_torch_spill.py)."""
    from spark_rapids_tpu import native as JN
    from spark_rapids_tpu_torch.columnar import device as PD
    from spark_rapids_tpu_torch.columnar.host import from_arrow
    from spark_rapids_tpu_torch.mem import spill as PS

    db = PD.host_to_device(from_arrow(pa.table({"a": np.arange(10), "s": list("abcdefghij")})),
                           torch.device("cpu"))
    want = [t.clone() for t in PS._tensors(db)]
    cat = PS.BufferCatalog(spill_dir=str(tmp_path))
    h = cat.register(db)
    del db
    cat.synchronous_spill(1)
    cat.host_limit = 0
    cat.synchronous_spill(0)
    buf = cat._buffers[h.id]
    assert buf.path.endswith(".srtf") and os.path.exists(buf.path)
    with open(buf.path, "rb") as f:
        assert len(JN.frame_unpack(f.read())) > 1
    got = PS._tensors(h.get_batch())
    assert all(torch.equal(a, b) for a, b in zip(want, got))
    h.close()
