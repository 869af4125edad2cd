"""The port's own Parquet reader and writer (``spark_rapids_tpu_torch/io/
parquet.py`` over the host codec library ``csrc/host/io_codec.cc``) held to
pyarrow and to the JAX package's pyarrow-backed reader.

* pyarrow writes a table of every flat type the engine holds (bool, byte,
  short, int, long, float, double, string, date, timestamp,
  decimal(9,2)) with no, some or all nulls, no/snappy/gzip compression,
  with and without dictionaries, default and 1 KiB data pages, data page
  v1 and v2; the port's read equals ``papq.read_table``, and the port
  session's rows and inferred ``Schema`` equal the JAX session's;
* the port writes the same tables; ``papq.read_table`` gives back the
  source, and pyarrow's footer shows the port's min/max/null_count;
* snappy both ways against ``pa.compress``/``pa.decompress``;
* what the port does not read raises, naming itself: ZSTD, LZ4, BROTLI,
  ``DELTA_BINARY_PACKED``, ``BYTE_STREAM_SPLIT``; a nested column and
  ``read.orc`` name ROADMAP item 10b; the types pyarrow reads in its own
  way (INT96, NANOS and MILLIS timestamps, unsigned and 8/16-bit ints,
  REQUIRED columns, a decimal over 18 digits) read as the JAX reader types
  them.
"""
from __future__ import annotations

import datetime as dt
import decimal
import math

import numpy as np
import pytest

pytest.importorskip("jax")  # the reference; absent on a machine with only the port

import pyarrow as pa  # noqa: E402
import pyarrow.compute as pc  # noqa: E402
import pyarrow.parquet as papq  # noqa: E402

from spark_rapids_tpu.types import Schema as JaxSchema  # noqa: E402
from spark_rapids_tpu_torch.columnar.host import from_arrow, to_arrow  # noqa: E402
from spark_rapids_tpu_torch.io import parquet as P  # noqa: E402

N = 400


def _flat_table(null_share: float, seed: int = 3) -> pa.Table:
    rng = np.random.default_rng(seed)

    def with_nulls(arr: pa.Array) -> pa.Array:
        if null_share == 0:
            return arr
        mask = rng.random(N) < null_share
        return pc.if_else(pa.array(mask), pa.nulls(N, arr.type), arr)

    cols = {
        "b": pa.array(rng.random(N) < 0.5),
        "i8": pa.array(rng.integers(-128, 128, N).astype(np.int8)),
        "i16": pa.array(rng.integers(-30000, 30000, N).astype(np.int16)),
        "i32": pa.array(rng.integers(-2**31, 2**31, N).astype(np.int32)),
        "i64": pa.array(rng.integers(-2**62, 2**62, N)),
        "f32": pa.array(np.where(rng.random(N) < 0.05, np.nan,
                                 rng.standard_normal(N)).astype(np.float32)),
        "f64": pa.array(rng.standard_normal(N) * 1e6),
        "s": pa.array([("ü%d" % (i % 37)) * (i % 4) for i in range(N)]),
        "d": pa.array(rng.integers(-20000, 30000, N).astype(np.int32)).cast(pa.date32()),
        "t": pa.array(rng.integers(-2**50, 2**50, N), type=pa.timestamp("us", tz="UTC")),
        "m": pa.array([decimal.Decimal(int(x)).scaleb(-2)
                       for x in rng.integers(-10**8, 10**8, N)], type=pa.decimal128(9, 2)),
    }
    return pa.table({k: with_nulls(v) for k, v in cols.items()})


def _same(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a) and math.isnan(b):
        return True
    return a == b


def _rows_equal(got, want) -> None:
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert len(g) == len(w) and all(_same(x, y) for x, y in zip(g, w)), (i, g, w)


def _port_session():
    from spark_rapids_tpu_torch import TorchSession

    return TorchSession({"spark.rapids.sql.enabled": False}, device="cpu")


def _jax_session():
    from tests.harness import cpu_session

    return cpu_session()


GRID = [
    pytest.param(nulls, codec, dic, page, ver,
                 id=f"{nulls}-{codec}-{'dict' if dic else 'plain'}-{page or 'default'}-v{ver}")
    for nulls in ("none", "some", "all")
    for codec in ("none", "snappy", "gzip")
    for dic in (True, False)
    for page in (None, 1024)
    for ver in ("1.0", "2.0")
]
NULL_SHARE = {"none": 0.0, "some": 0.3, "all": 1.0}


@pytest.mark.parametrize("nulls,codec,dic,page,ver", GRID)
def test_read_pyarrow_files(nulls, codec, dic, page, ver, tmp_path):
    t = _flat_table(NULL_SHARE[nulls])
    path = str(tmp_path / "t.parquet")
    kw = dict(compression=codec, use_dictionary=dic, data_page_version=ver)
    if page:
        kw["data_page_size"] = page
    papq.write_table(t, path, **kw)
    got = P.read_table(path)
    want = papq.read_table(path)
    schema = JaxSchema.from_arrow(papq.read_schema(path))
    assert repr(got.schema) == repr(schema)
    assert [f.nullable for f in got.schema] == [f.nullable for f in schema]
    arrow = to_arrow(got)
    for name in t.column_names:
        w = want.column(name).cast(arrow.schema.field(name).type)
        _rows_equal([(v,) for v in arrow.column(name).to_pylist()], [(v,) for v in w.to_pylist()])
    # the sessions: the port's rows and schema against the JAX reader's
    port = _port_session().read.parquet(path)
    jax = _jax_session().read.parquet(path)
    assert repr(port.schema) == repr(jax.schema)
    _rows_equal(port.collect(), jax.collect())


@pytest.mark.parametrize("nulls", ["none", "some", "all"])
@pytest.mark.parametrize("codec", ["none", "snappy", "gzip"])
def test_port_writes_pyarrow_reads(nulls, codec, tmp_path):
    t = _flat_table(NULL_SHARE[nulls], seed=11)
    path = str(tmp_path / "p.parquet")
    P.write_table(from_arrow(t), path, codec)
    back = papq.read_table(path)
    for name in t.column_names:
        assert back.column(name).type == t.column(name).type, name
        _rows_equal([(v,) for v in back.column(name).to_pylist()],
                    [(v,) for v in t.column(name).to_pylist()])
    md = papq.ParquetFile(path).metadata
    assert md.row_group(0).column(0).compression == {"none": "UNCOMPRESSED"}.get(
        codec, codec.upper())
    for i in range(md.num_columns):
        name = md.schema.column(i).name
        st = md.row_group(0).column(i).statistics
        col = t.column(name)
        assert st is not None and st.null_count == col.null_count, name
        finite = pc.drop_null(col)
        if name.startswith("f") and pc.any(pc.is_nan(finite)).as_py():
            assert not st.has_min_max  # NaN-bearing floats carry no min/max
            continue
        assert st.has_min_max == (len(finite) > 0), name
        if st.has_min_max:
            mm = pc.min_max(col)
            assert (st.min, st.max) == (mm["min"].as_py(), mm["max"].as_py()), name
    # and the port reads its own file back to the source
    from spark_rapids_tpu_torch.columnar.host import batch_rows

    _rows_equal(batch_rows(P.read_table(path)), batch_rows(from_arrow(t)))


def test_writer_cuts_row_groups_and_pages(tmp_path, monkeypatch):
    """One row group per written batch, cut at ROW_GROUP_ROWS rows; pages cut
    near PAGE_BYTES (both shrunk here); string statistics by unsigned
    bytes."""
    monkeypatch.setattr(P, "ROW_GROUP_ROWS", 1000)
    monkeypatch.setattr(P, "PAGE_BYTES", 512)
    t = pa.table({"x": np.arange(2500), "s": [("é" if i % 2 else "z") + str(i) for i in range(2500)]})
    path = str(tmp_path / "rg.parquet")
    hb = from_arrow(t)
    with P.ParquetWriter(path, hb.schema) as w:
        w.write_batch(hb.slice(0, 1500))
        w.write_batch(hb.slice(1500, 1000))
    md = papq.ParquetFile(path).metadata
    assert [md.row_group(i).num_rows for i in range(md.num_row_groups)] == [1000, 500, 1000]
    assert papq.read_table(path).equals(t)
    st = md.row_group(0).column(1).statistics
    assert (st.min, st.max) == ("z0", "é999")  # é is 0xC3 0xA9: above every ASCII byte
    pf = P.ParquetFile(path)
    assert pf.statistics(0, "s").max == "é999" and pf.statistics(2, "x").min == 1500
    pf.close()


@pytest.mark.parametrize("data", [
    b"", b"x", b"abcabcabcabcabcabcabc" * 500, bytes(range(256)) * 300,
    np.random.default_rng(4).integers(0, 3, 200_000).astype(np.uint8).tobytes(),
    np.random.default_rng(5).bytes(70_000),
], ids=["empty", "one", "repeats", "ramp", "low-entropy", "random"])
def test_snappy_both_ways(data):
    ours = P.snappy_compress(data)
    assert pa.decompress(ours, len(data), codec="snappy").to_pybytes() == data
    theirs = pa.compress(data, codec="snappy").to_pybytes()
    assert P.snappy_decompress(theirs).tobytes() == data
    if len(data) > 1000 and data[:21] == b"abcabcabcabcabcabcabc":
        assert len(ours) < len(data) // 20  # real LZ77 matches, not literals


@pytest.mark.parametrize("bit_width", [1, 2, 7, 13, 32])
def test_rle_hybrid_round_trip(bit_width):
    rng = np.random.default_rng(bit_width)
    hi = 2 ** min(bit_width, 31)
    v = rng.integers(0, hi, 3001).astype(np.int32)
    v[500:900] = v[500]  # a long run
    enc = P.rle_encode(v, bit_width)
    dec, used = P.rle_decode(enc, bit_width, len(v))
    assert np.array_equal(dec, v) and used == len(enc)


@pytest.mark.parametrize("codec", ["zstd", "lz4", "brotli"])
def test_unsupported_codecs_raise(codec, tmp_path):
    path = str(tmp_path / "c.parquet")
    papq.write_table(pa.table({"x": np.arange(10)}), path, compression=codec)
    name = {"lz4": "LZ4"}.get(codec, codec.upper())
    with pytest.raises(NotImplementedError, match=name):
        P.read_table(path)


@pytest.mark.parametrize("encoding,values", [
    ("DELTA_BINARY_PACKED", pa.array(np.arange(100))),
    ("BYTE_STREAM_SPLIT", pa.array(np.linspace(0, 1, 100))),
])
def test_unsupported_encodings_raise(encoding, values, tmp_path):
    path = str(tmp_path / "e.parquet")
    papq.write_table(pa.table({"x": values}), path, use_dictionary=False,
                     column_encoding={"x": encoding})
    with pytest.raises(NotImplementedError, match=encoding):
        P.read_table(path)


def test_nested_and_orc_name_item_10b(tmp_path):
    from spark_rapids_tpu_torch.columnar.host import column_from_pylist
    from spark_rapids_tpu_torch.types import ArrayType, LONG

    path = str(tmp_path / "n.parquet")
    papq.write_table(pa.table({"a": [[1, 2], None, []], "x": [1, 2, 3]}), path)
    with pytest.raises(NotImplementedError, match="item 10b"):
        P.read_table(path)
    s = _port_session()
    with pytest.raises(NotImplementedError, match="item 10b"):
        s.read.parquet(path)
    with pytest.raises(NotImplementedError, match="item 10b"):
        s.read.orc(path)
    df = s.create_dataframe({"a": [[1], [2, 3]]}, )
    with pytest.raises(NotImplementedError, match="item 10b"):
        df.write.parquet(str(tmp_path / "w"))
    with pytest.raises(NotImplementedError, match="item 10b"):
        df.write.orc(str(tmp_path / "o"))
    with pytest.raises(NotImplementedError, match="item 10b"):
        df.cache().collect()
    assert column_from_pylist([[1]], ArrayType(LONG)) is not None


def _legacy_tables():
    ts = pa.array([dt.datetime(2020, 1, 2, 3, 4, 5, 123456), None,
                   dt.datetime(1900, 6, 7, 8, 9, 10)], type=pa.timestamp("us"))
    return [
        ("int96", pa.table({"t": ts}), dict(use_deprecated_int96_timestamps=True)),
        ("nanos", pa.table({"t": ts.cast(pa.timestamp("ns", tz="UTC"))}), dict(version="2.6")),
        ("millis", pa.table({"t": pa.array([1577934245123, None, 0], type=pa.timestamp("ms"))}),
         dict(coerce_timestamps="ms", allow_truncated_timestamps=True)),
        ("unsigned", pa.table({
            "u8": pa.array([0, 255, None], type=pa.uint8()),
            "u16": pa.array([0, 65535, 7], type=pa.uint16()),
            "u32": pa.array([0, 2**32 - 1, None], type=pa.uint32()),
        }), {}),
        ("required", pa.Table.from_arrays(
            [pa.array([1, 2, 3]), pa.array(["a", "b", "c"])],
            schema=pa.schema([pa.field("x", pa.int64(), nullable=False),
                              pa.field("s", pa.string(), nullable=False)])), {}),
        ("int-decimal", pa.table({"m": pa.array([decimal.Decimal("1.5"), None],
                                                type=pa.decimal128(5, 1))}),
         dict(store_decimal_as_integer=True)),
    ]


@pytest.mark.parametrize("case", _legacy_tables(), ids=lambda c: c[0])
def test_types_pyarrow_reads_its_own_way(case, tmp_path):
    """INT96, NANOS and MILLIS timestamps, unsigned ints, REQUIRED columns
    and integer-backed decimals read as the JAX reader types them."""
    _name, t, kw = case
    path = str(tmp_path / "l.parquet")
    papq.write_table(t, path, **kw)
    port = _port_session().read.parquet(path)
    jax = _jax_session().read.parquet(path)
    assert repr(port.schema) == repr(jax.schema)
    assert [f.nullable for f in port.schema] == [f.nullable for f in jax.schema]
    _rows_equal(port.collect(), jax.collect())


@pytest.mark.parametrize("case", ["decimal38", "uint64", "binary"])
def test_types_the_engine_cannot_hold_raise_alike(case, tmp_path):
    """A decimal over 18 digits raises ValueError in both readers, and a
    column no engine type holds TypeError."""
    t = {
        "decimal38": pa.table({"m": pa.array([decimal.Decimal("1.5")],
                                             type=pa.decimal128(38, 10))}),
        "uint64": pa.table({"u": pa.array([1], type=pa.uint64())}),
        "binary": pa.table({"b": pa.array([b"\x00\x01"], type=pa.binary())}),
    }[case]
    path = str(tmp_path / "x.parquet")
    papq.write_table(t, path)
    with pytest.raises(Exception) as jax_err:
        JaxSchema.from_arrow(papq.read_schema(path))
    with pytest.raises(type(jax_err.value)):
        _port_session().read.parquet(path)


def test_dictionary_fallback_to_plain_in_one_chunk(tmp_path):
    """pyarrow falls back from dictionary to PLAIN pages inside one column
    chunk once its dictionary page passes the size limit (1 MiB by
    default; 1 KiB here): both kinds of page read back in order."""
    n = 5000
    t = pa.table({"s": [f"distinct value number {i:06d}" for i in range(n)],
                  "x": np.arange(n) % 7})
    path = str(tmp_path / "fb.parquet")
    papq.write_table(t, path, dictionary_pagesize_limit=1024, data_page_size=2048)
    encodings = papq.ParquetFile(path).metadata.row_group(0).column(0).encodings
    assert "PLAIN" in encodings and any("DICTIONARY" in e for e in encodings), encodings
    _rows_equal([(v,) for v in to_arrow(P.read_table(path)).column("s").to_pylist()],
                [(v,) for v in t.column("s").to_pylist()])


@pytest.mark.parametrize("nulls", ["none", "some"])
def test_statistics_read_as_pyarrow_reads_them(nulls, tmp_path):
    """The footer statistics the pruning reads: min, max and null count of
    every type, several row groups, as pyarrow's metadata gives them."""
    t = _flat_table(NULL_SHARE[nulls], seed=21)
    path = str(tmp_path / "st.parquet")
    papq.write_table(t, path, row_group_size=150)
    md = papq.ParquetFile(path).metadata
    pf = P.ParquetFile(path)
    try:
        for rg in range(md.num_row_groups):
            for i in range(md.num_columns):
                name = md.schema.column(i).name
                want = md.row_group(rg).column(i).statistics
                got = pf.statistics(rg, name)
                assert got.null_count == want.null_count, name
                assert got.has_min_max == want.has_min_max, name
                assert got.physical_type == md.row_group(rg).column(i).physical_type, name
                if want.has_min_max and not name.startswith("f"):
                    assert (got.min, got.max) == (want.min, want.max), (name, got.min, want.min)
    finally:
        pf.close()
