"""The port's batch stream framing (``spark_rapids_tpu_torch/columnar/ipc.py``)
held against the JAX package's Arrow IPC framing (``tests/test_ipc.py``'s
nine cases): the same rows, framed and read back by each, must decode to
equal batches — zero-row batches, all-null columns (a ``NullType`` one
included), schema-only streams, a zero-row tail and schema bytes included.
"""
from __future__ import annotations

import numpy as np
import pytest

pytest.importorskip("jax")  # the reference; absent on a machine with only the port

import pyarrow as pa  # noqa: E402

from spark_rapids_tpu.columnar import ipc as J  # noqa: E402
from spark_rapids_tpu_torch.columnar import ipc as P  # noqa: E402
from spark_rapids_tpu_torch.columnar.host import batch_rows, from_arrow  # noqa: E402
from spark_rapids_tpu_torch.types import Schema  # noqa: E402


def _rows(rb: pa.RecordBatch) -> list:
    return [tuple(r.values()) for r in rb.to_pylist()]


def _port_rt(rb: pa.RecordBatch):
    return P.read_batch(P.write_batch(from_arrow(rb)))


def _check_same(rb: pa.RecordBatch):
    """The port's round trip equals the JAX package's, row for row and
    type for type."""
    jax_out = J.read_batch(J.write_batch(rb))
    out = _port_rt(rb)
    assert batch_rows(out) == _rows(jax_out)
    assert out.schema == Schema.from_arrow(jax_out.schema)
    return out


def test_roundtrip_plain_batch():
    _check_same(pa.record_batch({"a": [1, 2, 3], "s": ["x", None, "z"]}))


def test_roundtrip_zero_row_batch():
    rb = pa.record_batch(
        {"a": pa.array([], type=pa.int64()), "s": pa.array([], type=pa.string())}
    )
    out = _check_same(rb)
    assert out.num_rows == 0


def test_roundtrip_all_null_columns():
    rb = pa.record_batch(
        {
            "i": pa.array([None, None, None], type=pa.int32()),
            "f": pa.array([None, None, None], type=pa.float64()),
            "s": pa.array([None, None, None], type=pa.string()),
            "n": pa.nulls(3),  # NullType column: validity only, no data
        }
    )
    out = _check_same(rb)
    assert not out.columns[0].validity.any()
    assert out.schema["n"].data_type == Schema.from_arrow(pa.schema([("n", pa.null())]))["n"].data_type


def test_schema_only_stream_decodes_to_no_batches():
    schema = pa.schema([("a", pa.int64())])
    got_schema, batches = J.read_stream(J.write_stream([], schema=schema))
    pschema = Schema.from_arrow(schema)
    data = P.write_stream([], schema=pschema)
    p_schema, p_batches = P.read_stream(data)
    assert p_schema == pschema == Schema.from_arrow(got_schema)
    assert p_batches == batches == []
    # single-batch reader rebuilds the empty batch instead of IndexError
    hb = P.read_batch(data)
    assert hb.num_rows == 0 and hb.schema == pschema


def test_write_stream_empty_without_schema_raises():
    with pytest.raises(ValueError):
        J.write_stream([])
    with pytest.raises(ValueError):
        P.write_stream([])


def test_multi_batch_stream_preserves_zero_row_tail():
    schema = pa.schema([("a", pa.int64())])
    b1 = pa.record_batch({"a": [1, 2]}).cast(schema)
    b0 = J.empty_batch(schema)
    jdata = J.write_stream([b1, b0, b1], schema=schema)
    _, jbatches = J.read_stream(jdata)
    h1, h0 = from_arrow(b1), P.empty_batch(Schema.from_arrow(schema))
    pdata = P.write_stream([h1, h0, h1], schema=Schema.from_arrow(schema))
    _, pbatches = P.read_stream(pdata)
    assert [b.num_rows for b in pbatches] == [b.num_rows for b in jbatches] == [2, 0, 2]
    # read_batch combines the frames into one batch
    combined = P.read_batch(pdata)
    assert batch_rows(combined) == _rows(J.read_batch(jdata)) == [(1,), (2,), (1,), (2,)]


def test_read_batch_all_zero_row_frames():
    schema = pa.schema([("a", pa.int64()), ("s", pa.string())])
    ps = Schema.from_arrow(schema)
    data = P.write_stream([P.empty_batch(ps), P.empty_batch(ps)], schema=ps)
    hb = P.read_batch(data)
    jb = J.read_batch(J.write_stream([J.empty_batch(schema)] * 2, schema=schema))
    assert hb.num_rows == jb.num_rows == 0 and hb.schema == ps == Schema.from_arrow(jb.schema)


def test_schema_bytes_roundtrip():
    schema = pa.schema([("a", pa.decimal128(12, 2)), ("t", pa.timestamp("us")),
                        ("l", pa.list_(pa.int64())),
                        ("st", pa.struct([("x,y", pa.int32()), ("z:w", pa.string())])),
                        ("m", pa.map_(pa.string(), pa.float64()))])
    assert J.schema_from_bytes(J.schema_to_bytes(schema)).equals(schema)
    ps = Schema.from_arrow(schema)
    assert P.schema_from_bytes(P.schema_to_bytes(ps)) == ps


def test_serializer_shims_ride_ipc_helpers():
    """The shuffle serializer's codec layer sits on the shared framing —
    zero-row and all-null batches survive the codec round trip too (the
    port's ``lz4``; its ``zstd`` raises, see test_torch_shuffle_protocol)."""
    from spark_rapids_tpu.shuffle.compression import get_codec as jcodec
    from spark_rapids_tpu.shuffle.serializer import deserialize_record_batch, serialize_record_batch
    from spark_rapids_tpu_torch.shuffle import meta as M
    from spark_rapids_tpu_torch.shuffle.compression import get_codec
    from spark_rapids_tpu_torch.shuffle.serializer import (
        deserialize_host_batch,
        serialize_host_batch,
    )

    for rb in (
        pa.record_batch({"a": np.arange(100), "s": ["v"] * 100}),
        pa.record_batch({"a": pa.array([], type=pa.int64())}),
        pa.record_batch({"a": pa.array([None] * 5, type=pa.int64())}),
    ):
        payload, usize, cid = serialize_host_batch(from_arrow(rb), get_codec("lz4"))
        bm = M.BufferMeta(buffer_id=0, size=len(payload), uncompressed_size=usize, codec=cid)
        out = deserialize_host_batch(payload, bm)
        jp, ju, jc = serialize_record_batch(rb, jcodec("lz4"))
        from spark_rapids_tpu.shuffle import meta as JM

        jout = deserialize_record_batch(jp, JM.BufferMeta(0, len(jp), ju, jc))
        assert batch_rows(out) == _rows(jout)
