"""Batch stream framing — the ONE wire encoding for host columnar batches.

The port's counterpart of ``spark_rapids_tpu/columnar/ipc.py``. The JAX
package frames ``pa.RecordBatch``es as Arrow IPC streams through pyarrow,
which the card's machine does not have, so the port frames ``HostBatch``es
with the ``.srtf`` contiguous frame that is already the DISK spill tier's
format (``native.py::frame_pack``/``frame_unpack``; the same layout written
in Python where the native library is not built). A stream is one frame:

- buffer 0: a JSON header — the schema (names, nullability and each type as
  a JSON tree, so any field name survives) and, per batch, its row count
  and the dtype and shape of each of its planes;
- then every plane of every batch, 8-byte aligned: per column its validity,
  its data (not for arrays, maps and structs), its ``int32[n + 1]`` offsets
  (strings, arrays, maps), then its children the same way.

The edge cases of the JAX module hold: a 0-row batch round-trips, an
all-null column (a ``NullType`` one included) keeps its validity, a
schema-only stream decodes to no batches, ``read_batch`` rebuilds an empty
batch from the schema when a stream holds only 0-row batches, and a
multi-batch stream's zero-row tail survives.
"""
from __future__ import annotations

import io
import json
import struct
from typing import List, Optional, Tuple

import numpy as np

from ..types import (
    ArrayType,
    BooleanType,
    ByteType,
    DataType,
    DateType,
    DecimalType,
    DoubleType,
    FloatType,
    IntegerType,
    LongType,
    MapType,
    NullType,
    Schema,
    ShortType,
    StringType,
    StructField,
    StructType,
    TimestampType,
)
from .host import HostBatch, HostColumn, concat_batches, empty_host_batch

_SIMPLE = {
    "boolean": BooleanType, "byte": ByteType, "short": ShortType,
    "integer": IntegerType, "long": LongType, "float": FloatType,
    "double": DoubleType, "string": StringType, "date": DateType,
    "timestamp": TimestampType, "null": NullType,
}
_NAMES = {cls: name for name, cls in _SIMPLE.items()}
_FRAME_MAGIC = 0x46545253  # "SRTF", native/srt_host.cc's frame header


def _type_json(dt: DataType):
    if isinstance(dt, DecimalType):
        return ["decimal", dt.precision, dt.scale]
    if isinstance(dt, ArrayType):
        return ["array", _type_json(dt.element_type), dt.contains_null]
    if isinstance(dt, MapType):
        return ["map", _type_json(dt.key_type), _type_json(dt.value_type), dt.value_contains_null]
    if isinstance(dt, StructType):
        return ["struct", [_field_json(f) for f in dt.fields]]
    name = _NAMES.get(type(dt))
    if name is None:
        raise TypeError(f"no wire encoding for column type {dt}")
    return name


def _type_from_json(j) -> DataType:
    if isinstance(j, str):
        return _SIMPLE[j]()
    kind = j[0]
    if kind == "decimal":
        return DecimalType(j[1], j[2])
    if kind == "array":
        return ArrayType(_type_from_json(j[1]), j[2])
    if kind == "map":
        return MapType(_type_from_json(j[1]), _type_from_json(j[2]), j[3])
    if kind == "struct":
        return StructType(tuple(_field_from_json(f) for f in j[1]))
    raise ValueError(f"unknown wire type {j!r}")


def _field_json(f: StructField):
    return [f.name, _type_json(f.data_type), bool(f.nullable)]


def _field_from_json(j) -> StructField:
    return StructField(j[0], _type_from_json(j[1]), bool(j[2]))


def schema_to_bytes(schema: Schema) -> bytes:
    return json.dumps([_field_json(f) for f in schema]).encode("utf-8")


def schema_from_bytes(data: bytes) -> Schema:
    return Schema([_field_from_json(f) for f in json.loads(bytes(data).decode("utf-8"))])


def empty_batch(schema: Schema) -> HostBatch:
    """A 0-row batch of ``schema`` (the stream-tail currency)."""
    return empty_host_batch(schema)


def _child_types(dt: DataType) -> tuple:
    if isinstance(dt, StructType):
        return tuple(f.data_type for f in dt.fields)
    if isinstance(dt, MapType):
        return (dt.key_type, dt.value_type)
    if isinstance(dt, ArrayType):
        return (dt.element_type,)
    return ()


def _has_data(dt: DataType) -> bool:
    return not isinstance(dt, (ArrayType, MapType, StructType))


def _has_offsets(dt: DataType) -> bool:
    return isinstance(dt, (StringType, ArrayType, MapType))


def _column_planes(col: HostColumn, out: list) -> None:
    dt = col.dtype
    out.append(np.ascontiguousarray(col.validity, dtype=bool))
    if _has_data(dt):
        out.append(np.ascontiguousarray(col.data))
    if _has_offsets(dt):
        out.append(np.ascontiguousarray(col.offsets, dtype=np.int32))
    for kid in col.children or ():
        _column_planes(kid, out)


def _column_from_planes(dt: DataType, planes: list, i: int) -> Tuple[HostColumn, int]:
    validity = planes[i]
    i += 1
    data = offsets = None
    if _has_data(dt):
        data, i = planes[i], i + 1
    if _has_offsets(dt):
        offsets, i = planes[i], i + 1
    kids = []
    for kdt in _child_types(dt):
        k, i = _column_from_planes(kdt, planes, i)
        kids.append(k)
    return HostColumn(dt, data, validity, offsets, tuple(kids) if kids else None), i


def _pack(buffers: list) -> bytes:
    from .. import native

    if native.available():
        return bytes(native.frame_pack(buffers))
    out = io.BytesIO()
    native.frame_write(out, buffers)
    return out.getvalue()


def _unpack(data: bytes) -> List[memoryview]:
    from .. import native

    if native.available():
        return native.frame_unpack(data)
    # the same layout, read in Python: a 16-byte header, n uint64 lengths,
    # then each payload at the next 8-byte boundary
    magic, _version, n, _ = struct.unpack_from("<IIII", data, 0)
    if magic != _FRAME_MAGIC:
        raise ValueError("malformed srt frame")
    lens = struct.unpack_from(f"<{n}Q", data, 16)
    mv, off, out = memoryview(data), 16 + 8 * n, []
    for ln in lens:
        off += (-off) % 8
        if off + ln > len(data):
            raise ValueError("malformed srt frame")
        out.append(mv[off : off + ln])
        off += ln
    return out


def write_stream(batches: List[HostBatch], schema: Optional[Schema] = None) -> bytes:
    """Batches → one complete stream. ``schema`` is required when
    ``batches`` may be empty (a schema-only stream is valid and decodes to
    zero batches)."""
    if schema is None:
        if not batches:
            raise ValueError("write_stream with no batches requires a schema")
        schema = batches[0].schema
    planes: list = []
    metas = []
    for b in batches:
        start = len(planes)
        for c in b.columns:
            _column_planes(c, planes)
        metas.append({
            "rows": int(b.num_rows),
            "planes": [[p.dtype.str, list(p.shape)] for p in planes[start:]],
        })
    header = json.dumps({
        "schema": [_field_json(f) for f in schema],
        "batches": metas,
    }).encode("utf-8")
    return _pack([header] + planes)


def read_stream(data: bytes) -> Tuple[Schema, List[HostBatch]]:
    """Stream → (schema, batches). Zero-row batches are preserved; a
    schema-only stream returns an empty list. The planes are copied out of
    ``data``, so the batches own their memory."""
    views = _unpack(data)
    head = json.loads(bytes(views[0]).decode("utf-8"))
    schema = Schema([_field_from_json(f) for f in head["schema"]])
    pos, batches = 1, []
    for meta in head["batches"]:
        planes = []
        for dtype, shape in meta["planes"]:
            planes.append(np.frombuffer(views[pos], dtype=np.dtype(dtype)).reshape(shape).copy())
            pos += 1
        cols, i = [], 0
        for f in schema:
            c, i = _column_from_planes(f.data_type, planes, i)
            cols.append(c)
        batches.append(HostBatch(schema, cols, int(meta["rows"])))
    return schema, batches


def write_batch(batch: HostBatch) -> bytes:
    """One batch → a self-contained stream (schema + batch), the unit
    shuffle frames travel as."""
    return write_stream([batch])


def read_batch(data: bytes) -> HostBatch:
    """Self-contained stream → ONE batch. Multi-batch streams combine;
    empty streams (schema only, or only 0-row batches) rebuild a 0-row
    batch from the stream schema."""
    schema, batches = read_stream(data)
    if len(batches) == 1:
        return batches[0]
    live = [b for b in batches if b.num_rows]
    if not live:
        return empty_batch(schema)
    return concat_batches(schema, live)
