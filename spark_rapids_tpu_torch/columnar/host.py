"""Host-side columnar batches — the ``RapidsHostColumnVector`` analogue.

The JAX package's host currency is ``pyarrow.RecordBatch``
(``spark_rapids_tpu/columnar/host.py``). The port's runtime path must run on
numpy alone, so its host currency is ``HostBatch``: the same Arrow layout
held in numpy arrays. A fixed-width column is a data array plus a validity
mask (null slots zeroed); a string column is an ``int32[n + 1]`` offsets
array plus a ``uint8`` byte buffer, with null strings empty. Uploads build
the device byte planes straight from offsets and bytes, without Python
strings.

Nested columns follow Arrow too, with ``data`` None: an array or a map has
``int32[n + 1]`` offsets (a null list is empty) over child columns — the
elements, or the keys and the values of a map — and a struct has one child
column per field, row for row. Offsets start at 0 and end at the children's
length.

The CPU engine computes over ``(data, validity)`` numpy pairs, exactly as in
the JAX package. Strings and nested values become object arrays of Python
values only there (``np_from_host``: ``str``; a list for an array, a list
of ``(key, value)`` tuples for a map and a dict for a struct, as pyarrow's
``to_pylist`` gives them), because its per-row code needs them.

pyarrow is imported only by ``from_arrow``, for callers that pass Arrow
tables.
"""
from __future__ import annotations

import dataclasses
import datetime as _dt
import decimal as _dec
from typing import Optional

import numpy as np

from ..types import (
    ArrayType,
    DataType,
    DateType,
    DecimalType,
    MapType,
    NullType,
    Schema,
    StringType,
    StructType,
    TimestampType,
    is_complex,
)


@dataclasses.dataclass
class HostColumn:
    """One host column in Arrow layout (see the module docstring)."""

    dtype: DataType
    data: Optional[np.ndarray]  # None for nested columns
    validity: np.ndarray  # bool[n]
    offsets: Optional[np.ndarray] = None  # strings, arrays, maps: int32[n + 1]
    children: Optional[tuple] = None  # arrays, maps, structs: child columns

    def __len__(self) -> int:
        return len(self.validity)

    @property
    def lengths(self) -> np.ndarray:
        """int32[n] byte lengths of a string column (element counts of an
        array or map column)."""
        return np.diff(self.offsets).astype(np.int32)

    @property
    def nbytes(self) -> int:
        total = self.validity.nbytes
        for a in (self.data, self.offsets):
            if a is not None:
                total += a.nbytes
        return total + sum(k.nbytes for k in self.children or ())

    def to_pylist(self) -> list:
        """The column's Python values (see :func:`to_pylist`)."""
        return to_pylist(self)

    def take(self, idx: np.ndarray) -> "HostColumn":
        idx = np.asarray(idx, dtype=np.int64)
        if isinstance(self.dtype, StructType):
            kids = tuple(k.take(idx) for k in self.children)
            return HostColumn(self.dtype, None, self.validity[idx], None, kids)
        if self.offsets is None:
            return HostColumn(self.dtype, self.data[idx], self.validity[idx])
        starts = self.offsets[:-1].astype(np.int64)[idx]
        lens = self.lengths[idx].astype(np.int64)
        offsets = np.zeros(len(idx) + 1, dtype=np.int64)
        np.cumsum(lens, out=offsets[1:])
        # item i of the output comes from starts[row] + (i - offsets[row])
        row = np.repeat(np.arange(len(idx)), lens)
        src = starts[row] + (np.arange(offsets[-1]) - offsets[:-1][row])
        if self.children is not None:
            kids = tuple(k.take(src) for k in self.children)
            return HostColumn(
                self.dtype, None, self.validity[idx], _offsets32(offsets), kids
            )
        return HostColumn(
            self.dtype, self.data[src], self.validity[idx], offsets.astype(np.int32)
        )

    def slice(self, off: int, n: int) -> "HostColumn":
        valid = self.validity[off : off + n]
        if isinstance(self.dtype, StructType):
            kids = tuple(k.slice(off, n) for k in self.children)
            return HostColumn(self.dtype, None, valid, None, kids)
        if self.offsets is None:
            return HostColumn(self.dtype, self.data[off : off + n], valid)
        offs = self.offsets[off : off + n + 1]
        lo, hi = int(offs[0]), int(offs[-1])
        if self.children is not None:
            kids = tuple(k.slice(lo, hi - lo) for k in self.children)
            return HostColumn(self.dtype, None, valid, offs - lo, kids)
        return HostColumn(self.dtype, self.data[lo:hi], valid, offs - lo)


@dataclasses.dataclass
class HostBatch:
    """A batch of host columns (the port's ``pa.RecordBatch``)."""

    schema: Schema
    columns: list
    num_rows: int

    def column(self, i) -> HostColumn:
        """The column at index ``i``, or named ``i``."""
        return self.columns[self.schema.index_of(i) if isinstance(i, str) else i]

    def take(self, idx) -> "HostBatch":
        idx = np.asarray(idx, dtype=np.int64)
        return HostBatch(self.schema, [c.take(idx) for c in self.columns], len(idx))

    def filter(self, keep: np.ndarray) -> "HostBatch":
        return self.take(np.flatnonzero(keep))

    def slice(self, off: int, n: int) -> "HostBatch":
        n = max(0, min(n, self.num_rows - off))
        return HostBatch(self.schema, [c.slice(off, n) for c in self.columns], n)

    def select(self, names) -> "HostBatch":
        """The named columns, in the given order; the arrays are shared,
        not copied."""
        idx = [self.schema.index_of(n) for n in names]
        return HostBatch(
            Schema([self.schema[i] for i in idx]), [self.columns[i] for i in idx], self.num_rows
        )

    @property
    def nbytes(self) -> int:
        """Bytes of the host arrays (data, validity, offsets, children) —
        what an upload of the whole batch moves, as Arrow's ``nbytes``
        counts a batch."""
        return sum(c.nbytes for c in self.columns)


# ── strings ─────────────────────────────────────────────────────────────────


def strings_from_list(values) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Python strings (None for null) → (offsets int32[n+1], bytes u8,
    validity bool[n])."""
    n = len(values)
    valid = np.fromiter((v is not None for v in values), dtype=bool, count=n)
    enc = [v.encode("utf-8") if v is not None else b"" for v in values]
    lens = np.fromiter((len(b) for b in enc), dtype=np.int64, count=n)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    data = np.frombuffer(b"".join(enc), dtype=np.uint8).copy()
    return _offsets32(offsets), data, valid


def _offsets32(offsets: np.ndarray) -> np.ndarray:
    if offsets.size and offsets[-1] > np.iinfo(np.int32).max:
        raise ValueError("string column exceeds 2 GiB of bytes (int32 offsets)")
    return offsets.astype(np.int32)


def string_column(values, dt: DataType = None) -> HostColumn:
    from ..types import STRING

    offsets, data, valid = strings_from_list(values)
    return HostColumn(dt or STRING, data, valid, offsets)


def _py_strings(col: HostColumn) -> np.ndarray:
    """Object ndarray of python ``str`` (None for null)."""
    n = len(col)
    out = np.empty(n, dtype=object)
    raw = col.data.tobytes()
    offs = col.offsets.tolist()
    valid = col.validity.tolist()
    out[:] = [
        raw[offs[i] : offs[i + 1]].decode("utf-8") if valid[i] else None
        for i in range(n)
    ]
    return out


# ── numpy (data, validity) pairs: the CPU engine's working form ─────────────


def np_from_host(col: HostColumn) -> tuple[np.ndarray, np.ndarray]:
    """Host column → (data, validity). Strings become an object ndarray of
    python str (None for null), as the CPU engine's string code expects;
    nested columns an object ndarray of their Python values."""
    if isinstance(col.dtype, StringType):
        return _py_strings(col), col.validity
    if is_complex(col.dtype):
        out = np.empty(len(col), dtype=object)
        out[:] = to_pylist(col)
        return out, col.validity
    return col.data, col.validity


def _physical(v, dt: DataType):
    """One Python value → its physical number in ``dt``'s storage: days for
    a ``datetime.date``, microseconds (UTC) for a ``datetime``, the unscaled
    integer for a ``Decimal``; numbers pass through."""
    if isinstance(v, _dt.datetime):
        if v.tzinfo is None:
            v = v.replace(tzinfo=_dt.timezone.utc)
        return (v - _EPOCH_TS) // _dt.timedelta(microseconds=1)
    if isinstance(v, _dt.date):
        return (v - _EPOCH_DATE).days
    if isinstance(v, _dec.Decimal):
        return int(v.scaleb(dt.scale).to_integral_value())
    return v


def _field_value(v, f, j: int):
    if v is None:
        return None
    if isinstance(v, dict):
        return v.get(f.name)
    return v[j]  # a tuple or list in field order


def column_from_pylist(values, dt: DataType) -> HostColumn:
    """Python values (None for null) → a host column of type ``dt``, nested
    types included: a list for an array, a dict or a list of ``(key,
    value)`` pairs for a map, a dict or a tuple in field order for a
    struct. The inverse of :func:`to_pylist`."""
    values = list(values)
    n = len(values)
    valid = np.fromiter((v is not None for v in values), dtype=bool, count=n)
    if isinstance(dt, StringType):
        return string_column(values, dt)
    if isinstance(dt, NullType):
        return HostColumn(dt, np.zeros(n, np.int8), np.zeros(n, dtype=bool))
    if isinstance(dt, StructType):
        kids = tuple(
            column_from_pylist([_field_value(v, f, j) for v in values], f.data_type)
            for j, f in enumerate(dt.fields)
        )
        return HostColumn(dt, None, valid, None, kids)
    if isinstance(dt, (ArrayType, MapType)):
        items = [
            [] if v is None else list(v.items()) if isinstance(v, dict) else list(v)
            for v in values
        ]
        lens = np.fromiter((len(x) for x in items), dtype=np.int64, count=n)
        offsets = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(lens, out=offsets[1:])
        flat = [x for row in items for x in row]
        if isinstance(dt, MapType):
            kids = (
                column_from_pylist([k for k, _ in flat], dt.key_type),
                column_from_pylist([x for _, x in flat], dt.value_type),
            )
        else:
            kids = (column_from_pylist(flat, dt.element_type),)
        return HostColumn(dt, None, valid, _offsets32(offsets), kids)
    data = np.zeros(n, dtype=dt.np_dtype)
    for i, v in enumerate(values):
        if v is not None:
            data[i] = _physical(v, dt)
    return HostColumn(dt, data, valid)


def host_from_np(data: np.ndarray, valid: np.ndarray, dt: DataType) -> HostColumn:
    """(data, validity) → host column; null slots zeroed."""
    valid = np.asarray(valid, dtype=bool)
    n = len(valid)
    if isinstance(dt, StringType):
        vals = [data[i] if valid[i] else None for i in range(n)]
        return string_column(vals, dt)
    if is_complex(dt):
        return column_from_pylist([data[i] if valid[i] else None for i in range(n)], dt)
    if isinstance(dt, NullType):
        return HostColumn(dt, np.zeros(n, np.int8), np.zeros(n, dtype=bool))
    data = np.asarray(data)
    if data.dtype != dt.np_dtype:
        data = data.astype(dt.np_dtype)
    if not valid.all():
        data = np.where(valid, data, np.zeros((), dtype=dt.np_dtype))
    return HostColumn(dt, np.ascontiguousarray(data), valid)


def batch_from_columns(schema: Schema, cols: list) -> HostBatch:
    n = len(cols[0][1]) if cols else 0
    return HostBatch(
        schema,
        [host_from_np(d, v, f.data_type) for (d, v), f in zip(cols, schema)],
        n,
    )


def concat_columns(dt: DataType, parts: list) -> HostColumn:
    """One column of several host batches, end to end (children too)."""
    valid = np.concatenate([p.validity for p in parts])
    if isinstance(dt, StructType):
        kids = tuple(
            concat_columns(f.data_type, [p.children[j] for p in parts])
            for j, f in enumerate(dt.fields)
        )
        return HostColumn(dt, None, valid, None, kids)
    offsets = None
    if parts[0].offsets is not None:
        lens = np.concatenate([np.diff(p.offsets).astype(np.int64) for p in parts])
        offsets = np.zeros(len(lens) + 1, dtype=np.int64)
        np.cumsum(lens, out=offsets[1:])
        offsets = _offsets32(offsets)
    if isinstance(dt, (ArrayType, MapType)):
        kid_types = (dt.key_type, dt.value_type) if isinstance(dt, MapType) else (dt.element_type,)
        kids = tuple(
            concat_columns(kt, [p.children[j] for p in parts])
            for j, kt in enumerate(kid_types)
        )
        return HostColumn(dt, None, valid, offsets, kids)
    return HostColumn(dt, np.concatenate([p.data for p in parts]), valid, offsets)


def concat_batches(schema: Schema, batches: list) -> HostBatch:
    if not batches:
        return empty_host_batch(schema)
    if len(batches) == 1:
        return batches[0]
    cols = [
        concat_columns(f.data_type, [b.columns[i] for b in batches])
        for i, f in enumerate(schema)
    ]
    return HostBatch(schema, cols, sum(b.num_rows for b in batches))


def empty_column(dt: DataType) -> HostColumn:
    """A host column of ``dt`` with no rows."""
    return column_from_pylist([], dt)


def empty_host_batch(schema: Schema) -> HostBatch:
    return HostBatch(schema, [empty_column(f.data_type) for f in schema], 0)


# ── rows: what collect() returns ────────────────────────────────────────────

_EPOCH_DATE = _dt.date(1970, 1, 1)
_EPOCH_TS = _dt.datetime(1970, 1, 1, tzinfo=_dt.timezone.utc)


def to_pylist(col: HostColumn) -> list:
    """Python values of a column, as pyarrow's ``to_pylist`` gives them:
    dates as ``datetime.date``, timestamps as UTC ``datetime``, decimals as
    ``Decimal``, nulls as None."""
    dt = col.dtype
    valid = col.validity.tolist()
    if isinstance(dt, StringType):
        return _py_strings(col).tolist()
    if isinstance(dt, StructType):
        kids = [to_pylist(k) for k in col.children]
        names = [f.name for f in dt.fields]
        return [
            dict(zip(names, (k[i] for k in kids))) if ok else None
            for i, ok in enumerate(valid)
        ]
    if isinstance(dt, (ArrayType, MapType)):
        offs = col.offsets.tolist()
        kids = [to_pylist(k) for k in col.children]
        if isinstance(dt, MapType):
            keys, vals = kids
            return [
                list(zip(keys[offs[i] : offs[i + 1]], vals[offs[i] : offs[i + 1]]))
                if ok else None
                for i, ok in enumerate(valid)
            ]
        return [kids[0][offs[i] : offs[i + 1]] if ok else None for i, ok in enumerate(valid)]
    if isinstance(dt, NullType):
        return [None] * len(valid)
    vals = [v if ok else None for v, ok in zip(col.data.tolist(), valid)]
    if isinstance(dt, DateType):
        return [None if v is None else _EPOCH_DATE + _dt.timedelta(days=v) for v in vals]
    if isinstance(dt, TimestampType):
        return [None if v is None else _EPOCH_TS + _dt.timedelta(microseconds=v) for v in vals]
    if isinstance(dt, DecimalType):
        return [None if v is None else _dec.Decimal(v).scaleb(-dt.scale) for v in vals]
    return vals


def batch_rows(batch: HostBatch) -> list:
    cols = [to_pylist(c) for c in batch.columns]
    return list(zip(*cols)) if cols else [() for _ in range(batch.num_rows)]


# ── Arrow input and output (lazy pyarrow) ───────────────────────────────────


def to_arrow(batch: HostBatch):
    """One HostBatch → ``pa.Table`` with the schema's Arrow types, from the
    same Python values ``collect()`` gives (imports pyarrow; raises
    ``ImportError`` naming it where it is not installed)."""
    try:
        import pyarrow as pa
    except ImportError as e:
        raise ImportError("to_arrow() needs the pyarrow package, which is not installed") from e
    schema = batch.schema.to_arrow()
    arrays = [
        pa.array(to_pylist(c), type=schema.field(i).type) for i, c in enumerate(batch.columns)
    ]
    return pa.Table.from_arrays(arrays, schema=schema)


def from_arrow(table, schema: Optional[Schema] = None) -> HostBatch:
    """``pa.Table``/``pa.RecordBatch`` → one HostBatch (imports pyarrow)."""
    import pyarrow as pa

    if isinstance(table, pa.RecordBatch):
        table = pa.Table.from_batches([table])
    if schema is None:
        schema = Schema.from_arrow(table.schema)
    else:
        table = table.cast(schema.to_arrow())
    cols = [
        _from_arrow_column(table.column(i).combine_chunks(), f.data_type)
        for i, f in enumerate(schema)
    ]
    return HostBatch(schema, cols, table.num_rows)


def _from_arrow_column(arr, dt: DataType) -> HostColumn:
    """One Arrow array → a host column. A struct keeps its Arrow children as
    they are (a null struct's fields keep their own validity, as the JAX
    package's upload reads them); arrays and maps go through Python values."""
    import pyarrow as pa

    valid = ~np.asarray(arr.is_null(), dtype=bool)
    n = len(arr)
    if isinstance(dt, StringType):
        arr = arr.cast(pa.string())
        offs = np.frombuffer(arr.buffers()[1], dtype=np.int32)[arr.offset : arr.offset + n + 1]
        raw = arr.buffers()[2]
        values = np.frombuffer(raw, dtype=np.uint8) if raw is not None else np.zeros(0, np.uint8)
        lens = np.where(valid, np.diff(offs), 0).astype(np.int64)
        new_offs = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(lens, out=new_offs[1:])
        row = np.repeat(np.arange(n), lens)
        src = offs[:-1].astype(np.int64)[row] + (np.arange(new_offs[-1]) - new_offs[:-1][row])
        return HostColumn(dt, values[src], valid, _offsets32(new_offs))
    if isinstance(dt, StructType):
        kids = tuple(_from_arrow_column(arr.field(j), f.data_type) for j, f in enumerate(dt.fields))
        return HostColumn(dt, None, valid, None, kids)
    if is_complex(dt):
        return column_from_pylist(arr.to_pylist(), dt)
    if isinstance(dt, NullType):
        return HostColumn(dt, np.zeros(n, np.int8), np.zeros(n, dtype=bool))
    if isinstance(dt, DecimalType):
        buf = arr.buffers()[1]
        pairs = np.frombuffer(buf, dtype=np.int64, count=(arr.offset + n) * 2)
        data = pairs.reshape(-1, 2)[arr.offset :, 0]
    else:
        if pa.types.is_date32(arr.type):
            arr = arr.cast(pa.int32())
        elif pa.types.is_timestamp(arr.type):
            # the port holds microseconds, whatever the Arrow unit
            arr = arr.cast(pa.timestamp("us", tz=arr.type.tz)).cast(pa.int64())
        if dt.np_dtype == np.bool_:
            data = np.asarray(arr.fill_null(False).to_numpy(zero_copy_only=False), dtype=bool)
        else:
            buf = arr.buffers()[1]
            data = np.frombuffer(buf, dtype=dt.np_dtype, count=arr.offset + n)[arr.offset :]
    data = np.where(valid, data, np.zeros((), dtype=dt.np_dtype)).astype(dt.np_dtype)
    return HostColumn(dt, np.ascontiguousarray(data), valid)


__all__ = [
    "HostBatch",
    "HostColumn",
    "batch_from_columns",
    "batch_rows",
    "column_from_pylist",
    "concat_batches",
    "concat_columns",
    "empty_column",
    "empty_host_batch",
    "from_arrow",
    "host_from_np",
    "np_from_host",
    "string_column",
    "strings_from_list",
    "to_arrow",
    "to_pylist",
]
