"""Host-side columnar batches — the ``RapidsHostColumnVector`` analogue.

The JAX package's host currency is ``pyarrow.RecordBatch``
(``spark_rapids_tpu/columnar/host.py``). The port's runtime path must run on
numpy alone, so its host currency is ``HostBatch``: the same Arrow layout
held in numpy arrays. A fixed-width column is a data array plus a validity
mask (null slots zeroed); a string column is an ``int32[n + 1]`` offsets
array plus a ``uint8`` byte buffer, with null strings empty. Uploads build
the device byte planes straight from offsets and bytes, without Python
strings.

The CPU engine computes over ``(data, validity)`` numpy pairs, exactly as in
the JAX package. Strings become object arrays of ``str`` only there
(``np_from_host``), because its per-row string code needs them.

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
    DataType,
    DateType,
    DecimalType,
    NullType,
    Schema,
    StringType,
    TimestampType,
    is_complex,
)


@dataclasses.dataclass
class HostColumn:
    """One host column in Arrow layout (see the module docstring)."""

    dtype: DataType
    data: np.ndarray
    validity: np.ndarray  # bool[n]
    offsets: Optional[np.ndarray] = None  # strings: int32[n + 1]

    def __len__(self) -> int:
        return len(self.validity)

    @property
    def lengths(self) -> np.ndarray:
        """int32[n] byte lengths of a string column."""
        return np.diff(self.offsets).astype(np.int32)

    def take(self, idx: np.ndarray) -> "HostColumn":
        idx = np.asarray(idx, dtype=np.int64)
        if self.offsets is None:
            return HostColumn(self.dtype, self.data[idx], self.validity[idx])
        starts = self.offsets[:-1].astype(np.int64)[idx]
        lens = self.lengths[idx].astype(np.int64)
        offsets = np.zeros(len(idx) + 1, dtype=np.int64)
        np.cumsum(lens, out=offsets[1:])
        # byte i of the output comes from starts[row] + (i - offsets[row])
        row = np.repeat(np.arange(len(idx)), lens)
        src = starts[row] + (np.arange(offsets[-1]) - offsets[:-1][row])
        return HostColumn(
            self.dtype, self.data[src], self.validity[idx], offsets.astype(np.int32)
        )

    def slice(self, off: int, n: int) -> "HostColumn":
        if self.offsets is None:
            return HostColumn(
                self.dtype, self.data[off : off + n], self.validity[off : off + n]
            )
        offs = self.offsets[off : off + n + 1]
        data = self.data[offs[0] : offs[-1]]
        return HostColumn(self.dtype, data, self.validity[off : off + n], offs - offs[0])


@dataclasses.dataclass
class HostBatch:
    """A batch of host columns (the port's ``pa.RecordBatch``)."""

    schema: Schema
    columns: list
    num_rows: int

    def column(self, i: int) -> HostColumn:
        return self.columns[i]

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
        """Bytes of the host arrays (data, validity, offsets) — what an upload
        of the whole batch moves, as Arrow's ``nbytes`` counts a batch."""
        total = 0
        for c in self.columns:
            total += c.data.nbytes + c.validity.nbytes
            if c.offsets is not None:
                total += c.offsets.nbytes
        return total


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
    python str (None for null), as the CPU engine's string code expects."""
    if isinstance(col.dtype, StringType):
        return _py_strings(col), col.validity
    return col.data, col.validity


def host_from_np(data: np.ndarray, valid: np.ndarray, dt: DataType) -> HostColumn:
    """(data, validity) → host column; null slots zeroed."""
    valid = np.asarray(valid, dtype=bool)
    n = len(valid)
    if isinstance(dt, StringType):
        vals = [data[i] if valid[i] else None for i in range(n)]
        return string_column(vals, dt)
    if is_complex(dt):
        raise NotImplementedError(
            f"{dt.simple_string} columns are not in the torch port yet"
        )
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


def concat_batches(schema: Schema, batches: list) -> HostBatch:
    if not batches:
        return empty_host_batch(schema)
    if len(batches) == 1:
        return batches[0]
    cols = []
    for i, f in enumerate(schema):
        parts = [b.columns[i] for b in batches]
        valid = np.concatenate([p.validity for p in parts])
        data = np.concatenate([p.data for p in parts])
        offsets = None
        if isinstance(f.data_type, StringType):
            lens = np.concatenate([np.diff(p.offsets).astype(np.int64) for p in parts])
            offsets = np.zeros(len(lens) + 1, dtype=np.int64)
            np.cumsum(lens, out=offsets[1:])
            offsets = _offsets32(offsets)
        cols.append(HostColumn(f.data_type, data, valid, offsets))
    return HostBatch(schema, cols, sum(b.num_rows for b in batches))


def empty_host_batch(schema: Schema) -> HostBatch:
    cols = []
    for f in schema:
        dt = f.data_type
        if isinstance(dt, StringType):
            cols.append(
                HostColumn(dt, np.zeros(0, np.uint8), np.zeros(0, bool), np.zeros(1, np.int32))
            )
        else:
            cols.append(HostColumn(dt, np.zeros(0, dt.np_dtype), np.zeros(0, bool)))
    return HostBatch(schema, cols, 0)


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
    cols = []
    for i, f in enumerate(schema):
        arr = table.column(i).combine_chunks()
        dt = f.data_type
        valid = ~np.asarray(arr.is_null(), dtype=bool)
        n = len(arr)
        if isinstance(dt, StringType):
            arr = arr.cast(pa.string())
            offs = np.frombuffer(arr.buffers()[1], dtype=np.int32)[
                arr.offset : arr.offset + n + 1
            ]
            raw = arr.buffers()[2]
            values = np.frombuffer(raw, dtype=np.uint8) if raw is not None else np.zeros(0, np.uint8)
            lens = np.where(valid, np.diff(offs), 0).astype(np.int64)
            new_offs = np.zeros(n + 1, dtype=np.int64)
            np.cumsum(lens, out=new_offs[1:])
            row = np.repeat(np.arange(n), lens)
            src = offs[:-1].astype(np.int64)[row] + (np.arange(new_offs[-1]) - new_offs[:-1][row])
            cols.append(HostColumn(dt, values[src], valid, _offsets32(new_offs)))
            continue
        if is_complex(dt):
            raise NotImplementedError(
                f"{dt.simple_string} columns are not in the torch port yet"
            )
        if isinstance(dt, NullType):
            cols.append(HostColumn(dt, np.zeros(n, np.int8), np.zeros(n, dtype=bool)))
            continue
        if isinstance(dt, DecimalType):
            buf = arr.buffers()[1]
            pairs = np.frombuffer(buf, dtype=np.int64, count=(arr.offset + n) * 2)
            data = pairs.reshape(-1, 2)[arr.offset :, 0]
        else:
            if pa.types.is_date32(arr.type):
                arr = arr.cast(pa.int32())
            elif pa.types.is_timestamp(arr.type):
                arr = arr.cast(pa.int64())
            if dt.np_dtype == np.bool_:
                data = np.asarray(arr.fill_null(False).to_numpy(zero_copy_only=False), dtype=bool)
            else:
                buf = arr.buffers()[1]
                data = np.frombuffer(buf, dtype=dt.np_dtype, count=arr.offset + n)[arr.offset :]
        data = np.where(valid, data, np.zeros((), dtype=dt.np_dtype)).astype(dt.np_dtype)
        cols.append(HostColumn(dt, np.ascontiguousarray(data), valid))
    return HostBatch(schema, cols, table.num_rows)


__all__ = [
    "HostBatch",
    "HostColumn",
    "batch_from_columns",
    "batch_rows",
    "concat_batches",
    "empty_host_batch",
    "from_arrow",
    "host_from_np",
    "np_from_host",
    "string_column",
    "strings_from_list",
    "to_arrow",
    "to_pylist",
]
