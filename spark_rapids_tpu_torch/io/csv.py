"""CSV reading and writing over the stdlib ``csv`` module.

The JAX package reads and writes CSV through ``pyarrow.csv``
(``spark_rapids_tpu/io/files.py:198-221``, ``io/writer.py:95-99``); the
port keeps its semantics without pyarrow:

* options ``header``, ``sep``/``delimiter`` and ``schema`` (a ``Schema``
  whose types the columns take; without a header its names name them);
* ``nullValue`` is the only null string (default ``""``, routed through the
  version shim), so ``"NaN"`` parses as a float NaN, and empty strings read
  as null under that default;
* without a schema each column's type is inferred as pyarrow infers it and
  ``Schema.from_arrow`` maps it: int64, then bool (``1``/``0``/``true``/
  ``false`` in pyarrow's spellings), double, date (``YYYY-MM-DD``),
  timestamp (``YYYY-MM-DD[ T]hh:mm[:ss[.f]][Z]``), else string; an all-null
  column is the null type, a time-of-day column raises ``TypeError`` as
  ``Schema.from_arrow`` does for pyarrow's ``time32``; without a header the
  columns are ``f0``, ``f1``, ...

Each column converts as a whole numpy array of its strings (``astype`` to
the number, date or timestamp type), not row by row. The writer quotes
strings, writes nulls empty and timestamps as pyarrow does
(``2021-03-04 05:06:07.890000Z``).
"""
from __future__ import annotations

import csv as _csv
import io
from typing import List, Optional

import numpy as np

from ..columnar.host import HostBatch, HostColumn, host_from_np, string_column, to_pylist
from ..types import (
    BOOLEAN,
    DATE,
    DOUBLE,
    LONG,
    NULL,
    STRING,
    TIMESTAMP,
    BooleanType,
    DataType,
    DateType,
    DecimalType,
    FloatType,
    DoubleType,
    NullType,
    Schema,
    StringType,
    StructField,
    TimestampType,
)

_TRUE = ("1", "True", "TRUE", "true")
_FALSE = ("0", "False", "FALSE", "false")


def _flag(options: dict, key: str) -> bool:
    return str(options.get(key, "false")).lower() in ("true", "1")


def read_csv(path: str, options: dict) -> HostBatch:
    """One CSV file as a host batch (see the module docstring for the
    options)."""
    header = _flag(options, "header")
    sep = options.get("sep", options.get("delimiter", ","))
    null_value = options.get("nullValue", "")
    schema: Optional[Schema] = options.get("schema")
    with open(path, newline="", encoding="utf-8") as f:
        rows = [r for r in _csv.reader(f, delimiter=sep) if r]
    if header:
        if not rows:
            raise ValueError(f"{path}: empty CSV file has no header")
        names, rows = rows[0], rows[1:]
    else:
        width = len(rows[0]) if rows else (len(schema) if schema is not None else 0)
        names = schema.names if schema is not None else [f"f{i}" for i in range(width)]
    ncol = len(names)
    for i, r in enumerate(rows):
        if len(r) != ncol:
            raise ValueError(f"{path}: CSV row {i + 1 + header} has {len(r)} columns, "
                             f"expected {ncol}")
    raw_cols = list(zip(*rows)) if rows else [() for _ in names]
    types = None
    if schema is not None:
        types = {f.name: f.data_type for f in schema}
    fields, cols = [], []
    for name, values in zip(names, raw_cols):
        arr = np.array(values, dtype=object)
        null = arr == null_value if arr.size else np.zeros(0, dtype=bool)
        if types is not None and name in types:
            dt = types[name]
            col = _convert(arr, null, dt, name)
        else:
            dt, col = _infer(arr, null, name)
        fields.append(StructField(name, dt, True))
        cols.append(col)
    return HostBatch(Schema(fields), cols, len(rows))


def _as_str(arr: np.ndarray) -> np.ndarray:
    return arr.astype(str) if arr.size else np.zeros(0, dtype="<U1")


def _parse(vals: np.ndarray, dt: DataType) -> np.ndarray:
    """Non-null strings → ``dt``'s storage, the whole array at once;
    raises ValueError when any value does not parse."""
    s = _as_str(vals)
    if isinstance(dt, BooleanType):
        t, f = np.isin(s, _TRUE), np.isin(s, _FALSE)
        if not (t | f).all():
            raise ValueError("not a boolean")
        return t
    if isinstance(dt, DateType):
        if s.size and not ((np.char.str_len(s) == 10).all()
                           and (np.char.find(s, "-") == 4).all()):
            raise ValueError("not a date")
        return s.astype("datetime64[D]").astype(np.int64).astype(np.int32)
    if isinstance(dt, TimestampType):
        return _parse_timestamps(s)
    if isinstance(dt, DecimalType):
        import decimal

        return np.array([int(decimal.Decimal(x).scaleb(dt.scale).to_integral_value())
                         for x in s], dtype=np.int64)
    if dt.np_dtype.kind in "iu":
        try:
            return s.astype(np.int64).astype(dt.np_dtype)
        except OverflowError as e:
            raise ValueError(str(e)) from e
    return s.astype(dt.np_dtype)


def _parse_timestamps(s: np.ndarray) -> np.ndarray:
    """ISO 8601 timestamps as pyarrow's parser takes them: a date, or a
    date, ``T`` or a space, and ``hh[:mm[:ss[.f]]]``; either every value
    carries a zone (``Z`` or ``+hh:mm``) or none does."""
    if not s.size:
        return np.zeros(0, dtype=np.int64)
    lens = np.char.str_len(s)
    head = s.astype("<U11")  # through the date and its separator
    shaped = (lens == 10) | ((lens >= 13) & (np.char.endswith(head, "T")
                                             | np.char.endswith(head, " ")))
    if not shaped.all() or not (np.char.find(s, "-") == 4).all():
        raise ValueError("not a timestamp")
    zulu = np.char.endswith(s, "Z")
    cut = np.maximum(np.char.rfind(s, "+"), np.char.rfind(s, "-"))
    offset = (cut > 10) & ~zulu
    zoned = zulu | offset
    if zoned.any() and not zoned.all():
        raise ValueError("timestamps with and without a zone")
    off_us = np.zeros(len(s), dtype=np.int64)
    if offset.any():
        tz = np.array([x[c:] for x, c in zip(s[offset], cut[offset])])
        if not ((np.char.str_len(tz) == 6) & (np.char.find(tz, ":") == 3)).all():
            raise ValueError("not a zone offset")
        sign = np.where(np.char.startswith(tz, "-"), -1, 1)
        hm = np.char.replace(np.char.lstrip(np.char.lstrip(tz, "+"), "-"), ":", "")
        mins = hm.astype(np.int64)
        off_us[offset] = sign * ((mins // 100) * 60 + mins % 100) * 60_000_000
        s = s.copy()
        s[offset] = np.array([x[:c] for x, c in zip(s[offset], cut[offset])])
    base = np.char.replace(np.char.rstrip(s, "Z"), " ", "T")
    return base.astype("datetime64[us]").astype(np.int64) - off_us


def _column(vals, null: np.ndarray, dt: DataType) -> HostColumn:
    valid = ~null
    if isinstance(dt, StringType):
        out = np.where(valid, vals, None)
        return string_column(out.tolist(), dt)
    if isinstance(dt, NullType):
        return HostColumn(dt, np.zeros(len(null), np.int8), np.zeros(len(null), dtype=bool))
    data = np.zeros(len(null), dtype=dt.np_dtype)
    data[valid] = vals
    return host_from_np(data, valid, dt)


def _convert(arr: np.ndarray, null: np.ndarray, dt: DataType, name: str) -> HostColumn:
    if isinstance(dt, StringType):
        return _column(arr, null, dt)
    try:
        return _column(_parse(arr[~null], dt), null, dt)
    except ValueError as e:
        raise ValueError(f"CSV column {name!r} does not parse as {dt.simple_string}: {e}") from e


def _is_time(s: np.ndarray) -> bool:
    if not s.size:
        return False
    lens = np.char.str_len(s)
    return bool(np.isin(lens, (5, 8)).all() and (np.char.find(s, ":") == 2).all()
                and np.char.isdigit(np.char.replace(s, ":", "")).all())


def _infer(arr: np.ndarray, null: np.ndarray, name: str) -> tuple:
    """(type, column) by pyarrow's order of inference."""
    vals = arr[~null]
    if not vals.size:
        return NULL, _column(arr, null, NULL)
    for dt in (LONG, BOOLEAN, DOUBLE, DATE):
        try:
            return dt, _column(_parse(vals, dt), null, dt)
        except ValueError:
            pass
    if _is_time(_as_str(vals)):
        raise TypeError(f"unsupported arrow type time32[s] (CSV column {name!r})")
    try:
        return TIMESTAMP, _column(_parse(vals, TIMESTAMP), null, TIMESTAMP)
    except ValueError:
        pass
    return STRING, _column(arr, null, STRING)


# ── writer ──────────────────────────────────────────────────────────────────


def _quote(s: str) -> str:
    return '"' + s.replace('"', '""') + '"'


def _cells(col: HostColumn) -> list:
    """One column's CSV cells ('' for null), formatted as pyarrow's writer
    formats them."""
    dt, valid = col.dtype, col.validity
    if isinstance(dt, StringType):
        return [_quote(v) if v is not None else "" for v in to_pylist(col)]
    if isinstance(dt, NullType):
        return [""] * len(col)
    d = col.data
    if isinstance(dt, BooleanType):
        s = np.where(d, "true", "false")
    elif isinstance(dt, DateType):
        s = d.astype("datetime64[D]").astype(str)
    elif isinstance(dt, TimestampType):
        s = np.char.add(np.char.replace(d.astype("datetime64[us]").astype(str), "T", " "), "Z")
    elif isinstance(dt, DecimalType):
        s = np.array([str(v) if v is not None else "" for v in to_pylist(col)], dtype=object)
    elif isinstance(dt, (FloatType, DoubleType)):
        s = d.astype(str)
    else:
        s = d.astype(str)
    return np.where(valid, s, "").tolist()


class CsvWriter:
    """Appends host batches to one CSV file; the header (quoted names, as
    pyarrow writes it) goes first when asked for."""

    def __init__(self, path: str, schema: Schema, include_header: bool):
        self._f = open(path, "w", encoding="utf-8", newline="")
        if include_header:
            self._f.write(",".join(_quote(n) for n in schema.names) + "\n")

    def write_batch(self, hb: HostBatch) -> None:
        cols = [_cells(c) for c in hb.columns]
        buf = io.StringIO()
        for row in zip(*cols):
            buf.write(",".join(row))
            buf.write("\n")
        self._f.write(buf.getvalue())

    def close(self) -> None:
        self._f.close()


__all__: List[str] = ["CsvWriter", "read_csv"]
