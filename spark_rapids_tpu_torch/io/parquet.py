"""The port's Parquet reader and writer, over numpy.

The JAX package reads and writes Parquet through pyarrow
(``spark_rapids_tpu/io/files.py``, ``io/writer.py``); the port runs where
pyarrow is not installed, so it reads and writes the format itself: the
footer and page headers through ``io/thrift.py``, the values with numpy,
and the byte loops (snappy, the RLE/bit-packed hybrid, the PLAIN
``BYTE_ARRAY`` scan, bit-packed booleans, string min/max) in the host C++
library ``csrc/host/io_codec.cc``, built with ``g++`` at first use
(``kernels.host_library``). There is no Python copy of those loops.

What it reads (flat columns only):

* physical types BOOLEAN, INT32, INT64, INT96 (legacy Spark timestamps),
  FLOAT, DOUBLE, BYTE_ARRAY and FIXED_LEN_BYTE_ARRAY (decimals);
* logical types INT(8/16/32/64), STRING/UTF8, DATE, TIMESTAMP
  (MILLIS/MICROS/NANOS, UTC or local), DECIMAL, and the null type;
* encodings PLAIN, PLAIN_DICTIONARY/RLE_DICTIONARY, and RLE for levels and
  booleans, in data pages v1 and v2;
* codecs UNCOMPRESSED, SNAPPY and GZIP (the stdlib ``zlib``).

Anything else raises ``NotImplementedError`` naming the encoding or codec;
a nested column (LIST, MAP, a struct group) raises naming ROADMAP item 10b.
Each column's type is what the JAX package's ``Schema.from_arrow`` gives for
pyarrow's reading of the same file (unsigned ints widened, INT96 and NANOS
as timestamps; a type it cannot hold raises ``TypeError``, a decimal over
18 digits ``ValueError``).

What it writes: one row group per written batch, cut at 1,048,576 rows
(pyarrow's ``write_batch`` does the same); data page v1 pages of about 1 MiB;
PLAIN values with RLE definition levels (every column OPTIONAL); SNAPPY by
default; ``min``/``max``/``null_count`` statistics on every column chunk
(none for a float chunk holding NaN); Spark's types as pyarrow writes them.
"""
from __future__ import annotations

import ctypes
import datetime as _dt
import decimal as _dec
import io
import os
import struct
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np

from ..columnar.host import HostBatch, HostColumn, _offsets32, concat_batches
from ..types import (
    BOOLEAN,
    BYTE,
    DATE,
    DOUBLE,
    FLOAT,
    INT,
    LONG,
    NULL,
    SHORT,
    STRING,
    TIMESTAMP,
    BooleanType,
    ByteType,
    DataType,
    DateType,
    DecimalType,
    DoubleType,
    FloatType,
    IntegerType,
    LongType,
    NullType,
    Schema,
    ShortType,
    StringType,
    StructField,
    TimestampType,
    is_complex,
)
from . import thrift as T
from .thrift import F

MAGIC = b"PAR1"
ROW_GROUP_ROWS = 1_048_576
PAGE_BYTES = 1 << 20

# physical types
BOOLEAN_T, INT32_T, INT64_T, INT96_T, FLOAT_T, DOUBLE_T, BYTE_ARRAY_T, FLBA_T = range(8)
PHYSICAL = ("BOOLEAN", "INT32", "INT64", "INT96", "FLOAT", "DOUBLE", "BYTE_ARRAY",
            "FIXED_LEN_BYTE_ARRAY")
CODECS = {0: "UNCOMPRESSED", 1: "SNAPPY", 2: "GZIP", 3: "LZO", 4: "BROTLI", 5: "LZ4",
          6: "ZSTD", 7: "LZ4_RAW"}
CODEC_IDS = {"none": 0, "uncompressed": 0, "snappy": 1, "gzip": 2}
ENCODINGS = {0: "PLAIN", 1: "GROUP_VAR_INT", 2: "PLAIN_DICTIONARY", 3: "RLE", 4: "BIT_PACKED",
             5: "DELTA_BINARY_PACKED", 6: "DELTA_LENGTH_BYTE_ARRAY", 7: "DELTA_BYTE_ARRAY",
             8: "RLE_DICTIONARY", 9: "BYTE_STREAM_SPLIT"}
PLAIN, PLAIN_DICTIONARY, RLE, RLE_DICTIONARY = 0, 2, 3, 8
DATA_PAGE, INDEX_PAGE, DICTIONARY_PAGE, DATA_PAGE_V2 = 0, 1, 2, 3
REQUIRED, OPTIONAL, REPEATED = 0, 1, 2
# ConvertedType
UTF8, DECIMAL_CT, DATE_CT, TIME_MILLIS, TIME_MICROS = 0, 5, 6, 7, 8
TIMESTAMP_MILLIS, TIMESTAMP_MICROS = 9, 10
UINT_8, UINT_16, UINT_32, UINT_64, INT_8, INT_16, INT_32, INT_64 = range(11, 19)

_JULIAN_EPOCH = 2_440_588  # the Julian day of 1970-01-01
_US_PER_DAY = 86_400_000_000

NESTED_ITEM = "ROADMAP item 10b"


# ── the host codec library ─────────────────────────────────────────────────

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from ..kernels import host_library

        lib = host_library("io_codec")
        i64, i32 = ctypes.c_int64, ctypes.c_int32
        vp = ctypes.c_void_p
        for name, res, args in (
            ("srt_snappy_uncompressed_length", i64, [vp, i64]),
            ("srt_snappy_decompress", i64, [vp, i64, vp, i64]),
            ("srt_snappy_max_compressed", i64, [i64]),
            ("srt_snappy_compress", i64, [vp, i64, vp]),
            ("srt_rle_decode", i64, [vp, i64, i32, vp, i64]),
            ("srt_rle_max_encoded", i64, [i64, i32]),
            ("srt_rle_encode", i64, [vp, i64, i32, vp]),
            ("srt_byte_array_scan", i64, [vp, i64, i64, vp, vp]),
            ("srt_byte_array_encode", i64, [vp, vp, vp, i64, vp]),
            ("srt_unpack_bools", None, [vp, i64, vp]),
            ("srt_pack_bools", None, [vp, i64, vp]),
            ("srt_string_minmax", None, [vp, vp, vp, i64, vp]),
        ):
            fn = getattr(lib, name)
            fn.restype = res
            fn.argtypes = args
        _LIB = lib
    return _LIB


def _u8(buf) -> np.ndarray:
    if isinstance(buf, np.ndarray):
        return np.ascontiguousarray(buf).view(np.uint8).reshape(-1)
    return np.frombuffer(buf, dtype=np.uint8)


def _ptr(a: np.ndarray):
    return a.ctypes.data if a.size else None


def snappy_compress(buf) -> bytes:
    src = _u8(buf)
    lib = _lib()
    out = np.empty(lib.srt_snappy_max_compressed(src.size), dtype=np.uint8)
    n = lib.srt_snappy_compress(_ptr(src), src.size, out.ctypes.data)
    return out[:n].tobytes()


def snappy_decompress(buf) -> np.ndarray:
    src = _u8(buf)
    lib = _lib()
    n = lib.srt_snappy_uncompressed_length(_ptr(src), src.size)
    if n < 0:
        raise ValueError("malformed snappy stream (bad length)")
    out = np.empty(max(n, 1), dtype=np.uint8)
    got = lib.srt_snappy_decompress(_ptr(src), src.size, out.ctypes.data, n)
    if got != n:
        raise ValueError(f"malformed snappy stream (error {got})")
    return out[:n]


def rle_decode(buf, bit_width: int, count: int) -> tuple:
    """``count`` values of the RLE/bit-packed hybrid → (int32 values, bytes
    consumed)."""
    src = _u8(buf)
    out = np.empty(max(count, 1), dtype=np.int32)
    used = _lib().srt_rle_decode(_ptr(src), src.size, bit_width, out.ctypes.data, count)
    if used < 0:
        raise ValueError(f"malformed RLE/bit-packed run (error {used})")
    return out[:count], used


def rle_encode(values: np.ndarray, bit_width: int) -> bytes:
    v = np.ascontiguousarray(values, dtype=np.int32)
    lib = _lib()
    out = np.empty(lib.srt_rle_max_encoded(v.size, bit_width), dtype=np.uint8)
    n = lib.srt_rle_encode(_ptr(v), v.size, bit_width, out.ctypes.data)
    return out[:n].tobytes()


def byte_array_scan(buf, count: int) -> tuple:
    """PLAIN BYTE_ARRAY → (int32 offsets[count + 1], uint8 bytes, bytes
    consumed)."""
    src = _u8(buf)
    offsets = np.empty(count + 1, dtype=np.int32)
    data = np.empty(max(src.size, 1), dtype=np.uint8)
    used = _lib().srt_byte_array_scan(_ptr(src), src.size, count, offsets.ctypes.data,
                                      data.ctypes.data)
    if used < 0:
        raise ValueError(f"malformed PLAIN BYTE_ARRAY values (error {used})")
    return offsets, data[: offsets[-1]], used


def byte_array_encode(offsets: np.ndarray, data: np.ndarray, valid: Optional[np.ndarray]) -> bytes:
    offs = np.ascontiguousarray(offsets, dtype=np.int32)
    d = np.ascontiguousarray(data, dtype=np.uint8)
    n = offs.size - 1
    v = None if valid is None else np.ascontiguousarray(valid, dtype=np.uint8)
    cap = 4 * n + (int(offs[-1] - offs[0]) if n else 0)
    out = np.empty(max(cap, 1), dtype=np.uint8)
    got = _lib().srt_byte_array_encode(offs.ctypes.data, _ptr(d), None if v is None else _ptr(v),
                                       n, out.ctypes.data)
    return out[:got].tobytes()


def unpack_bools(buf, count: int) -> np.ndarray:
    src = _u8(buf)
    if src.size * 8 < count:
        raise ValueError("truncated bit-packed booleans")
    out = np.empty(max(count, 1), dtype=np.uint8)
    _lib().srt_unpack_bools(_ptr(src), count, out.ctypes.data)
    return out[:count].view(np.bool_)


def pack_bools(values: np.ndarray) -> bytes:
    v = np.ascontiguousarray(values, dtype=np.uint8)
    out = np.empty(max((v.size + 7) // 8, 1), dtype=np.uint8)
    _lib().srt_pack_bools(_ptr(v), v.size, out.ctypes.data)
    return out[: (v.size + 7) // 8].tobytes()


def string_minmax(offsets: np.ndarray, data: np.ndarray, valid: Optional[np.ndarray]) -> tuple:
    """Row indices of the least and greatest valid string by unsigned bytes
    ((-1, -1) when none is valid)."""
    offs = np.ascontiguousarray(offsets, dtype=np.int32)
    d = np.ascontiguousarray(data, dtype=np.uint8)
    v = None if valid is None else np.ascontiguousarray(valid, dtype=np.uint8)
    out = np.empty(2, dtype=np.int64)
    _lib().srt_string_minmax(offs.ctypes.data, _ptr(d), None if v is None else _ptr(v),
                             offs.size - 1, out.ctypes.data)
    return int(out[0]), int(out[1])


# ── codecs ─────────────────────────────────────────────────────────────────


def _codec_name(codec: int) -> str:
    return CODECS.get(codec, f"codec {codec}")


def _check_codec(codec: int, column: str) -> None:
    if codec not in (0, 1, 2):
        raise NotImplementedError(
            f"Parquet codec {_codec_name(codec)} (column {column!r}) is not supported by the "
            "port's reader: UNCOMPRESSED, SNAPPY and GZIP only")


def _decompress(page, codec: int, size: int):
    if codec == 0:
        return page
    if codec == 1:
        return snappy_decompress(page)
    out = zlib.decompress(bytes(page), 47)  # gzip or zlib framing
    if len(out) != size:
        raise ValueError("GZIP page decompressed to the wrong size")
    return out


def _compress(raw: bytes, codec: int) -> bytes:
    if codec == 0:
        return raw
    if codec == 1:
        return snappy_compress(raw)
    c = zlib.compressobj(6, zlib.DEFLATED, 31)
    return c.compress(raw) + c.flush()


# ── schema ─────────────────────────────────────────────────────────────────


class ColumnDesc:
    """One flat leaf column of a file: its physical and logical types and
    the port type it reads as (``dtype``; None with ``error`` set when the
    JAX package's reader could not type it either)."""

    def __init__(self, se: dict):
        self.name = se[F.SE_NAME].decode("utf-8")
        self.physical = se.get(F.SE_TYPE)
        self.type_length = se.get(F.SE_TYPE_LENGTH, 0)
        self.optional = se.get(F.SE_REPETITION, OPTIONAL) != REQUIRED
        self.converted = se.get(F.SE_CONVERTED)
        self.logical = se.get(F.SE_LOGICAL) or {}
        self.scale = se.get(F.SE_SCALE, 0)
        self.precision = se.get(F.SE_PRECISION, 0)
        self.unit = "us"  # timestamps: ms, us or ns
        self.signed = True
        self.error: Optional[BaseException] = None
        try:
            self.dtype = self._dtype()
        except (TypeError, ValueError) as e:
            self.dtype, self.error = None, e

    def _unsupported(self, what: str):
        return TypeError(f"unsupported Parquet column {self.name!r}: {what}")

    def _decimal(self) -> Optional[DecimalType]:
        lt = self.logical.get(F.LT_DECIMAL)
        if lt is not None:
            return DecimalType(lt.get(2, self.precision), lt.get(1, self.scale))
        if self.converted == DECIMAL_CT:
            return DecimalType(self.precision, self.scale)
        return None

    def _dtype(self) -> DataType:
        p, lt, ct = self.physical, self.logical, self.converted
        if F.LT_UNKNOWN in lt:
            return NULL
        dec = self._decimal()
        if p == BOOLEAN_T:
            return BOOLEAN
        if p in (INT32_T, INT64_T):
            if dec is not None:
                return dec
            bits, signed = (32 if p == INT32_T else 64), True
            if F.LT_INTEGER in lt:
                bits, signed = lt[F.LT_INTEGER].get(1, bits), lt[F.LT_INTEGER].get(2, True)
            elif ct in (INT_8, INT_16, INT_32, INT_64):
                bits = (8, 16, 32, 64)[ct - INT_8]
            elif ct in (UINT_8, UINT_16, UINT_32, UINT_64):
                bits, signed = (8, 16, 32, 64)[ct - UINT_8], False
            self.signed = signed
            if F.LT_DATE in lt or ct == DATE_CT:
                return DATE
            if F.LT_TIME in lt or ct in (TIME_MILLIS, TIME_MICROS):
                raise self._unsupported("TIME")
            if F.LT_TIMESTAMP in lt or ct in (TIMESTAMP_MILLIS, TIMESTAMP_MICROS):
                unit = lt.get(F.LT_TIMESTAMP, {}).get(2, {})
                self.unit = ("ms" if 1 in unit or ct == TIMESTAMP_MILLIS
                             else "ns" if 3 in unit else "us")
                return TIMESTAMP
            if signed:
                return {8: BYTE, 16: SHORT, 32: INT, 64: LONG}[bits]
            if bits == 64:
                raise self._unsupported("unsigned 64-bit integers")
            return {8: SHORT, 16: INT, 32: LONG}[bits]
        if p == INT96_T:
            self.unit = "int96"
            return TIMESTAMP
        if p == FLOAT_T:
            return FLOAT
        if p == DOUBLE_T:
            return DOUBLE
        if p in (BYTE_ARRAY_T, FLBA_T):
            if dec is not None:
                return dec
            if p == BYTE_ARRAY_T and (F.LT_STRING in lt or ct == UTF8):
                return STRING
            raise self._unsupported(f"{PHYSICAL[p]} without a string or decimal type")
        raise self._unsupported(f"physical type {p}")


def _parse_schema(elements: list) -> List[ColumnDesc]:
    """The flat leaves of a footer's schema list; a group or a repeated
    field raises, naming item 10b."""
    root = elements[0]
    n = root.get(F.SE_NUM_CHILDREN, 0)
    cols = []
    for se in elements[1:]:
        name = se.get(F.SE_NAME, b"?").decode("utf-8", "replace")
        if se.get(F.SE_NUM_CHILDREN) or se.get(F.SE_REPETITION) == REPEATED:
            raise NotImplementedError(
                f"nested Parquet column {name!r} (LIST, MAP or struct group) is not read by the "
                f"port yet: {NESTED_ITEM}")
        cols.append(ColumnDesc(se))
    if len(cols) != n:
        raise ValueError("malformed Parquet schema: the root's child count does not match")
    return cols


# ── statistics ─────────────────────────────────────────────────────────────


_EPOCH_DATE = _dt.date(1970, 1, 1)
_EPOCH_TS = _dt.datetime(1970, 1, 1, tzinfo=_dt.timezone.utc)


def _stat_value(c: ColumnDesc, raw: bytes):
    """A statistic's plain bytes → the Python value pyarrow's statistics
    give for it (int, float, str, date, UTC datetime, Decimal)."""
    p, dt = c.physical, c.dtype
    if p == BOOLEAN_T:
        return bool(raw[0])
    if p == INT32_T:
        v = struct.unpack("<i", raw[:4])[0]
        if not c.signed:
            v &= 0xFFFFFFFF
    elif p == INT64_T:
        v = struct.unpack("<q", raw[:8])[0]
    elif p == FLOAT_T:
        return struct.unpack("<f", raw[:4])[0]
    elif p == DOUBLE_T:
        return struct.unpack("<d", raw[:8])[0]
    elif p in (BYTE_ARRAY_T, FLBA_T):
        if isinstance(dt, StringType):
            return raw.decode("utf-8", "replace")
        v = int.from_bytes(raw, "big", signed=True)
    else:
        return None
    if isinstance(dt, DecimalType):
        return _dec.Decimal(v).scaleb(-dt.scale)
    if isinstance(dt, DateType):
        return _EPOCH_DATE + _dt.timedelta(days=v)
    if isinstance(dt, TimestampType):
        us = v * 1000 if c.unit == "ms" else v // 1000 if c.unit == "ns" else v
        return _EPOCH_TS + _dt.timedelta(microseconds=us)
    return v


class ChunkStats:
    """min, max and null count of one column chunk (``has_min_max`` as
    pyarrow's statistics say it)."""

    def __init__(self, c: ColumnDesc, st: dict):
        self.physical_type = PHYSICAL[c.physical]
        self.null_count = st.get(F.ST_NULL_COUNT)
        mn, mx = st.get(F.ST_MIN_VALUE), st.get(F.ST_MAX_VALUE)
        if (mn is None or mx is None) and not isinstance(c.dtype, StringType) \
                and c.physical != FLBA_T:
            # the deprecated fields hold signed-order values: good for
            # numbers only
            mn, mx = st.get(F.ST_MIN), st.get(F.ST_MAX)
        self.has_min_max = mn is not None and mx is not None and c.dtype is not None
        self.min = _stat_value(c, mn) if self.has_min_max else None
        self.max = _stat_value(c, mx) if self.has_min_max else None


# ── reader ─────────────────────────────────────────────────────────────────


class ParquetFile:
    """One Parquet file (a path, or the bytes of one) for reading: its
    schema, row groups and their statistics, and batches of chosen columns
    and row groups."""

    def __init__(self, source):
        if isinstance(source, (bytes, bytearray, memoryview)):
            self._f = io.BytesIO(source)
            self.path = "<bytes>"
        else:
            self._f = open(source, "rb")
            self.path = source
        try:
            self._read_footer()
        except BaseException:
            self._f.close()
            raise

    def _read_footer(self) -> None:
        f = self._f
        f.seek(0, os.SEEK_END)
        size = f.tell()
        if size < 12:
            raise ValueError(f"{self.path}: not a Parquet file (too short)")
        f.seek(size - 8)
        tail = f.read(8)
        if tail[4:] != MAGIC:
            raise ValueError(f"{self.path}: not a Parquet file (no PAR1 magic at the end)")
        flen = struct.unpack("<I", tail[:4])[0]
        if flen + 12 > size:
            raise ValueError(f"{self.path}: Parquet footer length past the file start")
        f.seek(size - 8 - flen)
        meta, _ = T.read_struct(f.read(flen))
        self.num_rows = meta.get(F.FMD_NUM_ROWS, 0)
        self.columns = _parse_schema(meta[F.FMD_SCHEMA])
        self._by_name = {c.name: i for i, c in enumerate(self.columns)}
        self._row_groups = meta.get(F.FMD_ROW_GROUPS, [])

    @property
    def schema(self) -> Schema:
        """The port's schema (raises as the JAX package's
        ``Schema.from_arrow`` would for a column it cannot type)."""
        fields = []
        for c in self.columns:
            if c.error is not None:
                raise c.error
            fields.append(StructField(c.name, c.dtype, c.optional))
        return Schema(fields)

    @property
    def num_row_groups(self) -> int:
        return len(self._row_groups)

    def row_group_num_rows(self, i: int) -> int:
        return self._row_groups[i][F.RG_NUM_ROWS]

    def _chunk_meta(self, rg: int, name: str) -> dict:
        return self._row_groups[rg][F.RG_COLUMNS][self._by_name[name]][F.CC_META]

    def statistics(self, rg: int, name: str) -> Optional[ChunkStats]:
        """A column chunk's statistics, or None when it has none."""
        if name not in self._by_name:
            return None
        st = self._chunk_meta(rg, name).get(F.CM_STATS)
        if st is None:
            return None
        return ChunkStats(self.columns[self._by_name[name]], st)

    def byte_sizes(self) -> tuple:
        """(uncompressed, compressed) bytes of every column chunk's pages,
        headers included, as the footer records them."""
        unc = comp = 0
        for rg in self._row_groups:
            for cc in rg[F.RG_COLUMNS]:
                unc += cc[F.CC_META][F.CM_UNCOMPRESSED]
                comp += cc[F.CC_META][F.CM_COMPRESSED]
        return unc, comp

    def read_row_group(self, rg: int, names=None) -> HostBatch:
        """The chosen columns of one row group: the chunks' bytes read in
        turn, then decoded on the decode pool (the codec library's calls
        release the interpreter lock)."""
        names = list(self._by_name) if names is None else list(names)
        n = self.row_group_num_rows(rg)
        descs, raws, fields = [], [], []
        for name in names:
            c = self.columns[self._by_name[name]]
            if c.error is not None:
                raise c.error
            cm = self._chunk_meta(rg, name)
            descs.append((c, cm))
            raws.append(self._chunk_bytes(c, cm))
            fields.append(StructField(c.name, c.dtype, c.optional))
        jobs = [(c, cm, raw, n) for (c, cm), raw in zip(descs, raws)]
        if len(jobs) > 1:
            cols = list(_decode_pool().map(lambda j: self._decode_chunk(*j), jobs))
        else:
            cols = [self._decode_chunk(*j) for j in jobs]
        return HostBatch(Schema(fields), cols, n)

    def read(self, columns=None) -> HostBatch:
        names = list(self._by_name) if columns is None else list(columns)
        parts = [self.read_row_group(rg, names) for rg in range(self.num_row_groups)]
        if not parts:
            from ..columnar.host import empty_host_batch

            return empty_host_batch(Schema([
                StructField(c.name, c.dtype, c.optional)
                for c in (self.columns[self._by_name[n]] for n in names)
            ]))
        return concat_batches(parts[0].schema, parts)

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ── column chunks ─────────────────────────────────────────────────────

    def _chunk_bytes(self, c: ColumnDesc, cm: dict) -> memoryview:
        """The pages of one column chunk, as stored."""
        _check_codec(cm.get(F.CM_CODEC, 0), c.name)
        start = cm[F.CM_DATA_OFFSET]
        dict_off = cm.get(F.CM_DICT_OFFSET)
        if dict_off is not None and 0 < dict_off < start:
            start = dict_off
        self._f.seek(start)
        return memoryview(self._f.read(cm[F.CM_COMPRESSED]))

    def _decode_chunk(self, c: ColumnDesc, cm: dict, buf: memoryview,
                      num_rows: int) -> HostColumn:
        codec = cm.get(F.CM_CODEC, 0)
        pos, rows, dictionary = 0, 0, None
        valids, values = [], []
        while rows < num_rows and pos < len(buf):
            ph, pos = T.read_struct(buf, pos)
            ptype = ph[F.PH_TYPE]
            size = ph[F.PH_COMPRESSED]
            page = buf[pos : pos + size]
            pos += size
            if ptype == DICTIONARY_PAGE:
                dh = ph[F.PH_DICT]
                enc = dh.get(F.DICT_ENCODING, PLAIN)
                if enc not in (PLAIN, PLAIN_DICTIONARY):
                    raise NotImplementedError(self._encoding_msg(c, enc))
                raw = _decompress(page, codec, ph[F.PH_UNCOMPRESSED])
                dictionary = self._plain(c, raw, dh[F.DICT_NUM_VALUES])[0]
                continue
            if ptype == DATA_PAGE:
                dp = ph[F.PH_DATA]
                n, enc = dp[F.DP_NUM_VALUES], dp[F.DP_ENCODING]
                raw = _u8(_decompress(page, codec, ph[F.PH_UNCOMPRESSED]))
                off = 0
                if c.optional:
                    ln = int(raw[:4].view("<u4")[0]) if raw.size >= 4 else -1
                    if ln < 0 or 4 + ln > raw.size:
                        raise ValueError(f"{self.path}: column {c.name!r}: bad definition levels")
                    valid = rle_decode(raw[4 : 4 + ln], 1, n)[0].astype(bool)
                    off = 4 + ln
                else:
                    valid = np.ones(n, dtype=bool)
                body = raw[off:]
            elif ptype == DATA_PAGE_V2:
                v2 = ph[F.PH_DATA_V2]
                n, enc = v2[F.V2_NUM_VALUES], v2[F.V2_ENCODING]
                dlen, rlen = v2.get(F.V2_DEF_BYTES, 0), v2.get(F.V2_REP_BYTES, 0)
                levels = _u8(page[rlen : rlen + dlen])
                if c.optional and dlen:
                    valid = rle_decode(levels, 1, n)[0].astype(bool)
                else:
                    valid = np.ones(n, dtype=bool)
                body = page[rlen + dlen :]
                if v2.get(F.V2_IS_COMPRESSED, True):
                    body = _decompress(body, codec, ph[F.PH_UNCOMPRESSED] - rlen - dlen)
                body = _u8(body)
            else:  # an index page: nothing to read
                continue
            nvalid = int(valid.sum())
            if enc == PLAIN:
                vals = self._plain(c, body, nvalid)[0]
            elif enc in (PLAIN_DICTIONARY, RLE_DICTIONARY):
                if dictionary is None:
                    raise ValueError(f"{self.path}: column {c.name!r}: dictionary page missing")
                if nvalid:
                    idx = rle_decode(body[1:], int(body[0]), nvalid)[0]
                    vals = _take(dictionary, idx)
                else:
                    vals = _take(dictionary, np.zeros(0, dtype=np.int32))
            elif enc == RLE and c.physical == BOOLEAN_T:
                ln = int(body[:4].view("<u4")[0])
                vals = rle_decode(body[4 : 4 + ln], 1, nvalid)[0].astype(bool)
            else:
                raise NotImplementedError(self._encoding_msg(c, enc))
            valids.append(valid)
            values.append(vals)
            rows += n
        if rows != num_rows:
            raise ValueError(f"{self.path}: column {c.name!r}: {rows} rows in the pages, "
                             f"{num_rows} in the row group")
        return _assemble(c.dtype, valids, values, num_rows)

    def _encoding_msg(self, c: ColumnDesc, enc: int) -> str:
        return (f"Parquet encoding {ENCODINGS.get(enc, enc)} (column {c.name!r} of {self.path}) "
                "is not supported by the port's reader: PLAIN, PLAIN_DICTIONARY/RLE_DICTIONARY "
                "and RLE (levels, booleans) only")

    def _plain(self, c: ColumnDesc, raw, count: int):
        """``count`` PLAIN values → the port's storage (an array, or
        (offsets, bytes) for strings), and the bytes consumed."""
        raw = _u8(raw)
        p, dt = c.physical, c.dtype
        if p == BYTE_ARRAY_T:
            offsets, data, used = byte_array_scan(raw, count)
            if isinstance(dt, DecimalType):
                return _be_decimals_var(offsets, data), used
            return (offsets, data), used
        if p == BOOLEAN_T:
            return unpack_bools(raw, count), (count + 7) // 8
        width = {INT32_T: 4, INT64_T: 8, INT96_T: 12, FLOAT_T: 4, DOUBLE_T: 8,
                 FLBA_T: c.type_length}[p]
        need = width * count
        if raw.size < need:
            raise ValueError(f"{self.path}: column {c.name!r}: truncated PLAIN values")
        body = raw[:need]
        if p == FLBA_T:
            return _be_decimals_fixed(body.reshape(count, width)), need
        if p == INT96_T:
            rec = body.reshape(count, 12)
            nanos = rec[:, :8].copy().view("<i8").reshape(-1)
            days = rec[:, 8:].copy().view("<i4").reshape(-1).astype(np.int64)
            return (days - _JULIAN_EPOCH) * _US_PER_DAY + nanos // 1000, need
        v = body.view({INT32_T: "<i4", INT64_T: "<i8", FLOAT_T: "<f4", DOUBLE_T: "<f8"}[p])
        if isinstance(dt, NullType):
            return np.zeros(count, dtype=np.int8), need
        if p == INT32_T and not c.signed:
            v = v.view("<u4")
        if isinstance(dt, TimestampType):
            v = v * 1000 if c.unit == "ms" else v // 1000 if c.unit == "ns" else v
        return v.astype(dt.np_dtype), need


_POOL = None
_POOL_LOCK = threading.Lock()


def _decode_pool() -> ThreadPoolExecutor:
    """The process's column-decode threads, started at first use."""
    global _POOL
    with _POOL_LOCK:
        if _POOL is None:
            _POOL = ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1),
                                       thread_name_prefix="srt-parquet-decode")
        return _POOL


def _be_decimals_fixed(rows: np.ndarray) -> np.ndarray:
    """Big-endian two's-complement fixed-width decimals → int64."""
    n, w = rows.shape
    if w > 8:
        raise ValueError("decimal wider than 8 bytes in a DECIMAL64 column")
    sign = np.where(rows[:, :1] & 0x80, np.uint8(0xFF), np.uint8(0))
    full = np.concatenate([np.repeat(sign, 8 - w, axis=1), rows], axis=1)
    return np.ascontiguousarray(full).view(">i8").reshape(-1).astype(np.int64)


def _be_decimals_var(offsets: np.ndarray, data: np.ndarray) -> np.ndarray:
    raw = data.tobytes()
    o = offsets.tolist()
    return np.array([int.from_bytes(raw[o[i]:o[i + 1]], "big", signed=True)
                     for i in range(len(o) - 1)], dtype=np.int64)


def _take(dictionary, idx: np.ndarray):
    """Dictionary values at ``idx`` (strings as (offsets, bytes))."""
    idx = idx.astype(np.int64)
    if isinstance(dictionary, tuple):
        offs, data = dictionary
        n = len(offs) - 1
        if idx.size and (idx.min() < 0 or idx.max() >= n):
            raise ValueError("dictionary index out of range")
        col = HostColumn(STRING, data, np.ones(n, dtype=bool), offs)
        t = col.take(idx)
        return t.offsets, t.data
    if idx.size and (idx.min() < 0 or idx.max() >= len(dictionary)):
        raise ValueError("dictionary index out of range")
    return dictionary[idx]


def _assemble(dt: DataType, valids: list, values: list, n: int) -> HostColumn:
    """One chunk's pages → a host column: non-null values scattered to
    their rows, null slots zero (strings empty)."""
    valid = np.concatenate(valids) if valids else np.zeros(0, dtype=bool)
    all_valid = bool(valid.all())
    if isinstance(dt, StringType):
        lens = np.concatenate([np.diff(o) for o, _ in values]) if values else np.zeros(0, np.int32)
        data = np.concatenate([d for _, d in values]) if values else np.zeros(0, np.uint8)
        full = lens if all_valid else np.zeros(n, dtype=np.int64)
        if not all_valid:
            full[valid] = lens
        offsets = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(full, out=offsets[1:])
        return HostColumn(dt, data, valid, _offsets32(offsets))
    vals = np.concatenate(values) if values else np.zeros(0, dtype=dt.np_dtype)
    vals = vals.astype(dt.np_dtype, copy=False)
    if all_valid:
        return HostColumn(dt, np.ascontiguousarray(vals), valid)
    data = np.zeros(n, dtype=dt.np_dtype)
    data[valid] = vals
    return HostColumn(dt, data, valid)


def read_schema(path) -> Schema:
    with ParquetFile(path) as pf:
        return pf.schema


def read_table(source, columns=None) -> HostBatch:
    """A whole file (a path or its bytes) as one host batch."""
    with ParquetFile(source) as pf:
        return pf.read(columns)


# ── writer ─────────────────────────────────────────────────────────────────


def _decimal_bytes(precision: int) -> int:
    """The fewest bytes that hold every unscaled value of ``precision``
    digits in two's complement (pyarrow's FIXED_LEN_BYTE_ARRAY width)."""
    n = 1
    while 10 ** precision - 1 >= 1 << (8 * n - 1):
        n += 1
    return n


def _schema_element(f: StructField) -> tuple:
    """(the footer's SchemaElement of one flat column, its physical type,
    its fixed byte width), with Spark's types as pyarrow writes them."""
    dt = f.data_type
    if is_complex(dt):
        raise NotImplementedError(
            f"writing the nested column {f.name!r} ({dt.simple_string}) to Parquet is not "
            f"supported by the port yet: {NESTED_ITEM}")
    lt = ct = None
    type_length = scale = precision = None
    if isinstance(dt, BooleanType):
        phys = BOOLEAN_T
    elif isinstance(dt, ByteType):
        phys, ct = INT32_T, INT_8
        lt = [(F.LT_INTEGER, T.STRUCT, [(1, T.BYTE, 8), (2, T.BOOL, True)])]
    elif isinstance(dt, ShortType):
        phys, ct = INT32_T, INT_16
        lt = [(F.LT_INTEGER, T.STRUCT, [(1, T.BYTE, 16), (2, T.BOOL, True)])]
    elif isinstance(dt, DateType):
        phys, ct = INT32_T, DATE_CT
        lt = [(F.LT_DATE, T.STRUCT, [])]
    elif isinstance(dt, IntegerType):
        phys = INT32_T
    elif isinstance(dt, TimestampType):
        phys, ct = INT64_T, TIMESTAMP_MICROS
        lt = [(F.LT_TIMESTAMP, T.STRUCT,
               [(1, T.BOOL, True), (2, T.STRUCT, [(2, T.STRUCT, [])])])]
    elif isinstance(dt, LongType):
        phys = INT64_T
    elif isinstance(dt, FloatType):
        phys = FLOAT_T
    elif isinstance(dt, DoubleType):
        phys = DOUBLE_T
    elif isinstance(dt, StringType):
        phys, ct = BYTE_ARRAY_T, UTF8
        lt = [(F.LT_STRING, T.STRUCT, [])]
    elif isinstance(dt, DecimalType):
        phys, ct = FLBA_T, DECIMAL_CT
        type_length, scale, precision = _decimal_bytes(dt.precision), dt.scale, dt.precision
        lt = [(F.LT_DECIMAL, T.STRUCT, [(1, T.I32, dt.scale), (2, T.I32, dt.precision)])]
    elif isinstance(dt, NullType):
        phys = INT32_T
        lt = [(F.LT_UNKNOWN, T.STRUCT, [])]
    else:
        raise NotImplementedError(f"cannot write column {f.name!r} of type {dt} to Parquet")
    return [
        (F.SE_TYPE, T.I32, phys),
        (F.SE_TYPE_LENGTH, T.I32, type_length),
        (F.SE_REPETITION, T.I32, OPTIONAL),
        (F.SE_NAME, T.BINARY, f.name),
        (F.SE_CONVERTED, T.I32, ct),
        (F.SE_SCALE, T.I32, scale),
        (F.SE_PRECISION, T.I32, precision),
        (F.SE_LOGICAL, T.STRUCT, lt),
    ], phys, type_length


class ParquetWriter:
    """Writes host batches to one Parquet file (a path or a binary file
    object), one row group per batch cut at :data:`ROW_GROUP_ROWS` rows.
    ``compression``: none/uncompressed, snappy (the default) or gzip."""

    def __init__(self, where, schema: Schema, compression: str = "snappy"):
        codec = CODEC_IDS.get(str(compression or "snappy").lower())
        if codec is None:
            raise NotImplementedError(
                f"Parquet codec {compression!r} is not supported by the port's writer: "
                "none, snappy or gzip")
        self.codec = codec
        self.schema = schema
        self._elements = [_schema_element(f) for f in schema]
        self._own = not hasattr(where, "write")
        self._f = open(where, "wb") if self._own else where
        self._f.write(MAGIC)
        self._pos = len(MAGIC)
        self._row_groups: list = []
        self.num_rows = 0

    def write_batch(self, hb: HostBatch) -> None:
        for off in range(0, hb.num_rows, ROW_GROUP_ROWS):
            part = hb if hb.num_rows <= ROW_GROUP_ROWS else hb.slice(off, ROW_GROUP_ROWS)
            self._write_row_group(part)

    def _write_row_group(self, hb: HostBatch) -> None:
        start = self._pos
        chunks, total, compressed = [], 0, 0
        for (_se, phys, tlen), f, col in zip(self._elements, self.schema, hb.columns):
            first, meta, unc, comp = self._write_chunk(f, col, phys, tlen)
            chunks.append([(F.CC_FILE_OFFSET, T.I64, first), (F.CC_META, T.STRUCT, meta)])
            total += unc
            compressed += comp
        self._row_groups.append([
            (F.RG_COLUMNS, T.LIST, (T.STRUCT, chunks)),
            (F.RG_TOTAL_BYTES, T.I64, total),
            (F.RG_NUM_ROWS, T.I64, hb.num_rows),
            (F.RG_FILE_OFFSET, T.I64, start),
            (F.RG_COMPRESSED, T.I64, compressed),
        ])
        self.num_rows += hb.num_rows

    def _values(self, col: HostColumn, phys: int, tlen: int):
        """(PLAIN bytes of the valid values, byte end of each valid value)
        — booleans are packed per page, so they return the values."""
        valid = col.validity
        if phys == BYTE_ARRAY_T:
            offs = col.offsets
            enc = byte_array_encode(offs, col.data, None if valid.all() else valid)
            lens = np.diff(offs).astype(np.int64)[valid] + 4
            return enc, np.cumsum(lens)
        if phys == BOOLEAN_T:
            return col.data[valid], None
        data = col.data[valid] if not valid.all() else col.data
        if phys == FLBA_T:
            raw = np.ascontiguousarray(data.astype(">i8")).view(np.uint8).reshape(-1, 8)
            raw = raw[:, 8 - tlen :]
            return np.ascontiguousarray(raw).tobytes(), None
        np_t = {INT32_T: "<i4", INT64_T: "<i8", FLOAT_T: "<f4", DOUBLE_T: "<f8"}[phys]
        return np.ascontiguousarray(data.astype(np_t)).tobytes(), None

    def _write_chunk(self, f: StructField, col: HostColumn, phys: int, tlen: int):
        n = len(col)
        valid = np.ascontiguousarray(col.validity, dtype=bool)
        width = {INT32_T: 4, INT64_T: 8, FLOAT_T: 4, DOUBLE_T: 8, FLBA_T: tlen,
                 BOOLEAN_T: 1}.get(phys)
        values, ends = self._values(col, phys, tlen)
        # rows per page: cut where the values' bytes pass each PAGE_BYTES
        nvalid_before = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(valid, out=nvalid_before[1:])
        if ends is None:
            per = max(1, PAGE_BYTES // max(width, 1))
            cuts = list(range(0, n, per)) + [n]
            if phys == BOOLEAN_T:
                cuts = list(range(0, n, PAGE_BYTES * 8)) + [n]
        else:
            byte_at = np.concatenate([[0], ends])[nvalid_before]  # bytes before each row
            marks = np.searchsorted(byte_at, np.arange(PAGE_BYTES, int(byte_at[-1]) + 1,
                                                       PAGE_BYTES), side="right") - 1
            cuts = sorted(set([0, n] + [int(m) for m in marks if 0 < m < n]))
        if n == 0:
            cuts = [0, 0]
        first = self._pos
        unc_total = comp_total = 0
        for r0, r1 in zip(cuts[:-1], cuts[1:]):
            v0, v1 = int(nvalid_before[r0]), int(nvalid_before[r1])
            if phys == BOOLEAN_T:
                body = pack_bools(values[v0:v1])
            elif ends is not None:
                b0 = int(ends[v0 - 1]) if v0 else 0
                b1 = int(ends[v1 - 1]) if v1 else 0
                body = values[b0:b1]
            else:
                body = values[v0 * width : v1 * width]
            levels = rle_encode(valid[r0:r1].view(np.uint8).astype(np.int32), 1)
            raw = struct.pack("<I", len(levels)) + levels + body
            comp = _compress(raw, self.codec)
            header = T.write_struct([
                (F.PH_TYPE, T.I32, DATA_PAGE),
                (F.PH_UNCOMPRESSED, T.I32, len(raw)),
                (F.PH_COMPRESSED, T.I32, len(comp)),
                (F.PH_DATA, T.STRUCT, [
                    (F.DP_NUM_VALUES, T.I32, r1 - r0),
                    (F.DP_ENCODING, T.I32, PLAIN),
                    (F.DP_DEF_ENCODING, T.I32, RLE),
                    (F.DP_REP_ENCODING, T.I32, RLE),
                ]),
            ])
            self._f.write(header)
            self._f.write(comp)
            self._pos += len(header) + len(comp)
            unc_total += len(header) + len(raw)
            comp_total += len(header) + len(comp)
        meta = [
            (F.CM_TYPE, T.I32, phys),
            (F.CM_ENCODINGS, T.LIST, (T.I32, [PLAIN, RLE])),
            (F.CM_PATH, T.LIST, (T.BINARY, [f.name])),
            (F.CM_CODEC, T.I32, self.codec),
            (F.CM_NUM_VALUES, T.I64, n),
            (F.CM_UNCOMPRESSED, T.I64, unc_total),
            (F.CM_COMPRESSED, T.I64, comp_total),
            (F.CM_DATA_OFFSET, T.I64, first),
            (F.CM_STATS, T.STRUCT, _statistics(col, phys, tlen, valid)),
        ]
        return first, meta, unc_total, comp_total

    def close(self) -> None:
        if self._f is None:
            return
        ncols = len(self.schema)
        schema = [[(F.SE_NAME, T.BINARY, "schema"), (F.SE_NUM_CHILDREN, T.I32, ncols)]]
        schema += [se for se, _p, _t in self._elements]
        footer = T.write_struct([
            (F.FMD_VERSION, T.I32, 1),
            (F.FMD_SCHEMA, T.LIST, (T.STRUCT, schema)),
            (F.FMD_NUM_ROWS, T.I64, self.num_rows),
            (F.FMD_ROW_GROUPS, T.LIST, (T.STRUCT, self._row_groups)),
            (F.FMD_CREATED_BY, T.BINARY, "spark_rapids_tpu_torch"),
            # TYPE_ORDER for every column: min/max are in the type's order
            (F.FMD_COLUMN_ORDERS, T.LIST, (T.STRUCT, [[(1, T.STRUCT, [])]] * ncols)),
        ])
        self._f.write(footer)
        self._f.write(struct.pack("<I", len(footer)) + MAGIC)
        if self._own:
            self._f.close()
        self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _statistics(col: HostColumn, phys: int, tlen: int, valid: np.ndarray) -> list:
    """min_value/max_value (plain bytes) and null_count of one chunk."""
    nulls = int(len(valid) - valid.sum())
    out = [(F.ST_NULL_COUNT, T.I64, nulls)]
    if nulls == len(valid) or isinstance(col.dtype, NullType):
        return out
    if phys == BYTE_ARRAY_T:
        lo, hi = string_minmax(col.offsets, col.data, None if nulls == 0 else valid)
        o = col.offsets
        mn, mx = col.data[o[lo]:o[lo + 1]].tobytes(), col.data[o[hi]:o[hi + 1]].tobytes()
    else:
        vals = col.data[valid] if nulls else col.data
        if phys in (FLOAT_T, DOUBLE_T) and np.isnan(vals).any():
            return out  # NaN-blind min/max would mislead a reader
        lo, hi = vals.min(), vals.max()
        if phys == BOOLEAN_T:
            mn, mx = bytes([int(lo)]), bytes([int(hi)])
        elif phys == FLBA_T:
            mn = int(lo).to_bytes(8, "big", signed=True)[8 - tlen :]
            mx = int(hi).to_bytes(8, "big", signed=True)[8 - tlen :]
        else:
            fmt = {INT32_T: "<i", INT64_T: "<q", FLOAT_T: "<f", DOUBLE_T: "<d"}[phys]
            cast = float if phys in (FLOAT_T, DOUBLE_T) else int
            mn, mx = struct.pack(fmt, cast(lo)), struct.pack(fmt, cast(hi))
    return out + [(F.ST_MAX_VALUE, T.BINARY, mx), (F.ST_MIN_VALUE, T.BINARY, mn)]


def write_table(hb: HostBatch, where, compression: str = "snappy") -> None:
    """One host batch as a whole file (a path or a binary file object)."""
    with ParquetWriter(where, hb.schema, compression) as w:
        w.write_batch(hb)


__all__ = [
    "ParquetFile",
    "ParquetWriter",
    "read_schema",
    "read_table",
    "write_table",
]
