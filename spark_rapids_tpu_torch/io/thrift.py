"""Thrift compact protocol for the Parquet footer and page headers.

The port's Parquet reader and writer (``io/parquet.py``) read and write
``parquet.thrift``'s structures themselves, where the JAX package has
pyarrow do it. The compact protocol carries each field's type beside its id,
so :func:`read_struct` decodes any struct generically into a dict of field
id → value (a nested struct as a dict, a list as a list, binary as bytes),
and fields the port does not know (pyarrow 25's size statistics, page
indexes, the ``ARROW:schema`` blob, encryption) are skipped by their type,
as pyarrow skips them. :func:`write_struct` encodes a list of
``(field id, type, value)`` triples, a ``None`` value omitted.

The ids the port reads are named in :class:`F`, by structure, from
``parquet.thrift``.
"""
from __future__ import annotations

import struct
from typing import Tuple

# compact-protocol type codes
BOOL_TRUE, BOOL_FALSE, BYTE, I16, I32, I64, DOUBLE, BINARY, LIST, SET, MAP, STRUCT = range(1, 13)
#: a boolean field value in :func:`write_struct` (its type code carries it)
BOOL = BOOL_TRUE


class ThriftError(ValueError):
    """A malformed or truncated compact-protocol structure."""


def _varint(buf, pos: int) -> Tuple[int, int]:
    out = shift = 0
    n = len(buf)
    while True:
        if pos >= n:
            raise ThriftError("truncated varint")
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7
        if shift > 70:
            raise ThriftError("varint too long")


def _zigzag(v: int) -> int:
    return (v >> 1) ^ -(v & 1)


def _read_value(buf, pos: int, ttype: int):
    if ttype == BOOL_TRUE:
        return True, pos
    if ttype == BOOL_FALSE:
        return False, pos
    if ttype == BYTE:
        if pos >= len(buf):
            raise ThriftError("truncated byte")
        b = buf[pos]
        return (b - 256 if b > 127 else b), pos + 1
    if ttype in (I16, I32, I64):
        v, pos = _varint(buf, pos)
        return _zigzag(v), pos
    if ttype == DOUBLE:
        if pos + 8 > len(buf):
            raise ThriftError("truncated double")
        return struct.unpack_from("<d", buf, pos)[0], pos + 8
    if ttype == BINARY:
        n, pos = _varint(buf, pos)
        if pos + n > len(buf):
            raise ThriftError("truncated binary")
        return bytes(buf[pos : pos + n]), pos + n
    if ttype in (LIST, SET):
        return _read_list(buf, pos)
    if ttype == MAP:
        n, pos = _varint(buf, pos)
        out = {}
        if n:
            if pos >= len(buf):
                raise ThriftError("truncated map")
            kt, vt = buf[pos] >> 4, buf[pos] & 0x0F
            pos += 1
            for _ in range(n):
                k, pos = _read_elem(buf, pos, kt)
                v, pos = _read_elem(buf, pos, vt)
                out[k] = v
        return out, pos
    if ttype == STRUCT:
        return read_struct(buf, pos)
    raise ThriftError(f"unknown compact type {ttype}")


def _read_elem(buf, pos: int, ttype: int):
    """A list/set/map element: a boolean is a whole byte there (1 true)."""
    if ttype in (BOOL_TRUE, BOOL_FALSE):
        if pos >= len(buf):
            raise ThriftError("truncated bool")
        return buf[pos] == BOOL_TRUE, pos + 1
    return _read_value(buf, pos, ttype)


def _read_list(buf, pos: int):
    if pos >= len(buf):
        raise ThriftError("truncated list")
    head = buf[pos]
    pos += 1
    n, et = head >> 4, head & 0x0F
    if n == 15:
        n, pos = _varint(buf, pos)
    out = []
    for _ in range(n):
        v, pos = _read_elem(buf, pos, et)
        out.append(v)
    return out, pos


def read_struct(buf, pos: int = 0) -> Tuple[dict, int]:
    """Decode one struct at ``pos``: (field id → value, position after its
    stop byte)."""
    out: dict = {}
    fid = 0
    n = len(buf)
    while True:
        if pos >= n:
            raise ThriftError("truncated struct")
        head = buf[pos]
        pos += 1
        if head == 0:
            return out, pos
        delta, ttype = head >> 4, head & 0x0F
        if delta:
            fid += delta
        else:
            v, pos = _varint(buf, pos)
            fid = _zigzag(v)
        out[fid], pos = _read_value(buf, pos, ttype)


# ── writer ──────────────────────────────────────────────────────────────────


def _put_varint(out: bytearray, v: int) -> None:
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _put_zigzag(out: bytearray, v: int) -> None:
    _put_varint(out, (v << 1) ^ (v >> 63))


def _put_value(out: bytearray, ttype: int, v) -> None:
    if ttype == BYTE:
        out.append(v & 0xFF)
    elif ttype in (I16, I32, I64):
        _put_zigzag(out, int(v))
    elif ttype == DOUBLE:
        out += struct.pack("<d", v)
    elif ttype == BINARY:
        b = v.encode("utf-8") if isinstance(v, str) else bytes(v)
        _put_varint(out, len(b))
        out += b
    elif ttype == LIST:
        et, items = v
        if len(items) < 15:
            out.append((len(items) << 4) | et)
        else:
            out.append(0xF0 | et)
            _put_varint(out, len(items))
        for it in items:
            if et == BOOL_TRUE:
                out.append(BOOL_TRUE if it else BOOL_FALSE)
            else:
                _put_value(out, et, it)
    elif ttype == STRUCT:
        _put_struct(out, v)
    else:
        raise ThriftError(f"cannot write compact type {ttype}")


def _put_struct(out: bytearray, fields) -> None:
    last = 0
    for fid, ttype, v in fields:
        if v is None:
            continue
        if ttype == BOOL_TRUE:
            ttype = BOOL_TRUE if v else BOOL_FALSE
        delta = fid - last
        if 0 < delta <= 15:
            out.append((delta << 4) | ttype)
        else:
            out.append(ttype)
            _put_zigzag(out, fid)
        last = fid
        if ttype not in (BOOL_TRUE, BOOL_FALSE):
            _put_value(out, ttype, v)
    out.append(0)


def write_struct(fields) -> bytes:
    """Encode ``[(field id, type, value), ...]`` (ascending ids; a struct
    value is such a list again, a list value ``(element type, items)``; a
    ``None`` value is left out)."""
    out = bytearray()
    _put_struct(out, fields)
    return bytes(out)


class F:
    """Field ids of ``parquet.thrift`` that the port reads or writes."""

    # FileMetaData
    FMD_VERSION, FMD_SCHEMA, FMD_NUM_ROWS, FMD_ROW_GROUPS, FMD_KV, FMD_CREATED_BY = 1, 2, 3, 4, 5, 6
    FMD_COLUMN_ORDERS = 7
    # SchemaElement
    SE_TYPE, SE_TYPE_LENGTH, SE_REPETITION, SE_NAME, SE_NUM_CHILDREN = 1, 2, 3, 4, 5
    SE_CONVERTED, SE_SCALE, SE_PRECISION, SE_FIELD_ID, SE_LOGICAL = 6, 7, 8, 9, 10
    # LogicalType (a union)
    LT_STRING, LT_MAP, LT_LIST, LT_ENUM, LT_DECIMAL, LT_DATE = 1, 2, 3, 4, 5, 6
    LT_TIME, LT_TIMESTAMP, LT_INTEGER, LT_UNKNOWN, LT_JSON = 7, 8, 10, 11, 12
    # RowGroup
    RG_COLUMNS, RG_TOTAL_BYTES, RG_NUM_ROWS, RG_FILE_OFFSET, RG_COMPRESSED = 1, 2, 3, 5, 6
    # ColumnChunk
    CC_FILE_PATH, CC_FILE_OFFSET, CC_META = 1, 2, 3
    # ColumnMetaData
    CM_TYPE, CM_ENCODINGS, CM_PATH, CM_CODEC, CM_NUM_VALUES = 1, 2, 3, 4, 5
    CM_UNCOMPRESSED, CM_COMPRESSED, CM_DATA_OFFSET, CM_DICT_OFFSET, CM_STATS = 6, 7, 9, 11, 12
    # Statistics
    ST_MAX, ST_MIN, ST_NULL_COUNT, ST_MAX_VALUE, ST_MIN_VALUE = 1, 2, 3, 5, 6
    # PageHeader
    PH_TYPE, PH_UNCOMPRESSED, PH_COMPRESSED, PH_DATA, PH_DICT, PH_DATA_V2 = 1, 2, 3, 5, 7, 8
    # DataPageHeader
    DP_NUM_VALUES, DP_ENCODING, DP_DEF_ENCODING, DP_REP_ENCODING, DP_STATS = 1, 2, 3, 4, 5
    # DictionaryPageHeader
    DICT_NUM_VALUES, DICT_ENCODING = 1, 2
    # DataPageHeaderV2
    V2_NUM_VALUES, V2_NUM_NULLS, V2_NUM_ROWS, V2_ENCODING = 1, 2, 3, 4
    V2_DEF_BYTES, V2_REP_BYTES, V2_IS_COMPRESSED = 5, 6, 7
