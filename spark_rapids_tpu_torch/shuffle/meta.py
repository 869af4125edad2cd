"""Shuffle wire metadata — the FlatBuffers-schema analogue.

Reference: sql-plugin/src/main/format/*.fbs (ShuffleCommon.fbs ``TableMeta``/
``BufferMeta``/``CodecBufferDescriptor``, ShuffleMetadata request/response,
TransferRequest) built in MetaUtils.scala:46-168 and exchanged by
RapidsShuffleClient/Server. Here the same descriptors are packed with
``struct`` into versioned little-endian frames: fixed-width fields first,
then the serialized schema bytes — compact, zero-dependency, and
language-portable (a C++ peer can parse it with one ``memcpy`` per field).

Messages:
* ``MetadataRequest``  — reduce task asks a peer for the TableMetas of a
  range of partitions of the map outputs it holds.
* ``MetadataResponse`` — list of ``TableMeta``.
* ``TransferRequest``  — asks the peer to start sending the listed buffers
  as tagged data frames starting at ``base_tag``.
* ``TransferResponse`` — per-buffer acks.

Copied from ``spark_rapids_tpu/shuffle/meta.py``. ``TableMeta.schema_bytes``
holds the port's schema serialization (``columnar/ipc.py::schema_to_bytes``),
not an Arrow IPC schema message.
"""
from __future__ import annotations

import dataclasses
import struct
from typing import List, Optional, Sequence

MAGIC = 0x54505553  # "TPUS"
VERSION = 1

# codec ids (BufferMeta.codec — ShuffleCommon.fbs CodecType analogue)
CODEC_NONE = 0
CODEC_COPY = 1
CODEC_LZ4 = 2
CODEC_ZSTD = 3


@dataclasses.dataclass(frozen=True)
class BufferMeta:
    """Describes one contiguous (possibly compressed) buffer
    (ShuffleCommon.fbs:29-60)."""

    buffer_id: int
    size: int  # on-wire (possibly compressed) size in bytes
    uncompressed_size: int
    codec: int = CODEC_NONE

    _FMT = "<qqqi"

    def pack(self) -> bytes:
        return struct.pack(
            self._FMT, self.buffer_id, self.size, self.uncompressed_size, self.codec
        )

    @classmethod
    def unpack(cls, buf: memoryview, off: int) -> tuple["BufferMeta", int]:
        vals = struct.unpack_from(cls._FMT, buf, off)
        return cls(*vals), off + struct.calcsize(cls._FMT)


@dataclasses.dataclass(frozen=True)
class TableMeta:
    """Metadata for one shuffle-cached columnar batch: identity + row count +
    the schema needed to deserialize it (MetaUtils.buildTableMeta)."""

    shuffle_id: int
    map_id: int
    partition_id: int
    batch_id: int
    num_rows: int
    buffer: BufferMeta
    schema_bytes: bytes  # columnar/ipc.py::schema_to_bytes

    _FMT = "<qqqqq"

    def pack(self) -> bytes:
        head = struct.pack(
            self._FMT,
            self.shuffle_id,
            self.map_id,
            self.partition_id,
            self.batch_id,
            self.num_rows,
        )
        return (
            head
            + self.buffer.pack()
            + struct.pack("<i", len(self.schema_bytes))
            + self.schema_bytes
        )

    @classmethod
    def unpack(cls, buf: memoryview, off: int) -> tuple["TableMeta", int]:
        vals = struct.unpack_from(cls._FMT, buf, off)
        off += struct.calcsize(cls._FMT)
        bm, off = BufferMeta.unpack(buf, off)
        (n,) = struct.unpack_from("<i", buf, off)
        off += 4
        schema = bytes(buf[off : off + n])
        off += n
        return cls(*vals, bm, schema), off


def _pack_list(items: Sequence, pack_one) -> bytes:
    out = [struct.pack("<iii", MAGIC, VERSION, len(items))]
    out.extend(pack_one(i) for i in items)
    return b"".join(out)


def _unpack_header(buf: memoryview) -> tuple[int, int]:
    magic, version, n = struct.unpack_from("<iii", buf, 0)
    if magic != MAGIC:
        raise ValueError(f"bad shuffle frame magic {magic:#x}")
    if version != VERSION:
        raise ValueError(f"unsupported shuffle frame version {version}")
    return n, struct.calcsize("<iii")


@dataclasses.dataclass(frozen=True)
class BlockId:
    """One requested map-output range (ShuffleMetadata request entry)."""

    shuffle_id: int
    map_id: int
    start_partition: int
    end_partition: int  # exclusive

    _FMT = "<qqii"

    def pack(self) -> bytes:
        return struct.pack(
            self._FMT,
            self.shuffle_id,
            self.map_id,
            self.start_partition,
            self.end_partition,
        )

    @classmethod
    def unpack(cls, buf: memoryview, off: int) -> tuple["BlockId", int]:
        vals = struct.unpack_from(cls._FMT, buf, off)
        return cls(*vals), off + struct.calcsize(cls._FMT)


def pack_metadata_request(blocks: Sequence[BlockId], trace=None) -> bytes:
    """Blocks, plus an OPTIONAL length-prefixed JSON span-context tail
    (obs/trace.py SpanContext.to_wire) — cross-process trace propagation:
    the serving executor's fetch-serve span joins the requesting query's
    trace. Old unpackers read exactly ``n`` blocks and never look past
    them, so the tail is wire-compatible within the same frame version."""
    out = _pack_list(blocks, BlockId.pack)
    if trace:
        import json

        blob = json.dumps(trace).encode("utf-8")
        out += struct.pack("<i", len(blob)) + blob
    return out


def unpack_metadata_request(data: bytes) -> List[BlockId]:
    buf = memoryview(data)
    n, off = _unpack_header(buf)
    out = []
    for _ in range(n):
        b, off = BlockId.unpack(buf, off)
        out.append(b)
    return out


def unpack_metadata_trace(data: bytes):
    """The optional span-context tail of a metadata request (None when
    absent or unreadable — propagation is best-effort by design)."""
    import json

    buf = memoryview(data)
    try:
        n, off = _unpack_header(buf)
        off += n * struct.calcsize(BlockId._FMT)
        if len(buf) < off + 4:
            return None
        (ln,) = struct.unpack_from("<i", buf, off)
        off += 4
        if ln <= 0 or len(buf) < off + ln:
            return None
        return json.loads(bytes(buf[off:off + ln]).decode("utf-8"))
    except (ValueError, UnicodeDecodeError):
        return None


def pack_metadata_response(metas: Sequence[TableMeta]) -> bytes:
    return _pack_list(metas, TableMeta.pack)


def unpack_metadata_response(data: bytes) -> List[TableMeta]:
    buf = memoryview(data)
    n, off = _unpack_header(buf)
    out = []
    for _ in range(n):
        m, off = TableMeta.unpack(buf, off)
        out.append(m)
    return out


@dataclasses.dataclass(frozen=True)
class TransferRequest:
    """Ask the server to stream these buffers as data frames tagged
    ``base_tag + i`` (ShuffleTransferRequest.fbs analogue)."""

    base_tag: int
    buffer_ids: tuple

    def pack(self) -> bytes:
        head = struct.pack("<iiq i".replace(" ", ""), MAGIC, VERSION, self.base_tag, len(self.buffer_ids))
        return head + struct.pack(f"<{len(self.buffer_ids)}q", *self.buffer_ids)

    @classmethod
    def unpack(cls, data: bytes) -> "TransferRequest":
        buf = memoryview(data)
        magic, version, base_tag, n = struct.unpack_from("<iiqi", buf, 0)
        if magic != MAGIC or version != VERSION:
            raise ValueError("bad transfer request frame")
        off = struct.calcsize("<iiqi")
        ids = struct.unpack_from(f"<{n}q", buf, off)
        return cls(base_tag, tuple(ids))


@dataclasses.dataclass(frozen=True)
class TransferResponse:
    """Per-buffer acceptance (0 = queued, 1 = unknown buffer)."""

    states: tuple

    def pack(self) -> bytes:
        return struct.pack(f"<iii{len(self.states)}b", MAGIC, VERSION, len(self.states), *self.states)

    @classmethod
    def unpack(cls, data: bytes) -> "TransferResponse":
        buf = memoryview(data)
        n, off = _unpack_header(buf)
        return cls(struct.unpack_from(f"<{n}b", buf, off))
