"""Columnar batch (de)serialization for shuffle.

Reference: GpuColumnarBatchSerializer.scala:50 (JCudfSerialization host
round-trip — the default shuffle path) and the `SerializedTableColumn`
currency (:238). One batch per frame, optionally whole-frame compressed by
a ``CompressionCodec`` with the codec recorded in ``BufferMeta`` so the
receiver self-describes. Device batches cross through the host staging
seam exactly where the reference's D2H serializer sits.

The port's counterpart of ``spark_rapids_tpu/shuffle/serializer.py``: the
frame is ``columnar/ipc.py``'s stream over a ``HostBatch``, not Arrow IPC.
A payload is host bytes; ``deserialize_to_device`` uploads onto the device
the caller names, on the calling thread's current stream, so only host
bytes ever cross the transport's threads.
"""
from __future__ import annotations

from typing import Tuple

from ..columnar import ipc
from ..columnar.device import DeviceBatch, device_to_host, host_to_device
from ..columnar.host import HostBatch
from ..columnar.ipc import schema_from_bytes, schema_to_bytes  # noqa: F401 - shims
from ..obs import metrics as obs_metrics
from ..types import Schema
from . import meta as M
from .compression import CompressionCodec, codec_for_id

# codec efficiency across every serialized shuffle payload (export computes
# the compression ratio from the pair)
_M_UNCOMP = obs_metrics.GLOBAL.counter("shuffle.bytesUncompressed")
_M_COMP = obs_metrics.GLOBAL.counter("shuffle.bytesCompressedOut")


def serialize_host_batch(hb: HostBatch, codec: CompressionCodec) -> Tuple[bytes, int, int]:
    """HostBatch → (payload, uncompressed_size, codec_id). The payload is a
    complete stream (schema + batch, columnar/ipc.py framing) so a frame is
    self-contained."""
    raw = ipc.write_batch(hb)
    payload = codec.compress(raw)
    _M_UNCOMP.add(len(raw))
    _M_COMP.add(len(payload))
    return payload, len(raw), codec.codec_id


def deserialize_host_batch(payload: bytes, buffer_meta: M.BufferMeta) -> HostBatch:
    codec = codec_for_id(buffer_meta.codec)
    raw = codec.decompress(payload, buffer_meta.uncompressed_size)
    return ipc.read_batch(raw)


def serialize_device_batch(db: DeviceBatch, codec: CompressionCodec) -> Tuple[bytes, int, int, Schema]:
    """DeviceBatch → wire payload via the host staging seam (one download
    of the live rows)."""
    hb = device_to_host(db)
    payload, usize, cid = serialize_host_batch(hb, codec)
    return payload, usize, cid, hb.schema


def deserialize_to_device(payload: bytes, buffer_meta: M.BufferMeta, device) -> DeviceBatch:
    return host_to_device(deserialize_host_batch(payload, buffer_meta), device)
