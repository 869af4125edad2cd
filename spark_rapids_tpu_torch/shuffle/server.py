"""Shuffle server — serves metadata + streams buffers to peers.

Reference: shuffle/RapidsShuffleServer.scala:66 — handles MetadataRequest
(TableMeta[] for the peer's block ranges) and TransferRequest (BufferSendState
windows catalog buffers through bounce buffers as tagged sends). Payloads are
serialized once at metadata time (sizes must be on the wire) and parked until
the transfer request claims them; unclaimed payloads age out with the shuffle.

Copied from ``spark_rapids_tpu/shuffle/server.py``. The metadata handler
downloads the parked device batches on the transport's dispatch thread,
on the default stream the map tasks wrote them on.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, Optional

from . import meta as M
from .bounce import BounceBufferManager, BufferSendState
from .catalog import ShuffleBufferCatalog
from .compression import CompressionCodec
from .transport import (
    REQ_METADATA,
    REQ_TRANSFER,
    ServerConnection,
)


class ShuffleServer:
    def __init__(
        self,
        executor_id: str,
        server_conn: ServerConnection,
        catalog: ShuffleBufferCatalog,
        codec: CompressionCodec,
        bounce: Optional[BounceBufferManager] = None,
    ):
        self.executor_id = executor_id
        self._conn = server_conn
        self._catalog = catalog
        self._codec = codec
        self._bounce = bounce or BounceBufferManager(4 << 20, 8)
        self._lock = threading.Lock()
        # buffer_id → payload, bounded LRU: serialization at metadata time is
        # an optimization, not a correctness requirement — a transfer whose
        # payload was evicted (or claimed by a concurrent reader) re-serializes
        # from the catalog, so eviction can be aggressive and unclaimed
        # payloads cannot leak host memory
        self._pending_payloads: "OrderedDict[int, bytes]" = OrderedDict()
        self._pending_bytes = 0
        self.pending_limit_bytes = 256 << 20
        self.stream_timeout_s = 120.0
        server_conn.register_request_handler(REQ_METADATA, self._on_metadata)
        server_conn.register_request_handler(REQ_TRANSFER, self._on_transfer)

    # ── handlers ────────────────────────────────────────────────────────
    def _put_pending(self, payloads: Dict[int, bytes]):
        with self._lock:
            for bid, data in payloads.items():
                old = self._pending_payloads.pop(bid, None)
                if old is not None:
                    self._pending_bytes -= len(old)
                self._pending_payloads[bid] = data
                self._pending_bytes += len(data)
            while self._pending_bytes > self.pending_limit_bytes and self._pending_payloads:
                _bid, old = self._pending_payloads.popitem(last=False)
                self._pending_bytes -= len(old)

    def _on_metadata(self, peer: str, payload: bytes) -> bytes:
        from ..obs import trace as obs_trace

        blocks = M.unpack_metadata_request(payload)
        # the requester's span-context tail (M.unpack_metadata_trace) is
        # read by the cross-process trace merge, which the port does not
        # have yet (ROADMAP Queue A item 12)
        args = {"peer": peer, "blocks": len(blocks)}
        with obs_trace.span("shuffle-serve-metadata", "shuffle", args):
            all_metas = []
            for b in blocks:
                metas, payloads = self._catalog.table_metas(
                    b.shuffle_id, b.map_id, b.start_partition,
                    b.end_partition, self._codec
                )
                all_metas.extend(metas)
                self._put_pending(payloads)
            return M.pack_metadata_response(all_metas)

    def _on_transfer(self, peer: str, payload: bytes) -> bytes:
        req = M.TransferRequest.unpack(payload)
        to_send = []
        states = []
        for i, bid in enumerate(req.buffer_ids):
            with self._lock:
                data = self._pending_payloads.pop(bid, None)
                if data is not None:
                    self._pending_bytes -= len(data)
            if data is None:
                # evicted or claimed by a concurrent reader of the same
                # blocks — rebuild from the (spillable) catalog
                data = self._catalog.payload_for(bid, self._codec)
            if data is None:
                states.append(1)  # unknown buffer
            else:
                states.append(0)
                to_send.append((req.base_tag + i, data))
        # stream asynchronously — the response returns before the data lands,
        # exactly like the reference's queued BufferSendState
        t = threading.Thread(target=self._stream, args=(peer, to_send), daemon=True)
        t.start()
        return M.TransferResponse(tuple(states)).pack()

    def _stream(self, peer: str, to_send):
        if not to_send:
            return
        tags = [t for t, _ in to_send]
        payloads = [p for _, p in to_send]
        send_state = BufferSendState(
            payloads, tags, self._bounce, acquire_timeout_s=self.stream_timeout_s
        )
        try:
            for tag, seq, frame in send_state.frames():
                # bounded wait: a peer that stops draining its socket must
                # not pin a bounce buffer (and this thread) forever
                self._conn.send(peer, tag, _pack_frame(tag, seq, frame)).wait(
                    self.stream_timeout_s
                )
        except TimeoutError:
            # abandon the stream; the client's fetch times out and retries
            # through the stage-retry path (FetchFailed semantics)
            return

    def remove_shuffle(self, shuffle_id: int):
        """Drop parked payloads for a completed shuffle."""
        ids = set(self._catalog.buffer_ids_for_shuffle(shuffle_id))
        with self._lock:
            for bid in list(self._pending_payloads):
                if bid in ids:
                    self._pending_bytes -= len(self._pending_payloads.pop(bid))

    def pending_count(self) -> int:
        with self._lock:
            return len(self._pending_payloads)


def _pack_frame(tag: int, seq: int, data) -> bytes:
    import struct

    # join accepts buffer objects, so a bounce-buffer memoryview is copied
    # exactly once, into the wire frame
    return b"".join((struct.pack("<qi", tag, seq), data))


def unpack_frame(data: bytes):
    import struct

    tag, seq = struct.unpack_from("<qi", data, 0)
    return tag, seq, data[12:]
