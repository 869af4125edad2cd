"""Shuffle buffer catalogs — device-resident, spillable map-output storage.

Reference: ShuffleBufferCatalog.scala:50 (shuffle-id → spillable buffers,
backed by the tiered store chain) and ShuffleReceivedBufferCatalog.scala:48
(ids for remotely fetched buffers). Writers park partition batches here
(device tier) and readers either hand the device batch straight out (local
hit — zero copy, the RapidsCachingReader fast path) or serialize it for the
transport.

The port's counterpart of ``spark_rapids_tpu/shuffle/catalog.py``. Map
output registers in the port's spill catalog (``mem/spill.py``) at priority
``INPUT_FROM_SHUFFLE`` — the first band to spill, as the port's in-memory
exchange parks its slices — so it walks device → host → disk under memory
pressure and comes back from whatever tier it is on. ``owner`` (the query's
``"exchange"`` for an in-process manager) lets the query's end reclaim
what a failed query left registered. The received catalog holds host bytes
only; ``materialize`` uploads onto the reader's device.
"""
from __future__ import annotations

import itertools
import threading
from typing import Dict, Iterator, List, Optional, Tuple

from ..columnar.device import DeviceBatch
from ..mem.spill import BufferCatalog, SpillableBatch, SpillPriorities
from . import meta as M
from .compression import CompressionCodec
from .serializer import schema_to_bytes, serialize_device_batch


class ShuffleBufferCatalog:
    """Map-output store: (shuffle_id, map_id, partition_id) → cached batches.

    Each batch gets a globally unique ``buffer_id`` (the transport/transfer
    currency) and lives in the tiered ``BufferCatalog`` so shuffle output is
    spillable exactly like the reference's ShuffleBufferCatalog-over-
    RapidsBufferStore design."""

    def __init__(self, store: BufferCatalog, owner=None):
        self._store = store
        self._owner = owner
        self._lock = threading.RLock()
        self._next_buffer_id = itertools.count(1)
        # (shuffle, map, part) -> list[(buffer_id, SpillableBatch, num_rows)]
        self._parts: Dict[Tuple[int, int, int], List[tuple]] = {}
        self._by_buffer: Dict[int, tuple] = {}  # buffer_id -> (key, SpillableBatch, rows)

    def add_batch(
        self, shuffle_id: int, map_id: int, partition_id: int, batch: DeviceBatch
    ) -> int:
        """Register a device-resident partition batch; returns its size in
        bytes (for MapStatus)."""
        rows = batch.row_count()
        handle = self._store.register(
            batch, SpillPriorities.INPUT_FROM_SHUFFLE, owner=self._owner
        )
        with self._lock:
            bid = next(self._next_buffer_id)
            key = (shuffle_id, map_id, partition_id)
            entry = (bid, handle, rows)
            self._parts.setdefault(key, []).append(entry)
            self._by_buffer[bid] = (key, handle, rows)
        return handle.size_bytes

    def blocks_for(
        self, shuffle_id: int, map_id: int, start_part: int, end_part: int
    ) -> List[tuple]:
        """[(buffer_id, SpillableBatch, num_rows)] for a partition range."""
        out = []
        with self._lock:
            for p in range(start_part, end_part):
                out.extend(self._parts.get((shuffle_id, map_id, p), []))
        return out

    def get_batch(self, buffer_id: int) -> DeviceBatch:
        """Local-hit path: materialize the batch back on device (pins it)."""
        with self._lock:
            _key, handle, _rows = self._by_buffer[buffer_id]
        db = handle.get_batch()
        handle.unpin()
        return db

    def table_metas(
        self,
        shuffle_id: int,
        map_id: int,
        start_part: int,
        end_part: int,
        codec: CompressionCodec,
    ) -> Tuple[List[M.TableMeta], Dict[int, bytes]]:
        """Serialize the requested range for a remote peer: TableMetas plus
        buffer_id → payload bytes (the BufferSendState source material)."""
        metas: List[M.TableMeta] = []
        payloads: Dict[int, bytes] = {}
        for p in range(start_part, end_part):
            with self._lock:
                entries = list(self._parts.get((shuffle_id, map_id, p), []))
            for batch_id, (bid, handle, rows) in enumerate(entries):
                db = handle.get_batch()
                try:
                    payload, usize, cid, schema = serialize_device_batch(db, codec)
                finally:
                    handle.unpin()
                metas.append(
                    M.TableMeta(
                        shuffle_id,
                        map_id,
                        p,
                        batch_id,
                        rows,
                        M.BufferMeta(bid, len(payload), usize, cid),
                        schema_to_bytes(schema),
                    )
                )
                payloads[bid] = payload
        return metas, payloads

    def payload_for(self, buffer_id: int, codec: CompressionCodec) -> Optional[bytes]:
        """(Re-)serialize one cached batch — deterministic for a given codec,
        so a payload evicted from the server's pending cache can be rebuilt
        with the sizes already promised in its TableMeta."""
        with self._lock:
            entry = self._by_buffer.get(buffer_id)
        if entry is None:
            return None
        _key, handle, _rows = entry
        db = handle.get_batch()
        try:
            payload, _usize, _cid, _schema = serialize_device_batch(db, codec)
        finally:
            handle.unpin()
        return payload

    def buffer_ids_for_shuffle(self, shuffle_id: int) -> List[int]:
        with self._lock:
            return [bid for bid, (key, _h, _r) in self._by_buffer.items() if key[0] == shuffle_id]

    def remove_shuffle(self, shuffle_id: int):
        """Unregister a completed shuffle (ShuffleBufferCatalog
        unregisterShuffle)."""
        with self._lock:
            keys = [k for k in self._parts if k[0] == shuffle_id]
            for k in keys:
                for bid, handle, _rows in self._parts.pop(k):
                    self._by_buffer.pop(bid, None)
                    handle.close()

    def remove_map(self, shuffle_id: int, map_id: int):
        """Unregister ONE map task's output (attempt abort): a failed map
        attempt's partial writes are dropped wholesale so the re-run under
        the next attempt id starts from a clean key range — the storage
        half of the atomic per-(map, attempt) commit."""
        with self._lock:
            keys = [
                k for k in self._parts if k[0] == shuffle_id and k[1] == map_id
            ]
            for k in keys:
                for bid, handle, _rows in self._parts.pop(k):
                    self._by_buffer.pop(bid, None)
                    handle.close()

    def stats(self) -> dict:
        with self._lock:
            return {
                "cached_batches": len(self._by_buffer),
                "cached_bytes": sum(h.size_bytes for _k, h, _r in self._by_buffer.values()),
            }


class ShuffleReceivedBufferCatalog:
    """Remotely fetched payloads pending materialization
    (ShuffleReceivedBufferCatalog.scala:48)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._next_id = itertools.count(1)
        self._bufs: Dict[int, tuple] = {}  # id -> (payload bytes, TableMeta)

    def add(self, payload: bytes, meta: M.TableMeta) -> int:
        with self._lock:
            rid = next(self._next_id)
            self._bufs[rid] = (payload, meta)
        return rid

    def materialize(self, received_id: int, device) -> DeviceBatch:
        """payload → DeviceBatch on ``device`` (H2D on the calling thread);
        drops the host copy."""
        from .serializer import deserialize_to_device

        with self._lock:
            payload, meta = self._bufs.pop(received_id)
        return deserialize_to_device(payload, meta.buffer, device)

    def __len__(self):
        with self._lock:
            return len(self._bufs)
