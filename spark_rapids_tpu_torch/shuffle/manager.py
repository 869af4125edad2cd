"""Accelerated shuffle manager — caching writer/reader over the transport.

Reference: RapidsShuffleInternalManagerBase.scala — ``RapidsCachingWriter``
(:73-194) parks partition batches device-resident in the spillable shuffle
catalog and reports real sizes in the MapStatus; ``RapidsCachingReader``
(RapidsCachingReader.scala:49) serves local blocks from the catalog
(zero-copy) and fetches remote blocks via the ShuffleClient; GpuShuffleEnv
(GpuShuffleEnv.scala:26-112) owns catalogs + codec per executor. The driver
side here is ``MapOutputRegistry`` (Spark's MapOutputTracker role): which
executor holds which map output.

Copied from ``spark_rapids_tpu/shuffle/manager.py``; the class keeps the
name ``TpuShuffleManager``. A ``ShuffleEnv`` also names the device its
readers upload fetched payloads onto (``device``; a reader may name its own)
and the owner its catalog registers map output under (``owner``: the
query's ``"exchange"`` for the in-process manager, so the query's end
reclaims what a failed query left).
"""
from __future__ import annotations

import threading
from typing import Dict, Iterator, List, Optional, Tuple

from ..columnar.device import DeviceBatch
from ..mem.spill import BufferCatalog
from . import meta as M
from .catalog import ShuffleBufferCatalog, ShuffleReceivedBufferCatalog
from .client import ShuffleClient
from .compression import CompressionCodec, get_codec
from .heartbeat import HeartbeatEndpoint, ShuffleHeartbeatManager
from .server import ShuffleServer
from .transport import ClientConnection, InflightThrottle, Transport


#: storage-id stride separating task attempts of one logical map: attempt k
#: stores its blocks under ``logical_map_id + k * ATTEMPT_STRIDE``, so a
#: re-executed map task never touches the keys a previous (possibly
#: partially-written) attempt used — commit is the only point an attempt
#: becomes visible, and it replaces the logical map's status wholesale.
ATTEMPT_STRIDE = 100_000


class MapOutputLostError(RuntimeError):
    """A shuffle's committed map output is gone (peer blacklisted/lost, or
    a registry wiped by injected chaos). Partition-scoped and recoverable:
    the lineage layer re-executes the map stage under a fresh generation
    instead of failing the query."""


class MapStatus:
    """Map-task completion record: where the output lives + per-partition
    sizes (Spark MapStatus; RapidsShuffleInternalManagerBase:164+).

    ``map_id`` is the STORAGE id (attempt-striped — what block keys and
    fetch requests carry); ``logical_map_id``/``attempt`` recover the
    lineage identity, so the registry keeps exactly one committed attempt
    per logical map task."""

    def __init__(self, executor_id: str, shuffle_id: int, map_id: int, sizes: List[int]):
        self.executor_id = executor_id
        self.shuffle_id = shuffle_id
        self.map_id = map_id
        self.sizes = sizes

    @property
    def logical_map_id(self) -> int:
        return self.map_id % ATTEMPT_STRIDE

    @property
    def attempt(self) -> int:
        return self.map_id // ATTEMPT_STRIDE


class MapOutputRegistry:
    """Driver-side map-output tracker."""

    def __init__(self):
        self._lock = threading.Lock()
        self._statuses: Dict[Tuple[int, int], MapStatus] = {}

    def register(self, status: MapStatus):
        # keyed by LOGICAL map id: committing a re-executed attempt
        # atomically replaces its predecessor — consumers never see two
        # attempts of one map task side by side
        with self._lock:
            self._statuses[(status.shuffle_id, status.logical_map_id)] = status

    def outputs_for(self, shuffle_id: int) -> List[MapStatus]:
        with self._lock:
            return [s for (sid, _m), s in self._statuses.items() if sid == shuffle_id]

    def remove_shuffle(self, shuffle_id: int):
        with self._lock:
            for k in [k for k in self._statuses if k[0] == shuffle_id]:
                del self._statuses[k]

    def range_bounds_sync(
        self, key: str, rank: int, size: int, payload, timeout_s: float = 120.0
    ):
        # in-process: one executor, its sample IS the gather
        return [payload]


class ShuffleEnv:
    """Per-executor shuffle environment (GpuShuffleEnv analogue)."""

    def __init__(
        self,
        executor_id: str,
        transport: Transport,
        store: BufferCatalog,
        heartbeat: ShuffleHeartbeatManager,
        codec: str = "lz4",
        max_inflight_bytes: int = 1 << 30,
        address: Optional[tuple] = None,
        fetch_timeout_s: float = 120.0,
        bounce_buffer_size: int = 4 << 20,
        bounce_buffer_count: int = 8,
        fetch_max_retries: int = 3,
        fetch_backoff_ms: float = 50.0,
        fetch_max_backoff_ms: float = 2000.0,
        blacklist_after: int = 3,
        retry_seed: int = 0,
        heartbeat_max_age_s: float = 0.0,
        device="cpu",
        owner: Optional[str] = None,
    ):
        import torch

        from .bounce import BounceBufferManager

        self.executor_id = executor_id
        self.transport = transport
        self.device = torch.device(device)
        self.catalog = ShuffleBufferCatalog(store, owner=owner)
        self.received = ShuffleReceivedBufferCatalog()
        self.codec: CompressionCodec = get_codec(codec)
        self.throttle = InflightThrottle(max_inflight_bytes)
        self.fetch_timeout_s = fetch_timeout_s
        self.fetch_max_retries = fetch_max_retries
        self.fetch_backoff_ms = fetch_backoff_ms
        self.fetch_max_backoff_ms = fetch_max_backoff_ms
        self.blacklist_after = blacklist_after
        self.retry_seed = retry_seed
        self.server = ShuffleServer(
            executor_id,
            transport.server,
            self.catalog,
            self.codec,
            BounceBufferManager(bounce_buffer_size, bounce_buffer_count),
        )
        self.heartbeat = HeartbeatEndpoint(
            executor_id, heartbeat, address, max_age_s=heartbeat_max_age_s
        )
        self._clients: Dict[str, "ShuffleClient"] = {}
        self._lock = threading.Lock()
        # consecutive exhausted-retry-budget counts per peer; at
        # ``blacklist_after`` the peer is evicted from the local table and
        # later fetches to it fail fast (FetchFailedException semantics —
        # the stage retry can reschedule around the dead executor)
        self._peer_failures: Dict[str, int] = {}
        self._blacklist: set = set()

    def _on_fetch_result(self, peer_executor_id: str, ok: bool) -> None:
        """ShuffleClient outcome callback: success resets the consecutive-
        failure count; an exhausted retry budget advances it toward the
        blacklist threshold."""
        with self._lock:
            if ok:
                self._peer_failures.pop(peer_executor_id, None)
                return
            n = self._peer_failures.get(peer_executor_id, 0) + 1
            self._peer_failures[peer_executor_id] = n
            trip = (
                self.blacklist_after > 0
                and n >= self.blacklist_after
                and peer_executor_id not in self._blacklist
            )
            if trip:
                self._blacklist.add(peer_executor_id)
        if trip:
            import logging

            from ..resilience import retry as R

            R.record("peers_evicted")
            self.heartbeat.drop_peer(peer_executor_id)
            logging.getLogger(__name__).warning(
                "peer %s blacklisted after %d consecutive fetch failures",
                peer_executor_id, n,
            )

    def blacklisted(self, peer_executor_id: str) -> bool:
        with self._lock:
            return peer_executor_id in self._blacklist

    def client_to(self, peer_executor_id: str) -> "ShuffleClient":
        """One ShuffleClient per peer connection — it owns the connection's
        frame handler, and concurrent fetches multiplex by tag."""
        from .client import ShuffleFetchError

        with self._lock:
            if peer_executor_id in self._blacklist:
                raise ShuffleFetchError(
                    f"peer {peer_executor_id} is blacklisted after repeated "
                    "fetch failures"
                )
            client = self._clients.get(peer_executor_id)
            if client is None:
                self.heartbeat.heartbeat()  # refresh peer table
                peer = self.heartbeat.peer(peer_executor_id)
                addr = peer.address if peer is not None else None
                conn = self.transport.connect(peer_executor_id, addr)
                client = ShuffleClient(
                    conn,
                    self.received,
                    self.throttle,
                    self.fetch_timeout_s,
                    max_retries=self.fetch_max_retries,
                    backoff_ms=self.fetch_backoff_ms,
                    max_backoff_ms=self.fetch_max_backoff_ms,
                    retry_seed=self.retry_seed,
                    on_fetch_result=self._on_fetch_result,
                )
                self._clients[peer_executor_id] = client
        return client


class CachingWriter:
    """Map-side writer: batches stay device-resident and spillable
    (RapidsCachingWriter.write).

    Attempt-atomic: blocks are parked under the attempt-striped storage id
    (``map_id + attempt * ATTEMPT_STRIDE``), invisible to readers until
    ``commit`` registers the MapStatus; ``abort`` drops a failed attempt's
    partial writes so the re-run starts clean. Readers therefore never
    observe a torn map output — the written-then-committed sequence is the
    shuffle's equivalent of write-temp-then-rename."""

    def __init__(self, env: ShuffleEnv, registry: MapOutputRegistry,
                 shuffle_id: int, map_id: int, num_partitions: int,
                 attempt: int = 0):
        self._env = env
        self._registry = registry
        self.shuffle_id = shuffle_id
        self.logical_map_id = map_id
        self.attempt = attempt
        self.map_id = map_id + attempt * ATTEMPT_STRIDE
        self._sizes = [0] * num_partitions

    def write(self, partition_id: int, batch: DeviceBatch):
        size = self._env.catalog.add_batch(
            self.shuffle_id, self.map_id, partition_id, batch
        )
        self._sizes[partition_id] += size
        from ..obs.metrics import GLOBAL as _obs

        _obs.counter("shuffle.bytesWritten").add(size)

    def commit(self) -> MapStatus:
        status = MapStatus(
            self._env.executor_id, self.shuffle_id, self.map_id, self._sizes
        )
        self._registry.register(status)
        return status

    def abort(self) -> None:
        """Drop this attempt's partial output (never committed, so no
        reader could have started on it)."""
        self._env.catalog.remove_map(self.shuffle_id, self.map_id)
        self._sizes = [0] * len(self._sizes)


class CachingReader:
    """Reduce-side reader: local catalog hits + remote transport fetches
    (RapidsCachingReader.read)."""

    def __init__(self, env: ShuffleEnv, registry: MapOutputRegistry):
        self._env = env
        self._registry = registry

    def read_partitions(
        self,
        shuffle_id: int,
        start_part: int,
        end_part: int,
        expected_maps: int = 0,
        device=None,
    ) -> Iterator[DeviceBatch]:
        """The partitions' batches: local map output straight from the
        catalog, remote output fetched and uploaded onto ``device`` (the
        env's by default) on the calling thread."""
        device = self._env.device if device is None else device
        statuses = self._registry.outputs_for(shuffle_id)
        if expected_maps > len(statuses):
            # multi-process: peers register their MapStatus only after their
            # map stage commits — poll the driver-side tracker like Spark
            # reducers block on MapOutputTracker (fetch timeout bounds it)
            import time as _time

            deadline = _time.monotonic() + self._env.fetch_timeout_s
            while len(statuses) < expected_maps:
                if _time.monotonic() > deadline:
                    raise TimeoutError(
                        f"shuffle {shuffle_id}: {len(statuses)}/{expected_maps} "
                        "map outputs registered before fetch timeout"
                    )
                _time.sleep(0.05)
                statuses = self._registry.outputs_for(shuffle_id)
        # group remote requests per peer executor (one metadata round trip
        # per peer, the RapidsShuffleIterator batching)
        remote: Dict[str, List[M.BlockId]] = {}
        # graft: ok(cancel-beat: local map-output replay from the
        # executor's own catalog — no network wait; the remote loop below
        # beats through fetch_blocks' stall phases)
        for s in statuses:
            if any(s.sizes[p] for p in range(start_part, min(end_part, len(s.sizes)))):
                if s.executor_id == self._env.executor_id:
                    # graft: ok(cancel-beat: same local catalog replay)
                    for bid, handle, _rows in self._env.catalog.blocks_for(
                        shuffle_id, s.map_id, start_part, end_part
                    ):
                        yield self._env.catalog.get_batch(bid)
                else:
                    remote.setdefault(s.executor_id, []).append(
                        M.BlockId(shuffle_id, s.map_id, start_part, end_part)
                    )
        for peer, blocks in remote.items():
            client = self._env.client_to(peer)
            for rid, _meta in client.fetch_blocks(blocks):
                yield self._env.received.materialize(rid, device)


class TpuShuffleManager:
    """Ties it together per executor (RapidsShuffleInternalManagerBase:200)."""

    def __init__(self, env: ShuffleEnv, registry: MapOutputRegistry):
        self.env = env
        self.registry = registry

    def get_writer(self, shuffle_id: int, map_id: int, num_partitions: int,
                   attempt: int = 0) -> CachingWriter:
        return CachingWriter(
            self.env, self.registry, shuffle_id, map_id, num_partitions,
            attempt=attempt,
        )

    def get_reader(self) -> CachingReader:
        return CachingReader(self.env, self.registry)

    def unregister_shuffle(self, shuffle_id: int):
        # server first: it resolves buffer ids through the catalog
        self.env.server.remove_shuffle(shuffle_id)
        self.env.catalog.remove_shuffle(shuffle_id)
        self.registry.remove_shuffle(shuffle_id)
