"""Cross-process driver coordination: heartbeat registry + map-output tracker
served over TCP.

Reference: the driver side of the accelerated shuffle — executor discovery
via RapidsShuffleHeartbeatManager (RapidsShuffleHeartbeatManager.scala:51,114,
driver RPC receive in Plugin.scala:140-152) and Spark's MapOutputTracker
(MapStatus flow in RapidsShuffleInternalManagerBase.scala:164+). In-process
queries use the local objects directly; multi-process executors talk to this
service instead, so two OS processes can run ONE query's map and reduce
stages against each other's shuffle servers.

Wire format: length-prefixed JSON requests/replies over a plain socket —
this is the CONTROL plane (tiny messages); the data plane is
``shuffle/tcp.py``'s framed transport.

Copied from ``spark_rapids_tpu/shuffle/driver_service.py`` unchanged.
"""
from __future__ import annotations

import json
import socket
import struct
import threading
from typing import Dict, List, Optional, Tuple

from .heartbeat import ExecutorInfo, ShuffleHeartbeatManager
from .manager import MapOutputRegistry, MapStatus


def _send(sock: socket.socket, obj) -> None:
    payload = json.dumps(obj).encode("utf-8")
    sock.sendall(struct.pack("<I", len(payload)) + payload)


def _recv(sock: socket.socket):
    hdr = b""
    while len(hdr) < 4:
        got = sock.recv(4 - len(hdr))
        if not got:
            return None
        hdr += got
    (n,) = struct.unpack("<I", hdr)
    buf = b""
    while len(buf) < n:
        got = sock.recv(n - len(buf))
        if not got:
            return None
        buf += got
    return json.loads(buf.decode("utf-8"))


class DriverService:
    """The 'driver plugin' process endpoint: owns the real heartbeat manager
    and map-output registry, serves them over TCP."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.heartbeats = ShuffleHeartbeatManager()
        self.registry = MapOutputRegistry()
        # range-bounds sample gather: key -> {rank: payload}. The driver
        # only GATHERS; every rank replays the same deterministic merge
        # (plan/partitioning.merge_sampled_word_groups) so all ranks bucket
        # with identical bounds (the Spark-driver-computed bounds analogue,
        # GpuRangePartitioner.createRangeBounds).
        self._range_samples: Dict[str, dict] = {}
        self._range_lock = threading.Lock()
        self._srv = socket.create_server((host, port))
        self.address: Tuple[str, int] = self._srv.getsockname()[:2]
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._thread.start()

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            threading.Thread(
                target=self._serve, args=(conn,), daemon=True
            ).start()

    def _serve(self, conn: socket.socket):
        with conn:
            while True:
                req = _recv(conn)
                if req is None:
                    return
                try:
                    reply = self._dispatch(req)
                except Exception as e:  # noqa: BLE001 - surface to the caller
                    import logging

                    logging.getLogger(__name__).warning(
                        "driver service request failed: %r -> %s", req, e
                    )
                    reply = {"error": f"{type(e).__name__}: {e}"}
                try:
                    _send(conn, reply)
                except OSError:
                    return

    def _dispatch(self, req) -> dict:
        op = req["op"]
        if op == "register_executor":
            peers = self.heartbeats.register_executor(
                req["executor_id"], tuple(req["address"]) if req["address"] else None
            )
            return {"peers": [[p.executor_id, p.address] for p in peers]}
        if op == "heartbeat":
            peers = self.heartbeats.executor_heartbeat(req["executor_id"])
            return {"peers": [[p.executor_id, p.address] for p in peers]}
        if op == "register_map_status":
            self.registry.register(
                MapStatus(req["executor_id"], req["shuffle_id"], req["map_id"],
                          req["sizes"])
            )
            return {"ok": True}
        if op == "outputs_for":
            return {
                "statuses": [
                    [s.executor_id, s.map_id, s.sizes]
                    for s in self.registry.outputs_for(req["shuffle_id"])
                ]
            }
        if op == "remove_shuffle":
            self.registry.remove_shuffle(req["shuffle_id"])
            with self._range_lock:
                prefix = f"{req['shuffle_id']}:"
                for k in [k for k in self._range_samples if k.startswith(prefix)]:
                    del self._range_samples[k]
            return {"ok": True}
        if op in ("range_samples", "range_poll"):
            # range_samples: idempotent per-rank post (retries overwrite);
            # range_poll: payload-free wait so slow-peer polling does not
            # re-ship the full sample every 50ms. Replies with the full
            # gather once all ``size`` ranks have contributed.
            size = int(req["size"])
            with self._range_lock:
                slot = self._range_samples.setdefault(
                    req["key"], {"size": size, "ranks": {}}
                )
                ranks = slot["ranks"]
                if op == "range_samples":
                    rank = int(req["rank"])
                    if (
                        len(ranks) >= slot["size"]
                        and ranks.get(rank) != req["payload"]
                    ):
                        # a COMPLETE slot being re-posted with DIFFERENT
                        # data is a key collision from a new job on a
                        # long-lived driver (per-session query seqs
                        # restart) — serving the stale gather would give
                        # ranks divergent bounds. Start a fresh gather.
                        # Identical re-posts (generation retries, which
                        # re-sample deterministically) keep the slot.
                        ranks = {}
                        slot = {"size": size, "ranks": ranks}
                        self._range_samples[req["key"]] = slot
                    ranks[rank] = req["payload"]
                # bounded: one entry per range exchange; the release path
                # never fires in multiproc (map output is executor-lifetime),
                # so cap instead of leak on long-lived drivers. Only evict
                # COMPLETE gathers — dropping an in-flight slot would strand
                # its ranks (range_poll never re-posts the payload).
                if len(self._range_samples) > 1024:
                    done = [
                        k
                        for k, s in self._range_samples.items()
                        if k != req["key"] and len(s["ranks"]) >= s["size"]
                    ]
                    for k in done[: len(self._range_samples) - 1024]:
                        del self._range_samples[k]
                if len(ranks) >= slot["size"]:
                    return {
                        "ready": True,
                        "contribs": [ranks[r] for r in sorted(ranks)],
                    }
            return {"ready": False}
        raise ValueError(f"unknown op {op!r}")

    def close(self):
        self._stop.set()
        try:
            self._srv.close()
        except OSError:
            pass


class _DriverClient:
    """One executor's socket to the driver service (thread-safe)."""

    def __init__(self, address: Tuple[str, int]):
        self._sock = socket.create_connection(address, timeout=30)
        self._lock = threading.Lock()

    def call(self, **req) -> dict:
        with self._lock:
            _send(self._sock, req)
            out = _recv(self._sock)
        if out is None:
            raise ConnectionError("driver service closed the connection")
        if "error" in out:
            raise RuntimeError(f"driver service rejected {req['op']}: {out['error']}")
        return out


class RemoteHeartbeatManager:
    """ShuffleHeartbeatManager facade over the driver service (duck-typed
    for HeartbeatEndpoint)."""

    def __init__(self, client: _DriverClient):
        self._client = client

    def register_executor(self, executor_id: str, address=None) -> List[ExecutorInfo]:
        out = self._client.call(
            op="register_executor", executor_id=executor_id,
            address=list(address) if address else None,
        )
        return [
            ExecutorInfo(eid, tuple(addr) if addr else None)
            for eid, addr in out["peers"]
        ]

    def executor_heartbeat(self, executor_id: str) -> List[ExecutorInfo]:
        out = self._client.call(op="heartbeat", executor_id=executor_id)
        return [
            ExecutorInfo(eid, tuple(addr) if addr else None)
            for eid, addr in out["peers"]
        ]


class RemoteMapOutputRegistry:
    """MapOutputRegistry facade over the driver service."""

    def __init__(self, client: _DriverClient):
        self._client = client

    def register(self, status: MapStatus):
        self._client.call(
            op="register_map_status",
            executor_id=status.executor_id,
            shuffle_id=status.shuffle_id,
            map_id=status.map_id,
            sizes=status.sizes,
        )

    def outputs_for(self, shuffle_id: int) -> List[MapStatus]:
        out = self._client.call(op="outputs_for", shuffle_id=shuffle_id)
        return [
            MapStatus(eid, shuffle_id, map_id, sizes)
            for eid, map_id, sizes in out["statuses"]
        ]

    def remove_shuffle(self, shuffle_id: int):
        self._client.call(op="remove_shuffle", shuffle_id=shuffle_id)

    def range_bounds_sync(
        self, key: str, rank: int, size: int, payload, timeout_s: float = 120.0
    ):
        """Post this rank's range-bounds sample and block until every rank's
        contribution is gathered. Returns the contributions in rank order."""
        import time

        deadline = time.monotonic() + timeout_s
        out = self._client.call(
            op="range_samples", key=key, rank=rank, size=size, payload=payload
        )
        while not out.get("ready"):
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"range-bounds gather {key!r}: peers did not contribute "
                    f"within {timeout_s}s"
                )
            time.sleep(0.05)
            # payload-free poll: the sample was already posted above
            out = self._client.call(op="range_poll", key=key, size=size)
        return out["contribs"]


def connect(address: Tuple[str, int]):
    """(RemoteHeartbeatManager, RemoteMapOutputRegistry) sharing one socket."""
    client = _DriverClient(address)
    return RemoteHeartbeatManager(client), RemoteMapOutputRegistry(client)
