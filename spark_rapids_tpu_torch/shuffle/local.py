"""In-process transport — same-host executors and protocol tests.

Reference: SURVEY §4 tier 2 — the reference tests its client/server protocol
against a mocked RapidsShuffleTransport (RapidsShuffleTestHelper.scala)
because the real fabric needs a cluster. Here the in-process transport is a
*real* SPI implementation (request dispatch on a worker pool, async tagged
frame delivery), so the full metadata/transfer protocol runs in one process;
it also serves same-host executor pairs where a socket would be waste.

Copied from ``spark_rapids_tpu/shuffle/local.py`` unchanged.
"""
from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict

from .transport import (
    ClientConnection,
    ServerConnection,
    Transaction,
    TransactionStatus,
    Transport,
    new_transaction,
)


class InProcessRegistry:
    """executor_id → transport; the 'fabric' (one per process/test)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._transports: Dict[str, "InProcessTransport"] = {}

    def register(self, t: "InProcessTransport"):
        with self._lock:
            self._transports[t.executor_id] = t

    def lookup(self, executor_id: str) -> "InProcessTransport":
        with self._lock:
            return self._transports[executor_id]


class _LocalServerConnection(ServerConnection):
    def __init__(self, transport: "InProcessTransport"):
        super().__init__(transport.executor_id)
        self._transport = transport

    def send(self, peer_executor_id: str, tag: int, data: bytes) -> Transaction:
        tx = new_transaction()

        def run():
            try:
                conn = self._transport._client_conns[peer_executor_id]
                conn.deliver_frame(tag, 0, data)
                tx.complete(TransactionStatus.SUCCESS)
            except Exception as e:  # noqa: BLE001 — surfaced via transaction
                tx.complete(TransactionStatus.ERROR, error=str(e))

        self._transport._pool.submit(run)
        return tx


class _LocalClientConnection(ClientConnection):
    def __init__(self, transport: "InProcessTransport", peer: "InProcessTransport"):
        super().__init__(peer.executor_id)
        self._transport = transport
        self._peer = peer

    def request(self, req_type: int, payload: bytes) -> Transaction:
        tx = new_transaction()

        def run():
            try:
                resp = self._peer.server.handle(
                    req_type, self._transport.executor_id, payload
                )
                tx.complete(TransactionStatus.SUCCESS, payload=resp)
            except Exception as e:  # noqa: BLE001
                tx.complete(TransactionStatus.ERROR, error=str(e))

        self._peer._pool.submit(run)
        return tx


class InProcessTransport(Transport):
    def __init__(self, executor_id: str, registry: InProcessRegistry, workers: int = 4):
        super().__init__(executor_id)
        self._registry = registry
        self._pool = ThreadPoolExecutor(max_workers=workers, thread_name_prefix=f"shuffle-{executor_id}")
        self._server = _LocalServerConnection(self)
        # peer_executor_id → the client connection whose frames route back here
        self._client_conns: Dict[str, _LocalClientConnection] = {}
        registry.register(self)

    @property
    def server(self) -> ServerConnection:
        return self._server

    def connect(self, peer_executor_id: str, address=None) -> ClientConnection:
        peer = self._registry.lookup(peer_executor_id)  # address unused: in-process registry IS discovery
        conn = _LocalClientConnection(self, peer)
        # the peer's server sends frames back to us by our executor id
        peer._client_conns[self.executor_id] = conn
        return conn

    def shutdown(self):
        self._pool.shutdown(wait=False)
