"""Transport SPI for the accelerated shuffle — connections, transactions,
tags, and the inflight-bytes throttle.

Reference: shuffle/RapidsShuffleTransport.scala:38-579 — ``Transaction``
life-cycle with status callbacks, ``ClientConnection``/``ServerConnection``,
``RequestType`` (MetadataRequest/TransferRequest), tag scheme, and the
receive throttle bounded by ``maxReceiveInflightBytes`` (RapidsConf:850,
backed by HashedPriorityQueue.java for issue ordering). The UCX
implementation behind this SPI is replaced here by an in-process transport
(same-host executors / tests — SURVEY §4 tier 2) and a TCP transport (the
DCN inter-host data plane); the intra-slice device plane rides XLA
collectives instead (parallel/ici.py) and never touches this SPI.

Copied from ``spark_rapids_tpu/shuffle/transport.py``. The device plane the
JAX package rides on XLA collectives is the port's single-controller mesh
exchange (``parallel/mesh.py``), which never touches this SPI either.
"""
from __future__ import annotations

import heapq
import itertools
import threading
from typing import Callable, Dict, List, Optional

# RequestType (RapidsShuffleTransport.scala:175)
REQ_METADATA = 1
REQ_TRANSFER = 2


class TransactionStatus:
    PENDING = 0
    SUCCESS = 1
    ERROR = 2
    CANCELLED = 3


class FetchCancelled(Exception):
    """Raised out of a blocking transport wait when the owning fetch was
    abandoned — the issuer-thread shutdown signal, never user-visible."""


class Transaction:
    """One async send/receive/request with completion callback + wait
    (RapidsShuffleTransport.scala Transaction)."""

    def __init__(self, tx_id: int):
        self.tx_id = tx_id
        self.status = TransactionStatus.PENDING
        self.error: Optional[str] = None
        self.payload: Optional[bytes] = None  # response / received data
        self._done = threading.Event()
        self._cb: Optional[Callable[["Transaction"], None]] = None

    def on_complete(self, cb: Callable[["Transaction"], None]) -> "Transaction":
        self._cb = cb
        if self._done.is_set():
            cb(self)
        return self

    def complete(self, status: int, payload: Optional[bytes] = None, error: Optional[str] = None):
        self.status = status
        self.payload = payload
        self.error = error
        self._done.set()
        if self._cb is not None:
            self._cb(self)

    def wait(self, timeout: Optional[float] = None) -> "Transaction":
        if not self._done.wait(timeout):
            raise TimeoutError(f"transaction {self.tx_id} timed out")
        return self

    def wait_cancellable(
        self,
        timeout: Optional[float],
        cancel: Optional[threading.Event],
        poll_s: float = 0.05,
    ) -> "Transaction":
        """``wait`` that also aborts (FetchCancelled) when ``cancel`` fires
        — so a fetch-issuer thread blocked on a peer response can be shut
        down promptly instead of leaking until the full timeout."""
        import time

        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if self._done.wait(poll_s):
                return self
            if cancel is not None and cancel.is_set():
                raise FetchCancelled(f"transaction {self.tx_id} cancelled")
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"transaction {self.tx_id} timed out")


_tx_counter = itertools.count(1)


def new_transaction() -> Transaction:
    return Transaction(next(_tx_counter))


class ClientConnection:
    """Executor→peer connection (RapidsShuffleTransport.ClientConnection).

    ``request`` does a request/response round trip; data frames the peer
    sends back (tagged, sequenced — the UCX tag-matched receive analogue)
    are delivered to the registered frame handler."""

    def __init__(self, peer_executor_id: str):
        self.peer_executor_id = peer_executor_id
        self._frame_handler: Optional[Callable[[int, int, bytes], None]] = None

    def request(self, req_type: int, payload: bytes) -> Transaction:
        raise NotImplementedError

    def set_frame_handler(self, handler: Callable[[int, int, bytes], None]):
        """handler(tag, seq, data) — called for every incoming data frame."""
        self._frame_handler = handler

    def deliver_frame(self, tag: int, seq: int, data: bytes):
        if self._frame_handler is None:
            raise RuntimeError("data frame arrived with no frame handler set")
        self._frame_handler(tag, seq, data)

    def close(self):
        pass


class ServerConnection:
    """Server side (RapidsShuffleTransport.ServerConnection:141): handlers
    for request types + tagged sends back to a peer."""

    def __init__(self, executor_id: str):
        self.executor_id = executor_id
        self._handlers: Dict[int, Callable[[str, bytes], bytes]] = {}

    def register_request_handler(self, req_type: int, handler: Callable[[str, bytes], bytes]):
        """handler(peer_executor_id, request_payload) -> response_payload"""
        self._handlers[req_type] = handler

    def handle(self, req_type: int, peer: str, payload: bytes) -> bytes:
        h = self._handlers.get(req_type)
        if h is None:
            raise ValueError(f"no handler for request type {req_type}")
        return h(peer, payload)

    def send(self, peer_executor_id: str, tag: int, data: bytes) -> Transaction:
        raise NotImplementedError


class Transport:
    """Factory SPI (RapidsShuffleTransport.scala:38): one per executor."""

    def __init__(self, executor_id: str):
        self.executor_id = executor_id

    def connect(self, peer_executor_id: str, address: Optional[tuple] = None) -> ClientConnection:
        """Dial a peer. ``address`` is the heartbeat-gossiped dial info
        (BlockManagerId topology analogue); transports with their own
        discovery (in-process) ignore it."""
        raise NotImplementedError

    @property
    def server(self) -> ServerConnection:
        raise NotImplementedError

    def shutdown(self):
        pass


class InflightThrottle:
    """Bounds bytes requested-but-not-yet-received; pending fetch requests
    queue by (size, arrival) so small transfers are not starved behind one
    huge one (RapidsShuffleClient issue throttle over
    ``maxReceiveInflightBytes`` + HashedPriorityQueue ordering)."""

    def __init__(self, max_inflight_bytes: int):
        self.max_bytes = max_inflight_bytes
        self._lock = threading.Condition()
        self._inflight = 0
        self._waiters: List[tuple] = []  # heap of (size, seq)
        self._seq = itertools.count()

    def acquire(self, nbytes: int, timeout: Optional[float] = None,
                cancel: Optional["threading.Event"] = None):
        """Block until nbytes may go inflight. Requests larger than the
        window are admitted alone (never deadlock). A ``cancel`` event
        interrupts the wait with ``FetchCancelled`` — the fetch-abandonment
        path uses it so an issuer thread parked here can be shut down
        instead of leaked (``kick`` wakes the waiters to re-check)."""
        with self._lock:
            me = (nbytes, next(self._seq))
            heapq.heappush(self._waiters, me)
            deadline_ok = self._lock.wait_for(
                lambda: (cancel is not None and cancel.is_set())
                or (
                    self._waiters[0] == me
                    and (self._inflight == 0 or self._inflight + nbytes <= self.max_bytes)
                ),
                timeout,
            )
            if cancel is not None and cancel.is_set():
                self._waiters.remove(me)
                heapq.heapify(self._waiters)
                raise FetchCancelled("shuffle fetch cancelled")
            if not deadline_ok:
                self._waiters.remove(me)
                heapq.heapify(self._waiters)
                raise TimeoutError("shuffle fetch throttle timeout")
            heapq.heappop(self._waiters)
            self._inflight += nbytes
            self._lock.notify_all()

    def kick(self):
        """Wake every waiter to re-check its predicate (cancellation)."""
        with self._lock:
            self._lock.notify_all()

    def release(self, nbytes: int):
        with self._lock:
            self._inflight -= nbytes
            self._lock.notify_all()

    @property
    def inflight(self) -> int:
        with self._lock:
            return self._inflight
