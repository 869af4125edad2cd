"""TCP transport — the inter-host (DCN) data plane.

Reference: the UCX implementation (shuffle-plugin UCX.scala:55 — jucx worker
+ progress thread, TCP management-port handshake exchanging WorkerAddress,
tag-matched sends). TPU pods reach peer hosts over DCN, where a stream
socket is the native primitive: each executor runs one listener; a
connection handshakes with a HELLO carrying the dialing executor's id (the
WorkerAddress-exchange analogue), then multiplexes length-prefixed frames:

  REQUEST  (req_id, req_type, payload)  → dispatched to server handlers
  RESPONSE (req_id, payload | error)    → completes the pending transaction
  DATA     (tag, payload)               → delivered to the frame handler

A per-socket reader thread is the progress-thread analogue. Mesh traffic never comes here — it rides the single-controller mesh
exchange (parallel/mesh.py).

Copied from ``spark_rapids_tpu/shuffle/tcp.py``, the fault points
included: ``set_injection`` latency and bandwidth (or the
``SRT_TCP_INJECT_LATENCY_MS``/``SRT_TCP_INJECT_BW_MBPS`` environment of an
executor process) and the dropped and bit-flipped DATA frames of
``resilience/faults.py``. Frames carry host bytes only; the reader
thread hands them to the client, which uploads on the reduce task's own
thread.
"""
from __future__ import annotations

import itertools
import socket
import struct
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional, Tuple

from .transport import (
    ClientConnection,
    ServerConnection,
    Transaction,
    TransactionStatus,
    Transport,
    new_transaction,
)

_HELLO = 0
_REQUEST = 1
_RESPONSE = 2
_DATA = 3
_ERROR = 4

# kind, a (req_id|tag), b (req_type|unused), len, crc (CRC32C of the
# payload, DATA frames only — control frames ride the reliable RPC layer
# and a corrupt one already fails loudly at unpack)
_HEADER = struct.Struct("<bqqiI")

from ..obs.metrics import GLOBAL as _obs_registry
from ..utils.checksum import frame_checksum as _crc

_M_CORRUPT = _obs_registry.counter("shuffle.corruptFrames")

# DCN condition injection: loopback multiproc tests exercise throttle and
# bounce-buffer sizing under realistic latency/bandwidth (the reference
# validates its shuffle client against a MOCKED transport the same way —
# RapidsShuffleClientSuite.scala). One-way latency is added per frame and
# bandwidth caps serialize inside the socket write lock, so concurrent
# senders contend for the simulated link exactly like a real NIC.
# Env (read at import so executor subprocesses inherit):
#   SRT_TCP_INJECT_LATENCY_MS  — one-way per-frame latency
#   SRT_TCP_INJECT_BW_MBPS     — link bandwidth cap (payload MB/s)
import os as _os
import time as _time

_INJECT = {
    "latency_s": float(_os.environ.get("SRT_TCP_INJECT_LATENCY_MS", "0")) / 1e3,
    "bw_bps": float(_os.environ.get("SRT_TCP_INJECT_BW_MBPS", "0")) * 1e6,
}


def set_injection(latency_ms: float = 0.0, bandwidth_mbps: float = 0.0) -> None:
    """Configure simulated DCN conditions for this process's transports."""
    _INJECT["latency_s"] = latency_ms / 1e3
    _INJECT["bw_bps"] = bandwidth_mbps * 1e6


def _send_frame(sock: socket.socket, lock: threading.Lock, kind: int, a: int, b: int, payload: bytes):
    crc = 0
    if kind == _DATA:
        # deterministic fault injection (resilience/faults.py): DATA frames
        # may be dropped, delayed, or bit-flipped — the fetch layer's
        # timeout + retry (and the receiver's CRC check) is what recovers.
        # Control frames stay reliable (a lossy link under a reliable RPC
        # layer).
        from ..resilience import faults as _faults

        if _faults._ACTIVE is not None and _faults.drop_tcp_data_frame():
            return
        crc = _crc(payload)
        if _faults._ACTIVE is not None and payload and \
                _faults.corrupt_tcp_data_frame():
            # flip one byte AFTER stamping the checksum: the receiver's
            # CRC verification is the thing under test
            corrupted = bytearray(payload)
            corrupted[len(corrupted) // 2] ^= 0xFF
            payload = bytes(corrupted)
    with lock:
        if _INJECT["latency_s"] > 0:
            _time.sleep(_INJECT["latency_s"])
        if _INJECT["bw_bps"] > 0 and payload:
            _time.sleep(len(payload) / _INJECT["bw_bps"])
        sock.sendall(_HEADER.pack(kind, a, b, len(payload), crc) + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf.extend(chunk)
    return bytes(buf)


def _recv_frame(sock: socket.socket) -> Tuple[int, int, int, bytes, int]:
    head = _recv_exact(sock, _HEADER.size)
    kind, a, b, n, crc = _HEADER.unpack(head)
    payload = _recv_exact(sock, n) if n else b""
    return kind, a, b, payload, crc


class _TcpChannel:
    """One socket shared by requests (client role) and data frames/responses
    (server role) — both directions multiplex over it."""

    def __init__(
        self,
        transport: "TcpTransport",
        sock: socket.socket,
        peer_id: str,
        wlock: Optional[threading.Lock] = None,
    ):
        self.transport = transport
        self.sock = sock
        self.peer_id = peer_id
        self.wlock = wlock or threading.Lock()
        self.pending: Dict[int, Transaction] = {}
        self.pending_lock = threading.Lock()
        self.client_conn: Optional["_TcpClientConnection"] = None
        self.dead = False  # set when the read loop exits (socket dropped)
        self.reader = threading.Thread(target=self._read_loop, daemon=True)
        self.reader.start()

    def _read_loop(self):
        try:
            while True:
                kind, a, b, payload, crc = _recv_frame(self.sock)
                if kind == _REQUEST:
                    self.transport._dispatch_request(self, a, b, payload)
                elif kind == _RESPONSE or kind == _ERROR:
                    with self.pending_lock:
                        tx = self.pending.pop(a, None)
                    if tx is not None:
                        if kind == _RESPONSE:
                            tx.complete(TransactionStatus.SUCCESS, payload=payload)
                        else:
                            tx.complete(
                                TransactionStatus.ERROR, error=payload.decode("utf-8", "replace")
                            )
                elif kind == _DATA:
                    if _crc(payload) != crc:
                        # a corrupt DATA frame is DROPPED like a lost one:
                        # the fetch's timeout + missing-block re-request is
                        # the recovery (never hand garbage to the decoder)
                        _M_CORRUPT.add(1)
                        continue
                    if self.client_conn is not None:
                        self.client_conn.deliver_frame(a, 0, payload)
        except (ConnectionError, OSError):
            self.dead = True
            with self.pending_lock:
                for tx in self.pending.values():
                    tx.complete(TransactionStatus.ERROR, error="connection lost")
                self.pending.clear()


class _TcpClientConnection(ClientConnection):
    """Client role over one channel, with reconnect-on-drop: when the
    channel's socket died (peer restart, dropped TCP session), the next
    ``request`` redials the peer and retries the send once — a transient
    transport fault costs one reconnect, not a poisoned connection object
    that fails every later fetch (the resilience-layer transport
    contract)."""

    def __init__(self, channel: _TcpChannel, transport: "TcpTransport",
                 address: Optional[tuple]):
        super().__init__(channel.peer_id)
        self._channel = channel
        self._transport = transport
        self._address = address
        self._redial_lock = threading.Lock()
        self._req_ids = itertools.count(1)

    def _live_channel(self) -> _TcpChannel:
        ch = self._channel
        if not ch.dead:
            return ch
        with self._redial_lock:
            if self._channel.dead:
                if self._address is None:
                    raise ConnectionError(
                        f"channel to {self.peer_executor_id} is dead and no "
                        "dial address is known"
                    )
                from ..resilience import retry as R

                self._channel = self._transport._dial(
                    self.peer_executor_id, self._address, self
                )
                R.record("transport_reconnects")
            return self._channel

    def request(self, req_type: int, payload: bytes) -> Transaction:
        tx = new_transaction()
        rid = next(self._req_ids)  # pending table is per-channel, so a plain counter is unique
        for attempt in (0, 1):  # second attempt after a reconnect
            try:
                ch = self._live_channel()
            except (ConnectionError, OSError) as e:
                tx.complete(TransactionStatus.ERROR, error=str(e))
                return tx
            with ch.pending_lock:
                ch.pending[rid] = tx
            try:
                _send_frame(ch.sock, ch.wlock, _REQUEST, rid, req_type, payload)
                return tx
            except OSError as e:
                ch.dead = True
                with ch.pending_lock:
                    ch.pending.pop(rid, None)
                if attempt == 1:
                    tx.complete(TransactionStatus.ERROR, error=str(e))
        return tx

    def close(self):
        try:
            self._channel.sock.close()
        except OSError:
            pass


class _TcpServerConnection(ServerConnection):
    def __init__(self, transport: "TcpTransport"):
        super().__init__(transport.executor_id)
        self._transport = transport

    def send(self, peer_executor_id: str, tag: int, data: bytes) -> Transaction:
        tx = new_transaction()
        ch = self._transport._peer_channel(peer_executor_id)
        if ch is None:
            tx.complete(TransactionStatus.ERROR, error=f"no channel to {peer_executor_id}")
            return tx
        try:
            _send_frame(ch.sock, ch.wlock, _DATA, tag, 0, data)
            tx.complete(TransactionStatus.SUCCESS)
        except OSError as e:
            tx.complete(TransactionStatus.ERROR, error=str(e))
        return tx


class TcpTransport(Transport):
    """One listener per executor; ``address`` is the (host, port) peers dial
    — the BlockManagerId topology-info analogue carried by heartbeats."""

    def __init__(self, executor_id: str, host: str = "127.0.0.1", port: int = 0,
                 workers: int = 4, handshake_timeout_s: float = 10.0):
        super().__init__(executor_id)
        #: HELLO-frame deadline for dialing peers
        #: (spark.rapids.tpu.shuffle.handshakeTimeout)
        self.handshake_timeout_s = handshake_timeout_s
        self._listener = socket.create_server((host, port))
        self.address = self._listener.getsockname()
        self._server = _TcpServerConnection(self)
        self._channels: Dict[str, _TcpChannel] = {}
        self._chan_lock = threading.Lock()
        self._pool = ThreadPoolExecutor(max_workers=workers, thread_name_prefix=f"tcp-{executor_id}")
        self._accept_thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._accept_thread.start()

    @property
    def server(self) -> ServerConnection:
        return self._server

    def _accept_loop(self):
        while True:
            try:
                sock, _addr = self._listener.accept()
            except OSError:
                return
            # handshake off-thread with a deadline so a stalled or garbage
            # client can neither block the accept loop nor kill it
            threading.Thread(
                target=self._handshake, args=(sock,), daemon=True
            ).start()

    def _handshake(self, sock: socket.socket):
        try:
            sock.settimeout(self.handshake_timeout_s)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            kind, _a, _b, payload, _crc_v = _recv_frame(sock)
            if kind != _HELLO:
                raise ConnectionError(f"first frame must be HELLO, got {kind}")
            sock.settimeout(None)
            peer_id = payload.decode()
            ch = _TcpChannel(self, sock, peer_id)
            with self._chan_lock:
                self._channels[peer_id] = ch
        except Exception:  # noqa: BLE001 — bad dialers are dropped, not fatal
            try:
                sock.close()
            except OSError:
                pass

    def connect(self, peer_executor_id: str, address: Optional[tuple] = None) -> ClientConnection:
        """Dial a peer. ``address`` comes from the heartbeat-gossiped peer
        table; omitted → the peer was registered locally (tests)."""
        if address is None:
            address = _ADDRESSES[peer_executor_id]
        ch = self._dial(peer_executor_id, tuple(address), None)
        conn = _TcpClientConnection(ch, self, tuple(address))
        ch.client_conn = conn
        return conn

    def _dial(self, peer_executor_id: str, address: tuple,
              conn: Optional[_TcpClientConnection]) -> _TcpChannel:
        """Open a socket + HELLO handshake + channel; shared by first
        connect and reconnect-on-drop (``conn`` rebinds to the new
        channel's frame delivery)."""
        sock = socket.create_connection(tuple(address))
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            lock = threading.Lock()
            _send_frame(sock, lock, _HELLO, 0, 0, self.executor_id.encode())
            ch = _TcpChannel(self, sock, peer_executor_id, wlock=lock)
        except BaseException:
            # a failed handshake must not orphan the dialed socket
            sock.close()
            raise
        if conn is not None:
            ch.client_conn = conn
        return ch

    def _dispatch_request(self, ch: _TcpChannel, req_id: int, req_type: int, payload: bytes):
        def run():
            try:
                resp = self._server.handle(req_type, ch.peer_id, payload)
                _send_frame(ch.sock, ch.wlock, _RESPONSE, req_id, 0, resp)
            except Exception as e:  # noqa: BLE001 — surfaced as ERROR frame
                try:
                    _send_frame(ch.sock, ch.wlock, _ERROR, req_id, 0, str(e).encode())
                except OSError:
                    pass

        self._pool.submit(run)

    def _peer_channel(self, peer_id: str) -> Optional[_TcpChannel]:
        with self._chan_lock:
            return self._channels.get(peer_id)

    def register_address(self):
        """Publish this executor's address for local-process peer discovery
        (tests; in a cluster the heartbeat manager gossips it)."""
        _ADDRESSES[self.executor_id] = self.address

    def shutdown(self):
        # shutdown() before close(): a thread blocked in accept() pins the
        # kernel listener alive past close (in-flight syscalls hold the
        # file), leaking both the accept thread and the port
        try:
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:
            pass
        # close accepted channels so their reader threads unwind (the
        # peer's dialed channel sees EOF and unwinds its own reader)
        with self._chan_lock:
            chans = list(self._channels.values())
            self._channels.clear()
        for ch in chans:
            try:
                ch.sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                ch.sock.close()
            except OSError:
                pass
        self._pool.shutdown(wait=False)


_ADDRESSES: Dict[str, tuple] = {}
