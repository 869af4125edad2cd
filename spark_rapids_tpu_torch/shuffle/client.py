"""Shuffle client — fetches remote map output over the transport SPI.

Reference: shuffle/RapidsShuffleClient.scala:74-120 — metadata request →
throttled TransferRequests → BufferReceiveState reassembly → received-buffer
catalog; and shuffle/RapidsShuffleIterator.scala — per-task orchestration
with fetch timeouts surfacing as fetch failures (stage retry).

Fault recovery (resilience layer): every fetch stage retries with
exponential backoff + deterministic seeded jitter before surfacing a
``ShuffleFetchError`` — a dropped DATA frame or a transient transport error
costs one retry wave, not the query. Retries re-request ONLY the blocks not
yet received (completed buffers were already yielded to the consumer and the
received catalog holds them). The issuer thread is fully cancellable: an
abandoned fetch signals it through the throttle/transaction cancel plumbing
and joins it — a timed-out fetch leaves no live threads behind.

Copied from ``spark_rapids_tpu/shuffle/client.py``. The metadata request
carries no span-context tail yet (the cross-process trace merge is ROADMAP
Queue A item 12), so a fetch records its histogram and a ``shuffle-fetch``
span of the metadata round trip, not a span across its yields. Completed
payloads are host bytes in the received catalog; the reduce task uploads
them itself.
"""
from __future__ import annotations

import itertools
import logging
import queue
import random
import threading
import time
from typing import Iterator, List, Optional, Tuple

from . import meta as M
from .bounce import BufferReceiveState
from .catalog import ShuffleReceivedBufferCatalog
from .server import unpack_frame
from .transport import (
    REQ_METADATA,
    REQ_TRANSFER,
    ClientConnection,
    FetchCancelled,
    InflightThrottle,
    TransactionStatus,
)

log = logging.getLogger(__name__)


class ShuffleFetchError(Exception):
    """Surfaced to the task as a fetch failure (the FetchFailedException
    analogue → upstream stage retry) — only after the client's own retry
    budget is exhausted."""


_tag_counter = itertools.count(0x1000)


class ShuffleClient:
    def __init__(
        self,
        conn: ClientConnection,
        received: ShuffleReceivedBufferCatalog,
        throttle: Optional[InflightThrottle] = None,
        fetch_timeout_s: float = 120.0,
        max_retries: int = 0,
        backoff_ms: float = 50.0,
        max_backoff_ms: float = 2000.0,
        retry_seed: int = 0,
        on_fetch_result=None,
    ):
        self._conn = conn
        self._received = received
        self._throttle = throttle or InflightThrottle(1 << 30)
        self._timeout = fetch_timeout_s
        self._max_retries = max(0, max_retries)
        self._backoff_ms = backoff_ms
        self._max_backoff_ms = max_backoff_ms
        # deterministic jitter: seeded per (seed, peer), so a chaos run
        # replays the same backoff schedule (peer id duck-typed: protocol
        # tests drive this client with minimal mock connections)
        self._peer_id = getattr(conn, "peer_executor_id", "?")
        self._rng = random.Random(f"{retry_seed}:{self._peer_id}")
        # on_fetch_result(peer_id, ok): the env's consecutive-failure /
        # blacklist tracking (peer eviction after N exhausted budgets)
        self._on_fetch_result = on_fetch_result
        self._lock = threading.Lock()
        # tag → (BufferReceiveState, TableMeta, completion queue); fetches
        # from concurrent reduce tasks coexist because tags are globally
        # unique (the UCX tag-space property the reference relies on)
        self._inflight_tags: dict = {}
        conn.set_frame_handler(self._on_frame)

    # ── frame path ──────────────────────────────────────────────────────
    def _on_frame(self, tag: int, seq: int, data: bytes):
        # transports hand us the raw framed bytes; unwrap the (tag, seq) header
        tag, seq, body = unpack_frame(data)
        # single critical section: whoever pops a tag from _inflight_tags
        # owns its completion AND its throttle release — the cleanup paths
        # follow the same claim protocol, so double-release is impossible
        with self._lock:
            entry = self._inflight_tags.get(tag)
            if entry is None:
                return  # fetch abandoned (timeout) — drop the late frame
            state, meta, completions = entry
            payload = state.on_frame(tag, seq, bytes(body))
            if payload is not None:
                self._inflight_tags.pop(tag, None)
        if payload is not None:
            rid = self._received.add(payload, meta)
            self._throttle.release(meta.buffer.size)
            from ..obs.metrics import GLOBAL as _obs

            _obs.counter("shuffle.bytesFetched").add(len(payload))
            completions.put((rid, meta))

    # ── retry pacing ────────────────────────────────────────────────────
    def _backoff(self, attempt: int) -> None:
        base = min(
            self._backoff_ms * (2 ** max(0, attempt - 1)), self._max_backoff_ms
        )
        delay_s = base * (0.5 + self._rng.random() / 2.0) / 1e3
        log.warning(
            "shuffle fetch from %s: retry %d/%d in %.0f ms",
            self._peer_id, attempt, self._max_retries,
            delay_s * 1e3,
        )
        time.sleep(delay_s)

    def _notify(self, ok: bool) -> None:
        if self._on_fetch_result is not None:
            try:
                self._on_fetch_result(self._peer_id, ok)
            except Exception:  # noqa: BLE001 - bookkeeping never kills a fetch
                pass

    # ── fetch orchestration ─────────────────────────────────────────────
    def _request_metadata(self, blocks: List[M.BlockId]) -> List[M.TableMeta]:
        from ..obs import trace as obs_trace
        from ..resilience.watchdog import stall_phase

        tx = self._conn.request(REQ_METADATA, M.pack_metadata_request(blocks))
        try:
            with stall_phase("fetch", f"peer:{self._peer_id}"), obs_trace.span(
                "shuffle-fetch", "shuffle",
                {"peer": str(self._peer_id), "blocks": len(blocks)},
            ):
                tx.wait(self._timeout)
        except TimeoutError as e:
            # FetchFailedException semantics: timeouts are fetch failures
            # (stage retry), not task-killing runtime errors
            raise ShuffleFetchError(f"metadata request timed out: {e}") from e
        if tx.status != TransactionStatus.SUCCESS:
            raise ShuffleFetchError(f"metadata request failed: {tx.error}")
        return M.unpack_metadata_response(tx.payload)

    def fetch_blocks(
        self, blocks: List[M.BlockId]
    ) -> Iterator[Tuple[int, M.TableMeta]]:
        """Fetch all batches for the block ranges; yields (received_id, meta)
        as transfers complete. The caller materializes via the received
        catalog (RapidsShuffleIterator's batch-per-next loop). Safe to call
        from concurrent tasks sharing this client."""
        from ..obs import metrics as obs_metrics
        from ..resilience import retry as R

        t_fetch = time.perf_counter_ns()
        try:
            yield from self._fetch_blocks_inner(blocks, R)
        finally:
            obs_metrics.GLOBAL.histogram("shuffle.fetchHist").observe(
                time.perf_counter_ns() - t_fetch
            )

    def _fetch_blocks_inner(self, blocks: List[M.BlockId], R):
        attempt = 0
        while True:
            try:
                metas = self._request_metadata(blocks)
                break
            except ShuffleFetchError:
                attempt += 1
                if attempt > self._max_retries:
                    self._notify(False)
                    raise
                R.record("fetch_retries")
                self._backoff(attempt)
        if not metas:
            self._notify(True)
            return
        pending = list(metas)
        attempt = 0
        while True:
            done_ids: set = set()
            completions: "queue.Queue" = queue.Queue()
            try:
                for rid, m in self._transfer_wave(pending, completions):
                    done_ids.add(m.buffer.buffer_id)
                    yield rid, m
                self._notify(True)
                return
            except ShuffleFetchError:
                # drain buffers that completed during the abort: they are
                # ALREADY in the received catalog (frame path ran), so
                # yielding them here — instead of re-fetching — keeps the
                # retry from leaking the first copy
                # graft: ok(cancel-beat: non-blocking get_nowait drain of
                # already-landed buffers; exits on first Empty)
                while True:
                    try:
                        item = completions.get_nowait()
                    except queue.Empty:
                        break
                    if isinstance(item, ShuffleFetchError):
                        continue
                    rid, m = item
                    done_ids.add(m.buffer.buffer_id)
                    yield rid, m
                pending = [
                    m for m in pending if m.buffer.buffer_id not in done_ids
                ]
                if not pending:  # everything landed despite the error
                    self._notify(True)
                    return
                attempt += 1
                if attempt > self._max_retries:
                    self._notify(False)
                    raise
                R.record("fetch_retries")
                self._backoff(attempt)

    def _transfer_wave(
        self, metas: List[M.TableMeta], completions: "queue.Queue"
    ) -> Iterator[Tuple[int, M.TableMeta]]:
        """One attempt at transferring ``metas``: register fresh tags, issue
        throttled transfer requests from an issuer thread, yield completions.
        Raises ShuffleFetchError on the first failure/timeout; the finally
        block cancels and JOINS the issuer (cancellable throttle/transaction
        waits), unregisters abandoned tags, and returns their throttle bytes
        — an abandoned wave leaks neither threads nor window budget. The
        caller owns ``completions`` so it can drain items that completed
        during the abort (already in the received catalog)."""
        tags = [next(_tag_counter) for _ in metas]
        with self._lock:
            for t, m in zip(tags, metas):
                self._inflight_tags[t] = (
                    BufferReceiveState({t: m.buffer.size}),
                    m,
                    completions,
                )

        # issue transfer requests in throttled waves (client-side inflight
        # bytes bound — RapidsConf maxReceiveInflightBytes)
        cancelled = threading.Event()
        acquired_tags: set = set()

        def issue():
            for i, m in enumerate(metas):
                if cancelled.is_set():
                    return
                try:
                    self._throttle.acquire(
                        m.buffer.size, self._timeout, cancel=cancelled
                    )
                except FetchCancelled:
                    return
                except TimeoutError as e:
                    with self._lock:
                        owned = self._inflight_tags.pop(tags[i], None)
                    if owned is not None:
                        completions.put(ShuffleFetchError(str(e)))
                    return
                acquired_tags.add(tags[i])
                if cancelled.is_set():
                    # consumer already gave up: hand the bytes straight back
                    # (claim the tag first — release only if we own it)
                    with self._lock:
                        owned = self._inflight_tags.pop(tags[i], None)
                    if owned is not None:
                        self._throttle.release(m.buffer.size)
                    acquired_tags.discard(tags[i])
                    return
                try:
                    req = M.TransferRequest(tags[i], (m.buffer.buffer_id,))
                    rtx = self._conn.request(REQ_TRANSFER, req.pack())
                    rtx.wait_cancellable(self._timeout, cancelled)
                    if rtx.status != TransactionStatus.SUCCESS:
                        raise ShuffleFetchError(rtx.error)
                    resp = M.TransferResponse.unpack(rtx.payload)
                    if any(resp.states):
                        raise ShuffleFetchError(
                            f"peer rejected buffers: {resp.states}"
                        )
                except FetchCancelled:
                    with self._lock:
                        owned = self._inflight_tags.pop(tags[i], None)
                    if owned is not None:
                        self._throttle.release(m.buffer.size)
                    acquired_tags.discard(tags[i])
                    return
                except Exception as e:  # noqa: BLE001 — surfaced to consumer
                    # claim-then-release: if the server streamed the frames
                    # before the response failed, _on_frame already owns the
                    # tag and released the bytes — don't release twice
                    with self._lock:
                        owned = self._inflight_tags.pop(tags[i], None)
                    if owned is not None:
                        self._throttle.release(m.buffer.size)
                    acquired_tags.discard(tags[i])
                    completions.put(
                        e if isinstance(e, ShuffleFetchError) else ShuffleFetchError(str(e))
                    )
                    return

        from ..resilience.watchdog import stall_phase

        issuer = threading.Thread(target=issue, daemon=True)
        issuer.start()
        try:
            for _ in range(len(metas)):
                try:
                    # the wait for remote frames is a legit long beat gap:
                    # phase-label it so a watchdog stall here reads
                    # 'stall:fetch' (dead peer), not a device wedge
                    with stall_phase("fetch", f"peer:{self._peer_id}"):
                        item = completions.get(timeout=self._timeout)
                except queue.Empty:
                    raise ShuffleFetchError(
                        f"timed out waiting for shuffle data from "
                        f"{self._peer_id}"
                    ) from None
                if isinstance(item, ShuffleFetchError):
                    raise item
                yield item
        finally:
            # abandon outstanding tags (error/timeout paths): release the
            # throttle bytes that were actually acquired so the shared
            # window can't shrink permanently; un-issued tags just unregister
            cancelled.set()
            self._throttle.kick()  # wake an issuer parked in acquire()
            with self._lock:
                for t in [t for t in tags if t in self._inflight_tags]:
                    _state, m, _q = self._inflight_tags.pop(t)
                    if t in acquired_tags:
                        self._throttle.release(m.buffer.size)
            issuer.join(timeout=5.0)
            if issuer.is_alive():
                # cancellable waits make prompt exit the invariant; the one
                # remaining non-cancellable point is a socket send stalled
                # by a zero-window peer. Log loudly rather than raise — a
                # raise in this finally would REPLACE the in-flight
                # ShuffleFetchError and bypass the retry/blacklist path
                # (the test suite asserts no leaked threads on the normal
                # timeout path)
                log.warning(
                    "shuffle fetch issuer to %s still alive after cancel+join",
                    self._peer_id,
                )
