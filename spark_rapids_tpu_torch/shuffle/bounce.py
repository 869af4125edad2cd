"""Bounce buffers: fixed pools of staging buffers + windowed block iteration.

Reference: shuffle/BounceBufferManager.scala (fixed pools of pinned-host and
device bounce buffers), WindowedBlockIterator.scala (walks a list of blocks
in bounce-buffer-sized windows), BufferSendState/BufferReceiveState (copy
catalog buffers through the windows). On TPU the device side of a transfer
is torch's own H2D/D2H; the host staging pool remains — it bounds peak host
memory for the DCN path and chunks large buffers into frames.

Copied from ``spark_rapids_tpu/shuffle/bounce.py``: the pool is host
memory only; the device side of a transfer is the serializer's download
and the reader's upload (``shuffle/serializer.py``).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Iterator, List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class BlockRange:
    """A contiguous slice of one logical block mapped into a window
    (WindowedBlockIterator.BlockRange)."""

    block_index: int  # which input block
    block_offset: int  # offset within that block
    length: int


def windowed_blocks(
    sizes: Sequence[int], window_bytes: int
) -> Iterator[List[BlockRange]]:
    """Walk blocks of the given sizes in windows of at most ``window_bytes``,
    never splitting a window across more bytes than one bounce buffer holds.
    Yields, per window, the list of (block, offset, length) ranges that fill
    it (WindowedBlockIterator.scala)."""
    assert window_bytes > 0
    current: List[BlockRange] = []
    room = window_bytes
    for bi, size in enumerate(sizes):
        off = 0
        remaining = size
        while remaining > 0:
            take = min(remaining, room)
            current.append(BlockRange(bi, off, take))
            off += take
            remaining -= take
            room -= take
            if room == 0:
                yield current
                current = []
                room = window_bytes
    if current:
        yield current


class BounceBuffer:
    def __init__(self, pool: "BounceBufferManager", offset: Optional[int], data):
        self._pool = pool
        self.offset = offset  # arena offset (native mode) or None
        self.data = data

    def close(self):
        self._pool.release(self)

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class BounceBufferManager:
    """Fixed pool of host staging buffers; acquire blocks when exhausted
    (BounceBufferManager.scala). The pool bound is what keeps a slow peer
    from ballooning host memory.

    With the native data plane available, buffers are sub-allocated from ONE
    contiguous arena through the best-fit AddressSpaceAllocator
    (AddressSpaceAllocator.scala:22 — the reference carves its bounce
    buffers out of a single pinned allocation the same way); otherwise each
    buffer is its own bytearray."""

    def __init__(self, buffer_size: int, num_buffers: int):
        from .. import native

        self.buffer_size = buffer_size
        self.num_buffers = num_buffers
        self._outstanding = 0
        self._lock = threading.Condition()
        self._recycled: List = []  # released data buffers, reused on acquire
        if native.available():
            cap = buffer_size * num_buffers
            self._arena: Optional[memoryview] = memoryview(bytearray(cap))
            self._asa = native.AddressSpaceAllocator(cap)
        else:
            self._arena = None
            self._asa = None

    def _make(self) -> BounceBuffer:
        if self._recycled:
            off, data = self._recycled.pop()
            return BounceBuffer(self, off, data)
        if self._asa is not None:
            off = self._asa.alloc(self.buffer_size)
            if off is None:  # can't happen with uniform sizes; fail loudly
                raise RuntimeError("bounce arena fragmented")
            return BounceBuffer(
                self, off, self._arena[off : off + self.buffer_size]
            )
        return BounceBuffer(self, None, bytearray(self.buffer_size))

    def acquire(self, timeout: Optional[float] = None) -> BounceBuffer:
        with self._lock:
            if not self._lock.wait_for(
                lambda: self._outstanding < self.num_buffers, timeout
            ):
                raise TimeoutError("bounce buffer pool exhausted")
            self._outstanding += 1
            return self._make()

    def try_acquire(self) -> Optional[BounceBuffer]:
        with self._lock:
            if self._outstanding >= self.num_buffers:
                return None
            self._outstanding += 1
            return self._make()

    def release(self, buf: BounceBuffer):
        with self._lock:
            self._recycled.append((buf.offset, buf.data))
            buf.offset = None
            buf.data = None
            self._outstanding -= 1
            self._lock.notify()

    @property
    def free_count(self) -> int:
        with self._lock:
            return self.num_buffers - self._outstanding


class BufferSendState:
    """Server-side: stream a set of payloads through bounce buffers as tagged
    frames (BufferSendState.scala). Each frame carries one window; the client
    reassembles by (tag, sequence)."""

    def __init__(
        self,
        payloads: Sequence[bytes],
        tags: Sequence[int],
        pool: BounceBufferManager,
        acquire_timeout_s: Optional[float] = 120.0,
    ):
        assert len(payloads) == len(tags)
        self._payloads = payloads
        self._tags = tags
        self._pool = pool
        self._acquire_timeout = acquire_timeout_s

    def frames(self) -> Iterator[Tuple[int, int, memoryview]]:
        """Yield (tag, seq, frame_view) per window — each window is copied
        once into an acquired bounce buffer and yielded as a view of it; the
        buffer is released when the consumer advances the generator, so the
        pool genuinely bounds frame memory. Consumers must finish sending
        (or copy) before requesting the next frame — exactly the reference's
        windowed-send contract (BufferSendState.scala)."""
        seqs = [0] * len(self._payloads)
        for window in windowed_blocks([len(p) for p in self._payloads], self._pool.buffer_size):
            for r in window:
                with self._pool.acquire(self._acquire_timeout) as bb:
                    chunk = memoryview(self._payloads[r.block_index])[
                        r.block_offset : r.block_offset + r.length
                    ]
                    bb.data[: r.length] = chunk
                    yield (
                        self._tags[r.block_index],
                        seqs[r.block_index],
                        memoryview(bb.data)[: r.length],
                    )
                seqs[r.block_index] += 1


class BufferReceiveState:
    """Client-side: reassemble tagged frames into whole payloads
    (BufferReceiveState.scala). Frames for one tag arrive in sequence order
    per connection; out-of-order across tags is fine."""

    def __init__(self, tag_sizes: dict):
        """tag_sizes: tag -> expected total bytes."""
        self._expected = dict(tag_sizes)
        self._chunks: dict = {t: [] for t in tag_sizes}
        self._received: dict = {t: 0 for t in tag_sizes}

    def on_frame(self, tag: int, seq: int, data: bytes) -> Optional[bytes]:
        """Add a frame; returns the completed payload when the tag's bytes
        are all in, else None."""
        chunks = self._chunks[tag]
        assert seq == len(chunks), f"out-of-order frame tag={tag} seq={seq}"
        # own the bytes: the sender's view may alias a bounce buffer that is
        # recycled as soon as it produces the next frame
        chunks.append(bytes(data))
        self._received[tag] += len(data)
        if self._received[tag] >= self._expected[tag]:
            payload = b"".join(chunks)
            del self._chunks[tag]
            return payload
        return None

    @property
    def done(self) -> bool:
        return not self._chunks
