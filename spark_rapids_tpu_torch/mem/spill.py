"""Tiered spill framework — device → pinned host RAM → disk.

Reference architecture: RapidsBufferCatalog.scala (id→tiered buffers, store
chain init :177-199), RapidsBufferStore.scala (priority spill queue,
``synchronousSpill`` :41-260), RapidsDeviceMemoryStore /
RapidsHostMemoryStore / RapidsDiskStore, SpillableColumnarBatch.scala
(:29-130 re-materialize from any tier), SpillPriorities.scala (priority
bands), and DeviceMemoryEventHandler.scala (:42-69 alloc-failure →
synchronous spill → retry).

The port of ``spark_rapids_tpu/mem/spill.py``. OOM handling is a wrapper at
the point device work is launched (``with_oom_retry``) that catches a device
OOM, synchronously spills registered buffers, and retries — plus proactive
headroom maintenance (``ensure_headroom``) against the device budget.

Tier currencies:

* DEVICE — the ``DeviceBatch``'s tensors.
* HOST   — the same tensors as page-locked (``pin_memory``) CPU tensors,
  copied with one sync a buffer, within
  ``spark.rapids.memory.host.spillStorageSize``. When the "device" is the
  CPU (the tests), the host tier holds plain copies, so the tier walk runs
  without a card.
* DISK   — the host tensors' numpy views, each plane of a nested column
  under its own path key (``d0.1`` is the data of the second child of
  column 0), written into the spill dir as one contiguous ``.srtf`` frame
  (a JSON header of keys, dtypes and shapes, then every plane 8-byte
  aligned, streamed by ``native.frame_write``), as the JAX spill writes
  them; ``np.savez`` to ``.npz`` where the native host plane is not built or
  is disabled. The metadata stays in the in-process catalog, as the
  reference keeps TableMeta in memory.

Byte accounting is by storage, once per storage. A batch's tensors can be
views of one storage, and the session's upload cache hands the same device
tensors to every query over a table, so bytes are counted per distinct
storage across the device tier, and a spill counts as freed only the
storages that dropping the catalog's reference releases: none while an
operator, the upload cache or another buffer still holds the batch, a
column, a tensor or another view of the storage. Such a buffer is not
spilled at all, since moving it would free nothing.
"""
from __future__ import annotations

import json
import logging
import os
import sys
import tempfile
import threading
import weakref
from typing import Callable, Optional

import numpy as np
import torch

from .. import config as cfg
from ..columnar.device import DeviceBatch, DeviceColumn, column_planes
from ..obs import metrics as obs_metrics

# process-wide spill telemetry (obs/metrics.py catalog): bytes by tier
# transition plus the device high-watermark, sampled at batch boundaries
# (register / re-materialize — the points device_bytes changes)
_M_D2H = obs_metrics.GLOBAL.counter("spill.bytesDeviceToHost")
_M_H2D_DISK = obs_metrics.GLOBAL.counter("spill.bytesHostToDisk")
_M_DISK2H = obs_metrics.GLOBAL.counter("spill.bytesDiskToHost")
_M_SPILLS = obs_metrics.GLOBAL.counter("spill.count")
_M_DEV_PEAK = obs_metrics.GLOBAL.watermark("mem.deviceBytesHighWatermark")

log = logging.getLogger(__name__)


class StorageTier:
    """RapidsBuffer.scala:53-59 tier enum (no GDS tier)."""

    DEVICE = 0
    HOST = 1
    DISK = 2

    NAMES = {0: "DEVICE", 1: "HOST", 2: "DISK"}


class SpillPriorities:
    """Priority bands (SpillPriorities.scala): lower spills first."""

    INPUT_FROM_SHUFFLE = -100
    ACTIVE_ON_DECK = 0
    WORKING = 100
    OUTPUT_FOR_SHUFFLE = 200


class SpillError(RuntimeError):
    """A spill-tier operation failed in a way that loses or blocks access to
    a registered buffer; the message always names the buffer id and tier so
    the task-level failure is diagnosable."""


# ── storage accounting ──────────────────────────────────────────────────────


def _tensors(batch: DeviceBatch) -> list:
    """Every tensor of a batch, repeats included, num_rows last."""
    out = [t for c in batch.columns for t in column_planes(c)]
    out.append(batch.num_rows)
    return out


def _storage_key(t: torch.Tensor) -> tuple:
    st = t.untyped_storage()
    return (str(t.device), st.data_ptr(), st.nbytes())


def storage_bytes(batch: DeviceBatch) -> dict:
    """{storage key: bytes} of the distinct storages a batch's tensors view."""
    return {k: k[2] for k in map(_storage_key, _tensors(batch))}


def _impl_count(t: torch.Tensor) -> int:
    """Tensors (TensorImpls) viewing ``t``'s storage, other than the storage
    wrapper this call makes; None where torch does not report it."""
    counter = getattr(torch._C, "_storage_Use_Count", None)
    if counter is None:
        return None
    st = t.untyped_storage()
    return counter(st._cdata) - 1


# references one local variable and sys.getrefcount's argument add
_LOCAL_REFS = 2


def _released_storages(buf: "_Buffer") -> dict:
    """{storage key: bytes} that dropping the catalog's reference to
    ``buf.device`` would release: only objects the catalog alone reaches
    (the batch, its column list, a column, a tensor) count, and a storage
    only when every tensor viewing it is one of those. Reference counts
    are read with one local variable per object (``_LOCAL_REFS``)."""
    batch = buf.device
    # the catalog's slot is the one reference a released batch may have
    if sys.getrefcount(batch) - _LOCAL_REFS > 1:
        return {}
    cols = batch.columns
    if sys.getrefcount(cols) - _LOCAL_REFS > 1:  # batch.columns
        return {}
    del cols
    col_uses: dict = {}
    for c in batch.columns:
        col_uses[id(c)] = col_uses.get(id(c), 0) + 1
    held_cols = set()
    for c in batch.columns:
        if sys.getrefcount(c) - _LOCAL_REFS > col_uses[id(c)]:
            held_cols.add(id(c))
    del c
    # a nested column's children: held when their tuple or a child column
    # is referenced from outside the column
    nested_held = {}
    for c in batch.columns:
        _mark_children_held(c, id(c) in held_cols, nested_held)
    del c
    # a tensor's references from the batch: one per field of a distinct
    # column (children included) naming it, and num_rows
    distinct = []
    for c in _all_columns(batch.columns):
        if all(c is not d for d in distinct):
            distinct.append(c)
    t_uses: dict = {}
    for c in distinct:
        for t in (c.data, c.validity, c.lengths):
            if t is not None:
                t_uses[id(t)] = t_uses.get(id(t), 0) + 1
    t = batch.num_rows
    t_uses[id(t)] = t_uses.get(id(t), 0) + 1
    by_storage: dict = {}  # key -> [our tensors, all released, impls]
    done: set = set()

    def visit(t, held: bool) -> None:
        # references: the structure's, this frame's parameter and
        # sys.getrefcount's argument (the caller's own local is deleted)
        if id(t) in done:
            return
        done.add(id(t))
        outside = sys.getrefcount(t) - _LOCAL_REFS - t_uses[id(t)]
        entry = by_storage.setdefault(_storage_key(t), [0, True, _impl_count(t)])
        entry[0] += 1
        if outside > 0 or held:
            entry[1] = False

    del t
    for c in distinct:
        held = id(c) in held_cols or nested_held.get(id(c), False)
        for name in ("data", "validity", "lengths"):
            if getattr(c, name) is not None:
                visit(getattr(c, name), held)
    visit(batch.num_rows, False)
    out = {}
    for key, (ours, released, impls) in by_storage.items():
        if released and (impls is None or impls <= ours):
            out[key] = key[2]
    return out


def _all_columns(cols) -> list:
    """The columns and, depth first, their children."""
    out = []
    for c in cols:
        out.append(c)
        out.extend(_all_columns(c.children or ()))
    return out


def _mark_children_held(col, held: bool, out: dict) -> None:
    """``out[id(child)]`` = whether each child column of ``col`` is reached
    from outside the batch: its parent is, the children tuple is, or the
    child itself is."""
    kids = col.children
    if kids is None:
        return
    held = held or sys.getrefcount(kids) - _LOCAL_REFS > 1  # col.children
    uses: dict = {}
    for k in kids:
        uses[id(k)] = uses.get(id(k), 0) + 1
    for k in kids:
        k_held = held or sys.getrefcount(k) - _LOCAL_REFS > uses[id(k)]
        out[id(k)] = out.get(id(k), False) or k_held
        _mark_children_held(k, k_held, out)


def _refcount_probe(hold: str) -> int:
    """The storages ``_released_storages`` finds released in a two-column
    CPU batch of five storages, of which ``hold`` names what is also held
    outside the catalog: "nothing", "batch", "column", "tensor" or "view"."""
    from types import SimpleNamespace

    from ..types import LONG, Schema, StructField

    def column():
        return DeviceColumn(LONG, torch.zeros(4, dtype=torch.int64), torch.ones(4, dtype=torch.bool))

    buf = SimpleNamespace(device=DeviceBatch(
        Schema([StructField("a", LONG), StructField("b", LONG)]),
        [column(), column()],
        torch.tensor(4, dtype=torch.int32),
    ))
    keep = {
        "nothing": lambda: None,
        "batch": lambda: buf.device,
        "column": lambda: buf.device.columns[0],
        "tensor": lambda: buf.device.columns[0].data,
        "view": lambda: buf.device.columns[0].data[1:],
    }[hold]()
    released = len(_released_storages(buf))
    del keep
    return released


#: what ``_refcount_probe`` must find: every storage of an unheld batch,
#: none of a held one, all but the held column's two or the held tensor's
REFCOUNT_MODEL = {"nothing": 5, "batch": 0, "column": 3, "tensor": 4, "view": 4}
_REFCOUNT_MODEL_CHECKED = False


def check_refcount_model() -> None:
    """Raise unless ``_released_storages``'s reading of reference counts
    holds on this interpreter and torch. Those counts are CPython's and
    torch's own business: were a version to count one reference more or
    less, the catalog would spill batches still in use, or nothing at all,
    without a word. Checked once per process, at the first spill."""
    global _REFCOUNT_MODEL_CHECKED
    if _REFCOUNT_MODEL_CHECKED:
        return
    got = {hold: _refcount_probe(hold) for hold in REFCOUNT_MODEL}
    if got != REFCOUNT_MODEL:
        raise RuntimeError(
            f"mem/spill.py: the reference counts of Python {sys.version.split()[0]} with "
            f"torch {torch.__version__} do not match _released_storages's model: released "
            f"storages {got}, expected {REFCOUNT_MODEL}"
        )
    _REFCOUNT_MODEL_CHECKED = True


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a CPU tensor: page-locked and copied asynchronously from a
    CUDA tensor (the caller syncs once per buffer), a plain copy from a CPU
    one (the tests' device)."""
    if t.device.type == "cuda":
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        return host
    return t.clone()


class SpillableBatch:
    """Handle to a batch owned by the catalog; re-materializes from whatever
    tier it currently lives at (SpillableColumnarBatch.scala:29-130).

    Not thread-safe per-handle (one owner task), but catalog operations are.
    """

    def __init__(self, catalog: "BufferCatalog", buf_id: int, schema, size: int):
        self._catalog = catalog
        self.id = buf_id
        self.schema = schema
        self.size_bytes = size
        self._closed = False

    def get_batch(self) -> DeviceBatch:
        """Bring the batch back to the DEVICE tier, *pin* it (unspillable
        until unpin()/close() — the RapidsBuffer.addReference protocol,
        RapidsBuffer.scala:82-172) and return it."""
        assert not self._closed, "use after close"
        return self._catalog._acquire_device(self.id)

    def unpin(self):
        """Make the buffer spillable again after a get_batch(). The caller
        must drop its DeviceBatch reference: a held batch keeps its device
        memory alive, and the catalog then frees nothing by spilling it."""
        self._catalog._unpin(self.id)

    def close(self):
        if not self._closed:
            self._closed = True
            self._catalog._remove(self.id)

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class _Buffer:
    __slots__ = ("id", "size", "priority", "tier", "device", "host", "path",
                 "schema", "pinned", "dev", "origin", "storages", "owner", "handle")

    def __init__(self, buf_id: int, size: int, priority: int):
        self.id = buf_id
        self.size = size
        self.priority = priority
        self.tier = StorageTier.DEVICE
        self.device: Optional[DeviceBatch] = None
        # host tier: ([(dtype, data, validity, lengths, children) per
        # column, children in the same form or None], num_rows)
        self.host: Optional[tuple] = None
        self.path: Optional[str] = None
        self.schema = None
        self.pinned = False
        self.dev: Optional[torch.device] = None  # device the batch returns to
        self.origin: Optional[str] = None  # registration site (debug mode)
        self.storages: dict = {}  # device-tier storage keys -> bytes
        self.owner: Optional[str] = None  # who reclaims it at query end
        self.handle = None  # weak: the SpillableBatch, closed on release


class BufferCatalog:
    """id → buffer at exactly one tier; spills walk DEVICE→HOST→DISK
    (RapidsBufferCatalog.scala:40-199)."""

    def __init__(
        self,
        device_limit: Optional[int] = None,
        host_limit: int = 1 << 31,
        spill_dir: Optional[str] = None,
    ):
        self._lock = threading.RLock()
        self._buffers: dict[int, _Buffer] = {}
        self._next_id = 0
        #: debug-allocator mode (spark.rapids.memory.tpu.debug — the
        #: reference's RMM debug allocator + cudf refcount.debug analogue):
        #: registration sites recorded, leaks reported at query end
        self.debug = False
        self.device_limit = device_limit  # None = unlimited (tests / CPU)
        self.host_limit = host_limit
        self._spill_dir = spill_dir
        self._owned_tmp: Optional[tempfile.TemporaryDirectory] = None
        # device-tier storages of registered buffers: key -> buffers holding
        # it; device_bytes counts each storage once
        self._storage_users: dict = {}
        self.device_bytes = 0
        self.host_bytes = 0
        self.disk_bytes = 0
        self.spill_count = 0
        #: set once the retry path has handled a device OOM in this
        #: catalog's query (resilience/retry.py::_note_oom)
        self.oom_handled = False

    @classmethod
    def from_conf(cls, conf) -> "BufferCatalog":
        cat = cls(
            device_limit=None,
            host_limit=cfg.HOST_SPILL_STORAGE_SIZE.get(conf),
            spill_dir=cfg.SPILL_DIR.get(conf),
        )
        cat.debug = cfg.MEMORY_DEBUG.get(conf)
        return cat

    def _dir(self) -> str:
        if self._spill_dir is None:
            self._owned_tmp = tempfile.TemporaryDirectory(prefix="srt_spill_")
            self._spill_dir = self._owned_tmp.name
        os.makedirs(self._spill_dir, exist_ok=True)
        return self._spill_dir

    # ── device-tier storage accounting ──────────────────────────────────
    def _hold_storages(self, buf: _Buffer, storages: dict) -> None:
        buf.storages = storages
        for key, nbytes in storages.items():
            users = self._storage_users.get(key, 0)
            if users == 0:
                self.device_bytes += nbytes
            self._storage_users[key] = users + 1
        _M_DEV_PEAK.set_max(self.device_bytes)

    def _drop_storages(self, buf: _Buffer) -> None:
        for key, nbytes in buf.storages.items():
            users = self._storage_users[key] - 1
            if users:
                self._storage_users[key] = users
            else:
                del self._storage_users[key]
                self.device_bytes -= nbytes
        buf.storages = {}

    # ── registration ────────────────────────────────────────────────────
    def register(
        self, batch: DeviceBatch, priority: int = SpillPriorities.WORKING,
        owner: Optional[str] = None,
    ) -> SpillableBatch:
        """Take ownership of a device batch, making it spillable. Admission
        enforces the device budget by spilling older buffers first. The
        caller drops its own reference to ``batch``: a spill frees only
        what the catalog alone holds. ``owner`` names buffers that
        :meth:`release` reclaims at the query's end (an exchange's slices),
        before the leak report."""
        storages = storage_bytes(batch)
        size = sum(storages.values())
        self.ensure_headroom(size, batch.device)
        with self._lock:
            buf = _Buffer(self._next_id, size, priority)
            self._next_id += 1
            buf.device = batch
            buf.schema = batch.schema
            buf.dev = batch.device
            buf.owner = owner
            if self.debug:
                import traceback

                frames = [
                    f"{os.path.basename(f.filename)}:{f.lineno}({f.name})"
                    for f in traceback.extract_stack(limit=9)[:-1]
                ]
                buf.origin = " <- ".join(reversed(frames))
                log.debug("register buffer %d (%d B) at %s", buf.id, size, buf.origin)
            self._buffers[buf.id] = buf
            self._hold_storages(buf, storages)
        handle = SpillableBatch(self, buf.id, batch.schema, size)
        buf.handle = weakref.ref(handle)
        return handle

    def release(self, owner: str) -> int:
        """Close every buffer registered by ``owner``; returns how many."""
        with self._lock:
            bufs = [b for b in self._buffers.values() if b.owner == owner]
        for b in bufs:
            h = b.handle()
            if h is not None:
                h.close()
            else:
                self._remove(b.id)
        return len(bufs)

    def leak_report(self) -> list:
        """Buffers still registered — at query end every operator should
        have closed its spillables; survivors are leaks (the debug-mode
        analogue of cudf's MemoryCleaner leak log)."""
        with self._lock:
            return [
                {
                    "id": b.id,
                    "size": b.size,
                    "tier": StorageTier.NAMES.get(b.tier, b.tier),
                    "pinned": b.pinned,
                    "origin": b.origin,
                }
                for b in self._buffers.values()
            ]

    # ── acquire / remove ────────────────────────────────────────────────
    def _acquire_device(self, buf_id: int) -> DeviceBatch:
        with self._lock:
            buf = self._buffers[buf_id]
            buf.pinned = True
            if buf.tier == StorageTier.DEVICE:
                return buf.device
            if buf.tier == StorageTier.DISK:
                self._disk_to_host(buf)
            # HOST → DEVICE: pinned sources copy asynchronously; torch's host
            # allocator keeps each source alive until its copy has run
            dev = buf.dev
            cols, num_rows = buf.host

            def up(t):
                return None if t is None else t.to(dev, non_blocking=True)

            batch = DeviceBatch(buf.schema, [_from_host(c, up) for c in cols], up(num_rows))
            buf.device = batch
            buf.host = None
            buf.tier = StorageTier.DEVICE
            self.host_bytes -= buf.size
            self._hold_storages(buf, storage_bytes(batch))
            return batch

    def _unpin(self, buf_id: int):
        with self._lock:
            buf = self._buffers.get(buf_id)
            if buf is not None:
                buf.pinned = False

    def _remove(self, buf_id: int):
        with self._lock:
            buf = self._buffers.pop(buf_id, None)
            if buf is None:
                return
            if buf.tier == StorageTier.DEVICE:
                self._drop_storages(buf)
                buf.device = None
            elif buf.tier == StorageTier.HOST:
                self.host_bytes -= buf.size
                buf.host = None
            else:
                self.disk_bytes -= buf.size
                if buf.path and os.path.exists(buf.path):
                    os.unlink(buf.path)

    # ── spilling ────────────────────────────────────────────────────────
    def _device_to_host(self, buf: _Buffer) -> None:
        if self.debug:
            log.debug("spill buffer %d DEVICE->HOST (%d B, origin %s)",
                      buf.id, buf.size, buf.origin)
        batch = buf.device
        copies: dict = {}  # one host copy per tensor object

        def down(t):
            if t is None:
                return None
            if id(t) not in copies:
                copies[id(t)] = _host_copy(t)
            return copies[id(t)]

        cols = [_to_host(c, down) for c in batch.columns]
        host = (cols, down(batch.num_rows))
        if batch.device.type == "cuda":
            # the one sync of this buffer: its host copies are complete
            torch.cuda.current_stream(batch.device).synchronize()
        del batch, down, copies
        buf.host = host
        buf.device = None  # the catalog's reference: the storages go here
        buf.tier = StorageTier.HOST
        self._drop_storages(buf)
        self.host_bytes += buf.size
        self.spill_count += 1
        _M_D2H.add(buf.size)
        _M_SPILLS.add(1)

    def _host_to_disk(self, buf: _Buffer) -> bool:
        """Returns False when the disk write failed — the buffer stays at
        the HOST tier (degraded but correct: host memory overshoots its
        budget rather than losing data)."""
        if self.debug:
            log.debug("spill buffer %d HOST->DISK (%d B, origin %s)",
                      buf.id, buf.size, buf.origin)
        try:
            self._write_disk(buf)
        except Exception as e:  # noqa: BLE001 - IO errors degrade, not crash
            from ..resilience import retry as _R

            _R.record("spill_write_errors")
            if buf.path and os.path.exists(buf.path):
                try:
                    os.unlink(buf.path)  # never leave a partial file behind
                except OSError:
                    pass
            buf.path = None
            log.warning(
                "disk spill of buffer %d (%d B) failed, keeping it at the "
                "HOST tier: %s", buf.id, buf.size, e,
            )
            return False
        buf.host = None
        buf.tier = StorageTier.DISK
        self.host_bytes -= buf.size
        self.disk_bytes += buf.size
        self.spill_count += 1
        _M_H2D_DISK.add(buf.size)
        _M_SPILLS.add(1)
        return True

    def _write_disk(self, buf: _Buffer):
        from .. import native
        from ..resilience import faults

        faults.on_spill_write()
        cols, num_rows = buf.host
        arrays = {"num_rows": num_rows.numpy()}
        for i, c in enumerate(cols):
            _frame_column(c, str(i), arrays)
        if native.available():
            # contiguous-frame spill (the reference's one-buffer spill
            # currency): a header, then every plane, in one streamed file
            path = os.path.join(self._dir(), f"buf{buf.id}.srtf")
            buf.path = path  # assigned BEFORE the write: failure cleanup unlinks it
            names = list(arrays)
            header = json.dumps({
                "names": names,
                "dtypes": [arrays[n].dtype.str for n in names],
                "shapes": [list(arrays[n].shape) for n in names],
            }).encode()
            with open(path, "wb") as f:
                native.frame_write(f, [header] + [arrays[n] for n in names])
        else:
            path = os.path.join(self._dir(), f"buf{buf.id}.npz")
            buf.path = path
            np.savez(path, **arrays)

    def _disk_to_host(self, buf: _Buffer):
        try:
            from ..resilience import faults

            faults.on_spill_read()
            self._read_disk(buf)
        except SpillError:
            raise
        except Exception as e:  # noqa: BLE001 - name the buffer and tier
            raise SpillError(
                f"buffer {buf.id} ({buf.size} B): failed to re-materialize "
                f"from the DISK tier at {buf.path!r}: "
                f"{type(e).__name__}: {e}"
            ) from e
        os.unlink(buf.path)
        buf.path = None
        buf.tier = StorageTier.HOST
        self.disk_bytes -= buf.size
        self.host_bytes += buf.size
        _M_DISK2H.add(buf.size)

    def _read_disk(self, buf: _Buffer):
        pin = buf.dev is not None and buf.dev.type == "cuda"

        def load(z, name):
            if name not in z.files:
                return None
            t = torch.from_numpy(z[name])
            return t.pin_memory() if pin else t

        if buf.path.endswith(".srtf"):
            from .. import native

            with open(buf.path, "rb") as f:
                data = f.read()
            views = native.frame_unpack(data)
            meta = json.loads(bytes(views[0]))
            arrays = {
                n: np.frombuffer(v, dtype=np.dtype(d)).reshape(shape).copy()
                for n, d, shape, v in zip(meta["names"], meta["dtypes"], meta["shapes"],
                                          views[1:])
            }
            z = _Frame(arrays)
        else:
            z = np.load(buf.path)
        with z:
            cols = [
                _unframe_column(f.data_type, str(i), lambda name: load(z, name))
                for i, f in enumerate(buf.schema)
            ]
            buf.host = (cols, load(z, "num_rows"))

    def _spill_order(self, tier: int, dev=None) -> list[_Buffer]:
        """Lowest priority first, then largest (frees most per spill).
        Pinned (acquired, in-use) buffers are never candidates; ``dev``
        restricts to one device's buffers."""
        bufs = [
            b
            for b in self._buffers.values()
            if b.tier == tier
            and not b.pinned
            and (dev is None or b.dev == dev)
        ]
        bufs.sort(key=lambda b: (b.priority, -b.size))
        return bufs

    def synchronous_spill(self, target_bytes: int, dev=None) -> int:
        """Move device buffers down-tier until >= target_bytes of device
        memory is released (RapidsBufferStore.synchronousSpill). Returns the
        bytes released: a buffer whose storages something outside the
        catalog still holds would release nothing, so it is not spilled. On
        a card the bytes are ``torch.cuda.memory_allocated``'s drop across
        each buffer's spill; elsewhere those of the storages released."""
        check_refcount_model()
        freed = 0
        with self._lock:
            for buf in self._spill_order(StorageTier.DEVICE, dev):
                if freed >= target_bytes:
                    break
                released = _released_storages(buf)
                if not released:
                    continue
                if buf.dev.type == "cuda":
                    # on a card, what the allocator saw freed, not the model
                    before = torch.cuda.memory_allocated(buf.dev)
                    self._device_to_host(buf)
                    freed += max(0, before - torch.cuda.memory_allocated(buf.dev))
                else:
                    self._device_to_host(buf)
                    freed += sum(released.values())
            # overflow host tier to disk
            if self.host_bytes > self.host_limit:
                for buf in self._spill_order(StorageTier.HOST):
                    if self.host_bytes <= self.host_limit:
                        break
                    self._host_to_disk(buf)
        return freed

    def ensure_headroom(self, want_bytes: int, dev=None):
        """Proactive admission: spill until want_bytes fits under the device
        budget (DeviceMemoryEventHandler, but ahead of the allocation).
        Device use is ``torch.cuda.memory_allocated`` on a card (a host-side
        counter of the caching allocator, not a driver query) and the
        catalog's own count elsewhere."""
        if self.device_limit is None:
            return
        with self._lock:
            if dev is not None and torch.device(dev).type == "cuda":
                used = torch.cuda.memory_allocated(dev)
            else:
                used = self.device_bytes
            excess = used + want_bytes - self.device_limit
            if excess > 0:
                self.synchronous_spill(excess, None if dev is None else torch.device(dev))

    def stats(self) -> dict:
        # under the catalog lock: the byte counters and the buffer map
        # move together during a spill
        with self._lock:
            return {
                "device_bytes": self.device_bytes,
                "host_bytes": self.host_bytes,
                "disk_bytes": self.disk_bytes,
                "buffers": len(self._buffers),
                "spill_count": self.spill_count,
            }


class _Frame:
    """A read ``.srtf`` frame's planes by key, read as ``np.load``'s archive
    is (``files``, ``[name]``, a context manager)."""

    def __init__(self, arrays: dict):
        self._arrays = arrays
        self.files = list(arrays)

    def __getitem__(self, name):
        return self._arrays[name]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._arrays = {}


def _to_host(c: DeviceColumn, down) -> tuple:
    kids = None if c.children is None else tuple(_to_host(k, down) for k in c.children)
    return (c.dtype, down(c.data), down(c.validity), down(c.lengths), kids)


def _from_host(h: tuple, up) -> DeviceColumn:
    dt, d, v, ln, kids = h
    kids = None if kids is None else tuple(_from_host(k, up) for k in kids)
    return DeviceColumn(dt, up(d), up(v), up(ln), kids)


def _child_types(dt) -> tuple:
    from ..types import ArrayType, MapType, StructType

    if isinstance(dt, StructType):
        return tuple(f.data_type for f in dt.fields)
    if isinstance(dt, MapType):
        return (dt.key_type, dt.value_type)
    if isinstance(dt, ArrayType):
        return (dt.element_type,)
    return ()


def _frame_column(h: tuple, path: str, arrays: dict) -> None:
    """A host-tier column's planes into ``arrays`` under ``<plane><path>``
    keys; child ``k`` of the column at ``path`` sits at ``path.k``."""
    _dt, d, v, ln, kids = h
    arrays[f"v{path}"] = v.numpy()
    if d is not None:
        arrays[f"d{path}"] = d.numpy()
    if ln is not None:
        arrays[f"l{path}"] = ln.numpy()
    for k, kid in enumerate(kids or ()):
        _frame_column(kid, f"{path}.{k}", arrays)


def _unframe_column(dt, path: str, load) -> tuple:
    kts = _child_types(dt)
    kids = tuple(_unframe_column(kt, f"{path}.{k}", load) for k, kt in enumerate(kts)) or None
    return (dt, load(f"d{path}"), load(f"v{path}"), load(f"l{path}"), kids)


def with_oom_retry(catalog: Optional[BufferCatalog], fn: Callable, *args, retries: int = 2):
    """Run device work; on a device OOM (classified through the full cause
    chain) spill everything spillable and retry
    (DeviceMemoryEventHandler.scala:42-69 RMM-callback analogue, relocated
    to the launch site). The splitting escalation for operators that can
    shrink their input lives in resilience/retry.py::run_with_retry; this is
    the non-splitting form. A real OOM also returns the allocator's free
    blocks before the retry (``retry._release_cache``)."""
    from ..resilience import retry as R

    attempt = 0
    while True:
        try:
            return R.launch(fn, *args)
        except Exception as e:  # noqa: BLE001 - classified below
            if catalog is None or not R.is_oom_error(e) or attempt >= retries:
                raise
            real = R.is_real_oom(e)
        attempt += 1
        R.record("oom_retries")
        R._note_oom(catalog)
        R._recover(catalog, real)
