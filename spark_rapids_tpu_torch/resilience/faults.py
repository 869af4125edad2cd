"""Deterministic fault injection — the chaos harness behind the resilience
layer's tests.

The reference validates its failure paths against forced RMM allocation
failures (DeviceMemoryEventHandlerSuite); the engine injects faults at its
own seams instead: device launches under an OOM-recovery scope
(``resilience/retry.py``, ``mem/spill.py::with_oom_retry``), splittable
operator launches with their batch size, and disk-tier spill IO
(``mem/spill.py``). Every point is counter-driven ("every Nth event"), so a
chaos run replays bit-identically — assertions can demand that
results under injected faults equal the fault-free run.

All points are inert (one ``is None`` check) unless a ``FaultConfig`` is
installed, either by ``scoped()`` (tests) or by the session when
``spark.rapids.tpu.faults.enabled`` is set.

Copied from ``spark_rapids_tpu/resilience/faults.py`` with the device-side
points: ``on_kernel_launch`` (``deviceOomEveryN``; in the port a "launch"
is one attempt of a device batch function under a recovery scope, where
the JAX package counts its compiled-kernel launches), ``on_batch_launch``,
``recoverable`` and ``on_spill_write``/``on_spill_read``, plus the two
points the query runtime observes: ``on_kernel_stall``
(``kernelStallEveryN``: a device launch SLEEPS without a progress beat —
what the watchdog must notice) and ``on_task_attempt``
(``stallPartition``: the first attempt of one partition straggles while
beating — what speculation must overtake) — and the shuffle slice's
points: outgoing TCP DATA frames dropped, delayed or bit-flipped
(``drop_tcp_data_frame``, ``corrupt_tcp_data_frame``, called from
``shuffle/tcp.py::_send_frame``) and a committed map output lost
(``lose_map_output``, the managed exchange's read). The compile and
compile-cache points come with the subsystems that observe them.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from contextlib import contextmanager
from typing import Optional


class InjectedFault(RuntimeError):
    """A synthetic failure raised by an injection point. The message mimics
    the real error class (CUDA's "out of memory" for OOM) so classification
    paths treat it like the real thing; ``kind`` lets tests assert on the
    injection itself."""

    def __init__(self, kind: str, msg: str):
        super().__init__(msg)
        self.kind = kind


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """One chaos scenario (all counters per-process, deterministic)."""

    device_oom_every_n: int = 0  # device launches under a recovery scope
    oom_above_bytes: int = 0  # splittable-operator launches over this size
    kernel_error_every_n: int = 0  # splittable-operator launches (non-OOM)
    spill_write_error_every_n: int = 0  # host→disk spill writes
    spill_read_error_every_n: int = 0  # disk→host re-materializations
    kernel_stall_every_n: int = 0  # stall (not fail) device launches
    kernel_stall_ms: float = 0.0
    stall_partition: int = -1  # straggle this partition id (first attempt)
    stall_partition_s: float = 2.0
    tcp_drop_every_n: int = 0  # outgoing shuffle DATA frames
    tcp_delay_every_n: int = 0
    tcp_delay_ms: float = 0.0
    tcp_corrupt_every_n: int = 0  # flip a byte in outgoing DATA frames
    map_output_loss_every_n: int = 0  # drop a committed shuffle map output


class FaultInjector:
    """Counters + the decision logic for one installed FaultConfig."""

    def __init__(self, config: FaultConfig):
        self.config = config
        self._lock = threading.Lock()
        self._counters: dict[str, int] = {}
        self.injected: dict[str, int] = {}

    def _tick(self, point: str, every_n: int) -> bool:
        if every_n <= 0:
            return False
        with self._lock:
            n = self._counters.get(point, 0) + 1
            self._counters[point] = n
            if n % every_n:
                return False
            self.injected[point] = self.injected.get(point, 0) + 1
            return True

    def _record(self, point: str) -> None:
        from . import retry as R

        R.record("faults_injected")

    # ── injection points ────────────────────────────────────────────────
    def on_kernel_launch(self) -> None:
        """Every device launch under a recovery scope."""
        if self._tick("kernel_launch", self.config.device_oom_every_n):
            self._record("kernel_launch")
            raise InjectedFault(
                "oom", "CUDA out of memory: injected device OOM (fault injection)"
            )

    def on_batch_launch(self, size_bytes: int) -> None:
        """Every splittable-operator launch, with the batch size known
        (resilience/retry.py — the seam the split state machine watches)."""
        c = self.config
        if c.oom_above_bytes and size_bytes > c.oom_above_bytes:
            with self._lock:
                self.injected["oom_above_bytes"] = (
                    self.injected.get("oom_above_bytes", 0) + 1
                )
            self._record("oom_above_bytes")
            raise InjectedFault(
                "oom",
                f"CUDA out of memory: injected OOM — batch of {size_bytes} B "
                f"exceeds the injected device budget of {c.oom_above_bytes} B",
            )
        if self._tick("batch_launch", c.kernel_error_every_n):
            self._record("batch_launch")
            raise InjectedFault(
                "kernel",
                "CUDA error: injected device kernel failure (fault injection)",
            )

    def on_kernel_stall(self) -> None:
        """Every Nth device launch under a recovery scope SLEEPS for
        kernelStallMs before running (a wedged-device simulation — no error
        is raised and no beat is stamped; nothing here recovers a stall;
        the watchdog's cancel is the recovery)."""
        c = self.config
        if self._tick("kernel_stall", c.kernel_stall_every_n) and c.kernel_stall_ms > 0:
            self._record("kernel_stall")
            time.sleep(c.kernel_stall_ms / 1e3)

    def on_task_attempt(self, partition_id: int, attempt: int,
                        token=None) -> None:
        """First attempt of the configured partition straggles: sleep in
        token-beating slices so the watchdog sees progress (a straggler is
        SLOW, not stalled — exactly what speculation, not the watchdog,
        must catch). Re-executed and speculative attempts run at full
        speed, so the duplicate attempt wins the race deterministically."""
        c = self.config
        if c.stall_partition < 0 or partition_id != c.stall_partition:
            return
        if attempt != 0 or c.stall_partition_s <= 0:
            return
        with self._lock:
            # one-shot: only the FIRST attempt ever observed straggles;
            # the speculative duplicate re-enters at attempt 0 too, and
            # stalling it as well would leave no attempt able to win
            if self.injected.get("stall_partition", 0):
                return
            self.injected["stall_partition"] = 1
        self._record("stall_partition")
        deadline = time.monotonic() + c.stall_partition_s
        while time.monotonic() < deadline:
            if token is not None:
                token.check()  # cancelled loser unwinds mid-straggle
            time.sleep(0.02)

    def on_spill_write(self) -> None:
        if self._tick("spill_write", self.config.spill_write_error_every_n):
            self._record("spill_write")
            raise InjectedFault("io", "injected spill-disk write IO error")

    def on_spill_read(self) -> None:
        if self._tick("spill_read", self.config.spill_read_error_every_n):
            self._record("spill_read")
            raise InjectedFault("io", "injected spill-disk read IO error")

    def on_tcp_data_frame(self) -> bool:
        """Returns True when the frame should be DROPPED; may also sleep
        (injected delay). Called only for DATA frames — control frames
        stay reliable, like a lossy link under a reliable RPC layer."""
        c = self.config
        if self._tick("tcp_delay", c.tcp_delay_every_n) and c.tcp_delay_ms > 0:
            time.sleep(c.tcp_delay_ms / 1e3)
        if self._tick("tcp_drop", c.tcp_drop_every_n):
            self._record("tcp_drop")
            return True
        return False

    def corrupt_tcp_data_frame(self) -> bool:
        """Whether to flip a payload byte in this outgoing DATA frame
        (AFTER its checksum is stamped — the receiver's CRC check is what
        must catch it)."""
        if self._tick("tcp_corrupt", self.config.tcp_corrupt_every_n):
            self._record("tcp_corrupt")
            return True
        return False

    def lose_map_output(self) -> bool:
        """Whether this exchange read should find its committed map output
        GONE (peer loss / blacklist simulation — the lineage layer must
        rebuild it instead of failing the query)."""
        if self._tick("map_output_loss", self.config.map_output_loss_every_n):
            self._record("map_output_loss")
            return True
        return False


_ACTIVE: Optional[FaultInjector] = None
_ACTIVE_COUNT = 0  # concurrent scoped() entries holding _ACTIVE installed
_SHADOWED: list = []  # [(injector, count)] scopes displaced by a newer one
_INSTALL_LOCK = threading.Lock()
_TLS = threading.local()


@contextmanager
def recoverable():
    """Marks the dynamic extent of a launch that has inline OOM recovery
    above it (resilience/retry.py run_once/run_with_retry, spill.py
    with_oom_retry). ``deviceOomEveryN`` fires ONLY inside this scope:
    injecting a synthetic OOM at a launch nothing recovers would only
    assert that unrecoverable failures fail — every covered launch instead
    exercises the spill/split machinery deterministically."""
    depth = getattr(_TLS, "depth", 0)
    _TLS.depth = depth + 1
    try:
        yield
    finally:
        _TLS.depth = depth


def in_recoverable_scope() -> bool:
    return getattr(_TLS, "depth", 0) > 0


# Module-level fast paths: one attribute read when no injector is installed.
def on_kernel_launch() -> None:
    inj = _ACTIVE
    if inj is not None and in_recoverable_scope():
        inj.on_kernel_launch()


def on_batch_launch(size_bytes: int) -> None:
    inj = _ACTIVE
    if inj is not None:
        inj.on_batch_launch(size_bytes)


def on_kernel_stall() -> None:
    inj = _ACTIVE
    if inj is not None:
        inj.on_kernel_stall()


def on_task_attempt(partition_id: int, attempt: int, token=None) -> None:
    inj = _ACTIVE
    if inj is not None:
        inj.on_task_attempt(partition_id, attempt, token)


def on_spill_write() -> None:
    inj = _ACTIVE
    if inj is not None:
        inj.on_spill_write()


def on_spill_read() -> None:
    inj = _ACTIVE
    if inj is not None:
        inj.on_spill_read()


def drop_tcp_data_frame() -> bool:
    inj = _ACTIVE
    if inj is not None:
        return inj.on_tcp_data_frame()
    return False


def corrupt_tcp_data_frame() -> bool:
    inj = _ACTIVE
    if inj is not None:
        return inj.corrupt_tcp_data_frame()
    return False


def lose_map_output() -> bool:
    inj = _ACTIVE
    if inj is not None:
        return inj.lose_map_output()
    return False


@contextmanager
def scoped(config_or_injector):
    """Install a fault scenario process-wide for the duration of the block
    (no-op when None). Accepts a ``FaultConfig`` (fresh counters) or a
    ``FaultInjector`` (counters persist across scopes — the session reuses
    ONE injector for its lifetime so every-Nth counters accumulate across
    queries). Concurrent scopes are refcounted by injector identity; a
    scope with a different injector shadows the current one and restores
    it when its own count drains."""
    global _ACTIVE, _ACTIVE_COUNT
    if config_or_injector is None:
        yield None
        return
    inj = (
        config_or_injector
        if isinstance(config_or_injector, FaultInjector)
        else FaultInjector(config_or_injector)
    )
    with _INSTALL_LOCK:
        if _ACTIVE is inj:
            _ACTIVE_COUNT += 1
        else:
            if _ACTIVE is not None:
                _SHADOWED.append((_ACTIVE, _ACTIVE_COUNT))
            _ACTIVE = inj
            _ACTIVE_COUNT = 1
    try:
        yield inj
    finally:
        with _INSTALL_LOCK:
            if _ACTIVE is inj:
                _ACTIVE_COUNT -= 1
                if _ACTIVE_COUNT <= 0:
                    if _SHADOWED:
                        _ACTIVE, _ACTIVE_COUNT = _SHADOWED.pop()
                    else:
                        _ACTIVE, _ACTIVE_COUNT = None, 0
            else:
                # exiting while shadowed (out-of-order exit across threads):
                # drain this injector's count on the shadow stack instead
                for i in range(len(_SHADOWED) - 1, -1, -1):
                    s, c = _SHADOWED[i]
                    if s is inj:
                        if c <= 1:
                            del _SHADOWED[i]
                        else:
                            _SHADOWED[i] = (s, c - 1)
                        break


def config_from_conf(conf) -> Optional[FaultConfig]:
    """FaultConfig from the device-side spark.rapids.tpu.faults.* keys; None
    unless spark.rapids.tpu.faults.enabled."""
    from .. import config as cfg

    if not cfg.FAULTS_ENABLED.get(conf):
        return None
    return FaultConfig(
        device_oom_every_n=cfg.FAULTS_DEVICE_OOM_EVERY_N.get(conf),
        oom_above_bytes=cfg.FAULTS_OOM_ABOVE_BYTES.get(conf),
        kernel_error_every_n=cfg.FAULTS_KERNEL_ERROR_EVERY_N.get(conf),
        spill_write_error_every_n=cfg.FAULTS_SPILL_WRITE_ERROR_EVERY_N.get(conf),
        spill_read_error_every_n=cfg.FAULTS_SPILL_READ_ERROR_EVERY_N.get(conf),
        kernel_stall_every_n=cfg.FAULTS_KERNEL_STALL_EVERY_N.get(conf),
        kernel_stall_ms=cfg.FAULTS_KERNEL_STALL_MS.get(conf),
        stall_partition=cfg.FAULTS_STALL_PARTITION.get(conf),
        stall_partition_s=cfg.FAULTS_STALL_PARTITION_S.get(conf),
        tcp_drop_every_n=cfg.FAULTS_TCP_DROP_EVERY_N.get(conf),
        tcp_delay_every_n=cfg.FAULTS_TCP_DELAY_EVERY_N.get(conf),
        tcp_delay_ms=cfg.FAULTS_TCP_DELAY_MS.get(conf),
        tcp_corrupt_every_n=cfg.FAULTS_TCP_CORRUPT_EVERY_N.get(conf),
        map_output_loss_every_n=cfg.FAULTS_MAP_OUTPUT_LOSS_EVERY_N.get(conf),
    )
