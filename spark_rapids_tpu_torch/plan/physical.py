"""Physical plan base — the ``SparkPlan``/``GpuExec`` seam.

Reference: GpuExec.scala (the GpuExec trait: supportsColumnar, CoalesceGoal
batching contracts :166-277). Every node is an ``Exec`` producing a
``PartitionSet`` — a list of lazily-computable partition iterators of
batches. CPU execs stream ``HostBatch``; device execs stream ``DeviceBatch``;
explicit transition execs convert (HostToDeviceExec / DeviceToHostExec).

Copied from ``spark_rapids_tpu/plan/physical.py``. The context holds the
conf, the session, the device, the query's counters and the memory and
resilience runtime the operators run inside, as the JAX context does
(``spark_rapids_tpu/plan/physical.py:35-50, :114-153``): the device
semaphore, the spill catalog with the device budget (sized from
``torch.cuda.mem_get_info`` and any per-process cap, where the JAX package
reads ``jax.local_devices()`` memory stats), the OOM retry policy, the
session's circuit breaker and the query's cancel token (a property: a
worker thread may install an attempt-scoped override with
``token_override``, as speculation does). It also carries the query's
sequence number, its phase ledger (``obs/ledger.py``, set by the session's
prepare) and the metrics level; every ``Exec`` has its own metric registry
(``metric``, ``metrics_on``, ``collect_metrics``), as in the JAX package.
It holds the adaptive exchanges' size providers and the reuse memo
(``aqe_size_providers``, ``reuse_cache``, ``:129-132`` there), and the
shuffle and mesh state (``:95-103``, ``:133-138``, ``:180-274`` there): the
multi-process topology frozen at the session's construction
(``mp_driver``, ``mp_rank``, ``mp_size``), the lazily built
``shuffle_manager`` with ``next_shuffle_id()``, the thread-local
``broadcast_depth`` and the session's ``mesh``.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
from collections import Counter
from typing import Callable, Iterator, List, Optional, Sequence

import torch

from ..config import TpuConf
from ..obs.metrics import METRIC_LEVELS, Metric, MetricRegistry
from ..types import Schema


class ExecContext:
    """Per-query execution context: conf, session, device, memory and
    resilience. The device is the session's; a context made without a
    session must be given one (there is no default device)."""

    def __init__(self, conf: TpuConf, session=None, device=None):
        from .. import config as cfg
        from ..mem.semaphore import DeviceSemaphore
        from ..mem.spill import BufferCatalog
        from ..resilience.retry import RetryPolicy

        if device is None:
            if session is None:
                raise ValueError("an ExecContext without a session needs a device")
            device = session.device
        self.conf = conf
        self.session = session
        self.device = torch.device(device)
        # per-query counters the operators add to (hostToDeviceBytes, …)
        self.metrics: Counter = Counter()
        self.semaphore = DeviceSemaphore(cfg.CONCURRENT_TPU_TASKS.get(conf))
        self.catalog = BufferCatalog.from_conf(conf)
        # resilience: the OOM retry/split policy splittable operators use,
        # and the session's CPU-fallback circuit breaker (failures recorded
        # here are consulted by the NEXT planning pass)
        self.retry_policy = RetryPolicy.from_conf(conf)
        self.breaker = getattr(session, "_breaker", None)
        # the spillable-buffer budget the JAX package sizes from device
        # memory × allocFraction (GpuDeviceManager.initializeRmm's sizing),
        # here also within a per-process cap; unlimited on a CPU device
        limit = cfg.DEVICE_POOL_LIMIT.get(conf)
        if limit <= 0 and self.device.type == "cuda":
            _free, total = torch.cuda.mem_get_info(self.device)
            frac = cfg.POOL_SIZE_FRACTION.get(conf)
            cap = getattr(torch.cuda, "get_per_process_memory_fraction", None)
            if cap is not None:
                index = self.device.index
                frac = min(frac, cap(torch.cuda.current_device() if index is None else index))
            limit = int(total * frac)
        self.device_limit = max(limit, 0)
        if self.device_limit:
            self.catalog.device_limit = self.device_limit
        # spark.rapids.tpu.metrics.level wins when set; else the reference's
        # spark.rapids.sql.metrics.level key (obs/metrics.py taxonomy)
        level = (
            cfg.METRICS_LEVEL_TPU.get(conf)
            or cfg.METRICS_LEVEL.get(conf)
            or "MODERATE"
        )
        self.metrics_level = METRIC_LEVELS.get(level.upper(), 1)
        # the session's query sequence number (trace file names, query ids)
        self.query_seq = session._next_query_seq() if session is not None else 0
        # the query's phase ledger (obs/ledger.py); None = ledger off
        self.ledger = None
        # the query's cancellation token (sched/cancel.py), installed at
        # admission and checked at batch boundaries; None = unscheduled
        # execution (no checks). A worker thread may install a thread-local
        # override (an attempt-scoped LinkedCancelToken) via
        # ``token_override`` so ONE partition attempt can be cancelled —
        # speculation losing the race — without touching the query token
        # every other partition checks.
        self._cancel_token = None
        self._token_tls = threading.local()
        # AQE (spark.sql.adaptive.enabled): each adaptive exchange publishes
        # its measured-size provider here, keyed by id, so a join's two
        # linked exchanges compute ONE shared coalesce/skew assignment
        self.aqe_size_providers: dict = {}
        # exchange reuse (plan/reuse.py): shared exchange nodes memoize
        # their PartitionSet here so every consumer reads one materialization
        self.reuse_cache: dict = {}
        # multi-process topology (spark.rapids.shuffle.multiproc.*): frozen
        # at the session's construction; a session-less context reads it
        # once here
        if session is not None:
            self.mp_driver, self.mp_rank, self.mp_size = session.multiproc_topology()
        else:
            self.mp_driver = cfg.MULTIPROC_DRIVER.get(conf)
            self.mp_rank = cfg.MULTIPROC_RANK.get(conf)
            self.mp_size = cfg.MULTIPROC_SIZE.get(conf)
        self._shuffle_manager = None
        self._shuffle_mgr_lock = threading.Lock()
        # Shuffle ids are namespaced by the query sequence: a multi-process
        # driver registry outlives one query, and every rank must mint the
        # same id for the same exchange (each runs the same program, so the
        # (query_seq, per-query counter) pair agrees across processes)
        self._shuffle_ids = itertools.count(self.query_seq * 1_000_000 + 1)
        # depth > 0 while building a broadcast batch: exchanges below a
        # broadcast run WHOLE in every process. Thread-local: a build runs
        # on the thread that first asks for it
        self._broadcast_tls = threading.local()
        # mesh execution: the session's MeshContext (stable across queries);
        # None = single-device mode
        self.mesh = None
        if session is not None and getattr(session, "_mesh_on", False):
            self.mesh = session.mesh_context()

    @property
    def cancel_token(self):
        """The token operators should check: the thread-local attempt
        override when one is installed, else the query-level token set at
        admission. Operators read this lazily inside their partition
        closures, so the override reaches every node of the running
        partition without plan surgery."""
        tok = getattr(self._token_tls, "token", None)
        return tok if tok is not None else self._cancel_token

    @cancel_token.setter
    def cancel_token(self, token) -> None:
        self._cancel_token = token

    @property
    def broadcast_depth(self) -> int:
        return getattr(self._broadcast_tls, "depth", 0)

    @broadcast_depth.setter
    def broadcast_depth(self, value: int) -> None:
        self._broadcast_tls.depth = value

    @property
    def shuffle_manager(self):
        """The accelerated shuffle manager (GpuShuffleEnv.init analogue),
        built at first use under a lock (partition tasks and sibling
        exchanges may first-touch it at once). In-process: one executor
        whose map output lives in the query's spill catalog. A multi-process
        executor (``mp_driver`` set): the TCP transport and the driver
        service's heartbeat registry and map-output tracker, held on the
        SESSION — an executor keeps one shuffle server for its lifetime, and
        its map output stays servable after the query that wrote it, in an
        executor-lifetime store (not a query's catalog)."""
        with self._shuffle_mgr_lock:
            if self._shuffle_manager is None:
                self._shuffle_manager = self._build_shuffle_manager()
            return self._shuffle_manager

    def _shuffle_env_kwargs(self) -> dict:
        from .. import config as cfg

        c = self.conf
        return dict(
            codec=cfg.SHUFFLE_COMPRESSION_CODEC.get(c),
            max_inflight_bytes=cfg.SHUFFLE_MAX_RECEIVE_INFLIGHT.get(c),
            fetch_timeout_s=cfg.SHUFFLE_FETCH_TIMEOUT_S.get(c),
            bounce_buffer_size=cfg.SHUFFLE_BOUNCE_BUFFER_SIZE.get(c),
            bounce_buffer_count=cfg.SHUFFLE_BOUNCE_BUFFER_COUNT.get(c),
            fetch_max_retries=cfg.RETRY_FETCH_MAX_RETRIES.get(c),
            fetch_backoff_ms=cfg.RETRY_FETCH_BACKOFF_MS.get(c),
            fetch_max_backoff_ms=cfg.RETRY_FETCH_MAX_BACKOFF_MS.get(c),
            blacklist_after=cfg.RETRY_FETCH_BLACKLIST_AFTER.get(c),
            heartbeat_max_age_s=cfg.HEARTBEAT_MAX_AGE_S.get(c),
            device=self.device,
        )

    def _build_shuffle_manager(self):
        from .. import config as cfg
        from ..mem.spill import BufferCatalog
        from ..shuffle.heartbeat import ShuffleHeartbeatManager
        from ..shuffle.local import InProcessRegistry, InProcessTransport
        from ..shuffle.manager import MapOutputRegistry, ShuffleEnv, TpuShuffleManager

        if not self.mp_driver:
            env = ShuffleEnv(
                "driver-executor",
                InProcessTransport("driver-executor", InProcessRegistry()),
                self.catalog,
                ShuffleHeartbeatManager(),
                owner="exchange",
                **self._shuffle_env_kwargs(),
            )
            return TpuShuffleManager(env, MapOutputRegistry())
        cached = getattr(self.session, "_mp_shuffle_manager", None)
        if cached is not None:
            return cached
        from ..shuffle import driver_service as ds
        from ..shuffle.tcp import TcpTransport

        host, _, port = self.mp_driver.rpartition(":")
        heartbeats, registry = ds.connect((host, int(port)))
        executor_id = f"executor-{self.mp_rank}"
        transport = TcpTransport(
            executor_id,
            handshake_timeout_s=cfg.SHUFFLE_HANDSHAKE_TIMEOUT_S.get(self.conf),
        )
        store = BufferCatalog.from_conf(self.conf)
        if self.device_limit:
            store.device_limit = self.device_limit
        env = ShuffleEnv(
            executor_id, transport, store, heartbeats,
            address=tuple(transport.address), **self._shuffle_env_kwargs(),
        )
        mgr = TpuShuffleManager(env, registry)
        if self.session is not None:
            self.session._mp_shuffle_manager = mgr
        return mgr

    def next_shuffle_id(self) -> int:
        return next(self._shuffle_ids)

    @contextlib.contextmanager
    def token_override(self, token):
        """Install ``token`` as this worker thread's cancel token for the
        duration of one partition attempt."""
        prev = getattr(self._token_tls, "token", None)
        self._token_tls.token = token
        try:
            yield token
        finally:
            self._token_tls.token = prev


def _scoped_part(index: int, thunk):
    """Wrap a partition thunk so a TaskInfo (TaskContext analogue) is the
    active thread-local whenever this partition's frames execute. Nested
    PartitionSets re-assert their own TaskInfo before each pull, so each
    operator's loop body sees the TaskInfo of the stage directly beneath it
    (stable across batches — what row counters need)."""

    def run():
        from ..exec import task as _task

        info = _task.TaskInfo(index, attempt=_task.current_attempt())

        def gen():
            _task.set_current(info)
            _task.reset_input_file()
            it = thunk()
            while True:
                try:
                    x = next(it)
                except StopIteration:
                    return
                # re-assert AFTER the pull: deeper stages set their own info
                # while producing x
                _task.set_current(info)
                yield x

        return gen()

    return run


def _drained(thunk) -> Iterator:
    """Pull ``thunk`` to its end and yield nothing (a foreign partition)."""
    for _ in thunk():
        pass
    return
    yield


class PartitionSet:
    """Lazily computable partitions (the RDD[ColumnarBatch] analogue).

    ``foreign`` holds the partitions a multi-process query's peer executors
    compute (a managed exchange's reduce partitions of other ranks): a
    per-partition operator mapped over one yields nothing — not, say, the
    one row an ungrouped aggregate makes of an empty input — but still
    pulls it, so that this executor's map side runs."""

    def __init__(self, parts: List[Callable[[], Iterator]], foreign=frozenset()):
        self.parts = [_scoped_part(i, t) for i, t in enumerate(parts)]
        self.foreign = frozenset(foreign)

    @property
    def num_partitions(self) -> int:
        return len(self.parts)

    def map_partitions(self, fn) -> "PartitionSet":
        def wrap(i, thunk):
            if i in self.foreign:
                return lambda: _drained(thunk)
            return lambda: fn(thunk())

        return PartitionSet([wrap(i, t) for i, t in enumerate(self.parts)], self.foreign)

    def materialize(self) -> List[list]:
        return [list(t()) for t in self.parts]


class Exec:
    """Physical operator base."""

    def __init__(self, children: Sequence["Exec"]):
        self._children = list(children)
        self.metrics: MetricRegistry = MetricRegistry()

    # ── tree ────────────────────────────────────────────────────────────
    @property
    def children(self) -> List["Exec"]:
        return self._children

    def with_new_children(self, children: List["Exec"]) -> "Exec":
        import copy

        new = copy.copy(self)
        new._children = list(children)
        new.metrics = MetricRegistry()
        return new

    # ── contract ────────────────────────────────────────────────────────
    @property
    def output(self) -> Schema:
        raise NotImplementedError

    @property
    def is_device(self) -> bool:
        """True if this exec produces DeviceBatch (the supportsColumnar bit)."""
        return False

    def execute(self, ctx: ExecContext) -> PartitionSet:
        raise NotImplementedError

    # ── metrics ─────────────────────────────────────────────────────────
    def metric(
        self, name: str, level: str = "ESSENTIAL", kind: Optional[str] = None
    ) -> Metric:
        """Get-or-create this node's metric (locked — partition tasks and
        pipeline producers may race first touch). ``kind`` (MetricKind)
        drives exporter rendering; inferred from the name when omitted."""
        return self.metrics.get_or_create(name, level, kind)

    def metrics_on(self, ctx: "ExecContext", level: str) -> bool:
        """Is a metric of ``level`` collected under this query's
        ``spark.rapids.sql.metrics.level``?"""
        return METRIC_LEVELS[level] <= ctx.metrics_level

    def collect_metrics(self) -> dict:
        """node → {metric: value} for the whole subtree (Spark-UI stand-in)."""
        out = {}
        if self.metrics:
            out[self.node_string()] = {
                m.name: m.value for m in self.metrics.values()
            }
        for c in self.children:
            for k, v in c.collect_metrics().items():
                out.setdefault(k, {}).update(v)
        return out

    # ── pretty print ────────────────────────────────────────────────────
    def node_string(self) -> str:
        return type(self).__name__

    def tree_string(self, indent: int = 0) -> str:
        lines = [" " * indent + ("* " if self.is_device else "  ") + self.node_string()]
        for c in self.children:
            lines.append(c.tree_string(indent + 2))
        return "\n".join(lines)

    def __str__(self):
        return self.tree_string()
