"""TorchSession + DataFrame — the SparkSession-shaped entry point.

The port of ``spark_rapids_tpu/session.py``: DataFrame → logical plan → CPU
physical plan → ``GpuOverrides`` rewrite → execution.
``conf["spark.rapids.sql.enabled"]=False`` gives the pure-CPU run, which is
how the differential tests produce their oracle.

The device is explicit: ``TorchSession(conf, device=None)`` runs on
``cuda`` and raises where no card is present, unless the caller passes
``device="cpu"`` (the tests do). It never falls back to the CPU on its own.

The DataFrame surface so far: ``create_dataframe``, ``select`` (window
expressions pulled into ``Window`` nodes), ``filter``, ``agg``,
``group_by`` (with ``pivot`` and the ``count``/``sum``/``avg``/``min``/
``max`` shorthands), ``rollup``, ``cube``, ``sort``,
``sort_within_partitions``, ``limit``, ``union``, ``distinct``, ``drop``,
``drop_duplicates``, ``intersect``, ``subtract``, ``repartition``,
``join``, ``cross_join``, ``with_column``, ``with_column_renamed``,
``fillna``, ``dropna`` and ``sample``, with the actions ``collect``,
``count``, ``head``, ``first``, ``take``, ``show``, ``to_host``,
``to_torch``, ``to_arrow`` and ``to_pandas`` (pyarrow and pandas imported
only there) and ``explain`` (``explain("metrics")`` for the last run);
and the SQL front-end: ``sql(text, params)`` over the temp views that
``create_or_replace_temp_view`` registers (a plain dict: the JAX session's
result-cache version bumps wait for the caches slice).

Each query runs inside the query runtime, at the places the JAX session
wires it: ``_prepare_plan`` bills the query's phase ledger
(``obs/ledger.py``) and fuses project/filter chains into ``StageExec``s
(``plan/fusion.py``); ``_execute`` admits the query through the session's
``QueryScheduler`` (``sched/``: weighted permits, fair-share pools,
deadlines, ``cancel``/``cancel_all``, the progress watchdog), traces it
when ``spark.rapids.tpu.trace.enabled`` samples it (``obs/trace.py``), and
``_run_plan`` runs a multi-partition root's tasks on
``spark.rapids.sql.concurrentGpuTasks`` threads, committing them in
partition order (the device plan's own partitions run concurrently under
its root coalesce, ``exec/gpu.py``).

Each query also runs inside the memory and resilience runtime: its
``ExecContext`` holds the device semaphore, the spill catalog, the OOM
retry policy and the session's ``CircuitBreaker``; each partition runs as
a task with Spark's retry model (``_run_task``, ``spark.task.maxFailures``);
an op whose device path failed ``threshold`` times plans on the CPU engine
with the breaker's reason in the explain; ``spark.rapids.tpu.faults.*``
installs the session's fault injector around its queries; and with
``spark.rapids.memory.tpu.debug`` set, buffers still registered in the
catalog at the query's end are logged as leaks.
Columns from a dict carry no nulls except strings (None); pass a
``HostBatch`` or an Arrow table for nullable fixed-width columns. Plans are column-pruned before
planning (``plan/pruning.py``), and the session keeps the device batches of
its in-memory tables in an upload cache (``_h2d_cache``, filled by
``HostToDeviceExec``), as the JAX session does.

Files: ``session.read`` (``DataFrameReader``: ``parquet``, ``csv``,
``option``, the alluxio path rewrite, bucket specs and scan roots; ``orc``
raises, naming ROADMAP item 10b) and ``df.write`` (``io/writer.py``'s
``DataFrameWriter``) over the port's own Parquet and CSV codecs
(``io/``). ``df.cache()`` materializes its plan once, on first use, and
keeps the result as the port's own SNAPPY Parquet bytes (the JAX session
keeps ZSTD, which the port does not write), decoded once on the next use
and served as an in-memory relation from then on; ``unpersist()`` drops it
and its device uploads. The serving layers come with later slices.
"""
from __future__ import annotations

import contextlib
import threading
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from . import config as cfg
from .columnar.host import (
    HostBatch,
    HostColumn,
    batch_rows,
    column_from_pylist,
    concat_batches,
    from_arrow,
    string_column,
)
from .config import TpuConf
from .exec.cpu_join import extract_equi_join_keys
from .expr import Alias, Expression, UnresolvedAttribute, bind, output_name
from .functions import Column, _e, col
from .plan import logical as L
from .plan.overrides import GpuOverrides
from .plan.physical import ExecContext
from .plan.planner import plan_physical
from .plan.pruning import prune_columns
from .types import Schema, StringType, StructField, is_complex


def _resolve_device(device) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "TorchSession runs on a CUDA device and none is available; "
                'pass device="cpu" to run on the CPU'
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev


class TorchSession:
    """The port's ``TpuSession``. Conf keys are the JAX package's."""

    def __init__(self, conf: Optional[dict] = None, device=None):
        self.conf = TpuConf(conf or {})
        # version shim (ShimLoader analogue): shim-driven defaults fill
        # keys the user left unset; an unknown version raises
        from .shims import get_shim

        self.shim = get_shim(cfg.SPARK_VERSION.get(self.conf))
        if self.conf.get_raw(cfg.ANSI_ENABLED.key) is None and self.shim.ansi_default():
            self.conf = self.conf.set(cfg.ANSI_ENABLED.key, True)
        if (
            self.conf.get_raw(cfg.ADAPTIVE_ENABLED.key) is None
            and self.shim.adaptive_default()
        ):
            self.conf = self.conf.set(cfg.ADAPTIVE_ENABLED.key, True)
        self.device = _resolve_device(device)
        # an explicit device places every mesh member on it; None means the
        # visible CUDA devices (mesh_context)
        self._device_given = device is not None
        # native host data plane gate (spark.rapids.native.enabled)
        from . import native as _native

        _native.set_enabled(cfg.NATIVE_ENABLED.get(self.conf))
        self._mesh_ctx = None
        # startup_only: mesh mode is committed at construction (partition
        # arity, exchange lowering); per-query surfaces read this frozen
        # flag, never the conf
        self._mesh_on = cfg.MESH_ENABLED.get(self.conf)
        if self._mesh_on:
            # mesh mode: one exchange partition per member, so the planner's
            # shuffle arity matches the mesh unless the user pinned it
            if self.conf.get_raw(cfg.SHUFFLE_PARTITIONS.key) is None:
                self.conf = self.conf.set(cfg.SHUFFLE_PARTITIONS.key, self.mesh_context().n)
        elif (
            cfg.SQL_ENABLED.get(self.conf)
            and self.conf.get_raw(cfg.SHUFFLE_PARTITIONS.key) is None
        ):
            # single-device default: ONE task (the reference's
            # concurrentGpuTasks model), as in the JAX package
            self.conf = self.conf.set(cfg.SHUFFLE_PARTITIONS.key, 1)
        mp_driver = cfg.MULTIPROC_DRIVER.get(self.conf)
        mp_rank = cfg.MULTIPROC_RANK.get(self.conf)
        mp_size = cfg.MULTIPROC_SIZE.get(self.conf)
        if mp_driver:
            # fail fast on inconsistent multi-process settings — a missing
            # piece silently double-counts (every rank runs the full query)
            if not cfg.SHUFFLE_MANAGER_ENABLED.get(self.conf):
                raise ValueError(
                    "spark.rapids.shuffle.multiproc.driver requires "
                    "spark.rapids.shuffle.manager.enabled=true"
                )
            if mp_size < 2 or not (0 <= mp_rank < mp_size):
                raise ValueError(f"multiproc rank/size invalid: rank={mp_rank} size={mp_size}")
        # The multiproc keys are startup_only: the transport, executor id
        # and driver registration commit to this topology, so every
        # per-query surface reads the frozen tuple; the thread-local
        # override lets subquery resolution run single-process without
        # mutating the shared conf (as in the JAX session)
        self._mp_topology = (mp_driver, mp_rank, mp_size) if mp_driver else ("", 0, 1)
        self._mp_off_tls = threading.local()
        # one executor's shuffle manager for the session's lifetime
        # (multi-process mode; plan/physical.py::ExecContext.shuffle_manager)
        self._mp_shuffle_manager = None
        self._last_overrides: Optional[GpuOverrides] = None
        # the last query's counters (hostToDeviceBytes, …)
        self._last_metrics: dict = {}
        # device batches of in-memory relations, keyed by the source batch's
        # id (the entry pins the source), byte-bounded LRU in insertion order
        self._h2d_cache: dict = {}
        self._h2d_lock = threading.Lock()
        # SQL temp views: lower-cased name -> DataFrame
        self._temp_views: dict = {}
        # df.cache(): cache key -> entry (Parquet bytes, then the decoded
        # batch), single-flight under the lock
        self._cache_lock = threading.Lock()
        self._cache_store: dict = {}
        # the last query's task re-executions (spark.task.maxFailures)
        self._task_retries = 0
        # resilience: the session-lifetime CPU-fallback circuit breaker
        # (runtime device failures flip ops to the CPU engine at the next
        # planning pass) and the deterministic fault-injection scenario
        # (None unless spark.rapids.tpu.faults.enabled — chaos testing only;
        # one injector, so every-Nth counters accumulate across queries)
        from .resilience import CircuitBreaker
        from .resilience import faults as _faults

        self._breaker = CircuitBreaker.from_conf(self.conf)
        config = _faults.config_from_conf(self.conf)
        self._fault_injector = None if config is None else _faults.FaultInjector(config)
        # the query runtime: the multi-tenant scheduler (admission, the
        # cancellation registry, the watchdog; its confs are re-read at
        # every admission), the last query's plan, ledger, tracer and
        # stage count, and the query sequence
        from .sched import QueryScheduler

        self._scheduler = QueryScheduler()
        self._scheduler.breaker = self._breaker
        self._seq_lock = threading.Lock()
        self._query_seq = 0
        self._last_plan = None
        self._last_ledger = None
        self._last_tracer = None
        self._last_fused_stages = 0
        self._last_reused_exchanges = 0
        # obs wiring: the dynamic-series cardinality cap is process-global
        # (as the registry it guards is), and the live scrape endpoint
        # starts here when spark.rapids.tpu.metrics.httpPort asks for it
        from .obs import metrics as _obs_metrics
        from .obs.scrape import ensure_scrape

        self._scrape_server = None
        _obs_metrics.set_slug_cap(cfg.METRICS_MAX_DYNAMIC_SLUGS.get(self.conf))
        ensure_scrape(self)

    def _next_query_seq(self) -> int:
        with self._seq_lock:
            self._query_seq += 1
            return self._query_seq

    def close(self) -> None:
        """Stop what the session started: the scrape listener, if any, and
        a multi-process executor's shuffle transport."""
        srv = self._scrape_server
        if srv is not None:
            self._scrape_server = None
            srv.stop()
        mgr = self._mp_shuffle_manager
        if mgr is not None:
            self._mp_shuffle_manager = None
            mgr.env.transport.shutdown()

    def multiproc_topology(self) -> tuple:
        """``(driver, rank, size)`` as frozen at construction — the only
        read of the startup_only multiproc keys on the query path. The
        single-process tuple while the calling thread resolves a subquery
        (subqueries run WHOLE on every rank)."""
        if getattr(self._mp_off_tls, "depth", 0) > 0:
            return ("", 0, 1)
        return self._mp_topology

    @contextlib.contextmanager
    def _single_process_scope(self):
        """Thread-local multiproc-off scope for subquery resolution; a depth
        counter, so a nested subquery's exit does not re-enable multiproc
        for the still-running outer one."""
        tls = self._mp_off_tls
        tls.depth = getattr(tls, "depth", 0) + 1
        try:
            yield
        finally:
            tls.depth -= 1

    def mesh_context(self):
        """The session's ``MeshContext`` (mesh mode), built at first use:
        ``spark.rapids.sql.mesh.size`` members on the session's device when
        one was given (0 means 1), else the visible CUDA devices,
        ``min(size, count)`` (0 means all), as the JAX session takes
        ``min(size, len(jax.devices()))``."""
        if self._mesh_ctx is None:
            from .parallel.mesh import MeshContext

            size = cfg.MESH_SIZE.get(self.conf)
            if self._device_given:
                devices = [self.device] * max(size, 1)
            else:
                count = torch.cuda.device_count()
                n = min(size or count, count)
                devices = [torch.device("cuda", i) for i in range(n)]
            self._mesh_ctx = MeshContext(devices)
        return self._mesh_ctx

    # ── multi-tenant scheduling (sched/) ────────────────────────────────
    @property
    def scheduler(self):
        """The session's QueryScheduler (admission pool + active-query
        registry) — read-only introspection for services and tests."""
        return self._scheduler

    def active_queries(self) -> dict:
        """query_id → {pool, permits, granted, running, queue_wait_s} of
        every query currently queued or executing in this session."""
        return self._scheduler.active_queries()

    def cancel(self, query_id: str, reason: str = "cancelled by user") -> bool:
        """Cancel one in-flight query: it stops at its next batch boundary,
        releases its admission permits, and raises QueryCancelledError to
        its caller. True when a matching active query existed."""
        return self._scheduler.cancel(query_id, reason)

    def cancel_all(self, reason: str = "cancel_all") -> int:
        """Cancel every queued and running query; returns how many were
        flagged. The session stays fully usable afterwards."""
        return self._scheduler.cancel_all(reason)

    def set_conf(self, key: str, value) -> None:
        """Set one conf key for the queries that follow (per-query keys are
        re-read at every query; ``startup_only`` keys keep the value the
        session was made with). A fault-injection key rebuilds the
        session's injector, as in the JAX session."""
        self.conf = self.conf.set(key, value)
        if key.startswith("spark.rapids.tpu.faults."):
            from .resilience import faults as _faults

            config = _faults.config_from_conf(self.conf)
            self._fault_injector = None if config is None else _faults.FaultInjector(config)

    # ── SQL ─────────────────────────────────────────────────────────────
    def sql(self, text: str, params=None) -> "DataFrame":
        """A SELECT statement over the registered temp views (``sql/``).
        ``params`` binds the statement's ``?`` placeholders positionally,
        on the AST (``sql/parser.py::bind_parameters``), so values are
        always literals, never spliced text."""
        from .sql import Compiler, bind_parameters, parse

        q = parse(text)
        if params is not None:
            q = bind_parameters(q, params)
        return Compiler(self).compile(q)

    def create_or_replace_temp_view(self, name: str, df: "DataFrame") -> None:
        self._temp_views[name.lower()] = df

    def drop_temp_view(self, name: str) -> bool:
        return self._temp_views.pop(name.lower(), None) is not None

    def table(self, name: str) -> "DataFrame":
        try:
            return self._temp_views[name.lower()]
        except KeyError:
            raise ValueError(f"unknown table {name!r}") from None

    def create_dataframe(
        self,
        data: Union[HostBatch, dict, object],
        schema: Optional[Schema] = None,
        num_partitions: int = 1,
    ) -> "DataFrame":
        """A DataFrame over in-memory data: a ``HostBatch``, a dict of
        columns (numpy arrays; sequences of str/None for strings; Python
        lists, dicts and, with a schema, tuples or dicts for array, map and
        struct columns), or a ``pyarrow`` Table/RecordBatch (pyarrow is
        imported only then)."""
        if isinstance(data, HostBatch):
            batch = data
            if schema is not None and schema != batch.schema:
                raise ValueError("schema does not match the HostBatch's schema")
        elif isinstance(data, dict):
            batch = _batch_from_dict(data, schema)
        elif type(data).__module__.startswith("pyarrow"):
            batch = from_arrow(data, schema)
        else:
            raise TypeError(f"cannot create dataframe from {type(data)}")
        return DataFrame(self, L.LocalRelation(batch, batch.schema, num_partitions))

    createDataFrame = create_dataframe

    @property
    def read(self) -> "DataFrameReader":
        return DataFrameReader(self)

    def range(self, start: int, end: Optional[int] = None, step: int = 1,
              num_partitions: int = 1) -> "DataFrame":
        """``spark.range``: one ``id`` column of longs; on the device the ids
        are born there, with nothing uploaded."""
        if end is None:
            start, end = 0, start
        return DataFrame(self, L.Range(start, end, step, num_partitions))

    # ── execution ───────────────────────────────────────────────────────
    def _resolve_subqueries(self, lp: L.LogicalPlan, metrics=None, explain=None) -> L.LogicalPlan:
        """Execute every subquery plan through this session's engine and
        inline the results (Spark executes subqueries before the main query;
        reference GpuScalarSubquery.scala / GpuInSet.scala), the JAX
        session's ``_resolve_subqueries``:

            ScalarSubquery(plan) → Literal(value)
            InSubquery(c, plan)  → InSet(c, distinct values, NULL last)

        A subquery runs through the same engine and plan shape as the main
        query would, so a float it yields equals the main plan's to the bit
        (TPC-H q15 compares a sum with its max). Its counters (bytes
        uploaded, …) add to ``metrics`` and its plan's explain entries to
        ``explain``."""
        from .columnar.host import to_pylist
        from .expr.base import Literal
        from .expr.subquery import InSet, InSubquery, ScalarSubquery
        from .types import DateType, TimestampType

        def run(plan) -> HostBatch:
            # under a multi-process query every rank computes the WHOLE
            # subquery (a rank split would inline a partial aggregate)
            if self._mp_topology[0]:
                with self._single_process_scope():
                    tbl = self._execute(plan)
            else:
                tbl = self._execute(plan)
            if metrics is not None:
                metrics.update(self._last_metrics)
            if explain is not None:
                explain.extend(self._last_overrides.explain)
            return tbl

        def fix(e):
            if isinstance(e, ScalarSubquery):
                tbl = run(e.plan)
                if len(tbl.columns) != 1:
                    raise ValueError(
                        f"scalar subquery must return one column, got {len(tbl.columns)}"
                    )
                if tbl.num_rows > 1:
                    raise ValueError("scalar subquery returned more than one row")
                val = to_pylist(tbl.column(0))[0] if tbl.num_rows else None
                if val is not None and isinstance(e.data_type, (DateType, TimestampType)):
                    # date/timestamp literals store their physical ints
                    val = InSet._encode_values([val], e.data_type)[0]
                return Literal(val, e.data_type)
            if isinstance(e, InSubquery):
                tbl = run(e.plan)
                if len(tbl.columns) != 1:
                    raise ValueError(
                        f"IN-subquery must return one column, got {len(tbl.columns)}"
                    )
                seen: set = set()
                out = []
                has_null = False
                for x in to_pylist(tbl.column(0)):
                    if x is None:
                        has_null = True
                    elif x not in seen:
                        seen.add(x)
                        out.append(x)
                if has_null:
                    out.append(None)
                return InSet(e.c, tuple(out))
            return e

        return L.transform_expressions(lp, fix)

    def _translate_udfs(self, lp: L.LogicalPlan) -> L.LogicalPlan:
        """udf-compiler pass: rewrite translatable python UDFs into plain
        expression trees so they run on the device (reference
        udf-compiler/CatalystExpressionBuilder.scala; the subset is
        documented in expr/udf_compiler.py). Untranslatable UDFs keep their
        CPU fallback. The JAX session's ``_translate_udfs``."""
        from .expr.udf import PythonUdf
        from .expr.udf_compiler import try_translate

        def fix(e):
            if isinstance(e, PythonUdf):
                t = try_translate(e.fn, list(e.args), e.return_type)
                if t is not None:
                    return t
            return e

        return L.transform_expressions(lp, fix)

    def _resolve_cached(self, lp: L.LogicalPlan) -> L.LogicalPlan:
        """Materialize InMemoryRelation nodes: first touch executes the
        subtree and stores the result as PARQUET BYTES in memory (the
        ParquetCachedBatchSerializer analogue — compressed columnar cache,
        reference shims/spark311/ParquetCachedBatchSerializer.scala);
        later touches decode from the store."""
        import dataclasses as _dc

        if not isinstance(lp, L.LogicalPlan):
            return lp
        if isinstance(lp, L.InMemoryRelation):
            entry = self._cache_entry(lp)
            return L.LocalRelation(entry["table"], lp.schema, lp.num_partitions)
        kw = {}
        changed = False
        for f in _dc.fields(lp):
            v = getattr(lp, f.name)
            if isinstance(v, L.LogicalPlan):
                nv = self._resolve_cached(v)
            elif isinstance(v, list) and v and isinstance(v[0], L.LogicalPlan):
                nv = [self._resolve_cached(c) for c in v]
            else:
                nv = v
            kw[f.name] = nv
            if nv is not v:
                changed = True
        return _dc.replace(lp, **kw) if changed else lp

    def _cache_entry(self, lp: "L.InMemoryRelation") -> dict:
        """Materialize (or await) one InMemoryRelation's cache entry with
        SINGLE-FLIGHT semantics: the first toucher of a cold key executes
        the subtree; concurrent touchers of the same key block on its done
        event instead of re-executing the subtree or racing the dict. A
        failed materialization clears the key and raises only to the OWNER;
        waiters retry ownership themselves — the owner's failure may be its
        own cancellation or deadline, which must not poison another query.
        The store holds the port's SNAPPY Parquet bytes (the JAX session's
        holds ZSTD)."""
        import io

        from .io.parquet import read_table, write_table

        while True:
            with self._cache_lock:
                store = self._cache_store
                entry = store.get(lp.cache_key)
                owner = entry is None
                if owner:
                    entry = {
                        "bytes": None,
                        "table": None,
                        "error": None,
                        "done": threading.Event(),
                        "lock": threading.Lock(),
                    }
                    store[lp.cache_key] = entry
            if owner:
                try:
                    table = self._execute(lp.child)
                    buf = io.BytesIO()
                    write_table(table, buf, "snappy")
                    entry["bytes"] = buf.getvalue()
                except BaseException as e:
                    entry["error"] = e
                    with self._cache_lock:
                        if store.get(lp.cache_key) is entry:
                            del store[lp.cache_key]
                    raise
                finally:
                    entry["done"].set()
                break
            # this wait predates the waiter's own admission, so
            # session.cancel_all() reaches it through the scheduler's cancel
            # epoch instead
            from .sched import QueryCancelledError

            epoch = self._scheduler.cancel_epoch
            while not entry["done"].wait(0.05):
                if self._scheduler.cancel_epoch != epoch:
                    raise QueryCancelledError(
                        f"cancel_all while waiting on cache ({lp.cache_key}) materialization"
                    )
            if entry["error"] is None:
                break  # materialized: decode below
        with entry["lock"]:
            if entry["table"] is None:
                entry["table"] = read_table(entry["bytes"])
                # the decoded batch serves all later reads (and anchors the
                # device-upload cache); the compressed bytes are done
                entry["bytes"] = None
        return entry

    def uncache(self, key: int) -> None:
        with self._cache_lock:
            entry = self._cache_store.pop(key, None)
        if entry and entry.get("table") is not None:
            # also evict the device uploads anchored on the decoded batch —
            # unpersist() must actually free device memory
            tid = id(entry["table"])
            with self._h2d_lock:
                h2d = self._h2d_cache
                for k in [k for k in h2d if len(k) > 1 and k[1] == tid]:
                    h2d.pop(k, None)

    def _physical_plan(self, lp: L.LogicalPlan, metrics=None):
        """(device plan, overrides) of a logical plan: subquery resolution
        (its counters add to ``metrics``; the overrides' explain begins
        with the subqueries' entries), the ANSI rewrite, column pruning, CPU
        planning, the override pass, whole-stage fusion
        (``plan/fusion.py``, where the JAX session calls it) and exchange
        reuse (``plan/reuse.py``, ``spark.sql.exchange.reuse``)."""
        from .plan.fusion import fuse_stages

        import dataclasses as _dc

        from .expr.strings_ext import StringSplit

        sub_explain: list = []
        lp = self._resolve_cached(lp)
        lp = self._resolve_subqueries(lp, metrics, sub_explain)
        if cfg.UDF_COMPILER_ENABLED.get(self.conf):
            lp = self._translate_udfs(lp)
        # the device split's token-plane width is a conf (the JAX session
        # wires it in the same place)
        mt = cfg.SPLIT_MAX_TOKENS.get(self.conf)
        lp = L.transform_expressions(
            lp,
            lambda e: _dc.replace(e, max_tokens=mt)
            if isinstance(e, StringSplit) and e.max_tokens != mt
            else e,
        )
        if cfg.ANSI_ENABLED.get(self.conf):
            # Spark resolves ansiEnabled into Cast at analysis time
            import dataclasses as _dc

            from .expr.arithmetic import AnsiArithmetic
            from .expr.cast import Cast

            # casts as in the JAX package; integral + - * also raise on
            # overflow (Spark's failOnError arithmetic, which the JAX
            # package does not model)
            lp = L.transform_expressions(
                lp,
                lambda e: _dc.replace(e, ansi=True)
                if isinstance(e, (Cast, AnsiArithmetic)) and not e.ansi
                else e,
            )
        lp = prune_columns(lp)
        cpu_plan = plan_physical(lp, self.conf)
        overrides = GpuOverrides(self.conf, breaker=self._breaker)
        plan = overrides.apply(cpu_plan)
        overrides.explain[:0] = sub_explain
        plan, overrides.fused_stages = fuse_stages(plan, self.conf, breaker=self._breaker)
        # exchange reuse AFTER fusion (the JAX session's order): fusing
        # rewrites operator chains consistently across the plan, so identical
        # exchange subtrees still canonicalize identically, while fusing after
        # reuse would rewrite through physically shared nodes
        overrides.reused_exchanges = 0
        if cfg.EXCHANGE_REUSE_ENABLED.get(self.conf):
            from .plan.reuse import reuse_exchanges

            plan, overrides.reused_exchanges = reuse_exchanges(plan)
        return plan, overrides

    def _prepare_plan(self, lp: L.LogicalPlan, ctx: Optional[ExecContext] = None):
        """Analysis, planning, overrides and fusion: everything ``_execute``
        does before running the plan. With a ``ctx``, creates the query's
        phase ledger (``spark.rapids.tpu.ledger.enabled``, attached as
        ``ctx.ledger``) and bills this whole pass to its ``parse_plan``
        phase; with ``spark.rapids.sql.profile.opTime.enabled`` or the cost
        calibration on, wraps every node in the per-batch opTime wait
        (``profiling.instrument_plan``)."""
        from .obs import ledger as obs_ledger

        metrics = ctx.metrics if ctx is not None else None
        led = (
            obs_ledger.PhaseLedger()
            if ctx is not None and cfg.LEDGER_ENABLED.get(self.conf)
            else None
        )
        if led is not None:
            led.wall_start()
        try:
            with obs_ledger.ledger_scope(led), obs_ledger.phase("parse_plan"):
                final_plan, overrides = self._physical_plan(lp, metrics)
        finally:
            if led is not None:
                led.wall_stop()
        if ctx is not None:
            ctx.ledger = led
        self._last_overrides = overrides
        self._last_fused_stages = overrides.fused_stages
        self._last_reused_exchanges = overrides.reused_exchanges
        self._last_plan = final_plan
        self._assert_test_mode(overrides)
        if cfg.PROFILE_OPTIME.get(self.conf) or cfg.CBO_CALIBRATION_ENABLED.get(self.conf):
            from .profiling import instrument_plan

            instrument_plan(final_plan)
        return final_plan

    def _execute(self, lp: L.LogicalPlan, token=None) -> HostBatch:
        """Run a logical plan to one host batch, through admission, the
        ledger and the tracer (the JAX session's ``_execute``). ``token``
        (a ``sched.CancelToken``) replaces the cancel token admission mints
        — tests drive cancellation through it."""
        from .obs import ledger as obs_ledger
        from .obs import trace as obs_trace
        from .profiling import query_trace
        from .resilience import faults as _faults

        # chaos harness scope: injection points fire only while THIS
        # session's queries execute (no-op when faults are not enabled)
        with _faults.scoped(self._fault_injector):
            ctx = ExecContext(self.conf, self)
            final_plan = self._prepare_plan(lp, ctx)
            self._last_metrics = ctx.metrics
            seq = ctx.query_seq
            led = ctx.ledger
            tracer = self._maybe_tracer(seq)
            if tracer is not None:
                # the tracer is pinned into the wrappers: a straggling
                # producer thread keeps recording into ITS query's buffer
                obs_trace.instrument_plan(final_plan, tracer)
            if led is not None:
                led.wall_start()
            try:
                with obs_ledger.ledger_scope(led), obs_trace.query_scope(
                    tracer, f"query-{seq}", {"seq": seq}
                ):
                    # admission: estimate the device footprint, take a
                    # weighted permit share (queueing under the fair-share
                    # policy — the wait shows as a 'queued' span), install
                    # the cancel token, run; the context manager releases
                    # the permits on every exit path
                    with self._scheduler.admit(
                        f"q{seq}", final_plan, self.conf, tracer
                    ) as admission:
                        ctx.cancel_token = token if token is not None else admission.token
                        if led is not None:
                            led.add("queue_wait", admission.queue_wait_ns)
                        with query_trace(cfg.PROFILE_PATH.get(self.conf)):
                            return self._run_plan(final_plan, ctx)
            finally:
                if led is not None:
                    led.wall_stop()
                    self._last_ledger = led
                self._harvest_calibration(final_plan)
                if tracer is not None:
                    self._export_trace(tracer, final_plan, seq, ledger=led)

    def _maybe_tracer(self, seq: int):
        """The span tracer for this query when tracing is on AND this query
        is sampled, else None. Sampling is deterministic in the session's
        query sequence (spark.rapids.tpu.trace.sample)."""
        trace_dir = cfg.TRACE_DIR.get(self.conf)
        if not (cfg.TRACE_ENABLED.get(self.conf) or trace_dir):
            return None
        sample = cfg.TRACE_SAMPLE.get(self.conf)
        # Weyl-sequence hash of the seq → [0, 1): deterministic, well
        # spread even for consecutive seqs
        u = ((seq * 2654435761) & 0xFFFFFFFF) / 2**32
        if u >= sample:
            return None
        from .obs.trace import Tracer

        return Tracer(capacity=cfg.TRACE_BUFFER_SPANS.get(self.conf))

    def _export_trace(self, tracer, plan, seq: int, ledger=None) -> None:
        """Per-query artifacts (spark.rapids.tpu.trace.dir): the Chrome-
        trace/Perfetto span dump plus the metrics JSON. Export failures
        never fail the query."""
        self._last_tracer = tracer
        trace_dir = cfg.TRACE_DIR.get(self.conf)
        if not trace_dir:
            return
        import os

        from .obs import export as obs_export

        try:
            tracer.export_chrome(os.path.join(trace_dir, f"query-{seq}.trace.json"))
            obs_export.write_query_artifact(
                os.path.join(trace_dir, f"query-{seq}.metrics.json"),
                plan=plan,
                session=self,
                tracer=tracer,
                ledger=ledger,
            )
        except Exception:
            import logging

            logging.getLogger(__name__).warning(
                "trace export to %s failed", trace_dir, exc_info=True
            )

    def _harvest_calibration(self, final_plan) -> None:
        """Feed the measured per-op cost table at query exit
        (spark.rapids.tpu.cbo.calibration.enabled): opTime ÷ rows per node
        into the EWMA, persisted so later sessions plan on measured costs
        (obs/calibration.py). Never fails a query."""
        if not cfg.CBO_CALIBRATION_ENABLED.get(self.conf):
            return
        from .obs import calibration as obs_cal

        try:
            cal = obs_cal.get(cfg.CBO_CALIBRATION_FILE.get(self.conf))
            if cal.observe_plan(final_plan):
                cal.save()
        except Exception:
            import logging

            logging.getLogger(__name__).warning(
                "cost-calibration harvest failed", exc_info=True
            )

    def _run_plan(self, final_plan, ctx) -> HostBatch:
        """Every partition of a physical plan as a task (``_run_task``),
        committed in partition order into one host batch (billed to the
        ledger's ``serialize`` phase). With more than one partition and
        ``spark.rapids.sql.concurrentGpuTasks`` > 1 (re-read here, per
        query) the tasks run on that many threads, with straggler
        speculation when it is on, as in the JAX session's ``_run_plan``.
        The query's task re-executions land in ``ctx.metrics
        ["taskRetries"]`` and, once it ends, in ``_task_retries``."""
        from concurrent.futures import ThreadPoolExecutor

        from .obs import ledger as obs_ledger

        retry_lock = threading.Lock()

        def on_retry():
            with retry_lock:
                ctx.metrics["taskRetries"] += 1

        try:
            parts = final_plan.execute(ctx)
            attempts = cfg.TASK_MAX_FAILURES.get(self.conf)
            token = ctx.cancel_token
            n_threads = min(len(parts.parts), cfg.CONCURRENT_TPU_TASKS.get(self.conf))
            if n_threads > 1:
                spec = None
                if cfg.SPECULATION_ENABLED.get(self.conf) and token is not None:
                    from .sched.speculation import SpeculationMonitor

                    spec = SpeculationMonitor.from_conf(
                        self.conf, ctx=ctx, token=token,
                        pool=self._scheduler.pool, n_partitions=len(parts.parts),
                    )
                led = ctx.ledger

                def submit(i, t):
                    def run_attempt(tok):
                        from .exec import task as _task

                        _task.set_in_task_pool(True)
                        try:
                            return self._run_task(t, attempts, i, tok, ctx, on_retry, led)
                        finally:
                            _task.set_in_task_pool(False)

                    if spec is None:
                        return lambda: run_attempt(token)
                    return lambda: spec.run_partition(i, run_attempt)

                try:
                    with ThreadPoolExecutor(max_workers=n_threads,
                                            thread_name_prefix="srt-task") as pool:
                        futures = [pool.submit(submit(i, t)) for i, t in enumerate(parts.parts)]
                        results = [f.result() for f in futures]
                finally:
                    if spec is not None:
                        spec.close()
            else:
                results = [
                    self._run_task(t, attempts, i, token, ctx, on_retry, ctx.ledger)
                    for i, t in enumerate(parts.parts)
                ]
            with obs_ledger.scope_or_null(ctx.ledger, "serialize"):
                batches = [b for bs in results for b in bs if b.num_rows]
                return concat_batches(final_plan.output, batches)
        finally:
            self._task_retries = ctx.metrics["taskRetries"]
            # the exchanges' slices end with the query
            ctx.catalog.release("exchange")
            self._leak_check(ctx)

    def _run_task(self, thunk, attempts: int, partition_id: int = 0,
                  token=None, ctx=None, on_retry=None, ledger=None) -> List[HostBatch]:
        """One partition task with Spark's retry model (spark.task.maxFailures):
        the lineage IS the recovery mechanism — a partition thunk is a pure
        closure over its upstream pipeline, so a failed attempt simply
        re-runs it. Results commit only on success (a partial stream from a
        failed attempt is discarded). Deterministic errors surface at once:
        retrying an ANSI violation, an assertion, a cancelled query or a
        blown compile deadline can only fail again, and a sticky CUDA error
        leaves the device context unusable for every later attempt
        (``resilience/lineage.py::is_recoverable``). The JAX session's
        ``_run_task``: the straggler fault point fires at each attempt's
        start, a re-execution bills the ledger's ``recovery`` phase, and
        each adds one to the query's ``taskRetries`` (through
        ``on_retry``) and to ``task.reattempts``."""
        import traceback

        from .obs import trace as obs_trace
        from .resilience import faults as _faults
        from .resilience import lineage as _lineage

        desc = _lineage.TaskDescriptor(partition_id, query_id=getattr(token, "query_id", ""))
        last: Optional[Exception] = None
        for attempt in range(max(1, attempts)):
            desc.attempt = attempt
            try:
                with _lineage.attempt_scope(attempt):
                    # chaos straggler point: the configured partition's
                    # FIRST attempt crawls (token-beating sleep) — what the
                    # speculation monitor must overtake
                    _faults.on_task_attempt(partition_id, attempt, token)
                    if attempt == 0:
                        return self._drain(thunk, token, ledger)
                    with _lineage.recovery_scope(ledger):
                        return self._drain(thunk, token, ledger)
            except Exception as e:  # noqa: BLE001 - Spark retries any task failure
                if not _lineage.is_recoverable(e):
                    self._note_device_fault(e)
                    raise
                last = e
                if on_retry is not None:
                    on_retry()
                elif ctx is not None:
                    ctx.metrics["taskRetries"] += 1
                if attempt + 1 < attempts:
                    _lineage.record_reattempt(desc, e, tracer=obs_trace.active())
                    # the failed attempt's frames hold its device tensors:
                    # free them before the re-run (the traceback text stays)
                    traceback.clear_frames(e.__traceback__)
        assert last is not None
        raise last

    def _note_device_fault(self, e: BaseException) -> None:
        """A sticky CUDA error that surfaced outside any retry wrapper (a
        download's sync, say) still reaches the breaker, once, named by the
        innermost frame of the port it surfaced in — not pinned on an op
        (resilience/retry.py)."""
        import traceback

        from .resilience.retry import is_sticky_device_error

        if getattr(e, "device_fault_recorded", False) or not is_sticky_device_error(e):
            return
        frames = [f for f in traceback.extract_tb(e.__traceback__)
                  if "spark_rapids_tpu_torch" in f.filename]
        where = f"{frames[-1].name} ({frames[-1].lineno})" if frames else "task"
        self._breaker.record_device_fault(where, e)
        e.device_fault_recorded = True

    @staticmethod
    def _drain(thunk, token, ledger=None) -> List[HostBatch]:
        """One partition's result batches. The token becomes this thread's
        watchdog current (blocking regions beneath the pull label their
        stall phase on it; every check() is a beat) and the query's ledger
        rides the same install, so those regions attribute their time."""
        from .obs import ledger as obs_ledger
        from .resilience import watchdog as _wd

        prev_tok, prev_led = _wd.current(), obs_ledger.current()
        if token is not None:
            _wd.set_current(token)
        obs_ledger.set_current(ledger)
        try:
            out = []
            for b in thunk():
                if token is not None:
                    token.check()  # a beat per result batch
                out.append(b)
            return out
        finally:
            _wd.set_current(prev_tok)
            obs_ledger.set_current(prev_led)

    def _leak_check(self, ctx) -> None:
        """Debug mode: log the buffers still registered in the query's
        catalog (every operator should have closed its spillables)."""
        if ctx.catalog.debug:
            leaks = ctx.catalog.leak_report()
            if leaks:
                import logging

                logging.getLogger(__name__).warning(
                    "spillable-buffer LEAKS at query end (%d, %d bytes): %s",
                    len(leaks),
                    sum(l["size"] for l in leaks),
                    leaks[:10],
                )

    def _assert_test_mode(self, overrides: GpuOverrides) -> None:
        """TEST_CONF: fail when expected-on-device execs fell back
        (reference: GpuTransitionOverrides validation under TEST_CONF)."""
        if not cfg.TEST_CONF.get(self.conf):
            return
        allowed = (cfg.TEST_ALLOWED_NONTPU.get(self.conf) or "").split(",")
        allowed = {a.strip() for a in allowed if a.strip()}
        # file scans and writes decode and encode on the host by design
        # (io/files.py, io/writer.py)
        allowed |= {"CpuScan", "CpuFileScan", "DeviceToHost", "HostToDevice", "WriteFiles"}
        bad = []
        for e in overrides.explain:
            if e.on_device:
                continue
            name = e.node.split(" ")[0].split("[")[0]
            if not any(name.startswith(a) for a in allowed):
                bad.append((e.node, e.reasons))
        if bad:
            msg = "; ".join(f"{n}: {r}" for n, r in bad)
            raise AssertionError(f"execs unexpectedly not on device: {msg}")


def _extract_windows(
    exprs: List[Expression], plan: L.LogicalPlan
) -> tuple:
    """Pull WindowExpressions out of a projection into Window nodes below it
    (Spark's ExtractWindowExpressions): expressions sharing a
    (partition_by, order_by) spec land in one Window node; the projection
    references the appended columns. The JAX session's ``_extract_windows``."""
    from .expr.base import map_child_exprs
    from .expr.windows import WindowExpression, WindowOrder, WindowSpec, contains_window

    if not any(contains_window(e) for e in exprs):
        return exprs, plan

    groups: dict = {}  # (partition_by, order_by) -> list[(name, wexpr)]
    counter = [0]
    child_schema = plan.schema

    def pull(e: Expression) -> Expression:
        if isinstance(e, WindowExpression):
            # resolve against the child schema now: the Window node's own
            # schema needs the function's type before planning
            spec = WindowSpec(
                tuple(bind(p, child_schema) for p in e.spec.partition_by),
                tuple(
                    WindowOrder(bind(o.child, child_schema), o.ascending, o.nulls_first)
                    for o in e.spec.order_by
                ),
                e.spec.frame,
            )
            e = WindowExpression(bind(e.function, child_schema), spec)
            key = (spec.partition_by, spec.order_by)
            name = f"__w{counter[0]}"
            counter[0] += 1
            groups.setdefault(key, []).append((name, e))
            return UnresolvedAttribute(name)
        if not e.children():
            return e
        return map_child_exprs(e, pull)

    new_exprs = [pull(e) for e in exprs]
    for cols in groups.values():
        plan = L.Window(cols, plan)
    return new_exprs, plan


def _batch_from_dict(data: dict, schema: Optional[Schema]) -> HostBatch:
    from .types import BOOLEAN, DOUBLE, FLOAT, INT, LONG, STRING, BYTE, SHORT

    by_dtype = {
        np.dtype(np.bool_): BOOLEAN,
        np.dtype(np.int8): BYTE,
        np.dtype(np.int16): SHORT,
        np.dtype(np.int32): INT,
        np.dtype(np.int64): LONG,
        np.dtype(np.float32): FLOAT,
        np.dtype(np.float64): DOUBLE,
    }
    fields, cols = [], []
    for i, (name, values) in enumerate(data.items()):
        if isinstance(values, HostColumn):
            fields.append(StructField(name, values.dtype))
            cols.append(values)
            continue
        dt = schema[i].data_type if schema is not None else None
        if dt is None and not isinstance(values, np.ndarray):
            dt = _nested_type_of(values)
        if dt is not None and is_complex(dt):
            cols.append(column_from_pylist(values, dt))
            fields.append(StructField(name, dt))
            continue
        arr = np.asarray(values) if not isinstance(values, np.ndarray) else values
        if dt is None:
            if arr.dtype.kind == "U" or (
                arr.dtype == object and all(v is None or isinstance(v, str) for v in values)
            ):
                dt = STRING
            elif arr.dtype in by_dtype:
                dt = by_dtype[arr.dtype]
            else:
                raise TypeError(f"column {name!r}: no SQL type for numpy {arr.dtype}")
        if isinstance(dt, StringType):
            cols.append(string_column(list(values), dt))
        else:
            data_np = np.ascontiguousarray(arr, dtype=dt.np_dtype)
            cols.append(HostColumn(dt, data_np, np.ones(len(data_np), dtype=bool)))
        fields.append(StructField(name, dt))
    n = len(cols[0]) if cols else 0
    if any(len(c) != n for c in cols):
        raise ValueError("columns of different lengths")
    return HostBatch(schema or Schema(fields), cols, n)


def _nested_type_of(values):
    """The nested type of a Python column (lists → array, dicts → map from
    their first non-empty values; None for anything else). A struct needs
    the schema."""
    from .types import BOOLEAN, DOUBLE, LONG, STRING, ArrayType, MapType

    def scalar(v):
        for t, dt in ((bool, BOOLEAN), (int, LONG), (float, DOUBLE), (str, STRING)):
            if isinstance(v, t):
                return dt
        raise TypeError(f"no SQL type inferred for {type(v).__name__} values; pass a schema")

    def first(xs):
        return next((x for x in xs if x is not None), None)

    v = first(values)
    if isinstance(v, list):
        e = first(x for row in values if row for x in row)
        return ArrayType(scalar(e) if e is not None else STRING)
    if isinstance(v, dict):
        items = [kv for row in values if row for kv in row.items()]
        k, x = first(k for k, _ in items), first(x for _, x in items)
        return MapType(scalar(k) if k is not None else STRING,
                       scalar(x) if x is not None else STRING)
    if isinstance(v, tuple):
        raise TypeError("a column of tuples is a struct: pass a schema naming its fields")
    return None


class DataFrameReader:
    """``session.read``: Parquet and CSV files (and directories and globs
    of them) as DataFrames; ``orc`` raises, naming ROADMAP item 10b."""

    def __init__(self, session: TorchSession):
        self._session = session
        self._options: dict = {}

    def option(self, k: str, v) -> "DataFrameReader":
        self._options[k] = v
        return self

    def _rewrite(self, paths) -> tuple:
        """spark.rapids.alluxio.pathsToReplace: 'src->dst' prefix rewrites
        applied before file listing (RapidsConf.scala:929 — route cloud
        reads through a cache mount)."""
        raw = cfg.ALLUXIO_PATHS_TO_REPLACE.get(self._session.conf)
        if not raw:
            return tuple(paths)
        rules = []
        for part in raw.split(","):
            if "->" in part:
                src, dst = part.split("->", 1)
                rules.append((src.strip(), dst.strip()))
        out = []
        for p in paths:
            for src, dst in rules:
                if p.startswith(src):
                    p = dst + p[len(src):]
                    break
            out.append(p)
        return tuple(out)

    def _bucket_options(self, paths) -> dict:
        """Attach the _bucket_spec.json sidecar (one consistent spec across
        all roots) so the scan can bucket-prune (io/bucketing.py)."""
        import os

        from .io.bucketing import read_spec

        opts = dict(self._options)
        dirs = [p for p in paths if os.path.isdir(p)]
        specs = [s for s in (read_spec(p) for p in dirs) if s is not None]
        if specs and all(s == specs[0] for s in specs) and len(specs) == len(dirs):
            opts["__bucket_spec"] = specs[0]
        return self._root_options(paths, opts)

    @staticmethod
    def _root_options(roots, opts: dict) -> dict:
        """Record the scan ROOTS (not just the expanded files) on the scan
        node, as the JAX session does for its result cache's keys."""
        import os

        opts["__roots"] = tuple(os.path.realpath(r) for r in roots)
        return opts

    def parquet(self, *paths: str) -> "DataFrame":
        from .io.files import expand_paths, infer_schema

        roots = self._rewrite(paths)
        files = expand_paths(roots, "parquet")
        schema = infer_schema(files, "parquet", self._options)
        return DataFrame(self._session,
                         L.FileScan(files, "parquet", schema, self._bucket_options(roots)))

    def csv(self, *paths: str, **kwargs) -> "DataFrame":
        from .io.files import expand_paths, infer_schema

        opts = dict(self._options)
        opts.update(kwargs)
        # shim-routed default (SparkShims seam): what string reads as NULL
        opts.setdefault("nullValue", self._session.shim.csv_null_value())
        roots = self._rewrite(paths)
        files = expand_paths(roots, "csv")
        schema = infer_schema(files, "csv", opts)
        return DataFrame(self._session,
                         L.FileScan(files, "csv", schema, self._root_options(roots, opts)))

    def orc(self, *paths: str) -> "DataFrame":
        from .io.files import orc_not_ported

        raise orc_not_ported("read.orc")


def _to_exprs(cols: Sequence[Union[str, Column, Expression]]) -> List[Expression]:
    out = []
    for c in cols:
        if isinstance(c, str):
            out.append(UnresolvedAttribute(c))
        elif isinstance(c, Column):
            out.append(c.expr)
        else:
            out.append(c)
    return out


#: every ``how`` spelling ``DataFrame.join`` takes, to the join type
_JOIN_TYPES = {
    "inner": "inner",
    "left": "left",
    "left_outer": "left",
    "leftouter": "left",
    "right": "right",
    "right_outer": "right",
    "rightouter": "right",
    "outer": "full",
    "full": "full",
    "full_outer": "full",
    "cross": "cross",
    "semi": "left_semi",
    "left_semi": "left_semi",
    "leftsemi": "left_semi",
    "anti": "left_anti",
    "left_anti": "left_anti",
    "leftanti": "left_anti",
}


class DataFrame:
    def __init__(self, session: TorchSession, plan: L.LogicalPlan):
        self._session = session
        self._plan = plan

    @property
    def schema(self) -> Schema:
        return self._plan.schema

    @property
    def columns(self) -> List[str]:
        return self.schema.names

    # ── transformations ─────────────────────────────────────────────────
    def select(self, *cols) -> "DataFrame":
        exprs, plan = _extract_windows(_to_exprs(cols), self._plan)
        exprs, plan = _extract_generators(exprs, plan)
        return DataFrame(self._session, L.Project(exprs, plan))

    def map_in_pandas(self, fn, schema) -> "DataFrame":
        """``fn(iterator of pd.DataFrame) -> iterator of pd.DataFrame`` per
        partition (pyspark mapInPandas; reference GpuMapInPandasExec).
        ``schema`` declares the result columns. Runs on the host, over
        pandas."""
        return DataFrame(self._session, L.MapInPandas(fn, _to_schema(schema), self._plan))

    mapInPandas = map_in_pandas

    def filter(self, condition: Union[Column, Expression]) -> "DataFrame":
        e = condition.expr if isinstance(condition, Column) else condition
        return DataFrame(self._session, L.Filter(e, self._plan))

    where = filter

    def group_by(self, *cols) -> "GroupedData":
        return GroupedData(self, _to_exprs(cols))

    groupBy = group_by

    def rollup(self, *cols) -> "GroupedData":
        """ROLLUP grouping sets: (all), (all-1), …, ()."""
        exprs = _to_exprs(cols)
        sets = [list(range(k)) for k in range(len(exprs), -1, -1)]
        return GroupedData(self, exprs, grouping_sets=sets)

    def cube(self, *cols) -> "GroupedData":
        """CUBE grouping sets: every subset of the grouping columns."""
        exprs = _to_exprs(cols)
        n = len(exprs)
        sets = [
            [i for i in range(n) if mask & (1 << i)] for mask in range(2**n - 1, -1, -1)
        ]
        return GroupedData(self, exprs, grouping_sets=sets)

    def agg(self, *aggs) -> "DataFrame":
        return GroupedData(self, []).agg(*aggs)

    def sort(self, *cols, ascending: Union[bool, List[bool]] = True) -> "DataFrame":
        orders = self._sort_orders(cols, ascending)
        return DataFrame(self._session, L.Sort(orders, True, self._plan))

    orderBy = sort
    order_by = sort

    def sort_within_partitions(self, *cols, ascending=True) -> "DataFrame":
        """Sort each partition on its own (no range exchange)."""
        orders = self._sort_orders(cols, ascending)
        return DataFrame(self._session, L.Sort(orders, False, self._plan))

    def _sort_orders(self, cols, ascending) -> List[L.SortOrder]:
        exprs = _to_exprs(cols)
        if isinstance(ascending, bool):
            ascending = [ascending] * len(exprs)
        # Column.desc()/asc() markers override the ascending kwarg
        ascending = [
            False if (isinstance(c, Column) and getattr(c, "_sort_desc", False)) else a
            for c, a in zip(cols, ascending)
        ]
        return [L.SortOrder(e, a) for e, a in zip(exprs, ascending)]

    def limit(self, n: int) -> "DataFrame":
        return DataFrame(self._session, L.Limit(n, self._plan))

    def union(self, other: "DataFrame") -> "DataFrame":
        return DataFrame(self._session, L.Union([self._plan, other._plan]))

    unionAll = union

    def repartition(self, n: int, *cols) -> "DataFrame":
        exprs = _to_exprs(cols) if cols else None
        return DataFrame(self._session, L.Repartition(n, exprs, self._plan))

    def with_column(self, name: str, c: Column) -> "DataFrame":
        exprs: List[Expression] = []
        replaced = False
        for f in self.schema:
            if f.name == name:
                exprs.append(Alias(c.expr, name))
                replaced = True
            else:
                exprs.append(UnresolvedAttribute(f.name))
        if not replaced:
            exprs.append(Alias(c.expr, name))
        exprs, plan = _extract_windows(exprs, self._plan)
        return DataFrame(self._session, L.Project(exprs, plan))

    withColumn = with_column

    def with_column_renamed(self, existing: str, new: str) -> "DataFrame":
        """Rename one column; no-op when absent (pyspark semantics)."""
        if existing not in self.schema.names:
            return self
        exprs = [
            Alias(UnresolvedAttribute(n), new) if n == existing else UnresolvedAttribute(n)
            for n in self.schema.names
        ]
        return self.select(*exprs)

    withColumnRenamed = with_column_renamed

    def fillna(self, value, subset: Optional[List[str]] = None) -> "DataFrame":
        """Replace nulls with ``value`` in type-compatible columns
        (pyspark DataFrameNaFunctions.fill: numeric values fill numeric
        columns, strings fill strings, bools fill bools)."""
        from .expr.base import Literal
        from .expr.conditional import Coalesce
        from .types import BooleanType, FractionalType, IntegralType, NumericType

        if isinstance(value, dict):
            # pyspark's per-column form: {'a': 0, 'b': 'x'}; subset is
            # documented as IGNORED for dict values
            per_col = dict(value)
            subset = None
        elif isinstance(value, (bool, int, float, str)):
            per_col = None
        else:
            raise TypeError(
                f"fillna value must be bool/int/float/str/dict, got {type(value)}"
            )

        def compatible(v, dt) -> bool:
            return (
                (isinstance(v, bool) and isinstance(dt, BooleanType))
                or (
                    isinstance(v, (int, float))
                    and not isinstance(v, bool)
                    and isinstance(dt, NumericType)
                )
                or (isinstance(v, str) and isinstance(dt, StringType))
            )

        names = set(subset) if subset is not None else None
        exprs: List[Expression] = []
        for f in self.schema:
            dt = f.data_type
            if per_col is not None:
                v = per_col.get(f.name)
                applies = v is not None and compatible(v, dt)
            else:
                v = value
                applies = (names is None or f.name in names) and compatible(v, dt)
            if applies:
                if isinstance(dt, FractionalType):
                    v = float(v)
                elif isinstance(dt, IntegralType) and not isinstance(v, bool):
                    v = int(v)
                exprs.append(
                    Alias(Coalesce((UnresolvedAttribute(f.name), Literal(v, dt))), f.name)
                )
            else:
                exprs.append(UnresolvedAttribute(f.name))
        return self.select(*exprs)

    def dropna(
        self,
        how: str = "any",
        thresh: Optional[int] = None,
        subset: Optional[List[str]] = None,
    ) -> "DataFrame":
        """Drop rows with nulls (pyspark DataFrameNaFunctions.drop):
        ``how='any'`` drops rows with any null among the subset,
        ``'all'`` only all-null rows; ``thresh`` keeps rows with at least
        that many non-nulls."""
        from .expr.base import Literal
        from .expr.conditional import If
        from .types import INT

        if how not in ("any", "all"):
            raise ValueError(f"how must be 'any' or 'all', got {how!r}")
        names = subset if subset is not None else list(self.schema.names)
        if not names:
            return self
        non_null_count: Optional[Expression] = None
        for n in names:
            one = If(_e(col(n).is_not_null()), Literal(1, INT), Literal(0, INT))
            non_null_count = (
                one
                if non_null_count is None
                else _e(Column(non_null_count) + Column(one))
            )
        if thresh is None:
            thresh = len(names) if how == "any" else 1
        return self.filter(Column(non_null_count) >= thresh)

    def sample(self, *args, **kwargs) -> "DataFrame":
        """Bernoulli sample. Accepts pyspark's signatures:
        ``sample(fraction, seed=0)`` or
        ``sample(withReplacement, fraction, seed)`` (replacement must be
        falsy — with-replacement sampling is not implemented). The filter
        over ``rand(seed)`` runs on the CPU engine unless
        ``spark.rapids.sql.incompatibleOps.enabled`` (the JAX package's
        gate)."""
        from .functions import rand as rand_fn

        a = list(args)
        with_replacement = kwargs.pop("withReplacement", None)
        if a and isinstance(a[0], bool):
            with_replacement = a.pop(0)
        if with_replacement:
            raise NotImplementedError("sample(withReplacement=True) is not supported")
        fraction = kwargs.get("fraction", a[0] if a else None)
        if fraction is None:
            raise TypeError("sample() requires a fraction")
        seed = kwargs.get("seed", a[1] if len(a) > 1 else 0)
        return self.filter(rand_fn(int(seed)) < float(fraction))

    def join(
        self,
        other: "DataFrame",
        on: Union[str, List, Column, None] = None,
        how: str = "inner",
    ) -> "DataFrame":
        """``on``: a column name or a list of names (a USING join: the right
        key columns leave the output), a list of ``(left, right)`` name
        pairs, or a Column condition (split into equi keys and a residual)."""
        how = _JOIN_TYPES[how]
        lk: List[Expression] = []
        rk: List[Expression] = []
        using = False
        residual = None
        if on is None:
            pass
        elif isinstance(on, str):
            lk, rk, using = [UnresolvedAttribute(on)], [UnresolvedAttribute(on)], True
        elif isinstance(on, list) and on and isinstance(on[0], str):
            lk = [UnresolvedAttribute(n) for n in on]
            rk = [UnresolvedAttribute(n) for n in on]
            using = True
        elif isinstance(on, list) and on and isinstance(on[0], tuple):
            lk = [UnresolvedAttribute(l) for l, _ in on]
            rk = [UnresolvedAttribute(r) for _, r in on]
        elif isinstance(on, Column):
            lk, rk, residual = extract_equi_join_keys(on.expr, self.schema, other.schema)
        else:
            raise TypeError(
                "join on= must be a name, list of names, list of (l, r) pairs, "
                "or a Column condition"
            )
        return DataFrame(
            self._session,
            L.Join(self._plan, other._plan, how, lk, rk, residual, using),
        )

    def cross_join(self, other: "DataFrame") -> "DataFrame":
        return DataFrame(
            self._session,
            L.Join(self._plan, other._plan, "cross", [], [], None, False),
        )

    def distinct(self) -> "DataFrame":
        """Spark plans Distinct as Aggregate(all columns); so does this."""
        cols = [UnresolvedAttribute(n) for n in self.schema.names]
        return DataFrame(self._session, L.Aggregate(cols, list(cols), self._plan))

    def drop(self, *cols: str) -> "DataFrame":
        """Project out the named columns (pyspark: unknown names ignored)."""
        gone = set(cols)
        return self.select(*[n for n in self.schema.names if n not in gone])

    def _set_op(self, other: "DataFrame", keep_matched: bool) -> "DataFrame":
        """Null-safe INTERSECT/EXCEPT: tag each side, union, group by all
        columns (GROUP BY treats nulls as equal: Spark's set-op null
        semantics), then filter on side presence."""
        from .functions import col, lit
        from .functions import max as max_fn

        names = list(self.schema.names)
        left = self.with_column("__side_l", lit(1)).with_column("__side_r", lit(0))
        right = other.with_column("__side_l", lit(0)).with_column("__side_r", lit(1))
        grouped = (
            left.union(right)
            .group_by(*names)
            .agg(
                max_fn(col("__side_l")).alias("__hl"),
                max_fn(col("__side_r")).alias("__hr"),
            )
        )
        cond = (col("__hl") == 1) & (
            (col("__hr") == 1) if keep_matched else (col("__hr") == 0)
        )
        return grouped.filter(cond).select(*names)

    def intersect(self, other: "DataFrame") -> "DataFrame":
        """Distinct rows present in both frames (Spark INTERSECT, null-safe)."""
        return self._set_op(other, keep_matched=True)

    def subtract(self, other: "DataFrame") -> "DataFrame":
        """Distinct rows of this frame absent from the other (Spark EXCEPT,
        null-safe)."""
        return self._set_op(other, keep_matched=False)

    def drop_duplicates(self, subset: Optional[List[str]] = None) -> "DataFrame":
        if subset is None:
            return self.distinct()
        from .functions import col
        from .functions import first as first_fn

        keys = [UnresolvedAttribute(n) for n in subset]
        keep = set(subset)
        # output keeps the original column order (pyspark semantics)
        aggs: List[Expression] = []
        for f in self.schema:
            if f.name in keep:
                aggs.append(UnresolvedAttribute(f.name))
            else:
                aggs.append(Alias(first_fn(col(f.name)).expr, f.name))
        return DataFrame(self._session, L.Aggregate(keys, aggs, self._plan))

    dropDuplicates = drop_duplicates

    def create_or_replace_temp_view(self, name: str) -> None:
        self._session.create_or_replace_temp_view(name, self)

    createOrReplaceTempView = create_or_replace_temp_view

    def cache(self) -> "DataFrame":
        """Materialize this DataFrame's result on first use and serve later
        uses from a Parquet-compressed in-memory store (the
        ParquetCachedBatchSerializer analogue)."""
        import itertools

        counter = self._session.__dict__.setdefault("_cache_ids", itertools.count(1))
        key = next(counter)

        def parts_of(p) -> int:
            own = getattr(p, "num_partitions", 0)
            kids = [parts_of(c) for c in p.children()]
            return max([own] + kids + [1])

        return DataFrame(self._session, L.InMemoryRelation(self._plan, key, parts_of(self._plan)))

    persist = cache

    def unpersist(self) -> "DataFrame":
        if isinstance(self._plan, L.InMemoryRelation):
            self._session.uncache(self._plan.cache_key)
            return DataFrame(self._session, self._plan.child)
        return self

    @property
    def write(self):
        from .io.writer import DataFrameWriter

        return DataFrameWriter(self)

    # ── actions ─────────────────────────────────────────────────────────
    def to_host(self) -> HostBatch:
        """The result as one ``HostBatch`` (through admission, like every
        action)."""
        return self._session._execute(self._plan)

    def collect(self) -> List[tuple]:
        return batch_rows(self.to_host())

    def count(self) -> int:
        """The row count, from one aggregate query (through ``collect``:
        the card's machine has no pyarrow)."""
        from .functions import count as count_fn

        return self.agg(count_fn("*").alias("count")).collect()[0][0]

    def head(self, n: Optional[int] = None):
        """pyspark: head() → first row or None; head(n) → list of rows
        (including head(1) → one-element list)."""
        if n is None:
            rows = self.limit(1).collect()
            return rows[0] if rows else None
        return self.limit(n).collect()

    def first(self):
        """pyspark: first() == head() — a single row, or None when empty."""
        return self.head()

    def take(self, n: int) -> List[tuple]:
        return self.limit(n).collect()

    def show(self, n: int = 20, truncate: bool = True) -> None:
        """Print the first ``n`` rows in pyspark's grid format (the JAX
        session's ``show``, character for character)."""
        rows = self.limit(n).collect()
        names = list(self.schema.names)

        def fmt(v):
            s = "null" if v is None else str(v)
            return s[:17] + "..." if truncate and len(s) > 20 else s

        table = [[fmt(v) for v in r] for r in rows]
        widths = [
            max(len(names[i]), *(len(r[i]) for r in table)) if table else len(names[i])
            for i in range(len(names))
        ]
        sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
        print(sep)
        print("|" + "|".join(f" {names[i]:<{widths[i]}} " for i in range(len(names))) + "|")
        print(sep)
        for r in table:
            print("|" + "|".join(f" {r[i]:<{widths[i]}} " for i in range(len(names))) + "|")
        print(sep)

    def to_arrow(self):
        """The result as a ``pyarrow.Table`` (pyarrow is imported here, and
        only here: without it this raises ``ImportError``)."""
        from .columnar.host import to_arrow

        return to_arrow(self.to_host())

    def to_pandas(self):
        """The result as a ``pandas.DataFrame`` (through ``to_arrow``; raises
        ``ImportError`` naming the package that is missing)."""
        try:
            import pandas  # noqa: F401
        except ImportError as e:
            raise ImportError("to_pandas() needs the pandas package, which is not installed") from e
        return self.to_arrow().to_pandas()

    toPandas = to_pandas

    def to_torch(self):
        """Zero-copy device export: run the query and hand out the LIVE
        device-resident result as one ``DeviceBatch`` of torch tensors
        (per-column ``data``/``validity``/``lengths``), with no host round
        trip — the analogue of the JAX package's ``DataFrame.to_jax``. Any
        DLPack consumer takes the columns without a copy
        (``torch.utils.dlpack.to_dlpack(batch.columns[i].data)``).

        The batch is padded to capacity: rows ``[0, num_rows)`` are live
        (``num_rows`` is a device scalar — ``row_count()`` syncs it);
        padding rows have ``validity == False``. It rides the same
        admission, cancel token and task retry model as ``collect()``."""
        from .columnar.device import empty_batch
        from .exec.gpu import DeviceToHostExec
        from .ops.gather import bulk_shrink

        session = self._session
        ctx = ExecContext(session.conf, session)
        final_plan = session._prepare_plan(self._plan, ctx)
        if not isinstance(final_plan, DeviceToHostExec):
            raise ValueError(
                "to_torch(): plan does not end on the device (fell back to "
                "the CPU engine?) — use to_host() instead"
            )
        plan = final_plan.children[0]
        try:
            with session._scheduler.admit(
                f"q{ctx.query_seq}", final_plan, session.conf
            ) as admission:
                ctx.cancel_token = admission.token
                parts = plan.execute(ctx)
                attempts = cfg.TASK_MAX_FAILURES.get(session.conf)
                batches = [
                    db
                    for i, t in enumerate(parts.parts)
                    for db in session._run_task(t, attempts, i, admission.token, ctx)
                ]
                ctx.semaphore.release_if_necessary()
            session._task_retries = ctx.metrics["taskRetries"]
            batches = [b for b in bulk_shrink(batches)[0] if b.capacity]
            if not batches:
                return empty_batch(plan.output, session.device)
            if len(batches) == 1:
                return batches[0]
            from .ops.concat import concat_device

            return concat_device(batches)
        finally:
            ctx.catalog.release("exchange")
            session._leak_check(ctx)

    def explain(self, mode: str = "plans") -> str:
        """The device plan (``*`` marks device nodes); ``mode="metrics"``
        renders the LAST executed plan with each node's collected metrics
        inline, headed by its phase ledger — where the last query's wall
        clock went (collect() first)."""
        if mode == "metrics":
            from .obs.export import render_ledger, render_plan_metrics

            plan = self._session._last_plan
            if plan is None:
                s = "<no query executed yet — collect() first>"
            else:
                s = render_plan_metrics(plan)
                led = render_ledger(self._session._last_ledger)
                if led:
                    s = led + "\n" + s
            print(s)
            return s
        s = self._session._physical_plan(self._plan)[0].tree_string()
        print(s)
        return s


#: the grouping-id column of a rollup/cube aggregate's Expand
GROUPING_ID = "__grouping_id"


class GroupedData:
    def __init__(
        self,
        df: DataFrame,
        grouping: List[Expression],
        grouping_sets: Optional[List[List[int]]] = None,
        pivot: Optional[tuple] = None,
    ):
        self._df = df
        self._grouping = grouping
        self._grouping_sets = grouping_sets
        self._pivot = pivot

    def pivot(self, pivot_col: str, values: Optional[list] = None) -> "GroupedData":
        """Pivot on ``pivot_col`` — Catalyst's RewritePivot shape: each
        (value, aggregate) pair becomes ``agg(if(p <=> value, x, null))``
        (reference analogue: GpuPivotFirst); ``count`` yields null for
        absent (group, value) combinations like Spark's DataFrame pivot.
        When ``values`` is omitted they are collected eagerly from the data
        (sorted, like Spark's auto-detection)."""
        if self._grouping_sets is not None:
            raise ValueError("pivot is only supported after a groupBy")
        if values is None:
            key = UnresolvedAttribute(pivot_col)
            vals_df = DataFrame(self._df._session, L.Aggregate([key], [key], self._df._plan))
            collected = [v for (v,) in vals_df.collect()]
            non_null = sorted(v for v in collected if v is not None)
            values = non_null + ([None] if None in collected else [])
        return GroupedData(self._df, self._grouping, pivot=(pivot_col, values))

    def _expand_pivot(self, agg_exprs: List[Expression]) -> List[Expression]:
        import dataclasses as _dc

        from .expr.aggregates import AggregateFunction, Count
        from .expr.base import Literal, map_child_exprs, to_expr
        from .expr.conditional import If
        from .expr.predicates import EqualNullSafe, GreaterThan
        from .types import NULL

        pcol, values = self._pivot

        def wrap(e: Expression, v) -> Expression:
            if isinstance(e, AggregateFunction):
                cond = EqualNullSafe(UnresolvedAttribute(pcol), to_expr(v))
                guarded = If(cond, e.child, Literal(None, NULL))
                agg = _dc.replace(e, child=guarded)
                if isinstance(e, Count):
                    # Spark's DataFrame pivot (PivotFirst / GpuPivotFirst)
                    # yields NULL, not 0, when no input row matched the
                    # pivot value; gate the count on a matched-row count
                    matched = _dc.replace(e, child=If(cond, to_expr(1), Literal(None, NULL)))
                    return If(GreaterThan(matched, to_expr(0)), agg, Literal(None, NULL))
                return agg
            if not e.children():
                return e
            return map_child_exprs(e, lambda c: wrap(c, v))

        out: List[Expression] = []
        multiple = len(agg_exprs) > 1
        for v in values:
            for a in agg_exprs:
                base = str(v) if v is not None else "null"
                name = f"{base}_{output_name(a)}" if multiple else base
                target = a.child if isinstance(a, Alias) else a
                out.append(Alias(wrap(target, v), name))
        return out

    def apply_in_pandas(self, fn, schema) -> DataFrame:
        """``fn(pd.DataFrame) -> pd.DataFrame`` once per key group (pyspark
        applyInPandas; reference GpuFlatMapGroupsInPandasExec). Grouping
        must be plain columns; ``schema`` declares the result columns."""
        names = self._plain_key_names("apply_in_pandas")
        return DataFrame(
            self._df._session,
            L.FlatMapGroupsInPandas(names, fn, _to_schema(schema), self._df._plan),
        )

    applyInPandas = apply_in_pandas

    def cogroup(self, other: "GroupedData") -> "CoGroupedData":
        """Pair this grouped frame with another for
        ``cogroup(...).apply_in_pandas(fn, schema)`` (pyspark cogroup;
        reference GpuFlatMapCoGroupsInPandasExec)."""
        if not isinstance(other, GroupedData):
            raise TypeError("cogroup expects another groupBy()")
        return CoGroupedData(self, other)

    def _plain_key_names(self, what: str) -> List[str]:
        if self._grouping_sets is not None or self._pivot is not None:
            raise ValueError(f"{what} requires a plain groupBy")
        names = []
        for g in self._grouping:
            if not isinstance(g, UnresolvedAttribute):
                raise ValueError(f"{what} grouping must be plain columns")
            names.append(g.name)
        return names

    def _agg_in_pandas(self, agg_exprs: List[Expression]) -> DataFrame:
        """GROUPED_AGG pandas UDF route: pre-project key + argument columns,
        then AggregateInPandas evaluates one scalar per (group, udf)."""
        from .expr.udf import GroupedAggUdf

        keys = self._plain_key_names("grouped-agg pandas UDFs")
        proj: List[Expression] = [UnresolvedAttribute(n) for n in keys]
        udfs = []
        child_schema = self._df.schema
        out_fields = [StructField(n, child_schema[n].data_type, True) for n in keys]
        for i, a in enumerate(agg_exprs):
            target = a.child if isinstance(a, Alias) else a
            if not isinstance(target, GroupedAggUdf):
                raise ValueError(
                    "grouped-agg pandas UDFs cannot be mixed with other "
                    f"aggregates in one agg() (got {a})"
                )
            arg_names = []
            for j, arg in enumerate(target.args):
                nm = f"__pagg_arg{i}_{j}"
                proj.append(Alias(arg, nm))
                arg_names.append(nm)
            out_name = output_name(a)
            udfs.append((out_name, target.fn, target.return_type, arg_names))
            out_fields.append(StructField(out_name, target.return_type, True))
        projected = L.Project(proj, self._df._plan)
        return DataFrame(
            self._df._session,
            L.AggregateInPandas(keys, udfs, Schema(out_fields), projected),
        )

    def agg(self, *aggs) -> DataFrame:
        from .expr.udf import GroupedAggUdf

        agg_exprs = [a.expr if isinstance(a, Column) else a for a in aggs]

        def has_grouped_agg(e) -> bool:
            stack = [e]
            while stack:
                x = stack.pop()
                if isinstance(x, GroupedAggUdf):
                    return True
                stack.extend(x.children())
            return False

        if any(has_grouped_agg(a) for a in agg_exprs):
            return self._agg_in_pandas(agg_exprs)
        if self._pivot is not None:
            agg_exprs = self._expand_pivot(agg_exprs)
        if self._grouping_sets is not None:
            return self._agg_grouping_sets(agg_exprs)
        # Spark: group-by output = grouping columns ++ aggregates
        all_out = list(self._grouping) + agg_exprs
        return DataFrame(
            self._df._session, L.Aggregate(self._grouping, all_out, self._df._plan)
        )

    def _agg_grouping_sets(self, agg_exprs: List[Expression]) -> DataFrame:
        """rollup/cube: Expand fans each row out once per grouping set with
        non-member keys nulled and a grouping-id column, then a plain
        aggregate groups on [keys…, grouping_id] (Spark's
        ResolveGroupingAnalytics → Expand plan; the JAX session's
        ``_agg_grouping_sets``)."""
        from .expr import Literal
        from .types import INT

        child_schema = self._df.schema
        n_keys = len(self._grouping)
        names = list(child_schema.names)
        key_names = [f"__key{i}" for i in range(n_keys)]
        out_names = names + key_names + [GROUPING_ID]
        projections: List[List[Expression]] = []
        for s in self._grouping_sets:
            proj: List[Expression] = [UnresolvedAttribute(nm) for nm in names]
            for i, g in enumerate(self._grouping):
                if i in s:
                    proj.append(Alias(g, key_names[i]))
                else:
                    dt = bind(g, child_schema).data_type
                    proj.append(Alias(Literal(None, dt), key_names[i]))
            gid = sum((1 << (n_keys - 1 - i)) for i in range(n_keys) if i not in s)
            proj.append(Alias(Literal(gid, INT), GROUPING_ID))
            projections.append(proj)
        expand = L.Expand(projections, out_names, self._df._plan)
        grouping = [UnresolvedAttribute(nm) for nm in key_names] + [
            UnresolvedAttribute(GROUPING_ID)
        ]
        # output: the original grouping names, then the aggregates (gid
        # internal); aggregate inputs read the original columns, passed
        # through the Expand unchanged, as in Spark's plan
        out_keys = [
            Alias(UnresolvedAttribute(kn), output_name(g))
            for kn, g in zip(key_names, self._grouping)
        ]
        return DataFrame(
            self._df._session,
            L.Aggregate(grouping, out_keys + agg_exprs, expand),
        )

    def count(self) -> DataFrame:
        from .functions import count as count_fn

        return self.agg(count_fn("*").alias("count"))

    def sum(self, *names: str) -> DataFrame:
        from .functions import sum as sum_fn

        return self.agg(*[sum_fn(col(n)).alias(f"sum({n})") for n in names])

    def avg(self, *names: str) -> DataFrame:
        from .functions import avg as avg_fn

        return self.agg(*[avg_fn(col(n)).alias(f"avg({n})") for n in names])

    def min(self, *names: str) -> DataFrame:
        from .functions import min as min_fn

        return self.agg(*[min_fn(col(n)).alias(f"min({n})") for n in names])

    def max(self, *names: str) -> DataFrame:
        from .functions import max as max_fn

        return self.agg(*[max_fn(col(n)).alias(f"max({n})") for n in names])


class CoGroupedData:
    """Two co-grouped frames awaiting ``apply_in_pandas`` (pyspark
    ``GroupedData.cogroup``; reference GpuFlatMapCoGroupsInPandasExec)."""

    def __init__(self, left: GroupedData, right: GroupedData):
        self._left = left
        self._right = right

    def apply_in_pandas(self, fn, schema) -> DataFrame:
        """``fn(left_pd, right_pd) -> pd.DataFrame`` once per key group
        present on either side; an absent side arrives as an empty frame
        with that side's columns."""
        lk = self._left._plain_key_names("cogroup apply_in_pandas")
        rk = self._right._plain_key_names("cogroup apply_in_pandas")
        if len(lk) != len(rk):
            raise ValueError(f"cogroup key counts differ: {lk} vs {rk}")
        return DataFrame(
            self._left._df._session,
            L.FlatMapCoGroupsInPandas(
                lk, rk, fn, _to_schema(schema), self._left._df._plan, self._right._df._plan
            ),
        )

    applyInPandas = apply_in_pandas


def _to_schema(schema) -> Schema:
    """Accept a Schema, a pyspark-style DDL string (``"a long, b double"``),
    or a list of (name, DataType) pairs / StructFields."""
    if isinstance(schema, Schema):
        return schema
    if isinstance(schema, str):
        from .types import parse_ddl_schema

        return parse_ddl_schema(schema)
    return Schema([f if isinstance(f, StructField) else StructField(f[0], f[1], True)
                   for f in schema])


def _extract_generators(exprs: List[Expression], plan: L.LogicalPlan) -> tuple:
    """Pull a top-level explode/posexplode out of a projection into a
    Generate node below it (Spark's ExtractGenerator; the JAX session's
    ``_extract_generators``); the projection then references the
    generator's output columns by name."""
    from .expr.complex import Explode, contains_generator
    from .types import MapType

    if not any(contains_generator(e) for e in exprs):
        return exprs, plan
    new_exprs: List[Expression] = []
    generator = None
    internal: List[str] = []  # collision-proof Generate output names
    for e in exprs:
        alias = e.name if isinstance(e, Alias) else None
        target = e.child if isinstance(e, Alias) else e
        if isinstance(target, Explode):
            if generator is not None:
                raise ValueError("only one generator per select is supported")
            generator = target
            ct = bind(target.child, plan.schema).data_type
            public: List[str] = []
            if target.position:
                public.append("pos")
            if isinstance(ct, MapType):
                if alias is not None:
                    raise ValueError(
                        "explode of a map produces two columns (key, value); "
                        "select them by name instead of aliasing the explode"
                    )
                public.extend(["key", "value"])
            else:
                public.append(alias or "col")
            internal = [f"__gen{i}" for i in range(len(public))]
            new_exprs.extend(Alias(UnresolvedAttribute(g), p) for g, p in zip(internal, public))
        elif contains_generator(e):
            raise ValueError("explode() must be a top-level select expression")
        else:
            new_exprs.append(e)
    return new_exprs, L.Generate(generator, internal, plan)
