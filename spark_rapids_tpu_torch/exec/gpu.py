"""Device physical operators — the GpuExec family, in torch.

The port of ``spark_rapids_tpu/exec/tpu.py``, with the upstream
spark-rapids names: the transitions (``HostToDeviceExec``, with the
session's upload cache, and ``DeviceToHostExec``),
``GpuCoalesceBatchesExec``, ``GpuProjectExec``, ``GpuFilterExec``,
``GpuHashAggregateExec`` (sort-based group-by in the partial, final and
complete modes; its filter-fusion decision is the JAX package's
``_fused_child``), ``GpuSortExec``, ``GpuUnionExec``,
``GpuCoalescePartitionsExec``, ``GpuShuffleExchangeExec``,
``GpuLimitExec``, ``GpuTakeOrderedAndProjectExec`` (top-N, with the radix
select's candidate prefilter) and ``GpuExpandExec``.

Eager torch runs each operator's expression tree as it comes — there is no
per-shape program to compile — so the JAX package's kernel cache and
compile guards have no counterpart here. The expression library evaluates
against the batch's torch namespace (``xp.py``), and string search runs
the hand-written kernel of ``ops/strings_kernels.py``.

The query runtime sits where the JAX package's does: the download and the
limit consume their upstream through the dispatch-ahead pipeline
(``exec/pipeline.py``); the download bills the ledger's
``device_execute`` and ``d2h`` phases and publishes the per-operator
metrics; and the partition coalesce under every collect() drives its child
partitions on ``spark.rapids.sql.concurrentGpuTasks`` worker threads,
with straggler speculation, committing their batches in partition order.

Every operator runs inside the context's memory and resilience runtime at
the places the JAX package's do: the upload takes the device semaphore and
the download releases it behind ``with_oom_retry``; project and filter go
through ``task.run_device`` (spill, retry, split); the aggregate's update
splits and its merge and final spill-retry; the out-of-core sort parks its
runs in the spill catalog and merges them pairwise with both operands
pinned; every exchange bucketing step runs behind ``with_oom_retry``; Expand
checks the cancel token once per batch. Two places go further than the JAX
package, because the card's real OOMs land there (``PERF.md`` §6):
the exchange registers the slices it holds for its readers in the catalog,
so a spill anywhere can move the partitions nobody reads yet off the card,
and the out-of-core sort's last merge splits by key rank when even a spill
leaves it short.

The upload cache hands the same device tensors to every later query over
the same table, so no operator here writes into a tensor of a batch it did
not create.
"""
from __future__ import annotations

import threading
from typing import List, Optional

import torch

from ..columnar.device import (
    DeviceBatch,
    DeviceColumn,
    bucket_capacity,
    dc_replace,
    device_to_host,
    empty_batch,
    host_to_device,
    map_planes,
)
from ..expr import Expression, bind, output_name
from ..expr.aggregates import AggregateFunction
from ..expr.base import Ctx, Val
from ..expr.misc import contains_task_dependent
from ..ops.aggregate import group_aggregate, group_max_size
from ..ops.concat import concat_device
from ..ops.gather import (
    bulk_shrink,
    compact,
    gather_batch,
    gather_column,
    partition_slices,
    row_counts,
    shrink_one,
    slice_head,
)
from ..ops.hash import murmur3_rows, partition_ids
from ..ops.scan import first_k_positions
from ..ops.sortkeys import (
    WORD_MAX,
    WORD_MIN,
    column_radix_words,
    merge_permutation,
    radix_select_kth,
    sort_permutation,
)
from ..plan.logical import SortOrder
from ..plan.partitioning import (
    SAMPLE_PER_BATCH,
    HashPartitioning,
    RangePartitioning,
    RoundRobinPartitioning,
    align_word_groups,
    compute_range_bounds,
    merge_sampled_word_groups,
    pad_flat_words,
    words_partition_ids,
)
from ..plan.physical import Exec, ExecContext, PartitionSet
from ..types import Schema, StringType, StructField
from ..resilience import retry as R
from ..xp import torch_dtype
from . import task


def val_to_column(ctx: Ctx, val: Val, dtype) -> DeviceColumn:
    """Materialize an expression result into a full DeviceColumn."""
    from ..types import ArrayType, MapType, StructType

    xp = ctx.xp
    if isinstance(dtype, (ArrayType, MapType)):
        lengths = ctx.broadcast(val.lengths).to(torch.int32)
        return DeviceColumn(dtype, None, val.full_valid(ctx), lengths, val.children)
    if isinstance(dtype, StructType):
        return DeviceColumn(dtype, None, val.full_valid(ctx), None, val.children)
    if isinstance(dtype, StringType):
        data = xp.asarray(val.data)
        if data.ndim == 1:  # scalar string literal [w]
            data = xp.broadcast_to(data[None, :], (ctx.n, data.shape[0]))
        lengths = xp.broadcast_to(xp.asarray(val.lengths, dtype=xp.int32), (ctx.n,))
        return DeviceColumn(
            dtype, data.contiguous(), val.full_valid(ctx).contiguous(), lengths.contiguous()
        )
    data = ctx.broadcast(val.data)
    want = torch_dtype(dtype.np_dtype)
    if data.dtype != want:
        data = data.to(want)
    return DeviceColumn(dtype, data.contiguous(), val.full_valid(ctx).contiguous())


# ── transitions ─────────────────────────────────────────────────────────────


def _row_bytes(schema: Schema) -> int:
    """Rough per-row device footprint for batch-size targeting (the JAX
    package's estimate, so both engines cut the same chunks)."""
    total = 0
    for f in schema:
        dt = f.data_type
        if isinstance(dt, StringType):
            total += 64  # padded bytes + lengths, typical bucket
        else:
            try:
                total += dt.np_dtype.itemsize
            except Exception:
                total += 16
        total += 1  # validity
    return max(total, 1)


def _upload_cache_budget(conf, device: torch.device) -> int:
    """H2D upload-cache byte budget (spark.rapids.tpu.uploadCache.maxBytes):
    explicit when set; else a quarter of the card's memory; else (on the
    CPU) the JAX package's 4 GiB fallback."""
    from .. import config as cfg

    b = cfg.UPLOAD_CACHE_MAX_BYTES.get(conf)
    if b > 0:
        return b
    if device.type == "cuda":
        return int(torch.cuda.mem_get_info(device)[1]) // 4
    return 4 << 30


def _schema_key(schema: Schema) -> tuple:
    return tuple((f.name, repr(f.data_type), f.nullable) for f in schema)


class HostToDeviceExec(Exec):
    """Host batches → device batches (HostColumnarToGpu analogue).

    Incoming batches are re-chunked to ``spark.rapids.sql.batchSizeBytes``
    (the CoalesceGoal TargetSize contract — GpuExec.scala:173-188) so one
    oversized host batch cannot blow the device working set.

    Over an in-memory scan the uploads go through the session's upload
    cache, as in the JAX package: repeated queries over the same table
    (and the same pruned columns) reuse the device batches. Each upload
    adds the host bytes it moves to the query's ``hostToDeviceBytes``
    counter, so a cache hit counts 0."""

    def __init__(self, child: Exec):
        super().__init__([child])

    @property
    def output(self) -> Schema:
        return self.children[0].output

    @property
    def is_device(self) -> bool:
        return True

    def execute(self, ctx: ExecContext) -> PartitionSet:
        from .. import config as cfg
        from .cpu import CpuScanExec

        schema = self.output
        max_rows = max(1, cfg.BATCH_SIZE_BYTES.get(ctx.conf) // _row_bytes(schema))
        max_str = cfg.STRING_MAX_BYTES.get(ctx.conf)
        device = ctx.device
        metrics = ctx.metrics
        bytes_m = self.metric("hostToDeviceBytes", "MODERATE")
        rows_m = self.metric("numInputRows", "ESSENTIAL")

        def fn(it):
            tok = ctx.cancel_token
            for rb in it:
                if rb.num_rows == 0:
                    continue
                metrics["hostToDeviceBytes"] += rb.nbytes
                bytes_m.add(rb.nbytes)
                rows_m.add(rb.num_rows)
                for off in range(0, rb.num_rows, max_rows):
                    if tok is not None:
                        tok.check()  # a beat per uploaded chunk
                    chunk = rb if rb.num_rows <= max_rows else rb.slice(off, max_rows)
                    ctx.semaphore.acquire_if_necessary()
                    yield host_to_device(chunk, device, max_str_bytes=max_str)

        child = self.children[0]
        if not isinstance(child, CpuScanExec) or ctx.session is None:
            return _placed_partitions(ctx, child.execute(ctx).map_partitions(fn))
        entry = self._cache_entry(ctx, child, (max_rows, max_str))
        child_parts = child.execute(ctx)

        def make_cached(p, thunk):
            def it():
                # single-flight per partition: one builder uploads, the rest
                # wait on its event and replay; a failed builder clears its
                # event so a waiter takes over
                while True:
                    with entry["lock"]:
                        built = entry["parts"][p]
                        ev = entry["building"][p]
                        builder = built is None and ev is None
                        if builder:
                            ev = entry["building"][p] = threading.Event()
                    if built is not None:
                        tok = ctx.cancel_token
                        for db in built:
                            if tok is not None:
                                tok.check()
                            ctx.semaphore.acquire_if_necessary()
                            yield db
                        return
                    if builder:
                        try:
                            out = list(fn(thunk()))
                            with entry["lock"]:
                                entry["parts"][p] = out
                        finally:
                            with entry["lock"]:
                                entry["building"][p] = None
                            ev.set()
                        yield from out
                        return
                    # another query is uploading this partition: wait for it
                    ev.wait()

            return it

        return _placed_partitions(
            ctx, PartitionSet([make_cached(p, t) for p, t in enumerate(child_parts.parts)])
        )

    def _cache_entry(self, ctx: ExecContext, scan, geometry: tuple) -> dict:
        """The session's cache entry for this scan, created (and the LRU
        trimmed to its byte budget) on a miss. The key is the SOURCE batch's
        id — pruning builds a new batch every query — and the entry pins
        both the source (so the id is never reused) and the pruned batch
        the uploads come from."""
        session = ctx.session
        key = ("h2d", id(scan.source), scan.num_partitions, _schema_key(self.output), geometry)
        with session._h2d_lock:
            cache = session._h2d_cache
            entry = cache.pop(key, None)
            if entry is None:
                nparts = scan.num_partitions
                entry = {
                    "table": (scan.source, scan.table),
                    "parts": [None] * nparts,
                    "building": [None] * nparts,
                    "lock": threading.Lock(),
                    # host bytes underestimate the padded device footprint;
                    # ~2x covers the power-of-two row padding
                    "est_bytes": 2 * scan.table.nbytes,
                }
                budget = _upload_cache_budget(ctx.conf, ctx.device)
                held = sum(c["est_bytes"] for c in cache.values())
                while cache and held + entry["est_bytes"] > budget:
                    held -= cache.pop(next(iter(cache)))["est_bytes"]  # LRU head
            cache[key] = entry  # (re)inserted last: most recently used
        return entry


def _range_samples(batches: list, all_words: list, home) -> list:
    """The range exchange's sample: ``SAMPLE_PER_BATCH`` evenly spaced rows
    of every batch's sort words, taken on each batch's device, gathered on
    ``home`` and fetched in ONE transfer; a list of numpy arrays, one per
    word. Duplicates (n < SAMPLE_PER_BATCH) just weight the sample; only an
    empty batch is left out, by its flag row."""
    samples = []
    for db, words in zip(batches, all_words):
        s_idx = (
            torch.arange(SAMPLE_PER_BATCH, dtype=torch.int64, device=db.device)
            * torch.clamp(db.num_rows, min=1)
        ) // SAMPLE_PER_BATCH
        flag = (db.num_rows > 0).to(torch.int64).expand(SAMPLE_PER_BATCH)
        samples.append(torch.stack([flag] + [w[s_idx] for w in words]).to(home))
    host = torch.stack(samples).cpu().numpy()  # [batches, 1 + words, S]
    keep = host[:, 0, :].astype(bool)
    return [host[:, 1 + i, :][keep] for i in range(host.shape[1] - 1)]


def _placed_partitions(ctx: ExecContext, pset: PartitionSet) -> PartitionSet:
    """Mesh mode: partition p's batches on member p % n's device, so
    per-partition operators run data-parallel from the upload on (the JAX
    package's ``_placed_partitions``); single-device mode and members that
    share the session's device pass through untouched."""
    mc = ctx.mesh
    if mc is None or all(d == ctx.device for d in mc.devices):
        return pset
    from ..parallel.mesh import put_batch

    def make(p, t):
        def it():
            dev = mc.device_for(p)
            for db in t():
                yield put_batch(db, dev)

        return it

    return PartitionSet([make(p, t) for p, t in enumerate(pset.parts)])


class DeviceToHostExec(Exec):
    """Device batches → host batches (GpuColumnarToRow/GpuBringBackToHost).

    The upstream chain runs on the dispatch-ahead pipeline's producer
    thread (``exec/pipeline.py``): its kernels for batches i+1..k are
    launched while this sink waits on batch i, as at the JAX package's
    ``DeviceToHostExec``. With a ledger, the wait for the device is split
    from the copy: ``device_execute`` bills the stream sync (the copy would
    wait for it anyway), ``d2h`` the transfer."""

    def __init__(self, child: Exec):
        super().__init__([child])

    @property
    def output(self) -> Schema:
        return self.children[0].output

    def execute(self, ctx: ExecContext) -> PartitionSet:
        from ..mem.spill import with_oom_retry
        from ..obs import ledger as obs_ledger
        from .pipeline import pipe_metrics, pipeline_conf, pipelined_partition

        rows_m = self.metric("numOutputRows", "ESSENTIAL")
        time_m = self.metric("deviceToHostTime", "MODERATE")
        bytes_m = self.metric("deviceToHostBytes", "MODERATE")
        timing = self.metrics_on(ctx, "MODERATE")
        led = ctx.ledger
        on_cuda = ctx.device.type == "cuda"

        def pull(db):
            with obs_ledger.scope_or_null(led, "d2h"):
                if timing:
                    with time_m.timed():
                        return with_oom_retry(ctx.catalog, device_to_host, db)
                return with_oom_retry(ctx.catalog, device_to_host, db)

        def fn(it):
            tok = ctx.cancel_token
            for db in it:
                if tok is not None:
                    tok.check()
                if led is not None and on_cuda:
                    with led.scope("device_execute"):
                        torch.cuda.current_stream(ctx.device).synchronize()
                hb = pull(db)
                del db
                ctx.semaphore.release_if_necessary()
                if hb.num_rows:
                    rows_m.add(hb.num_rows)
                    bytes_m.add(hb.nbytes)
                    yield hb

        # conf and metrics resolve HERE, on the single-threaded plan walk —
        # partition thunks race on a thread pool
        pconf = pipeline_conf(ctx)
        metrics = pipe_metrics(self, ctx) if pconf is not None else None

        def run(it):
            return pipelined_partition(pconf, ctx, it, fn, metrics)

        return self.children[0].execute(ctx).map_partitions(run)


class CoalesceGoal:
    """Batching contract (CoalesceGoal): a negative target is
    RequireSingleBatch, else TargetSize in bytes."""

    __slots__ = ("target_bytes",)

    def __init__(self, target_bytes: int):
        self.target_bytes = target_bytes

    def __repr__(self):
        if self.target_bytes < 0:
            return "RequireSingleBatch"
        return f"TargetSize({self.target_bytes})"


class GpuCoalesceBatchesExec(Exec):
    """Concatenate undersized device batches up to the goal before handing
    them to the parent (GpuCoalesceBatches' Table.concatenate accumulation
    loop :133-455)."""

    def __init__(self, child: Exec, goal: CoalesceGoal):
        super().__init__([child])
        self.goal = goal

    @property
    def output(self) -> Schema:
        return self.children[0].output

    @property
    def is_device(self) -> bool:
        return True

    def execute(self, ctx: ExecContext) -> PartitionSet:
        goal = self.goal
        batches_m = self.metric("numOutputBatches", "ESSENTIAL")

        def fn(it):
            acc: list = []
            acc_bytes = 0
            tok = ctx.cancel_token
            for db in it:
                if tok is not None:
                    tok.check()
                sz = db.size_bytes()
                if goal.target_bytes >= 0 and acc and acc_bytes + sz > goal.target_bytes:
                    batches_m.add(1)
                    yield concat_device(acc)
                    acc, acc_bytes = [], 0
                acc.append(db)
                acc_bytes += sz
            if acc:
                batches_m.add(1)
                yield concat_device(acc)

        return self.children[0].execute(ctx).map_partitions(fn)

    def node_string(self):
        return f"GpuCoalesceBatches {self.goal!r}"


# ── project / filter ────────────────────────────────────────────────────────


def has_error_site(e: Expression) -> bool:
    """Fusion guard (the JAX package's ``_expr_has_error_site``):
    expressions that raise through the device error channel (ANSI casts,
    ANSI integral arithmetic) keep their own project or filter, whose run
    reads the channel; a fused copy would swallow the error."""
    from ..expr.arithmetic import AnsiArithmetic
    from ..expr.cast import Cast

    if isinstance(e, Cast) and e.ansi:
        return True
    if isinstance(e, AnsiArithmetic) and e.ansi:
        return True
    return any(has_error_site(c) for c in e.children())


def fusable_filter(condition: Expression) -> bool:
    """A filter may fold into the operator above it as a liveness mask
    unless it reads task values or raises through the error channel."""
    return not (contains_task_dependent(condition) or has_error_site(condition))


def raise_errors(c: Ctx, live) -> None:
    """The device error channel (the JAX package's ``_error_flags`` and
    ``_ErrorCheckingKernel``): each ANSI site the expressions registered
    while evaluating is one flag, its row mask reduced over the live rows;
    the flags cross to the host in one sync, and only where a site exists,
    and the first that fired raises ``AnsiError`` with its message."""
    if not c.errors:
        return
    from ..expr.base import AnsiError

    flags = torch.stack([(mask & live).any() for _, mask in c.errors]).cpu()
    if bool(flags.any()):
        raise AnsiError(c.errors[int(torch.argmax(flags.to(torch.uint8)))][0])


def project_fn(exprs: tuple, schema: Schema):
    """The projection of one device batch (the JAX package's
    ``project_kernel``), raising its ANSI errors."""

    def _project(batch: DeviceBatch, tvals=None):
        c = Ctx.for_device(batch, task=tvals)
        cols = [val_to_column(c, e.eval(c), e.data_type) for e in exprs]
        # keep padding rows inert
        live = batch.row_mask()
        cols = [dc_replace(col, validity=col.validity & live) for col in cols]
        raise_errors(c, live)
        return DeviceBatch(schema, cols, batch.num_rows)

    return _project


def filter_fn(condition: Expression):
    """The filter of one device batch: evaluate, then compact (the JAX
    package's ``filter_kernel``), raising its ANSI errors."""

    def _filter(batch: DeviceBatch, tvals=None):
        c = Ctx.for_device(batch, task=tvals)
        v = condition.eval(c)
        keep = c.broadcast_bool(v.data) & v.full_valid(c)
        raise_errors(c, batch.row_mask())
        return compact(batch, keep)

    return _filter


class GpuProjectExec(Exec):
    def __init__(
        self,
        exprs: List[Expression],
        child: Exec,
        schema: Optional[Schema] = None,
    ):
        super().__init__([child])
        self.exprs = [bind(e, child.output) for e in exprs]
        # converted plans pass the CPU exec's schema: their exprs are already
        # bound, so output_name() would yield colN placeholders
        self._schema = schema or Schema(
            [
                StructField(output_name(e0), e.data_type, e.nullable)
                for e0, e in zip(exprs, self.exprs)
            ]
        )

    @property
    def output(self) -> Schema:
        return self._schema

    @property
    def is_device(self) -> bool:
        return True

    def execute(self, ctx: ExecContext) -> PartitionSet:
        fn = project_fn(tuple(self.exprs), self._schema)
        needs_task = any(contains_task_dependent(e) for e in self.exprs)

        def run(it):
            # splittable-operator opt-in: OOM at a launch spills, retries,
            # then recursively halves the batch (resilience/retry.py)
            return task.run_device(
                fn, it, needs_task, catalog=ctx.catalog, policy=ctx.retry_policy,
                op="ProjectExec", breaker=ctx.breaker, token=ctx.cancel_token,
            )

        return self.children[0].execute(ctx).map_partitions(run)

    def node_string(self):
        return f"GpuProject [{', '.join(map(str, self.exprs))}]"


class GpuFilterExec(Exec):
    def __init__(self, condition: Expression, child: Exec):
        super().__init__([child])
        self.condition = bind(condition, child.output)

    @property
    def output(self) -> Schema:
        return self.children[0].output

    @property
    def is_device(self) -> bool:
        return True

    def execute(self, ctx: ExecContext) -> PartitionSet:
        fn = filter_fn(self.condition)
        needs_task = contains_task_dependent(self.condition)

        def run(it):
            # splittable: a filter over concat(a, b) is concat(filter(a),
            # filter(b)) — halves yield independently under OOM pressure
            return task.run_device(
                fn, it, needs_task, catalog=ctx.catalog, policy=ctx.retry_policy,
                op="FilterExec", breaker=ctx.breaker, token=ctx.cancel_token,
            )

        return self.children[0].execute(ctx).map_partitions(run)

    def node_string(self):
        return f"GpuFilter {self.condition}"


class GpuCoalescePartitionsExec(Exec):
    """All child partitions into one, in partition order.

    This node is the engine's executor-task-slot surface (the JAX
    package's ``TpuCoalescePartitionsExec``): the coalesce at the root of a
    collect() drives every leaf partition, so with
    ``spark.rapids.sql.concurrentGpuTasks`` > 1 it runs its child
    partitions on that many worker threads — their host work and
    launches overlap — and yields each partition's batches in partition
    order, whatever task finishes first, so float results do not depend
    on the concurrency. At most that many partitions are buffered at once,
    and each worker returns its device-semaphore permit when its partition
    completes. With ``spark.rapids.tpu.speculation.enabled`` a straggling
    partition gets a duplicate attempt (``sched/speculation.py``); the
    straggler fault point (``faults.stallPartition``) fires here."""

    def __init__(self, child: Exec):
        super().__init__([child])

    @property
    def output(self) -> Schema:
        return self.children[0].output

    @property
    def is_device(self) -> bool:
        return True

    def execute(self, ctx: ExecContext) -> PartitionSet:
        from .. import config as cfg

        child_parts = self.children[0].execute(ctx)
        n_workers = min(len(child_parts.parts), cfg.CONCURRENT_TPU_TASKS.get(ctx.conf))

        def it():
            if n_workers <= 1 or task.in_task_pool():
                for t in child_parts.parts:
                    yield from t()
                return
            yield from _run_concurrent(ctx, child_parts.parts, n_workers)

        return PartitionSet([it])


def _run_concurrent(ctx: ExecContext, parts: list, n_workers: int):
    """Drive ``parts`` on ``n_workers`` threads, yielding each partition's
    batches in partition order (the JAX package's coalesce pool). The
    workers adopt the calling thread's phase ledger, span context and
    watchdog token, so their work attributes to the query."""
    from concurrent.futures import ThreadPoolExecutor

    from .. import config as cfg
    from ..obs import ledger as obs_ledger
    from ..obs import trace as obs_trace
    from ..resilience import faults as _faults
    from ..resilience import watchdog as _wd

    led = obs_ledger.current()
    captured = obs_trace.capture_context()
    token = ctx.cancel_token
    spec = None
    if cfg.SPECULATION_ENABLED.get(ctx.conf) and token is not None:
        from ..sched.speculation import SpeculationMonitor

        scheduler = getattr(ctx.session, "_scheduler", None)
        spec = SpeculationMonitor.from_conf(
            ctx.conf, ctx=ctx, token=token,
            pool=getattr(scheduler, "pool", None),
            n_partitions=len(parts),
        )

    def attempt(i, t, tok):
        obs_ledger.set_current(led)
        obs_trace.attach_context(captured)
        _wd.set_current(tok)
        task.set_in_task_pool(True)
        try:
            # chaos straggler point: the first attempt of the configured
            # partition crawls; a duplicate runs free
            _faults.on_task_attempt(i, 0, tok)
            return list(t())
        finally:
            # the primary runs on a pool worker, a duplicate on the
            # monitor's thread — each returns its own permit
            ctx.semaphore.release_if_necessary()
            obs_ledger.set_current(None)
            _wd.set_current(None)

    def run_one(i, t):
        if spec is None:
            return attempt(i, t, token)
        return spec.run_partition(i, lambda tok: attempt(i, t, tok))

    try:
        with ThreadPoolExecutor(max_workers=n_workers, thread_name_prefix="srt-task") as pool:
            pending = {i: pool.submit(run_one, i, parts[i]) for i in range(n_workers)}
            nxt = n_workers
            for i in range(len(parts)):
                batches = pending.pop(i).result()
                if nxt < len(parts):
                    pending[nxt] = pool.submit(run_one, nxt, parts[nxt])
                    nxt += 1
                yield from batches
    finally:
        if spec is not None:
            spec.close()


# ── aggregate ───────────────────────────────────────────────────────────────


def _buffer_ordinal(grouping, agg_fns, f: AggregateFunction, j: int) -> int:
    """Ordinal of buffer ``j`` of ``f`` in the keys ++ buffers layout."""
    base = len(grouping)
    for g in agg_fns:
        if g is f:
            return base + j
        base += len(g.buffer_types)
    raise KeyError


def aggregate_fn(
    mode: str,
    grouping: tuple,
    agg_fns: tuple,
    result_exprs,
    out_schema: Schema,
    child_schema: Schema,
    pre_filter: Optional[Expression] = None,
    has_nans: bool = True,
    collect_width: int = 0,
):
    """The group aggregate of one device batch (update or merge+evaluate) —
    the JAX package's ``aggregate_kernel``. ``pre_filter`` folds a child
    filter's predicate in as a liveness mask: no compaction between the
    filter and the aggregate. ``collect_width`` is the collect family's
    element-plane width, from ``aggregate_width_fn``."""

    def _aggregate(batch: DeviceBatch) -> DeviceBatch:
        c = Ctx.for_device(batch)
        live = batch.row_mask()
        if pre_filter is not None:
            fv = pre_filter.eval(c)
            live = live & c.broadcast_bool(fv.data) & fv.full_valid(c)
        # materialize grouping keys + agg inputs as columns
        key_cols = [val_to_column(c, g.eval(c), g.data_type) for g in grouping]
        key_cols = [dc_replace(k, validity=k.validity & live) for k in key_cols]
        in_cols: list = []
        ops: list = []
        for f in agg_fns:
            if mode in ("partial", "complete"):
                exprs = [bind(e, child_schema) for e in f.update_exprs]
                for e, op in zip(exprs, f.update_ops):
                    col = val_to_column(c, e.eval(c), e.data_type)
                    in_cols.append(dc_replace(col, validity=col.validity & live))
                    ops.append(op)
            else:
                for j, op in enumerate(f.merge_ops):
                    in_cols.append(batch.columns[_buffer_ordinal(grouping, agg_fns, f, j)])
                    ops.append(op)
        key_schema = Schema([StructField(f"k{i}", k.dtype, True) for i, k in enumerate(key_cols)])
        work = DeviceBatch(key_schema, key_cols, batch.num_rows)
        out_keys, out_aggs, num_groups = group_aggregate(
            work,
            list(range(len(key_cols))),
            in_cols,
            ops,
            live_mask=live if pre_filter is not None else None,
            has_nans=has_nans,
            collect_width=collect_width,
        )
        if mode == "partial":
            return DeviceBatch(out_schema, out_keys + out_aggs, num_groups)
        # final/complete: evaluate aggregates + result projection
        cap = out_aggs[0].capacity if out_aggs else out_keys[0].capacity
        keys_v = [Val(k.data, k.validity, k.lengths) for k in out_keys]
        gctx = Ctx(c.xp, cap, True, keys_v, num_groups)
        agg_results: list = []
        i = 0
        for f in agg_fns:
            nbuf = len(f.buffer_types)
            bufs = [
                Val(
                    out_aggs[i + j].data,
                    out_aggs[i + j].validity,
                    out_aggs[i + j].lengths,
                    out_aggs[i + j].children,
                )
                for j in range(nbuf)
            ]
            agg_results.append(f.evaluate(gctx, bufs))
            i += nbuf
        rctx = Ctx(c.xp, cap, True, keys_v + agg_results, num_groups)
        glive = torch.arange(cap, dtype=torch.int32, device=batch.device) < num_groups
        cols = []
        for e in result_exprs:
            col = val_to_column(rctx, e.eval(rctx), e.data_type)
            cols.append(dc_replace(col, validity=col.validity & glive))
        return DeviceBatch(out_schema, cols, num_groups)

    return _aggregate


def aggregate_width_fn(grouping: tuple, pre_filter, has_nans: bool):
    """The collect family's width pre-pass over one device batch (the JAX
    package's ``_width_kernel``): the largest group's live-row count, an
    int32 device scalar."""

    def _width(batch: DeviceBatch) -> torch.Tensor:
        c = Ctx.for_device(batch)
        live = batch.row_mask()
        if pre_filter is not None:
            fv = pre_filter.eval(c)
            live = live & c.broadcast_bool(fv.data) & fv.full_valid(c)
        if not grouping:
            return live.sum().to(torch.int32)
        key_cols = [val_to_column(c, g.eval(c), g.data_type) for g in grouping]
        key_cols = [dc_replace(k, validity=k.validity & live) for k in key_cols]
        work = DeviceBatch(
            Schema([StructField(f"k{i}", k.dtype, True) for i, k in enumerate(key_cols)]),
            key_cols,
            batch.num_rows,
        )
        return group_max_size(
            work,
            list(range(len(key_cols))),
            live_mask=live if pre_filter is not None else None,
            has_nans=has_nans,
        )

    return _width


# Largest [capacity, W] collect element plane the device path will build
# (~1 GB of int64). Beyond it (one group holding most of a huge input) the
# padded layout is the wrong tool — the query fails with the kill-switch
# hint instead of running the card out of memory.
_COLLECT_PLANE_LIMIT = 1 << 27


def aggregate_merge_fn(grouping: tuple, agg_fns: tuple, out_schema: Schema, has_nans: bool = True):
    """Merge-mode aggregation over (concatenated) partial batches — the JAX
    package's ``aggregate_merge_kernel``. The partial layout is keys ++
    buffers, so key ordinals and ``_buffer_ordinal`` line up."""

    def _merge(batch: DeviceBatch) -> DeviceBatch:
        in_cols, ops = [], []
        for f in agg_fns:
            for j, op in enumerate(f.merge_ops):
                in_cols.append(batch.columns[_buffer_ordinal(grouping, agg_fns, f, j)])
                ops.append(op)
        out_keys, out_aggs, num_groups = group_aggregate(
            batch, list(range(len(grouping))), in_cols, ops, has_nans=has_nans
        )
        return DeviceBatch(out_schema, out_keys + out_aggs, num_groups)

    return _merge


class GpuHashAggregateExec(Exec):
    """Sort-based group-by on the device; one phase (partial|final|complete).

    The reference's hot loop (aggregate.scala:406-468): per-batch update
    aggregate → concat partials → merge aggregate. Update and merge are the
    same group aggregate with different reduce ops. OOM handling follows the
    JAX package's split rules: the update is splittable (partials of two
    halves merge downstream like two input batches), so it rides
    ``run_with_retry``; the merge and the final merge+evaluate are not
    (merging halves apart would emit a key twice), so they spill-retry
    through ``run_once``."""

    def __init__(
        self,
        mode: str,
        grouping: List[Expression],
        agg_fns: List[AggregateFunction],
        result_exprs: Optional[List[Expression]],
        result_names: Optional[List[str]],
        child: Exec,
    ):
        super().__init__([child])
        self.mode = mode
        self.grouping = [bind(g, child.output) for g in grouping]
        self.agg_fns = list(agg_fns)
        self.result_exprs = None if result_exprs is None else list(result_exprs)
        self.result_names = None if result_names is None else list(result_names)
        self._schema = self._compute_schema()

    def _compute_schema(self) -> Schema:
        fields = [StructField(output_name(g), g.data_type, g.nullable) for g in self.grouping]
        if self.mode == "partial":
            for i, f in enumerate(self.agg_fns):
                for j, bt in enumerate(f.buffer_types):
                    fields.append(StructField(f"buf{i}_{j}", bt, True))
            return Schema(fields)
        return Schema(
            [
                StructField(name, e.data_type, e.nullable)
                for name, e in zip(self.result_names, self.result_exprs)
            ]
        )

    @property
    def output(self) -> Schema:
        return self._schema

    @property
    def is_device(self) -> bool:
        return True

    def _fused_child(self) -> tuple:
        """(effective child, fused pre_filter) — the JAX package's
        filter-fusion decision (``exec/tpu.py`` ``_fused_child``): a child
        filter's predicate folds into the aggregate as a liveness mask, and
        the compaction gather of every column is skipped. Filters with
        task-dependent or error-raising expressions stay standalone."""
        child = self.children[0]
        if (
            self.mode in ("partial", "complete")
            and isinstance(child, GpuFilterExec)
            and fusable_filter(child.condition)
        ):
            return child.children[0], child.condition
        return child, None

    def execute(self, ctx: ExecContext) -> PartitionSet:
        from .. import config as cfg

        child, pre_filter = self._fused_child()
        child_schema = child.output
        has_nans = cfg.HAS_NANS.get(ctx.conf)
        grouping = tuple(self.grouping)
        agg_fns = tuple(self.agg_fns)
        fn = aggregate_fn(
            self.mode,
            grouping,
            agg_fns,
            None if self.result_exprs is None else tuple(self.result_exprs),
            self._schema,
            child_schema,
            pre_filter,
            has_nans,
        )
        merge = aggregate_merge_fn(grouping, agg_fns, self._schema, has_nans)
        width = aggregate_width_fn(grouping, pre_filter, has_nans)
        device = ctx.device
        target = cfg.BATCH_SIZE_BYTES.get(ctx.conf)
        pack_filter = None if pre_filter is None else filter_fn(pre_filter)
        catalog, policy, breaker = ctx.catalog, ctx.retry_policy, ctx.breaker
        op = "HashAggregateExec"

        def once(f, arg):
            return R.run_once(catalog, f, arg, policy, op=op, breaker=breaker)

        def run(it):
            if self.mode == "partial":
                # per-batch update, then shrink + concat + merge of the
                # partials (one row-count fetch for all of them)
                partials = []
                for db in it:
                    partials.extend(
                        R.run_with_retry(catalog, fn, db, policy, op=op, breaker=breaker)
                    )
                    del db
                if not partials:
                    if grouping:
                        return
                    partials = [once(fn, empty_batch(child_schema, device))]
                if len(partials) == 1:
                    yield partials.pop()
                else:
                    shrunk, counts = bulk_shrink(partials)
                    del partials
                    out = once(lambda bs: merge(concat_device(bs, counts=counts)), shrunk)
                    del shrunk  # the inputs free before the output moves on
                    yield out
                return
            # final/complete: one merge+evaluate over the whole partition.
            # Whenever the batches held since the last pack pass the batch-size
            # target, they are filtered by the fused filter (re-applied later
            # to the same rows, which keeps them) and packed into one batch
            # tight to their live rows (one count fetch): a filtered batch
            # keeps its input's capacity, and a deep join's filtered output
            # would otherwise be held at full width. (The JAX package holds
            # the batches as they come.)
            def pack(bs):
                if pack_filter is not None:
                    bs = [pack_filter(b) for b in bs]
                return concat_device(bs, counts=row_counts(bs))

            batches, pending, held = [], [], 0
            for db in it:
                pending.append(db)
                held += db.size_bytes()
                del db
                if held > target and len(pending) > 1:
                    batches.append(once(pack, pending))
                    pending, held = [], 0
            batches += pending
            del pending
            if not batches:
                if grouping:
                    return
                batches = [empty_batch(child_schema, device)]
            if self._has_collect:
                yield once(collect, batches)
                return
            # the concat is part of the retried work: an OOM there spills too
            out = once(lambda bs: fn(concat_device(bs)), batches)
            del batches  # the held input frees before the output moves on
            yield out

        def collect(bs):
            """The collect family's final/complete pass: the plane width
            from the max-group-size pre-pass, fetched with the live-row
            count in one host sync; the merged batch shrinks to its live rows
            first, since the ``[capacity, W]`` element plane scales with both
            (the JAX package's ``TpuHashAggregateExec.execute``)."""
            merged = concat_device(bs)
            n, w = torch.stack([merged.num_rows, width(merged)]).tolist()
            merged = shrink_one(merged, n)
            plane_w = bucket_capacity(max(w, 1))
            if merged.capacity * plane_w > _COLLECT_PLANE_LIMIT:
                raise RuntimeError(
                    "device collect_list/collect_set needs a "
                    f"[{merged.capacity}, {plane_w}] element plane "
                    f"(> {_COLLECT_PLANE_LIMIT} elements) — a single "
                    "group holds too many rows for the padded device "
                    "layout; disable the device path with "
                    "spark.rapids.sql.expression.CollectList=false / "
                    "spark.rapids.sql.expression.CollectSet=false"
                )
            return aggregate_fn(
                self.mode, grouping, agg_fns,
                None if self.result_exprs is None else tuple(self.result_exprs),
                self._schema, child_schema, pre_filter, has_nans, collect_width=plane_w,
            )(merged)

        return child.execute(ctx).map_partitions(run)

    @property
    def _has_collect(self) -> bool:
        return any(
            op in ("collect_list", "collect_set") for f in self.agg_fns for op in f.update_ops
        )

    def node_string(self):
        return (
            f"GpuHashAggregate({self.mode}) keys={[str(g) for g in self.grouping]} "
            f"aggs={[str(a) for a in self.agg_fns]}"
        )


# ── sort ────────────────────────────────────────────────────────────────────


def _order_words(c: Ctx, order, live) -> list:
    words = []
    for o in order:
        col = val_to_column(c, o.child.eval(c), o.child.data_type)
        col = dc_replace(col, validity=col.validity & live)
        words.extend(column_radix_words(col, o.ascending, o.resolved_nulls_first()))
    return words


def device_sort_fn(order: list):
    """Whole-batch sort: radix words of the sort keys, one LSD permutation,
    one gather — the JAX package's ``device_sort_fn``."""

    def _sort(batch: DeviceBatch) -> DeviceBatch:
        live = batch.row_mask()
        perm = sort_permutation(_order_words(Ctx.for_device(batch), order, live), live)
        return gather_batch(batch, perm, batch.num_rows)

    return _sort


def device_merge_fn(order: list):
    """Two-run merge: concat the sorted runs (live segments land at [0, na)
    and [na, na+nb)), rebuild the radix words and gather through
    ``merge_permutation``'s binary-search ranks — the JAX package's
    ``device_merge_fn`` (reference: GpuSortExec.scala:212-510)."""

    def _merge(ba: DeviceBatch, bb: DeviceBatch) -> DeviceBatch:
        na, nb = ba.num_rows, bb.num_rows
        merged = concat_device([ba, bb])
        words = _order_words(Ctx.for_device(merged), order, merged.row_mask())
        return gather_batch(merged, merge_permutation(words, na, nb), na + nb)

    return _merge


def _row_words(batch: DeviceBatch, order: list, i: int, widths: dict) -> list:
    """The radix words of row ``i`` of ``batch`` as host ints (one sync),
    its string planes first widened to ``widths`` (column -> width) so two
    batches' rows give word lists of one length."""
    from ..ops.concat import _pad_width

    idx = torch.tensor([i], dtype=torch.int64, device=batch.device)
    row = gather_batch(batch, idx, 1)
    cols = [
        dc_replace(c, data=_pad_width(c.data, widths[j])) if j in widths else c
        for j, c in enumerate(row.columns)
    ]
    row = DeviceBatch(row.schema, cols, row.num_rows)
    live = torch.ones(1, dtype=torch.bool, device=batch.device)
    return torch.cat(_order_words(Ctx.for_device(row), order, live)).tolist()


def _rank(batch: DeviceBatch, n: int, order: list, key: list, right: bool, widths: dict) -> int:
    """Rows of the sorted ``batch`` (``n`` live) that sort before ``key``
    (``right``: before or equal) — a host binary search over one row's words
    at a time, so it needs no memory for the batch's words."""
    lo, hi = 0, n
    while lo < hi:
        mid = (lo + hi) // 2
        w = _row_words(batch, order, mid, widths)
        if w < key or (right and w == key):
            lo = mid + 1
        else:
            hi = mid
    return lo


def _rows_view(batch: DeviceBatch, lo: int, hi: int) -> DeviceBatch:
    """Rows ``[lo, hi)`` of ``batch`` as views, in a capacity of the next
    power of two where the batch holds it (no copy)."""
    end = min(batch.capacity, lo + bucket_capacity(max(hi - lo, 1)))
    cols = [map_planes(c, lambda t: t[lo:end]) for c in batch.columns]
    return DeviceBatch(
        batch.schema, cols, torch.tensor(hi - lo, dtype=torch.int32, device=batch.device)
    )


class GpuSortExec(Exec):
    """Per-partition sort (GpuSortExec.scala:36-42,212-510), the port of the
    JAX package's ``TpuSortExec``:

    * single-batch: coalesce the partition into one batch and sort it;
    * out-of-core: once the partition's batches exceed
      ``spark.rapids.tpu.sort.outOfCoreThresholdBytes``, sort each incoming
      batch into a *run*, park runs in the spill catalog (device → host →
      disk as memory demands), then merge runs pairwise with both operands
      pinned — at most two runs are pinned on the device at once. Each sort
      and merge makes headroom first and runs behind ``with_oom_retry``.

    The last merge goes one step further than the JAX package's: when a
    real OOM persists after the spills (both operands are pinned, so
    nothing else is left to move), it splits the merge by key rank — the
    middle row of the larger run, and its rank in the other found by a host
    binary search over one row's words at a time — and merges the two
    halves apart, recursively, yielding the sorted output as several
    batches. Ties keep the stable merge's order (the first run wins)."""

    def __init__(self, order: list, child: Exec):
        super().__init__([child])
        self.order = [
            SortOrder(bind(o.child, child.output), o.ascending, o.nulls_first) for o in order
        ]

    @property
    def output(self) -> Schema:
        return self.children[0].output

    @property
    def is_device(self) -> bool:
        return True

    def execute(self, ctx: ExecContext) -> PartitionSet:
        from .. import config as cfg
        from ..mem.spill import SpillPriorities, with_oom_retry

        order = self.order
        _sort = device_sort_fn(order)
        _merge = device_merge_fn(order)
        threshold = cfg.OUT_OF_CORE_SORT_THRESHOLD.get(ctx.conf)
        catalog = ctx.catalog
        floor = max(2, ctx.retry_policy.min_split_rows)

        def make_run(b):
            """Sort one input batch into a spillable run."""
            catalog.ensure_headroom(2 * b.size_bytes(), b.device)
            return catalog.register(with_oom_retry(catalog, _sort, b), SpillPriorities.WORKING)

        def merge_pair(a, b):
            # pin the operands FIRST so the headroom pass (and any
            # retry-spill) cannot evict what is being merged
            ba, bb = a.get_batch(), b.get_batch()
            catalog.ensure_headroom(2 * (a.size_bytes + b.size_bytes), ba.device)
            return _merge(ba, bb)

        def merge_split(ba, bb):
            """The merge of two sorted batches as several batches, split by
            key rank (class docstring)."""
            na, nb = row_counts([ba, bb])
            if max(na, nb) <= floor:
                yield with_oom_retry(catalog, _merge, ba, bb)  # raises as it may
                return
            R.record("splits")
            widths = {
                j: max(ca.str_width, cb.str_width)
                for j, (ca, cb) in enumerate(zip(ba.columns, bb.columns))
                if ca.is_string
            }
            if na >= nb:
                m = na // 2
                key = _row_words(ba, order, m, widths)
                k = _rank(bb, nb, order, key, False, widths)
                cuts = ((0, m, 0, k), (m, na, k, nb))
            else:
                m = nb // 2
                key = _row_words(bb, order, m, widths)
                k = _rank(ba, na, order, key, True, widths)
                cuts = ((0, k, 0, m), (k, na, m, nb))
            for a0, a1, b0, b1 in cuts:
                x, y = _rows_view(ba, a0, a1), _rows_view(bb, b0, b1)
                try:
                    out = with_oom_retry(catalog, _merge, x, y)
                except Exception as e:  # noqa: BLE001 - classified below
                    if not R.is_oom_error(e):
                        raise
                    out = None
                if out is None:
                    yield from merge_split(x, y)
                else:
                    yield out
                    del out

        def merge_last(a, b):
            try:
                out = with_oom_retry(catalog, merge_pair, a, b)
            except Exception as e:  # noqa: BLE001 - classified below
                if not R.is_oom_error(e):
                    raise
                out = None
            if out is not None:
                a.close(), b.close()
                yield out
                return
            # both operands are pinned: split the merge instead
            yield from merge_split(a.get_batch(), b.get_batch())
            a.close(), b.close()

        def run(it):
            # buffer small partitions for the single-batch path; past the
            # threshold, sort each incoming batch into a spillable run at
            # once, so unsorted input never accumulates on the device
            pending, pending_bytes, runs = [], 0, None
            for b in it:
                if runs is None:
                    pending.append(b)
                    pending_bytes += b.size_bytes()
                    if pending_bytes > threshold and len(pending) > 1:
                        runs = []
                        while pending:
                            runs.append(make_run(pending.pop(0)))
                else:
                    runs.append(make_run(b))
                del b
            if runs is None:
                if pending:
                    out = with_oom_retry(catalog, lambda bs: _sort(concat_device(bs)), pending)
                    del pending
                    yield out
                return
            # staged binary merge of sorted runs (binary-search ranks, linear
            # work per level); the last merge may split (class docstring)
            while len(runs) > 2:
                nxt = []
                for i in range(0, len(runs) - 1, 2):
                    a, b = runs[i], runs[i + 1]
                    out = with_oom_retry(catalog, merge_pair, a, b)
                    a.close(), b.close()
                    nxt.append(catalog.register(out, SpillPriorities.WORKING))
                    del out
                if len(runs) % 2:
                    nxt.append(runs[-1])
                runs = nxt
            if len(runs) == 2:
                yield from merge_last(*runs)
                return
            with runs[0] as final:
                yield final.get_batch()

        return self.children[0].execute(ctx).map_partitions(run)

    def node_string(self):
        return f"GpuSort [{', '.join(map(str, self.order))}]"


# ── union, exchange, limit ──────────────────────────────────────────────────


class GpuUnionExec(Exec):
    """The children's partitions, concatenated in order (the JAX package's
    ``TpuUnionExec``)."""

    def __init__(self, children: List[Exec]):
        super().__init__(children)

    @property
    def output(self) -> Schema:
        return self.children[0].output

    @property
    def is_device(self) -> bool:
        return True

    def execute(self, ctx: ExecContext) -> PartitionSet:
        parts = []
        for c in self.children:
            parts.extend(c.execute(ctx).parts)
        return PartitionSet(parts)


#: guards the entries of every query's reuse memo (a shared exchange is
#: reached from several partition tasks at once)
_REUSE_LOCK = threading.Lock()

# which join side may be SPLIT under skew (the other side is replicated;
# replication must not be able to emit unmatched rows of its own side)
_SPLITTABLE_SIDES = {
    "inner": ("left", "right"),
    "left": ("left",),
    "left_semi": ("left",),
    "left_anti": ("left",),
    "right": ("right",),
    "full": (),
}


def _aqe_join_plan(sa, sb, n, advisory, sides, skew_thresh, skew_factor):
    """One shared AQE plan for both shuffle reads of a join: per output
    slot, a list of (source partition, split index, split count) for each
    side. Coalescing groups adjacent small partitions; a skewed partition
    (one side > max(threshold, factor x median), other side small) is
    split across the slots coalescing freed while the other side's
    partition replicates into each. Deterministic in (sa, sb) so both
    exchanges compute identical plans. Copied from the JAX package's
    ``exec/tpu.py::_aqe_join_plan``."""
    combined = [x + y for x, y in zip(sa, sb)]
    skewed: dict = {}
    if sides and skew_thresh > 0:
        med_a = sorted(sa)[n // 2]
        med_b = sorted(sb)[n // 2]
        for p in range(n):
            if (
                "left" in sides
                and sa[p] > max(skew_thresh, skew_factor * med_a)
                and sb[p] <= skew_thresh
            ):
                skewed[p] = "left"
            elif (
                "right" in sides
                and sb[p] > max(skew_thresh, skew_factor * med_b)
                and sa[p] <= skew_thresh
            ):
                skewed[p] = "right"
    groups: list = []
    cur: list = []
    by = 0
    for p in range(n):
        if p in skewed:
            if cur:
                groups.append(("g", cur))
                cur, by = [], 0
            groups.append(("s", [p]))
            continue
        if cur and by + combined[p] > advisory:
            groups.append(("g", cur))
            cur, by = [], 0
        cur.append(p)
        by += combined[p]
    if cur:
        groups.append(("g", cur))
    free = n - len(groups)
    out_a: list = [[] for _ in range(n)]
    out_b: list = [[] for _ in range(n)]
    slot = 0
    for kind, g in groups:
        if kind == "s" and free > 0:
            p = g[0]
            side = skewed[p]
            big = sa[p] if side == "left" else sb[p]
            want = max(2, int(big // max(advisory, 1)))
            k = min(free + 1, want, n)
            free -= k - 1
            for j in range(k):
                if side == "left":
                    out_a[slot].append((p, j, k))
                    out_b[slot].append((p, 0, 1))
                else:
                    out_a[slot].append((p, 0, 1))
                    out_b[slot].append((p, j, k))
                slot += 1
        else:
            for p in g:
                out_a[slot].append((p, 0, 1))
                out_b[slot].append((p, 0, 1))
            slot += 1
    return out_a, out_b


def _row_range_slice(db: DeviceBatch, j: int, k: int) -> DeviceBatch:
    """Rows of live-row range slice j of k, moved to the prefix (the skew
    split unit). Live rows are the prefix ``[0, num_rows)``, so the slice
    is rows ``[n*j//k, n*(j+1)//k)``: one shifted gather at the batch's
    capacity, the padding re-masked past the slice's own count (as
    ``resilience/retry.py::split_batch`` re-masks its halves). Rows keep
    their order, as the JAX package's compaction keeps them."""
    n = db.num_rows.to(torch.int64)
    lo = (n * j) // k
    cnt = (n * (j + 1)) // k - lo
    cap = db.capacity
    iota = torch.arange(cap, dtype=torch.int64, device=db.device)
    out = gather_batch(db, torch.clamp(lo + iota, 0, cap - 1), cnt.to(torch.int32))
    live = iota < cnt
    cols = [dc_replace(c, validity=c.validity & live) for c in out.columns]
    return DeviceBatch(out.schema, cols, out.num_rows)


class GpuShuffleExchangeExec(Exec):
    """Partitioned exchange with on-device bucketing and device-side slicing
    (GpuShuffleExchangeExec + the four GpuPartitioning impls), the port of
    the JAX package's ``TpuShuffleExchangeExec`` in its single-process,
    in-memory form. Hash = murmur3 pmod; range = radix-word compare against
    bounds from one fetch of sampled words; round-robin from a device-
    resident running offset; single = all batches, shrunk, into partition 0.
    Every partition's batches stay on the device.

    Under ``spark.sql.adaptive.enabled`` the read is adaptive, as in the
    JAX package (``exec/tpu.py:2613-2714``): from the measured live-row
    bytes of every bucket (one count fetch per exchange, memoized) adjacent
    small partitions coalesce into one reader slot, and when the exchange
    feeds a shuffled join linked to its peer (``exec/gpu_join.py``) a
    skewed partition splits across the freed slots while the peer's
    partition replicates. Both sides compute one plan from the combined
    sizes, so positional pairing holds. The assignment is memoized under
    a lock: partition tasks and both sides of a join reach it at once.
    Each exchange records ``aqe_groups`` and ``aqe_splits``. A node that
    exchange reuse (``plan/reuse.py``) shares between consumers memoizes
    its ``PartitionSet`` in the query's ``reuse_cache``.

    With ``spark.rapids.shuffle.manager.enabled`` the read goes through the
    shuffle manager (``_managed_read``), and in a multi-process query
    (``spark.rapids.shuffle.multiproc.*``) each executor maps only its
    rank's child partitions, reduces only its rank's output partitions and
    fetches the peers' map output over TCP; a range exchange then shares
    one set of bounds through the driver service. In mesh mode
    (``spark.rapids.sql.mesh.enabled``, as many partitions as members) a
    hash, range or round-robin exchange is one ``parallel/mesh.py``
    exchange (``_execute_mesh``). These are the JAX package's
    ``exec/tpu.py:2052-2230, :2283-2304, :2363-2395, :2441-2611``.

    Every bucketing step runs behind ``with_oom_retry``, as in the JAX
    package. Unlike the JAX package's in-memory exchange, the slices it
    holds for its readers are registered in the spill catalog (priority
    ``INPUT_FROM_SHUFFLE``, the first to go), the way its shuffle manager
    parks map output: a partition nobody reads yet (or that its reader has
    dropped) is memory a spill can free anywhere in the query. A reader
    takes each slice back from whatever tier it is on and unpins it, so a
    partition can be read again (a task retried from lineage, a cartesian
    product); the slices stay registered, as the JAX exchange holds its
    buckets, until the query's end, when the session closes them."""

    def __init__(self, partitioning, child: Exec):
        super().__init__([child])
        from .cpu import _bind_partitioning

        self.partitioning = _bind_partitioning(partitioning, child.output)
        # AQE coalescing coordination: a co-partitioned consumer (shuffled
        # join) links its two feeding exchanges so both compute ONE shared
        # assignment from combined sizes; if only one side is an exchange,
        # coalescing is disabled to keep positional pairing intact.
        self._aqe_peer: "GpuShuffleExchangeExec | None" = None
        self._aqe_disabled = False

    @property
    def num_partitions(self) -> int:
        return self.partitioning.num_partitions

    @property
    def output(self) -> Schema:
        return self.children[0].output

    @property
    def is_device(self) -> bool:
        return True

    def _kind(self) -> str:
        part = self.partitioning
        if isinstance(part, HashPartitioning) and part.keys:
            return "hash"
        if isinstance(part, RoundRobinPartitioning):
            return "roundrobin"
        if isinstance(part, RangePartitioning):
            return "range"
        return "single"

    def _scatter_fn(self, kind: str, nparts: int, pre_filter=None):
        """The bucketing of one batch into ``nparts`` slices for ``kind``
        (None for "single").
        ``pre_filter`` fuses a child filter's predicate in as a liveness
        mask: dead rows fall out during bucketing, skipping the filter's own
        compaction."""

        def live_of(c: Ctx):
            if pre_filter is None:
                return None
            fv = pre_filter.eval(c)
            return c.broadcast_bool(fv.data) & fv.full_valid(c)

        if kind == "hash":
            keys = tuple(self.partitioning.keys)

            def hash_slice(batch: DeviceBatch) -> list:
                c = Ctx.for_device(batch)
                cols = []
                for k in keys:
                    col = val_to_column(c, k.eval(c), k.data_type)
                    cols.append((k.data_type, col.data, col.validity, col.lengths))
                pids = partition_ids(c.xp, murmur3_rows(c.xp, cols, batch.capacity), nparts)
                return partition_slices(batch, pids, nparts, live_of(c))

            return hash_slice
        if kind == "roundrobin":

            def rr_slice(batch: DeviceBatch, start: torch.Tensor) -> list:
                iota = torch.arange(batch.capacity, dtype=torch.int64, device=batch.device)
                return partition_slices(batch, (start + iota) % nparts, nparts)

            return rr_slice
        if kind == "single":
            return None  # no bucketing: every batch goes to partition 0

        def range_slice(batch: DeviceBatch, words: list, bounds: list) -> list:
            pids = words_partition_ids(words, bounds)
            return partition_slices(batch, pids, nparts, live_of(Ctx.for_device(batch)))

        return range_slice

    def _range_words(self, batch: DeviceBatch) -> list:
        """Per-order-column radix word lists of one batch (aligned later)."""
        c = Ctx.for_device(batch)
        return [
            column_radix_words(
                val_to_column(c, o.child.eval(c), o.child.data_type),
                o.ascending,
                o.resolved_nulls_first(),
            )
            for o in self.partitioning.order
        ]

    def _materialize(
        self, kind: str, fn, child_parts: PartitionSet, ctx: ExecContext, rows=None,
        shared_bounds=None,
    ) -> list:
        """Every input batch bucketed into its output partitions, each slice
        registered in the spill catalog (a list of handles per partition).
        With ``rows`` (a list; the adaptive read passes one), each input
        batch also appends its slices' live-row counts as one int32
        ``[nparts]`` device tensor, so the sizes cross to the host later in
        one fetch. ``shared_bounds(sample_words, targets)`` (a multi-process
        range exchange) replaces the local bounds with ``(bounds,
        global_targets)`` agreed by every rank; it is called even when this
        rank has no rows."""
        from ..mem.spill import SpillPriorities, with_oom_retry

        catalog = ctx.catalog
        nparts = self.num_partitions
        buckets = [[] for _ in range(nparts)]

        def park(p: int, slices) -> None:
            """Whole batches into partition ``p`` ("single", a range
            exchange without bounds)."""
            if rows is not None:
                for s in slices:
                    one = torch.zeros(nparts, dtype=torch.int32, device=s.device)
                    one[p] = s.num_rows
                    rows.append(one)
            for s in slices:
                buckets[p].append(
                    catalog.register(s, SpillPriorities.INPUT_FROM_SHUFFLE, owner="exchange")
                )
        def park_all(slices) -> None:
            """One input batch's slices, slice p into partition p."""
            if rows is not None:
                rows.append(torch.stack([sl.num_rows.to(torch.int32) for sl in slices]))
            for p in range(nparts):
                buckets[p].append(
                    catalog.register(slices[p], SpillPriorities.INPUT_FROM_SHUFFLE, owner="exchange")
                )

        if kind == "range":
            order = self.partitioning.order
            batches, group_lists = [], []
            for t in child_parts.parts:
                for db in t():
                    batches.append(db)
                    group_lists.append(with_oom_retry(catalog, self._range_words, db))
                    del db
            # string columns may encode to different word counts per batch
            # (bucketed widths) — align before sampling/bucketing
            all_words, targets = align_word_groups(group_lists, order)
            del group_lists
            sample_words = None
            if batches:
                device = batches[0].device
                sample_words = _range_samples(batches, all_words, device)
            if shared_bounds is not None:
                bounds, gtargets = shared_bounds(sample_words, targets)
                if bounds is not None and gtargets != targets and batches:
                    # peers saw wider string keys: re-pad this rank's words
                    # to the agreed widths so rows and bounds compare
                    # word for word
                    all_words = [pad_flat_words(w, targets, gtargets, order) for w in all_words]
            else:
                bounds = None if sample_words is None else compute_range_bounds(sample_words, nparts)
            if not batches:
                return buckets
            if bounds is None:
                park(0, batches)
                return buckets
            dev_bounds = [torch.from_numpy(b).to(device) for b in bounds]
            batches.reverse()
            all_words.reverse()
            while batches:  # inputs free as they are bucketed
                slices = with_oom_retry(catalog, fn, batches.pop(), all_words.pop(), dev_bounds)
                park_all(slices)
                del slices
        elif kind == "hash":
            # drain every partition first (queues all upstream work), then
            # ONE row-count fetch for the shrink, then slice
            drained, _ = bulk_shrink([db for t in child_parts.parts for db in t()])
            drained.reverse()
            while drained:  # slices consume the list, so inputs free as we go
                slices = with_oom_retry(catalog, fn, drained.pop())
                park_all(slices)
                del slices
        elif kind == "single":
            # coalesce to one partition; shrink sparse batches (e.g.
            # ungrouped partial aggregates: 1 live row in a large capacity)
            drained, _ = bulk_shrink([db for t in child_parts.parts for db in t()])
            drained.reverse()
            while drained:
                park(0, [drained.pop()])
        else:  # roundrobin
            for pi, t in enumerate(child_parts.parts):
                # device-resident running offset: no host sync per batch
                offset = None
                for db in t():
                    if offset is None:
                        offset = torch.tensor(pi % nparts, dtype=torch.int64, device=db.device)
                    slices = with_oom_retry(catalog, fn, db, offset % nparts)
                    park_all(slices)
                    offset = offset + db.num_rows
                    del slices, db
        return buckets

    def execute(self, ctx: ExecContext) -> PartitionSet:
        # exchange reuse (plan/reuse.py): a node shared by several consumers
        # materializes once per query — the ReuseExchange analogue. A task
        # re-attempted from lineage, or a speculative duplicate, re-reads the
        # shared buckets (their handles stay registered until the query's
        # end); nothing materializes twice.
        if getattr(self, "_reuse_shared", False):
            with _REUSE_LOCK:  # one lock per shared node and query
                entry = ctx.reuse_cache.setdefault(id(self), [threading.Lock(), None])
            # the node's own lock, held while its subtree executes: a shared
            # exchange beneath takes its own, and a partition task that
            # reaches this node from a broadcast build waits for one set
            with entry[0]:
                if entry[1] is None:
                    entry[1] = self._execute_impl(ctx)
            return entry[1]
        return self._execute_impl(ctx)

    def _execute_impl(self, ctx: ExecContext) -> PartitionSet:
        from .. import config as cfg

        nparts = self.num_partitions
        kind = self._kind()
        mc = ctx.mesh
        if mc is not None and nparts == mc.n and kind != "single":
            from ..parallel.mesh import mesh_supported_schema

            if mesh_supported_schema(self.output):
                return self._execute_mesh(ctx, mc, kind)
        exchange_child = self.children[0]
        pre_filter = None
        if (
            isinstance(exchange_child, GpuFilterExec)
            and kind in ("hash", "range")
            and fusable_filter(exchange_child.condition)
        ):
            # fuse the filter into the bucketing: its rows fall out during
            # the partition sort, skipping the filter's own compaction.
            # Round-robin balances by row position, so a fused filter would
            # skew it; hash/range pids are value-based. Task-dependent and
            # error-raising filters keep their own run.
            pre_filter = exchange_child.condition
            exchange_child = exchange_child.children[0]
        fn = self._scatter_fn(kind, nparts, pre_filter)
        child_parts = exchange_child.execute(ctx)
        # A multi-process query (spark.rapids.shuffle.multiproc.*): this
        # executor maps only the child partitions its rank owns; peers map
        # the rest and serve them over the TCP transport. The topology is
        # the context's, frozen at the session's construction. A broadcast
        # build's subtree runs whole in every executor.
        managed = cfg.SHUFFLE_MANAGER_ENABLED.get(ctx.conf) and ctx.broadcast_depth == 0
        multiproc = managed and bool(ctx.mp_driver) and ctx.mp_size > 1
        if multiproc:
            size, rank = ctx.mp_size, ctx.mp_rank
            child_parts = PartitionSet(
                [t if i % size == rank else (lambda: iter(()))
                 for i, t in enumerate(child_parts.parts)]
            )
        # the shuffle id is minted HERE, in the single-threaded plan walk:
        # identical plans mint identical ids in every rank (minting inside
        # the partition threads would let the pool's order decide)
        base_sid = ctx.next_shuffle_id() if managed else None
        shared_bounds = None
        if multiproc and kind == "range":
            order = self.partitioning.order

            def shared_bounds(sample_words, targets):
                # every rank sees only its own child partitions, so per-rank
                # bounds would send one key range to different reduce
                # partitions: gather every rank's sample through the driver
                # and replay one deterministic merge
                payload = {
                    "targets": list(targets),
                    "words": [w.tolist() for w in (sample_words or [])],
                }
                contribs = ctx.shuffle_manager.registry.range_bounds_sync(
                    key=f"{base_sid}:range", rank=ctx.mp_rank, size=ctx.mp_size,
                    payload=payload,
                )
                merged, gtargets = merge_sampled_word_groups(contribs, order)
                if merged is None:
                    return None, None
                return compute_range_bounds(merged, nparts), gtargets

        adaptive = (
            not managed and cfg.ADAPTIVE_ENABLED.get(ctx.conf) and not self._aqe_disabled
        )
        state: dict = {}
        lock = threading.RLock()

        def materialize() -> list:
            with lock:
                if "buckets" not in state:
                    rows = [] if adaptive or managed else None
                    state["buckets"] = self._materialize(
                        kind, fn, child_parts, ctx, rows, shared_bounds
                    )
                    state["rows"] = rows
                return state["buckets"]

        def read(h):
            db = h.get_batch()
            h.unpin()  # spillable again once the reader lets go of it
            return db

        if managed:
            return self._managed_read(ctx, materialize, read, state, lock, base_sid, multiproc)

        if not adaptive:

            def make(p):
                def it():
                    for h in materialize()[p]:
                        db = read(h)
                        yield db
                        del db

                return it

            return PartitionSet([make(p) for p in range(nparts)])
        return self._adaptive_read(ctx, materialize, read, state, lock)

    def _managed_read(self, ctx: ExecContext, materialize, read, state: dict, lock,
                      base_sid: int, multiproc: bool) -> PartitionSet:
        """The accelerated shuffle path (the JAX package's
        ``exec/tpu.py:2441-2611``): the map side parks each partition's
        slices in the shuffle manager's spillable catalog and commits one
        MapStatus; readers go through the caching reader — local catalog
        hits, and in a multi-process query the peers' output fetched over
        TCP (the read waits for ``expected_maps`` statuses).

        Each (map, attempt) commit is atomic: a failed write aborts its
        partial blocks and the retry writes under the next attempt id. A
        lost map output (a peer gone, a fetch budget spent, the
        ``mapOutputLossEveryN`` fault) marks the generation released and
        raises ``MapOutputLostError``; the partition task's re-attempt then
        re-runs the map stage from lineage under the next generation's
        shuffle id, at most ``recovery.maxMapRecomputes`` times."""
        from .. import config as cfg

        nparts = self.num_partitions
        mp_size, mp_rank = ctx.mp_size, ctx.mp_rank
        mgr_state = {"shuffle_id": None, "generation": 0, "attempt": 0, "released": False}
        mgr_lock = threading.Lock()

        def ensure_written() -> int:
            with mgr_lock:
                if mgr_state["shuffle_id"] is not None:
                    return mgr_state["shuffle_id"]
                manager = ctx.shuffle_manager
                sid = base_sid + mgr_state["generation"] * 10_000
                writer = manager.get_writer(
                    sid, map_id=mp_rank if multiproc else 0, num_partitions=nparts,
                    attempt=mgr_state["attempt"],
                )
                try:
                    buckets = materialize()
                    with lock:
                        rows = state.get("rows") or []
                    # one fetch of every slice's live rows (slice i of
                    # partition p counts at rows[i][p]): an empty slice is
                    # not written, it would cost a frame per peer
                    counts = torch.stack(rows).cpu().tolist() if rows else []
                    for p, bucket in enumerate(buckets):
                        for i, h in enumerate(bucket):
                            if counts[i][p]:
                                db = read(h)
                                writer.write(p, db)
                                del db
                            h.close()  # the shuffle catalog holds it now
                    writer.commit()
                except BaseException:
                    # atomic per-(map, attempt) commit: drop THIS attempt's
                    # partial blocks and advance the attempt id, so the
                    # retry's re-write can never duplicate batches
                    writer.abort()
                    mgr_state["attempt"] += 1
                    raise
                finally:
                    with lock:
                        # the catalog owns the batches now; a regeneration
                        # re-runs the child pipeline
                        state.pop("buckets", None)
                mgr_state["shuffle_id"] = sid
                return sid

        consumed: set = set()

        def make(p):
            def it():
                from ..resilience import faults as _faults
                from ..shuffle.client import ShuffleFetchError
                from ..shuffle.manager import MapOutputLostError

                with mgr_lock:
                    if mgr_state["released"]:
                        # a task retry AFTER the map output was freed: re-run
                        # the map stage under the next generation's id
                        # (reading the freed id would commit zero rows)
                        mgr_state["shuffle_id"] = None
                        mgr_state["generation"] += 1
                        mgr_state["released"] = False
                        consumed.clear()
                sid = ensure_written()
                if multiproc and p % mp_size != mp_rank:
                    # a peer owns this reduce partition; this executor only
                    # had to contribute its map output
                    return
                manager = ctx.shuffle_manager
                if _faults.lose_map_output():
                    # chaos: the committed map output vanishes (peer death)
                    manager.unregister_shuffle(sid)

                def lost(cause):
                    if not cfg.RECOVERY_RECOMPUTE_ENABLED.get(ctx.conf):
                        raise cause
                    if mgr_state["generation"] >= cfg.RECOVERY_MAX_MAP_RECOMPUTES.get(ctx.conf):
                        raise cause
                    with mgr_lock:
                        if mgr_state["shuffle_id"] == sid and not mgr_state["released"]:
                            mgr_state["released"] = True
                            from ..obs.metrics import GLOBAL as _obs

                            _obs.counter("shuffle.recomputedPartitions").add(1)
                    raise MapOutputLostError(
                        f"shuffle {sid} partition {p}: map output lost ({cause}); "
                        f"recomputing from lineage under generation "
                        f"{mgr_state['generation'] + 1}"
                    ) from cause

                if not multiproc and not manager.registry.outputs_for(sid):
                    # a single-process read expects no maps, so an emptied
                    # registry would yield NOTHING; ensure_written always
                    # commits a status, so absence means loss
                    lost(MapOutputLostError(f"shuffle {sid}: no map outputs registered"))
                try:
                    yield from manager.get_reader().read_partitions(
                        sid, p, p + 1, expected_maps=mp_size if multiproc else 0,
                        device=ctx.device,
                    )
                except (ShuffleFetchError, TimeoutError) as e:
                    lost(e)
                # free the catalog-held map output once every partition is
                # drained (ShuffleBufferCatalog unregisterShuffle); a reused
                # exchange is drained once per consumer, and a multi-process
                # executor's peers fetch on their own clock
                with mgr_lock:
                    consumed.add(p)
                    done = (
                        len(consumed) == nparts
                        and not mgr_state["released"]
                        and mgr_state["shuffle_id"] == sid
                        and not getattr(self, "_reuse_shared", False)
                        and not multiproc
                    )
                    if done:
                        mgr_state["released"] = True
                if done:
                    manager.unregister_shuffle(sid)

            return it

        foreign = [p for p in range(nparts) if p % mp_size != mp_rank] if multiproc else ()
        return PartitionSet([make(p) for p in range(nparts)], foreign)

    def _pids(self, kind: str, batch: DeviceBatch, member: int, nparts: int) -> torch.Tensor:
        """Per-row partition ids of one member's batch (the JAX package's
        ``_pid_fns``) — no per-partition slicing: the mesh exchange
        scatters by them. Range ids come from ``_execute_mesh``."""
        c = Ctx.for_device(batch)
        if kind == "hash":
            cols = []
            for k in self.partitioning.keys:
                col = val_to_column(c, k.eval(c), k.data_type)
                cols.append((k.data_type, col.data, col.validity, col.lengths))
            return partition_ids(c.xp, murmur3_rows(c.xp, cols, batch.capacity), nparts)
        iota = torch.arange(batch.capacity, dtype=torch.int64, device=batch.device)
        return ((member + iota) % nparts).to(torch.int32)

    def _execute_mesh(self, ctx: ExecContext, mc, kind: str) -> PartitionSet:
        """The mesh exchange (the JAX package's ``_execute_mesh``,
        ``exec/tpu.py:2126-2230``): member i contributes child partitions
        j ≡ i (mod n), concatenated into one batch on its device; one mesh
        exchange re-partitions every member's rows; output partition i
        stays on member i. Range bounds come from one fetch of every
        member's samples."""
        from ..columnar.device import empty_batch as _empty
        from ..ops.gather import bulk_shrink
        from ..parallel.mesh import mesh_exchange, put_batch

        nparts = self.num_partitions
        schema = self.output
        child_parts = self.children[0].execute(ctx)
        state: dict = {}
        lock = threading.Lock()

        def materialize() -> list:
            with lock:
                if "out" in state:
                    return state["out"]
                n = mc.n
                lists: list = [[] for _ in range(n)]
                for j, t in enumerate(child_parts.parts):
                    lists[j % n].extend(t())
                flat = [db for l in lists for db in l]
                _, counts = bulk_shrink(flat) if flat else ([], [])
                per, at = [], 0
                for i, l in enumerate(lists):
                    k = len(l)
                    dev = mc.device_for(i)
                    if k:
                        b = concat_device([put_batch(db, dev) for db in l],
                                          counts=counts[at : at + k])
                    else:
                        b = _empty(schema, dev)
                    per.append(b)
                    at += k
                del lists, flat
                if kind == "range":
                    pids = self._mesh_range_pids(per, nparts)
                else:
                    pids = [self._pids(kind, b, i, nparts) for i, b in enumerate(per)]
                state["out"] = mesh_exchange(mc, schema, per, pids)
                return state["out"]

        def make(p):
            def it():
                yield materialize()[p]

            return it

        return PartitionSet([make(p) for p in range(nparts)])

    def _mesh_range_pids(self, per: list, nparts: int) -> list:
        order = self.partitioning.order
        all_words, _ = align_word_groups([self._range_words(b) for b in per], order)
        bounds = compute_range_bounds(_range_samples(per, all_words, per[0].device), nparts)
        if bounds is None:
            return [torch.zeros(b.capacity, dtype=torch.int32, device=b.device) for b in per]
        return [
            words_partition_ids(w, [torch.from_numpy(x).to(b.device) for x in bounds])
            for b, w in zip(per, all_words)
        ]

    def _adaptive_read(self, ctx: ExecContext, materialize, read, state: dict, lock) -> PartitionSet:
        """AQE partition coalescing + skew-join splitting
        (GpuCustomShuffleReaderExec / CoalescedPartitionSpec +
        OptimizeSkewedJoin analogues, the JAX package's adaptive branch):
        measured output sizes group adjacent small partitions into one
        reader slot, and — when this exchange feeds a shuffled join — an
        oversized partition is split across the freed slots while the
        peer's partition is replicated. The partition COUNT stays static
        (PartitionSets are fixed-arity); both join sides compute the SAME
        plan from the combined measurements, so positional pairing holds."""
        from .. import config as cfg

        nparts = self.num_partitions
        advisory = cfg.ADVISORY_PARTITION_SIZE.get(ctx.conf)
        skew_on = cfg.SKEW_JOIN_ENABLED.get(ctx.conf)
        skew_thresh = cfg.SKEW_JOIN_THRESHOLD.get(ctx.conf)
        skew_factor = cfg.SKEW_JOIN_FACTOR.get(ctx.conf)
        assign_lock = threading.Lock()

        def my_sizes() -> list:
            # LIVE-row bytes, not capacity bytes: bucket slices share the
            # input's padded capacity, which would make every bucket look
            # equally big and hide both small partitions and skew. One
            # fetch of every bucket count, memoized: both sides of a
            # linked join read each exchange's sizes.
            with lock:
                if "sizes" not in state:
                    materialize()
                    rows = state.pop("rows")
                    if rows:
                        counts = torch.stack(rows).to(torch.int64).sum(dim=0).cpu().tolist()
                        ctx.metrics["aqeSizeSyncs"] += 1
                    else:
                        counts = [0] * nparts
                    rb = _row_bytes(self.output)
                    state["sizes"] = [int(c) * rb for c in counts]
                return state["sizes"]

        ctx.aqe_size_providers[id(self)] = my_sizes

        def assignment() -> list:
            with assign_lock:
                if "assign" not in state:
                    state["assign"] = plan_assignment()
                return state["assign"]

        def plan_assignment() -> list:
            sizes = my_sizes()
            peer = self._aqe_peer
            if peer is None:
                assign, _ = _aqe_join_plan(sizes, [0] * nparts, nparts, advisory, (), 0, 0)
            else:
                peer_fn = ctx.aqe_size_providers.get(id(peer))
                if peer_fn is None:
                    # peer never took the AQE path: identity grouping
                    # preserves positional pairing
                    self.aqe_groups = nparts
                    return [[(p, 0, 1)] for p in range(nparts)]
                sides = (
                    _SPLITTABLE_SIDES.get(getattr(self, "_aqe_join_type", "inner"), ())
                    if skew_on
                    else ()
                )
                mine, theirs = sizes, peer_fn()
                if getattr(self, "_aqe_side", "left") == "left":
                    assign, _ = _aqe_join_plan(
                        mine, theirs, nparts, advisory, sides, skew_thresh, skew_factor
                    )
                else:
                    _, assign = _aqe_join_plan(
                        theirs, mine, nparts, advisory, sides, skew_thresh, skew_factor
                    )
            self.aqe_groups = sum(1 for a in assign if a)
            self.aqe_splits = sum(
                1 for slot in assign for (_, j, k) in slot if k > 1 and j == 0
            )
            return assign

        def make(p):
            def it():
                buckets = materialize()
                tok = ctx.cancel_token
                for src, j, k in assignment()[p]:
                    for h in buckets[src]:
                        if tok is not None:
                            tok.check()
                        db = read(h)
                        if k > 1:
                            db = _row_range_slice(db, j, k)
                        yield db
                        del db

            return it

        return PartitionSet([make(p) for p in range(nparts)])

    def node_string(self):
        return f"GpuShuffleExchange {self.partitioning} p={self.num_partitions}"


class GpuLimitExec(Exec):
    """CollectLimit on the device: one partition, the first ``n`` rows of
    the children's partitions in order (the JAX package's ``TpuLimitExec``).
    It fetches each batch's row count after the slice, to know when to stop
    — the JAX package's one sync per batch — and, as there, consumes each
    child partition through the dispatch-ahead pipeline
    (``exec/pipeline.py``) so those syncs hide the upstream's launches; the
    bounded window caps how far past the limit a producer runs before the
    early-exit close stops it."""

    def __init__(self, n: int, child: Exec):
        super().__init__([child])
        self.n = n

    @property
    def output(self) -> Schema:
        return self.children[0].output

    @property
    def is_device(self) -> bool:
        return True

    def execute(self, ctx: ExecContext) -> PartitionSet:
        from .pipeline import pipe_metrics, pipeline_conf, pipelined_partition

        limit = self.n
        child_parts = self.children[0].execute(ctx)
        pconf = pipeline_conf(ctx)
        metrics = pipe_metrics(self, ctx) if pconf is not None else None

        def it():
            remaining = limit
            tok = ctx.cancel_token

            def consume(src):
                nonlocal remaining
                for db in src:
                    if tok is not None:
                        tok.check()
                    if remaining <= 0:
                        return
                    out = slice_head(db, remaining)
                    n = out.row_count()
                    remaining -= n
                    if n:
                        yield out

            for t in child_parts.parts:
                yield from pipelined_partition(pconf, ctx, t(), consume, metrics)
                if remaining <= 0:
                    return

        return PartitionSet([it])

    def node_string(self):
        return f"GpuLimit n={self.n}"


# ── top-N and expand ────────────────────────────────────────────────────────

#: below this capacity the full sort is cheap enough that the candidate
#: pass's host sync would dominate (the JAX package's ``TOPK_MIN_CAPACITY``)
TOPK_MIN_CAPACITY = 1 << 15


def topn_candidates(batch: DeviceBatch, first: SortOrder, k: int):
    """(mask, count) of the live rows whose FIRST radix word ties or beats
    the k-th best — a superset of the true top-k (ties at the boundary are
    kept; later sort keys only reorder within first-word ties). The JAX
    package's ``TpuTakeOrderedAndProjectExec._candidate_fn``: the word is
    ``value_only`` (a leading validity word would make a {0, 1} threshold);
    nulls get the boundary key of their ordering, dead rows the largest."""
    c = Ctx.for_device(batch)
    live = batch.row_mask()
    col = val_to_column(c, first.child.eval(c), first.child.data_type)
    col = dc_replace(col, validity=col.validity & live)
    nulls_first = first.resolved_nulls_first()
    w0 = column_radix_words(col, first.ascending, nulls_first, value_only=True)[0]
    w0 = torch.where(col.validity, w0, WORD_MIN if nulls_first else WORD_MAX)
    w0 = torch.where(live, w0, WORD_MAX)
    kth = radix_select_kth(w0, min(k, int(w0.shape[0])))
    mask = live & (w0 <= kth)
    return mask, mask.sum(dtype=torch.int32)


class GpuTakeOrderedAndProjectExec(Exec):
    """Top-N on the device: per-partition sort + head(n), then a merged
    final sort + head(n) (reference: GpuTakeOrderedAndProjectExec,
    limit.scala) — the JAX package's ``TpuTakeOrderedAndProjectExec``.

    A large batch first keeps only the candidates of ``topn_candidates``
    when they fit in a quarter of its capacity: one host sync (the count)
    buys sorting the candidates instead of the whole batch. The candidates
    are gathered in row order, so the stable sort after them breaks ties as
    the full sort would. Each time that path is taken adds one to the
    query's ``topNCandidateHits`` counter."""

    def __init__(self, n: int, order: list, child: Exec):
        super().__init__([child])
        self.n = n
        self.order = [
            SortOrder(bind(o.child, child.output), o.ascending, o.nulls_first) for o in order
        ]
        self.prefilter_hits = 0  # observability: candidate fast path taken

    @property
    def output(self) -> Schema:
        return self.children[0].output

    @property
    def is_device(self) -> bool:
        return True

    def execute(self, ctx: ExecContext) -> PartitionSet:
        limit = self.n
        sort_fn = device_sort_fn(self.order)

        def topn(batches):
            if not batches:
                return None
            merged = batches[0] if len(batches) == 1 else concat_device(batches)
            cand_cap = bucket_capacity(max(4 * limit, 4096))
            if merged.capacity >= TOPK_MIN_CAPACITY and cand_cap <= merged.capacity // 4:
                mask, cnt = topn_candidates(merged, self.order[0], limit)
                if int(cnt) <= cand_cap:  # the one host sync
                    ctx.metrics["topNCandidateHits"] += 1
                    self.prefilter_hits += 1
                    # the candidates' rows in order, then the others: the
                    # first cand_cap hold every candidate
                    idx = first_k_positions(mask)[:cand_cap]
                    live = torch.arange(cand_cap, dtype=torch.int32, device=merged.device) < cnt
                    out = gather_batch(merged, idx, cnt)
                    cols = [dc_replace(c, validity=c.validity & live) for c in out.columns]
                    return slice_head(sort_fn(DeviceBatch(out.schema, cols, cnt)), limit)
            return slice_head(sort_fn(merged), limit)

        child_parts = self.children[0].execute(ctx)

        def it():
            partials = []
            for t in child_parts.parts:
                out = topn(list(t()))
                if out is not None:
                    partials.append(out)
            final = topn(partials)
            if final is not None:
                yield final

        return PartitionSet([it])

    def node_string(self):
        return f"GpuTakeOrderedAndProject n={self.n} [{', '.join(map(str, self.order))}]"


class GpuExpandExec(Exec):
    """Projection-list fan-out per batch (GpuExpandExec.scala), the JAX
    package's ``TpuExpandExec``: each projection gives one output batch of
    the input's capacity and row count."""

    def __init__(self, projections: list, names: list, child: Exec):
        from .cpu import expand_schema

        super().__init__([child])
        self.projections = [[bind(e, child.output) for e in proj] for proj in projections]
        self._schema = expand_schema(self.projections, names)

    @property
    def output(self) -> Schema:
        return self._schema

    @property
    def is_device(self) -> bool:
        return True

    def execute(self, ctx: ExecContext) -> PartitionSet:
        schema = self._schema

        def run(it):
            tok = ctx.cancel_token
            for batch in it:
                if tok is not None:
                    tok.check()
                c = Ctx.for_device(batch)
                live = batch.row_mask()
                for proj in self.projections:
                    cols = []
                    for e, f in zip(proj, schema):
                        col = val_to_column(c, e.eval(c), f.data_type)
                        cols.append(
                            dc_replace(col, dtype=f.data_type, validity=col.validity & live)
                        )
                    yield DeviceBatch(schema, cols, batch.num_rows)

        return self.children[0].execute(ctx).map_partitions(run)

    def node_string(self):
        return f"GpuExpand x{len(self.projections)}"


# ── generators and range ────────────────────────────────────────────────────


class GpuRangeExec(Exec):
    """Device-side sequence generation (GpuRangeExec,
    basicPhysicalOperators.scala; the JAX package's ``TpuRangeExec``): the
    ids are born on the device, with no upload."""

    def __init__(self, cpu_range):
        super().__init__([])
        self._cpu = cpu_range
        self._schema = cpu_range.output

    @property
    def output(self) -> Schema:
        return self._schema

    @property
    def is_device(self) -> bool:
        return True

    def execute(self, ctx: ExecContext) -> PartitionSet:
        from .. import config as cfg
        from ..types import LONG

        batch_rows = cfg.BATCH_SIZE_ROWS.get(ctx.conf)
        start, step, schema = self._cpu.start, self._cpu.step, self._schema
        device = ctx.device
        parts = []
        for lo, cnt in self._cpu.partition_bounds():
            def make(lo=lo, cnt=cnt):
                def it():
                    ctx.semaphore.acquire_if_necessary()
                    tok = ctx.cancel_token
                    done = 0
                    while done < cnt:
                        if tok is not None:
                            tok.check()
                        m = min(batch_rows, cnt - done)
                        cap = bucket_capacity(max(m, 1))
                        first = start + (lo + done) * step
                        iota = torch.arange(cap, dtype=torch.int64, device=device)
                        valid = iota < m
                        ids = torch.where(valid, first + step * iota, 0)
                        yield DeviceBatch(
                            schema,
                            [DeviceColumn(LONG, ids, valid)],
                            torch.tensor(m, dtype=torch.int32, device=device),
                        )
                        done += m

                return it()

            parts.append(make)
        return PartitionSet(parts)

    def node_string(self):
        c = self._cpu
        return f"GpuRange ({c.start}, {c.end}, step={c.step}, splits={c.num_partitions})"


class GpuGenerateExec(Exec):
    """explode/posexplode on the device (GpuGenerateExec.scala; the JAX
    package's ``TpuGenerateExec``). Output slot j maps to (row r_j, element
    p_j) by a ``searchsorted`` over the cumulative element counts — no
    scatter; the output capacity is bucketed from one host sync of the total
    element count per batch."""

    def __init__(self, cpu_gen, child: Exec):
        super().__init__([child])
        self.generator = cpu_gen.generator  # bound against the same schema
        self.out_names = cpu_gen.out_names
        self._schema = cpu_gen.output

    @property
    def output(self) -> Schema:
        return self._schema

    @property
    def is_device(self) -> bool:
        return True

    def _explode(self, batch: DeviceBatch) -> Optional[DeviceBatch]:
        from ..types import INT, MapType

        g = self.generator
        ct = g.child.data_type
        c = Ctx.for_device(batch)
        v = g.child.eval(c)
        live_rows = batch.row_mask() & c.broadcast_bool(v.valid)
        lengths = torch.where(live_rows, c.broadcast(v.lengths), 0).to(torch.int64)
        coff = torch.cumsum(lengths, 0)
        total = int(coff[-1])  # the one host sync: the output capacity
        if total == 0:
            return None
        out_cap = bucket_capacity(total)
        j = torch.arange(out_cap, dtype=torch.int64, device=batch.device)
        live = j < total
        r = torch.clamp(torch.searchsorted(coff, j, right=True), 0, batch.capacity - 1)
        prev = torch.where(r > 0, coff[torch.clamp(r - 1, min=0)], 0)
        p = j - prev
        out_cols = [gather_column(col, r, live) for col in batch.columns]
        if g.position:
            out_cols.append(DeviceColumn(INT, torch.where(live, p, 0).to(torch.int32), live))
        n_out = torch.tensor(total, dtype=torch.int32, device=batch.device)
        gctx = Ctx(c.xp, out_cap, True, [], n_out)
        if isinstance(ct, MapType):
            pairs = zip(v.children, (ct.key_type, ct.value_type))
        else:
            pairs = [(v.children[0], ct.element_type)]
        for plane, dt in pairs:
            out_cols.append(val_to_column(gctx, _plane_element(plane, r, p, live), dt))
        return DeviceBatch(self._schema, out_cols, n_out)

    def execute(self, ctx: ExecContext) -> PartitionSet:
        def run(it):
            tok = ctx.cancel_token
            for db in it:
                if tok is not None:
                    tok.check()
                out = self._explode(db)
                if out is not None:
                    yield out

        return self.children[0].execute(ctx).map_partitions(run)

    def node_string(self):
        return f"GpuGenerate {self.generator}"


def _plane_element(plane: DeviceColumn, r, p, live) -> Val:
    """Element (r_j, p_j) of a padded element plane as a Val."""
    W = plane.validity.shape[1]
    safe = torch.clamp(p, 0, W - 1)
    data = plane.data[r, safe]
    valid = plane.validity[r, safe] & live
    lengths = None
    if plane.lengths is not None:
        lengths = torch.where(live, plane.lengths[r, safe], 0)
    mask = live[:, None] if data.ndim == 2 else live
    return Val(torch.where(mask, data, torch.zeros((), dtype=data.dtype, device=data.device)),
               valid, lengths)
