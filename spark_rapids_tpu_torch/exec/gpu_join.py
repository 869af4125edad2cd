"""Device join operators: the shuffled and broadcast hash joins.

Reference: GpuShuffledHashJoinBase + GpuHashJoin.scala (build side coalesced
to a single batch, stream side batched — :165-362) and the per-version
GpuBroadcastHashJoinExec shims. The port of
``spark_rapids_tpu/exec/tpu_join.py``: ``GpuShuffledHashJoinExec``,
``GpuBroadcastExchangeExec``, ``GpuBroadcastHashJoinExec`` (all six hash-join
types, with the residual condition), ``null_extend_batch`` and the two
phases. The matcher is the sort-merge of ``ops/join.py``; the execution
contract is the reference's: build on the RIGHT side, stream the LEFT.
Output capacities come from ONE host sync per window of ``_PROBE_WINDOW``
probe batches (one fetch of their match totals), never one per batch. A
probe batch whose pairs would pass ``spark.rapids.sql.batchSizeBytes`` of
output is cut into runs of probe rows that fit (``_output_chunks``), as
spark-rapids' join gatherer cuts its output; the JAX package has no such
cut.

Memory and resilience: phase 1 runs under ``run_with_retry`` and splits
the probe batch under OOM, as in the JAX package
(``spark_rapids_tpu/exec/tpu_join.py:128-138``), and the cancel token is
checked once per probe batch (``:147-150``). The three memory bounds
compose with the split in this order: a split halves the probe batch
before phase 1, so each half enters the probe window as a batch of its own
(the window's byte bound counts the halves); the output cut then divides
each half's pairs at the batch size. The port goes further where the
card's real OOMs land (``PERF.md`` §6): phase 2 of each output chunk
spill-retries and then splits the chunk's probe rows in half, recursively
(each half's pairs counted in one sync); the build's concat and key sort
spill-retry; and once the query has handled a device OOM (its catalog's
``oom_handled``, set by the retry path) the window and the output cut close
at a quarter of the batch size, so a chain of joins holds a quarter as much
in flight. The flag is the query's own: another query's OOM never changes
this one's batch boundaries.

The build's key sort is made once per stream of probe batches
(``sort_build``); the JAX package sorts the build again for every probe
batch. Pairs and rows come out in the JAX package's order.

The nested-loop and cartesian joins (``GpuBroadcastNestedLoopJoinExec``,
``GpuCartesianProductExec``, ``chunk_device_batch``) are the JAX package's
``TpuBroadcastNestedLoopJoinExec`` and ``TpuCartesianProductExec``: the pair
space of a stream chunk and the build is a flat index ``k`` (``li = k //
m``, ``ri = k % m``) of at most ``MAX_PAIR_CAP`` pairs, both sides are
gathered, the condition is evaluated on the pairs, and the matches are
compacted; stream chunks are cut over the capacity, so there is no host
sync for their count. Unlike the JAX package, the build is first cut to
its live rows (one count fetch per join task), so a compacted build does
not multiply the pair space by its padding.

Under ``spark.sql.adaptive.enabled`` the shuffled join links its two
feeding exchanges (``_link_aqe_exchanges``) so both compute one coalesce
and skew-split plan, and tries the runtime broadcast switch first
(``_try_broadcast_switch``), both from the JAX package's
``exec/tpu_join.py:56-93, :265-346``.

In mesh mode the two sides of a join and the broadcast build meet on the
probe's device (``_colocate_with``, ``broadcast_batch_like``,
``_colocated``: the JAX package's ``exec/tpu_join.py:33-53, :424-438,
:578-593``), and the runtime broadcast switch stays off, as there.
"""
from __future__ import annotations

import threading
from typing import List, Optional

import torch

from .. import config as cfg
from ..columnar.device import (
    DeviceBatch,
    _empty_col,
    bucket_capacity,
    dc_replace,
    empty_batch,
)
from ..expr import Expression, bind
from ..expr.base import Ctx, Val
from ..ops.concat import concat_device
from ..ops.gather import compact, gather_column, row_counts, shrink_one
from ..ops.join import gather_pairs, join_output_schema, probe_bounds, sort_build
from ..plan.physical import Exec, ExecContext, PartitionSet
from ..resilience import retry as R
from ..types import Schema
from .gpu import _row_bytes, val_to_column

# probe batches whose phase-1 results may be held on the device at once
# while their match totals ride one batched sync (memory bound per stream);
# the window also closes once its batches hold spark.rapids.sql.batchSizeBytes
_PROBE_WINDOW = 8


def _link_aqe_exchanges(left: Exec, right: Exec, join_type: str = "inner") -> None:
    """Positional partition pairing requires both join inputs to share one
    AQE coalesce assignment. Find the shuffle exchange feeding each side
    (descending through batch-coalesce wrappers); link the pair so each
    computes the grouping from combined sizes, or disable coalescing when
    only one side is exchange-fed (the other side's partitioning is fixed).
    The join type rides along so the skew-split pass knows which side may
    be split (the other side is replicated — only legal when replication
    cannot emit unmatched rows). Spark parity: AQE applies identical
    CoalescedPartitionSpecs to both shuffle reads of a join
    (ShufflePartitionsUtil) and OptimizeSkewedJoin splits a skewed side
    while replicating the other."""
    from .gpu import GpuCoalesceBatchesExec, GpuShuffleExchangeExec

    def find(node: Exec):
        while True:
            if isinstance(node, GpuShuffleExchangeExec):
                return node
            if isinstance(node, GpuCoalesceBatchesExec):
                node = node.children[0]
                continue
            return None

    lex, rex = find(left), find(right)
    if lex is not None and rex is not None:
        lex._aqe_peer, rex._aqe_peer = rex, lex
        lex._aqe_side, rex._aqe_side = "left", "right"
        lex._aqe_join_type = rex._aqe_join_type = join_type
    else:
        for ex in (lex, rex):
            if ex is not None:
                ex._aqe_disabled = True


def _stream_probe_join(node, get_build, probe_thunk, jt, ctx, matched_acc=None):
    """One probe stream joined against one build batch — the loop under the
    shuffled and broadcast joins. ``get_build(probe)`` supplies the build
    batch at the first probe batch (a broadcast build replicated onto the
    probe's device in mesh mode), and a probe on another device than its
    build moves to it (``_colocate_with``); ``matched_acc['m']`` (when given) accumulates
    build-row match bits for right/full null-extension. OOM handling as in
    the module docstring."""
    build = prepared = None
    prepare, phase1 = node._phase1()
    phase2 = node._phase2()
    target = cfg.BATCH_SIZE_BYTES.get(ctx.conf)
    row_bytes = _row_bytes(node.output)
    catalog, policy, breaker = ctx.catalog, ctx.retry_policy, ctx.breaker
    op = node._breaker_op
    floor = max(2, policy.min_split_rows)
    it = iter(probe_thunk())

    def run_phase2(sub, build_order, lower, counts, total):
        """(probe rows, phase 2's result) of one output chunk, the chunk's
        probe rows halved while an OOM persists after the spills."""
        out_cap = bucket_capacity(max(total, 1))
        try:
            res = R.run_once(
                catalog,
                lambda b: phase2(build, b, build_order, lower, counts, out_cap),
                sub, policy, op=op, breaker=breaker,
            )
        except Exception as e:  # noqa: BLE001 - classified below
            if not R.is_oom_error(e) or not policy.split_enabled or sub.capacity <= floor:
                raise
            res = None
        if res is not None:
            yield sub, res
            return
        R.record("splits")
        h = sub.capacity // 2
        lo_total = int(counts[:h].sum())
        halves = R.split_batch(sub)
        del sub
        for part, sl, t in zip(halves, (slice(0, h), slice(h, None)), (lo_total, total - lo_total)):
            yield from run_phase2(part, build_order, lower[sl], counts[sl], t)

    tok = ctx.cancel_token
    while True:
        # up to _PROBE_WINDOW probe batches, or batchSizeBytes of them,
        # dispatch before ONE fetch of their match totals; the window bounds
        # the join's memory (every join of a chain holds one), and an
        # early-exiting consumer (a limit) stops after the current window
        cut = target // 4 if catalog.oom_handled else target
        max_rows = max(1, cut // row_bytes)
        window, held = [], 0
        for probe in it:
            if build is None:
                build = get_build(probe)
                prepared = R.run_once(catalog, prepare, build, policy, op=op, breaker=breaker)
            # mesh mode: the two sides can land on different devices when
            # only one side's exchange took the mesh path
            probe = _colocate_with(probe, build)
            window.extend(
                R.run_with_retry(
                    catalog, lambda b: (b, phase1(prepared, b)), probe, policy,
                    op=op, breaker=breaker,
                )
            )
            held += probe.size_bytes()
            del probe
            if len(window) >= _PROBE_WINDOW or held >= cut:
                break
        if not window:
            return
        # the output capacities are chosen on the host: one fetch a window
        totals = torch.stack([counts.sum() for _p, (_o, _l, counts) in window]).tolist()
        ctx.metrics["joinProbeSyncs"] += 1
        for i, total in enumerate(totals):
            if tok is not None:
                tok.check()
            probe, (build_order, lower, counts) = window[i]
            window[i] = None  # release as consumed
            chunks = _output_chunks(probe, lower, counts, int(total), max_rows, ctx)
            del probe, lower, counts
            for sub, sub_lower, sub_counts, sub_total in chunks:
                for part, (out, probe_matched, bmatch) in run_phase2(
                    sub, build_order, sub_lower, sub_counts, sub_total
                ):
                    if matched_acc is not None:
                        matched_acc["m"] = matched_acc["m"] | bmatch
                    # possibly-empty batches are yielded without a row-count sync
                    if jt in ("left", "full"):
                        unmatched = (~probe_matched) & part.row_mask()
                        yield node._null_extend(part, unmatched, "left")
                    del part, probe_matched, bmatch
                    yield out
                    del out
                del sub, sub_lower, sub_counts


def _output_chunks(probe: DeviceBatch, lower, counts, total: int, max_rows: int, ctx):
    """(probe rows, lower, counts, pairs) of each output batch of one probe
    batch: the whole batch when its ``total`` pairs fit in ``max_rows`` (the
    batch-size target over the output row's bytes), else runs of whole probe
    rows whose pairs fit (a row with more matches than that is a run of its
    own), as spark-rapids' join gatherer cuts its output to the target
    batch size. Pairs keep their order. Cutting costs two host syncs, made
    only for a batch over the target."""
    if total <= max_rows:
        yield probe, lower, counts, total
        return
    ends = torch.cumsum(counts.to(torch.int64), 0)
    targets = torch.arange(1, -(-total // max_rows), dtype=torch.int64, device=ends.device)
    cuts = torch.searchsorted(ends, targets * max_rows, right=True).tolist()
    bounds = [0] + sorted({c for c in cuts if 0 < c < probe.capacity}) + [probe.capacity]
    at = torch.tensor([b - 1 for b in bounds[1:]], dtype=torch.int64, device=ends.device)
    before = [0] + ends[at].tolist()
    ctx.metrics["joinProbeSyncs"] += 2
    for k, (a, b) in enumerate(zip(bounds[:-1], bounds[1:])):
        cap = bucket_capacity(b - a)
        idx = torch.arange(cap, dtype=torch.int64, device=ends.device) + a
        live = idx < b
        idx = torch.clamp(idx, max=probe.capacity - 1)
        sub = DeviceBatch(
            probe.schema,
            [gather_column(c, idx, live) for c in probe.columns],
            torch.clamp(probe.num_rows - a, 0, b - a).to(torch.int32),
        )
        yield sub, lower[idx], torch.where(live, counts[idx], 0), before[k + 1] - before[k]


def _make_phase1(left_keys: tuple, right_keys: tuple):
    """(prepare, phase1): ``prepare(build)`` evaluates and sorts the build's
    keys once; ``phase1(prepared, probe)`` gives (build_order, lower,
    counts) for one probe batch."""

    def prepare(build: DeviceBatch):
        bctx = Ctx.for_device(build)
        bcols = [val_to_column(bctx, k.eval(bctx), k.data_type) for k in right_keys]
        return sort_build(bcols, build.row_mask())

    def phase1(prepared, probe: DeviceBatch):
        build_order, sorted_cols, sorted_live = prepared
        pctx = Ctx.for_device(probe)
        pcols = [val_to_column(pctx, k.eval(pctx), k.data_type) for k in left_keys]
        lower, upper = probe_bounds(sorted_cols, sorted_live, pcols, probe.row_mask())
        return build_order, lower, upper - lower

    return prepare, phase1


def _matched(idx: torch.Tensor, live: torch.Tensor, n: int) -> torch.Tensor:
    """bool[n]: the rows ``idx`` names where ``live``; the dead pairs write
    a dropped extra slot (every write stores True, so repeats are harmless)."""
    flags = torch.zeros(n + 1, dtype=torch.bool, device=idx.device)
    flags[torch.where(live, idx, n)] = True
    return flags[:n]


def _make_phase2(out_schema: Schema, pair_schema: Schema, right_ords: tuple, jt: str, residual):
    """phase2(build, probe, build_order, lower, counts, out_cap) →
    (output batch, probe rows matched, build rows matched)."""

    def phase2(build: DeviceBatch, probe: DeviceBatch, build_order, lower, counts, out_cap: int):
        probe_idx, build_idx, pair_live, total = gather_pairs(
            build_order, lower, counts, probe.row_mask(), out_cap
        )
        lcols = [gather_column(c, probe_idx, pair_live) for c in probe.columns]
        rcols_all = [gather_column(c, build_idx, pair_live) for c in build.columns]
        live = pair_live
        if residual is not None:
            rctx = Ctx.for_device(DeviceBatch(pair_schema, lcols + rcols_all, total))
            rv = residual.eval(rctx)
            live = rctx.broadcast_bool(rv.data) & rv.full_valid(rctx) & pair_live
        # per-probe / per-build matched flags (for outer joins)
        probe_matched = _matched(probe_idx, live, probe.capacity)
        build_matched = _matched(build_idx, live, build.capacity)
        if jt in ("left_semi", "left_anti"):
            want = probe_matched if jt == "left_semi" else (~probe_matched & probe.row_mask())
            return compact(probe, want), probe_matched, build_matched
        cols = lcols + [rcols_all[i] for i in right_ords]
        # num_rows = full capacity: with a residual, live pairs are scattered
        # across the pair grid, so compact must see every slot
        out = DeviceBatch(
            out_schema,
            [dc_replace(c, validity=c.validity & live) for c in cols],
            torch.tensor(out_cap, dtype=torch.int32, device=probe.device),
        )
        return compact(out, live), probe_matched, build_matched

    return phase2


def null_extend_batch(
    out_schema: Schema,
    batch: DeviceBatch,
    keep: torch.Tensor,
    side: str,
    left_fields,
    right_fields,
    right_ordinals=None,
) -> DeviceBatch:
    """Rows of one join side with the other side's columns as NULLs."""
    sub = compact(batch, keep)
    cap, device = sub.capacity, sub.device
    if side == "left":  # left rows + null right
        cols = list(sub.columns) + [_empty_col(f.data_type, cap, device) for f in right_fields]
    else:  # null left + right rows
        ords = right_ordinals if right_ordinals is not None else range(len(batch.columns))
        cols = [_empty_col(f.data_type, cap, device) for f in left_fields] + [
            sub.columns[i] for i in ords
        ]
    return DeviceBatch(out_schema, cols, sub.num_rows)


class GpuShuffledHashJoinExec(Exec):
    """Equi-join of two co-partitioned sides: per partition, the right side
    concatenated into one build batch, the left side's batches streamed
    against it; right/full outer null-extend the unmatched build rows once
    the stream is done."""

    _breaker_op = "ShuffledHashJoinExec"

    def __init__(
        self,
        join_type: str,
        left_keys: List[Expression],
        right_keys: List[Expression],
        residual: Optional[Expression],
        left: Exec,
        right: Exec,
        drop_right_keys: Optional[List[str]] = None,
    ):
        super().__init__([left, right])
        self.join_type = join_type
        self.left_keys = [bind(k, left.output) for k in left_keys]
        self.right_keys = [bind(k, right.output) for k in right_keys]
        self.residual = residual
        self.drop_right_keys = drop_right_keys or []
        self._schema = join_output_schema(
            join_type, left.output.fields, right.output.fields, self.drop_right_keys
        )

    @property
    def output(self) -> Schema:
        return self._schema

    @property
    def is_device(self) -> bool:
        return True

    def _right_ordinals(self) -> List[int]:
        return [
            i
            for i, f in enumerate(self.children[1].output.fields)
            if f.name not in self.drop_right_keys
        ]

    def _phase1(self):
        return _make_phase1(tuple(self.left_keys), tuple(self.right_keys))

    def _phase2(self):
        left_exec, right_exec = self.children
        pair_schema = Schema(list(left_exec.output.fields) + list(right_exec.output.fields))
        residual = None if self.residual is None else bind(self.residual, pair_schema)
        return _make_phase2(
            self._schema, pair_schema, tuple(self._right_ordinals()), self.join_type, residual
        )

    def _null_extend(self, batch: DeviceBatch, keep: torch.Tensor, side: str) -> DeviceBatch:
        """Rows of one side with the other side's columns as NULLs."""
        left_exec, right_exec = self.children
        right_fields = [
            f for f in right_exec.output.fields if f.name not in self.drop_right_keys
        ]
        return null_extend_batch(
            self._schema,
            batch,
            keep,
            side,
            left_exec.output.fields,
            right_fields,
            self._right_ordinals(),
        )

    def _try_broadcast_switch(self, ctx: ExecContext):
        """AQE runtime join-strategy switch (Spark's DynamicJoinSelection +
        local shuffle reader; GpuCustomShuffleReaderExec analogue): when
        the build side's MEASURED map-output size fits the broadcast
        threshold, join every probe partition against ONE concatenated
        build table and read the probe side's exchange LOCALLY — its
        bucketing is skipped entirely. Returns ``(switched_partition_set |
        None, reusable_build_parts | None)`` — the second slot hands an
        already-executed build exchange back to the normal path so
        declining never materializes it twice."""
        from .gpu import GpuShuffleExchangeExec

        if ctx.mesh is not None or not cfg.ADAPTIVE_ENABLED.get(ctx.conf):
            return None, None
        # broadcast-build-right is only sound when unmatched BUILD rows
        # never surface (they would duplicate per probe partition)
        if self.join_type not in ("inner", "left", "left_semi", "left_anti"):
            return None, None
        left, right = self.children
        if not isinstance(right, GpuShuffleExchangeExec):
            return None, None
        thresh = cfg.ADAPTIVE_BROADCAST_THRESHOLD.get(ctx.conf)
        if thresh < 0:
            thresh = cfg.AUTO_BROADCAST_THRESHOLD.get(ctx.conf)
        if thresh < 0:
            return None, None
        rparts = right.execute(ctx)
        size_fn = ctx.aqe_size_providers.get(id(right))
        if size_fn is None:  # exchange didn't take the AQE path
            return None, rparts
        total = sum(size_fn())
        self.aqe_build_bytes = total
        # the measurement materialized the build side ON THIS thread; give
        # back the device-semaphore permit it took, or this thread holds a
        # task slot for the rest of the query and the partition tasks stall
        ctx.semaphore.release_if_necessary()
        if total > thresh:
            # declined: hand the already-executed build partitions back so
            # the normal path doesn't materialize the exchange twice
            return None, rparts
        self.aqe_broadcast_switched = True
        # local shuffle read: bypass the probe exchange's bucketing (the
        # broadcast build holds every key, so co-partitioning is moot)
        probe_src = left.children[0] if isinstance(left, GpuShuffleExchangeExec) else left
        lparts = probe_src.execute(ctx)
        jt = self.join_type
        bstate: dict = {}
        block = threading.Lock()

        def build_once(_probe=None) -> DeviceBatch:
            with block:
                if "b" not in bstate:
                    from ..mem.spill import with_oom_retry

                    batches = [db for p in rparts.parts for db in p()]
                    bstate["b"] = (
                        with_oom_retry(ctx.catalog, concat_device, batches)
                        if batches
                        else empty_batch(right.output, ctx.device)
                    )
                return bstate["b"]

        def make(lt):
            def it():
                yield from _stream_probe_join(self, build_once, lt, jt, ctx)

            return it

        return PartitionSet([make(lt) for lt in lparts.parts]), None

    def execute(self, ctx: ExecContext) -> PartitionSet:
        left, right = self.children
        # link BEFORE any side executes: the AQE coalesce/skew assignment
        # must see its peer even when the broadcast-switch probe below
        # executes the build exchange first (and then declines)
        _link_aqe_exchanges(left, right, self.join_type)
        switched, reuse_rparts = self._try_broadcast_switch(ctx)
        if switched is not None:
            return switched
        lparts = left.execute(ctx)
        rparts = reuse_rparts if reuse_rparts is not None else right.execute(ctx)
        assert lparts.num_partitions == rparts.num_partitions, (
            f"{lparts.num_partitions} vs {rparts.num_partitions}"
        )
        jt = self.join_type

        def make(lt, rt):
            def it():
                from ..mem.spill import with_oom_retry

                bbatches = list(rt())
                build = (
                    with_oom_retry(ctx.catalog, concat_device, bbatches)
                    if bbatches
                    else empty_batch(right.output, ctx.device)
                )
                del bbatches
                acc = None
                if jt in ("right", "full"):
                    acc = {"m": torch.zeros(build.capacity, dtype=torch.bool, device=build.device)}
                yield from _stream_probe_join(self, lambda _p: build, lt, jt, ctx, acc)
                if acc is not None:
                    unmatched = (~acc["m"]) & build.row_mask()
                    yield self._null_extend(build, unmatched, "right")

            return it

        return PartitionSet([make(lt, rt) for lt, rt in zip(lparts.parts, rparts.parts)])

    def node_string(self):
        return (
            f"GpuShuffledHashJoin {self.join_type} "
            f"[{', '.join(map(str, self.left_keys))}] [{', '.join(map(str, self.right_keys))}]"
        )


def _colocate_with(batch: DeviceBatch, anchor: DeviceBatch) -> DeviceBatch:
    """``batch`` on ``anchor``'s device when they differ (mesh mode can mix
    mesh-exchanged and single-device join inputs); a device check only
    otherwise. The JAX package's ``exec/tpu_join.py::_colocate_with``."""
    if batch.device == anchor.device:
        return batch
    from ..parallel.mesh import put_batch

    return put_batch(batch, anchor.device)


def _colocated(anchor: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``t`` on ``anchor``'s device (per-partition match masks of partitions
    placed on different mesh members); the JAX package's ``_colocated``."""
    return t if t.device == anchor.device else t.to(anchor.device)


def broadcast_batch_like(build: DeviceBatch, peer: DeviceBatch, state: dict,
                         lock: threading.Lock) -> DeviceBatch:
    """Mesh mode: the broadcast build replicated onto ``peer``'s device (the
    in-process analogue of a broadcast re-materializing per executor), one
    copy per device kept in ``state``; the build itself when they share a
    device. The JAX package's ``broadcast_batch_like``."""
    if build.device == peer.device:
        return build
    from ..parallel.mesh import put_batch

    with lock:
        cache = state.setdefault("replicas", {})
        if peer.device not in cache:
            cache[peer.device] = put_batch(build, peer.device)
        return cache[peer.device]


def _broadcast_once(node: Exec, state: dict, lock: threading.Lock, ctx: ExecContext) -> DeviceBatch:
    """The whole of ``node``'s output as one device batch, built once per
    state under its lock."""
    with lock:
        if "b" not in state:
            # a multi-process query runs a broadcast's subtree WHOLE in every
            # executor (no rank split below it)
            ctx.broadcast_depth += 1
            try:
                parts = node.execute(ctx)
                batches = [b for t in parts.parts for b in t()]
            finally:
                ctx.broadcast_depth -= 1
            state["b"] = (
                concat_device(batches) if batches else empty_batch(node.output, ctx.device)
            )
        return state["b"]


class GpuBroadcastExchangeExec(Exec):
    """Build side collected once to a single device batch shared by all join
    tasks (GpuBroadcastExchangeExecBase:238; in-process, the serialize/
    JVM-broadcast/deserialize round trip collapses to one cached batch)."""

    def __init__(self, child: Exec):
        super().__init__([child])
        self._state: dict = {}
        self._lock = threading.Lock()

    @property
    def output(self) -> Schema:
        return self.children[0].output

    @property
    def is_device(self) -> bool:
        return True

    def execute(self, ctx: ExecContext) -> PartitionSet:
        def it():
            yield _broadcast_once(self.children[0], self._state, self._lock, ctx)

        return PartitionSet([it])

    def node_string(self):
        return "GpuBroadcastExchange"


class GpuBroadcastHashJoinExec(GpuShuffledHashJoinExec):
    """Hash join with a broadcast build (right) side: stream partitions stay
    put, each joins the one broadcast batch (GpuBroadcastHashJoinExec shims).
    The build is the right child's whole output, one batch per execution.

    right/full outer need BUILD-side null-extension: unmatched build rows
    must surface exactly ONCE even though every stream partition probes the
    same broadcast batch. Each partition accumulates its build match bits on
    the device; the LAST partition to finish ORs them and emits the
    unmatched tail. A partition abandoned early (its consumer stopped, e.g.
    a satisfied limit) skips the tail via GeneratorExit, which is sound:
    every consumer had stopped wanting rows."""

    _breaker_op = "BroadcastHashJoinExec"

    def execute(self, ctx: ExecContext) -> PartitionSet:
        left, right = self.children
        lparts = left.execute(ctx)
        jt = self.join_type
        bstate: dict = {}
        block = threading.Lock()

        def build() -> DeviceBatch:
            return _broadcast_once(right, bstate, block, ctx)

        def build_like(probe: DeviceBatch) -> DeviceBatch:
            return broadcast_batch_like(build(), probe, bstate, block)

        if jt not in ("right", "full"):
            def make(lt):
                def it():
                    yield from _stream_probe_join(self, build_like, lt, jt, ctx)

                return it

            return PartitionSet([make(lt) for lt in lparts.parts])

        state = {"remaining": len(lparts.parts), "mask": None, "emitted": False}
        lock = threading.Lock()

        def make_outer(lt):
            def it():
                seen = {}

                def get_build(probe):
                    b = seen["b"] = build_like(probe)
                    if "m" not in acc:
                        acc["m"] = torch.zeros(b.capacity, dtype=torch.bool, device=b.device)
                    return b

                acc: dict = {}
                done = False
                abandoned = False
                try:
                    yield from _stream_probe_join(self, get_build, lt, jt, ctx, acc)
                    done = True
                except GeneratorExit:
                    # consumer stopped wanting rows (e.g. satisfied limit):
                    # this partition is FINISHED for tail purposes
                    abandoned = True
                    raise
                finally:
                    with lock:
                        # the OR stays on the device: no sync per partition;
                        # a mask from a partition on another mesh member
                        # moves to the accumulator's device first
                        if "m" in acc:
                            prev = state["mask"]
                            state["mask"] = (
                                acc["m"] if prev is None else prev | _colocated(prev, acc["m"])
                            )
                        # decrement once per FINISHED partition
                        last = False
                        if done or abandoned:
                            state["remaining"] -= 1
                            last = state["remaining"] == 0 and not state["emitted"]
                            if last:
                                state["emitted"] = True
                    if last and done:
                        b = seen.get("b") or build()
                        rm = b.row_mask()
                        mask = state["mask"]
                        if mask is None:
                            mask = torch.zeros(b.capacity, dtype=torch.bool, device=b.device)
                        unmatched = (~_colocated(rm, mask)) & rm
                        yield self._null_extend(b, unmatched, "right")

            return it

        return PartitionSet([make_outer(lt) for lt in lparts.parts])

    def node_string(self):
        return (
            f"GpuBroadcastHashJoin {self.join_type} "
            f"[{', '.join(map(str, self.left_keys))}]"
        )


def chunk_device_batch(db: DeviceBatch, rows: int):
    """Slice a device batch into static sub-batches of at most ``rows`` rows
    (shared by the nested-loop and cartesian pair loops). Chunks are cut
    over the capacity, not the live-row count: the count is a device scalar,
    so there is no host sync; a tail chunk past the live rows is empty."""
    if db.capacity <= rows:
        yield db
        return
    for lo in range(0, db.capacity, rows):
        idx = torch.arange(rows, dtype=torch.int64, device=db.device) + lo
        live = idx < db.num_rows
        idx = torch.clamp(idx, max=db.capacity - 1)
        cols = [gather_column(c, idx, live) for c in db.columns]
        yield DeviceBatch(
            db.schema,
            cols,
            torch.clamp(db.num_rows - lo, 0, rows).to(torch.int32),
        )


def pair_fn(out_schema: Schema, condition, jt: str):
    """The pair kernel of the nested-loop and cartesian joins (the JAX
    package's ``_make_pair_kernel``): ``fn(lb, rb)`` → (matched pairs
    compacted, or None for semi/anti; left rows matched; right rows
    matched)."""

    def fn(lb: DeviceBatch, rb: DeviceBatch):
        n, m = lb.capacity, rb.capacity
        cap = n * m
        k = torch.arange(cap, dtype=torch.int64, device=lb.device)
        li = torch.div(k, m, rounding_mode="floor")
        ri = k % m
        pair_live = (li < lb.num_rows) & (ri < rb.num_rows)
        lcols = [gather_column(c, li, pair_live) for c in lb.columns]
        rcols = [gather_column(c, ri, pair_live) for c in rb.columns]
        live = pair_live
        if condition is not None:
            from ..xp import namespace

            cctx = Ctx(
                namespace(lb.device),
                cap,
                True,
                [Val(c.data, c.validity, c.lengths) for c in lcols + rcols],
                live.sum().to(torch.int32),
            )
            cv = condition.eval(cctx)
            live = cctx.broadcast_bool(cv.data) & cv.full_valid(cctx) & pair_live
        # matched flags per side row (outer/semi/anti bookkeeping)
        left_matched = _matched(li, live, n)
        right_matched = _matched(ri, live, m)
        if jt in ("left_semi", "left_anti"):
            return None, left_matched, right_matched
        # num_rows = cap: live pairs are scattered over the [n x m] grid and
        # compact intersects its keep mask with row_mask
        out = DeviceBatch(
            out_schema,
            [dc_replace(c, validity=c.validity & live) for c in lcols + rcols],
            torch.tensor(cap, dtype=torch.int32, device=lb.device),
        )
        return compact(out, live), left_matched, right_matched

    return fn


def _build_batch(parts, schema: Schema, ctx: ExecContext) -> DeviceBatch:
    """The build side of a pair loop as one batch, tight to its live rows.
    Each stream chunk's pair space is its rows times the build's capacity,
    and a build that was compacted (a filter, an aggregate) can keep few
    live rows in a large capacity; so its counts are fetched once (one host
    sync per join task) and the build cut to them. The JAX package pairs
    against the full capacity."""
    batches = [b for t in parts for b in t()]
    if not batches:
        return empty_batch(schema, ctx.device)
    counts = row_counts(batches)
    if len(batches) == 1:
        return shrink_one(batches[0], counts[0])
    return concat_device(batches, counts=counts)


class GpuBroadcastNestedLoopJoinExec(Exec):
    """Cross / conditional (non-equi) join on the device.

    Reference: GpuBroadcastNestedLoopJoinExec.scala (Table.crossJoin +
    condition filter). The right side is built into one batch; the stream
    side (coalesced to one partition by the planner) is chunked so each
    chunk's pair space stays under ``MAX_PAIR_CAP``."""

    MAX_PAIR_CAP = 1 << 20

    def __init__(self, join_type: str, condition: Optional[Expression], left: Exec, right: Exec):
        super().__init__([left, right])
        self.join_type = join_type
        self._schema = join_output_schema(join_type, left.output.fields, right.output.fields)
        self.condition = (
            bind(condition, Schema(list(left.output.fields) + list(right.output.fields)))
            if condition is not None
            else None
        )

    @property
    def output(self) -> Schema:
        return self._schema

    @property
    def is_device(self) -> bool:
        return True

    def _null_extend(self, batch: DeviceBatch, keep: torch.Tensor, side: str) -> DeviceBatch:
        left, right = self.children
        return null_extend_batch(
            self._schema, batch, keep, side, left.output.fields, right.output.fields
        )

    @classmethod
    def _stream_rows(cls, build_capacity: int) -> int:
        """Power-of-two stream-side chunk rows for a build of this size."""
        lrows = max(1, cls.MAX_PAIR_CAP // max(build_capacity, 1))
        p = 1
        while p * 2 <= lrows:
            p *= 2
        return p

    def execute(self, ctx: ExecContext) -> PartitionSet:
        left, right = self.children
        lparts = left.execute(ctx)
        kernel = pair_fn(self._schema, self.condition, self.join_type)
        jt = self.join_type

        def make(lt):
            def it():
                build = _build_batch(right.execute(ctx).parts, right.output, ctx)
                lrows = self._stream_rows(build.capacity)
                build_matched = torch.zeros(build.capacity, dtype=torch.bool, device=build.device)
                tok = ctx.cancel_token
                for stream in lt():
                    if tok is not None:
                        tok.check()
                    for lb in chunk_device_batch(stream, lrows):
                        out, lmatch, rmatch = kernel(lb, build)
                        build_matched = build_matched | rmatch
                        if jt in ("left_semi", "left_anti"):
                            want = lmatch if jt == "left_semi" else (~lmatch & lb.row_mask())
                            yield compact(lb, want)
                            continue
                        if jt in ("left", "full"):
                            unmatched = (~lmatch) & lb.row_mask()
                            yield self._null_extend(lb, unmatched, "left")
                        yield out
                if jt in ("right", "full"):
                    unmatched = (~build_matched) & build.row_mask()
                    yield self._null_extend(build, unmatched, "right")

            return it

        return PartitionSet([make(lt) for lt in lparts.parts])

    def node_string(self):
        return f"GpuBroadcastNestedLoopJoin {self.join_type} {self.condition or ''}"


class GpuCartesianProductExec(GpuBroadcastNestedLoopJoinExec):
    """Pairwise-partition cross join (GpuCartesianProductExec.scala:349):
    one task per (left, right) partition pair, each crossing its pair
    through the same pair kernel. Only cross/inner shapes plan here; the
    outer variants need global matched-set bookkeeping and take the
    nested-loop join, as in the reference."""

    def __init__(self, condition: Optional[Expression], left: Exec, right: Exec):
        super().__init__("inner", condition, left, right)

    def execute(self, ctx: ExecContext) -> PartitionSet:
        left, right = self.children
        lparts = left.execute(ctx)
        rparts = right.execute(ctx)
        kernel = pair_fn(self._schema, self.condition, "inner")

        def make(lt, rt):
            def it():
                build = _build_batch([rt], right.output, ctx)
                p = self._stream_rows(build.capacity)
                tok = ctx.cancel_token
                for stream in lt():
                    if tok is not None:
                        tok.check()
                    for lb in chunk_device_batch(stream, p):
                        yield kernel(lb, build)[0]

            return it

        return PartitionSet([make(lt, rt) for lt in lparts.parts for rt in rparts.parts])

    def node_string(self):
        return f"GpuCartesianProduct {self.condition or ''}"
