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
probe batches (one fetch of their match totals), never one per batch.

The build's key sort is made once per stream of probe batches
(``sort_build``); the JAX package sorts the build again for every probe
batch. Pairs and rows come out in the JAX package's order.

Left out of the port so far, each with its place in ROADMAP.md: the AQE
runtime broadcast switch and exchange linking (item 16), the mesh placement
of the two sides (item 13), the OOM retry around phase 1 (item 11), the
cancel token (item 12), and the device nested-loop and cartesian joins,
which stay on the CPU engine with their reason in the explain.
"""
from __future__ import annotations

import threading
from itertools import islice
from typing import List, Optional

import torch

from ..columnar.device import (
    DeviceBatch,
    _empty_col,
    bucket_capacity,
    dc_replace,
    empty_batch,
)
from ..expr import Expression, bind
from ..expr.base import Ctx
from ..ops.concat import concat_device
from ..ops.gather import compact, gather_column
from ..ops.join import gather_pairs, join_output_schema, probe_bounds, sort_build
from ..plan.physical import Exec, ExecContext, PartitionSet
from ..types import Schema
from .gpu import val_to_column

# probe batches whose phase-1 results may be held on the device at once
# while their match totals ride one batched sync (memory bound per stream)
_PROBE_WINDOW = 8


def _stream_probe_join(node, get_build, probe_thunk, jt, ctx, matched_acc=None):
    """One probe stream joined against one build batch — the loop under the
    shuffled and broadcast joins. ``get_build()`` supplies the build batch
    at the first probe batch; ``matched_acc['m']`` (when given) accumulates
    build-row match bits for right/full null-extension."""
    build = prepared = None
    prepare, phase1 = node._phase1()
    phase2 = node._phase2()
    it = iter(probe_thunk())
    while True:
        # up to _PROBE_WINDOW probe batches dispatch before ONE fetch of
        # their match totals; the window bounds the join's memory, and an
        # early-exiting consumer (a limit) stops after the current window
        window = []
        for probe in islice(it, _PROBE_WINDOW):
            if build is None:
                build = get_build()
                prepared = prepare(build)
            window.append((probe, phase1(prepared, probe)))
        if not window:
            return
        # the output capacities are chosen on the host: one fetch a window
        totals = torch.stack([counts.sum() for _p, (_o, _l, counts) in window]).tolist()
        ctx.metrics["joinProbeSyncs"] += 1
        for i, total in enumerate(totals):
            probe, (build_order, lower, counts) = window[i]
            window[i] = None  # release as consumed
            out_cap = bucket_capacity(max(int(total), 1))
            out, probe_matched, bmatch = phase2(build, probe, build_order, lower, counts, out_cap)
            if matched_acc is not None:
                matched_acc["m"] = matched_acc["m"] | bmatch
            # possibly-empty batches are yielded without a row-count sync
            if jt in ("left", "full"):
                unmatched = (~probe_matched) & probe.row_mask()
                yield node._null_extend(probe, unmatched, "left")
            yield out


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

    def execute(self, ctx: ExecContext) -> PartitionSet:
        left, right = self.children
        lparts = left.execute(ctx)
        rparts = right.execute(ctx)
        assert lparts.num_partitions == rparts.num_partitions, (
            f"{lparts.num_partitions} vs {rparts.num_partitions}"
        )
        jt = self.join_type

        def make(lt, rt):
            def it():
                bbatches = list(rt())
                build = (
                    concat_device(bbatches)
                    if bbatches
                    else empty_batch(right.output, ctx.device)
                )
                acc = None
                if jt in ("right", "full"):
                    acc = {"m": torch.zeros(build.capacity, dtype=torch.bool, device=build.device)}
                yield from _stream_probe_join(self, lambda: build, lt, jt, ctx, acc)
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


def _broadcast_once(node: Exec, state: dict, lock: threading.Lock, ctx: ExecContext) -> DeviceBatch:
    """The whole of ``node``'s output as one device batch, built once per
    state under its lock."""
    with lock:
        if "b" not in state:
            parts = node.execute(ctx)
            batches = [b for t in parts.parts for b in t()]
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

    def execute(self, ctx: ExecContext) -> PartitionSet:
        left, right = self.children
        lparts = left.execute(ctx)
        jt = self.join_type
        bstate: dict = {}
        block = threading.Lock()

        def build() -> DeviceBatch:
            return _broadcast_once(right, bstate, block, ctx)

        if jt not in ("right", "full"):
            def make(lt):
                def it():
                    yield from _stream_probe_join(self, build, lt, jt, ctx)

                return it

            return PartitionSet([make(lt) for lt in lparts.parts])

        state = {"remaining": len(lparts.parts), "mask": None, "emitted": False}
        lock = threading.Lock()

        def make_outer(lt):
            def it():
                b = build()
                acc = {"m": torch.zeros(b.capacity, dtype=torch.bool, device=b.device)}
                done = False
                abandoned = False
                try:
                    yield from _stream_probe_join(self, lambda: b, lt, jt, ctx, acc)
                    done = True
                except GeneratorExit:
                    # consumer stopped wanting rows (e.g. satisfied limit):
                    # this partition is FINISHED for tail purposes
                    abandoned = True
                    raise
                finally:
                    with lock:
                        # the OR stays on the device: no sync per partition
                        prev = state["mask"]
                        state["mask"] = acc["m"] if prev is None else prev | acc["m"]
                        # decrement once per FINISHED partition
                        last = False
                        if done or abandoned:
                            state["remaining"] -= 1
                            last = state["remaining"] == 0 and not state["emitted"]
                            if last:
                                state["emitted"] = True
                    if last and done:
                        unmatched = (~state["mask"]) & b.row_mask()
                        yield self._null_extend(b, unmatched, "right")

            return it

        return PartitionSet([make_outer(lt) for lt in lparts.parts])

    def node_string(self):
        return (
            f"GpuBroadcastHashJoin {self.join_type} "
            f"[{', '.join(map(str, self.left_keys))}]"
        )
