"""CPU join operators — oracle and per-node fallback for the join family.

Reference: GpuHashJoin.scala (Table.innerJoin/leftJoin over key columns with
null-key filtering, :282), GpuShuffledHashJoinBase, GpuBroadcastNestedLoop
JoinExec. Spark join-key semantics: NULL keys never match (unlike grouping);
NaN keys DO match each other and -0.0 == 0.0 (Spark normalizes join keys).

Copied from ``spark_rapids_tpu/exec/cpu_join.py`` with the host currency
changed to the port's numpy ``HostBatch``. The JAX package matches keys by
stacking them into object arrays and a Python dict; here each key becomes
int64 words (``ops/sortkeys.py::np_column_radix_words``: normalized float
bits, strings padded to one width on both sides), and rows match by a
stable sort of the build side and ``searchsorted`` — the device join's
sort-merge, in numpy. Pairs come out in the same order as the JAX CPU
engine's: probe-major, and within a probe row in build row order.
"""
from __future__ import annotations

import threading
from typing import List, Optional

import numpy as np

from ..columnar.host import HostBatch, HostColumn, concat_batches
from ..expr import Expression, UnresolvedAttribute, bind
from ..ops.hash import np_strings_to_padded
from ..ops.join import join_output_schema
from ..ops.sortkeys import np_column_radix_words
from ..plan.physical import Exec, ExecContext, PartitionSet
from ..types import DataType, Schema, StringType
from .cpu import _cpu_ctx, _val_to_np


def _eval_keys(keys: List[Expression], rb: HostBatch, schema: Schema) -> tuple:
    """[(type, data, validity)] of each key over one batch, and the rows
    whose keys are all non-null."""
    c = _cpu_ctx(rb, schema)
    vals = []
    all_valid = np.ones(rb.num_rows, dtype=bool)
    for k in keys:
        d, v = _val_to_np(c, k.eval(c))
        all_valid &= v
        vals.append((k.data_type, d, v))
    return vals, all_valid


def _side_words(dt: DataType, d, v) -> list:
    """The value words of one key column (no validity word: rows with a null
    key are left out of the match)."""
    if isinstance(dt, StringType):
        plane, lengths = d
        return np_column_radix_words(dt, plane, v, lengths)[1:]
    return np_column_radix_words(dt, d, v)[1:]


def _codes(lvals: list, rvals: list, lrows, rrows) -> tuple:
    """One int64 code per candidate row of each side, equal exactly where
    every key is equal: the single word itself, or for several words a
    dense rank over both sides (one ``np.lexsort``). String keys are padded
    to one width on both sides, so equal strings give equal words."""
    lw: list = []
    rw: list = []
    for (dt, ld, lv), (_, rd, rv) in zip(lvals, rvals):
        if isinstance(dt, StringType):
            lp, rp = np_strings_to_padded(ld, lv), np_strings_to_padded(rd, rv)
            width = max(lp[0].shape[1], rp[0].shape[1])
            ld, rd = [
                (np.pad(p, ((0, 0), (0, width - p.shape[1]))), lens) for p, lens in (lp, rp)
            ]
        lw.extend(w[lrows] for w in _side_words(dt, ld, lv))
        rw.extend(w[rrows] for w in _side_words(dt, rd, rv))
    if len(lw) == 1:
        return lw[0], rw[0]
    words = [np.concatenate([a, b]) for a, b in zip(lw, rw)]
    order = np.lexsort(words[::-1])
    starts = np.zeros(len(order), dtype=bool)
    if len(order):
        starts[0] = True
        for w in words:
            sw = w[order]
            starts[1:] |= sw[1:] != sw[:-1]
    codes = np.empty(len(order), dtype=np.int64)
    codes[order] = np.cumsum(starts) - 1
    return codes[: len(lrows)], codes[len(lrows):]


def match_pairs(lvals, lvalid, rvals, rvalid) -> tuple:
    """(left row, right row) index arrays of every key-equal pair, left-major
    and, within a left row, in right row order. Rows with a null key match
    nothing."""
    lrows = np.flatnonzero(lvalid)
    rrows = np.flatnonzero(rvalid)
    lcode, rcode = _codes(lvals, rvals, lrows, rrows)
    order = np.argsort(rcode, kind="stable")
    sorted_codes = rcode[order]
    lower = np.searchsorted(sorted_codes, lcode, side="left")
    counts = np.searchsorted(sorted_codes, lcode, side="right") - lower
    total = int(counts.sum())
    li = np.repeat(lrows, counts)
    starts = np.repeat(np.cumsum(counts) - counts, counts)
    within = np.arange(total, dtype=np.int64) - starts
    ri = rrows[order[np.repeat(lower, counts) + within]]
    return li.astype(np.int64), ri.astype(np.int64)


def _null_column(dt: DataType, n: int) -> HostColumn:
    from ..columnar.host import column_from_pylist
    from ..types import is_complex

    if is_complex(dt):
        return column_from_pylist([None] * n, dt)
    if isinstance(dt, StringType):
        return HostColumn(dt, np.zeros(0, np.uint8), np.zeros(n, bool), np.zeros(n + 1, np.int32))
    return HostColumn(dt, np.zeros(n, dt.np_dtype), np.zeros(n, bool))


class CpuShuffledHashJoinExec(Exec):
    """Equi-join: both sides hash-partitioned by key; per-partition hash join."""

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

    def execute(self, ctx: ExecContext) -> PartitionSet:
        left, right = self.children
        lparts = left.execute(ctx)
        rparts = right.execute(ctx)
        assert lparts.num_partitions == rparts.num_partitions
        lschema, rschema = left.output, right.output

        def make(lt, rt):
            def it():
                lrb = concat_batches(lschema, list(lt()))
                rrb = concat_batches(rschema, list(rt()))
                yield self._join_partition(lrb, rrb)

            return it

        return PartitionSet(
            [make(lt, rt) for lt, rt in zip(lparts.parts, rparts.parts)]
        )

    def _join_partition(
        self,
        lrb: HostBatch,
        rrb: HostBatch,
        build_matched_acc=None,
    ) -> HostBatch:
        """``build_matched_acc`` (np bool array over build rows): broadcast
        right/full mode — build match bits are ACCUMULATED instead of
        null-extending per partition (which would duplicate unmatched build
        rows across stream partitions); the caller emits the tail once."""
        left, right = self.children
        lvals, lvalid = _eval_keys(self.left_keys, lrb, left.output)
        rvals, rvalid = _eval_keys(self.right_keys, rrb, right.output)
        # build on right (stream=left), matching the reference's build side
        li, ri = match_pairs(lvals, lvalid, rvals, rvalid)
        lmatched = np.zeros(lrb.num_rows, dtype=bool)
        rmatched = np.zeros(rrb.num_rows, dtype=bool)
        # residual condition filters matched pairs (then outer rows re-added)
        if self.residual is not None and len(li):
            pairs = self._pairs_batch(lrb, rrb, li, ri, drop=False)
            rs = pairs.schema
            c = _cpu_ctx(pairs, rs)
            d, v = _val_to_np(c, bind(self.residual, rs).eval(c))
            keep = d.astype(bool) & v
            li, ri = li[keep], ri[keep]
        lmatched[li] = True
        rmatched[ri] = True
        jt = self.join_type
        if jt == "inner":
            return self._pairs_batch(lrb, rrb, li, ri)
        if jt == "left_semi":
            return lrb.filter(lmatched)
        if jt == "left_anti":
            return lrb.filter(~lmatched)
        none = np.zeros(0, dtype=np.int64)
        extra_l = np.flatnonzero(~lmatched) if jt in ("left", "full") else none
        if jt in ("right", "full") and build_matched_acc is None:
            extra_r = np.flatnonzero(~rmatched)
        else:
            extra_r = none
        if build_matched_acc is not None:
            build_matched_acc |= rmatched
        return self._outer_batch(lrb, rrb, li, ri, extra_l, extra_r)

    def _right_ordinals(self) -> List[int]:
        return [
            i
            for i, f in enumerate(self.children[1].output.fields)
            if f.name not in self.drop_right_keys
        ]

    def _pairs_batch(self, lrb, rrb, li, ri, drop=True) -> HostBatch:
        left, right = self.children
        ords = self._right_ordinals() if drop else range(len(right.output.fields))
        cols = [c.take(li) for c in lrb.columns] + [rrb.columns[i].take(ri) for i in ords]
        schema = self._schema if drop else Schema(
            list(left.output.fields) + list(right.output.fields)
        )
        return HostBatch(schema, cols, len(li))

    def _outer_batch(self, lrb, rrb, li, ri, extra_l, extra_r) -> HostBatch:
        parts = [self._pairs_batch(lrb, rrb, li, ri)]
        ords = self._right_ordinals()
        rfields = self.children[1].output.fields
        if len(extra_l):
            n = len(extra_l)
            cols = [c.take(extra_l) for c in lrb.columns]
            cols += [_null_column(rfields[i].data_type, n) for i in ords]
            parts.append(HostBatch(self._schema, cols, n))
        if len(extra_r):
            n = len(extra_r)
            cols = [_null_column(f.data_type, n) for f in self.children[0].output.fields]
            cols += [rrb.columns[i].take(extra_r) for i in ords]
            parts.append(HostBatch(self._schema, cols, n))
        return concat_batches(self._schema, parts)

    def node_string(self):
        return f"CpuShuffledHashJoin {self.join_type} [{', '.join(map(str, self.left_keys))}] [{', '.join(map(str, self.right_keys))}]"


def _collect_once(node: Exec, state: dict, lock: threading.Lock, ctx: ExecContext) -> HostBatch:
    """The whole of ``node``'s output as one batch, built once per state."""
    with lock:
        if "b" not in state:
            parts = node.execute(ctx)
            state["b"] = concat_batches(node.output, [b for t in parts.parts for b in t()])
        return state["b"]


class CpuBroadcastExchangeExec(Exec):
    """Collect the build side once into a single batch shared by every join
    task (GpuBroadcastExchangeExecBase; the JVM-broadcast step collapses to
    an in-process cached batch)."""

    def __init__(self, child: Exec):
        super().__init__([child])
        self._state: dict = {}
        self._lock = threading.Lock()

    @property
    def output(self) -> Schema:
        return self.children[0].output

    def execute(self, ctx: ExecContext) -> PartitionSet:
        def it():
            yield _collect_once(self.children[0], self._state, self._lock, ctx)

        return PartitionSet([it])

    def node_string(self):
        return "CpuBroadcastExchange"


class CpuBroadcastHashJoinExec(CpuShuffledHashJoinExec):
    """Hash join against a broadcast build side: the stream (left) keeps its
    partitioning, every partition joins the same build batch
    (GpuBroadcastHashJoinExec shims). The build is the right child's whole
    output, collected once per execution — a ``CpuBroadcastExchangeExec``,
    or its device form behind a transition when only the join fell back."""

    def execute(self, ctx: ExecContext) -> PartitionSet:
        left, right = self.children
        lparts = left.execute(ctx)
        lschema = left.output
        bstate: dict = {}
        block = threading.Lock()

        def build() -> HostBatch:
            return _collect_once(right, bstate, block, ctx)

        if self.join_type not in ("right", "full"):
            def make(lt):
                def it():
                    lrb = concat_batches(lschema, list(lt()))
                    yield self._join_partition(lrb, build())

                return it

            return PartitionSet([make(lt) for lt in lparts.parts])

        # right/full outer: accumulate build match bits across stream
        # partitions; the last finisher emits the unmatched-build tail once
        # (mirrors GpuBroadcastHashJoinExec — see its docstring)
        state = {"remaining": len(lparts.parts), "mask": None, "emitted": False}
        lock = threading.Lock()

        def make_outer(lt):
            def it():
                rrb = build()
                local = np.zeros(rrb.num_rows, dtype=bool)
                done = False
                abandoned = False
                try:
                    lrb = concat_batches(lschema, list(lt()))
                    yield self._join_partition(lrb, rrb, build_matched_acc=local)
                    done = True
                except GeneratorExit:
                    abandoned = True
                    raise
                finally:
                    with lock:
                        state["mask"] = (
                            local if state["mask"] is None else state["mask"] | local
                        )
                        # once per FINISHED partition
                        last = False
                        if done or abandoned:
                            state["remaining"] -= 1
                            last = state["remaining"] == 0 and not state["emitted"]
                            if last:
                                state["emitted"] = True
                    if last and done:
                        extra_r = np.flatnonzero(~state["mask"])
                        if len(extra_r):
                            none = np.zeros(0, dtype=np.int64)
                            yield self._outer_batch(
                                concat_batches(lschema, []), rrb, none, none, none, extra_r
                            )

            return it

        return PartitionSet([make_outer(lt) for lt in lparts.parts])

    def node_string(self):
        return (
            f"CpuBroadcastHashJoin {self.join_type} "
            f"[{', '.join(map(str, self.left_keys))}]"
        )


def _cross_pairs(lrb: HostBatch, rrb: HostBatch, pair_schema: Schema, cond) -> tuple:
    """Every (left, right) row pair as one batch, and the pairs the
    condition keeps."""
    nl, nr = lrb.num_rows, rrb.num_rows
    li = np.repeat(np.arange(nl, dtype=np.int64), nr)
    ri = np.tile(np.arange(nr, dtype=np.int64), nl)
    cols = [c.take(li) for c in lrb.columns] + [c.take(ri) for c in rrb.columns]
    pairs = HostBatch(pair_schema, cols, nl * nr)
    if cond is None:
        return pairs, np.ones(nl * nr, dtype=bool)
    c = _cpu_ctx(pairs, pair_schema)
    d, v = _val_to_np(c, cond.eval(c))
    return pairs, d.astype(bool) & v


class CpuNestedLoopJoinExec(Exec):
    """Cross/conditional join (GpuBroadcastNestedLoopJoinExec analogue)."""

    def __init__(self, join_type: str, condition: Optional[Expression], left: Exec, right: Exec):
        super().__init__([left, right])
        self.join_type = join_type
        self.condition = condition
        self._schema = join_output_schema(
            join_type, left.output.fields, right.output.fields
        )

    @property
    def output(self) -> Schema:
        return self._schema

    def execute(self, ctx: ExecContext) -> PartitionSet:
        left, right = self.children
        lschema, rschema = left.output, right.output
        lparts = left.execute(ctx)
        rparts = right.execute(ctx)
        jt = self.join_type
        pair_schema = Schema(list(lschema.fields) + list(rschema.fields))
        cond = bind(self.condition, pair_schema) if self.condition is not None else None

        def it():
            lrb = concat_batches(lschema, [b for t in lparts.parts for b in t()])
            rrb = concat_batches(rschema, [b for t in rparts.parts for b in t()])
            nl, nr = lrb.num_rows, rrb.num_rows
            pairs, keep = _cross_pairs(lrb, rrb, pair_schema, cond)
            grid = keep.reshape(nl, nr)
            matched_l = grid.any(axis=1) if nr else np.zeros(nl, bool)
            matched_r = grid.any(axis=0) if nl else np.zeros(nr, bool)
            if jt in ("left_semi", "left_anti"):
                yield lrb.filter(matched_l if jt == "left_semi" else ~matched_l)
                return
            matched = pairs.filter(keep)
            yield HostBatch(self._schema, matched.columns, matched.num_rows)
            if jt in ("left", "full") and (~matched_l).any():
                lsub = lrb.filter(~matched_l)
                cols = lsub.columns + [_null_column(f.data_type, lsub.num_rows) for f in rschema]
                yield HostBatch(self._schema, cols, lsub.num_rows)
            if jt in ("right", "full") and (~matched_r).any():
                rsub = rrb.filter(~matched_r)
                cols = [_null_column(f.data_type, rsub.num_rows) for f in lschema] + rsub.columns
                yield HostBatch(self._schema, cols, rsub.num_rows)

        return PartitionSet([it])

    def node_string(self):
        return f"CpuNestedLoopJoin {self.join_type} {self.condition or ''}"


def extract_equi_join_keys(condition, left_schema: Schema, right_schema: Schema):
    """Split a join condition into (left_keys, right_keys, residual)."""
    from ..expr.predicates import And, EqualTo

    if condition is None:
        return [], [], None
    conjuncts = []

    def flatten(e):
        if isinstance(e, And):
            flatten(e.l)
            flatten(e.r)
        else:
            conjuncts.append(e)

    flatten(condition)
    lk, rk, residual = [], [], []
    for e in conjuncts:
        if isinstance(e, EqualTo):
            sides = []
            for operand in (e.l, e.r):
                if isinstance(operand, UnresolvedAttribute):
                    in_l = operand.name in left_schema.names
                    in_r = operand.name in right_schema.names
                    if in_l and not in_r:
                        sides.append("l")
                        continue
                    if in_r and not in_l:
                        sides.append("r")
                        continue
                sides.append("?")
            if sides == ["l", "r"]:
                lk.append(e.l)
                rk.append(e.r)
                continue
            if sides == ["r", "l"]:
                lk.append(e.r)
                rk.append(e.l)
                continue
        residual.append(e)
    res = None
    for e in residual:
        res = e if res is None else And(res, e)
    return lk, rk, res


class CpuCartesianProductExec(Exec):
    """Pairwise-partition cross join (GpuCartesianProductExec analogue,
    CPU engine): one task per (left, right) partition pair."""

    def __init__(self, condition: Optional[Expression], left: Exec, right: Exec):
        super().__init__([left, right])
        self.condition = condition
        self._schema = join_output_schema(
            "inner", left.output.fields, right.output.fields
        )

    @property
    def output(self) -> Schema:
        return self._schema

    def execute(self, ctx: ExecContext) -> PartitionSet:
        left, right = self.children
        lschema, rschema = left.output, right.output
        lparts = left.execute(ctx)
        rparts = right.execute(ctx)
        pair_schema = Schema(list(lschema.fields) + list(rschema.fields))
        cond = bind(self.condition, pair_schema) if self.condition is not None else None

        def make(lt, rt):
            def it():
                lrb = concat_batches(lschema, list(lt()))
                rrb = concat_batches(rschema, list(rt()))
                if lrb.num_rows == 0 or rrb.num_rows == 0:
                    return
                pairs, keep = _cross_pairs(lrb, rrb, pair_schema, cond)
                pairs = pairs.filter(keep)
                if pairs.num_rows:
                    yield HostBatch(self._schema, pairs.columns, pairs.num_rows)

            return it

        return PartitionSet(
            [make(lt, rt) for lt in lparts.parts for rt in rparts.parts]
        )

    def node_string(self):
        return f"CpuCartesianProduct {self.condition or ''}"
