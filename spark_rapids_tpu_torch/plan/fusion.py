"""Whole-stage fusion — collapse project/filter chains into one stage.

The per-op execution model runs one ``run_device`` loop per project and
filter node per batch: each with its own retry scope, its own cancel-token
check, its own breaker key and its own generator hop. A *stage* is a
maximal chain of adjacent device row-operators whose bodies are pure
expression evaluation; fusing the chain evaluates their expression trees
end-to-end over one batch inside ONE callable, driven by ONE
``run_device`` — one retry scope, one token check, one breaker key per
stage.

Fusion boundaries (anything else breaks the chain):

* only ``GpuProjectExec`` / ``GpuFilterExec`` fuse — their bodies are
  pure ``DeviceBatch -> DeviceBatch`` functions with identical launch
  plumbing (``exec/task.run_device``);
* task-dependent expressions never fuse: ``run_device`` accumulates
  ``row_base`` from the *stage input* batch, which would be wrong for an
  expression that was supposed to see a post-filter batch;
* expressions with ANSI error sites never fuse: their per-op device error
  channel (``exec/gpu.py::raise_errors``) raises at the precise batch, and
  fusing would re-order the check against the in-stage filter's
  compaction;
* chains cap at ``spark.rapids.tpu.fusion.maxOps``.

Single-op "chains" stay unfused — the parent-side fusions that already
exist (``GpuHashAggregateExec._fused_child`` folding an immediate filter,
the exchange's scatter-side filter fusion) keep first claim on lone
filters, so this pass composes with them instead of competing.

Copied from ``spark_rapids_tpu/plan/fusion.py``. The JAX package traces the
stage into one jitted XLA program under a kernel-cache key; here the stage
runs eagerly, step after step, on the card and on the CPU alike, so a
fused run launches the same torch kernels as the unfused chain and is
bit-identical to it. Capturing a stage (a CUDA graph, ``torch.compile``)
is left to measurement (ROADMAP Queue P).
"""
from __future__ import annotations

from typing import List, Tuple

from .. import config as cfg
from ..columnar.device import DeviceBatch
from ..config import TpuConf
from ..exec import task
from ..exec.gpu import (
    GpuFilterExec,
    GpuProjectExec,
    filter_fn,
    has_error_site,
    project_fn,
)
from ..expr.misc import contains_task_dependent
from .physical import Exec, ExecContext, PartitionSet


def _op_key(op: Exec) -> tuple:
    """Semantic identity of one fused step — the (kind, bound exprs,
    schema) tuple, so a stage's identity is the concatenation of its
    steps'."""
    if isinstance(op, GpuProjectExec):
        return ("project", tuple(op.exprs), op.output)
    assert isinstance(op, GpuFilterExec)
    return ("filter", op.condition)


def stage_signature(fused: tuple) -> str:
    """The circuit-breaker key for one fused chain. Per-STAGE, not the
    class-wide "StageExec": one pathological stage must not condemn every
    other stage in the plan to the fallback path. Process-local like the
    breaker itself."""
    try:
        h = hash(("stage",) + fused)
    except TypeError:
        h = hash(("stage", repr(fused)))
    return f"StageExec:{h & 0xFFFFFFFF:08x}"


def stage_fn(fused: tuple):
    """One callable evaluating every step of ``fused`` in sequence over one
    batch, each through the unfused operator's own body (``project_fn``
    masks a project's columns by the live rows, ``filter_fn`` compacts
    sync-free), so a fused run is the unfused chain's launches in order.
    Steps with error sites are excluded by the fusion guard, so no step
    registers an error flag and each body's error check is a no-op."""
    steps = [
        project_fn(step[1], step[2]) if step[0] == "project" else filter_fn(step[1])
        for step in fused
    ]

    def _stage(batch: DeviceBatch, tvals=None) -> DeviceBatch:
        for fn in steps:
            batch = fn(batch, tvals)
        return batch

    return _stage


class StageExec(Exec):
    """A fused pipeline stage: ``ops`` (bottom-up) executed as one step
    function under one ``run_device``. ``fused`` — the tuple of step
    identities — is public, as in the JAX package."""

    def __init__(self, ops: List[Exec], child: Exec):
        super().__init__([child])
        self._ops = list(ops)
        self._schema = ops[-1].output
        self.fused: Tuple[tuple, ...] = tuple(_op_key(op) for op in ops)
        self._fn = stage_fn(self.fused)
        # per-stage breaker identity: failures recorded under THIS
        # signature open the breaker for this chain only; the next planning
        # pass rebuilds it unfused (fuse_stages' fallback) while other
        # stages keep fusing
        self.breaker_op = stage_signature(self.fused)

    @property
    def output(self):
        return self._schema

    @property
    def is_device(self) -> bool:
        return True

    @property
    def ops(self) -> List[Exec]:
        return list(self._ops)

    def execute(self, ctx: ExecContext) -> PartitionSet:
        fn = self._fn

        def run(it):
            # splittable exactly like its constituent ops: every step is a
            # row-local map/compact, so concat(a, b) commutes with the stage
            return task.run_device(
                fn, it, False, catalog=ctx.catalog,
                policy=ctx.retry_policy, op=self.breaker_op,
                breaker=ctx.breaker, token=ctx.cancel_token,
            )

        return self.children[0].execute(ctx).map_partitions(run)

    def node_string(self):
        names = [op.node_string() for op in self._ops]
        return f"Stage({len(self._ops)}) [" + " -> ".join(names) + "]"


def _fusable(node: Exec) -> bool:
    if isinstance(node, GpuProjectExec):
        return not any(
            contains_task_dependent(e) or has_error_site(e) for e in node.exprs
        )
    if isinstance(node, GpuFilterExec):
        return not (
            contains_task_dependent(node.condition)
            or has_error_site(node.condition)
        )
    return False


def fuse_stages(plan: Exec, conf: TpuConf, breaker=None) -> tuple:
    """(fused plan, number of stages formed). Walks top-down, replacing
    every maximal chain of >= 2 fusable nodes with a ``StageExec``; all
    other nodes are rebuilt via ``with_new_children`` (fresh metric
    registries, the standard rewrite currency).

    Breaker-aware: a chain whose ``stage_signature`` the circuit breaker
    has opened — its stage failed repeatedly — is rebuilt as the unfused
    per-op chain instead of a StageExec. Each op then runs (and fails)
    under its OWN breaker key, so a genuinely bad operator degrades one
    more step to the CPU engine via the overrides pass, while its innocent
    chain-mates keep running on the device."""
    if not cfg.FUSION_ENABLED.get(conf):
        return plan, 0
    max_ops = max(2, cfg.FUSION_MAX_OPS.get(conf))
    count = 0

    def unfuse(chain, below: Exec) -> Exec:
        from ..obs.metrics import GLOBAL as _obs

        _obs.counter("fusion.breakerFallbacks").add(1)
        rebuilt = below
        for op in reversed(chain):  # deepest first, original node on top
            rebuilt = op.with_new_children([rebuilt])
        return rebuilt

    def walk(node: Exec) -> Exec:
        nonlocal count
        if _fusable(node):
            chain = [node]
            cur = node.children[0]
            while len(chain) < max_ops and _fusable(cur):
                chain.append(cur)
                cur = cur.children[0]
            if len(chain) >= 2:
                fused = tuple(_op_key(op) for op in reversed(chain))
                if breaker is not None and breaker.is_open(
                    stage_signature(fused)
                ):
                    return unfuse(chain, walk(cur))
                count += 1
                return StageExec(list(reversed(chain)), walk(cur))
        return node.with_new_children([walk(c) for c in node.children])

    return walk(plan), count
