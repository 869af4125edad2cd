"""Output partitionings for exchanges — the four ``GpuPartitioning`` impls.

Reference: GpuHashPartitioning.scala (:49-76 murmur3 pmod bucketing on
device), GpuRangePartitioning.scala + GpuRangePartitioner.scala +
SamplingUtils.scala (sample rows → CPU-computed bounds → device bucketing),
GpuRoundRobinPartitioning.scala, GpuSinglePartitioning.scala.

TPU-first range design: rows and sampled bound rows are both encoded to the
framework's order-preserving uint64 *radix words* (ops/sortkeys.py); a row's
partition id is the count of bounds lexicographically below it — one fused
compare kernel on device, no per-type comparators. Bounds are picked on the
host from an evenly-strided sample of encoded words (the reservoir-sample
analogue; bounds only shape balance, never results).

Copied from ``spark_rapids_tpu/plan/partitioning.py``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from ..expr import Expression
from .logical import SortOrder


@dataclasses.dataclass
class Partitioning:
    num_partitions: int

    def exprs(self) -> List[Expression]:
        return []


@dataclasses.dataclass
class SinglePartitioning(Partitioning):
    num_partitions: int = 1


@dataclasses.dataclass
class HashPartitioning(Partitioning):
    keys: List[Expression] = dataclasses.field(default_factory=list)

    def exprs(self) -> List[Expression]:
        return list(self.keys)


@dataclasses.dataclass
class RoundRobinPartitioning(Partitioning):
    pass


@dataclasses.dataclass
class RangePartitioning(Partitioning):
    order: List[SortOrder] = dataclasses.field(default_factory=list)

    def exprs(self) -> List[Expression]:
        return [o.child for o in self.order]


SAMPLE_PER_BATCH = 128  # rows sampled per input batch for range bounds


def align_word_groups(per_batch_groups, orders, xp):
    """Align per-batch radix-word group lists to a common word count.

    String columns encode to a *variable* number of char words (width is
    bucketed per batch), so two batches of the same column can produce word
    lists of different lengths. A narrower batch's missing char words are
    exactly the zero words the wider padding would have produced (all-ones
    under descending, where value words are complemented), so alignment pads
    with that constant *before* the trailing length word.

    ``per_batch_groups``: list over batches of per-order-column word lists.
    Returns ``(aligned, targets)``: a list over batches of flat, aligned
    word lists, plus the per-column word counts everything was padded to
    (cross-rank gathers re-pad against these — keep the two in lockstep).
    """
    ncols = len(orders)
    if not per_batch_groups:
        return [], [0] * ncols
    targets = [
        max(len(g[ci]) for g in per_batch_groups) for ci in range(ncols)
    ]
    out = []
    for groups in per_batch_groups:
        flat = [w for ci in range(ncols) for w in groups[ci]]
        locals_ = [len(groups[ci]) for ci in range(ncols)]
        out.append(pad_flat_words(flat, locals_, targets, orders, xp))
    return out, targets


def pad_flat_words(flat_words, local_targets, global_targets, orders, xp):
    """Re-pad a flat aligned word list from per-column ``local_targets`` word
    counts up to ``global_targets`` (the cross-rank maxima). Same padding rule
    as :func:`align_word_groups`: a narrower string column's missing char
    words are inserted *before* its trailing length word, as zeros (all-ones
    under descending order, where value words are complemented)."""
    pos, out = 0, []
    for ci, o in enumerate(orders):
        g = list(flat_words[pos : pos + local_targets[ci]])
        pos += local_targets[ci]
        missing = global_targets[ci] - local_targets[ci]
        if missing:
            zero = xp.zeros_like(g[0])
            pad = zero if o.ascending else ~zero
            g = g[:-1] + [pad] * missing + [g[-1]]
        out.extend(g)
    return out


def merge_sampled_word_groups(contribs, orders):
    """Merge per-rank sampled radix-word contributions into one flat sample.

    Multi-process range exchanges must agree on ONE set of range bounds —
    per-rank bounds would route the same key range to different reduce
    partitions on different ranks (globally wrong sort). Each rank samples
    its own rows, publishes ``{"targets": [words-per-column], "words":
    [[int,...] per flat word]}`` through the driver service, and every rank
    runs this same deterministic merge over the gathered contributions
    (GpuRangePartitioner computes bounds once on the Spark driver; here the
    merge is replicated instead, driver service only gathers).

    Returns ``(sample_words, global_targets)`` — flat uint64 arrays ready
    for :func:`compute_range_bounds` — or ``(None, None)`` when no rank
    contributed rows.
    """
    # a rank with no input batches posts targets=[0,...], words=[] — it
    # contributes nothing and must not reach pad_flat_words (g[0] on [])
    live = [c for c in contribs if c and c.get("targets") and c.get("words")]
    if not live:
        return None, None
    ncols = len(orders)
    gtargets = [max(c["targets"][ci] for c in live) for ci in range(ncols)]
    merged: List[List[np.ndarray]] = [[] for _ in range(sum(gtargets))]
    for c in live:
        flat = [np.asarray(w, dtype=np.uint64) for w in c["words"]]
        padded = pad_flat_words(flat, c["targets"], gtargets, orders, np)
        for i, w in enumerate(padded):
            merged[i].append(w)
    sample_words = [np.concatenate(ws) for ws in merged]
    if sample_words[0].size == 0:
        return None, None
    return sample_words, gtargets


def compute_range_bounds(
    sample_words: List[np.ndarray], num_partitions: int
) -> Optional[List[np.ndarray]]:
    """Sampled radix words → P-1 bound rows (as word vectors), picked at even
    quantiles of the lexicographically-sorted sample (GpuRangePartitioner
    createRangeBounds analogue). Returns None when the sample is empty."""
    if not sample_words or sample_words[0].size == 0:
        return None
    k = sample_words[0].shape[0]
    order = np.lexsort(tuple(reversed(sample_words)))
    idx = np.minimum((np.arange(1, num_partitions) * k) // num_partitions, k - 1)
    return [w[order][idx] for w in sample_words]


def words_partition_ids(xp, words, bounds, int32_dtype=None):
    """pid[i] = #bounds lexicographically < row i's words (row == bound goes
    left). ``words``: per-row word arrays [cap]; ``bounds``: same-length list
    of [P-1] arrays. Works for numpy and jax.numpy."""
    i32 = int32_dtype or xp.int32
    cap = words[0].shape[0]
    nb = bounds[0].shape[0]
    if nb == 0:
        return xp.zeros(cap, dtype=i32)
    gt = xp.zeros((cap, nb), dtype=bool)
    eq = xp.ones((cap, nb), dtype=bool)
    for w, bw in zip(words, bounds):
        wv = w[:, None]
        bv = bw[None, :]
        gt = gt | (eq & (wv > bv))
        eq = eq & (wv == bv)
    return gt.sum(axis=1).astype(i32)
