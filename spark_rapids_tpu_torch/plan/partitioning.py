"""Output partitionings for exchanges — the four ``GpuPartitioning`` impls.

Reference: GpuHashPartitioning.scala (:49-76 murmur3 pmod bucketing on
device), GpuRangePartitioning.scala + GpuRangePartitioner.scala +
SamplingUtils.scala (sample rows → CPU-computed bounds → device bucketing),
GpuRoundRobinPartitioning.scala, GpuSinglePartitioning.scala.

Range design: rows and sampled bound rows are both encoded to the
framework's order-preserving *radix words* (ops/sortkeys.py); a row's
partition id is the count of bounds lexicographically below it — elementwise
compares on device, no per-type comparators. Bounds are picked on the host
from an evenly-strided sample of encoded words (the reservoir-sample
analogue; bounds only shape balance, never results).

Copied from ``spark_rapids_tpu/plan/partitioning.py``. The range helpers
work over the port's radix words — int64 holding the JAX package's uint64
word with the sign bit flipped — as torch tensors on the device and as
numpy arrays in the CPU engine. So the padding words that stand for uint64
``0`` and ``~0`` are ``WORD_MIN`` and ``WORD_MAX`` here, and signed compares
and ``np.lexsort`` on the flipped words give the uint64 order, the
multi-process sample merge (``merge_sampled_word_groups``) included.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..expr import Expression
from ..ops.sortkeys import WORD_MAX, WORD_MIN
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


def align_word_groups(per_batch_groups, orders):
    """Align per-batch radix-word group lists to a common word count.

    String columns encode to a *variable* number of char words (width is
    bucketed per batch), so two batches of the same column can produce word
    lists of different lengths. A narrower batch's missing char words are
    exactly the zero words the wider padding would have produced (all-ones
    under descending, where value words are complemented), so alignment pads
    with that constant *before* the trailing length word.

    ``per_batch_groups``: list over batches of per-order-column word lists.
    Returns ``(aligned, targets)``: a list over batches of flat, aligned
    word lists, plus the per-column word counts everything was padded to.
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
        out.append(pad_flat_words(flat, locals_, targets, orders))
    return out, targets


def pad_flat_words(flat_words, local_targets, global_targets, orders):
    """Re-pad a flat aligned word list from per-column ``local_targets`` word
    counts up to ``global_targets``. Same padding rule as
    :func:`align_word_groups`: a narrower string column's missing char
    words are inserted *before* its trailing length word, as the word of
    uint64 zero (``WORD_MIN``; ``WORD_MAX``, its complement, under
    descending order, where value words are complemented)."""
    pos, out = 0, []
    for ci, o in enumerate(orders):
        g = list(flat_words[pos : pos + local_targets[ci]])
        pos += local_targets[ci]
        missing = global_targets[ci] - local_targets[ci]
        if missing:
            fill = WORD_MIN if o.ascending else WORD_MAX
            if isinstance(g[0], torch.Tensor):
                pad = torch.full_like(g[0], fill)
            else:
                pad = np.full_like(g[0], fill)
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

    Returns ``(sample_words, global_targets)`` — flat int64 word arrays
    ready for :func:`compute_range_bounds` — or ``(None, None)`` when no
    rank contributed rows.
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
        flat = [np.asarray(w, dtype=np.int64) for w in c["words"]]
        padded = pad_flat_words(flat, c["targets"], gtargets, orders)
        for i, w in enumerate(padded):
            merged[i].append(w)
    sample_words = [np.concatenate(ws) for ws in merged]
    if sample_words[0].size == 0:
        return None, None
    return sample_words, gtargets


def compute_range_bounds(
    sample_words: List[np.ndarray], num_partitions: int
) -> Optional[List[np.ndarray]]:
    """Sampled radix words (numpy int64) → P-1 bound rows (as word
    vectors), picked at even quantiles of the lexicographically-sorted
    sample (GpuRangePartitioner createRangeBounds analogue). Returns None
    when the sample is empty."""
    if not sample_words or sample_words[0].size == 0:
        return None
    k = sample_words[0].shape[0]
    order = np.lexsort(tuple(reversed(sample_words)))
    idx = np.minimum((np.arange(1, num_partitions) * k) // num_partitions, k - 1)
    return [w[order][idx] for w in sample_words]


def words_partition_ids(words, bounds):
    """pid[i] = #bounds lexicographically < row i's words (row == bound goes
    left), int32. ``words``: per-row word arrays [cap]; ``bounds``: a
    same-length list of [P-1] arrays — torch tensors on one device, or
    numpy arrays."""
    cap = words[0].shape[0]
    nb = bounds[0].shape[0]
    if isinstance(words[0], torch.Tensor):
        dev = words[0].device
        if nb == 0:
            return torch.zeros(cap, dtype=torch.int32, device=dev)
        gt = torch.zeros((cap, nb), dtype=torch.bool, device=dev)
        eq = torch.ones((cap, nb), dtype=torch.bool, device=dev)
    else:
        if nb == 0:
            return np.zeros(cap, dtype=np.int32)
        gt = np.zeros((cap, nb), dtype=bool)
        eq = np.ones((cap, nb), dtype=bool)
    for w, bw in zip(words, bounds):
        wv = w[:, None]
        bv = bw[None, :]
        gt = gt | (eq & (wv > bv))
        eq = eq & (wv == bv)
    if isinstance(gt, torch.Tensor):
        return gt.sum(dim=1, dtype=torch.int32)
    return gt.sum(axis=1).astype(np.int32)
