"""Device equi-join kernels — the Table.innerJoin/leftJoin/... analogue
(reference: GpuHashJoin.scala:165-362, cudf hash joins).

The port of ``spark_rapids_tpu/ops/join.py``. No hash table: both sides'
keys are radix-encoded (``ops/sortkeys.py``) and matched as a sort-merge.
For every probe row the count of build keys strictly less (``lower``) and
less or equal (``upper``) gives its range ``[lower, upper)`` in the
key-sorted build order — exact lexicographic multi-word matching, no
collisions.

Join semantics (Spark): NULL keys never match (side-specific sentinel words
make them unequal to everything); NaN keys match each other and -0.0 == 0.0
(float keys are normalized before encoding).

What differs from the JAX package: it sorts ``[build ++ probe]`` twice
with a side flag as the last key. Here the build side is sorted once per
stream of probe batches (``sort_build``, one stable ``torch.sort`` per
word), and each probe batch finds its bounds in it (``probe_bounds``):
with one value word, by two ``torch.searchsorted`` calls; with several
(strings, several keys), by one stable sort of ``[sorted build ++ probe]``
whose runs of equal tuples give both bounds. The counts are the JAX
package's numbers, element for element, in a few dozen launches a probe
batch whatever the build's size. Words are the port's flipped
int64 (``ops/sortkeys.py``): the JAX sentinel ``uint64(2 + side_flag)`` is
``(2 + side_flag) ^ WORD_MIN`` here, and the valid-row word 0 is
``WORD_MIN``.

Output size is data-dependent: phase 1 returns per-probe match counts (the
one host sync per window of probe batches); phase 2 gathers pairs into a
bucketed capacity.
"""
from __future__ import annotations

import dataclasses

import torch

from ..columnar.device import DeviceColumn
from ..ops.aggregate import _normalize_float
from ..ops.gather import gather_column
from ..ops.sortkeys import WORD_MAX, WORD_MIN, column_radix_words, sort_permutation
from ..types import Schema, StringType


def join_output_schema(
    join_type: str,
    left_fields,
    right_fields,
    drop_right: list[str] | None = None,
):
    """Join output schema shared by every join exec (CPU and device):
    semi/anti keep only the left side; outer sides become nullable."""
    lt = list(left_fields)
    rt = [f for f in right_fields if f.name not in (drop_right or [])]
    if join_type in ("left_semi", "left_anti"):
        return Schema(lt)
    if join_type in ("left", "full"):
        rt = [dataclasses.replace(f, nullable=True) for f in rt]
    if join_type in ("right", "full"):
        lt = [dataclasses.replace(f, nullable=True) for f in lt]
    return Schema(lt + rt)


def pad_string_column(col: DeviceColumn, width: int) -> DeviceColumn:
    if not isinstance(col.dtype, StringType) or col.data.shape[1] >= width:
        return col
    data = torch.nn.functional.pad(col.data, (0, width - col.data.shape[1]))
    return DeviceColumn(col.dtype, data, col.validity, col.lengths)


def _key_words(cols: list, live: torch.Tensor, side_flag: int):
    """Radix words for join keys + leading null-exclusion word.

    Rows with any NULL key (or padding rows) get a side-specific sentinel in
    the leading word so they can never equal anything on the other side."""
    words: list = []
    any_null = ~live
    for c in cols:
        c = _normalize_float(c)
        any_null = any_null | ~c.validity
        # no standalone validity word (nulls handled by the exclusion
        # sentinel)
        words.extend(column_radix_words(c, value_only=True))
    sentinel = torch.where(any_null, (2 + side_flag) ^ WORD_MIN, WORD_MIN)
    return [sentinel] + words, any_null


def _common_widths(build_cols: list, probe_cols: list) -> tuple:
    """Pad each string key to the wider of its two sides' planes: words of
    equal strings must be equal whatever each side's bucketed width."""
    bcols, pcols = list(build_cols), list(probe_cols)
    for i, (b, p) in enumerate(zip(bcols, pcols)):
        if isinstance(b.dtype, StringType):
            w = max(b.data.shape[1], p.data.shape[1])
            bcols[i] = pad_string_column(b, w)
            pcols[i] = pad_string_column(p, w)
    return bcols, pcols


def sort_build(build_cols: list, build_live: torch.Tensor) -> tuple:
    """(build_order, the key columns and live mask in that order): the
    stable sort of the build rows by their key words, null and padding rows
    last."""
    bw, _ = _key_words(build_cols, build_live, 0)
    build_order = sort_permutation(bw, build_live, live_first=False)
    sorted_cols = [gather_column(c, build_order) for c in build_cols]
    return build_order, sorted_cols, build_live[build_order]


def probe_bounds(sorted_cols: list, sorted_live, probe_cols: list, probe_live):
    """(lower, upper) of each probe row in the sorted build keys: the count
    of build key tuples ``<`` and ``<=`` its own, sentinels included."""
    sorted_cols, probe_cols = _common_widths(sorted_cols, probe_cols)
    sw, _ = _key_words(sorted_cols, sorted_live, 0)
    pw, probe_null = _key_words(probe_cols, probe_live, 1)
    if len(sw) == 2:
        return _one_word_bounds(sw, pw, probe_null)
    return _joint_sort_bounds(sw, pw)


def _one_word_bounds(sw: list, pw: list, probe_null):
    """One value word: two ``searchsorted`` calls. The sorted build holds its
    valid rows first (sentinel ``WORD_MIN``) in value order; its null and
    padding rows, after them, read as ``WORD_MAX`` so the sequence stays
    sorted, and ``upper`` is capped at the valid rows so a probe value of
    ``WORD_MAX`` counts none of them. A probe row with a null key or on a
    padding row (sentinel 3) sorts after every build tuple: both bounds are
    the build's row count."""
    valid = sw[0] == WORD_MIN
    seq = torch.where(valid, sw[1], WORD_MAX).contiguous()
    q = pw[1].contiguous()
    nb = seq.shape[0]
    lower = torch.searchsorted(seq, q, right=False)
    upper = torch.minimum(torch.searchsorted(seq, q, right=True), valid.sum())
    return torch.where(probe_null, nb, lower), torch.where(probe_null, nb, upper)


def _joint_sort_bounds(sw: list, pw: list):
    """Several words: one stable LSD sort of [sorted build ++ probe] by the
    words, so each probe row lands after every build tuple ``<=`` its own
    (``upper``: the build rows before it); ``lower`` is the build rows
    before the first row of its run of equal tuples."""
    nb, npr = sw[0].shape[0], pw[0].shape[0]
    n = nb + npr
    device = sw[0].device
    words = [torch.cat([b, p]) for b, p in zip(sw, pw)]
    perm = sort_permutation(words, None, live_first=False)
    is_build = perm < nb
    build_before = torch.cumsum(is_build, 0) - is_build.to(torch.int64)
    starts = torch.zeros(n, dtype=torch.bool, device=device)
    starts[0] = True
    for w in words:
        ws = w[perm]
        starts[1:] |= ws[1:] != ws[:-1]
    run = torch.cumsum(starts, 0) - 1
    pos = torch.arange(n, dtype=torch.int64, device=device)
    # each run's first sorted position, by a write to unique targets
    first = torch.zeros(n + 1, dtype=torch.int64, device=device)
    first[torch.where(starts, run, n)] = pos
    lower_sorted = build_before[first[run]]
    # back to the probe rows' own positions (unique targets; build rows
    # write the dropped extra slot)
    target = torch.where(is_build, npr, perm - nb)
    lower = torch.zeros(npr + 1, dtype=torch.int64, device=device)
    upper = torch.zeros(npr + 1, dtype=torch.int64, device=device)
    lower[target] = lower_sorted
    upper[target] = build_before
    return lower[:npr], upper[:npr]


def join_bounds(build_cols: list, build_live, probe_cols: list, probe_live):
    """Per-probe-row [lower, upper) ranges into the key-sorted build order.

    Returns (build_order, lower, upper) where ``build_order`` maps sorted
    positions to original build row indices."""
    build_cols, probe_cols = _common_widths(build_cols, probe_cols)
    build_order, sorted_cols, sorted_live = sort_build(build_cols, build_live)
    lower, upper = probe_bounds(sorted_cols, sorted_live, probe_cols, probe_live)
    return build_order, lower, upper


def gather_pairs(build_order, lower, counts, probe_live, out_cap: int):
    """Expand per-probe match ranges into (probe_idx, build_idx) pair arrays
    of length ``out_cap`` with a live-pair mask and the total count. Pairs
    come probe-major, and within a probe row in the build's key order."""
    ends = torch.cumsum(counts.to(torch.int64), 0)
    offsets = ends - counts  # start of probe i's pairs
    total = counts.sum()
    j = torch.arange(out_cap, dtype=torch.int64, device=counts.device)
    # probe index for output slot j: last i with offsets[i] <= j
    probe_idx = torch.searchsorted(ends, j, right=True)
    probe_idx = torch.clamp(probe_idx, 0, lower.shape[0] - 1)
    within = j - offsets[probe_idx]
    sorted_pos = torch.clamp(lower[probe_idx] + within, 0, build_order.shape[0] - 1)
    build_idx = build_order[sorted_pos]
    pair_live = j < total
    return probe_idx, build_idx, pair_live, total
