"""Numpy kernels for the CPU (fallback/oracle) engine.

These implement Spark-exact semantics with the same spec as the device
kernels in ops/ — the differential test harness (tests/harness.py) compares
the two engines, which is the reference's CPU-vs-GPU equality strategy
(SparkQueryCompareTestSuite.scala) turned inward.

Copied from ``spark_rapids_tpu/exec/cpu_kernels.py``.
"""
from __future__ import annotations

import numpy as np

from ..types import (
    BooleanType,
    DataType,
    DoubleType,
    FloatType,
    StringType,
)


def normalized_float_bits(data: np.ndarray) -> np.ndarray:
    """Float -> comparable int64 bits with Spark's grouping/join/sort
    normalization: -0.0 == 0.0 and one canonical NaN."""
    x = np.where(data == 0, np.zeros_like(data), data)
    x = np.where(np.isnan(x), np.full_like(x, np.nan), x)
    return x.astype(np.float64).view(np.int64)


def encode_group_key(dt: DataType, data: np.ndarray, valid: np.ndarray):
    """Encode one key column into int64 word columns such that equal words ⇔
    same Spark group (nulls one group, NaNs one group, -0.0 == 0.0).
    Returns a list of int64 arrays (validity word + value word)."""
    from ..types import is_complex

    n = len(valid)
    vw = valid.astype(np.int64)
    if isinstance(dt, StringType) or is_complex(dt):
        def canon(v):
            if isinstance(v, list):
                return tuple(canon(x) for x in v)
            if isinstance(v, dict):
                return tuple((k, canon(x)) for k, x in sorted(v.items()))
            if isinstance(v, tuple):
                return tuple(canon(x) for x in v)
            return v

        vocab: dict = {}
        codes = np.zeros(n, dtype=np.int64)
        for i in range(n):
            if not valid[i]:
                continue
            key = canon(data[i])
            code = vocab.get(key)
            if code is None:
                code = len(vocab) + 1
                vocab[key] = code
            codes[i] = code
        return [vw, codes]
    if isinstance(dt, (FloatType, DoubleType)):
        return [vw, np.where(valid, normalized_float_bits(data), 0)]
    return [vw, np.where(valid, data.astype(np.int64), 0)]


def group_inverse(encoded_cols: list[np.ndarray], n: int):
    """(inverse ids, first-occurrence row index per group). Group order is
    first-occurrence order (stable, like streaming aggregation)."""
    if not encoded_cols:
        return np.zeros(n, dtype=np.int64), np.zeros(min(n, 1), dtype=np.int64)
    mat = np.stack(encoded_cols, axis=1)
    # np.unique(axis=0) sorts; recover first-occurrence order for stability
    uniq, first_idx, inverse = np.unique(
        mat, axis=0, return_index=True, return_inverse=True
    )
    order = np.argsort(first_idx, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    return rank[inverse], first_idx[order]


_NULL_SENTINEL_F = -(2**62)


def _canon_value(v):
    """Hashable canonical form with Spark value equality (NaN == NaN)."""
    import math

    if isinstance(v, float) and math.isnan(v):
        return "__NaN__"
    if isinstance(v, list):
        return tuple(_canon_value(x) for x in v)
    if isinstance(v, dict):
        return tuple((k, _canon_value(x)) for k, x in sorted(v.items()))
    return v


def _sorted_set(items: list) -> list:
    """Deterministic collect_set order: value-ascending with canonical
    floats (-0.0 → 0.0, NaN greatest) — mirrors the device kernel's
    value-sorted dedupe. Spark guarantees no order for collect_set, so a
    canonical order is a compatible (and testable) choice."""
    import math

    def canon(v):
        if isinstance(v, float) and v == 0.0:
            return 0.0
        return v

    def key(v):
        if isinstance(v, float):
            return (1, 0.0) if math.isnan(v) else (0, v)
        return (0, v)

    vals = [canon(v) for v in items]
    try:
        return sorted(vals, key=key)
    except TypeError:
        return vals


def _dedup_spark(items: list) -> list:
    seen = set()
    out = []
    for v in items:
        k = _canon_value(v)
        if k not in seen:
            seen.add(k)
            out.append(v)
    return out


def reduce_groups(
    op: str,
    dt: DataType,
    data: np.ndarray,
    valid: np.ndarray,
    inv: np.ndarray,
    num_groups: int,
):
    """One segment reduction; returns (data[num_groups], valid[num_groups])."""
    G = num_groups
    any_valid = np.zeros(G, dtype=bool)
    np.logical_or.at(any_valid, inv, valid)
    if op == "count":
        out = np.zeros(G, dtype=np.int64)
        np.add.at(out, inv[valid], 1)
        return out, np.ones(G, dtype=bool)
    if op == "sum":
        out = np.zeros(G, dtype=data.dtype)
        np.add.at(out, inv[valid], data[valid])
        return out, any_valid
    if isinstance(dt, StringType) and op in ("min", "max"):
        # python loop: UTF-8 byte order like Spark's UTF8String.compareTo
        out = np.empty(G, dtype=object)
        outv = np.zeros(G, dtype=bool)
        for i in range(len(inv)):
            g = inv[i]
            if not valid[i]:
                continue
            v = data[i]
            if not outv[g]:
                out[g], outv[g] = v, True
            elif op == "min" and v.encode() < out[g].encode():
                out[g] = v
            elif op == "max" and v.encode() > out[g].encode():
                out[g] = v
        return out, outv
    if op in ("min", "max"):
        if np.issubdtype(data.dtype, np.floating):
            fill = np.inf if op == "min" else -np.inf
            x = np.where(valid, data, fill)
            # Spark NaN ordering: NaN greatest. max is NaN where a NaN was
            # seen; min is NaN only where every valid value was NaN, and
            # otherwise the minimum of the others (+inf included)
            is_nan = valid & np.isnan(data)
            x = np.where(np.isnan(x), fill, x)
            out = np.full(G, fill, dtype=data.dtype)
            (np.minimum if op == "min" else np.maximum).at(out, inv, x)
            if op == "max":
                had_nan = np.zeros(G, dtype=bool)
                np.logical_or.at(had_nan, inv, is_nan)
                out = np.where(had_nan, np.nan, out)
            else:
                had_number = np.zeros(G, dtype=bool)
                np.logical_or.at(had_number, inv, valid & ~is_nan)
                out = np.where(any_valid & ~had_number, np.nan, out)
            return out, any_valid
        info = np.iinfo(data.dtype)
        fill = info.max if op == "min" else info.min
        x = np.where(valid, data, fill)
        out = np.full(G, fill, dtype=data.dtype)
        (np.minimum if op == "min" else np.maximum).at(out, inv, x)
        return out, any_valid
    if op in ("collect_list", "collect_set", "merge_lists", "merge_sets"):
        out = np.empty(G, dtype=object)
        for g in range(G):
            out[g] = []
        merging = op.startswith("merge")
        for i in range(len(inv)):
            if not valid[i]:
                continue
            if merging:
                out[inv[i]].extend(data[i])
            else:
                out[inv[i]].append(data[i])
        if op in ("collect_set", "merge_sets"):
            for g in range(G):
                out[g] = _sorted_set(_dedup_spark(out[g]))
        # collect results are never null — empty array for all-null groups
        return out, np.ones(G, dtype=bool)
    idx = np.arange(len(inv), dtype=np.int64)
    big = np.int64(2**62)
    if op == "first":
        pick = np.full(G, big)
        np.minimum.at(pick, inv, idx)
    elif op == "last":
        pick = np.full(G, -1, dtype=np.int64)
        np.maximum.at(pick, inv, idx)
    elif op == "first_ignore_nulls":
        pick = np.full(G, big)
        np.minimum.at(pick, inv, np.where(valid, idx, big))
    elif op == "last_ignore_nulls":
        pick = np.full(G, -1, dtype=np.int64)
        np.maximum.at(pick, inv, np.where(valid, idx, -1))
    else:
        raise ValueError(op)
    ok = (pick != big) & (pick >= 0)
    safe = np.clip(pick, 0, max(len(inv) - 1, 0))
    out = data[safe] if len(inv) else np.zeros(G, dtype=data.dtype)
    outv = (valid[safe] if len(inv) else np.zeros(G, dtype=bool)) & ok
    return out, outv
