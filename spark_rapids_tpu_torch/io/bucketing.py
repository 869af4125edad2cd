"""Bucketed table layout — the standalone analogue of Spark's bucketed
reads (reference: GpuFileSourceScanExec.scala:148-149 ``bucketedScan`` and
the bucket-pruning filter pushdown).

The writer routes each row to one of ``num_buckets`` files per task by
Spark's bucket id — ``pmod(murmur3(bucket cols, seed 42), n)``, the same
hash the exchange uses — and records the spec in a ``_bucket_spec.json``
sidecar next to the data (the Hive metastore's role in Spark). The scan
prunes whole bucket FILES when every bucket column is equality-constrained
by a pushed-down predicate: the matching rows can only live in the bucket
the literals hash to.

Copied from ``spark_rapids_tpu/io/bucketing.py`` over the port's
``HostBatch``: the ids come from the port's numpy murmur3 through the CPU
engine's hash exchange code path, so a bucketed write and a hash shuffle
agree on placement.
"""
from __future__ import annotations

import json
import os
import re
from typing import Optional

import numpy as np

SPEC_FILE = "_bucket_spec.json"
_BUCKET_RE = re.compile(r"_b(\d{5})\.[A-Za-z0-9.]+$")


def write_spec(root: str, num_buckets: int, cols: list[str]) -> None:
    with open(os.path.join(root, SPEC_FILE), "w") as f:
        json.dump({"num_buckets": int(num_buckets), "cols": list(cols)}, f)


def read_spec(root: str) -> Optional[dict]:
    p = os.path.join(root, SPEC_FILE)
    if not os.path.isfile(p):
        return None
    try:
        with open(p) as f:
            spec = json.load(f)
        if spec.get("num_buckets", 0) > 0 and spec.get("cols"):
            return spec
    except (OSError, ValueError):
        pass
    return None


def parse_bucket_id(filename: str) -> Optional[int]:
    m = _BUCKET_RE.search(filename)
    return int(m.group(1)) if m else None


def batch_bucket_ids(rb, schema, cols: list[str]) -> np.ndarray:
    """Per-row murmur3 fold over the bucket columns (int32, pre-pmod) —
    identical code path to the CPU engine's hash exchange so a bucketed
    write and a hash shuffle agree on placement."""
    from ..exec.cpu import _cpu_ctx, _val_to_np
    from ..expr.base import UnresolvedAttribute, bind
    from ..ops.hash import murmur3_rows

    ctx = _cpu_ctx(rb, schema)
    hashed = []
    for name in cols:
        e = bind(UnresolvedAttribute(name), schema)
        d, v = _val_to_np(ctx, e.eval(ctx))
        hashed.append((e.data_type, d, v, None))
    return murmur3_rows(np, hashed, rb.num_rows)


def bucket_ids(rb, schema, spec: dict) -> np.ndarray:
    from ..ops.hash import partition_ids

    h = batch_bucket_ids(rb, schema, spec["cols"])
    return partition_ids(np, h, spec["num_buckets"])


def target_bucket(spec: dict, predicates, schema) -> Optional[int]:
    """Bucket id the pushed-down equality literals hash to, or None when
    any bucket column lacks an ``=`` conjunct (no pruning possible)."""
    from ..columnar.host import HostBatch, column_from_pylist

    by_name = {}
    for name, op, value in predicates:
        if op == "=" and value is not None:
            by_name.setdefault(name, value)
    if not all(c in by_name for c in spec["cols"]):
        return None
    try:
        fields = [schema[schema.index_of(c)] for c in spec["cols"]]
        cols = [column_from_pylist([by_name[f.name]], f.data_type) for f in fields]
    except (AttributeError, KeyError, TypeError, ValueError, OverflowError):
        return None
    sub_schema = type(schema)(fields)
    return int(bucket_ids(HostBatch(sub_schema, cols, 1), sub_schema, spec)[0])
