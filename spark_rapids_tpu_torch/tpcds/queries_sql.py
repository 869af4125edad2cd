"""The TPC-DS 99-query battery as SQL text, run through the sql/ front-end.

Query texts follow the spec templates' shapes — CTE reuse (q1/q30/q47/q57/
q64/q95), correlated scalar aggregates (q1/q6/q32/q41/q92), EXISTS chains
(q10/q16/q35/q69/q94), OR-of-EXISTS (q10/q35), rollups with grouping()
ranks (q18/q27/q36/q67/q70/q86), window ratios (q12/q20/q51/q98), channel
unions (q2/q5/q14/q33/q56/q60/q66/q71/q75/q76/q80), intersect/except
(q8/q14/q38/q87), full outer joins (q51/q97), and day-bucket pivots
(q50/q62/q88/q99) — with validation-style parameters chosen inside the
generator's value domains so results are non-vacuous at small SF.

The differential anchor is engine-vs-engine (tests/test_tpcds.py): both the
device plan and the CPU oracle consume the same parsed plan, exactly like
the reference consumes Spark's parse of its qa battery.

Copied from ``spark_rapids_tpu/tpcds/queries_sql.py``.
"""
from __future__ import annotations

from .q01_25 import Q as _Q1
from .q26_50 import Q as _Q2
from .q51_75 import Q as _Q3
from .q76_99 import Q as _Q4

_ALL = {}
for part in (_Q1, _Q2, _Q3, _Q4):
    _ALL.update(part)

ALL = sorted(_ALL)
assert ALL == list(range(1, 100)), f"missing queries: {set(range(1,100)) - set(ALL)}"


def tpcds_sql(n: int) -> str:
    """SQL text of TPC-DS query ``n`` (1-99)."""
    return _ALL[n]
