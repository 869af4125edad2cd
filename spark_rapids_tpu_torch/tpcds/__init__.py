"""TPC-DS rig: scalable generator + the 99-query battery as SQL text.

The north-star workload (BASELINE.json: TPC-DS SF1000, 99 queries): a
dsdgen-shaped deterministic generator and every query from (sql-parsed)
text. ``register_tables(session, sf)`` registers the 24 tables as temp
views on a ``TorchSession``.

Copied from ``spark_rapids_tpu/tpcds/__init__.py`` (without the parquet
writer).
"""
from .datagen import TABLES, gen_table, register_tables
from .queries_sql import ALL as QUERY_IDS
from .queries_sql import tpcds_sql

__all__ = [
    "TABLES",
    "gen_table",
    "register_tables",
    "QUERY_IDS",
    "tpcds_sql",
]
