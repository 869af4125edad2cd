"""SQL front-end: a SELECT-subset parser + compiler onto the DataFrame API.

The reference rides Spark's own parser/analyzer and ships a ~756-SELECT QA
battery (integration_tests/src/main/python/qa_nightly_sql.py); this package
is the standalone analogue — enough SQL to run the TPC-H and TPC-DS query
texts against the engine's existing logical planner:

  SELECT [DISTINCT] items | * FROM tables/joins/subqueries
  WHERE / GROUP BY [ROLLUP|CUBE|GROUPING SETS] / HAVING / ORDER BY / LIMIT
  WITH ctes, UNION [ALL] / INTERSECT / EXCEPT
  scalar + IN + EXISTS subqueries (correlated ones decorrelated to joins)
  window functions OVER (PARTITION BY .. ORDER BY .. ROWS|RANGE BETWEEN ..)
  CASE, CAST, EXTRACT, INTERVAL / DATE literals, BETWEEN / LIKE / IN / IS

Entry points: ``TorchSession.sql(text)``, ``parse(text)`` (AST),
``bind_parameters`` (substitute ``?`` placeholders — the PREPARE/BIND
seam), and ``Compiler`` (AST -> DataFrame).

Copied from ``spark_rapids_tpu/sql/__init__.py``.
"""
from .parser import bind_parameters, parse
from .compiler import Compiler

__all__ = ["bind_parameters", "parse", "Compiler"]
