"""TPC-DS through the port, from SQL text, against the JAX package.

- The port's numpy generator makes the 24 tables value for value as the JAX
  generator's Arrow tables, at SF 0.004.
- At ``tests/test_tpcds.py``'s scale (SF 0.004, 2 shuffle partitions,
  incompatibleOps on), each query in scope runs through the port's device
  engine (``device="cpu"``) with nothing off the device but scans, the
  subqueries' plans included, and its rows equal the port's CPU engine
  within ``tests/test_tpcds.py``'s tolerance (the harness's, plus 0.011
  on the float columns a ``round()`` reaches).
- The same rows equal the JAX CPU engine. The JAX CPU engine takes 3 s or
  more to compile and collect 21 of the texts (2, 4, 5, 11, 14, 31, 38,
  39, 47, 49, 51, 57, 59, 64, 65, 66, 67, 72, 75, 77, 87; most of it
  recomputing the logical ``schema`` of deep plans), so their comparison
  with it is marked ``slow``; the port's own check of them is not.
- q41 raises the JAX package's ``SqlError`` in both packages.

q13 and q48 are left out: their dimension joins sit inside the WHERE's OR
branches, so both packages plan a stack of cartesian products over the
facts, which the JAX CPU engine cannot hold in memory even at this scale.
"""
from __future__ import annotations

import pytest
import torch

pytest.importorskip("jax")  # the reference; absent on a machine with only the port

from harness import cpu_session  # noqa: E402
from spark_rapids_tpu.sql.parser import SqlError as JaxSqlError  # noqa: E402
from spark_rapids_tpu.tpcds import gen_table as jax_gen_table  # noqa: E402
from spark_rapids_tpu.tpcds import register_tables as jax_register  # noqa: E402
from spark_rapids_tpu_torch import TorchSession  # noqa: E402
from spark_rapids_tpu_torch.columnar.host import from_arrow, to_pylist  # noqa: E402
from spark_rapids_tpu_torch.sql.parser import SqlError  # noqa: E402
from spark_rapids_tpu_torch.testing import tpcds_check  # noqa: E402
from spark_rapids_tpu_torch.tpcds import QUERY_IDS, TABLES, gen_table, register_tables, tpcds_sql  # noqa: E402

SF = 0.004

#: the texts the JAX package cannot run to their end (module docstring)
OUT_OF_SCOPE = (13, 41, 48)
IN_SCOPE = [q for q in QUERY_IDS if q not in OUT_OF_SCOPE]
#: the texts the JAX CPU engine takes 3 s or more to compile and collect
JAX_SLOW = {2, 4, 5, 11, 14, 31, 38, 39, 47, 49, 51, 57, 59, 64, 65, 66, 67, 72, 75, 77, 87}

CONF = {"spark.sql.shuffle.partitions": 2, "spark.rapids.sql.incompatibleOps.enabled": True}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in several
    worker processes at once, and torch's thread pools oversubscribe the
    cores (queries slow down tenfold and more)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", TABLES)
def test_table_matches_jax_generator(name):
    want = from_arrow(jax_gen_table(name, SF))
    got = gen_table(name, SF)
    assert got.schema == want.schema
    assert got.num_rows == want.num_rows
    for f, a, b in zip(got.schema, got.columns, want.columns):
        assert to_pylist(a) == to_pylist(b), f"{name}.{f.name}"


@pytest.fixture(scope="module")
def port_sessions():
    dev = TorchSession({**CONF, "spark.rapids.sql.test.enabled": True}, device="cpu")
    cpu = TorchSession({**CONF, "spark.rapids.sql.enabled": False}, device="cpu")
    register_tables(dev, SF)
    register_tables(cpu, SF)
    return dev, cpu


@pytest.fixture(scope="module")
def jax_cpu():
    s = cpu_session()
    jax_register(s, SF)
    return s


#: query → (DataFrame, device rows) of the port's device engine, per worker
_DEVICE_ROWS: dict = {}


def _device_rows(dev, q: int):
    if q not in _DEVICE_ROWS:
        df = dev.sql(tpcds_sql(q))
        rows = df.collect()
        off = [
            (e.node, e.reasons)
            for e in dev._last_overrides.explain
            if not e.on_device and not e.node.startswith("CpuScan")
        ]
        assert not off, f"q{q} off the device: {off}"
        _DEVICE_ROWS[q] = (df, rows)
    return _DEVICE_ROWS[q]


@pytest.mark.parametrize("q", IN_SCOPE)
def test_device_engine_matches_cpu_engine(q, port_sessions):
    dev, cpu = port_sessions
    df, got = _device_rows(dev, q)
    ok, msg = tpcds_check(tpcds_sql(q), df, cpu.sql(tpcds_sql(q)).collect(), got)
    assert ok, f"q{q}: {msg}"


@pytest.mark.parametrize(
    "q",
    [pytest.param(q, marks=pytest.mark.slow) if q in JAX_SLOW else q for q in IN_SCOPE],
)
def test_device_engine_matches_jax_cpu_engine(q, port_sessions, jax_cpu):
    df, got = _device_rows(port_sessions[0], q)
    ok, msg = tpcds_check(tpcds_sql(q), df, jax_cpu.sql(tpcds_sql(q)).collect(), got)
    assert ok, f"q{q}: {msg}"


def test_q41_raises_the_jax_sql_error(port_sessions, jax_cpu):
    with pytest.raises(JaxSqlError) as jx:
        jax_cpu.sql(tpcds_sql(41))
    with pytest.raises(SqlError) as px:
        port_sessions[0].sql(tpcds_sql(41))
    assert str(px.value) == str(jx.value)
    assert "correlated scalar subquery supports equality correlation only" in str(px.value)


def test_tpcds_path_imports_no_jax_no_jax_package_and_no_pyarrow():
    """The SQL front-end, the generator and both engines over TPC-DS texts
    with windows (q47, q67), a cartesian product (q28), rollups (q36),
    EXISTS decorrelation (q10) and round() (q78) leave jax, every
    spark_rapids_tpu module and pyarrow out of sys.modules."""
    import pathlib
    import subprocess
    import sys

    code = """
import sys
import torch
torch.set_num_threads(1)
from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch.tpcds import register_tables, tpcds_sql
for enabled in (True, False):
    s = TorchSession({"spark.rapids.sql.enabled": enabled,
                      "spark.rapids.sql.incompatibleOps.enabled": True}, device="cpu")
    register_tables(s, 0.001)
    for q in (10, 28, 36, 47, 67, 78):
        s.sql(tpcds_sql(q)).collect()
bad = sorted(
    m for m in sys.modules
    if m.split(".")[0] in ("jax", "jaxlib", "spark_rapids_tpu", "pyarrow")
)
print("BAD", bad)
"""
    root = pathlib.Path(__file__).resolve().parents[1]
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=root
    )
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
