"""UDFs on the PyTorch port: the device UDF (``torch_udf``, the JAX
package's ``jax_udf``), python UDFs with the udf-compiler pass
(``spark.rapids.sql.udfCompiler.enabled``), and the pandas UDFs.

The JAX package's ``test_udf.py`` and ``test_udf_compiler.py`` run unchanged
through the mirror helpers of ``tests/test_torch_dataframe_api.py``:
``assert_cpu_and_tpu_equal`` holds the port's device rows to the JAX CPU
engine's and the JAX device engine's, ``tpu_session`` is a port device
session (on ``device="cpu"``), and a ``jax_udf`` becomes a ``TorchUdf`` that
calls the same jnp function. The suites' plan checks read the port's plan
with its ``Gpu`` operator names shown as the JAX package's ``Tpu`` ones
(``GpuProjectExec`` is the ``TpuProjectExec`` of the port).

Below them, a ``torch_udf`` written with torch ops is held to the JAX
engines running the same arithmetic as a jnp ``jax_udf``.
"""
from __future__ import annotations

import importlib
import inspect

import numpy as np
import pytest
import torch

from tests.test_torch_dataframe_api import (  # the shared mirror helpers
    PortSession,
    _param_sets,
    patch_module,
    run_reference,
)
from tests.test_torch_nested import assert_jax_engines_and_port_equal

REF_MODULES = ("test_udf", "test_udf_compiler")

#: reference tests mirrored by a test of this file, each with its name
MIRRORED_ELSEWHERE = {
    "test_udf::test_python_udf_numeric":
        "test_python_udf_numeric_on_cpu_engine (the reference runs only its CPU engine)",
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class _TpuNamedPlan:
    """The port's physical plan, its tree string with the JAX package's
    operator prefix."""

    def __init__(self, plan):
        self._plan = plan

    def tree_string(self) -> str:
        return self._plan.tree_string().replace("Gpu", "Tpu")


class UdfPortSession(PortSession):
    """``PortSession`` whose last plan reads with the JAX operator names."""

    @property
    def _last_plan(self):
        return _TpuNamedPlan(self._s._last_plan)


def _reference_tests():
    """(module, name, function) of every test of the suites: their device
    checks sit in shared helpers (``_check_translated``), so every test is
    mirrored, not only those naming the device session themselves."""
    for name in REF_MODULES:
        mod = importlib.import_module(name)
        for fname, fn in inspect.getmembers(mod, inspect.isfunction):
            if fname.startswith("test_") and fn.__module__ == mod.__name__:
                yield name, fname, fn


CASES = [
    pytest.param(name, fname, kwargs, id=f"{name}::{fname}" + (f"[{label}]" if label else ""))
    for name, fname, fn in _reference_tests()
    if f"{name}::{fname}" not in MIRRORED_ELSEWHERE
    for kwargs, label in _param_sets(fn)
]


@pytest.mark.parametrize("module,fname,kwargs", CASES)
def test_mirror(module, fname, kwargs, monkeypatch, request):
    mod = importlib.import_module(module)
    patch_module(mod, monkeypatch)
    monkeypatch.setattr(mod, "assert_cpu_and_tpu_equal", assert_jax_engines_and_port_equal,
                        raising=False)
    monkeypatch.setattr(mod, "tpu_session", UdfPortSession)
    run_reference(mod, getattr(mod, fname), kwargs, request)


def test_mirror_covers_every_suite():
    mirrored = {f"{p.values[0]}::{p.values[1]}" for p in CASES}
    every = {f"{name}::{fname}" for name, fname, _ in _reference_tests()}
    assert mirrored | set(MIRRORED_ELSEWHERE) == every
    assert len(every) == 37
    for key in MIRRORED_ELSEWHERE:
        assert key in every, key


def test_python_udf_numeric_on_cpu_engine():
    """``test_udf.py::test_python_udf_numeric`` on the port's CPU engine."""
    from spark_rapids_tpu_torch import TorchSession
    from spark_rapids_tpu_torch.functions import col, udf
    from spark_rapids_tpu_torch.types import LONG

    @udf(returnType=LONG)
    def collatz(x):
        return 3 * x + 1 if x % 2 else x // 2

    s = TorchSession({"spark.rapids.sql.enabled": False}, device="cpu")
    rows = s.create_dataframe({"x": np.arange(1, 50, dtype=np.int64)}).select(
        collatz(col("x")).alias("c")).collect()
    assert rows[0] == (4,) and rows[1] == (1,)


# ── torch_udf against jax_udf ──────────────────────────────────────────────


def _table(n=300, seed=21):
    import pyarrow as pa

    rng = np.random.default_rng(seed)
    x = rng.integers(-1000, 1000, size=n)
    y = rng.normal(size=n) * 100
    return pa.table({
        "x": pa.array(x, type=pa.int64(), mask=rng.random(n) < 0.1),
        "y": pa.array(y, mask=rng.random(n) < 0.1),
    })


def test_torch_udf_equals_jax_udf():
    """A ``torch_udf`` over two columns, inside a filter and an arithmetic
    projection, gives the rows the JAX engines give for the same function
    written with jnp (nulls propagate the same way), and the port's
    projection stays on the device."""
    import jax.numpy as jnp

    from spark_rapids_tpu.functions import col as jcol
    from spark_rapids_tpu.functions import jax_udf
    from spark_rapids_tpu.types import DOUBLE as JDOUBLE
    from spark_rapids_tpu_torch.functions import col, torch_udf
    from spark_rapids_tpu_torch.types import DOUBLE
    from tests.harness import _normalize, cpu_session, tpu_session

    t = _table()
    jf = jax_udf(lambda x, y: jnp.sqrt(jnp.abs(x.astype(jnp.float64) * y)) + x % 7,
                 returnType=JDOUBLE)
    pf = torch_udf(lambda x, y: torch.sqrt(torch.abs(x.to(torch.float64) * y)) + x % 7,
                   returnType=DOUBLE)

    def jax_rows(s):
        df = s.create_dataframe(t, num_partitions=2).filter(jcol("x") > -500)
        return _normalize(df.select((jf(jcol("x"), jcol("y")) * 2).alias("v")).collect(), True)

    s = PortSession()
    df = s.create_dataframe(t, num_partitions=2).filter(col("x") > -500)
    got = _normalize(df.select((pf(col("x"), col("y")) * 2).alias("v"))._df.collect(), True)
    for want in (jax_rows(cpu_session()), jax_rows(tpu_session())):
        assert len(got) == len(want)
        for (a,), (b,) in zip(got, want):
            assert (a is None and b is None) or abs(a - b) <= max(1e-9 * abs(b), 1e-11)
    assert any(e.on_device and "Project" in e.node for e in s._s._last_overrides.explain)


def test_torch_udf_cpu_engine_equals_device():
    """The CPU engine hands ``fn`` the numpy columns as CPU tensors; its rows
    equal the device engine's bit for bit."""
    from spark_rapids_tpu_torch import TorchSession
    from spark_rapids_tpu_torch.functions import col, torch_udf
    from spark_rapids_tpu_torch.types import LONG

    t = _table()
    f = torch_udf(lambda x: x * 3 - (x >> 2), returnType=LONG)
    rows = []
    for enabled in (True, False):
        s = TorchSession({"spark.rapids.sql.enabled": enabled}, device="cpu")
        rows.append(sorted(s.create_dataframe(t).select(f(col("x")).alias("v")).collect(),
                           key=lambda r: (r[0] is None, r[0] or 0)))
    assert rows[0] == rows[1]
