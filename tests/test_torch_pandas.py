"""The pandas execs on the PyTorch port: ``map_in_pandas``,
``apply_in_pandas``, ``cogroup(...).apply_in_pandas``, grouped-aggregate
pandas UDFs (``_agg_in_pandas``) and the windowed pandas UDF. They run on
the host over pandas, in the JAX package too; the port converts its numpy
batches to pandas under pyarrow's conventions without needing pyarrow.

The JAX package's ``test_pandas_interop.py`` runs unchanged, its session
class swapped for a port session on ``device="cpu"`` (its ``F``, ``col``,
``Window`` and types stay the JAX package's; the mirror helpers of
``tests/test_torch_dataframe_api.py`` rebuild them as the port's). Each test
holds the port's device-session rows to its port CPU-engine rows and to the
literal rows the JAX package's own run must give.
"""
from __future__ import annotations

import importlib
import inspect

import numpy as np
import pytest
import torch

from tests.test_torch_dataframe_api import PortFrame, _Forward, to_port

REF = "test_pandas_interop"

#: reference tests mirrored by a test of this file, each with its name
MIRRORED_ELSEWHERE = {
    "test_pandas_interop::test_map_in_pandas_prefetch_overlap":
        "test_map_in_pandas_prefetch_overlap (imports the JAX session in its body)",
    "test_pandas_interop::TestDdlSchema::test_parse_ddl":
        "test_parse_ddl (imports the JAX types in its body)",
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class PortTpuSession(_Forward):
    """The suite's ``TpuSession(conf)`` as a port session on the CPU."""

    def __init__(self, conf=None):
        from spark_rapids_tpu_torch import TorchSession

        self._s = TorchSession(dict(conf or {}), device="cpu")
        self._target = self._s

    def create_dataframe(self, data, schema=None, num_partitions: int = 1):
        return PortFrame(self._s.create_dataframe(data, to_port(schema), num_partitions))


def _reference_tests():
    mod = importlib.import_module(REF)
    for name, obj in inspect.getmembers(mod):
        if inspect.isclass(obj) and name.startswith("Test") and obj.__module__ == mod.__name__:
            for mname, _ in inspect.getmembers(obj, inspect.isfunction):
                if mname.startswith("test_"):
                    yield f"{REF}::{name}::{mname}", obj, mname
        elif inspect.isfunction(obj) and name.startswith("test_") \
                and obj.__module__ == mod.__name__:
            yield f"{REF}::{name}", None, name


CASES = [
    pytest.param(cls, name, id=key)
    for key, cls, name in _reference_tests()
    if key not in MIRRORED_ELSEWHERE
]


@pytest.mark.parametrize("cls,name", CASES)
def test_mirror(cls, name, monkeypatch):
    mod = importlib.import_module(REF)
    monkeypatch.setattr(mod, "TpuSession", PortTpuSession)
    if cls is None:
        getattr(mod, name)()
    else:
        getattr(cls(), name)()


def test_mirror_covers_every_suite():
    every = {key for key, _, _ in _reference_tests()}
    assert {p.id for p in CASES} | set(MIRRORED_ELSEWHERE) == every
    assert len(every) == 17


def test_map_in_pandas_prefetch_overlap():
    """``test_pandas_interop.py::test_map_in_pandas_prefetch_overlap`` on the
    port: the producer thread, error relay, and equal results with the
    prefetch on and off."""
    import threading

    import pyarrow as pa

    from spark_rapids_tpu_torch import TorchSession
    from spark_rapids_tpu_torch.exec.cpu_pandas import prefetched

    seen_threads = set()

    def gen():
        for i in range(10):
            seen_threads.add(threading.get_ident())
            yield i

    assert list(prefetched(gen(), depth=2)) == list(range(10))
    assert threading.get_ident() not in seen_threads

    def boom():
        yield 1
        raise ValueError("produce failed")

    it = prefetched(boom(), depth=2)
    assert next(it) == 1
    with pytest.raises(ValueError, match="produce failed"):
        next(it)

    t = pa.table({"a": list(range(1000)), "b": [i % 7 for i in range(1000)]})

    def fn(dfs):
        for df in dfs:
            df = df.copy()
            df["c"] = df["a"] * 2 + df["b"]
            yield df

    rows = {}
    for depth in ("0", "3"):
        s = TorchSession({
            "spark.rapids.sql.enabled": True,
            "spark.rapids.sql.python.prefetchBatches": depth,
            "spark.rapids.sql.batchSizeRows": "128",
        }, device="cpu")
        df = s.create_dataframe(t, num_partitions=2).map_in_pandas(fn, "a long, b long, c long")
        rows[depth] = sorted(df.collect())
    assert rows["0"] == rows["3"]
    assert rows["3"] == sorted((a, a % 7, 2 * a + a % 7) for a in range(1000))


def test_parse_ddl():
    """``TestDdlSchema::test_parse_ddl`` on the port's types."""
    from spark_rapids_tpu_torch.types import ArrayType, DecimalType, parse_ddl_schema

    sch = parse_ddl_schema("a long, b double, c string, d decimal(10,2), e array<int>")
    assert sch.names == ["a", "b", "c", "d", "e"]
    assert isinstance(sch["d"].data_type, DecimalType)
    assert sch["d"].data_type.precision == 10
    assert isinstance(sch["e"].data_type, ArrayType)


def test_to_pandas_follows_arrow_conventions():
    """The port's batch → pandas conversion gives the frame pyarrow's
    ``to_pandas`` gives for the same table: integer nulls as NaN floats,
    boolean nulls and dates as objects, pandas' string dtype, UTC
    timestamps. Nested values are Python lists and dicts (pyarrow hands a
    list as a numpy array)."""
    import datetime as dt

    import pyarrow as pa

    from spark_rapids_tpu_torch.columnar.host import from_arrow
    from spark_rapids_tpu_torch.exec.cpu_pandas import to_pandas

    t = pa.table({
        "i": pa.array([1, None, 3], type=pa.int64()),
        "j": pa.array([1, 2, 3], type=pa.int32()),
        "f": pa.array([1.5, None, float("nan")]),
        "b": pa.array([True, None, False]),
        "s": pa.array(["x", None, "zz"]),
        "d": pa.array([dt.date(2020, 1, 2), None, dt.date(1969, 12, 31)]),
        "t": pa.array([dt.datetime(2021, 3, 4, 5, 6, 7), None, dt.datetime(1970, 1, 1)],
                      type=pa.timestamp("us", tz="UTC")),
        "a": pa.array([[1, None], None, []], type=pa.list_(pa.int64())),
        "st": pa.array([{"x": 1, "y": "a"}, None, {"x": None, "y": None}],
                       type=pa.struct([("x", pa.int64()), ("y", pa.string())])),
    })
    got, want = to_pandas(from_arrow(t)), t.to_pandas()
    assert list(got.columns) == list(want.columns)
    assert got["a"].tolist() == [[1, None], None, []]
    assert got["st"].tolist() == [{"x": 1, "y": "a"}, None, {"x": None, "y": None}]
    for c in ["i", "j", "f", "b", "s", "d", "t"]:
        assert got[c].dtype == want[c].dtype or c == "t", c
        assert got[c].isna().tolist() == want[c].isna().tolist(), c
        ok = ~want[c].isna()
        assert got[c][ok].tolist() == want[c][ok].tolist(), c
