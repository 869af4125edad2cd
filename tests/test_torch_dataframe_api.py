"""The JAX package's DataFrame-surface suites, mirrored on the PyTorch port.

Each mirrored case runs a reference test function unchanged, with the names
of its module swapped as ``tests/test_torch_exprs.py`` swaps them:

* ``assert_cpu_and_tpu_equal`` runs the query on the JAX CPU engine and on
  the port's device engine (``device="cpu"``, test mode) and compares the
  rows with the harness's normalization and tolerance;
* ``tpu_session`` gives a port device session (every session method, with
  JAX-package arguments rebuilt as the port's);
* ``broadcast`` marks a port DataFrame, and the suites' plan finders
  (``_find_topn``, ``_find_exchange(s)``, ``_find_join``) look for the
  port's operators.

Mirrored are the reference tests that touch the device engine (their source
names ``assert_cpu_and_tpu_equal`` or ``tpu_session``) of
``test_dataframe_api.py``, ``test_qa_battery.py``, ``test_qa_generated.py``,
``test_expr_tail.py`` and ``test_subquery.py``, and of the suites earlier
slices mirrored in part: ``test_basic_ops.py``, ``test_joins.py``,
``test_broadcast_joins.py``, ``test_sort.py``, ``test_partitioning.py``,
``test_limits_expand.py`` and ``test_new_aggregates.py``. Left out are the
cases of :data:`NOT_IN_SLICE`, each with the ROADMAP item it waits for, and
those of :data:`MIRRORED_ELSEWHERE`, each with the port test that mirrors
it already. ``show()`` is held to the JAX session's output byte for byte.
"""
from __future__ import annotations

import dataclasses
import importlib
import inspect
import itertools

import pytest
import torch

REF_MODULES = (
    "test_dataframe_api",
    "test_qa_battery",
    "test_qa_generated",
    "test_expr_tail",
    "test_subquery",
    "test_basic_ops",
    "test_joins",
    "test_broadcast_joins",
    "test_sort",
    "test_partitioning",
    "test_limits_expand",
    "test_new_aggregates",
)

#: reference tests not mirrored, each with the ROADMAP item it waits for
NOT_IN_SLICE: dict = {}

#: reference tests an earlier slice's port test mirrors already
MIRRORED_ELSEWHERE = {
    "test_sort::test_sort_nulls_first_last":
        "test_torch_groupby_sort.py (builds the logical sort with null order)",
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ── the JAX-package objects → the port's ──────────────────────────────────


def to_port(obj):
    """The port's twin of a JAX-package object: a ``Column`` (with its sort
    direction) or an expression/type/plan value becomes the port class of
    the same module and name; containers map item by item; a port
    DataFrame wrapper gives its DataFrame."""
    from spark_rapids_tpu.functions import Column as JColumn
    from spark_rapids_tpu_torch.functions import Column

    if isinstance(obj, PortFrame):
        return obj._df
    if type(obj).__name__ == "JaxUdf" and type(obj).__module__ == "spark_rapids_tpu.expr.udf":
        return _torch_udf_of(obj)
    if isinstance(obj, JColumn):
        c = Column(to_port(obj.expr))
        if getattr(obj, "_sort_desc", False):
            c._sort_desc = True
        return c
    mod = type(obj).__module__
    if mod.startswith("spark_rapids_tpu.") and isinstance(obj, tuple):
        return _port_class(obj)(*obj)  # value tuples (CalendarInterval)
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_port(x) for x in obj)
    if isinstance(obj, dict):
        return {k: to_port(v) for k, v in obj.items()}
    if not mod.startswith("spark_rapids_tpu."):
        return obj
    cls = _port_class(obj)
    if type(obj).__name__ == "Schema":
        return cls([to_port(f) for f in obj.fields])
    if dataclasses.is_dataclass(obj):
        return cls(**{
            f.name: to_port(getattr(obj, f.name))
            for f in dataclasses.fields(obj) if f.init
        })
    return cls()


def _torch_udf_of(judf):
    """A JAX ``JaxUdf`` as the port's ``TorchUdf``: the same jnp function,
    called on the tensors' numpy views (on the CPU, where these tests run)
    and its result handed back as a tensor, so both packages evaluate the
    same arithmetic."""
    import numpy as np

    from spark_rapids_tpu_torch.expr.udf import TorchUdf

    def fn(*tensors):
        out = judf.fn(*[t.cpu().numpy() for t in tensors])
        return torch.from_numpy(np.array(out))

    return TorchUdf(fn, to_port(judf.return_type), to_port(judf.args), judf.name)


def _port_class(obj):
    mod = type(obj).__module__
    port_mod = importlib.import_module("spark_rapids_tpu_torch." + mod.split(".", 1)[1])
    return getattr(port_mod, type(obj).__name__)


def _wrap(out):
    from spark_rapids_tpu_torch.session import DataFrame, GroupedData

    if isinstance(out, (DataFrame, GroupedData)):
        return PortFrame(out)
    if isinstance(out, list) and out and isinstance(out[0], (DataFrame, GroupedData)):
        return [PortFrame(x) for x in out]
    return out


class _Forward:
    """Forwards attribute reads to the wrapped object; a method is called
    with JAX-package arguments rebuilt as the port's, and a DataFrame it
    returns comes back wrapped."""

    _target = None

    def __getattr__(self, name):
        attr = getattr(self._target, name)
        if not callable(attr) or inspect.isclass(attr):
            return attr

        def call(*args, **kwargs):
            return _wrap(attr(*to_port(args), **to_port(kwargs)))

        return call


class PortFrame(_Forward):
    """A port DataFrame (or GroupedData) driven by JAX-package arguments."""

    def __init__(self, df):
        self._df = df
        self._target = df

    def collect(self):
        from spark_rapids_tpu.expr.base import AnsiError as JaxAnsiError
        from spark_rapids_tpu_torch.expr.base import AnsiError

        try:
            return self._df.collect()
        except AnsiError as e:
            raise JaxAnsiError(str(e)) from e


class PortSession(_Forward):
    """``tpu_session``'s conf on the port's device engine, on the CPU."""

    def __init__(self, extra=None, strict: bool = True):
        from spark_rapids_tpu_torch import TorchSession

        conf = {
            "spark.rapids.sql.enabled": True,
            "spark.rapids.sql.test.enabled": strict,
            "spark.sql.shuffle.partitions": 8,
        }
        conf.update(extra or {})
        self._s = TorchSession(conf, device="cpu")
        self._target = self._s

    def create_dataframe(self, data, schema=None, num_partitions: int = 1):
        return PortFrame(self._s.create_dataframe(data, to_port(schema), num_partitions))

    createDataFrame = create_dataframe

    @property
    def read(self):
        """The port's ``DataFrameReader``, driven by JAX-package arguments."""
        return PortReader(self._s.read)


class PortReader(_Forward):
    """A port ``DataFrameReader``: options and paths in, a wrapped port
    DataFrame out (``option`` returns the wrapper again)."""

    def __init__(self, reader):
        self._target = reader

    def option(self, k, v):
        self._target.option(k, to_port(v))
        return self


def assert_jax_cpu_and_port_equal(
    build_df, conf=None, sort_result=True, approx_float=False, allowed_non_tpu=None
):
    """``harness.assert_cpu_and_tpu_equal`` with the port's device engine in
    place of the JAX one."""
    from tests.harness import _normalize, _values_equal, cpu_session

    extra = dict(conf or {})
    if allowed_non_tpu:
        extra["spark.rapids.sql.test.allowedNonGpu"] = ",".join(allowed_non_tpu)
    cpu_rows = build_df(cpu_session(conf)).collect()
    port_rows = build_df(PortSession(extra)).collect()
    cpu_n, port_n = _normalize(cpu_rows, sort_result), _normalize(port_rows, sort_result)
    assert len(cpu_n) == len(port_n), f"row count: JAX cpu={len(cpu_n)} port={len(port_n)}"
    for i, (cr, pr) in enumerate(zip(cpu_n, port_n)):
        assert len(cr) == len(pr), f"row {i} arity: {cr} vs {pr}"
        for j, (cv, pv) in enumerate(zip(cr, pr)):
            assert _values_equal(cv, pv, approx_float), (
                f"row {i} col {j}: JAX cpu={cv!r} port={pv!r}\n"
                f"JAX cpu rows: {cpu_n[max(0, i - 2): i + 3]}\n"
                f"port rows: {port_n[max(0, i - 2): i + 3]}"
            )


def _broadcast(df):
    from spark_rapids_tpu.functions import broadcast as jax_broadcast
    from spark_rapids_tpu_torch.functions import broadcast

    if isinstance(df, PortFrame):
        return PortFrame(broadcast(df._df))
    return jax_broadcast(df)


def _finder(cls_path: str, many: bool = False):
    """A plan finder over the port's operator ``cls_path`` (module:Class)."""
    mod, name = cls_path.split(":")

    def find(plan, out=None):
        cls = getattr(importlib.import_module(mod), name)
        found = [] if out is None else out
        stack = [plan]
        while stack:
            n = stack.pop(0)
            if isinstance(n, cls):
                found.append(n)
                if not many:
                    return n
            stack.extend(n.children)
        return found if many else None

    return find


#: the suites' plan finders, pointed at the port's operators
FINDERS = {
    "_find_topn": _finder("spark_rapids_tpu_torch.exec.gpu:GpuTakeOrderedAndProjectExec"),
    "_find_exchange": _finder("spark_rapids_tpu_torch.exec.gpu:GpuShuffleExchangeExec"),
    "_find_exchanges": _finder("spark_rapids_tpu_torch.exec.gpu:GpuShuffleExchangeExec", True),
    "_find_join": _finder("spark_rapids_tpu_torch.exec.gpu_join:GpuShuffledHashJoinExec"),
}


def patch_module(mod, monkeypatch) -> None:
    """Swap the reference module's harness names for the port's."""
    monkeypatch.setattr(mod, "assert_cpu_and_tpu_equal", assert_jax_cpu_and_port_equal,
                        raising=False)
    monkeypatch.setattr(mod, "tpu_session", PortSession, raising=False)
    if hasattr(mod, "broadcast"):
        monkeypatch.setattr(mod, "broadcast", _broadcast)
    for name, fn in FINDERS.items():
        if hasattr(mod, name):
            monkeypatch.setattr(mod, name, fn)


def run_reference(mod, fn, kwargs, request) -> None:
    """Call a reference test with its parameters and the pytest fixtures
    it names."""
    fixtures = {
        n: request.getfixturevalue(n)
        for n in inspect.signature(fn).parameters
        if n not in kwargs
    }
    fn(**kwargs, **fixtures)


def _param_sets(fn):
    """Every call of a reference test: its parametrize marks expanded (the
    marks a ``pytest.param`` carries are kept with its values)."""
    axes = []
    for mark in reversed(getattr(fn, "pytestmark", [])):
        if mark.name != "parametrize":
            continue
        names = mark.args[0]
        names = [n.strip() for n in names.split(",")] if isinstance(names, str) else list(names)
        ids = mark.kwargs.get("ids")
        values = []
        for k, v in enumerate(mark.args[1]):
            marks = ()
            if hasattr(v, "values") and hasattr(v, "marks"):
                v, marks = v.values, v.marks
                v = v if len(names) > 1 else v[0]
            vals = tuple(v) if len(names) > 1 else (v,)
            if callable(ids):
                label = "-".join(str(ids(x)) for x in vals)
            elif isinstance(ids, (list, tuple)):
                label = str(ids[k])
            else:
                label = "-".join(str(x) for x in vals)
            values.append((dict(zip(names, vals)), label, marks))
        axes.append(values)
    for combo in itertools.product(*axes):
        kwargs, labels = {}, []
        for kw, label, _ in combo:
            kwargs.update(kw)
            labels.append(label)
        yield kwargs, "-".join(labels)


def mirrored_cases(modules, not_in_slice, elsewhere):
    out = []
    for name in modules:
        mod = importlib.import_module(name)
        for fname, fn in inspect.getmembers(mod, inspect.isfunction):
            if not fname.startswith("test_") or fn.__module__ != mod.__name__:
                continue
            key = f"{name}::{fname}"
            if key in not_in_slice or key in elsewhere:
                continue
            src = inspect.getsource(fn)
            if "assert_cpu_and_tpu_equal" not in src and "tpu_session" not in src:
                continue
            for kwargs, label in _param_sets(fn):
                case = key + (f"[{label}]" if label else "")
                out.append(pytest.param(name, fname, kwargs, id=case))
    return out


def check_covers(modules, cases, not_in_slice, elsewhere) -> None:
    """Every device-touching test of every suite is mirrored, left out with
    its item, or mirrored elsewhere; and every name listed exists."""
    mirrored = {f"{p.values[0]}::{p.values[1]}" for p in cases}
    assert {p.values[0] for p in cases} == set(modules)
    for name in modules:
        mod = importlib.import_module(name)
        for fname, fn in inspect.getmembers(mod, inspect.isfunction):
            if not fname.startswith("test_") or fn.__module__ != mod.__name__:
                continue
            src = inspect.getsource(fn)
            if "assert_cpu_and_tpu_equal" not in src and "tpu_session" not in src:
                continue
            key = f"{name}::{fname}"
            assert key in mirrored or key in not_in_slice or key in elsewhere, key
    for key in list(not_in_slice) + list(elsewhere):
        module, fname = key.split("::")
        assert hasattr(importlib.import_module(module), fname), key
    for why in not_in_slice.values():
        assert "item " in why, why


CASES = mirrored_cases(REF_MODULES, NOT_IN_SLICE, MIRRORED_ELSEWHERE)


@pytest.mark.parametrize("module,fname,kwargs", CASES)
def test_mirror(module, fname, kwargs, monkeypatch, request):
    mod = importlib.import_module(module)
    patch_module(mod, monkeypatch)
    run_reference(mod, getattr(mod, fname), kwargs, request)


def test_mirror_covers_every_suite():
    check_covers(REF_MODULES, CASES, NOT_IN_SLICE, MIRRORED_ELSEWHERE)


# ── the new surface against the JAX session, call for call ────────────────


def _frames(table, parts=1):
    """(JAX CPU-engine frame, port device frame) over one Arrow table: the
    JAX session's own methods against the port's."""
    from tests.harness import cpu_session

    return (cpu_session({}).create_dataframe(table, num_partitions=parts),
            PortSession({}).create_dataframe(table, num_partitions=parts))


def _show_table():
    import datetime as dt
    import decimal

    import pyarrow as pa

    return pa.table({
        "i": pa.array([1, None, -30000, 7, 123456789012], type=pa.int64()),
        "f": pa.array([1.5, float("nan"), None, -0.0, 1e300]),
        "s": pa.array(["x", None, "a rather long string value", "", "ü"]),
        "b": pa.array([True, False, None, True, False]),
        "d": pa.array([dt.date(2020, 1, 2), None, dt.date(1969, 12, 31),
                       dt.date(2000, 2, 29), dt.date(1, 1, 1)]),
        "t": pa.array([dt.datetime(2021, 3, 4, 5, 6, 7, 890000), None,
                       dt.datetime(1970, 1, 1), dt.datetime(1999, 12, 31, 23, 59, 59),
                       dt.datetime(2038, 1, 19)], type=pa.timestamp("us", tz="UTC")),
        "m": pa.array([decimal.Decimal("1.25"), None, decimal.Decimal("-3.50"),
                       decimal.Decimal("0.00"), decimal.Decimal("99999.99")],
                      type=pa.decimal128(7, 2)),
    })


@pytest.mark.parametrize("n,truncate", [(20, True), (3, True), (20, False), (0, True)])
def test_show_byte_for_byte(n, truncate, capsys):
    """``show()`` prints what the JAX session prints, character for
    character: nulls, NaN, -0.0, truncation at 20, dates, UTC timestamps,
    decimals, unicode, and the header alone for ``n=0``."""
    jdf, pdf = _frames(_show_table())
    jdf.sort("i").show(n, truncate)
    want = capsys.readouterr().out
    pdf.sort("i").show(n, truncate)
    got = capsys.readouterr().out
    assert got == want
    assert want.count("\n") == 3 + (min(n, 5) + 1 if n else 1)


def _same_rows(a, b) -> bool:
    """Rows equal in order under the harness's value rule (NaN equals NaN,
    no float tolerance); ``None`` for "no row" on both sides."""
    from tests.harness import _values_equal

    return len(a) == len(b) and all(
        (x is None and y is None)
        or (x is not None and y is not None and len(x) == len(y)
            and all(_values_equal(u, v, False) for u, v in zip(x, y)))
        for x, y in zip(a, b)
    )


def test_count_head_first_take_equal_jax():
    """``count``, ``head``, ``head(n)``, ``first`` and ``take`` give the JAX
    session's values, an empty frame included."""
    from spark_rapids_tpu.functions import col

    jdf, pdf = _frames(_show_table(), parts=2)
    for f in (lambda d: d, lambda d: d.filter(col("i") > 10**12)):
        j, p = f(jdf).sort("i"), f(pdf).sort("i")
        assert p.count() == j.count()
        assert _same_rows([p.head()], [j.head()]) and _same_rows([p.first()], [j.first()])
        assert _same_rows(p.head(2), j.head(2)) and _same_rows(p.take(4), j.take(4))


def test_count_does_not_import_pyarrow(monkeypatch):
    """``count()`` runs on a machine without pyarrow: it takes the count
    from ``collect()``."""
    import builtins
    import numpy as np

    from spark_rapids_tpu_torch import TorchSession

    real = builtins.__import__

    def no_arrow(name, *a, **k):
        if name == "pyarrow" or name.startswith("pyarrow.") or name == "pandas":
            raise ImportError(f"No module named {name!r}")
        return real(name, *a, **k)

    s = TorchSession({"spark.rapids.sql.enabled": True,
                      "spark.rapids.sql.test.enabled": True}, device="cpu")
    df = s.create_dataframe({"a": np.arange(37, dtype=np.int64)}, num_partitions=3)
    monkeypatch.setattr(builtins, "__import__", no_arrow)
    assert df.count() == 37
    with pytest.raises(ImportError, match="pyarrow"):
        df.to_arrow()
    with pytest.raises(ImportError, match="pandas"):
        df.to_pandas()


def test_to_arrow_and_to_pandas_equal_jax():
    import pandas as pd

    jdf, pdf = _frames(_show_table())
    got, want = pdf.sort("i").to_arrow(), jdf.sort("i").to_arrow()
    assert got.schema == want.schema
    assert _same_rows(list(zip(*[c.to_pylist() for c in got.columns])),
                      list(zip(*[c.to_pylist() for c in want.columns])))
    pd.testing.assert_frame_equal(pdf.sort("i").to_pandas(), jdf.sort("i").to_pandas())


@pytest.mark.parametrize("agg", ["count", "sum", "avg", "min", "max"])
def test_grouped_shorthands_equal_jax(agg):
    """``GroupedData.count/sum/avg/min/max``: the JAX session's column names
    and rows."""
    from data_gen import gen_grouped_table
    from spark_rapids_tpu.types import DOUBLE, LONG
    from tests.harness import _normalize, _values_equal

    t = gen_grouped_table([("x", LONG), ("y", DOUBLE)], 300, num_groups=9, seed=111)
    jdf, pdf = _frames(t, parts=3)
    args = () if agg == "count" else ("x", "y")
    j = getattr(jdf.group_by("k"), agg)(*args)
    p = getattr(pdf.group_by("k"), agg)(*args)
    assert p.columns == j.columns
    jr, pr = _normalize(j.collect(), True), _normalize(p.collect(), True)
    assert len(jr) == len(pr) > 1
    for a, b in zip(jr, pr):
        assert all(_values_equal(x, y, True) for x, y in zip(a, b)), (a, b)


@pytest.mark.parametrize("values", [None, [3, 1, 99]])
def test_pivot_equal_jax(values):
    """``pivot`` with and without a values list: the JAX session's columns
    and rows (absent combinations null, count null not 0)."""
    import numpy as np
    import pyarrow as pa

    from spark_rapids_tpu.functions import col, count, sum as sum_
    from tests.harness import _normalize

    rng = np.random.default_rng(112)
    n = 400
    t = pa.table({
        "k": rng.integers(0, 6, n),
        "p": pa.array(np.where(rng.random(n) < 0.1, None, rng.integers(0, 4, n)).tolist(),
                      type=pa.int32()),
        "x": rng.integers(-50, 50, n),
    })
    jdf, pdf = _frames(t, parts=2)

    def q(df):
        return df.group_by("k").pivot("p", values).agg(sum_(col("x")), count(col("x")))

    j, p = q(jdf), q(pdf)
    assert p.columns == j.columns
    assert _normalize(p.collect(), True) == _normalize(j.collect(), True)


def test_sort_within_partitions_equal_jax():
    """Each partition sorted on its own: the rows in the JAX session's order
    (no global order, no range exchange)."""
    from data_gen import gen_table
    from spark_rapids_tpu.functions import col
    from spark_rapids_tpu.types import INT, STRING

    t = gen_table([("a", INT), ("s", STRING)], 500, seed=113)
    jdf, pdf = _frames(t, parts=4)
    j = jdf.sort_within_partitions(col("a").desc(), "s")
    p = pdf.sort_within_partitions(col("a").desc(), "s")
    assert p.collect() == j.collect()
    assert "RangePartitioning" not in p._df._session._last_plan.tree_string()


def test_set_conf_applies_to_the_next_query():
    """``set_conf`` changes a per-query key for the queries that follow."""
    import numpy as np

    from spark_rapids_tpu_torch import TorchSession
    from spark_rapids_tpu_torch import functions as F

    s = TorchSession({"spark.rapids.sql.enabled": True}, device="cpu")
    df = s.create_dataframe({"a": np.arange(10, dtype=np.int64)})
    q = df.select((F.col("a") * 2).alias("b"))
    q.collect()
    assert all(e.on_device for e in s._last_overrides.explain if "Project" in e.node)
    s.set_conf("spark.rapids.sql.exec.ProjectExec", False)
    assert q.collect() == [(2 * i,) for i in range(10)]
    assert not any(e.on_device for e in s._last_overrides.explain if "Project" in e.node)


def test_sample_rand_filter_is_the_one_node_off_the_device():
    """``sample``'s Rand filter stays on the CPU engine with the JAX rule's
    reason, and is the only node there."""
    import numpy as np

    from spark_rapids_tpu_torch import TorchSession

    s = TorchSession({"spark.rapids.sql.enabled": True}, device="cpu")
    df = s.create_dataframe({"x": np.arange(2000, dtype=np.int64)}).sample(0.1, seed=7)
    n = len(df.collect())
    assert 120 < n < 280
    off = [e for e in s._last_overrides.explain
           if not e.on_device and not e.node.startswith("CpuScan")]
    assert [e.node.split(" ")[0].split("[")[0] for e in off] == ["CpuFilter"]
    assert any("XORShiftRandom" in r for r in off[0].reasons), off[0].reasons
