"""The JAX package's scalar-expression suites, mirrored on the PyTorch port.

Each mirrored case runs a reference test function of ``test_cast.py``,
``test_datetime.py``, ``test_strings.py``, ``test_string_datetime_ext.py``,
``test_math_bitwise.py``, ``test_arith_semantics.py`` or
``test_misc_exprs.py`` unchanged, with two names of its module swapped:

* ``assert_cpu_and_tpu_equal`` runs the query on the JAX CPU engine
  (``tests/harness.py::cpu_session``) and on the port's device engine
  (``device="cpu"``, test mode), and compares the rows with the harness's
  own normalization and tolerance;
* ``tpu_session`` gives a port device session.

The port session takes the reference test's own DataFrame code: the JAX
``Column`` expressions are rebuilt as the port's classes of the same module
and name (the port copies the expression library class for class), and the
Arrow tables the reference generates from its numpy seeds are the inputs of
both engines. An ``AnsiError`` of the port surfaces as the JAX package's,
so the reference's ``pytest.raises`` holds.

Mirrored are the reference tests that touch the device engine (their source
names ``assert_cpu_and_tpu_equal`` or ``tpu_session``), but those of
:data:`NOT_IN_SLICE`, which exercise what the port does not run yet.
"""
from __future__ import annotations

import importlib
import inspect

import pytest
import torch

from tests.test_torch_dataframe_api import (  # the shared mirror helpers
    PortSession,
    _param_sets,
    assert_jax_cpu_and_port_equal,
)

REF_MODULES = (
    "test_cast",
    "test_datetime",
    "test_strings",
    "test_string_datetime_ext",
    "test_math_bitwise",
    "test_arith_semantics",
    "test_misc_exprs",
)

#: reference tests not mirrored, each with the part of the port it waits for
NOT_IN_SLICE: dict = {}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ── the mirrored cases ─────────────────────────────────────────────────────


def _mirrored():
    out = []
    for name in REF_MODULES:
        mod = importlib.import_module(name)
        for fname, fn in inspect.getmembers(mod, inspect.isfunction):
            if not fname.startswith("test_") or fn.__module__ != mod.__name__:
                continue
            if f"{name}::{fname}" in NOT_IN_SLICE:
                continue
            src = inspect.getsource(fn)
            if "assert_cpu_and_tpu_equal" not in src and "tpu_session" not in src:
                continue
            for kwargs, label in _param_sets(fn):
                if fname == "test_numeric_matrix" and kwargs["frm"] == kwargs["to"]:
                    continue  # the reference skips the identity cast
                case = f"{name}::{fname}" + (f"[{label}]" if label else "")
                out.append(pytest.param(name, fname, kwargs, id=case))
    return out


CASES = _mirrored()


@pytest.mark.parametrize("module,fname,kwargs", CASES)
def test_mirror(module, fname, kwargs, monkeypatch, request):
    mod = importlib.import_module(module)
    fn = getattr(mod, fname)
    monkeypatch.setattr(mod, "assert_cpu_and_tpu_equal", assert_jax_cpu_and_port_equal,
                        raising=False)
    monkeypatch.setattr(mod, "tpu_session", PortSession, raising=False)
    # the pytest fixtures the reference test names (tmp_path)
    fixtures = {n: request.getfixturevalue(n) for n in inspect.signature(fn).parameters
                if n not in kwargs}
    fn(**kwargs, **fixtures)


def test_mirror_covers_every_suite():
    """Each reference suite contributes mirrored cases, and the list of
    reference tests left out names only what the port does not run yet."""
    mods = {p.values[0] for p in CASES}
    assert mods == set(REF_MODULES)
    for key in NOT_IN_SLICE:
        module, fname = key.split("::")
        assert hasattr(importlib.import_module(module), fname), key


# ── the chip's expression families, small, on the CPU ─────────────────────


@pytest.fixture(scope="module")
def tpch_small():
    from spark_rapids_tpu_torch.tpch.datagen import gen_orders_lineitem

    orders, lineitem = gen_orders_lineitem(0.002, 19980802)
    return {"orders": orders, "lineitem": lineitem}


def _family_sessions():
    from spark_rapids_tpu_torch import TorchSession
    from spark_rapids_tpu_torch.tpch.expr_queries import EXPR_CONF

    dev = TorchSession({"spark.rapids.sql.enabled": True, "spark.rapids.sql.test.enabled": True,
                        **EXPR_CONF}, device="cpu")
    cpu = TorchSession({"spark.rapids.sql.enabled": False, **EXPR_CONF}, device="cpu")
    return dev, cpu


@pytest.mark.parametrize("family", ["expr_dates", "expr_casts", "expr_strings", "expr_math"])
def test_expr_family_matches_cpu_engine(family, tpch_small):
    """``chip_smoke.py``'s expression families at SF 0.002: the device engine
    in test mode (nothing off the device but scans), each column equal to
    the CPU engine's."""
    from spark_rapids_tpu_torch.testing import columns_equal
    from spark_rapids_tpu_torch.tpch.expr_queries import EXPR_QUERIES

    fn, _ = EXPR_QUERIES[family]
    dev, cpu = _family_sessions()
    got = fn(lambda n: dev.create_dataframe(tpch_small[n])).to_host()
    ref = fn(lambda n: cpu.create_dataframe(tpch_small[n])).to_host()
    assert ref.num_rows > 1000
    ok, msg = columns_equal(ref, got)
    assert ok, f"{family}: {msg}"


@pytest.mark.parametrize("name", ["ansi_cast", "ansi_add"])
def test_ansi_overflow_in_one_row_raises(name, tpch_small):
    """An ANSI cast and an ANSI add that overflow in exactly one row raise
    through the device error channel; shifted by one, nothing overflows and
    the rows equal the non-ANSI ones."""
    from spark_rapids_tpu_torch import TorchSession
    from spark_rapids_tpu_torch.expr.base import AnsiError
    from spark_rapids_tpu_torch.testing import columns_equal
    from spark_rapids_tpu_torch.tpch.expr_queries import ansi_queries

    li = tpch_small["lineitem"]
    conf = {"spark.rapids.sql.enabled": True, "spark.rapids.sql.test.enabled": True}
    ansi = TorchSession({**conf, "spark.sql.ansi.enabled": True}, device="cpu")
    plain = TorchSession(conf, device="cpu")
    t = {"lineitem": li}
    with pytest.raises(AnsiError):
        ansi_queries(li, True)[name](lambda n: ansi.create_dataframe(t[n])).to_host()
    fn = ansi_queries(li, False)[name]
    ok, msg = columns_equal(fn(lambda n: plain.create_dataframe(t[n])).to_host(),
                            fn(lambda n: ansi.create_dataframe(t[n])).to_host())
    assert ok, msg
    # one row sits one short of the overflow: the largest INT
    top = fn(lambda n: ansi.create_dataframe(t[n])).to_host().columns[0].data.max()
    assert top == 2**31 - 1


def test_ansi_error_channel_syncs_only_with_a_site(monkeypatch, tpch_small):
    """The error flags cross to the host only for a tree that registered a
    site: a non-ANSI projection never reads them."""
    from spark_rapids_tpu_torch import TorchSession
    from spark_rapids_tpu_torch.exec import gpu as G
    from spark_rapids_tpu_torch.tpch.expr_queries import ansi_queries

    reads = []
    real = G.raise_errors
    monkeypatch.setattr(G, "raise_errors", lambda c, live: (reads.append(len(c.errors)),
                                                            real(c, live)))
    li = tpch_small["lineitem"]
    t = {"lineitem": li}
    for ansi in (False, True):
        s = TorchSession({"spark.rapids.sql.enabled": True, "spark.sql.ansi.enabled": ansi},
                         device="cpu")
        ansi_queries(li, False)["ansi_add"](lambda n: s.create_dataframe(t[n])).to_host()
    assert reads and reads[0] == 0 and all(r > 0 for r in reads[1:])


def _ansi_outside_project(name, df):
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.types import INT

    a, b, s = F.col("a"), F.col("b"), F.col("s")
    if name == "group_key_add":
        return df.group_by((a + b).alias("k")).agg(F.count().alias("n")).sort("k")
    if name == "group_key_cast":
        return df.group_by(s.cast(INT).alias("k")).agg(F.count().alias("n")).sort("k")
    if name == "agg_input_add":
        return df.agg(F.sum(a + b).alias("t"))
    return df.sort(a + b).select("a")


@pytest.mark.parametrize("name", ["group_key_add", "group_key_cast", "agg_input_add",
                                  "sort_key_add"])
def test_ansi_error_site_outside_project_filter(name):
    """An ANSI overflow or bad cast in a grouping key, an aggregate input or
    a sort key raises ``AnsiError`` through the device engine as through
    the CPU engine: the device error channel is read by the project and
    filter only, so an exec holding an error site elsewhere stays on the
    CPU engine with the JAX package's reason. Without the offending row
    the device engine equals the CPU engine."""
    import numpy as np

    from spark_rapids_tpu_torch import TorchSession
    from spark_rapids_tpu_torch.expr.base import AnsiError
    from spark_rapids_tpu_torch.testing import columns_equal

    a = np.arange(40, dtype=np.int32)
    a[7] = 2**31 - 1
    data = {"a": a, "b": np.ones(40, dtype=np.int32),
            "s": np.array([str(i % 5) for i in range(40)], dtype=object)}
    data["s"][7] = "x"
    ansi = {"spark.sql.ansi.enabled": True}
    dev = TorchSession({"spark.rapids.sql.enabled": True, **ansi}, device="cpu")
    cpu = TorchSession({"spark.rapids.sql.enabled": False, **ansi}, device="cpu")
    for s in (cpu, dev):
        with pytest.raises(AnsiError):
            _ansi_outside_project(name, s.create_dataframe(data)).to_host()
    reasons = [r for e in dev._last_overrides.explain if not e.on_device for r in e.reasons]
    assert any("device error channel not wired here" in r for r in reasons), reasons
    keep = np.arange(40) != 7
    clean = {k: v[keep] for k, v in data.items()}
    ok, msg = columns_equal(_ansi_outside_project(name, cpu.create_dataframe(clean)).to_host(),
                            _ansi_outside_project(name, dev.create_dataframe(clean)).to_host())
    assert ok, msg


def test_round_integral_negative_scale_on_device():
    """``round``/``bround`` of an integral column with a negative scale run
    on the device (``Round.eval``'s integral branch once called ``.astype``
    on a tensor there): ``golden_decimal.json``'s ``round_int`` fixtures
    equal their literals, and a column equals the CPU engine."""
    import json
    import os

    import numpy as np

    from spark_rapids_tpu_torch import TorchSession
    from spark_rapids_tpu_torch import functions as F

    def session(enabled):
        return TorchSession({"spark.rapids.sql.enabled": enabled,
                             "spark.rapids.sql.test.enabled": enabled}, device="cpu")

    with open(os.path.join(os.path.dirname(__file__), "golden", "golden_decimal.json")) as f:
        fixtures = [c for c in json.load(f) if c["op"] == "round_int"]
    assert len(fixtures) == 7
    for c in fixtures:
        df = session(True).create_dataframe({"v": np.array([c["input"]], np.int32)})
        got = df.select(F.round(F.col("v"), c["scale"]).alias("r")).collect()
        assert got == [(c["expected"],)], c
    data = {"v": np.array([-2**31, -155, -150, -5, 0, 5, 149, 150, 2**31 - 1], np.int32)}
    out = [
        session(enabled).create_dataframe(data).select(
            F.round(F.col("v"), -1).alias("r"), F.bround(F.col("v"), -2).alias("b")
        ).collect()
        for enabled in (False, True)
    ]
    assert out[0] == out[1]
    assert [r[0] for r in out[1]][1:8] == [-160, -150, -10, 0, 10, 150, 150]


# ── the rest of the slice's rules, on JAX-built queries ───────────────────


def _jax_frame(table):
    return lambda s: s.create_dataframe(table, num_partitions=2)


def test_float_remainder_pmod_and_null_exprs():
    """``%`` and ``pmod`` over doubles, ``AtLeastNNonNulls``, ``<=>`` and
    ``isnan`` on the port's device engine against the JAX CPU engine."""
    from data_gen import gen_table
    from spark_rapids_tpu import functions as F
    from spark_rapids_tpu.expr.nullexprs import AtLeastNNonNulls
    from spark_rapids_tpu.functions import col
    from spark_rapids_tpu.types import DOUBLE, INT

    t = gen_table([("a", DOUBLE), ("b", DOUBLE), ("i", INT)], 300, seed=81,
                  special_fraction=0.2)
    frame = _jax_frame(t)
    assert_jax_cpu_and_port_equal(
        lambda s: frame(s).select(
            (col("a") % col("b")).alias("rem"),
            F.pmod(col("a"), col("b")).alias("pmod"),
            F.expr_col(AtLeastNNonNulls(2, (col("a").expr, col("b").expr, col("i").expr)))
            .alias("n2"),
            col("a").eq_null_safe(col("b")).alias("eqns"),
            F.isnan(col("a")).alias("nan"),
        ),
        approx_float=True,
    )


@pytest.mark.parametrize("grouped", [False, True])
def test_corr_covar_on_device(grouped):
    """``corr``, ``covar_pop`` and ``covar_samp`` on the port's device
    engine against the JAX CPU engine, grouped and not."""
    from data_gen import gen_table
    from spark_rapids_tpu import functions as F
    from spark_rapids_tpu.functions import col
    from spark_rapids_tpu.types import DOUBLE, INT

    t = gen_table([("g", INT), ("x", DOUBLE), ("y", DOUBLE)], 400, seed=82)
    aggs = (F.corr(col("x"), col("y")).alias("c"), F.covar_pop(col("x"), col("y")).alias("p"),
            F.covar_samp(col("x"), col("y")).alias("s"))
    conf = {"spark.rapids.sql.variableFloatAgg.enabled": True}
    if grouped:
        build = lambda s: _jax_frame(t)(s).group_by("g").agg(*aggs)  # noqa: E731
    else:
        build = lambda s: _jax_frame(t)(s).agg(*aggs)  # noqa: E731
    assert_jax_cpu_and_port_equal(build, conf=conf, approx_float=True)
