"""The golden corpus (``tests/golden/*.json``) through the PyTorch port.

Every expression fixture (``split_at`` included, over array columns) runs
through the port's CPU engine and through its device engine on ``device="cpu"`` in test
mode, under the conf of ``tests/test_golden.py``'s device session, and must
equal its literal; so must the 48 whole-query fixtures of
``golden_queries.json``, from their SQL text. The inputs are built by
``spark_rapids_tpu_torch.testing`` with numpy (no pyarrow), as
``chip_smoke.py`` builds them on the card.

The placement check holds, for every fixture, the nodes the port keeps off
the device (with their reasons) equal to the nodes the JAX package's
explain keeps off under the same conf. The JAX plans are planned, not
executed, so nothing compiles.
"""
from __future__ import annotations

import json
import os
import types

import pytest
import torch

from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch import testing as TT

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
CASES = TT.golden_cases(GOLDEN)
with open(os.path.join(GOLDEN, "golden_queries.json")) as _f:
    QUERIES = json.load(_f)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # torch's thread pools oversubscribe under several pytest workers
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _port_session(engine: str, case=None) -> TorchSession:
    if engine == "cpu":
        return TorchSession({"spark.rapids.sql.enabled": False}, device="cpu")
    conf = dict(TT.GOLDEN_CONF)
    if case is not None and case.label in TT.GOLDEN_OFF_DEVICE:
        conf["spark.rapids.sql.test.allowedNonGpu"] = "CpuProject"
    return TorchSession(conf, device="cpu")


def test_corpus_counts():
    """1805 expression fixtures (the whole corpus, the 6 ``split_at``
    included), and the 28 the JAX package keeps off the device among them."""
    by_file: dict = {}
    for c in CASES:
        by_file[c.file] = by_file.get(c.file, 0) + c.fixtures
    assert by_file == {
        "golden_murmur3.json": 236,
        "golden_cast.json": 241,
        "golden_datetime.json": 249,
        "golden_decimal.json": 34,
        "golden_strings.json": 860,
        "golden_datetime_fmt.json": 153,
        "golden_arith.json": 32,
    }
    assert sum(by_file.values()) == 1805
    labels = {c.label for c in CASES}
    assert set(TT.GOLDEN_OFF_DEVICE) <= labels and len(TT.GOLDEN_OFF_DEVICE) == 28
    assert len(QUERIES) == 48


@pytest.mark.parametrize("engine", ["cpu", "device"])
@pytest.mark.parametrize("case", CASES, ids=[c.label for c in CASES])
def test_golden_expression(case, engine):
    ok, msg = TT.run_golden_case(_port_session(engine, case), case)
    assert ok, f"{case.label} [{engine}]: {msg}"


@pytest.mark.parametrize("engine", ["cpu", "device"])
@pytest.mark.parametrize("fx", QUERIES, ids=[f["name"] for f in QUERIES])
def test_golden_query(fx, engine):
    conf = (
        dict(TT.GOLDEN_QUERY_CONF) if engine == "device" else {"spark.rapids.sql.enabled": False}
    )
    s = TorchSession(conf, device="cpu")
    ok, msg = TT.run_golden_query(s, fx)
    assert ok, f"{fx['name']} [{engine}]: {msg}"
    if engine == "device":
        off = [e.node for e in s._last_overrides.explain if not e.on_device]
        assert all(n.startswith("CpuScan") for n in off), off


# ── placement: the port's explain against the JAX package's ───────────────


def _jax_modules():
    from spark_rapids_tpu import functions as F
    from spark_rapids_tpu import types as T
    from spark_rapids_tpu.expr import arithmetic as ar

    return types.SimpleNamespace(F=F, T=T, ar=ar)


def _arrow_table(columns):
    """The case's columns as ``tests/test_golden.py`` builds them."""
    import pyarrow as pa

    arrow = {
        "int": pa.int32(), "long": pa.int64(), "double": pa.float64(),
        "float": pa.float32(), "boolean": pa.bool_(), "string": pa.string(),
        "date": pa.date32(), "timestamp": pa.timestamp("us", tz="UTC"),
    }
    return pa.table({
        name: pa.array(vals) if typ == "decimal" else pa.array(vals, type=arrow[typ])
        for name, typ, vals in columns
    })


def _off_device(explain) -> list:
    return sorted(
        (e.node.split(" ")[0], tuple(e.reasons))
        for e in explain
        if not e.on_device and not e.node.startswith("CpuScan")
    )


@pytest.fixture(scope="module")
def jax_session():
    from tests.harness import tpu_session

    conf = {k: v for k, v in TT.GOLDEN_CONF.items() if "test.enabled" not in k}
    return tpu_session(conf, strict=False)


@pytest.mark.parametrize("file", sorted({c.file for c in CASES}))
def test_placement_matches_jax(file, jax_session):
    """For each fixture of the group, the port's off-device nodes and
    reasons equal the JAX package's; the fixtures off the device are
    exactly ``GOLDEN_OFF_DEVICE``, each with the reason it names; decimal
    inputs get the type Arrow infers."""
    jm = _jax_modules()
    port = TorchSession({k: v for k, v in TT.GOLDEN_CONF.items() if "test.enabled" not in k},
                        device="cpu")
    off_labels = {}
    for case in (c for c in CASES if c.file == file):
        df = TT.golden_dataframe(port, case)
        port._prepare_plan(df._plan)
        port_off = _off_device(port._last_overrides.explain)

        jdf = jax_session.create_dataframe(_arrow_table(case.columns))
        jdf = jdf.select(case.build(jm, jm.F.col(case.columns[0][0])).alias("r"))
        jax_session._prepare_plan(jdf._plan)
        jax_off = _off_device(jax_session._last_overrides.explain)
        assert port_off == jax_off, f"{case.label}: port {port_off} vs JAX {jax_off}"
        assert (df.schema.fields[0].data_type.simple_string
                == jdf.schema.fields[0].data_type.simple_string), case.label
        if port_off:
            off_labels[case.label] = [r for _, rs in port_off for r in rs]
    want = {k: [v] for k, v in TT.GOLDEN_OFF_DEVICE.items() if any(
        c.label == k and c.file == file for c in CASES)}
    assert off_labels == want
