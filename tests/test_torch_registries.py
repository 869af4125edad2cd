"""The port's registries, its version shim and its generated documents.

Ports of ``tests/test_typesig_shim_coalesce.py`` (the TypeSig and shim
cases), ``tests/test_config_docs.py`` and ``tests/test_api_validation.py``,
pointed at the port's conf registry (``spark_rapids_tpu_torch/config.py``),
its exec and expression rules and ``SIGS`` (``plan/overrides.py``), its
shim (``shims.py``) and the documents ``docs_gen.py`` writes
(``docs/torch_configs.md``, ``docs/torch_supported_ops.md``), which must
equal what is checked in. :data:`PORTED` maps every test of those suites
to its port here, or to the ROADMAP item it waits for.
"""
from __future__ import annotations

import importlib
import inspect
import os
import re

import numpy as np
import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")
PORT_ROOT = os.path.join(ROOT, "spark_rapids_tpu_torch")

#: reference test → the port test here, or the ROADMAP item it waits for
PORTED = {
    "test_typesig_shim_coalesce::test_typesig_algebra": "test_typesig_algebra",
    "test_typesig_shim_coalesce::test_typesig_rejects_bitwise_on_float":
        "test_typesig_rejects_bitwise_on_float",
    "test_typesig_shim_coalesce::test_shim_selection_and_defaults":
        "test_shim_selection_and_defaults",
    "test_typesig_shim_coalesce::test_coalesce_batches_merges_small_scan_batches":
        "test_coalesce_batches_merges_small_scan_batches",
    "test_typesig_shim_coalesce::test_shim_parquet_rebase_write": "test_shim_parquet_rebase_write",
    "test_typesig_shim_coalesce::test_shim_csv_null_value_routed":
        "test_shim_csv_null_value_routed",
    "test_typesig_shim_coalesce::test_rebase_guard_respects_timestamp_unit":
        "test_rebase_guard_respects_timestamp_unit",
    "test_config_docs::test_every_registered_key_is_read_somewhere":
        "test_every_registered_key_is_read_somewhere",
    "test_config_docs::test_docs_generate_and_cover_all_public_keys":
        "test_docs_generate_and_cover_all_public_keys",
    "test_config_docs::test_metrics_level_gates_timing_metrics":
        "test_metrics_level_gates_timing_metrics",
    "test_config_docs::test_variable_float_agg_gate": "test_variable_float_agg_gate",
    "test_config_docs::test_has_nans_false_differential": "test_has_nans_false_differential",
    "test_config_docs::test_batch_size_bytes_rechunks_h2d": "test_batch_size_bytes_rechunks_h2d",
    "test_api_validation::test_expr_rules_name_expression_classes":
        "test_expr_rules_name_expression_classes",
    "test_api_validation::test_exec_rules_reference_real_cpu_execs":
        "test_exec_rules_reference_real_cpu_execs",
    "test_api_validation::test_aggregate_buffer_arities_consistent":
        "test_aggregate_buffer_arities_consistent",
    "test_api_validation::test_every_kill_switch_documented": "test_every_kill_switch_documented",
    "test_api_validation::test_supported_ops_doc_covers_exec_rules":
        "test_supported_ops_doc_covers_exec_rules",
    "test_api_validation::test_config_defaults_parse_roundtrip":
        "test_config_defaults_parse_roundtrip",
    "test_api_validation::test_window_ranking_classes_registered":
        "test_window_ranking_classes_registered",
}


def test_ported_covers_every_suite():
    """Every test of the three suites is ported here or waits for a named
    ROADMAP item, and every port named exists."""
    here = importlib.import_module(__name__)
    for name in ("test_typesig_shim_coalesce", "test_config_docs", "test_api_validation"):
        mod = importlib.import_module(name)
        for fname, fn in inspect.getmembers(mod, inspect.isfunction):
            if fname.startswith("test_") and fn.__module__ == mod.__name__:
                assert f"{name}::{fname}" in PORTED, f"{name}::{fname}"
    for target in PORTED.values():
        assert target.startswith("item ") or hasattr(here, target), target


def _session(conf=None, strict=True):
    from spark_rapids_tpu_torch import TorchSession

    base = {"spark.rapids.sql.enabled": True, "spark.rapids.sql.test.enabled": strict,
            "spark.sql.shuffle.partitions": 8}
    return TorchSession({**base, **(conf or {})}, device="cpu")


# ── TypeSig and the shim ───────────────────────────────────────────────────


def test_typesig_algebra():
    from spark_rapids_tpu_torch.plan.overrides import SIGS, TypeSig
    from spark_rapids_tpu_torch.types import DOUBLE, INT, STRING, ArrayType

    assert SIGS["numeric"].supports(INT)
    assert SIGS["numeric"].supports(DOUBLE)
    assert not SIGS["numeric"].supports(STRING)
    assert SIGS["orderable"].supports(STRING)
    assert not SIGS["orderable"].supports(ArrayType(INT))
    combined = SIGS["integral"] + TypeSig(type(STRING))
    assert combined.supports(STRING) and combined.supports(INT)


def test_sigs_equal_jax():
    """The port's ``SIGS`` are the JAX package's, class for class (the port
    adds the two it composes inline: ``fp`` and ``temporal``)."""
    from spark_rapids_tpu.plan.overrides import SIGS as JSIGS
    from spark_rapids_tpu_torch.plan.overrides import SIGS

    for key, sig in JSIGS.items():
        assert {c.__name__ for c in SIGS[key].classes} == {c.__name__ for c in sig.classes}
        assert SIGS[key].describe() == sig.describe()
    assert set(SIGS) - set(JSIGS) == {"fp", "temporal"}


def test_typesig_rejects_bitwise_on_float():
    """Bitwise ops carry the integral TypeSig: a float operand stays on the
    CPU engine with the signature's reason; cast to long first, the same
    op runs on the device."""
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.types import LONG

    data = {"a": np.array([1.5, 2.5])}
    s = _session(strict=True)
    df = s.create_dataframe(data).select(F.col("a").cast(LONG).bitwiseAND(3).alias("b"))
    assert df.collect() == [(1,), (2,)]
    s2 = _session(strict=False)
    bad = s2.create_dataframe(data).select(F.col("a").bitwiseAND(F.lit(3.0)).alias("b"))
    _, overrides = s2._physical_plan(bad._plan)  # planning only: no engine runs it
    reasons = [r for e in overrides.explain for r in e.reasons]
    assert any("outside its device signature (Byte+Integer+Long+Short)" in r
               for r in reasons), reasons


def test_shim_selection_and_defaults():
    from spark_rapids_tpu_torch import config as cfg
    from spark_rapids_tpu_torch.shims import Spark311Shim, Spark320Shim, Spark330Shim, get_shim

    assert isinstance(get_shim("3.1.1"), Spark311Shim)
    assert isinstance(get_shim("3.2.0"), Spark320Shim)
    assert isinstance(get_shim("3.3"), Spark330Shim) and isinstance(get_shim(None), Spark311Shim)
    with pytest.raises(ValueError):
        get_shim("2.4.8")
    # shim-driven default: 3.2 turns adaptive on unless the user set it
    s = _session({"spark.rapids.tpu.sparkVersion": "3.2.0"})
    assert cfg.ADAPTIVE_ENABLED.get(s.conf) is True
    s2 = _session({"spark.rapids.tpu.sparkVersion": "3.2.0", "spark.sql.adaptive.enabled": False})
    assert cfg.ADAPTIVE_ENABLED.get(s2.conf) is False
    assert _session().shim.version == "3.1"
    assert cfg.ADAPTIVE_ENABLED.get(_session().conf) is False


def test_shim_parquet_rebase_write(tmp_path):
    """The 3.1/3.2 shims refuse pre-Gregorian-cutover dates in Parquet
    writes (rebase EXCEPTION mode), as the JAX session does; the 3.3 shim
    writes them as they are (CORRECTED), read back by both readers."""
    import datetime

    import pyarrow as pa

    from spark_rapids_tpu import TpuSession

    t = pa.table({"d": pa.array([datetime.date(1500, 1, 1)])})
    s = _session({"spark.rapids.sql.enabled": False}, strict=False)
    with pytest.raises(ValueError, match="1582") as got:
        s.create_dataframe(t).write.parquet(str(tmp_path / "old"))
    with pytest.raises(ValueError) as want:
        TpuSession({"spark.rapids.sql.enabled": False}).create_dataframe(t).write.parquet(
            str(tmp_path / "old_jax"))
    assert str(got.value) == str(want.value)
    s33 = _session({"spark.rapids.sql.enabled": False, "spark.rapids.tpu.sparkVersion": "3.3"},
                   strict=False)
    s33.create_dataframe(t).write.parquet(str(tmp_path / "ok"))
    assert s33.read.parquet(str(tmp_path / "ok")).collect() == [(datetime.date(1500, 1, 1),)]
    jax33 = TpuSession({"spark.rapids.sql.enabled": False, "spark.rapids.tpu.sparkVersion": "3.3"})
    assert jax33.read.parquet(str(tmp_path / "ok")).collect() == [(datetime.date(1500, 1, 1),)]
    s.create_dataframe(pa.table({"d": pa.array([datetime.date(2020, 5, 4)])})).write.parquet(
        str(tmp_path / "new"))


def test_shim_csv_null_value_routed(tmp_path):
    """The shim's ``nullValue`` default ("") reaches the port's CSV reader;
    a ``nullValue`` option replaces it — rows as the JAX session reads
    them."""
    from spark_rapids_tpu import TpuSession

    p = str(tmp_path / "x.csv")
    with open(p, "w") as f:
        f.write("a,b\n1,\n2,NULLISH\n")
    s = _session({"spark.rapids.sql.enabled": False}, strict=False)
    j = TpuSession({"spark.rapids.sql.enabled": False})
    for sess in (s, j):
        assert sess.read.option("header", "true").csv(p).collect() == [(1, None), (2, "NULLISH")]
        rows2 = sess.read.option("header", "true").option("nullValue", "NULLISH").csv(p).collect()
        assert rows2 == [(1, ""), (2, None)]


def test_rebase_guard_respects_timestamp_unit(tmp_path):
    """A 1960 timestamp[ns] is after the cutover and writes; a 1500
    timestamp[s] is refused (the port holds microseconds, so each Arrow
    unit is scaled on the way in)."""
    import datetime

    import pyarrow as pa

    s = _session({"spark.rapids.sql.enabled": False}, strict=False)
    ok = pa.table({"t": pa.array([datetime.datetime(1960, 1, 1)], type=pa.timestamp("ns"))})
    s.create_dataframe(ok).write.parquet(str(tmp_path / "ns"))
    old = pa.table({"t": pa.array([int(-1.48e10)], type=pa.timestamp("s"))})
    with pytest.raises(ValueError, match="1582"):
        s.create_dataframe(old).write.parquet(str(tmp_path / "s"))


def test_coalesce_batches_merges_small_scan_batches(tmp_path):
    """Ten one-file batches coalesce into one device batch before compute
    (the TargetSize goal), with rows equal to the JAX engines'."""
    import pyarrow as pa
    import pyarrow.parquet as papq

    from spark_rapids_tpu import TpuSession
    from spark_rapids_tpu.functions import col as jcol
    from spark_rapids_tpu.functions import sum as jsum
    from spark_rapids_tpu_torch.functions import col, sum as sum_

    for i in range(10):
        papq.write_table(pa.table({"x": pa.array(range(i * 10, i * 10 + 10))}),
                         str(tmp_path / f"f{i}.parquet"))
    s = _session()
    rows = (s.read.option("readerType", "COALESCING").parquet(str(tmp_path))
            .agg(sum_(col("x")).alias("s")).collect())
    want = (TpuSession({"spark.rapids.sql.enabled": False}).read
            .option("readerType", "COALESCING").parquet(str(tmp_path))
            .agg(jsum(jcol("x")).alias("s")).collect())
    assert rows == want == [(sum(range(100)),)]
    m = s._last_plan.collect_metrics()
    coalesce_counts = [d.get("numOutputBatches") for k, d in m.items()
                       if "GpuCoalesceBatches" in k]
    assert coalesce_counts and coalesce_counts[0] == 1, m


def test_unknown_spark_version_raises_as_jax():
    """``sparkVersion`` 2.4 raises ``ValueError`` at construction, with the
    JAX package's message."""
    from spark_rapids_tpu import TpuSession

    with pytest.raises(ValueError) as want:
        TpuSession({"spark.rapids.sql.enabled": False, "spark.rapids.tpu.sparkVersion": "2.4"})
    with pytest.raises(ValueError) as got:
        _session({"spark.rapids.tpu.sparkVersion": "2.4"})
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("version", ["3.1", "3.2", "3.3"])
def test_shim_defaults_equal_jax(version):
    """Each shim's ANSI and adaptive defaults, and the session conf they
    fill, equal the JAX package's."""
    from spark_rapids_tpu import config as jcfg
    from spark_rapids_tpu.shims import get_shim as jget
    from spark_rapids_tpu_torch import config as cfg
    from spark_rapids_tpu_torch.shims import get_shim

    j, p = jget(version), get_shim(version)
    for m in ("ansi_default", "adaptive_default", "csv_null_value", "strict_date_parsing",
              "max_decimal_precision", "parquet_rebase_write"):
        assert getattr(p, m)() == getattr(j, m)(), m
    from tests.harness import cpu_session

    js = cpu_session({"spark.rapids.tpu.sparkVersion": version})
    ps = _session({"spark.rapids.tpu.sparkVersion": version})
    assert cfg.ADAPTIVE_ENABLED.get(ps.conf) == jcfg.ADAPTIVE_ENABLED.get(js.conf)
    assert cfg.ANSI_ENABLED.get(ps.conf) == jcfg.ANSI_ENABLED.get(js.conf)


def test_adaptive_exchange_stays_on_the_device():
    """With adaptive on (the 3.2 shim), an in-process exchange is no longer
    kept on the CPU engine; since the shuffle slice, neither is an exchange
    through the shuffle manager (strict mode, equal rows)."""
    from spark_rapids_tpu_torch import functions as F

    data = {"k": np.arange(300, dtype=np.int64) % 7, "v": np.arange(300, dtype=np.int64)}
    s = _session({"spark.rapids.tpu.sparkVersion": "3.2"})
    rows = sorted(s.create_dataframe(data, num_partitions=3).group_by("k")
                  .agg(F.sum(F.col("v")).alias("s")).collect())
    assert len(rows) == 7
    assert "GpuShuffleExchange" in s._last_plan.tree_string()
    s2 = _session({"spark.rapids.shuffle.manager.enabled": True})
    rows2 = sorted(s2.create_dataframe(data, num_partitions=3).group_by("k")
                   .agg(F.sum(F.col("v")).alias("s")).collect())
    assert rows2 == rows
    assert "GpuShuffleExchange" in s2._last_plan.tree_string()
    assert all(e.on_device for e in s2._last_overrides.explain
               if e.node.startswith("ShuffleExchange") or "Exchange" in e.node.split(" ")[0])


# ── config registry and generated documents ────────────────────────────────


def _source_blob() -> str:
    chunks = []
    for root, _dirs, files in os.walk(PORT_ROOT):
        for f in files:
            if f.endswith(".py") and f != "config.py":
                with open(os.path.join(root, f)) as fh:
                    chunks.append(fh.read())
    return "\n".join(chunks)


def test_every_registered_key_is_read_somewhere():
    """Each ConfEntry constant of the port must be referenced outside
    ``config.py`` in the port's package."""
    import spark_rapids_tpu_torch.config as cfg

    blob = _source_blob()
    names = {name for name, v in vars(cfg).items() if isinstance(v, cfg.ConfEntry)}
    unused = sorted(
        n for n in names
        if not re.search(rf"\bcfg\.{n}\b|\b{n}\.get\b|\bconfig\.{n}\b", blob)
    )
    assert not unused, f"registered but never read: {unused}"


def test_docs_generate_and_cover_all_public_keys():
    import spark_rapids_tpu_torch.config as cfg
    from spark_rapids_tpu_torch.docs_gen import generate_configs_md, generate_supported_ops_md

    md = generate_configs_md()
    for key, e in cfg._REGISTRY.items():
        if not e.internal:
            assert f"`{key}`" in md, key
    ops = generate_supported_ops_md()
    assert "FilterExec" in ops and "Cast" in ops


@pytest.mark.parametrize("doc", ["configs", "supported_ops"])
def test_generated_docs_equal_checked_in(doc):
    """``docs/torch_*.md`` are what ``python -m spark_rapids_tpu_torch.docs_gen``
    writes from the registries today."""
    from spark_rapids_tpu_torch import docs_gen

    gen = {"configs": (docs_gen.generate_configs_md, docs_gen.CONFIGS_MD),
           "supported_ops": (docs_gen.generate_supported_ops_md, docs_gen.SUPPORTED_OPS_MD)}
    fn, name = gen[doc]
    with open(os.path.join(ROOT, "docs", name)) as f:
        assert f.read() == fn(), f"docs/{name} is stale: rerun the generator"


def test_metrics_level_gates_timing_metrics():
    """MODERATE collects the download's timer, ESSENTIAL does not (the port
    times the download; its upload is billed to the ledger's ``h2d``
    phase, not to a per-node timer)."""
    from spark_rapids_tpu_torch import functions as F

    data = {"a": np.arange(100, dtype=np.int64), "b": np.arange(100, dtype=np.float64)}

    def q(s):
        return (s.create_dataframe(data, num_partitions=2).filter(F.col("a") > 10)
                .agg(F.sum(F.col("b")).alias("s")))

    s1 = _session({"spark.rapids.sql.metrics.level": "MODERATE"})
    q(s1).collect()
    m1 = s1._last_plan.collect_metrics()
    flat1 = {k for d in m1.values() for k in d}
    assert "numInputRows" in flat1 and "deviceToHostTime" in flat1
    timed = [v for d in m1.values() for k, v in d.items() if k == "deviceToHostTime"]
    assert timed and timed[0] > 0
    s2 = _session({"spark.rapids.sql.metrics.level": "ESSENTIAL"})
    q(s2).collect()
    m2 = s2._last_plan.collect_metrics()
    timed2 = [v for d in m2.values() for k, v in d.items() if k == "deviceToHostTime"]
    assert all(v == 0 for v in timed2)


def test_variable_float_agg_gate():
    from spark_rapids_tpu_torch import functions as F

    s = _session({"spark.rapids.sql.variableFloatAgg.enabled": False}, strict=False)
    df = s.create_dataframe({"k": np.array([1, 1, 2]), "x": np.array([0.5, 1.5, 2.5])})
    rows = sorted(df.group_by("k").agg(F.sum(F.col("x")).alias("s")).collect())
    assert rows == [(1, 2.0), (2, 2.5)]
    assert any("HashAggregate" in e.node and not e.on_device for e in s._last_overrides.explain)
    s2 = _session({"spark.rapids.sql.variableFloatAgg.enabled": False})
    df2 = s2.create_dataframe({"k": np.array([1, 1]), "x": np.array([1, 2])})
    assert df2.group_by("k").agg(F.sum(F.col("x")).alias("s")).collect() == [(1, 3)]


def test_has_nans_false_differential():
    """hasNans=false: with no NaNs present, the rows equal the JAX CPU
    engine's."""
    import pyarrow as pa

    from spark_rapids_tpu.functions import col, sum as sum_
    from tests.test_torch_dataframe_api import assert_jax_cpu_and_port_equal

    t = pa.table({"k": [1.5, 1.5, 2.5, None], "x": [1, 2, 3, 4]})
    assert_jax_cpu_and_port_equal(
        lambda s: s.create_dataframe(t).group_by("k").agg(sum_(col("x")).alias("s")),
        conf={"spark.rapids.sql.hasNans": False},
    )


def test_batch_size_bytes_rechunks_h2d():
    from spark_rapids_tpu_torch import functions as F

    s = _session({"spark.rapids.sql.batchSizeBytes": "1kb"})
    df = s.create_dataframe({"a": np.arange(1000, dtype=np.int64)}).filter(F.col("a") >= 0)
    assert len(df.collect()) == 1000


# ── registry/API invariants ────────────────────────────────────────────────


def test_expr_rules_name_expression_classes():
    from spark_rapids_tpu_torch.expr.base import Expression
    from spark_rapids_tpu_torch.plan import overrides as O

    for cls, rule in O.expr_rules().items():
        assert issubclass(cls, Expression), cls
        assert rule.name, cls
        assert rule.conf_key.startswith("spark.rapids.sql.expression."), rule.conf_key


def test_exec_rules_reference_real_cpu_execs():
    from spark_rapids_tpu_torch.plan import overrides as O
    from spark_rapids_tpu_torch.plan.physical import Exec

    for cls, rule in O.exec_rules().items():
        assert issubclass(cls, Exec), cls
        assert rule.conf_key.startswith("spark.rapids.sql.exec."), rule.conf_key
        assert callable(rule.convert), cls


def test_aggregate_buffer_arities_consistent():
    """update_exprs, buffer_types, update_ops and merge_ops of every
    aggregate of the port agree in arity."""
    from spark_rapids_tpu_torch.expr import aggregates as agg
    from spark_rapids_tpu_torch.expr.base import BoundReference
    from spark_rapids_tpu_torch.types import DOUBLE

    x = BoundReference(0, DOUBLE, True)
    y = BoundReference(1, DOUBLE, True)
    instances = []
    for name in dir(agg):
        cls = getattr(agg, name)
        if (inspect.isclass(cls) and issubclass(cls, agg.AggregateFunction)
                and cls is not agg.AggregateFunction and not name.startswith("_")):
            fields = [f for f in getattr(cls, "__dataclass_fields__", {}) if f != "ignore_nulls"]
            try:
                if not fields:
                    instances.append(cls())
                elif len(fields) == 1:
                    instances.append(cls(x))
                else:
                    instances.append(cls(x, y))
            except Exception:
                continue  # constructor needs richer args
    assert len(instances) >= 10
    for inst in instances:
        try:
            ue, bt, uo, mo = inst.update_exprs, inst.buffer_types, inst.update_ops, inst.merge_ops
        except (NotImplementedError, AssertionError):
            continue
        n = len(bt)
        assert len(ue) == n and len(uo) == n and len(mo) == n, inst


def _doc(name: str) -> str:
    with open(os.path.join(ROOT, "docs", name)) as f:
        return f.read()


def test_every_kill_switch_documented():
    from spark_rapids_tpu_torch.docs_gen import CONFIGS_MD
    from spark_rapids_tpu_torch.plan import overrides as O

    doc = _doc(CONFIGS_MD)
    missing = [r.conf_key for r in list(O.expr_rules().values()) + list(O.exec_rules().values())
               if r.conf_key not in doc]
    assert not missing, f"kill switches absent from docs/{CONFIGS_MD}: {missing[:10]}"


def test_supported_ops_doc_covers_exec_rules():
    from spark_rapids_tpu_torch.docs_gen import SUPPORTED_OPS_MD
    from spark_rapids_tpu_torch.plan import overrides as O

    doc = _doc(SUPPORTED_OPS_MD)
    for rule in O.exec_rules().values():
        assert rule.name in doc, f"{rule.name} missing from {SUPPORTED_OPS_MD}"


def test_config_defaults_parse_roundtrip():
    from spark_rapids_tpu_torch import config as cfg
    from spark_rapids_tpu_torch.config import TpuConf

    conf = TpuConf({})
    for key, entry in cfg._REGISTRY.items():
        assert entry.get(conf) == entry.default, key
        if entry.default is not None:
            assert entry.conv(str(entry.default)) == entry.default, key
    assert len(cfg._REGISTRY) >= 40


def test_config_keys_and_defaults_equal_jax():
    """Every key the port registers is the JAX package's, with its default,
    scope and internal mark."""
    from spark_rapids_tpu import config as jcfg
    from spark_rapids_tpu_torch import config as cfg

    for key, e in cfg._REGISTRY.items():
        j = jcfg._REGISTRY.get(key)
        assert j is not None, key
        assert (e.default, e.startup_only, e.internal) == (j.default, j.startup_only,
                                                           j.internal), key


def test_window_ranking_classes_registered():
    from spark_rapids_tpu_torch.expr import windows as W
    from spark_rapids_tpu_torch.plan import overrides as O

    rules = O.expr_rules()
    for name in dir(W):
        cls = getattr(W, name)
        if inspect.isclass(cls) and issubclass(cls, W.RankingFunction) \
                and cls is not W.RankingFunction:
            assert cls in rules, f"{name} has no expression rule"
