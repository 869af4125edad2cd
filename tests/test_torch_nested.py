"""Nested types on the PyTorch port: array, struct and map columns, the
collect family, explode, split, get_json_object, range and rand.

The JAX package's suites ``test_complex_types.py``, ``test_range.py`` and
``test_json_device.py`` run unchanged through the mirror helpers of
``tests/test_torch_dataframe_api.py``, with ``assert_cpu_and_tpu_equal``
swapped for :func:`assert_jax_engines_and_port_equal`: each query runs on the
JAX CPU engine, on the JAX device engine (on JAX-CPU) and on the port's
device engine (``device="cpu"``, strict), and the port's rows are held to
both with the harness's normalization and tolerance.

The unit tests below hold the port's ``group_max_size``, ``_group_collect``
(through ``group_aggregate``), split's multi-byte delimiter scan, ``rand``
and the nested upload/download/gather/concat/spill round trip to the JAX
functions on the same numpy inputs, made from a seed.
"""
from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch

from tests.test_torch_dataframe_api import (  # the shared mirror helpers
    PortSession,
    check_covers,
    mirrored_cases,
    patch_module,
    run_reference,
)

REF_MODULES = ("test_complex_types", "test_range", "test_json_device")

#: reference tests not mirrored here (none wait for a later slice)
NOT_IN_SLICE: dict = {}

#: reference tests mirrored by a test of this file, each with its name
MIRRORED_ELSEWHERE = {
    "test_range::test_range_is_device_born":
        "test_range_is_device_born (the port's operator names)",
    "test_complex_types::test_complex_group_key_falls_back":
        "test_complex_group_key_stays_on_cpu_engine (builds the session itself)",
    "test_json_device::test_get_json_object_falls_back_without_conf":
        "test_get_json_object_stays_on_cpu_engine_without_conf",
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def assert_jax_engines_and_port_equal(
    build_df, conf=None, sort_result=True, approx_float=False, allowed_non_tpu=None
):
    """The port's device rows against the JAX CPU engine's and the JAX
    device engine's (each query on all three), under the harness's
    normalization and tolerance."""
    from tests.harness import _normalize, _values_equal, cpu_session, tpu_session

    extra = dict(conf or {})
    if allowed_non_tpu:
        extra["spark.rapids.sql.test.allowedNonGpu"] = ",".join(allowed_non_tpu)
    port_n = _normalize(build_df(PortSession(extra)).collect(), sort_result)
    for engine, session in (("JAX cpu", cpu_session(conf)), ("JAX device", tpu_session(extra))):
        ref_n = _normalize(build_df(session).collect(), sort_result)
        assert len(ref_n) == len(port_n), f"row count: {engine}={len(ref_n)} port={len(port_n)}"
        for i, (rr, pr) in enumerate(zip(ref_n, port_n)):
            assert len(rr) == len(pr), f"row {i} arity: {rr} vs {pr}"
            for j, (rv, pv) in enumerate(zip(rr, pr)):
                assert _values_equal(rv, pv, approx_float), (
                    f"row {i} col {j}: {engine}={rv!r} port={pv!r}\n"
                    f"{engine} rows: {ref_n[max(0, i - 2): i + 3]}\n"
                    f"port rows: {port_n[max(0, i - 2): i + 3]}"
                )


CASES = mirrored_cases(REF_MODULES, NOT_IN_SLICE, MIRRORED_ELSEWHERE)


@pytest.mark.parametrize("module,fname,kwargs", CASES)
def test_mirror(module, fname, kwargs, monkeypatch, request):
    mod = importlib.import_module(module)
    patch_module(mod, monkeypatch)
    monkeypatch.setattr(mod, "assert_cpu_and_tpu_equal", assert_jax_engines_and_port_equal,
                        raising=False)
    run_reference(mod, getattr(mod, fname), kwargs, request)


def test_mirror_covers_every_suite():
    check_covers(REF_MODULES, CASES, NOT_IN_SLICE, MIRRORED_ELSEWHERE)


# ── the reference tests mirrored by hand ──────────────────────────────────


def _nested_table(n: int = 120, seed: int = 5):
    """array<long>, array<string>, struct<x: long, y: string> and
    map<string, double> columns with nulls everywhere, from a seed."""
    import pyarrow as pa

    rng = np.random.default_rng(seed)

    def maybe(v, p=0.15):
        return None if rng.random() < p else v

    arrs = [maybe([maybe(int(rng.integers(-50, 50))) for _ in range(rng.integers(0, 6))])
            for _ in range(n)]
    sarrs = [maybe([maybe(f"w{rng.integers(0, 30)}" * int(rng.integers(1, 4)))
                    for _ in range(rng.integers(0, 4))]) for _ in range(n)]
    structs = [maybe({"x": int(rng.integers(-9, 9)), "y": maybe(f"s{rng.integers(0, 99)}")})
               for _ in range(n)]
    maps = [maybe([(f"k{j}", maybe(float(rng.integers(0, 9)))) for j in range(rng.integers(0, 3))])
            for _ in range(n)]
    return pa.table({
        "id": pa.array(range(n), type=pa.int64()),
        "a": pa.array(arrs, type=pa.list_(pa.int64())),
        "sa": pa.array(sarrs, type=pa.list_(pa.string())),
        "s": pa.array(structs, type=pa.struct([("x", pa.int64()), ("y", pa.string())])),
        "m": pa.array(maps, type=pa.map_(pa.string(), pa.float64())),
    })


def test_range_is_device_born():
    """``test_range.py::test_range_is_device_born`` with the port's operator
    names: the range is a device node, nothing is uploaded."""
    from spark_rapids_tpu_torch.functions import col

    s = PortSession()
    df = s.range(100).filter(col("id") > 5)
    plan = df.explain()
    assert "GpuRange" in plan and "HostToDevice" not in plan
    assert len(df.collect()) == 94
    assert s._s._last_metrics["hostToDeviceBytes"] == 0


def test_complex_group_key_stays_on_cpu_engine():
    """``test_complex_types.py::test_complex_group_key_falls_back``: an array
    grouping key has no radix words, so the aggregate stays on the CPU
    engine with the JAX package's reason, and the counts still add up."""
    from spark_rapids_tpu_torch import TorchSession
    from spark_rapids_tpu_torch.functions import count

    t = _nested_table()
    s = TorchSession({"spark.rapids.sql.enabled": True}, device="cpu")
    rows = s.create_dataframe(t, num_partitions=2).group_by("a").agg(
        count("*").alias("n")).collect()
    assert sum(r[-1] for r in rows) == t.num_rows
    assert any("grouping key" in r for e in s._last_overrides.explain for r in e.reasons)


def test_get_json_object_stays_on_cpu_engine_without_conf():
    """``test_json_device.py::test_get_json_object_falls_back_without_conf``."""
    from spark_rapids_tpu_torch import TorchSession
    from spark_rapids_tpu_torch import functions as F

    s = TorchSession({"spark.rapids.sql.enabled": True}, device="cpu")
    df = s.create_dataframe({"j": ['{"a":1}']}).select(
        F.get_json_object(F.col("j"), "$.a").alias("r"))
    assert df.collect() == [("1",)]
    assert "CpuProject" in df.explain()


# ── the port's functions against the JAX package's ─────────────────────────


def _jax_batch(table):
    from spark_rapids_tpu.columnar.device import host_to_device

    return host_to_device(table.to_batches()[0])


def _port_batch(table):
    from spark_rapids_tpu_torch.columnar.device import host_to_device
    from spark_rapids_tpu_torch.columnar.host import from_arrow

    return host_to_device(from_arrow(table), "cpu")


def _planes(col, n):
    """(path, numpy plane) of every plane of a device column (either
    package's), its first ``n`` rows, children included."""
    out = []

    def walk(c, path):
        for name in ("data", "validity", "lengths"):
            t = getattr(c, name)
            if t is not None:
                a = t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
                out.append((f"{path}.{name}", a[:n]))
        for k, kid in enumerate(c.children or ()):
            walk(kid, f"{path}.{k}")

    walk(col, "c")
    return out


def _assert_same_planes(jcol, pcol, n):
    jp, pp = _planes(jcol, n), _planes(pcol, n)
    assert [p for p, _ in jp] == [p for p, _ in pp]
    for (path, a), (_, b) in zip(jp, pp):
        np.testing.assert_array_equal(a, b, err_msg=path)


def test_nested_upload_gather_concat_download_equal_jax():
    """The nested device layout: the port's upload, gather and concat give
    the JAX package's planes (data, validity, lengths, each child), and the
    download gives the table back."""
    from spark_rapids_tpu.ops.concat import concat_device as jconcat
    from spark_rapids_tpu.ops.gather import gather_batch as jgather
    from spark_rapids_tpu_torch.columnar.device import device_to_host
    from spark_rapids_tpu_torch.columnar.host import to_arrow
    from spark_rapids_tpu_torch.ops.concat import concat_device
    from spark_rapids_tpu_torch.ops.gather import gather_batch

    t = _nested_table()
    n = t.num_rows
    jb, pb = _jax_batch(t), _port_batch(t)
    for jc, pc in zip(jb.columns, pb.columns):
        _assert_same_planes(jc, pc, n)
    assert to_arrow(device_to_host(pb)).equals(t)
    idx = np.random.default_rng(3).integers(0, n, size=pb.capacity)
    jg = jgather(jb, np.asarray(idx[: jb.capacity]), n)
    pg = gather_batch(pb, torch.from_numpy(idx), n)
    for jc, pc in zip(jg.columns, pg.columns):
        _assert_same_planes(jc, pc, n)
    t2 = _nested_table(37, seed=9)
    jcat = jconcat([jb, _jax_batch(t2)])
    for counts in (None, [n, t2.num_rows]):
        pcat = concat_device([pb, _port_batch(t2)], counts=counts)
        for jc, pc in zip(jcat.columns, pcat.columns):
            _assert_same_planes(jc, pc, n + t2.num_rows)
    import pyarrow as pa

    want = pa.concat_tables([t, t2])
    assert to_arrow(device_to_host(pcat)).equals(want)


def test_nested_batch_spills_and_restores_bit_for_bit(tmp_path):
    """A nested batch walks device → host → disk in the spill catalog (each
    child plane under its own path key in the ``.srtf`` frame) and comes
    back plane for plane; the catalog counts every child plane's bytes."""
    from spark_rapids_tpu_torch.columnar.device import column_planes
    from spark_rapids_tpu_torch.mem import spill as PS

    db = _port_batch(_nested_table())
    want = [t.clone() for c in db.columns for t in column_planes(c)]
    assert db.size_bytes() == sum(t.numel() * t.element_size() for t in want)
    cat = PS.BufferCatalog(spill_dir=str(tmp_path))
    h = cat.register(db)
    del db
    assert cat.synchronous_spill(h.size_bytes) >= h.size_bytes
    cat.host_limit = 0
    cat.synchronous_spill(0)
    assert cat._buffers[h.id].tier == PS.StorageTier.DISK
    import json

    from spark_rapids_tpu_torch import native

    path = cat._buffers[h.id].path
    assert path.endswith(".srtf")
    with open(path, "rb") as f:
        names = json.loads(bytes(native.frame_unpack(f.read())[0]))["names"]
    assert {"d1.0", "v1.0", "d2.0", "l2.0", "d3.1", "v4.1"} <= set(names)
    got = [t for c in h.get_batch().columns for t in column_planes(c)]
    assert len(got) == len(want)
    assert all(torch.equal(a, b) for a, b in zip(want, got))


def _keyed_table(n, seed, strings=False):
    import pyarrow as pa

    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 9, size=n)
    vals = rng.integers(-4, 4, size=n).astype(np.float64)
    vals[rng.random(n) < 0.1] = np.nan
    vals[rng.random(n) < 0.1] = -0.0
    valid = rng.random(n) > 0.15
    if strings:
        v = pa.array([f"v{x}" if ok else None for x, ok in zip(vals, valid)])
    else:
        v = pa.array(vals, mask=~valid)
    return pa.table({"k": pa.array(keys, type=pa.int64()), "v": v})


@pytest.mark.parametrize("strings", [False, True])
@pytest.mark.parametrize("op", ["collect_list", "collect_set"])
def test_group_collect_equals_jax(op, strings):
    """``group_max_size`` and the collect planes of ``group_aggregate``
    (``_group_collect``) against the JAX functions: the same groups, sizes
    and element planes, NaN canonical and -0.0 as 0.0 in a set."""
    from spark_rapids_tpu.ops import aggregate as jagg
    from spark_rapids_tpu_torch.ops import aggregate as pagg

    t = _keyed_table(200, 11, strings)
    jb, pb = _jax_batch(t), _port_batch(t)
    jw = int(jagg.group_max_size(jb, [0]))
    pw = int(pagg.group_max_size(pb, [0]))
    assert jw == pw
    W = 1 << max(3, (pw - 1).bit_length())
    _, jaggs, jng = jagg.group_aggregate(jb, [0], [jb.columns[1]], [op], collect_width=W)
    _, paggs, png = pagg.group_aggregate(pb, [0], [pb.columns[1]], [op], collect_width=W)
    assert int(jng) == int(png)
    _assert_same_planes(jaggs[0], paggs[0], int(png))


@pytest.mark.parametrize("op", ["collect_list", "collect_set"])
def test_ungrouped_collect_equals_jax(op):
    from spark_rapids_tpu.ops import aggregate as jagg
    from spark_rapids_tpu_torch.ops import aggregate as pagg

    t = _keyed_table(50, 4)
    jb, pb = _jax_batch(t), _port_batch(t)
    W = 64
    _, jaggs, _ = jagg.group_aggregate(jb, [], [jb.columns[1]], [op], min_groups=1,
                                       collect_width=W)
    _, paggs, _ = pagg.group_aggregate(pb, [], [pb.columns[1]], [op], collect_width=W)
    _assert_same_planes(jaggs[0], paggs[0], 1)


@pytest.mark.parametrize("pattern", [",", "ab", "aba", "xyz", "[,;]"])
@pytest.mark.parametrize("limit", [-1, 2])
def test_split_planes_equal_jax(pattern, limit):
    """split's device planes (the delimiter scan, multi-byte non-overlap
    included; token starts and lengths; the token byte planes) against the
    JAX device function on the same input."""
    import pyarrow as pa

    from spark_rapids_tpu.expr.base import Ctx as JCtx
    from spark_rapids_tpu.expr.base import BoundReference as JRef
    from spark_rapids_tpu.expr.base import Literal as JLit
    from spark_rapids_tpu.expr.strings_ext import StringSplit as JSplit
    from spark_rapids_tpu.types import STRING as JSTRING
    from spark_rapids_tpu_torch.expr.base import BoundReference, Ctx, Literal
    from spark_rapids_tpu_torch.expr.strings_ext import StringSplit
    from spark_rapids_tpu_torch.types import STRING

    rng = np.random.default_rng(17)
    alphabet = list("abxyz,;")
    words = [None if rng.random() < 0.1 else
             "".join(rng.choice(alphabet, size=rng.integers(0, 14))) for _ in range(64)]
    t = pa.table({"s": pa.array(words, type=pa.string())})
    jb, pb = _jax_batch(t), _port_batch(t)
    je = JSplit(JRef(0, JSTRING, True), JLit(pattern, JSTRING), limit, 16)
    pe = StringSplit(BoundReference(0, STRING, True), Literal(pattern, STRING), limit, 16)
    jv = je.eval(JCtx.for_device(jb))
    pc = Ctx.for_device(pb)
    pv = pe.eval(pc)
    n = len(words)
    np.testing.assert_array_equal(np.asarray(jv.lengths)[:n], pv.lengths[:n].numpy())
    np.testing.assert_array_equal(np.asarray(jv.valid)[:n], pv.valid[:n].numpy())
    _assert_same_planes(jv.children[0], pv.children[0], n)


def test_rand_equals_jax_bit_for_bit():
    """``rand(7)`` on the port's device engine, the port's CPU engine, the
    JAX CPU engine and the JAX device engine: the same doubles, to the bit,
    over three partitions; and two device runs agree."""
    from spark_rapids_tpu.functions import rand as jrand
    from spark_rapids_tpu_torch import TorchSession
    from spark_rapids_tpu_torch.functions import rand
    from tests.harness import cpu_session, tpu_session

    conf = {"spark.rapids.sql.incompatibleOps.enabled": True}

    def bits(rows):
        return sorted((r[0], np.float64(r[1]).view(np.int64)) for r in rows)

    ref = bits(cpu_session(conf).range(0, 3000, 1, 3).select("id", jrand(7)).collect())
    assert ref == bits(tpu_session(conf).range(0, 3000, 1, 3).select("id", jrand(7)).collect())
    dev = TorchSession({"spark.rapids.sql.enabled": True, "spark.rapids.sql.test.enabled": True,
                        **conf}, device="cpu")
    cpu = TorchSession({"spark.rapids.sql.enabled": False}, device="cpu")
    for s in (dev, dev, cpu):
        assert bits(s.range(0, 3000, 1, 3).select("id", rand(7)).collect()) == ref


def test_nested_batch_paths_carry_children():
    """The shrink, the retry split and the adaptive read's row-range slice
    move a nested column's children with its rows (a path that dropped
    them would show only as wrong rows)."""
    from spark_rapids_tpu_torch.columnar.device import device_to_host
    from spark_rapids_tpu_torch.columnar.host import batch_rows, from_arrow
    from spark_rapids_tpu_torch.exec.gpu import _row_range_slice
    from spark_rapids_tpu_torch.ops.gather import bulk_shrink
    from spark_rapids_tpu_torch.resilience.retry import split_batch

    t = _nested_table(100)
    want = batch_rows(from_arrow(t))
    db = _port_batch(t)
    (shrunk,), _ = bulk_shrink([db])
    assert batch_rows(device_to_host(shrunk)) == want
    lo, hi = split_batch(_port_batch(_nested_table(70)))
    assert batch_rows(device_to_host(lo)) + batch_rows(device_to_host(hi)) == \
        batch_rows(from_arrow(_nested_table(70)))
    parts = [batch_rows(device_to_host(_row_range_slice(db, j, 3))) for j in range(3)]
    assert parts[0] + parts[1] + parts[2] == want


def test_create_dataframe_takes_python_nested_values():
    """Lists and dicts in a dict input become array and map columns, tuples
    (with a schema) struct columns; the device and the CPU engine read them
    alike."""
    from spark_rapids_tpu_torch import TorchSession
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.types import LONG, STRING, Schema, StructField, StructType

    data = {"id": np.arange(4, dtype=np.int64), "a": [[1, 2], None, [], [3]],
            "m": [{"x": 1.0}, {}, None, {"y": 2.5}]}
    st = StructType((StructField("p", LONG), StructField("q", STRING)))
    sch = Schema([StructField("id", LONG), StructField("s", st)])
    rows = []
    for enabled in (True, False):
        s = TorchSession({"spark.rapids.sql.enabled": enabled,
                          "spark.rapids.sql.test.enabled": enabled}, device="cpu")
        df = s.create_dataframe(data).select(
            "id", F.size(F.col("a")).alias("n"), F.col("m")["x"].alias("x"))
        sdf = s.create_dataframe({"id": [1, 2], "s": [(5, "a"), None]}, sch)
        rows.append((df.collect(), sdf.select(F.col("s")["q"].alias("q")).collect()))
    assert rows[0] == rows[1]
    assert rows[0][0] == [(0, 2, 1.0), (1, -1, None), (2, 0, None), (3, 1, None)]
    assert rows[0][1] == [("a",), (None,)]
