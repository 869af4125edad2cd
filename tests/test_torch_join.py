"""The port's equi-joins (spark_rapids_tpu_torch/ops/join.py, exec/
cpu_join.py, exec/gpu_join.py, the planner's join planning and the
DataFrame's ``join``) against the JAX package, on the CPU at a small size.

* ``join_bounds``, ``gather_pairs`` and ``join_output_schema`` against the
  JAX functions element for element: build order, lower, upper, pair
  indices, live mask and total, over int, long, double (NaN, ±0.0), date
  and string keys (planes of widths 8 and 130, NUL and multi-byte bytes),
  several keys, null keys on both sides, padding rows, duplicates and sides
  with no live row. The key words also equal the JAX words after
  ``to_uint64``.
* Mirrors of the hash-join cases of ``tests/test_joins.py`` and
  ``tests/test_broadcast_joins.py``: the six hash-join types, shuffled
  (threshold -1) and broadcast, the residual condition, the build-left
  swap and the right/full outer tails; each through the port's device path
  (device="cpu", strict mode), the port's CPU engine and the JAX CPU
  engine, a few also through the JAX device engine on JAX-CPU. Rows are
  compared order-insensitively, floats within the harness's tolerance.
* Nested-loop and cartesian joins on the device (``GpuBroadcastNestedLoopJoinExec``,
  ``GpuCartesianProductExec``): mirrors of ``tests/test_cartesian.py`` and
  the cross and non-equi cases of ``tests/test_broadcast_joins.py``, and a
  stream chunked under a small pair cap.

Inputs come from numpy seeds (or the reference's ``data_gen`` tables) and
enter both packages as the same arrays."""
from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; absent on a machine with only the port

import jax.numpy as jnp  # noqa: E402
import pyarrow as pa  # noqa: E402

import spark_rapids_tpu.functions as JF  # noqa: E402
import spark_rapids_tpu.types as JT  # noqa: E402
from data_gen import gen_grouped_table, gen_table  # noqa: E402
from harness import _normalize, _values_equal, cpu_session, tpu_session  # noqa: E402
from spark_rapids_tpu.columnar.device import DeviceColumn as JColumn  # noqa: E402
from spark_rapids_tpu.ops import join as jjoin  # noqa: E402
from spark_rapids_tpu_torch import TorchSession  # noqa: E402
from spark_rapids_tpu_torch import functions as PF  # noqa: E402
from spark_rapids_tpu_torch import types as PT  # noqa: E402
from spark_rapids_tpu_torch.columnar.device import DeviceColumn, bucket_capacity  # noqa: E402
from spark_rapids_tpu_torch.ops import hash as phash  # noqa: E402
from spark_rapids_tpu_torch.ops import join as pjoin  # noqa: E402
from spark_rapids_tpu_torch.ops import sortkeys as psk  # noqa: E402

NO_BC = {"spark.sql.autoBroadcastJoinThreshold": "-1"}
JOIN_TYPES = ["inner", "left", "right", "full", "left_semi", "left_anti"]


# ── join_bounds / gather_pairs against the JAX functions ───────────────────

_POOL = [b"", b"a", b"ab", b"abc", "h\xe9llo".encode(), "\xe9".encode(), b"a\x00b",
         b"a\x00", b"\xff\xfe", b"zz", "日本".encode(), b"x" * 8, b"y" * 40]


def _key(rng, kind: str, n: int, width: int, null_frac: float, pool_size: int):
    """(type name, data, validity, lengths) of one key column of ``n`` rows,
    values drawn from a small pool so the two sides share keys."""
    valid = rng.random(n) >= null_frac
    if kind == "string":
        pool = [b[:width] for b in _POOL[:pool_size]]
        plane = np.zeros((n, width), dtype=np.uint8)
        lengths = np.zeros(n, dtype=np.int32)
        for i, k in enumerate(rng.integers(0, len(pool), n)):
            b = pool[k] if valid[i] else b""
            plane[i, : len(b)] = np.frombuffer(b, dtype=np.uint8)
            lengths[i] = len(b)
        return "STRING", plane, valid, lengths
    vals = rng.integers(-pool_size // 2, pool_size // 2 + 1, n)
    if kind == "double":
        pool = np.array([1.5, -2.25, 0.0, -0.0, np.nan, np.inf, -np.inf, 3.0])
        data = pool[rng.integers(0, len(pool), n)]
    elif kind == "long_extremes":  # the words WORD_MIN and WORD_MAX themselves
        info = np.iinfo(np.int64)
        pool = np.array([info.min, info.min + 1, -1, 0, 1, info.max - 1, info.max])
        data = pool[rng.integers(0, len(pool), n)]
    else:
        data = vals.astype({"int": np.int32, "long": np.int64, "date": np.int32}[kind])
    data = np.where(valid, data, np.zeros((), data.dtype))
    names = {"int": "INT", "long": "LONG", "long_extremes": "LONG", "double": "DOUBLE",
             "date": "DATE"}
    return names[kind], data, valid, None


def _cols(specs):
    """(port DeviceColumns, JAX DeviceColumns) over the same arrays."""
    pcols, jcols = [], []
    for tname, data, valid, lengths in specs:
        pcols.append(DeviceColumn(
            getattr(PT, tname), torch.from_numpy(data.copy()), torch.from_numpy(valid.copy()),
            None if lengths is None else torch.from_numpy(lengths.copy()),
        ))
        jcols.append(JColumn(
            getattr(JT, tname), jnp.asarray(data), jnp.asarray(valid),
            None if lengths is None else jnp.asarray(lengths),
        ))
    return pcols, jcols


# name: (key kinds, build rows (capacity), probe rows, live build, live probe,
#        null fraction, key pool size, string widths (build, probe))
_BOUNDS_CASES = {
    "int": (["int"], 64, 48, 60, 40, 0.1, 12, None),
    "long_duplicates": (["long"], 64, 64, 64, 64, 0.0, 4, None),
    "long_extremes": (["long_extremes"], 64, 48, 50, 40, 0.1, 0, None),
    "double_nan_zero": (["double"], 40, 40, 36, 33, 0.1, 0, None),
    "date": (["date"], 32, 64, 30, 64, 0.2, 20, None),
    "string_8_130": (["string"], 48, 40, 45, 40, 0.1, 13, (8, 130)),
    "string_130_8": (["string"], 40, 48, 40, 41, 0.1, 13, (130, 8)),
    "multi_key": (["int", "string", "double"], 64, 64, 64, 50, 0.05, 5, (16, 8)),
    "all_null_build": (["long"], 16, 16, 16, 16, 1.0, 4, None),
    "no_live_build": (["long"], 16, 24, 0, 20, 0.0, 4, None),
    "no_live_probe": (["int"], 24, 16, 20, 0, 0.0, 4, None),
}


@pytest.mark.parametrize("case", list(_BOUNDS_CASES))
def test_join_bounds_and_gather_pairs_match_jax(case):
    kinds, nb, npr, lb, lp, null_frac, pool, widths = _BOUNDS_CASES[case]
    rng = np.random.default_rng(list(_BOUNDS_CASES).index(case))
    bspecs, pspecs = [], []
    for kind in kinds:
        bw, pw = widths if kind == "string" else (0, 0)
        bspecs.append(_key(rng, kind, nb, bw, null_frac, pool))
        pspecs.append(_key(rng, kind, npr, pw, null_frac, pool))
    pb, jb = _cols(bspecs)
    pp, jp = _cols(pspecs)
    blive, plive = np.arange(nb) < lb, np.arange(npr) < lp

    # JAX: the exec pads string keys to the common width before join_bounds
    for i, (b, p) in enumerate(zip(jb, jp)):
        w = max(b.data.shape[1], p.data.shape[1]) if b.lengths is not None else 0
        jb[i], jp[i] = jjoin.pad_string_column(b, w), jjoin.pad_string_column(p, w)
    jorder, jlower, jupper = jjoin.join_bounds(jb, jnp.asarray(blive), jp, jnp.asarray(plive))
    porder, plower, pupper = pjoin.join_bounds(
        pb, torch.from_numpy(blive), pp, torch.from_numpy(plive)
    )
    np.testing.assert_array_equal(porder.numpy(), np.asarray(jorder))
    np.testing.assert_array_equal(plower.numpy(), np.asarray(jlower))
    np.testing.assert_array_equal(pupper.numpy(), np.asarray(jupper))
    # the key words themselves, un-flipped, are the JAX package's
    pb_pad, _ = pjoin._common_widths(pb, pp)
    pw, pnull = pjoin._key_words(pb_pad, torch.from_numpy(blive), 0)
    jw, jnull = jjoin._key_words(jb, jnp.asarray(blive), 0)
    assert len(pw) == len(jw)
    for a, b in zip(pw, jw):
        np.testing.assert_array_equal(psk.to_uint64(a), np.asarray(b))
    np.testing.assert_array_equal(pnull.numpy(), np.asarray(jnull))

    counts = np.asarray(jupper) - np.asarray(jlower)
    total = int(counts.sum())
    out_cap = bucket_capacity(max(total, 1))
    got = pjoin.gather_pairs(porder, plower, pupper - plower, torch.from_numpy(plive), out_cap)
    want = jjoin.gather_pairs(jorder, jlower, jnp.asarray(counts), jnp.asarray(plive), out_cap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert int(got[3]) == total
    if case in ("int", "string_8_130", "multi_key", "long_duplicates", "long_extremes"):
        assert total > 0, "the case should produce matches"


@pytest.mark.parametrize("jt", JOIN_TYPES)
def test_join_output_schema_matches_jax(jt):
    lf = [PT.StructField("a", PT.LONG, False), PT.StructField("s", PT.STRING, True)]
    rf = [PT.StructField("a", PT.LONG, False), PT.StructField("b", PT.DOUBLE, False)]
    jlf = [JT.StructField("a", JT.LONG, False), JT.StructField("s", JT.STRING, True)]
    jrf = [JT.StructField("a", JT.LONG, False), JT.StructField("b", JT.DOUBLE, False)]
    for drop in (None, ["a"]):
        got = pjoin.join_output_schema(jt, lf, rf, drop)
        want = jjoin.join_output_schema(jt, jlf, jrf, drop)
        assert [(f.name, f.data_type.simple_string, f.nullable) for f in got] == [
            (f.name, f.data_type.simple_string, f.nullable) for f in want
        ]


def test_murmur3_gives_strings_one_hash_whatever_the_plane_width():
    """A shuffled join hashes each side's string keys from its own plane:
    the same strings in planes of widths 8, 130 and 256 hash alike, so both
    sides send a key to one partition."""
    from spark_rapids_tpu_torch.xp import namespace

    rng = np.random.default_rng(7)
    _, plane, valid, lengths = _key(rng, "string", 200, 8, 0.1, 12)
    xp = namespace("cpu")
    hashes = []
    for width in (8, 130, 256):
        wide = np.zeros((200, width), dtype=np.uint8)
        wide[:, :8] = plane
        cols = [(PT.STRING, torch.from_numpy(wide), torch.from_numpy(valid),
                 torch.from_numpy(lengths))]
        hashes.append(phash.murmur3_rows(xp, cols, 200).numpy())
    np.testing.assert_array_equal(hashes[0], hashes[1])
    np.testing.assert_array_equal(hashes[0], hashes[2])


# ── mirrors of the reference's hash-join suites ────────────────────────────


def _assert_rows_equal(a, b, what):
    a, b = _normalize(a, True), _normalize(b, True)
    assert len(a) == len(b), f"{what}: {len(a)} vs {len(b)} rows"
    for i, (ra, rb) in enumerate(zip(a, b)):
        assert len(ra) == len(rb), f"{what} row {i}: {ra} vs {rb}"
        for j, (x, y) in enumerate(zip(ra, rb)):
            assert _values_equal(x, y, approx_float=True), f"{what} row {i} col {j}: {x!r} vs {y!r}"


def _port(conf=None, enabled=True) -> TorchSession:
    c = {"spark.rapids.sql.enabled": enabled, "spark.rapids.sql.test.enabled": enabled}
    c.update(conf or {})
    return TorchSession(c, device="cpu")


def _two_tables(seed, n_left=300, n_right=200, groups=25, right_groups=None):
    lt = gen_grouped_table([("lv", JT.LONG)], n_left, num_groups=groups, seed=seed)
    rt = gen_grouped_table([("rv", JT.LONG)], n_right, num_groups=right_groups or groups,
                           seed=seed + 1)
    return lt, rt


def _renamed(t: pa.Table, names):
    return t.rename_columns(names)


def _case(name):
    """(build(F, session) -> DataFrame, conf, join node expected in the
    port's plan) of each mirrored case; ``F`` is either package's functions
    module, so one builder drives all engines."""
    lt, rt = _two_tables(40)
    wide_rt = _two_tables(63, right_groups=45)[1]  # some build keys never match
    cases = {}
    for how in JOIN_TYPES:
        for mode, conf, node in (("shuffled", NO_BC, "ShuffledHashJoin"),
                                 ("broadcast", {}, "BroadcastHashJoin")):
            r = wide_rt if mode == "broadcast" else rt
            cases[f"{how}_{mode}"] = (
                lambda F, s, how=how, r=r: s.create_dataframe(lt, num_partitions=3).join(
                    s.create_dataframe(r, num_partitions=2), on=[("k", "k")], how=how),
                conf, node)
    for how in ("inner", "left"):
        cases[f"using_name_{how}"] = (
            lambda F, s, how=how: s.create_dataframe(lt, num_partitions=2).join(
                s.create_dataframe(rt, num_partitions=2).select(
                    F.col("k"), F.col("rv").alias("rv2")), on="k", how=how),
            NO_BC, "ShuffledHashJoin")
    slt = gen_table([("s", JT.STRING), ("a", JT.INT)], 200, seed=42, str_len=4)
    srt = gen_table([("s", JT.STRING), ("b", JT.INT)], 150, seed=43, str_len=4)
    cases["string_key_shuffled"] = (
        lambda F, s: s.create_dataframe(slt, num_partitions=2).join(
            s.create_dataframe(srt, num_partitions=2), on=[("s", "s")], how="inner"),
        NO_BC, "ShuffledHashJoin")
    cases["string_key_broadcast_using"] = (
        lambda F, s: s.create_dataframe(slt, num_partitions=2).join(
            F.broadcast(s.create_dataframe(srt)), on="s", how="left"),
        {}, "BroadcastHashJoin")
    # string keys whose planes differ in width on the two sides (8 and 256
    # bytes): the exchange must send equal strings to one partition, and
    # the matcher must pad them to one width
    short = ["k%d" % i for i in range(12)] + [None, "", "a\x00b", "h\xe9"]
    longs = short + [s + "x" * 150 for s in short if s]
    narrow = pa.table({"s": pa.array([short[i % len(short)] for i in range(60)]),
                       "a": pa.array(np.arange(60, dtype=np.int64))})
    wide = pa.table({"s2": pa.array([longs[(3 * i) % len(longs)] for i in range(50)]),
                     "b": pa.array(np.arange(50, dtype=np.int64))})
    for how in ("inner", "full"):
        cases[f"string_widths_8_256_{how}"] = (
            lambda F, s, how=how: s.create_dataframe(narrow, num_partitions=3).join(
                s.create_dataframe(wide, num_partitions=2), on=[("s", "s2")], how=how),
            dict(NO_BC, **{"spark.sql.shuffle.partitions": 4}), "ShuffledHashJoin")
    mlt = gen_grouped_table([("k2", JT.INT), ("lv", JT.LONG)], 300, num_groups=6, seed=44)
    mrt = gen_grouped_table([("k2", JT.INT), ("rv", JT.LONG)], 200, num_groups=6, seed=45)
    cases["multi_key"] = (
        lambda F, s: s.create_dataframe(mlt, num_partitions=2).join(
            s.create_dataframe(mrt, num_partitions=2), on=[("k", "k"), ("k2", "k2")]),
        NO_BC, "ShuffledHashJoin")
    nlt = pa.table({"k": pa.array([1, None, 2, None]), "a": [10, 20, 30, 40]})
    nrt = pa.table({"k": pa.array([1, None, 3]), "b": [100, 200, 300]})
    for how in ("inner", "left", "full"):
        cases[f"null_keys_{how}"] = (
            lambda F, s, how=how: s.create_dataframe(nlt).join(
                s.create_dataframe(nrt), on=[("k", "k")], how=how),
            NO_BC, "ShuffledHashJoin")
    nan = float("nan")
    flt = pa.table({"k": [1.0, nan, -0.0, 2.0], "a": [1, 2, 3, 4]})
    frt = pa.table({"k": [nan, 0.0, 2.0], "b": [10, 20, 30]})
    cases["float_nan_zero"] = (
        lambda F, s: s.create_dataframe(flt).join(s.create_dataframe(frt), on=[("k", "k")]),
        NO_BC, "ShuffledHashJoin")
    dlt = pa.table({"k": [1, 1, 2], "a": [1, 2, 3]})
    drt = pa.table({"k": [1, 1, 1, 2], "b": [10, 20, 30, 40]})
    cases["duplicate_keys"] = (
        lambda F, s: s.create_dataframe(dlt).join(s.create_dataframe(drt), on=[("k", "k")]),
        NO_BC, "ShuffledHashJoin")
    cases["join_then_aggregate"] = (
        lambda F, s: s.create_dataframe(lt, num_partitions=3)
        .join(s.create_dataframe(rt, num_partitions=3), on=[("k", "k")])
        .group_by("k")
        .agg(F.sum(F.col("lv") + F.col("rv")).alias("s"), F.count("*").alias("c")),
        NO_BC, "ShuffledHashJoin")
    elt = pa.table({"k": pa.array([], type=pa.int64()), "a": pa.array([], type=pa.int64())})
    ert = pa.table({"k": pa.array([1, 2]), "b": [1, 2]})
    for how in ("inner", "left", "right", "full"):
        cases[f"empty_left_{how}"] = (
            lambda F, s, how=how: s.create_dataframe(elt).join(
                s.create_dataframe(ert), on=[("k", "k")], how=how),
            NO_BC, "ShuffledHashJoin")
        cases[f"empty_right_{how}_broadcast"] = (
            lambda F, s, how=how: s.create_dataframe(ert, num_partitions=2).join(
                F.broadcast(s.create_dataframe(elt)), on=[("k", "k")], how=how),
            {}, "BroadcastHashJoin")
    wlt = pa.table({"k32": pa.array(np.asarray([1, 2, 3, 4, 5], dtype=np.int32)),
                    "lv": [10, 20, 30, 40, 50]})
    wrt = pa.table({"k64": pa.array(np.asarray([2, 4, 6], dtype=np.int64)),
                    "rv": [200, 400, 600]})
    cases["mixed_width_int_keys"] = (
        lambda F, s: s.create_dataframe(wlt).join(
            s.create_dataframe(wrt), on=[("k32", "k64")]),
        NO_BC, "ShuffledHashJoin")
    rlt, rrt = lt, _renamed(rt, ["k2", "rv"])
    for how, mode, conf, node in (("inner", "shuffled", NO_BC, "ShuffledHashJoin"),
                                  ("left", "shuffled", NO_BC, "ShuffledHashJoin"),
                                  ("full", "broadcast", {}, "BroadcastHashJoin")):
        cases[f"residual_{how}_{mode}"] = (
            lambda F, s, how=how: s.create_dataframe(rlt, num_partitions=2).join(
                s.create_dataframe(rrt, num_partitions=2),
                on=(F.col("k") == F.col("k2")) & (F.col("lv") < F.col("rv")), how=how),
            conf, node)
    for how in ("inner", "right"):
        cases[f"broadcast_left_hint_swaps_{how}"] = (
            lambda F, s, how=how: F.broadcast(s.create_dataframe(rlt, num_partitions=2)).join(
                s.create_dataframe(rrt), on=[("k", "k2")], how=how),
            NO_BC, "BroadcastHashJoin")
    null_build = pa.table({"k": pa.array([None] * 40, type=pa.int32()),
                           "rv": pa.array(list(range(40)), type=pa.int64())})
    for how in ("right", "full"):
        cases[f"all_null_build_keys_{how}"] = (
            lambda F, s, how=how: s.create_dataframe(lt, num_partitions=3).join(
                F.broadcast(s.create_dataframe(null_build)), on=[("k", "k")], how=how),
            {}, "BroadcastHashJoin")
    return cases[name]


_CASE_NAMES = (
    [f"{how}_{mode}" for how in JOIN_TYPES for mode in ("shuffled", "broadcast")]
    + ["using_name_inner", "using_name_left", "string_key_shuffled",
       "string_key_broadcast_using", "string_widths_8_256_inner", "string_widths_8_256_full",
       "multi_key", "null_keys_inner", "null_keys_left", "null_keys_full", "float_nan_zero",
       "duplicate_keys", "join_then_aggregate", "mixed_width_int_keys",
       "residual_inner_shuffled", "residual_left_shuffled", "residual_full_broadcast",
       "broadcast_left_hint_swaps_inner", "broadcast_left_hint_swaps_right",
       "all_null_build_keys_right", "all_null_build_keys_full"]
    + [f"empty_left_{how}" for how in ("inner", "left", "right", "full")]
    + [f"empty_right_{how}_broadcast" for how in ("inner", "left", "right", "full")]
)

# the cases also held against the JAX device engine on JAX-CPU (it compiles
# per kernel, so only a few)
_JAX_DEVICE_CASES = {"inner_shuffled", "full_broadcast", "residual_left_shuffled"}


@pytest.mark.parametrize("name", _CASE_NAMES)
def test_hash_join_matches_jax(name):
    build, conf, node = _case(name)
    dev = _port(conf)
    df = build(PF, dev)
    got = df.collect()
    explain = dev._last_overrides.explain
    bad = [(e.node, e.reasons) for e in explain
           if not e.on_device and not e.node.startswith("CpuScan")]
    assert not bad, f"compute fallbacks: {bad}"
    plan = df.explain()
    assert f"Gpu{node}" in plan, plan
    cpu_rows = build(PF, _port(conf, enabled=False)).collect()
    _assert_rows_equal(got, cpu_rows, f"{name}: device vs the port's CPU engine")
    sessions = [cpu_session(conf)]
    if name in _JAX_DEVICE_CASES:
        sessions.append(tpu_session(conf))
    for s in sessions:
        want = build(JF, s).collect()
        _assert_rows_equal(got, want, f"{name}: port vs JAX")


def test_right_outer_tail_emitted_once_across_stream_partitions():
    """A broadcast right join over 3 stream partitions: every build row
    whose key matches nothing comes out exactly once."""
    lt, _ = _two_tables(63)
    rt = _two_tables(63, right_groups=45)[1]
    dev = _port()
    rows = dev.create_dataframe(lt, num_partitions=3).join(
        dev.create_dataframe(rt, num_partitions=2), on=[("k", "k")], how="right").collect()
    left_keys = set(lt.column("k").to_pylist())
    unmatched = [r for r in rows if r[0] is None and r[1] is None]
    want = [r for r in rt.to_pylist() if r["k"] is None or r["k"] not in left_keys]
    assert len(unmatched) == len(want) > 0
    nulls_last = lambda v: (v is None, v or 0)  # noqa: E731
    assert sorted((r[3] for r in unmatched), key=nulls_last) == sorted(
        (r["rv"] for r in want), key=nulls_last)


def test_join_plans_pick_broadcast_or_shuffled():
    lt, rt = _two_tables(52)
    s = _port()
    plan = s.create_dataframe(lt).join(s.create_dataframe(rt), on=[("k", "k")]).explain()
    assert "GpuBroadcastHashJoin" in plan and "GpuBroadcastExchange" in plan
    s2 = _port(NO_BC)
    plan2 = s2.create_dataframe(lt).join(s2.create_dataframe(rt), on=[("k", "k")]).explain()
    assert "BroadcastHashJoin" not in plan2 and "GpuShuffledHashJoin" in plan2


def test_join_falls_back_per_node_with_its_rows():
    """With the device join switched off the join runs on the CPU engine
    between device inputs, says why, and gives the same rows."""
    lt, rt = _two_tables(57)
    for key, conf in (("ShuffledHashJoinExec", NO_BC), ("BroadcastHashJoinExec", {})):
        s = TorchSession({"spark.rapids.sql.enabled": True,
                          f"spark.rapids.sql.exec.{key}": False, **conf}, device="cpu")
        rows = s.create_dataframe(lt, num_partitions=2).join(
            s.create_dataframe(rt), on=[("k", "k")], how="full").collect()
        reasons = [r for e in s._last_overrides.explain for r in e.reasons]
        assert f"disabled by spark.rapids.sql.exec.{key}" in reasons
        want = cpu_session(conf).create_dataframe(lt, num_partitions=2).join(
            cpu_session(conf).create_dataframe(rt), on=[("k", "k")], how="full").collect()
        _assert_rows_equal(rows, want, f"{key} off vs the JAX CPU engine")


@pytest.mark.parametrize("how", ["cross", "inner", "left", "full", "semi", "anti"])
def test_nested_loop_and_cartesian_stay_on_the_cpu_engine(how):
    """Cross joins and non-equi conditions plan a cartesian product or a
    nested-loop join. (The name is from the slices that kept them on the
    CPU engine.) Both now run on the device in strict mode, and give the
    JAX CPU engine's rows."""
    lt = gen_table([("a", JT.INT)], 40, seed=56)
    rt = gen_table([("b", JT.INT)], 30, seed=57)

    def build(F, s):
        left = s.create_dataframe(lt, num_partitions=2)
        if how == "cross":
            return left.cross_join(s.create_dataframe(rt))
        return left.join(s.create_dataframe(rt), on=F.col("a") < F.col("b"), how=how)

    dev = _port()
    got = build(PF, dev).collect()
    node = "CpuCartesianProductExec" if how in ("cross", "inner") else "CpuNestedLoopJoinExec"
    assert any(e.node.startswith(node.replace("Exec", "")) and e.on_device
               for e in dev._last_overrides.explain), dev._last_overrides.explain
    _assert_rows_equal(got, build(JF, cpu_session()).collect(), f"{how}: port vs JAX")
    assert got


@pytest.mark.parametrize("how", ["inner", "left", "right", "full"])
def test_hash_join_output_cut_to_the_batch_size(how):
    """A many-to-many key (each key 30 × 20 rows) under a batch-size target
    of a few hundred output rows: each probe batch's pairs come out in
    several batches of whole probe rows, and the rows equal the JAX CPU
    engine's, shuffled and broadcast."""
    lt, rt = _two_tables(60, n_left=300, n_right=200, groups=10)
    for conf in (NO_BC, {}):
        small = {**conf, "spark.rapids.sql.batchSizeBytes": 8192}

        def build(F, s):
            return s.create_dataframe(lt, num_partitions=2).join(
                s.create_dataframe(rt), on=[("k", "k")], how=how)

        dev = _port(small)
        got = build(PF, dev).collect()
        assert dev._last_metrics["joinProbeSyncs"] > 2, dev._last_metrics
        _assert_rows_equal(got, build(JF, cpu_session(conf)).collect(), f"{how} {conf}")


def _nlj_check(build, node: str):
    """``build(F, session)`` through the port's device engine (strict mode,
    ``node`` on the device) and CPU engine, held to the JAX CPU engine."""
    want = build(JF, cpu_session()).collect()
    dev = _port()
    got = build(PF, dev).collect()
    assert any(e.node.startswith(node) and e.on_device for e in dev._last_overrides.explain)
    _assert_rows_equal(got, want, "port device engine vs JAX")
    _assert_rows_equal(build(PF, _port(enabled=False)).collect(), want, "port CPU engine vs JAX")
    return got


def _cartesian_tables():
    rng = np.random.default_rng(5)
    lt = pa.table({"a": rng.integers(0, 10, 40), "x": rng.standard_normal(40)})
    rt = pa.table({"b": rng.integers(0, 10, 30), "y": rng.standard_normal(30)})
    return lt, rt


def test_cross_join_pairwise():
    """``tests/test_cartesian.py``: 3 × 2 partitions, one task per pair."""
    lt, rt = _cartesian_tables()
    rows = _nlj_check(
        lambda F, s: s.create_dataframe(lt, num_partitions=3).cross_join(
            s.create_dataframe(rt, num_partitions=2)),
        "CpuCartesianProduct",
    )
    assert len(rows) == 40 * 30


def test_conditional_non_equi_join_uses_cartesian():
    lt, rt = _cartesian_tables()
    rows = _nlj_check(
        lambda F, s: s.create_dataframe(lt, num_partitions=2).join(
            s.create_dataframe(rt, num_partitions=2), on=F.col("a") < F.col("b"), how="inner"),
        "CpuCartesianProduct",
    )
    want = sum(1 for a in lt.column("a").to_pylist() for b in rt.column("b").to_pylist() if a < b)
    assert len(rows) == want


def test_cross_join_empty_side():
    lt = pa.table({"a": pa.array([], type=pa.int64())})
    rt = pa.table({"b": [1, 2, 3]})
    assert _nlj_check(
        lambda F, s: s.create_dataframe(lt).cross_join(s.create_dataframe(rt)),
        "CpuCartesianProduct",
    ) == []


def test_broadcast_cross_join():
    """``tests/test_broadcast_joins.py::test_cross_join``."""
    lt = gen_table([("a", JT.INT)], 40, seed=54)
    rt = gen_table([("b", JT.INT)], 30, seed=55)
    _nlj_check(
        lambda F, s: s.create_dataframe(lt, num_partitions=2).cross_join(s.create_dataframe(rt)),
        "CpuCartesianProduct",
    )


@pytest.mark.parametrize("how", ["inner", "left", "right", "full", "semi", "anti"])
def test_non_equi_join(how):
    """``tests/test_broadcast_joins.py::test_non_equi_join``: the outer,
    semi and anti shapes take the nested-loop join, inner the cartesian."""
    lt = gen_table([("a", JT.INT)], 60, seed=56)
    rt = gen_table([("b", JT.INT)], 45, seed=57)
    _nlj_check(
        lambda F, s: s.create_dataframe(lt, num_partitions=2).join(
            s.create_dataframe(rt), on=F.col("a") < F.col("b"), how=how),
        "CpuCartesianProduct" if how == "inner" else "CpuNestedLoopJoin",
    )


@pytest.mark.parametrize("how", ["left", "full", "semi", "anti"])
def test_nested_loop_join_chunks_the_stream(how, monkeypatch):
    """A pair space over ``MAX_PAIR_CAP`` splits the stream side into chunks
    over its capacity (the last chunk past the live rows): the rows and the
    matched flags stay those of one pass."""
    from spark_rapids_tpu_torch.exec import gpu_join as GJ

    monkeypatch.setattr(GJ.GpuBroadcastNestedLoopJoinExec, "MAX_PAIR_CAP", 256)
    lt = gen_table([("a", JT.INT)], 150, seed=58)
    rt = gen_table([("b", JT.INT)], 70, seed=59)
    _nlj_check(
        lambda F, s: s.create_dataframe(lt).join(
            s.create_dataframe(rt), on=F.col("a") < F.col("b") - 3, how=how),
        "CpuNestedLoopJoin",
    )


def test_with_column_and_rename():
    t = pa.table({"a": pa.array([1, 2, 3], type=pa.int64()), "b": [1.5, 2.5, 3.5]})

    def build(F, s):
        return (s.create_dataframe(t)
                .with_column("c", F.col("a") * 2)
                .with_column("a", F.col("a") + 1)
                .with_column_renamed("b", "bb")
                .with_column_renamed("zz", "never"))

    dev = _port()
    df = build(PF, dev)
    assert df.columns == ["a", "bb", "c"]
    _assert_rows_equal(df.collect(), build(JF, cpu_session()).collect(), "with_column")


def test_year_in_and_divide_on_the_device():
    """The expressions the join queries add to the device: ``Year`` over
    dates before and after 1970 (floor division on negative days), ``In``
    over strings and longs (a null item makes a miss null), and double
    ``Divide`` (null on a zero divisor)."""
    import datetime as dt

    days = [-719162, -25567, -1, 0, 59, 365, 10957, 2932896]
    t = pa.table({
        "d": pa.array([dt.date(1970, 1, 1) + dt.timedelta(days=x) for x in days]),
        "s": pa.array(["MAIL", "SHIP", None, "AIR", "", "MAIL\x00", "RAIL", "SHIP"]),
        "x": pa.array([1.5, -2.0, 0.0, None, 7.0, float("nan"), 3.0, -0.0]),
        "y": pa.array([0.0, 2.0, -0.0, 1.0, None, 2.0, float("inf"), 4.0]),
        "k": pa.array([1, 2, 3, None, 5, 6, 7, 8], type=pa.int64()),
    })

    def build(F, s):
        return s.create_dataframe(t).select(
            F.year(F.col("d")).alias("yr"),
            F.col("s").isin("MAIL", "SHIP").alias("in_s"),
            F.col("k").isin(2, 5, None).alias("in_k"),
            (F.col("x") / F.col("y")).alias("q"),
            (F.col("x") / 7.0).alias("q7"),
        )

    dev = _port()
    got = build(PF, dev).collect()
    assert not [e for e in dev._last_overrides.explain
                if not e.on_device and not e.node.startswith("CpuScan")]
    assert [r[0] for r in got] == [1, 1900, 1969, 1970, 1970, 1971, 2000, 9999]
    _assert_rows_equal(got, build(PF, _port(enabled=False)).collect(), "device vs CPU engine")
    _assert_rows_equal(got, build(JF, cpu_session()).collect(), "port vs JAX CPU engine")


def test_aggregate_packs_its_held_input_past_the_batch_size():
    """A complete aggregate over a join whose filtered output comes in many
    batches (a small batch-size target cuts the join's pairs): the held
    batches are filtered and packed as they pass the target, and the rows
    equal the JAX CPU engine's."""
    lt, rt = _two_tables(61, n_left=300, n_right=200, groups=10)

    def build(F, s):
        j = s.create_dataframe(lt).join(s.create_dataframe(rt), on=[("k", "k")], how="inner")
        return j.filter(F.col("lv") < F.col("rv")).group_by("k").agg(
            F.sum(F.col("lv")).alias("s"), F.count(F.col("rv")).alias("c"))

    dev = _port({"spark.rapids.sql.batchSizeBytes": 8192})
    got = build(PF, dev).collect()
    _assert_rows_equal(got, build(JF, cpu_session()).collect(), "packed aggregate input")
