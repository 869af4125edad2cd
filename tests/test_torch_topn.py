"""The port's top-N (``GpuTakeOrderedAndProjectExec``) against the JAX
package, on the CPU.

* ``radix_select_kth`` over flipped int64 words against the JAX
  ``_radix_select_kth`` over the same uint64 words: seeded words with many
  ties, the extreme words (0, 2^63 - 1, 2^63, 2^64 - 1), all-equal words,
  every rank from 1 to n on a short vector.
* ``topn_candidates`` against the JAX exec's ``_candidate_fn`` on the same
  columns (nulls, padding rows, NaN and -0.0, strings), ascending and
  descending, nulls first and last: the candidate masks and counts equal.
* The candidate path, its capacity threshold lowered so a small table
  takes it, against the full-sort path and the JAX device engine (its
  threshold lowered alike), rows in order; and a tie-heavy top-N whose
  rows equal the JAX CPU engine's exactly, tie order included.

Inputs come from numpy seeds and enter both packages as the same arrays."""
from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; absent on a machine with only the port

import jax.numpy as jnp  # noqa: E402
import pyarrow as pa  # noqa: E402

import spark_rapids_tpu.functions as JF  # noqa: E402
import spark_rapids_tpu.types as JT  # noqa: E402
from harness import cpu_session, tpu_session  # noqa: E402
from spark_rapids_tpu.columnar.device import DeviceBatch as JBatch  # noqa: E402
from spark_rapids_tpu.columnar.device import DeviceColumn as JColumn  # noqa: E402
from spark_rapids_tpu.exec import tpu as JT_exec  # noqa: E402
from spark_rapids_tpu.expr.base import BoundReference as JRef  # noqa: E402
from spark_rapids_tpu.plan.logical import SortOrder as JOrder  # noqa: E402
from spark_rapids_tpu.tpch.datagen import gen_table as jax_gen_table  # noqa: E402
from spark_rapids_tpu.types import Schema as JSchema  # noqa: E402
from spark_rapids_tpu.types import StructField as JField  # noqa: E402
from spark_rapids_tpu_torch import TorchSession  # noqa: E402
from spark_rapids_tpu_torch import functions as PF  # noqa: E402
from spark_rapids_tpu_torch import types as PT  # noqa: E402
from spark_rapids_tpu_torch.columnar.device import DeviceBatch, DeviceColumn  # noqa: E402
from spark_rapids_tpu_torch.exec import gpu as G  # noqa: E402
from spark_rapids_tpu_torch.expr.base import BoundReference as PRef  # noqa: E402
from spark_rapids_tpu_torch.ops import sortkeys as psk  # noqa: E402
from spark_rapids_tpu_torch.plan.logical import SortOrder as POrder  # noqa: E402
from spark_rapids_tpu_torch.tpch.datagen import gen_table as port_gen_table  # noqa: E402

# ── the radix select ────────────────────────────────────────────────────────

_EXTREMES = np.array([0, 1, 2**63 - 1, 2**63, 2**64 - 2, 2**64 - 1], dtype=np.uint64)


def _words(case: str) -> np.ndarray:
    rng = np.random.default_rng(70)
    if case == "ties":
        pool = np.concatenate([_EXTREMES, rng.integers(0, 2**64 - 1, 10, dtype=np.uint64)])
        return pool[rng.integers(0, len(pool), 2000)]
    if case == "extremes":
        return np.repeat(_EXTREMES, 5)
    if case == "equal":
        return np.full(300, 2**63 + 5, dtype=np.uint64)
    return rng.integers(0, 2**64 - 1, 1500, dtype=np.uint64, endpoint=True)  # "spread"


def _flipped(u: np.ndarray) -> torch.Tensor:
    return torch.from_numpy((u ^ np.uint64(1 << 63)).view(np.int64))


@pytest.mark.parametrize("case", ["ties", "extremes", "equal", "spread"])
def test_radix_select_matches_jax(case):
    u = _words(case)
    n = len(u)
    ks = sorted({1, 2, 3, n // 3, n // 2, n - 1, n})
    jfn = jax.jit(JT_exec._radix_select_kth)
    ju = jnp.asarray(u)
    for k in ks:
        got = psk.to_uint64(psk.radix_select_kth(_flipped(u), k))
        want = np.asarray(jfn(ju, k))
        assert got == want == np.sort(u)[k - 1], (case, k, got, want)


def test_radix_select_every_rank():
    u = _words("ties")[:40]
    jfn = jax.jit(JT_exec._radix_select_kth)
    for k in range(1, len(u) + 1):
        got = psk.to_uint64(psk.radix_select_kth(_flipped(u), k))
        assert got == np.asarray(jfn(jnp.asarray(u), k)) == np.sort(u)[k - 1], k


# ── the candidate prefilter ─────────────────────────────────────────────────

N, CAP = 300, 512


def _column(tname: str, seed: int):
    """(port DeviceColumn, JAX DeviceColumn) of ``N`` live rows with nulls
    and ties in a capacity of ``CAP`` (padding rows zeroed, invalid)."""
    rng = np.random.default_rng(seed)
    valid = np.zeros(CAP, dtype=bool)
    valid[:N] = rng.random(N) >= 0.2
    lengths = None
    if tname == "STRING":
        pool = [b"", b"a", b"ab", "é".encode(), b"zz", b"abcdefghij", b"abcdefghik", b"\xff"]
        data = np.zeros((CAP, 16), dtype=np.uint8)
        lengths = np.zeros(CAP, dtype=np.int32)
        for i in range(N):
            b = pool[rng.integers(0, len(pool))]
            data[i, : len(b)] = np.frombuffer(b, dtype=np.uint8)
            lengths[i] = len(b)
        lengths = np.where(valid, lengths, 0).astype(np.int32)
        data = np.where(valid[:, None], data, 0).astype(np.uint8)
    elif tname == "DOUBLE":
        specials = np.array([np.nan, 0.0, -0.0, np.inf, -np.inf, 1.5, -1.5])
        data = np.where(
            rng.random(CAP) < 0.4,
            specials[rng.integers(0, len(specials), CAP)],
            np.round(rng.standard_normal(CAP) * 10),
        )
    else:
        dt = {"INT": np.int32, "LONG": np.int64}[tname]
        info = np.iinfo(dt)
        data = rng.integers(-20, 20, CAP).astype(dt)
        data[:4] = [info.min, info.max, 0, -1]
    if tname != "STRING":
        data = np.where(valid, data, np.zeros((), data.dtype))
    pc = DeviceColumn(
        getattr(PT, tname), torch.from_numpy(data.copy()), torch.from_numpy(valid.copy()),
        None if lengths is None else torch.from_numpy(lengths.copy()),
    )
    jc = JColumn(
        getattr(JT, tname), jnp.asarray(data), jnp.asarray(valid),
        None if lengths is None else jnp.asarray(lengths),
    )
    return pc, jc


class _Child:
    """The least a JAX exec needs of its child: an output schema."""

    def __init__(self, schema):
        self.output = schema


@pytest.mark.parametrize("asc,nulls_first", [(True, True), (True, False), (False, False), (False, True)])
@pytest.mark.parametrize("tname", ["INT", "LONG", "DOUBLE", "STRING"])
def test_topn_candidates_match_jax(tname, asc, nulls_first):
    pc, jc = _column(tname, seed=71 + len(tname))
    pbatch = DeviceBatch(PT.Schema([PT.StructField("v", pc.dtype)]), [pc],
                         torch.tensor(N, dtype=torch.int32))
    jschema = JSchema([JField("v", jc.dtype)])
    jbatch = JBatch(jschema, [jc], jnp.asarray(N, jnp.int32))
    k = 7
    porder = POrder(PRef(0, pc.dtype, True), asc, nulls_first)
    mask, cnt = G.topn_candidates(pbatch, porder, k)
    jexec = JT_exec.TpuTakeOrderedAndProjectExec(
        k, [JOrder(JRef(0, jc.dtype, True), asc, nulls_first)], _Child(jschema)
    )
    jmask, jcnt = jexec._candidate_fn()(jbatch)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    assert int(cnt) == int(jcnt) >= k


# ── the exec ────────────────────────────────────────────────────────────────

SF = 0.002


@pytest.fixture(scope="module")
def lineitem():
    return port_gen_table("lineitem", SF), jax_gen_table("lineitem", SF)


def _topn(F, s, table, parts):
    return (
        s.create_dataframe(table, num_partitions=parts)
        .select("l_orderkey", "l_linenumber", "l_extendedprice", "l_shipmode")
        .order_by(F.col("l_extendedprice").desc(), "l_orderkey", "l_linenumber")
        .limit(25)
    )


def _port_rows(table, parts, threshold, monkeypatch):
    monkeypatch.setattr(G, "TOPK_MIN_CAPACITY", threshold)
    s = TorchSession(
        {"spark.rapids.sql.enabled": True, "spark.rapids.sql.test.enabled": True,
         "spark.sql.shuffle.partitions": 2},
        device="cpu",
    )
    df = _topn(PF, s, table, parts)
    rows = df.collect()
    assert "GpuTakeOrderedAndProject n=25" in df.explain()
    return rows, s._last_metrics["topNCandidateHits"]


@pytest.mark.parametrize("parts", [1, 3])
def test_candidate_path_equals_full_sort_and_jax(parts, lineitem, monkeypatch):
    """lineitem's ~12k rows fill a 16,384-row batch on one partition, and
    on three the partials' concatenation does: with the threshold at that
    capacity the candidate path runs (4,096 candidates at most, a quarter
    of it); at 1 << 40 it never does. Both give the JAX device engine's
    rows, in order."""
    port_table, jax_table = lineitem
    cand, hits = _port_rows(port_table, parts, 1 << 14, monkeypatch)
    full, no_hits = _port_rows(port_table, parts, 1 << 40, monkeypatch)
    assert no_hits == 0 and hits >= 1, hits
    assert cand == full and len(cand) == 25
    monkeypatch.setattr(JT_exec.TpuTakeOrderedAndProjectExec, "TOPK_MIN_CAPACITY", 1 << 14)
    want = _topn(JF, tpu_session({"spark.sql.shuffle.partitions": 2}), jax_table, parts).collect()
    assert cand == want


def test_tie_heavy_topn_keeps_row_order(monkeypatch):
    """40,000 rows with three values of the sort key: the 100 first rows
    are all ties, so which rows come back, and in what order, rests on
    every sort being stable and on the candidates keeping row order. The
    rows equal the JAX CPU engine's exactly, on the candidate path and
    off it, from one partition and from three."""
    rng = np.random.default_rng(72)
    n = 40_000
    table = pa.table({
        "k": pa.array(rng.integers(0, 3, n).astype(np.int32)),
        "id": pa.array(np.arange(n, dtype=np.int64)),
        "v": pa.array(np.round(rng.standard_normal(n), 1)),
    })

    def build(F, s, parts):
        return s.create_dataframe(table, num_partitions=parts).order_by(F.col("k").desc()).limit(100)

    for parts in (1, 3):
        want = build(JF, cpu_session(), parts).collect()
        for threshold in (1 << 15, 1 << 40):
            monkeypatch.setattr(G, "TOPK_MIN_CAPACITY", threshold)
            s = TorchSession({"spark.rapids.sql.enabled": True}, device="cpu")
            got = build(PF, s, parts).collect()
            hits = s._last_metrics["topNCandidateHits"]
            assert (hits > 0) == (threshold == 1 << 15), (parts, threshold, hits)
            assert got == want, (parts, threshold)
