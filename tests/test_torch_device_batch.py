"""The port's device batch (spark_rapids_tpu_torch/columnar/device.py)
against the JAX package's: the same TPC-H tables uploaded by both give the
same planes, and the port's download returns the host data it started from.

The JAX batch's arrays come out as numpy and enter the port through
``batch_from_arrays``, so both packages hold the identical device layout."""
from __future__ import annotations

import numpy as np
import pytest
import torch

pytest.importorskip("jax")  # the reference; absent on a machine with only the port

import pyarrow as pa  # noqa: E402

from spark_rapids_tpu.columnar.device import host_to_device as jax_host_to_device
from spark_rapids_tpu.ops.gather import compact as jax_compact
from spark_rapids_tpu.tpch.datagen import TABLES
from spark_rapids_tpu.tpch.datagen import gen_table as jax_gen_table
from spark_rapids_tpu_torch.columnar.device import (
    batch_from_arrays,
    device_to_host,
    host_to_device,
)
from spark_rapids_tpu_torch.columnar.host import from_arrow, to_pylist
from spark_rapids_tpu_torch.ops.concat import concat_device
from spark_rapids_tpu_torch.ops.gather import compact
from spark_rapids_tpu_torch.tpch.datagen import gen_table

SF = 0.001


def _jax_arrays(jdb):
    """A JAX DeviceBatch's arrays, as numpy triples per column."""
    return [
        (
            np.asarray(c.data),
            np.asarray(c.validity),
            None if c.lengths is None else np.asarray(c.lengths),
        )
        for c in jdb.columns
    ]


def _bits(t):
    """Compare floats by their bits (NaN, -0.0)."""
    if t.dtype == torch.float64:
        return t.view(torch.int64)
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    return t


def _assert_same_planes(pdb, ref, n):
    """Port batch vs the JAX layout (entered via batch_from_arrays), bit for
    bit. Where the capacities agree the whole planes must; where the JAX
    batch is larger (its shape-bucket floor), the live rows must and the
    port's rows past them are zero and invalid."""
    assert pdb.schema == ref.schema
    assert pdb.row_count() == ref.row_count() == n
    whole = pdb.capacity == ref.capacity
    upto = pdb.capacity if whole else n
    for f, a, b in zip(pdb.schema, pdb.columns, ref.columns):
        assert a.data.dtype == b.data.dtype, f.name
        assert a.data.shape[1:] == b.data.shape[1:], f.name  # string width
        assert torch.equal(_bits(a.data[:upto]), _bits(b.data[:upto])), f.name
        assert torch.equal(a.validity[:upto], b.validity[:upto]), f.name
        if a.lengths is not None:
            assert torch.equal(a.lengths[:upto], b.lengths[:upto]), f.name
        if not whole:
            assert not a.validity[n:].any() and not a.data[n:].any(), f.name
            assert a.lengths is None or not a.lengths[n:].any(), f.name


@pytest.mark.parametrize("name", ["orders", "lineitem"])
def test_upload_matches_jax_planes_and_round_trips(name):
    host = gen_table(name, SF)
    jt = jax_gen_table(name, SF)
    jdb = jax_host_to_device(jt.combine_chunks().to_batches()[0])
    ref = batch_from_arrays(host.schema, _jax_arrays(jdb), int(jdb.num_rows))
    pdb = host_to_device(host, "cpu")
    _assert_same_planes(pdb, ref, host.num_rows)
    for db in (pdb, ref):
        back = device_to_host(db)
        assert back.num_rows == host.num_rows
        for f, a, b in zip(host.schema, host.columns, back.columns):
            assert to_pylist(a) == to_pylist(b), f.name


def test_upload_with_nulls_matches_jax():
    t = pa.table(
        {
            "s": pa.array(["abc", None, "", "hello world", None, "x" * 20]),
            "i": pa.array([1, None, 3, None, 5, 6], type=pa.int32()),
            "d": pa.array([1.5, 2.5, None, float("nan"), -0.0, None]),
            "dt": pa.array([0, 1, None, 3, 4, 5], type=pa.date32()),
            "b": pa.array([True, None, False, True, None, False]),
            "l": pa.array([None, 2**40, -(2**40), 0, 7, None], type=pa.int64()),
        }
    )
    host = from_arrow(t)
    jdb = jax_host_to_device(t.to_batches()[0])
    ref = batch_from_arrays(host.schema, _jax_arrays(jdb), int(jdb.num_rows))
    pdb = host_to_device(host, "cpu")
    _assert_same_planes(pdb, ref, 6)
    back = device_to_host(pdb)
    for i, f in enumerate(host.schema):
        got, want = to_pylist(back.columns[i]), t.column(i).to_pylist()
        assert [repr(x) for x in got] == [repr(x) for x in want], f.name


def test_compact_matches_jax():
    jt = jax_gen_table("orders", SF)
    jdb = jax_host_to_device(jt.combine_chunks().to_batches()[0])
    host = gen_table("orders", SF)
    pdb = host_to_device(host, "cpu")
    keep = np.random.default_rng(7).random(jdb.capacity) < 0.3
    jout = jax_compact(jdb, keep)
    ref = batch_from_arrays(host.schema, _jax_arrays(jout), int(jout.num_rows))
    got = compact(pdb, torch.from_numpy(keep[: pdb.capacity]))
    _assert_same_planes(got, ref, int(jout.num_rows))


def test_concat_device_keeps_live_rows_in_order():
    host = gen_table("orders", SF)
    a = host_to_device(host.slice(0, 700), "cpu")
    b = host_to_device(host.slice(700, host.num_rows - 700), "cpu")
    both = concat_device([a, b])
    assert both.row_count() == host.num_rows
    back = device_to_host(both)
    for f, x, y in zip(host.schema, host.columns, back.columns):
        assert to_pylist(x) == to_pylist(y), f.name


@pytest.mark.parametrize("name", TABLES)
def test_datagen_matches_jax_datagen(name):
    """The port's numpy datagen draws the same values as the JAX package's."""
    jt = jax_gen_table(name, SF)
    host = gen_table(name, SF)
    assert host.schema.names == jt.column_names
    for i, f in enumerate(host.schema):
        assert to_pylist(host.columns[i]) == jt.column(i).to_pylist(), f.name


@pytest.mark.parametrize(
    "case",
    ["scalar", "astype", "pad", "cumsum", "argmax_bool", "take_along", "where_np_scalar", "arange"],
)
def test_torch_namespace_follows_numpy(case):
    """The torch namespace (spark_rapids_tpu_torch/xp.py) gives numpy's
    results for the names the expression library calls on ``Ctx.xp``."""
    from spark_rapids_tpu_torch.xp import namespace

    xp = namespace("cpu")
    a = np.array([[3, 0, 5], [1, 7, 2]], dtype=np.int32)
    t = torch.from_numpy(a.copy())
    if case == "scalar":
        got, want = xp.asarray(np.float64(2.5)), np.asarray(np.float64(2.5))
        assert got.ndim == 0
    elif case == "astype":
        got, want = xp.astype(t, np.float64), a.astype(np.float64)
    elif case == "pad":
        got, want = xp.pad(t, ((0, 1), (2, 0))), np.pad(a, ((0, 1), (2, 0)))
    elif case == "cumsum":
        got, want = xp.cumsum(t, axis=1), np.cumsum(a, axis=1)
    elif case == "argmax_bool":
        got, want = xp.argmax(t > 2, axis=1), np.argmax(a > 2, axis=1)
    elif case == "take_along":
        idx = np.array([[2], [0]])
        got = xp.take_along_axis(t, torch.from_numpy(idx), axis=1)
        want = np.take_along_axis(a, idx, axis=1)
    elif case == "where_np_scalar":
        got, want = xp.where(t > 2, np.int32(1), np.int32(0)), np.where(a > 2, 1, 0)
    else:
        got, want = xp.arange(5, dtype=np.int32), np.arange(5, dtype=np.int32)
    assert np.array_equal(np.asarray(got), want)
