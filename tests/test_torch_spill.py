"""The port's spill catalog (``spark_rapids_tpu_torch/mem/spill.py``) held
against the JAX package's: ``tests/test_spill.py``'s nine cases and
``tests/test_memory_debug.py``'s leak report, each run side by side on both
catalogs with the observations compared, plus the port's own accounting
rules (bytes by storage, once per storage; a spill frees only what the
catalog alone holds).

The "device" of the port is the CPU here: the catalog still walks every
buffer through the device, host and disk tiers.
"""
from __future__ import annotations

import logging

import numpy as np
import pytest
import torch

pytest.importorskip("jax")  # the reference; absent on a machine with only the port

import pyarrow as pa  # noqa: E402

from spark_rapids_tpu.columnar import device as JD  # noqa: E402
from spark_rapids_tpu.mem import spill as JS
from spark_rapids_tpu_torch.columnar import device as PD
from spark_rapids_tpu_torch.columnar.host import from_arrow
from spark_rapids_tpu_torch.mem import spill as PS
from spark_rapids_tpu_torch.resilience import retry as PRT

torch.set_num_threads(1)


def _record_batch(n=100, seed=0):
    rng = np.random.default_rng(seed)
    return pa.record_batch(
        {
            "a": pa.array(rng.integers(0, 1000, n).astype(np.int64)),
            "s": pa.array([f"val{i % 17}" for i in range(n)]),
        }
    )


class _Jax:
    """The JAX package's catalog and batches."""

    S = JS

    @staticmethod
    def batch(n=100, seed=0):
        return JD.host_to_device(_record_batch(n, seed))

    @staticmethod
    def rows(db):
        rb = JD.device_to_host(db)
        return [tuple(c[i].as_py() for c in rb.columns) for i in range(rb.num_rows)]


class _Port:
    """The port's catalog and batches, on the CPU."""

    S = PS

    @staticmethod
    def batch(n=100, seed=0):
        return PD.host_to_device(from_arrow(_record_batch(n, seed)), "cpu")

    @staticmethod
    def rows(db):
        hb = PD.device_to_host(db)
        from spark_rapids_tpu_torch.columnar.host import batch_rows

        return batch_rows(hb)


def _both(scenario, *args):
    """Run ``scenario(engine, *args)`` on both catalogs; their observations
    must be equal."""
    want = scenario(_Jax, *args)
    got = scenario(_Port, *args)
    assert got == want
    return got


# ── tests/test_spill.py ─────────────────────────────────────────────────────


def _roundtrip(E):
    cat = E.S.BufferCatalog()
    db = E.batch()
    want = E.rows(db)
    handle = cat.register(db)
    del db  # the catalog alone holds it
    obs = [cat.device_bytes == handle.size_bytes > 0]
    got = handle.get_batch()
    obs.append(E.rows(got) == want)
    del got
    handle.close()
    obs.append(cat.device_bytes == 0 and cat.stats()["buffers"] == 0)
    return obs


def test_register_acquire_roundtrip():
    assert _both(_roundtrip) == [True, True, True]


def _tier_walk(E, tmp):
    cat = E.S.BufferCatalog(spill_dir=str(tmp / E.__name__))
    db = E.batch()
    want = E.rows(db)
    h = cat.register(db)
    del db
    freed = cat.synchronous_spill(h.size_bytes)
    obs = [freed >= h.size_bytes, cat.device_bytes == 0, cat.host_bytes == h.size_bytes]
    cat.host_limit = 0  # force host → disk
    cat.synchronous_spill(0)
    obs += [cat.host_bytes == 0, cat.disk_bytes == h.size_bytes,
            len(list((tmp / E.__name__).iterdir()))]
    got = h.get_batch()  # re-materialize from disk
    obs += [E.rows(got) == want, cat.device_bytes == h.size_bytes, cat.disk_bytes == 0,
            len(list((tmp / E.__name__).iterdir()))]
    del got
    h.close()
    return obs


def test_tier_walk_device_host_disk(tmp_path):
    assert _both(_tier_walk, tmp_path) == [True] * 5 + [1, True, True, True, 0]


def _priority(E):
    cat = E.S.BufferCatalog()
    low = cat.register(E.batch(seed=1), E.S.SpillPriorities.INPUT_FROM_SHUFFLE)
    high = cat.register(E.batch(seed=2), E.S.SpillPriorities.OUTPUT_FOR_SHUFFLE)
    cat.synchronous_spill(1)  # one spill's worth: must pick the low band
    obs = [cat.spill_count, cat._buffers[low.id].tier, cat._buffers[high.id].tier]
    low.close(), high.close()
    return obs


def test_spill_priority_order():
    assert _both(_priority) == [1, PS.StorageTier.HOST, PS.StorageTier.DEVICE]


def _pinned(E):
    cat = E.S.BufferCatalog()
    pinned = cat.register(E.batch(seed=1))
    other = cat.register(E.batch(seed=2))
    pinned.get_batch()  # pins (the batch itself is dropped at once)
    cat.synchronous_spill(cat.device_bytes)
    obs = [cat._buffers[pinned.id].tier, cat._buffers[other.id].tier]
    pinned.unpin()
    cat.synchronous_spill(cat.device_bytes)
    obs.append(cat._buffers[pinned.id].tier)
    pinned.close(), other.close()
    return obs


def test_pinned_buffer_not_spilled():
    T = PS.StorageTier
    assert _both(_pinned) == [T.DEVICE, T.HOST, T.HOST]


def _headroom(E):
    cat = E.S.BufferCatalog()
    h1 = cat.register(E.batch(seed=1))
    cat.device_limit = cat.device_bytes  # pool exactly full
    cat.ensure_headroom(1)  # need 1 more byte → must spill something
    obs = [cat.device_bytes == 0, cat.host_bytes == h1.size_bytes]
    h1.close()
    return obs


def test_ensure_headroom_proactive_spill():
    assert _both(_headroom) == [True, True]


def _oom_retry(E, err):
    cat = E.S.BufferCatalog()
    h = cat.register(E.batch())
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] == 1:
            raise err
        return 42

    obs = [E.S.with_oom_retry(cat, flaky), calls["n"], cat.spill_count]
    h.close()
    return obs


def test_oom_retry_spills_and_retries():
    """The JAX package's wording of an OOM, and torch's own error class."""
    assert _oom_retry(_Jax, RuntimeError("RESOURCE_EXHAUSTED: Out of memory allocating X")) == [42, 2, 1]
    assert _oom_retry(_Port, torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate X")) == [42, 2, 1]
    assert _oom_retry(_Port, RuntimeError("CUDA error: out of memory")) == [42, 2, 1]


def test_oom_retry_reraises_non_oom():
    for E in (_Jax, _Port):
        cat = E.S.BufferCatalog()
        with pytest.raises(ValueError):
            E.S.with_oom_retry(cat, lambda: (_ for _ in ()).throw(ValueError("boom")))


def _sort_data(n=1000):
    rng = np.random.default_rng(7)
    return pa.table(
        {
            "k": pa.array(rng.integers(-500, 500, n).astype(np.int64)),
            "v": pa.array(rng.random(n)),
            "s": pa.array([f"s{int(x)}" for x in rng.integers(0, 50, n)]),
        }
    )


def test_out_of_core_sort_matches_cpu():
    """A tiny threshold forces the spillable-run merge path over many
    batches (tiny batches), with a device budget small enough that runs
    spill; rows equal the JAX CPU engine's and the port's CPU engine's."""
    from harness import cpu_session

    from spark_rapids_tpu_torch import TorchSession

    data = _sort_data()
    conf = {
        "spark.rapids.tpu.sort.outOfCoreThresholdBytes": "1",
        "spark.rapids.sql.batchSizeBytes": "4096",
        "spark.rapids.tpu.memory.deviceLimitBytes": "16384",
    }
    want = cpu_session(conf).create_dataframe(data, num_partitions=5).sort("k", "s").collect()
    got = TorchSession(conf, device="cpu").create_dataframe(data, num_partitions=5).sort("k", "s").collect()
    cpu = TorchSession({**conf, "spark.rapids.sql.enabled": False}, device="cpu")
    assert got == [tuple(r) for r in want]
    assert got == cpu.create_dataframe(data, num_partitions=5).sort("k", "s").collect()


def _per_device(E, other):
    """``synchronous_spill(target, dev)`` spills only the named device's
    buffers (the JAX package's per-device accounting, on one device)."""
    cat = E.S.BufferCatalog()
    h = cat.register(E.batch(64))
    obs = [cat.synchronous_spill(h.size_bytes, other), cat._buffers[h.id].tier]
    obs.append(cat.synchronous_spill(h.size_bytes, torch.device("cpu")) >= h.size_bytes)
    obs.append(cat._buffers[h.id].tier)
    h.close()
    return obs


def test_per_device_accounting_and_headroom():
    T = PS.StorageTier
    assert _per_device(_Port, torch.device("cuda", 0)) == [0, T.DEVICE, True, T.HOST]


# ── the port's accounting: by storage, once per storage ─────────────────────


def test_storage_counted_once_and_held_batches_free_nothing():
    """Two registered batches sharing their columns count each storage once,
    and while either holds them (or anyone outside the catalog does) a spill
    of the other frees nothing, so it is not spilled at all."""
    cat = PS.BufferCatalog()
    shared = _Port.batch(64, seed=1)
    b2 = PD.DeviceBatch(shared.schema, list(shared.columns), shared.num_rows)
    size = sum(PS.storage_bytes(shared).values())
    h1 = cat.register(shared)
    h2 = cat.register(b2)
    assert cat.device_bytes == size  # b2's storages are all shared's
    del shared, b2
    # each buffer's storages are also the other's: nothing to free
    assert cat.synchronous_spill(cat.device_bytes) == 0
    assert cat.stats()["spill_count"] == 0 and cat.device_bytes == size
    h2.close()
    assert cat.device_bytes == size  # h1 still holds every storage
    assert cat.synchronous_spill(cat.device_bytes) == size
    assert cat.device_bytes == 0 and cat.host_bytes == h1.size_bytes
    h1.close()
    assert cat.stats()["buffers"] == 0 and cat.host_bytes == 0


def test_a_batch_held_outside_frees_only_the_rest():
    """A batch whose one column is still held outside the catalog releases
    every other storage when it spills."""
    cat = PS.BufferCatalog()
    db = _Port.batch(64, seed=2)
    keep = db.columns[0].data
    h = cat.register(db)
    del db
    freed = cat.synchronous_spill(h.size_bytes)
    assert 0 < freed == h.size_bytes - keep.untyped_storage().nbytes()
    h.close()


@pytest.mark.parametrize("hold", sorted(PS.REFCOUNT_MODEL))
def test_refcount_model_holds_on_this_interpreter(hold):
    """What a spill frees is read from CPython's and torch's reference
    counts: a batch held outside the catalog (whole, or by a column, a
    tensor or a view) must not count as freed, an unheld one must. Fails
    loudly if this interpreter or torch counts references otherwise."""
    assert PS._refcount_probe(hold) == PS.REFCOUNT_MODEL[hold]
    PS.check_refcount_model()


def test_spilling_an_upload_cache_batch_frees_nothing():
    """The session's upload cache hands the same device tensors to every
    query: registering one of its batches must not count a spill of it as
    freed (the JAX package never registers the cache)."""
    from spark_rapids_tpu_torch import TorchSession

    from spark_rapids_tpu_torch.functions import col

    s = TorchSession({}, device="cpu")
    df = s.create_dataframe(from_arrow(_record_batch(300)))
    df.filter(col("a") > 5).collect()  # fills the upload cache
    (entry,) = s._h2d_cache.values()
    cat = PS.BufferCatalog()
    h = cat.register(entry["parts"][0][0])
    assert cat.synchronous_spill(h.size_bytes) == 0
    assert cat._buffers[h.id].tier == PS.StorageTier.DEVICE
    h.close()


def test_exchange_slices_spill_and_come_back(tmp_path):
    """A partitioned query whose exchange slices are pushed off the device
    (a device budget of 1 byte) through host and disk gives the rows of the
    JAX CPU engine; the tiers were walked."""
    from harness import cpu_session

    from spark_rapids_tpu_torch import TorchSession
    from spark_rapids_tpu_torch.functions import col
    from spark_rapids_tpu_torch.functions import sum as psum
    from spark_rapids_tpu.functions import col as jcol
    from spark_rapids_tpu.functions import sum as jsum
    from spark_rapids_tpu_torch.obs.metrics import GLOBAL

    t = pa.table({"k": (np.arange(2000) % 37).astype(np.int64),
                  "v": np.arange(2000, dtype=np.int64)})
    conf = {
        "spark.sql.shuffle.partitions": 4,
        "spark.rapids.tpu.memory.deviceLimitBytes": "1",
        "spark.rapids.memory.host.spillStorageSize": "1",
        "spark.rapids.memory.spillDir": str(tmp_path),
    }
    GLOBAL.reset("spill.")
    got = (TorchSession(conf, device="cpu").create_dataframe(t, num_partitions=3)
           .group_by("k").agg(psum(col("v")).alias("s")).collect())
    spilled = GLOBAL.view("spill.")
    want = (cpu_session(conf).create_dataframe(t, num_partitions=3)
            .group_by("k").agg(jsum(jcol("v")).alias("s")).collect())
    assert sorted(got) == sorted(tuple(r) for r in want)
    assert spilled["bytesDeviceToHost"] > 0 and spilled["bytesHostToDisk"] > 0
    assert spilled["bytesDiskToHost"] > 0
    assert list(tmp_path.iterdir()) == []  # every spill file read back and removed


# ── tests/test_memory_debug.py ──────────────────────────────────────────────


def _leaks(E):
    cat = E.S.BufferCatalog()
    cat.debug = True
    h1 = cat.register(E.batch(64), E.S.SpillPriorities.WORKING)
    h2 = cat.register(E.batch(64), E.S.SpillPriorities.WORKING)
    leaks = cat.leak_report()
    obs = [len(leaks), all(lk["origin"] for lk in leaks), "test_torch_spill" in leaks[0]["origin"]]
    h1.close()
    obs.append(len(cat.leak_report()))
    h2.close()
    obs.append(cat.leak_report())
    return obs


def test_leak_report_tracks_origin_and_close():
    assert _both(_leaks) == [2, True, True, 1, []]


def _no_origin(E):
    cat = E.S.BufferCatalog()
    h = cat.register(E.batch(64))
    origin = cat.leak_report()[0]["origin"]
    h.close()
    return origin


def test_origin_not_recorded_outside_debug():
    assert _both(_no_origin) is None


def test_clean_query_reports_no_leaks(caplog):
    """An out-of-core sort registers and closes many spillable runs, and a
    partitioned aggregate parks its exchange slices; debug mode must end
    both queries with an empty leak report, as the JAX session does."""
    from spark_rapids_tpu_torch import TorchSession
    from spark_rapids_tpu_torch.functions import col
    from spark_rapids_tpu_torch.functions import sum as psum

    rng = np.random.default_rng(3)
    t = pa.table({"k": rng.integers(0, 100, 2000).astype(np.int64)})
    s = TorchSession({
        "spark.rapids.memory.tpu.debug": True,
        "spark.rapids.tpu.sort.outOfCoreThresholdBytes": "1",
        "spark.rapids.sql.batchSizeBytes": "2048",
        "spark.sql.shuffle.partitions": 3,
    }, device="cpu")
    with caplog.at_level(logging.WARNING, logger="spark_rapids_tpu_torch.session"):
        rows = s.create_dataframe(t, num_partitions=2).sort("k").collect()
        agg = s.create_dataframe(t, num_partitions=2).group_by("k").agg(psum(col("k"))).collect()
    assert len(rows) == 2000 and len(agg) == 100
    assert not [r for r in caplog.records if "LEAK" in r.getMessage()]


def test_leak_is_reported_at_query_end(caplog, monkeypatch):
    """A buffer an operator forgets to close is logged as a leak, with its
    registration site, at the query's end."""
    from spark_rapids_tpu_torch import TorchSession
    from spark_rapids_tpu_torch.exec import gpu as G

    real = G.GpuSortExec.execute

    def leaky_execute(self, ctx):
        ctx.catalog.register(_Port.batch(8))  # never closed
        return real(self, ctx)

    monkeypatch.setattr(G.GpuSortExec, "execute", leaky_execute)
    s = TorchSession({"spark.rapids.memory.tpu.debug": True}, device="cpu")
    t = pa.table({"k": np.arange(50, dtype=np.int64)})
    with caplog.at_level(logging.WARNING, logger="spark_rapids_tpu_torch.session"):
        assert len(s.create_dataframe(t).sort("k").collect()) == 50
    leaks = [r.getMessage() for r in caplog.records if "LEAK" in r.getMessage()]
    assert len(leaks) == 1 and "leaky_execute" in leaks[0]


def test_host_tier_holds_the_exact_tensors():
    """The host copy of a spilled buffer is bit-identical, and the disk
    tier's ``.srtf`` frame gives it back bit for bit (the card's pinned
    copies are checked in tests/test_torch_gpu.py)."""
    cat = PS.BufferCatalog()
    db = _Port.batch(200, seed=5)
    want = [t.clone() for t in PS._tensors(db)]
    h = cat.register(db)
    del db
    cat.synchronous_spill(1)
    cat.host_limit = 0
    cat.synchronous_spill(0)
    assert cat._buffers[h.id].tier == PS.StorageTier.DISK
    got = PS._tensors(h.get_batch())
    assert len(got) == len(want) and all(torch.equal(a, b) for a, b in zip(want, got))
    h.close()
    assert PRT.report()["spill_write_errors"] == 0


@pytest.mark.parametrize("native_on", [True, False], ids=["srtf", "npz"])
def test_disk_tier_frame_format(native_on, tmp_path):
    """The DISK tier writes one contiguous ``.srtf`` frame through the
    native host plane (the JAX spill's format: its own loader unpacks the
    file), and ``.npz`` with the plane disabled; both restore the batch,
    a string column and a nested one included, bit for bit."""
    from spark_rapids_tpu import native as JN
    from spark_rapids_tpu_torch import native as PN
    from spark_rapids_tpu_torch.columnar.host import HostBatch, column_from_pylist
    from spark_rapids_tpu_torch.types import ArrayType, LONG, Schema, StructField

    rb = _record_batch(64, seed=9)
    hb = from_arrow(rb)
    lists = column_from_pylist([[i, None, i * 2] if i % 3 else None for i in range(64)],
                               ArrayType(LONG))
    schema = Schema(list(hb.schema.fields) + [StructField("l", ArrayType(LONG))])
    hb = HostBatch(schema, hb.columns + [lists], 64)
    db = PD.host_to_device(hb, torch.device("cpu"))
    want = [t.clone() for t in PS._tensors(db)]
    PN.set_enabled(native_on)
    try:
        cat = PS.BufferCatalog(spill_dir=str(tmp_path))
        h = cat.register(db)
        del db
        cat.synchronous_spill(1)
        cat.host_limit = 0
        cat.synchronous_spill(0)
        buf = cat._buffers[h.id]
        assert buf.tier == PS.StorageTier.DISK
        assert buf.path.endswith(".srtf" if native_on else ".npz")
        if native_on:
            with open(buf.path, "rb") as f:
                views = JN.frame_unpack(f.read())
            import json

            meta = json.loads(bytes(views[0]))
            assert len(views) == 1 + len(meta["names"]) and "num_rows" in meta["names"]
        got = PS._tensors(h.get_batch())
        assert len(got) == len(want) and all(torch.equal(a, b) for a, b in zip(want, got))
        h.close()
    finally:
        PN.set_enabled(True)
