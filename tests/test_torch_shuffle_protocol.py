"""The port's shuffle subsystem (``spark_rapids_tpu_torch/shuffle/``), the
mirror of ``tests/test_shuffle_protocol.py``'s 21 cases: the wire metadata,
the codecs (the port's LZ4 frames against ``pa.Codec("lz4")`` both ways;
``zstd`` raises naming itself), bounce buffers, the throttle, heartbeats,
the manager over the in-process and TCP transports, spill of map output,
concurrent fetches, an evicted payload, the failure modes, the ICI cases on
the port's mesh with 8 CPU members (held per member against the JAX
package's ``ici_exchange`` on its 8 virtual CPU devices) and a query with
the shuffle manager held against the JAX CPU engine.
"""
from __future__ import annotations

import threading

import numpy as np
import pytest

pytest.importorskip("jax")  # the reference; absent on a machine with only the port

import pyarrow as pa  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

from harness import _normalize, _values_equal, cpu_session  # noqa: E402

from spark_rapids_tpu_torch.columnar.device import device_to_host, host_to_device  # noqa: E402
from spark_rapids_tpu_torch.columnar.host import batch_rows, from_arrow  # noqa: E402
from spark_rapids_tpu_torch.mem.spill import BufferCatalog  # noqa: E402
from spark_rapids_tpu_torch.shuffle import meta as M  # noqa: E402
from spark_rapids_tpu_torch.shuffle.bounce import (  # noqa: E402
    BounceBufferManager,
    BufferReceiveState,
    BufferSendState,
    windowed_blocks,
)
from spark_rapids_tpu_torch.shuffle.compression import get_codec  # noqa: E402
from spark_rapids_tpu_torch.shuffle.heartbeat import ShuffleHeartbeatManager  # noqa: E402
from spark_rapids_tpu_torch.shuffle.local import InProcessRegistry, InProcessTransport  # noqa: E402
from spark_rapids_tpu_torch.shuffle.manager import (  # noqa: E402
    MapOutputRegistry,
    ShuffleEnv,
    TpuShuffleManager,
)
from spark_rapids_tpu_torch.shuffle.serializer import (  # noqa: E402
    deserialize_host_batch,
    serialize_host_batch,
)
from spark_rapids_tpu_torch.shuffle.transport import InflightThrottle  # noqa: E402


def sample_rb(n=100, seed=0):
    rng = np.random.default_rng(seed)
    return pa.record_batch(
        {
            "a": pa.array(rng.integers(-1000, 1000, n).astype(np.int64)),
            "b": pa.array(rng.random(n)),
            "s": pa.array([f"v{int(i)}" for i in rng.integers(0, 50, n)]),
        }
    )


def _rows(rb: pa.RecordBatch) -> list:
    return [tuple(r.values()) for r in rb.to_pylist()]


def _dev(rb):
    return host_to_device(from_arrow(rb), "cpu")


def _host_rows(db) -> list:
    return batch_rows(device_to_host(db))


# ── wire metadata ──────────────────────────────────────────────────────────


def test_table_meta_roundtrip():
    bm = M.BufferMeta(7, 1234, 5678, M.CODEC_LZ4)
    tm = M.TableMeta(1, 2, 3, 0, 99, bm, b"schemabytes")
    assert M.unpack_metadata_response(M.pack_metadata_response([tm, tm])) == [tm, tm]


def test_metadata_request_roundtrip():
    from spark_rapids_tpu.shuffle import meta as JM

    blocks = [M.BlockId(1, 0, 0, 4), M.BlockId(1, 1, 2, 3)]
    assert M.unpack_metadata_request(M.pack_metadata_request(blocks)) == blocks
    # the wire bytes are the JAX package's
    jblocks = [JM.BlockId(1, 0, 0, 4), JM.BlockId(1, 1, 2, 3)]
    assert M.pack_metadata_request(blocks) == JM.pack_metadata_request(jblocks)


def test_transfer_messages_roundtrip():
    req = M.TransferRequest(0x1000, (5, 9, 11))
    assert M.TransferRequest.unpack(req.pack()) == req
    resp = M.TransferResponse((0, 0, 1))
    assert M.TransferResponse.unpack(resp.pack()) == resp


# ── codecs + serializer ────────────────────────────────────────────────────


@pytest.mark.parametrize("codec", ["none", "copy", "lz4", "zstd"])
def test_codec_roundtrip(codec):
    data = b"hello shuffle world " * 1000
    if codec == "zstd":
        with pytest.raises(NotImplementedError, match="zstd"):
            get_codec(codec)
        return
    c = get_codec(codec)
    comp = c.compress(data)
    assert c.decompress(comp, len(data)) == data
    if codec == "lz4":
        assert len(comp) < len(data)
        # the LZ4 frame format: pyarrow reads the port's frames and the
        # port reads pyarrow's, over compressible, random, empty and
        # multi-block inputs
        pc = pa.Codec("lz4")
        rng = np.random.default_rng(3)
        for d in (data, b"", b"x", rng.integers(0, 256, 70_000).astype(np.uint8).tobytes(),
                  rng.integers(0, 3, 9 << 20).astype(np.uint8).tobytes()):
            assert pc.decompress(c.compress(d), len(d), asbytes=True) == d
            assert c.decompress(pc.compress(d, asbytes=True), len(d)) == d


def test_serializer_roundtrip():
    rb = sample_rb()
    payload, usize, cid = serialize_host_batch(from_arrow(rb), get_codec("lz4"))
    out = deserialize_host_batch(payload, M.BufferMeta(1, len(payload), usize, cid))
    assert batch_rows(out) == _rows(rb)


# ── windowed blocks + bounce buffers ───────────────────────────────────────


def test_windowed_blocks_layout():
    from spark_rapids_tpu.shuffle.bounce import windowed_blocks as jwb

    windows = list(windowed_blocks([10, 3, 8], 8))
    assert sum(r.length for w in windows for r in w) == 21
    assert all(sum(r.length for r in w) <= 8 for w in windows)
    assert windows[0][0].block_index == 0 and windows[0][0].length == 8
    assert [[tuple(vars(r).values()) for r in w] for w in windows] == [
        [tuple(vars(r).values()) for r in w] for w in jwb([10, 3, 8], 8)
    ]


def test_bounce_pool_exhaustion():
    pool = BounceBufferManager(16, 2)
    a = pool.acquire()
    b = pool.acquire()
    with pytest.raises(TimeoutError):
        pool.acquire(timeout=0.05)
    b.close()
    c = pool.acquire(timeout=1.0)
    assert pool.free_count == 0
    a.close()
    c.close()
    assert pool.free_count == 2


def test_send_receive_state_roundtrip():
    payloads = [bytes(range(256)) * 10, b"x" * 5, b"", b"tail" * 100]
    tags = [100, 200, 300, 400]
    pool = BounceBufferManager(64, 2)
    recv = BufferReceiveState({t: len(p) for t, p in zip(tags, payloads) if p})
    done = {}
    for tag, seq, frame in BufferSendState(payloads, tags, pool).frames():
        out = recv.on_frame(tag, seq, frame)
        if out is not None:
            done[tag] = out
    assert done == {100: payloads[0], 200: payloads[1], 400: payloads[3]}
    assert recv.done


# ── throttle and heartbeats ────────────────────────────────────────────────


def test_throttle_blocks_and_orders():
    th = InflightThrottle(100)
    th.acquire(60)
    with pytest.raises(TimeoutError):
        th.acquire(60, timeout=0.05)
    th.release(60)
    th.acquire(60, timeout=1.0)
    th.release(60)
    th.acquire(1000, timeout=1.0)  # oversize request admitted alone
    th.release(1000)
    assert th.inflight == 0


def test_heartbeat_gossip():
    mgr = ShuffleHeartbeatManager()
    assert mgr.register_executor("e0", ("h0", 1)) == []
    assert [p.executor_id for p in mgr.register_executor("e1", ("h1", 2))] == ["e0"]
    # e0 learns about e1 on its next heartbeat, exactly once
    assert [p.executor_id for p in mgr.executor_heartbeat("e0")] == ["e1"]
    assert mgr.executor_heartbeat("e0") == []


def test_heartbeat_registry_isolated_per_instance():
    hb1 = ShuffleHeartbeatManager()
    hb2 = ShuffleHeartbeatManager()
    hb1.register_executor("execA", ("127.0.0.1", 1))
    assert "execA" not in {p.executor_id for p in hb2.register_executor("execB", ("127.0.0.1", 2))}
    assert {p.executor_id for p in hb1.register_executor("execC", ("127.0.0.1", 3))} == {"execA"}


# ── end-to-end: manager over the in-process transport ──────────────────────


def make_env(executor_id, registry, hb, codec="lz4", store=None):
    return ShuffleEnv(executor_id, InProcessTransport(executor_id, registry),
                      store or BufferCatalog(), hb, codec=codec)


def _pair(prefix):
    reg, hb, outputs = InProcessRegistry(), ShuffleHeartbeatManager(), MapOutputRegistry()
    env_a, env_b = make_env(prefix + "A", reg, hb), make_env(prefix + "B", reg, hb)
    return env_a, env_b, TpuShuffleManager(env_a, outputs), TpuShuffleManager(env_b, outputs)


def test_manager_local_and_remote_read():
    env_a, _env_b, mgr_a, mgr_b = _pair("exec")
    rbs = [sample_rb(50, seed=i) for i in range(3)]
    writer = mgr_a.get_writer(shuffle_id=1, map_id=0, num_partitions=3)
    for p, rb in enumerate(rbs):
        writer.write(p, _dev(rb))
    assert all(s > 0 for s in writer.commit().sizes)
    # local read on A (zero-copy catalog hit)
    local = list(mgr_a.get_reader().read_partitions(1, 0, 1))
    assert len(local) == 1 and _host_rows(local[0]) == _rows(rbs[0])
    # remote read on B (metadata + transfer over the transport)
    got = sorted((_host_rows(b) for b in mgr_b.get_reader().read_partitions(1, 1, 3)), key=len)
    assert got == sorted((_rows(r) for r in rbs[1:3]), key=len)
    mgr_a.unregister_shuffle(1)
    assert env_a.catalog.stats()["cached_batches"] == 0


def test_shuffle_output_survives_spill():
    """Map output re-materializes identically after a spill off the device
    tier (the spillable ShuffleBufferCatalog contract)."""
    store = BufferCatalog()
    env = make_env("execS", InProcessRegistry(), ShuffleHeartbeatManager(), store=store)
    mgr = TpuShuffleManager(env, MapOutputRegistry())
    rb = sample_rb(200, seed=7)
    w = mgr.get_writer(2, 0, 1)
    w.write(0, _dev(rb))
    w.commit()
    store.synchronous_spill(1 << 40)
    assert store.device_bytes == 0
    got = list(mgr.get_reader().read_partitions(2, 0, 1))
    assert _host_rows(got[0]) == _rows(rb)


def test_concurrent_fetches_same_peer():
    """Two reduce tasks fetching from one peer at once keep their frames
    apart (tag-multiplexed client)."""
    _env_a, env_b, mgr_a, mgr_b = _pair("cc")
    rbs = [sample_rb(400, seed=i + 40) for i in range(4)]
    w = mgr_a.get_writer(9, 0, 4)
    for p, rb in enumerate(rbs):
        w.write(p, _dev(rb))
    w.commit()
    results, errors = {}, []

    def fetch(part):
        try:
            got = list(mgr_b.get_reader().read_partitions(9, part, part + 1))
            results[part] = _host_rows(got[0])
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=fetch, args=(p,)) for p in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors, errors
    assert [results[p] for p in range(4)] == [_rows(r) for r in rbs]
    assert env_b.throttle.inflight == 0


def test_server_reserializes_evicted_payload():
    env_a, _env_b, mgr_a, mgr_b = _pair("ev")
    rb = sample_rb(100, seed=99)
    w = mgr_a.get_writer(12, 0, 1)
    w.write(0, _dev(rb))
    w.commit()
    env_a.server.pending_limit_bytes = 0  # evict everything immediately
    got = list(mgr_b.get_reader().read_partitions(12, 0, 1))
    assert _host_rows(got[0]) == _rows(rb)
    assert env_a.server.pending_count() == 0


# ── end-to-end: TCP transport ──────────────────────────────────────────────


def test_manager_over_tcp_transport():
    from spark_rapids_tpu_torch.shuffle.tcp import TcpTransport

    hb, outputs = ShuffleHeartbeatManager(), MapOutputRegistry()
    ta, tb = TcpTransport("tcpA"), TcpTransport("tcpB")
    ta.register_address()
    tb.register_address()
    try:
        env_a = ShuffleEnv("tcpA", ta, BufferCatalog(), hb, codec="lz4", address=ta.address)
        env_b = ShuffleEnv("tcpB", tb, BufferCatalog(), hb, codec="lz4", address=tb.address)
        mgr_a, mgr_b = TpuShuffleManager(env_a, outputs), TpuShuffleManager(env_b, outputs)
        rbs = [sample_rb(300, seed=i + 10) for i in range(2)]
        w = mgr_a.get_writer(5, 0, 2)
        for p, rb in enumerate(rbs):
            w.write(p, _dev(rb))
        w.commit()
        got = sorted(_host_rows(b) for b in mgr_b.get_reader().read_partitions(5, 0, 2))
        assert got == sorted(_rows(r) for r in rbs)
    finally:
        ta.shutdown()
        tb.shutdown()


# ── failure modes: timeouts, fetch errors, throttle ────────────────────────


class _DeadConnection:
    """A client connection whose peer never answers (dead executor)."""

    def request(self, req_type, payload):
        from spark_rapids_tpu_torch.shuffle.transport import new_transaction

        return new_transaction()  # never completed

    def set_frame_handler(self, h):
        self.handler = h

    def close(self):
        pass


class _ErrConnection(_DeadConnection):
    def request(self, req_type, payload):
        from spark_rapids_tpu_torch.shuffle.transport import TransactionStatus, new_transaction

        tx = new_transaction()
        tx.complete(TransactionStatus.ERROR, error="connection reset by peer")
        return tx


@pytest.mark.parametrize("conn,match", [(_DeadConnection, "metadata"), (_ErrConnection, "connection reset")])
def test_fetch_failure_surfaces_fetch_error(conn, match):
    """A dead peer's metadata request times out, a failed one propagates:
    both as ShuffleFetchError (the two JAX cases
    ``test_fetch_timeout_surfaces_fetch_error`` and
    ``test_fetch_error_propagates``)."""
    from spark_rapids_tpu_torch.shuffle.catalog import ShuffleReceivedBufferCatalog
    from spark_rapids_tpu_torch.shuffle.client import ShuffleClient, ShuffleFetchError

    client = ShuffleClient(conn(), ShuffleReceivedBufferCatalog(), fetch_timeout_s=0.2)
    with pytest.raises(ShuffleFetchError, match=match):
        list(client.fetch_blocks([M.BlockId(1, 0, 0, 1)]))


def test_transfer_stall_times_out_and_releases_throttle():
    """Metadata succeeds but the data frames never arrive: the fetch raises
    within the timeout AND releases its throttle reservation."""
    from spark_rapids_tpu_torch.shuffle import REQ_METADATA
    from spark_rapids_tpu_torch.shuffle.catalog import ShuffleReceivedBufferCatalog
    from spark_rapids_tpu_torch.shuffle.client import ShuffleClient, ShuffleFetchError
    from spark_rapids_tpu_torch.shuffle.transport import TransactionStatus, new_transaction

    class _MetaOnlyConnection(_DeadConnection):
        def request(self, req_type, payload):
            tx = new_transaction()
            if req_type == REQ_METADATA:
                tm = M.TableMeta(1, 0, 0, 0, 10, M.BufferMeta(11, 4096, 4096, M.CODEC_NONE), b"")
                tx.complete(TransactionStatus.SUCCESS, M.pack_metadata_response([tm]))
            else:
                tx.complete(TransactionStatus.SUCCESS, b"")
            return tx

    throttle = InflightThrottle(1 << 20)
    client = ShuffleClient(_MetaOnlyConnection(), ShuffleReceivedBufferCatalog(),
                           throttle=throttle, fetch_timeout_s=0.3)
    with pytest.raises(ShuffleFetchError):
        list(client.fetch_blocks([M.BlockId(1, 0, 0, 1)]))
    assert throttle.inflight == 0


# ── ICI device plane: the port's mesh with 8 CPU members ───────────────────


def _jax_ici(batches_rb, n, key=0, skew=False):
    """The JAX package's ICI exchange of the same per-chip rows: the rows
    each chip ends with (as sorted lists)."""
    import jax
    from jax.sharding import Mesh

    from spark_rapids_tpu.columnar.device import device_to_host as jd2h
    from spark_rapids_tpu.columnar.device import host_to_device as jh2d
    from spark_rapids_tpu.parallel.ici import ici_exchange

    mesh = Mesh(np.array(jax.devices()[:n]), ("dp",))
    per = max(rb.num_rows for rb in batches_rb)
    jb = [jh2d(rb, capacity=1 << max(per - 1, 1).bit_length()) for rb in batches_rb]
    out = ici_exchange(mesh, jb[0].schema, [key], jb)
    return [sorted(_rows(jd2h(b))) for b in out]


def _port_ici(batches_rb, n, skew=False):
    from spark_rapids_tpu_torch.parallel.distributed import make_mesh
    from spark_rapids_tpu_torch.parallel.ici import build_ici_exchange, ici_exchange

    from spark_rapids_tpu_torch.ops.concat import concat_device

    mc = make_mesh(n, "cpu")
    # the JAX test's capacity: twice the rows per chip
    pb = [concat_device([_dev(rb)], capacity=2 * rb.num_rows) for rb in batches_rb]
    if skew:
        out = ici_exchange(mc, pb[0].schema, [0], pb)
    else:
        out = build_ici_exchange(mc, pb[0].schema, [0])(pb)
    return [sorted(_host_rows(b)) for b in out], mc


def test_ici_all_to_all_exchange():
    import jax

    n = 4
    assert len(jax.devices()) >= n
    rng = np.random.default_rng(3)
    batches = [
        pa.record_batch({"k": pa.array(rng.integers(0, 1000, 32).astype(np.int64)),
                         "v": pa.array(rng.random(32))})
        for _ in range(n)
    ]
    got, mc = _port_ici(batches, n)
    # row set preserved, equal keys on one member, and each member's rows
    # are the JAX chip's (the same murmur3 over the same keys)
    assert sorted(r for c in got for r in c) == sorted(r for b in batches for r in _rows(b))
    key_chip = {}
    for chip, rows in enumerate(got):
        for k, _v in rows:
            assert key_chip.setdefault(k, chip) == chip
    assert got == _jax_ici(batches, n)
    assert mc.stats["exchanges"] == 1
    assert mc.stats["max_received"] == max(len(c) for c in got)


def test_ici_exchange_skew_escalates_capacity():
    """One key owning ~60% of all rows overflows a member's receive
    capacity; ``ici_exchange`` delivers every row, the hot key on one
    member, as the JAX package's escalating exchange does (the port needs
    no escalation round: its shapes are dynamic); the fixed-capacity
    exchange fails loudly instead."""
    n = 8
    rng = np.random.default_rng(11)
    batches = []
    for _ in range(n):
        keys = np.where(rng.random(96) < 0.6, 7, rng.integers(0, 1000, 96))
        batches.append(pa.record_batch({"k": pa.array(keys.astype(np.int64)),
                                        "v": pa.array(rng.random(96))}))
    got, mc = _port_ici(batches, n, skew=True)
    assert sum(len(c) for c in got) == 96 * n
    assert sum(1 for c in got if any(k == 7 for k, _v in c)) == 1
    # the hot member received more rows than an input's capacity (2 x 96)
    assert mc.stats["max_received"] == max(len(c) for c in got) > 2 * 96
    assert got == _jax_ici(batches, n, skew=True)
    with pytest.raises(ValueError, match="ICI exchange overflow"):
        _port_ici(batches, n)


# ── engine integration: exchange through the shuffle manager ───────────────


def test_query_with_shuffle_manager_enabled():
    """The same group-by gives the JAX CPU engine's rows, to the harness
    tolerance, when the exchange routes through the spillable shuffle
    catalog; strict mode: nothing off the device."""
    from spark_rapids_tpu.functions import col as jcol
    from spark_rapids_tpu.functions import sum as jsum
    from spark_rapids_tpu_torch import TorchSession
    from spark_rapids_tpu_torch.functions import col
    from spark_rapids_tpu_torch.functions import sum as sum_

    rng = np.random.default_rng(11)
    table = pa.table({"k": rng.integers(0, 20, 5000).astype(np.int64), "v": rng.random(5000)})
    s = TorchSession({"spark.rapids.shuffle.manager.enabled": True,
                      "spark.sql.shuffle.partitions": 4,
                      "spark.rapids.sql.test.enabled": True}, device="cpu")
    managed = s.create_dataframe(table, num_partitions=4).group_by("k").agg(
        sum_(col("v")).alias("s")).collect()
    expect = cpu_session().create_dataframe(table, num_partitions=4).group_by("k").agg(
        jsum(jcol("v")).alias("s")).collect()
    assert len(managed) == 20
    assert_rows_close(managed, expect)


def test_tpch_q5_through_the_manager_stays_on_device():
    """TPC-H q5 (SF 0.002, 4 input partitions, 8 shuffle partitions, the
    joins shuffled) with every exchange through the shuffle manager, strict:
    nothing off the device, rows equal to the JAX CPU engine's."""
    from spark_rapids_tpu.tpch import gen_table as jgen
    from spark_rapids_tpu.tpch import tpch_query as jq
    from spark_rapids_tpu_torch import TorchSession
    from spark_rapids_tpu_torch.tpch.datagen import gen_table
    from spark_rapids_tpu_torch.tpch.queries import tpch_query

    names = ("customer", "orders", "lineitem", "supplier", "nation", "region")
    conf = {"spark.sql.shuffle.partitions": 8, "spark.sql.autoBroadcastJoinThreshold": -1}
    s = TorchSession({**conf, "spark.rapids.shuffle.manager.enabled": True,
                      "spark.rapids.sql.test.enabled": True}, device="cpu")
    pt = {n: gen_table(n, 0.002) for n in names}
    got = tpch_query(5, lambda n: s.create_dataframe(pt[n], num_partitions=4)).collect()
    jt = {n: jgen(n, 0.002) for n in names}
    js = cpu_session(conf)
    want = jq(5, lambda n: js.create_dataframe(jt[n], num_partitions=4)).collect()
    assert got and all(e.on_device for e in s._last_overrides.explain
                       if not e.node.startswith("CpuScan"))
    assert_rows_close(got, want)


def assert_rows_close(got, want, sort=True):
    """Rows equal to the harness tolerance (floats rel 1e-9, abs 1e-11)."""
    got, want = _normalize(got, sort), _normalize(want, sort)
    assert len(got) == len(want), f"{len(got)} vs {len(want)} rows"
    for i, (a, b) in enumerate(zip(got, want)):
        assert _values_equal(tuple(a), tuple(b), True), f"row {i}: {a} vs {b}"
