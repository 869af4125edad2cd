"""Multi-device distributed execution over a single-controller mesh.

The reference scales with one GPU per Spark executor and moves shuffle
partitions over UCX (SURVEY.md §2.7). The mesh keeps the same logical
dataflow — partial aggregate → hash-partition exchange → final aggregate —
with rows data-parallel across the members and the exchange done by
``parallel/mesh.py``. This is the dataflow TPC-H/DS group-bys execute on
several devices.

The port of ``spark_rapids_tpu/parallel/distributed.py``. ``make_mesh``
builds a ``MeshContext``: n members on one given device (the CPU tests use
8 members on ``"cpu"``, the counterpart of the JAX tests' 8 virtual XLA CPU
devices), or the first n visible CUDA devices. Sums and counts are int64
and come from the port's segmented, order-fixed ``group_aggregate``, never
from atomics.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..columnar.device import DeviceBatch, DeviceColumn
from ..ops.aggregate import group_aggregate
from ..types import LONG, Schema, StructField
from .ici import _hash_pids
from .mesh import MeshContext, mesh_exchange


def make_mesh(n_devices: int, device=None) -> MeshContext:
    """n members on ``device``; with ``device=None`` the first n visible
    CUDA devices (fewer raise)."""
    if device is not None:
        return MeshContext([device] * n_devices)
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count < n_devices:
        raise RuntimeError(
            f"a mesh of {n_devices} CUDA devices needs {n_devices} visible; "
            f"{count} are (give a device to place every member on it)"
        )
    return MeshContext([torch.device("cuda", i) for i in range(n_devices)])


def _mini_batch(cols, num_rows) -> DeviceBatch:
    schema = Schema([StructField(f"c{i}", c.dtype, True) for i, c in enumerate(cols)])
    n = torch.as_tensor(num_rows, dtype=torch.int32, device=cols[0].validity.device)
    return DeviceBatch(schema, list(cols), n)


def distributed_group_sum_step(mc: MeshContext) -> Callable:
    """A distributed step: per-member partial group-sum → hash exchange of
    the groups → per-member final merge.

    Inputs (rows split evenly over the members, member i owning rows
    ``[i * cap, (i + 1) * cap)``): keys int[N], key validity bool[N], values
    int[N], value validity bool[N], live rows per member int32[n].

    Outputs, member-major like the JAX function's sharded outputs: keys,
    key validity, sums and counts [n * block] (member i's groups in the
    prefix of its block; a block is at least ``cap`` rows) and the group
    count per member [n], on the first member's device."""
    n = mc.n

    def step(keys, kvalid, vals, vvalid, num_rows):
        cap = keys.shape[0] // n
        partials = []
        for i, dev in enumerate(mc.devices):
            sl = slice(i * cap, (i + 1) * cap)
            nrows = int(num_rows[i])
            kcol = DeviceColumn(LONG, keys[sl].to(dev, torch.int64), kvalid[sl].to(dev))
            vcol = DeviceColumn(LONG, vals[sl].to(dev, torch.int64), vvalid[sl].to(dev))
            ccol = DeviceColumn(LONG, torch.ones(cap, dtype=torch.int64, device=dev),
                                torch.ones(cap, dtype=torch.bool, device=dev))
            gk, (gs, gc), ng = group_aggregate(
                _mini_batch([kcol], nrows), [0], [vcol, ccol], ["sum", "sum"]
            )
            gk = gk[0]
            # a null sum (every value null) is 0 in the merge, as the JAX
            # step zeroes it before the exchange
            gs = DeviceColumn(LONG, torch.where(gs.validity, gs.data, 0), gs.validity)
            partials.append(_mini_batch([gk, gs, gc], ng))
        schema = partials[0].schema
        pids = [_hash_pids(b, [0], n) for b in partials]
        received = mesh_exchange(mc, schema, partials, pids)
        home = mc.devices[0]
        finals = []
        for b in received:
            okeys, (osum, ocnt), ong = group_aggregate(
                b, [0], [b.columns[1], b.columns[2]], ["sum", "sum"]
            )
            finals.append((okeys[0].data, okeys[0].validity, osum.data, ocnt.data, ong))
        # one block size for every member (the largest final capacity)
        block = max(max(f[0].shape[0] for f in finals), cap)

        def fit(t):
            return torch.nn.functional.pad(t, (0, block - t.shape[0])).to(home)

        outs = [torch.cat([fit(f[j]) for f in finals]) for j in range(4)]
        return (*outs, torch.stack([f[4].to(home) for f in finals]))

    return step

