"""Device-resident columnar data — the ``GpuColumnVector``/``ColumnarBatch``
layer, in torch.

The port of ``spark_rapids_tpu/columnar/device.py``, with the same layout so
the two packages can be held against each other plane by plane:

* fixed-width types: ``data``: ``dtype[capacity]``, ``validity``: ``bool[capacity]``
* strings: ``data``: ``uint8[capacity, width]`` (padded bytes, zero past the
  length), ``lengths``: ``int32[capacity]`` (0 for null), ``validity`` —
  ``width`` is a power of two (``bucket_width``)

Rows ``[0, num_rows)`` are live; padding rows have ``validity == False`` and
zeroed data. ``num_rows`` is an int32 scalar tensor on the batch's device,
as in the JAX package, so a chain of device operators needs no host sync
until a boundary asks for the count.

What differs: eager torch compiles nothing per shape, so capacities round up
to a power of two without the JAX package's shape-bucket floor, and the
string plane is built on the device from the host's Arrow offsets and bytes
(one gather) rather than padded on the host.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..types import DataType, DecimalType, NullType, Schema, StringType, is_complex
from .host import HostBatch, HostColumn, empty_host_batch

MIN_CAPACITY = 8
MIN_STR_WIDTH = 8

# rows per chunk when building a string plane: bounds the int64 gather index
# to about 512 MiB whatever the table size
_PLANE_CHUNK_ELEMS = 1 << 26


def bucket_capacity(n: int) -> int:
    """Round a row count up to the next power of two >= MIN_CAPACITY."""
    cap = MIN_CAPACITY
    while cap < n:
        cap <<= 1
    return cap


def bucket_width(n: int) -> int:
    w = MIN_STR_WIDTH
    while w < n:
        w <<= 1
    return w


def pad_scalar_bytes(raw: bytes) -> tuple[np.ndarray, int]:
    """Encode one byte string into the padded scalar-string device layout:
    (uint8[bucket_width], true length). Shared by string literals and the
    TaskVals file-name channel."""
    w = bucket_width(max(len(raw), 1))
    buf = np.zeros(w, dtype=np.uint8)
    buf[: len(raw)] = np.frombuffer(raw, dtype=np.uint8)
    return buf, len(raw)


@dataclasses.dataclass
class DeviceColumn:
    """One column of a device batch (layouts in the module docstring)."""

    dtype: DataType
    data: Optional[torch.Tensor]
    validity: torch.Tensor  # bool[cap]
    lengths: Optional[torch.Tensor] = None  # string: int32[cap]
    children: Optional[tuple] = None  # nested columns: not in the port yet

    @property
    def capacity(self) -> int:
        if self.data is not None:
            return int(self.data.shape[0])
        return int(self.validity.shape[0])

    @property
    def is_string(self) -> bool:
        return isinstance(self.dtype, StringType)

    @property
    def str_width(self) -> int:
        if not self.is_string:
            raise TypeError(f"{self.dtype} column has no string width")
        return int(self.data.shape[1])


def dc_replace(col: DeviceColumn, **kw) -> DeviceColumn:
    """dataclasses.replace for DeviceColumn."""
    return dataclasses.replace(col, **kw)


@dataclasses.dataclass
class DeviceBatch:
    """A batch of columns with a device-resident live-row count."""

    schema: Schema
    columns: list
    num_rows: torch.Tensor  # int32 scalar on the device

    @property
    def capacity(self) -> int:
        if self.columns:
            return self.columns[0].capacity
        return 0

    @property
    def device(self) -> torch.device:
        return self.num_rows.device

    def row_count(self) -> int:
        """Host-sync the live-row count. Use only at operator boundaries."""
        return int(self.num_rows)

    def row_mask(self) -> torch.Tensor:
        """bool[capacity] — True for live rows."""
        return (
            torch.arange(self.capacity, dtype=torch.int32, device=self.device)
            < self.num_rows
        )

    def column(self, i: int) -> DeviceColumn:
        return self.columns[i]

    def size_bytes(self) -> int:
        """Device footprint (for batching goals)."""
        total = 0
        for c in self.columns:
            if c.data is not None:
                total += c.data.numel() * c.data.element_size()
            total += c.validity.numel()
            if c.lengths is not None:
                total += c.lengths.numel() * 4
        return total


def _check_flat(dt: DataType) -> None:
    if is_complex(dt):
        raise NotImplementedError(
            f"{dt.simple_string} columns are not in the torch port yet"
        )


# ── Host <-> device transfer ────────────────────────────────────────────────


def _string_plane(
    offsets: torch.Tensor, values: torch.Tensor, n: int, cap: int, width: int
) -> torch.Tensor:
    """Arrow (offsets, bytes) on the device → zero-padded ``uint8[cap, width]``."""
    device = values.device
    plane = torch.zeros((cap, width), dtype=torch.uint8, device=device)
    if n == 0 or values.numel() == 0:
        return plane
    starts = offsets[:n].to(torch.int64)
    lens = (offsets[1 : n + 1] - offsets[:n]).to(torch.int64)
    cols = torch.arange(width, dtype=torch.int64, device=device)[None, :]
    step = max(1, _PLANE_CHUNK_ELEMS // width)
    last = values.numel() - 1
    for lo in range(0, n, step):
        hi = min(n, lo + step)
        take = cols < lens[lo:hi, None]
        idx = torch.clamp(starts[lo:hi, None] + cols, max=last)
        plane[lo:hi] = torch.where(take, values[idx], 0)
    return plane


def host_to_device(
    hb: HostBatch, device, max_str_bytes: Optional[int] = None
) -> DeviceBatch:
    """HostBatch → DeviceBatch padded to a power-of-two capacity.
    ``max_str_bytes`` (spark.rapids.tpu.string.maxBytes) caps the padded
    string width the fixed-width layout will materialize; longer values
    raise. The upload bills the query's ``h2d`` ledger phase; building the
    padded string planes on the device bills ``pad`` inside it, as the
    JAX package's shape-bucket padding does."""
    from ..obs import ledger as _ledger

    with _ledger.phase("h2d"):
        return _host_to_device(hb, device, max_str_bytes)


def _host_to_device(hb: HostBatch, device, max_str_bytes: Optional[int]) -> DeviceBatch:
    from ..obs import ledger as _ledger

    device = torch.device(device)
    n = hb.num_rows
    cap = bucket_capacity(max(n, 1))
    cols = []
    for f, hc in zip(hb.schema, hb.columns):
        dt = f.data_type
        _check_flat(dt)
        validity = torch.zeros(cap, dtype=torch.bool, device=device)
        validity[:n] = torch.from_numpy(np.ascontiguousarray(hc.validity)).to(device)
        if isinstance(dt, StringType):
            lens_np = np.diff(hc.offsets).astype(np.int32)
            maxlen = int(lens_np.max()) if n else 0
            if max_str_bytes is not None and maxlen > max_str_bytes:
                raise ValueError(
                    f"string length {maxlen} exceeds "
                    f"spark.rapids.tpu.string.maxBytes={max_str_bytes}"
                )
            width = bucket_width(max(maxlen, 1))
            offsets = torch.from_numpy(hc.offsets).to(device)
            values = torch.from_numpy(hc.data).to(device)
            lengths = torch.zeros(cap, dtype=torch.int32, device=device)
            lengths[:n] = torch.from_numpy(lens_np).to(device)
            with _ledger.phase("pad"):
                plane = _string_plane(offsets, values, n, cap, width)
            cols.append(DeviceColumn(dt, plane, validity, lengths))
            continue
        if isinstance(dt, NullType):
            data = torch.zeros(cap, dtype=torch.int8, device=device)
            cols.append(DeviceColumn(dt, data, validity))
            continue
        data_np = np.ascontiguousarray(hc.data, dtype=dt.np_dtype)
        host = torch.from_numpy(data_np)
        data = torch.zeros(cap, dtype=host.dtype, device=device)
        data[:n] = host.to(device)
        cols.append(DeviceColumn(dt, data, validity))
    num_rows = torch.tensor(n, dtype=torch.int32, device=device)
    return DeviceBatch(hb.schema, cols, num_rows)


def device_to_host(batch: DeviceBatch) -> HostBatch:
    """DeviceBatch → HostBatch of its live rows. Strings are packed back to
    Arrow (offsets, bytes) on the device, so only live bytes cross the link."""
    if batch.capacity == 0:
        return empty_host_batch(batch.schema)
    n = batch.row_count()
    cols = []
    for f, c in zip(batch.schema, batch.columns):
        dt = f.data_type
        _check_flat(dt)
        valid = c.validity[:n].cpu().numpy()
        if isinstance(dt, StringType):
            lens = torch.where(c.validity[:n], c.lengths[:n], 0).to(torch.int64)
            width = c.data.shape[1]
            take = (
                torch.arange(width, dtype=torch.int64, device=c.data.device)[None, :]
                < lens[:, None]
            )
            values = c.data[:n][take].cpu().numpy()
            offsets = np.zeros(n + 1, dtype=np.int64)
            np.cumsum(lens.cpu().numpy(), out=offsets[1:])
            cols.append(HostColumn(dt, values, valid, offsets.astype(np.int32)))
            continue
        data = c.data[:n].cpu().numpy()
        if not isinstance(dt, NullType) and not isinstance(dt, DecimalType):
            data = data.astype(dt.np_dtype, copy=False)
        cols.append(HostColumn(dt, data, valid))
    return HostBatch(batch.schema, cols, n)


def _empty_col(dt: DataType, capacity: int, device) -> DeviceColumn:
    _check_flat(dt)
    valid = torch.zeros(capacity, dtype=torch.bool, device=device)
    if isinstance(dt, StringType):
        return DeviceColumn(
            dt,
            torch.zeros((capacity, MIN_STR_WIDTH), dtype=torch.uint8, device=device),
            valid,
            torch.zeros(capacity, dtype=torch.int32, device=device),
        )
    from ..xp import torch_dtype

    return DeviceColumn(
        dt, torch.zeros(capacity, dtype=torch_dtype(dt.np_dtype), device=device), valid
    )


def empty_batch(schema: Schema, device, capacity: int = MIN_CAPACITY) -> DeviceBatch:
    cols = [_empty_col(f.data_type, capacity, device) for f in schema]
    return DeviceBatch(schema, cols, torch.tensor(0, dtype=torch.int32, device=device))


def batch_from_arrays(
    schema: Schema, columns: list, num_rows: int, device="cpu"
) -> DeviceBatch:
    """The port's DeviceBatch from the arrays of a JAX ``DeviceBatch`` taken
    out as numpy: ``columns`` holds one ``(data, validity, lengths)`` triple
    per field (``lengths`` None for fixed-width columns). Tests use it to
    feed both packages the identical device layout."""
    cols = []
    for f, (data, validity, lengths) in zip(schema, columns):
        _check_flat(f.data_type)
        cols.append(
            DeviceColumn(
                f.data_type,
                torch.from_numpy(np.array(data)).to(device),
                torch.from_numpy(np.array(validity, dtype=bool)).to(device),
                None
                if lengths is None
                else torch.from_numpy(np.array(lengths, dtype=np.int32)).to(device),
            )
        )
    return DeviceBatch(
        schema, cols, torch.tensor(int(num_rows), dtype=torch.int32, device=device)
    )
