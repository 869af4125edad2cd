"""Device-resident columnar data — the ``GpuColumnVector``/``ColumnarBatch``
layer, in torch.

The port of ``spark_rapids_tpu/columnar/device.py``, with the same layout so
the two packages can be held against each other plane by plane:

* fixed-width types: ``data``: ``dtype[capacity]``, ``validity``: ``bool[capacity]``
* strings: ``data``: ``uint8[capacity, width]`` (padded bytes, zero past the
  length), ``lengths``: ``int32[capacity]`` (0 for null), ``validity`` —
  ``width`` is a power of two (``bucket_width``)
* array<e>: ``data`` None; ``lengths``: ``int32[capacity]`` (list sizes, 0
  for null); ``children`` = (element column,), whose planes carry a second
  padded axis: element data ``[capacity, W(, w)]``, element validity and
  string lengths ``[capacity, W]``; ``W`` is a ``bucket_width`` too
* map<k, v>: like an array, with ``children`` = (keys, values) planes
* struct: ``data`` None; ``children`` = one ``[capacity]`` column per field

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

from ..types import (
    ArrayType,
    DataType,
    DecimalType,
    MapType,
    NullType,
    Schema,
    StringType,
    StructType,
)
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
    lengths: Optional[torch.Tensor] = None  # string/array/map: int32[cap]
    children: Optional[tuple] = None  # array/map planes, struct fields

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


def map_planes(col: DeviceColumn, fn) -> DeviceColumn:
    """``col`` with ``fn`` applied to each of its planes (data, validity,
    lengths), its children's included: a row slice or a row gather of a
    nested column moves every plane along the row axis together."""
    return DeviceColumn(
        col.dtype,
        None if col.data is None else fn(col.data),
        fn(col.validity),
        None if col.lengths is None else fn(col.lengths),
        None if col.children is None else tuple(map_planes(k, fn) for k in col.children),
    )


def column_planes(col: DeviceColumn) -> list:
    """Every plane of ``col``, its children's included, in a fixed order."""
    out = [t for t in (col.data, col.validity, col.lengths) if t is not None]
    for k in col.children or ():
        out.extend(column_planes(k))
    return out


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
        """Device footprint (for batching goals and the spill catalog)."""
        return sum(
            t.numel() * t.element_size() for c in self.columns for t in column_planes(c)
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
    device = torch.device(device)
    n = hb.num_rows
    cap = bucket_capacity(max(n, 1))
    cols = [
        _upload_column(hc, f.data_type, n, cap, device, max_str_bytes)
        for f, hc in zip(hb.schema, hb.columns)
    ]
    num_rows = torch.tensor(n, dtype=torch.int32, device=device)
    return DeviceBatch(hb.schema, cols, num_rows)


def _upload_column(
    hc: HostColumn, dt: DataType, n: int, cap: int, device, max_str_bytes: Optional[int]
) -> DeviceColumn:
    """One host column of ``n`` rows → a device column of ``cap`` rows;
    recursive over array, map and struct nesting."""
    from ..obs import ledger as _ledger

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
        return DeviceColumn(dt, plane, validity, lengths)
    if isinstance(dt, NullType):
        return DeviceColumn(dt, torch.zeros(cap, dtype=torch.int8, device=device), validity)
    if isinstance(dt, StructType):
        kids = tuple(
            _upload_column(k, f.data_type, n, cap, device, max_str_bytes)
            for k, f in zip(hc.children, dt.fields)
        )
        return DeviceColumn(dt, None, validity, None, kids)
    if isinstance(dt, (ArrayType, MapType)):
        lens_np = np.where(hc.validity, np.diff(hc.offsets), 0).astype(np.int32)
        W = bucket_width(max(int(lens_np.max()) if n else 0, 1))
        lengths = torch.zeros(cap, dtype=torch.int32, device=device)
        lengths[:n] = torch.from_numpy(lens_np).to(device)
        starts = torch.zeros(cap, dtype=torch.int64, device=device)
        starts[:n] = torch.from_numpy(hc.offsets[:-1].astype(np.int64)).to(device)
        kid_types = (dt.key_type, dt.value_type) if isinstance(dt, MapType) else (dt.element_type,)
        kids = []
        for k, kdt in zip(hc.children, kid_types):
            m = len(k)
            flat = _upload_column(k, kdt, m, bucket_capacity(max(m, 1)), device, max_str_bytes)
            kids.append(element_plane(flat, starts, lengths, W))
        return DeviceColumn(dt, None, validity, lengths, tuple(kids))
    host = torch.from_numpy(np.ascontiguousarray(hc.data, dtype=dt.np_dtype))
    data = torch.zeros(cap, dtype=host.dtype, device=device)
    data[:n] = host.to(device)
    return DeviceColumn(dt, data, validity)


def element_plane(flat: DeviceColumn, starts, lengths, W: int) -> DeviceColumn:
    """A flat column (the Arrow values of a list, or a collect's kept rows)
    → its padded element plane ``[rows, W(, w)]``: slot ``(i, j)`` holds
    row ``starts[i] + j`` of ``flat`` where ``j < lengths[i]``, zero and
    invalid past the length (the JAX package's ``_np_list_from_arrow``, on
    the device, and the plane gather of its ``_group_collect``)."""
    j = torch.arange(W, dtype=torch.int64, device=starts.device)[None, :]
    mask = j < lengths[:, None].to(torch.int64)
    idx = torch.where(mask, torch.clamp(starts[:, None] + j, max=flat.capacity - 1), 0)
    data = flat.data[idx]
    data = torch.where(mask[:, :, None] if data.ndim == 3 else mask, data, 0)
    lens = None if flat.lengths is None else torch.where(mask, flat.lengths[idx], 0)
    return DeviceColumn(flat.dtype, data, flat.validity[idx] & mask, lens)


def device_to_host(batch: DeviceBatch) -> HostBatch:
    """DeviceBatch → HostBatch of its live rows. Strings are packed back to
    Arrow (offsets, bytes) on the device, so only live bytes cross the link;
    element planes are packed to their live elements the same way."""
    if batch.capacity == 0:
        return empty_host_batch(batch.schema)
    n = batch.row_count()
    cols = [_download_column(c, f.data_type, n) for f, c in zip(batch.schema, batch.columns)]
    return HostBatch(batch.schema, cols, n)


def _download_column(c: DeviceColumn, dt: DataType, n: int) -> HostColumn:
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
        return HostColumn(dt, values, valid, offsets.astype(np.int32))
    if isinstance(dt, StructType):
        kids = tuple(_download_column(k, f.data_type, n) for k, f in zip(c.children, dt.fields))
        return HostColumn(dt, None, valid, None, kids)
    if isinstance(dt, (ArrayType, MapType)):
        lens = torch.where(c.validity[:n], c.lengths[:n], 0).to(torch.int64)
        W = c.children[0].validity.shape[1]
        take = torch.arange(W, dtype=torch.int64, device=lens.device)[None, :] < lens[:, None]
        total = int(lens.sum())
        kid_types = (dt.key_type, dt.value_type) if isinstance(dt, MapType) else (dt.element_type,)
        kids = []
        for plane, kdt in zip(c.children, kid_types):
            flat = DeviceColumn(
                kdt,
                plane.data[:n][take],
                plane.validity[:n][take],
                None if plane.lengths is None else plane.lengths[:n][take],
            )
            kids.append(_download_column(flat, kdt, total))
        offsets = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(lens.cpu().numpy(), out=offsets[1:])
        return HostColumn(dt, None, valid, offsets.astype(np.int32), tuple(kids))
    data = c.data[:n].cpu().numpy()
    if not isinstance(dt, NullType) and not isinstance(dt, DecimalType):
        data = data.astype(dt.np_dtype, copy=False)
    return HostColumn(dt, data, valid)


def _empty_col(dt: DataType, capacity: int, device, plane_w: Optional[int] = None) -> DeviceColumn:
    """An all-null column of ``capacity`` rows (``plane_w``: an element
    plane of that width), as the JAX package's ``_empty_col`` builds it."""
    from ..xp import torch_dtype

    shape = (capacity,) if plane_w is None else (capacity, plane_w)
    valid = torch.zeros(shape, dtype=torch.bool, device=device)
    if isinstance(dt, StringType):
        return DeviceColumn(
            dt,
            torch.zeros(shape + (MIN_STR_WIDTH,), dtype=torch.uint8, device=device),
            valid,
            torch.zeros(shape, dtype=torch.int32, device=device),
        )
    if isinstance(dt, StructType):
        kids = tuple(_empty_col(f.data_type, capacity, device, plane_w) for f in dt.fields)
        return DeviceColumn(dt, None, valid, None, kids)
    if isinstance(dt, (ArrayType, MapType)):
        kid_types = (dt.key_type, dt.value_type) if isinstance(dt, MapType) else (dt.element_type,)
        kids = tuple(_empty_col(k, capacity, device, 1) for k in kid_types)
        return DeviceColumn(dt, None, valid, torch.zeros(shape, dtype=torch.int32, device=device), kids)
    np_dt = np.int8 if isinstance(dt, NullType) else dt.np_dtype
    return DeviceColumn(dt, torch.zeros(shape, dtype=torch_dtype(np_dt), device=device), valid)


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
