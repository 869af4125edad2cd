"""Complex-type expressions: create/extract/size/contains over
array/struct/map values.

Reference: complexTypeCreator.scala (CreateArray/CreateNamedStruct/CreateMap),
complexTypeExtractors.scala (GetStructField, GetArrayItem, GetMapValue,
ElementAt), collectionOperations.scala (Size, ArrayContains).

Device layout recap (columnar/device.py): an array value is (validity[cap],
lengths[cap], element plane [cap, W(, w)] with its own validity plane) — so
extraction is a per-row gather along the padded axis, creation is a stack,
and containment is a masked any() across the plane. The CPU engine evaluates
the same expressions over python objects (the differential oracle).

Copied from ``spark_rapids_tpu/expr/complex.py``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from ..types import (
    ArrayType,
    BOOLEAN,
    DataType,
    INT,
    MapType,
    StringType,
    StructField,
    StructType,
)
from .base import Ctx, Expression, Literal, Val


def _plane_take(xp, plane, ridx, eidx):
    """plane.data/[validity/lengths] rows indexed per-row at eidx."""
    return plane[ridx, eidx]


def _element_val(ctx: Ctx, plane, eidx, ok):
    """Take element ``eidx`` (int[cap]) of each row from an element plane
    DeviceColumn; ``ok`` masks rows whose index is in range."""
    xp = ctx.xp
    cap = ctx.n
    ridx = xp.arange(cap, dtype=xp.int32)
    W = plane.data.shape[1]
    safe = xp.clip(eidx, 0, W - 1)
    data = plane.data[ridx, safe]
    valid = plane.validity[ridx, safe] & ok
    lengths = None
    if plane.lengths is not None:
        lengths = xp.where(ok, plane.lengths[ridx, safe], 0)
    if data.ndim == 2:  # string elements: zero masked rows
        data = xp.where(ok[:, None], data, 0)
    else:
        data = xp.where(ok, data, xp.zeros_like(data))
    return Val(data, valid, lengths)


@dataclass(frozen=True)
class Size(Expression):
    """size(array|map). Spark legacy default: size(NULL) = -1, non-null."""

    child: Expression

    @property
    def data_type(self) -> DataType:
        return INT

    @property
    def nullable(self) -> bool:
        return False

    def eval(self, ctx: Ctx) -> Val:
        c = self.child.eval(ctx)
        xp = ctx.xp
        if ctx.is_device:
            lengths = xp.astype(ctx.broadcast(c.lengths), xp.int32)
            valid = c.full_valid(ctx)
            return Val(xp.where(valid, lengths, -1), xp.asarray(True))
        out = np.full(ctx.n, -1, dtype=np.int32)
        valid = ctx.broadcast_bool(c.valid)
        data = ctx.broadcast(c.data)
        for i in range(ctx.n):
            if valid[i] and data[i] is not None:
                out[i] = len(data[i])
        return Val(out, np.asarray(True))

    def __str__(self):
        return f"size({self.child})"


@dataclass(frozen=True)
class GetStructField(Expression):
    child: Expression
    ordinal: int

    @property
    def _field(self) -> StructField:
        return self.child.data_type.fields[self.ordinal]

    @property
    def data_type(self) -> DataType:
        return self._field.data_type

    @property
    def nullable(self) -> bool:
        return True

    def eval(self, ctx: Ctx) -> Val:
        c = self.child.eval(ctx)
        if ctx.is_device:
            kid = c.children[self.ordinal]
            valid = kid.validity & c.full_valid(ctx)
            return Val(kid.data, valid, kid.lengths, kid.children)
        data = ctx.broadcast(c.data)
        valid = ctx.broadcast_bool(c.valid)
        name = self._field.name
        is_str = isinstance(self.data_type, StringType)
        out = np.empty(ctx.n, dtype=object)
        ov = np.zeros(ctx.n, dtype=bool)
        for i in range(ctx.n):
            if valid[i] and data[i] is not None:
                v = data[i].get(name)
                if v is not None:
                    out[i] = v
                    ov[i] = True
        if not is_str and not isinstance(
            self.data_type, (ArrayType, MapType, StructType)
        ):
            typed = np.zeros(ctx.n, dtype=self.data_type.np_dtype)
            for i in range(ctx.n):
                if ov[i]:
                    typed[i] = out[i]
            return Val(typed, ov)
        return Val(out, ov)

    def __str__(self):
        return f"{self.child}.{self._field.name}"


@dataclass(frozen=True)
class GetArrayItem(Expression):
    """array[i] — 0-based; null when out of range / null array."""

    child: Expression
    index: Expression

    @property
    def data_type(self) -> DataType:
        return self.child.data_type.element_type

    def eval(self, ctx: Ctx) -> Val:
        arr = self.child.eval(ctx)
        idx = self.index.eval(ctx)
        xp = ctx.xp
        if ctx.is_device:
            eidx = xp.astype(ctx.broadcast(idx.data), xp.int32)
            lengths = ctx.broadcast(arr.lengths)
            ok = (
                arr.full_valid(ctx)
                & idx.full_valid(ctx)
                & (eidx >= 0)
                & (eidx < lengths)
            )
            return _element_val(ctx, arr.children[0], eidx, ok)
        return _cpu_array_index(ctx, arr, idx, self.data_type, base=0)

    def __str__(self):
        return f"{self.child}[{self.index}]"


@dataclass(frozen=True)
class ElementAt(Expression):
    """element_at(array, i) — 1-based, negative indexes from the end, null
    when |i| > size; element_at(map, key) — value or null."""

    child: Expression
    key: Expression

    @property
    def data_type(self) -> DataType:
        ct = self.child.data_type
        if isinstance(ct, MapType):
            return ct.value_type
        return ct.element_type

    def eval(self, ctx: Ctx) -> Val:
        ct = self.child.data_type
        if isinstance(ct, MapType):
            return GetMapValue(self.child, self.key).eval(ctx)
        arr = self.child.eval(ctx)
        idx = self.key.eval(ctx)
        xp = ctx.xp
        if ctx.is_device:
            k = xp.astype(ctx.broadcast(idx.data), xp.int32)
            lengths = xp.astype(ctx.broadcast(arr.lengths), xp.int32)
            eidx = xp.where(k > 0, k - 1, lengths + k)
            ok = (
                arr.full_valid(ctx)
                & idx.full_valid(ctx)
                & (k != 0)
                & (eidx >= 0)
                & (eidx < lengths)
            )
            return _element_val(ctx, arr.children[0], eidx, ok)
        return _cpu_array_index(ctx, arr, idx, self.data_type, base=1)

    def __str__(self):
        return f"element_at({self.child}, {self.key})"


def _cpu_array_index(ctx: Ctx, arr: Val, idx: Val, dt: DataType, base: int) -> Val:
    data = ctx.broadcast(arr.data)
    valid = ctx.broadcast_bool(arr.valid)
    kdata = ctx.broadcast(idx.data)
    kvalid = ctx.broadcast_bool(idx.valid)
    is_obj = isinstance(dt, (StringType, ArrayType, MapType, StructType))
    out = (
        np.empty(ctx.n, dtype=object)
        if is_obj
        else np.zeros(ctx.n, dtype=dt.np_dtype)
    )
    ov = np.zeros(ctx.n, dtype=bool)
    for i in range(ctx.n):
        if not (valid[i] and kvalid[i]) or data[i] is None:
            continue
        lst = data[i]
        k = int(kdata[i])
        if base == 1:
            if k == 0:
                continue
            k = k - 1 if k > 0 else len(lst) + k
        if 0 <= k < len(lst) and lst[k] is not None:
            out[i] = lst[k]
            ov[i] = True
    return Val(out, ov)


@dataclass(frozen=True)
class GetMapValue(Expression):
    child: Expression
    key: Expression

    @property
    def data_type(self) -> DataType:
        return self.child.data_type.value_type

    def eval(self, ctx: Ctx) -> Val:
        m = self.child.eval(ctx)
        k = self.key.eval(ctx)
        xp = ctx.xp
        if ctx.is_device:
            keys, values = m.children
            lengths = ctx.broadcast(m.lengths)
            W = keys.data.shape[1]
            pos_ok = xp.arange(W, dtype=xp.int32)[None, :] < lengths[:, None]
            eq = _plane_eq_scalar(ctx, keys, k) & pos_ok & keys.validity
            found = eq.any(axis=1)
            eidx = xp.astype(xp.argmax(xp.astype(eq, xp.int32), axis=1), xp.int32)
            ok = m.full_valid(ctx) & k.full_valid(ctx) & found
            return _element_val(ctx, values, eidx, ok)
        data = ctx.broadcast(m.data)
        valid = ctx.broadcast_bool(m.valid)
        kdata = ctx.broadcast(k.data)
        kvalid = ctx.broadcast_bool(k.valid)
        dt = self.data_type
        is_obj = isinstance(dt, (StringType, ArrayType, MapType, StructType))
        out = (
            np.empty(ctx.n, dtype=object)
            if is_obj
            else np.zeros(ctx.n, dtype=dt.np_dtype)
        )
        ov = np.zeros(ctx.n, dtype=bool)
        for i in range(ctx.n):
            if not (valid[i] and kvalid[i]) or data[i] is None:
                continue
            for kk, vv in data[i]:
                if kk == kdata[i] and vv is not None:
                    out[i] = vv
                    ov[i] = True
                    break
        return Val(out, ov)

    def __str__(self):
        return f"{self.child}[{self.key}]"


def _plane_eq_scalar(ctx: Ctx, plane, scalar: Val):
    """element plane == scalar value, per slot: bool[cap, W]."""
    xp = ctx.xp
    if plane.data.ndim == 3:  # string elements [cap, W, w]
        sdata = scalar.data
        if sdata.ndim == 1:  # scalar literal [w2]
            sdata = xp.broadcast_to(sdata[None, :], (ctx.n, sdata.shape[0]))
        slen = xp.broadcast_to(xp.asarray(scalar.lengths), (ctx.n,))
        w1, w2 = plane.data.shape[2], sdata.shape[1]
        w = max(w1, w2)
        p = xp.pad(plane.data, ((0, 0), (0, 0), (0, w - w1)))
        s = xp.pad(sdata, ((0, 0), (0, w - w2)))
        bytes_eq = (p == s[:, None, :]).all(axis=2)
        len_eq = plane.lengths == slen[:, None]
        return bytes_eq & len_eq
    sdata = xp.astype(ctx.broadcast(scalar.data), plane.data.dtype)
    return plane.data == sdata[:, None]


@dataclass(frozen=True)
class ArrayContains(Expression):
    """array_contains(arr, v): true if found; null if not found but the
    array has a null element or the array/value is null; else false."""

    child: Expression
    value: Expression

    @property
    def data_type(self) -> DataType:
        return BOOLEAN

    def eval(self, ctx: Ctx) -> Val:
        arr = self.child.eval(ctx)
        v = self.value.eval(ctx)
        xp = ctx.xp
        if ctx.is_device:
            plane = arr.children[0]
            lengths = ctx.broadcast(arr.lengths)
            W = plane.data.shape[1]
            pos_ok = xp.arange(W, dtype=xp.int32)[None, :] < lengths[:, None]
            eq = _plane_eq_scalar(ctx, plane, v) & pos_ok & plane.validity
            found = eq.any(axis=1)
            has_null_el = (pos_ok & ~plane.validity).any(axis=1)
            valid = (
                arr.full_valid(ctx)
                & v.full_valid(ctx)
                & (found | ~has_null_el)
            )
            return Val(found, valid)
        data = ctx.broadcast(arr.data)
        valid = ctx.broadcast_bool(arr.valid)
        vdata = ctx.broadcast(v.data)
        vvalid = ctx.broadcast_bool(v.valid)
        out = np.zeros(ctx.n, dtype=bool)
        ov = np.zeros(ctx.n, dtype=bool)
        for i in range(ctx.n):
            if not (valid[i] and vvalid[i]) or data[i] is None:
                continue
            lst = data[i]
            if any(x is not None and x == vdata[i] for x in lst):
                out[i] = True
                ov[i] = True
            elif any(x is None for x in lst):
                ov[i] = False
            else:
                ov[i] = True
        return Val(out, ov)

    def __str__(self):
        return f"array_contains({self.child}, {self.value})"


@dataclass(frozen=True)
class CreateArray(Expression):
    items: Tuple[Expression, ...]

    @property
    def data_type(self) -> DataType:
        el = next(
            (e.data_type for e in self.items), None
        )
        from ..types import NULL

        return ArrayType(el if el is not None else NULL)

    @property
    def nullable(self) -> bool:
        return False

    def eval(self, ctx: Ctx) -> Val:
        xp = ctx.xp
        k = len(self.items)
        el_dt = self.data_type.element_type
        vals = [e.eval(ctx) for e in self.items]
        if ctx.is_device:
            from ..columnar.device import DeviceColumn
            from ..exec.gpu import val_to_column

            if not vals:  # array(): every row is an empty list
                plane = DeviceColumn(
                    el_dt,
                    xp.zeros((ctx.n, 1), dtype=el_dt.np_dtype),
                    xp.zeros((ctx.n, 1), dtype=bool),
                )
                return Val(
                    None,
                    xp.asarray(True),
                    xp.zeros(ctx.n, dtype=xp.int32),
                    (plane,),
                )
            cols = [val_to_column(ctx, v, el_dt) for v in vals]
            if isinstance(el_dt, StringType):
                w = max(c.data.shape[1] for c in cols)
                data = xp.stack(
                    [xp.pad(c.data, ((0, 0), (0, w - c.data.shape[1]))) for c in cols],
                    axis=1,
                )  # [cap, k, w]
                elen = xp.stack([c.lengths for c in cols], axis=1)
            else:
                data = xp.stack([c.data for c in cols], axis=1)  # [cap, k]
                elen = None
            evalid = xp.stack([c.validity for c in cols], axis=1)
            plane = DeviceColumn(el_dt, data, evalid, elen)
            return Val(
                None,
                xp.asarray(True),
                xp.full(ctx.n, k, dtype=xp.int32),
                (plane,),
            )
        out = np.empty(ctx.n, dtype=object)
        datas = [ctx.broadcast(v.data) for v in vals]
        valids = [ctx.broadcast_bool(v.valid) for v in vals]
        for i in range(ctx.n):
            out[i] = [
                (d[i] if vv[i] else None) for d, vv in zip(datas, valids)
            ]
        return Val(out, np.asarray(True))

    def children(self):
        return list(self.items)

    def __str__(self):
        return f"array({', '.join(map(str, self.items))})"


@dataclass(frozen=True)
class CreateNamedStruct(Expression):
    names: Tuple[str, ...]
    values: Tuple[Expression, ...]

    @property
    def data_type(self) -> DataType:
        return StructType(
            tuple(
                StructField(n, v.data_type, v.nullable)
                for n, v in zip(self.names, self.values)
            )
        )

    @property
    def nullable(self) -> bool:
        return False

    def eval(self, ctx: Ctx) -> Val:
        vals = [e.eval(ctx) for e in self.values]
        if ctx.is_device:
            from ..exec.gpu import val_to_column

            kids = tuple(
                val_to_column(ctx, v, e.data_type)
                for v, e in zip(vals, self.values)
            )
            return Val(None, ctx.xp.asarray(True), None, kids)
        out = np.empty(ctx.n, dtype=object)
        datas = [ctx.broadcast(v.data) for v in vals]
        valids = [ctx.broadcast_bool(v.valid) for v in vals]
        for i in range(ctx.n):
            out[i] = {
                n: (d[i] if vv[i] else None)
                for n, d, vv in zip(self.names, datas, valids)
            }
        return Val(out, np.asarray(True))

    def children(self):
        return list(self.values)

    def __str__(self):
        inner = ", ".join(f"{n}: {v}" for n, v in zip(self.names, self.values))
        return f"named_struct({inner})"


@dataclass(frozen=True)
class UnresolvedExtractValue(Expression):
    """col[key] before the child's type is known (Catalyst's
    UnresolvedExtractValue): resolved by coercion once children are bound."""

    child: Expression
    key: Expression

    @property
    def data_type(self) -> DataType:
        return self.resolve().data_type

    def resolve(self) -> Expression:
        ct = self.child.data_type
        if isinstance(ct, StructType):
            if not isinstance(self.key, Literal) or not isinstance(self.key.value, str):
                raise TypeError("struct field access requires a string literal key")
            return GetStructField(self.child, ct.field_index(self.key.value))
        if isinstance(ct, MapType):
            return GetMapValue(self.child, self.key)
        if isinstance(ct, ArrayType):
            return GetArrayItem(self.child, self.key)
        raise TypeError(f"cannot extract value from {ct}")

    def eval(self, ctx: Ctx) -> Val:
        return self.resolve().eval(ctx)

    def __str__(self):
        return f"{self.child}[{self.key}]"


@dataclass(frozen=True)
class Explode(Expression):
    """Generator marker consumed by the Generate planner node — never
    evaluated as a row expression (GpuGenerateExec analogue)."""

    child: Expression
    position: bool = False  # posexplode

    @property
    def data_type(self) -> DataType:
        ct = self.child.data_type
        if isinstance(ct, MapType):
            return StructType(
                (
                    StructField("key", ct.key_type, False),
                    StructField("value", ct.value_type, True),
                )
            )
        return ct.element_type

    def eval(self, ctx: Ctx) -> Val:  # pragma: no cover - planner rewrites
        raise RuntimeError("explode() must appear at the top level of select()")

    def __str__(self):
        return f"{'pos' if self.position else ''}explode({self.child})"


def contains_generator(e: Expression) -> bool:
    if isinstance(e, Explode):
        return True
    return any(contains_generator(c) for c in e.children())
