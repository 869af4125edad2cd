"""Spark-compatible Murmur3 (x86_32, seed 42) — reference: HashFunctions.scala
and GpuHashPartitioning.scala (on-device murmur3 partition bucketing via
cudf Table.partition).

Spark's ``Murmur3Hash`` folds columns left-to-right: the running hash is the
seed for the next column. Per type (HashExpression in Spark):

* bool → hashInt(1/0); byte/short/int/date → hashInt(x)
* long/timestamp → hashLong(x); decimal(<=18) → hashLong(unscaled)
* float → hashInt(floatToIntBits(x)) with -0f normalized to 0f
* double → hashLong(doubleToLongBits(x)) with -0.0 normalized
* string → hashUnsafeBytes(utf8 bytes): 4-byte little-endian words, then
  remaining tail bytes one at a time (sign-extended)
* NULL → hash unchanged

Copied from ``spark_rapids_tpu/ops/hash.py``. Each function takes the
array module first, as there: ``numpy`` (the CPU engine, in uint32 lanes,
as the JAX package computes it) or the port's torch namespace (``xp.py``),
for torch tensors on the device. Torch has no ``+``, ``*`` or ``<<`` on
uint32, so the torch path holds each 32-bit value in an int64 lane and masks
it to 32 bits after every step. A 32-bit product would reach 2**64, past
int64, so each multiplier constant is split into 16-bit halves and no
product exceeds 2**48; a rotate stays below 2**47. The result is turned into
int32 by the two's-complement rule. As in the JAX package, the numpy path
hands flat columns and ``Pmod`` to the native host plane's C++ murmur3
(``native.py`` over ``native/srt_host.cc``) when that plane is built and
enabled; the numpy code is its reference and its fallback.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..xp import is_torch
from ..types import (
    BooleanType,
    ByteType,
    DataType,
    DateType,
    DecimalType,
    DoubleType,
    FloatType,
    IntegerType,
    LongType,
    ShortType,
    StringType,
    TimestampType,
)

_C1 = np.uint32(0xCC9E2D51)
_C2 = np.uint32(0x1B873593)
_M5 = np.uint32(0xE6546B64)

DEFAULT_SEED = 42


_MASK = 0xFFFFFFFF


def _u32(xp, x):
    return xp.asarray(x).astype(xp.uint32)


# ── torch lanes: int64 tensors holding values in [0, 2**32) ────────────────


def _t_mul(x, c: int):
    """``x * c`` mod 2**32 for a lane ``x`` and a 32-bit constant ``c``, as
    two products below 2**48."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _MASK


def _t_rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _MASK


def _t_mix_k1(k1):
    return _t_mul(_t_rotl(_t_mul(k1, int(_C1)), 15), int(_C2))


def _t_mix_h1(h1, k1):
    h1 = _t_rotl(h1 ^ k1, 13)
    return (h1 * 5 + int(_M5)) & _MASK


def _t_fmix(h1, length):
    h1 = h1 ^ length
    h1 = h1 ^ (h1 >> 16)
    h1 = _t_mul(h1, 0x85EBCA6B)
    h1 = h1 ^ (h1 >> 13)
    h1 = _t_mul(h1, 0xC2B2AE35)
    return h1 ^ (h1 >> 16)


def _t_lanes(seed, like: torch.Tensor):
    """A seed (python int, numpy scalar or lane tensor) as lanes shaped like
    ``like``'s rows."""
    if isinstance(seed, torch.Tensor):
        return seed.to(torch.int64)
    return torch.full(like.shape[:1], int(seed) & _MASK, dtype=torch.int64, device=like.device)


def _rotl(xp, x, r):
    x = x.astype(xp.uint32)
    return ((x << np.uint32(r)) | (x >> np.uint32(32 - r))).astype(xp.uint32)


def _mix_k1(xp, k1):
    k1 = (k1 * _C1).astype(xp.uint32)
    k1 = _rotl(xp, k1, 15)
    return (k1 * _C2).astype(xp.uint32)


def _mix_h1(xp, h1, k1):
    h1 = (h1 ^ k1).astype(xp.uint32)
    h1 = _rotl(xp, h1, 13)
    return (h1 * np.uint32(5) + _M5).astype(xp.uint32)


def _fmix(xp, h1, length):
    h1 = (h1 ^ xp.asarray(length).astype(xp.uint32)).astype(xp.uint32)
    h1 = h1 ^ (h1 >> np.uint32(16))
    h1 = (h1 * np.uint32(0x85EBCA6B)).astype(xp.uint32)
    h1 = h1 ^ (h1 >> np.uint32(13))
    h1 = (h1 * np.uint32(0xC2B2AE35)).astype(xp.uint32)
    return h1 ^ (h1 >> np.uint32(16))


def hash_int(xp, x_i32, seed_u32):
    if is_torch(xp):
        x = x_i32.to(torch.int64) & _MASK  # two's complement low 32 bits
        return _t_fmix(_t_mix_h1(_t_lanes(seed_u32, x), _t_mix_k1(x)), 4)
    k1 = _mix_k1(xp, _u32(xp, x_i32))
    h1 = _mix_h1(xp, _u32(xp, seed_u32), k1)
    return _fmix(xp, h1, 4)


def hash_long(xp, x_i64, seed_u32):
    if is_torch(xp):
        x = x_i64.to(torch.int64)
        h1 = _t_mix_h1(_t_lanes(seed_u32, x), _t_mix_k1(x & _MASK))
        h1 = _t_mix_h1(h1, _t_mix_k1((x >> 32) & _MASK))
        return _t_fmix(h1, 8)
    x = xp.asarray(x_i64).astype(xp.int64)
    low = _u32(xp, x & xp.asarray(0xFFFFFFFF, dtype=xp.int64))
    high = _u32(xp, (x >> 32) & xp.asarray(0xFFFFFFFF, dtype=xp.int64))
    k1 = _mix_k1(xp, low)
    h1 = _mix_h1(xp, _u32(xp, seed_u32), k1)
    k1 = _mix_k1(xp, high)
    h1 = _mix_h1(xp, h1, k1)
    return _fmix(xp, h1, 8)


def hash_bytes_padded(xp, data_u8, lengths, seed_u32):
    """hashUnsafeBytes over padded byte rows [n, width] with per-row lengths.

    Words are consumed 4 bytes at a time little-endian; the tail is consumed
    byte-by-byte sign-extended. The python loop is over the static width
    (under jit in the JAX package one fused program; in torch about 1.25·W
    steps of a few launches each).
    """
    if is_torch(xp):
        return _t_hash_bytes_padded(data_u8, lengths, seed_u32)
    n, width = data_u8.shape
    lengths = xp.asarray(lengths).astype(xp.int32)
    h1 = xp.broadcast_to(_u32(xp, seed_u32), (n,)).astype(xp.uint32)
    nwords = width // 4
    d = data_u8.astype(xp.uint32)
    for w in range(nwords):
        b0 = d[:, 4 * w]
        b1 = d[:, 4 * w + 1]
        b2 = d[:, 4 * w + 2]
        b3 = d[:, 4 * w + 3]
        word = (b0 | (b1 << np.uint32(8)) | (b2 << np.uint32(16)) | (b3 << np.uint32(24))).astype(xp.uint32)
        use = lengths >= (4 * w + 4)
        k1 = _mix_k1(xp, word)
        h1 = xp.where(use, _mix_h1(xp, h1, k1), h1)
    # tail bytes (position >= last full word, < length), sign-extended
    for i in range(width):
        b = data_u8[:, i].astype(xp.int8).astype(xp.int32)  # sign-extend
        use = (i >= (lengths // 4) * 4) & (i < lengths)
        k1 = _mix_k1(xp, _u32(xp, b))
        h1 = xp.where(use, _mix_h1(xp, h1, k1), h1)
    return _fmix(xp, h1, lengths.astype(xp.uint32))


def _t_hash_bytes_padded(data_u8, lengths, seed):
    lengths = lengths.to(torch.int64)
    h1 = _t_lanes(seed, lengths)
    d = data_u8.to(torch.int64)
    width = d.shape[1]
    for w in range(width // 4):
        word = (
            d[:, 4 * w]
            | (d[:, 4 * w + 1] << 8)
            | (d[:, 4 * w + 2] << 16)
            | (d[:, 4 * w + 3] << 24)
        )
        use = lengths >= (4 * w + 4)
        h1 = torch.where(use, _t_mix_h1(h1, _t_mix_k1(word)), h1)
    # tail bytes (position >= last full word, < length), sign-extended
    tail = (lengths // 4) * 4
    for i in range(width):
        b = d[:, i]
        b = torch.where(b >= 128, b - 256, b) & _MASK
        use = (i >= tail) & (i < lengths)
        h1 = torch.where(use, _t_mix_h1(h1, _t_mix_k1(b)), h1)
    return _t_fmix(h1, lengths & _MASK)


def _float_norm(xp, x, is_double: bool):
    # Spark normalizes -0.0 to 0.0 before hashing; NaN is canonical already
    # in the JVM (Float.floatToIntBits collapses NaNs).
    if is_torch(xp):
        x = torch.where(x == 0, 0.0, x)
        return torch.where(torch.isnan(x), float("nan"), x)
    zero = xp.zeros_like(x)
    x = xp.where(x == 0, zero, x)
    if is_double:
        canonical = xp.asarray(np.float64(np.nan))
    else:
        canonical = xp.asarray(np.float32(np.nan))
    return xp.where(xp.isnan(x), canonical, x)


def np_strings_to_padded(data, valid):
    """Object-dtype string array → (uint8[n, width], lengths) for the CPU
    hashing/encoding paths (width rounded to a multiple of 4)."""
    n = len(data)
    raw = [
        data[i].encode("utf-8") if (valid[i] and data[i] is not None) else b""
        for i in range(n)
    ]
    width = max((len(b) for b in raw), default=0)
    width = max(4, (width + 3) // 4 * 4)
    out = np.zeros((n, width), dtype=np.uint8)
    lengths = np.zeros(n, dtype=np.int32)
    for i, b in enumerate(raw):
        out[i, : len(b)] = np.frombuffer(b, dtype=np.uint8)
        lengths[i] = len(b)
    return out, lengths


def _hash_scalar_np(dt: DataType, value, seed_u32: np.uint32) -> np.uint32:
    """Spark-exact murmur3 of ONE python value (CPU oracle path for nested
    types: Spark's HashExpression folds element hashes recursively)."""
    from ..types import ArrayType, MapType, StructType

    if value is None:
        return seed_u32
    if isinstance(dt, ArrayType):
        h = seed_u32
        for el in value:
            h = _hash_scalar_np(dt.element_type, el, h)
        return h
    if isinstance(dt, StructType):
        h = seed_u32
        for f in dt.fields:
            h = _hash_scalar_np(f.data_type, value.get(f.name), h)
        return h
    if isinstance(dt, MapType):  # Spark: hashing maps is disallowed
        raise TypeError("hash of map type is not supported (Spark semantics)")
    one = hash_column(
        np,
        dt,
        np.asarray([value], dtype=object if isinstance(dt, StringType) else dt.np_dtype),
        np.asarray([True]),
        None,
        np.asarray([seed_u32], dtype=np.uint32),
    )
    return np.uint32(one[0])


def _native_hash_column(dt: DataType, data, valid, lengths, seed_u32):
    """Host path through the C++ murmur3 kernels (native/srt_host.cc;
    bit-identical to the numpy path). Returns uint32[n], or None when the
    native plane is unavailable or disabled."""
    from .. import native

    if not native.available():
        return None
    if isinstance(dt, StringType):
        if getattr(data, "ndim", 1) != 2 or lengths is None:
            data, lengths = np_strings_to_padded(data, np.asarray(valid).astype(bool))
        n = data.shape[0]
        h = np.broadcast_to(np.asarray(seed_u32, dtype=np.uint32), (n,)).copy()
        native.murmur3_update("bytes", np.ascontiguousarray(data, dtype=np.uint8), valid, h,
                              np.ascontiguousarray(lengths, dtype=np.int32))
        return h
    if isinstance(dt, BooleanType):
        kind, arr = "bool", np.ascontiguousarray(data, dtype=np.uint8)
    elif isinstance(dt, (LongType, TimestampType)):
        kind, arr = "i64", np.ascontiguousarray(data, dtype=np.int64)
    elif isinstance(dt, DecimalType):
        if dt.precision > 18:
            return None
        kind, arr = "i64", np.ascontiguousarray(data, dtype=np.int64)
    elif isinstance(dt, FloatType):
        kind, arr = "f32", np.ascontiguousarray(data, dtype=np.float32)
    elif isinstance(dt, DoubleType):
        kind, arr = "f64", np.ascontiguousarray(data, dtype=np.float64)
    else:  # byte/short/int/date
        kind, arr = "i32", np.ascontiguousarray(data, dtype=np.int32)
    h = np.broadcast_to(np.asarray(seed_u32, dtype=np.uint32), (arr.shape[0],)).copy()
    native.murmur3_update(kind, arr, valid, h)
    return h


def hash_column(xp, dt: DataType, data, valid, lengths, seed_u32):
    """One column's contribution: returns the new running hash (uint32[n]),
    leaving rows with NULL unchanged (Spark semantics)."""
    from ..types import is_complex

    if is_complex(dt):
        assert not is_torch(xp), "complex hash keys are gated off the device path"
        v = np.asarray(valid).astype(bool)
        seeds = np.broadcast_to(np.asarray(seed_u32, dtype=np.uint32), (len(v),)).copy()
        out = seeds.copy()
        for i in range(len(v)):
            if v[i] and data[i] is not None:
                out[i] = _hash_scalar_np(dt, data[i], seeds[i])
        return out
    if is_torch(xp):
        return _t_hash_column(dt, data, valid, lengths, seed_u32)
    nh = _native_hash_column(dt, data, valid, lengths, seed_u32)
    if nh is not None:
        return nh
    if isinstance(dt, StringType):
        if not is_torch(xp) and (getattr(data, "ndim", 1) != 2 or lengths is None):
            data, lengths = np_strings_to_padded(data, np.asarray(valid).astype(bool))
        h = hash_bytes_padded(xp, data, lengths, seed_u32)
    elif isinstance(dt, BooleanType):
        h = hash_int(xp, xp.where(data, 1, 0), seed_u32)
    elif isinstance(dt, (LongType, TimestampType)):
        h = hash_long(xp, data, seed_u32)
    elif isinstance(dt, DecimalType):
        if dt.precision <= 18:
            h = hash_long(xp, data, seed_u32)
        else:  # pragma: no cover - DECIMAL64 gate prevents this
            raise NotImplementedError
    elif isinstance(dt, FloatType):
        x = _float_norm(xp, data.astype(xp.float32), False)
        bits = x.view(np.int32)
        h = hash_int(xp, bits, seed_u32)
    elif isinstance(dt, DoubleType):
        x = _float_norm(xp, data.astype(xp.float64), True)
        bits = x.view(np.int64)
        h = hash_long(xp, bits, seed_u32)
    else:  # byte/short/int/date
        h = hash_int(xp, data.astype(xp.int32), seed_u32)
    seed_b = xp.broadcast_to(_u32(xp, seed_u32), h.shape)
    return xp.where(xp.asarray(valid).astype(bool), h, seed_b)


def _t_hash_column(dt: DataType, data, valid, lengths, seed):
    """The torch path of :func:`hash_column` (flat types; complex keys are
    gated off the device)."""
    if isinstance(dt, StringType):
        h = _t_hash_bytes_padded(data, lengths, seed)
    elif isinstance(dt, BooleanType):
        h = hash_int(torch, data.to(torch.int64), seed)
    elif isinstance(dt, (LongType, TimestampType)):
        h = hash_long(torch, data, seed)
    elif isinstance(dt, DecimalType):
        if dt.precision > 18:  # pragma: no cover - DECIMAL64 gate prevents this
            raise NotImplementedError
        h = hash_long(torch, data, seed)
    elif isinstance(dt, FloatType):
        x = _float_norm(torch, data.to(torch.float32), False)
        h = hash_int(torch, x.view(torch.int32), seed)
    elif isinstance(dt, DoubleType):
        x = _float_norm(torch, data.to(torch.float64), True)
        h = hash_long(torch, x.view(torch.int64), seed)
    else:  # byte/short/int/date
        h = hash_int(torch, data.to(torch.int32), seed)
    return torch.where(valid.to(torch.bool), h, _t_lanes(seed, h))


def murmur3_rows(xp, cols: list[tuple[DataType, Any, Any, Any]], n: int, seed: int = DEFAULT_SEED):
    """Row hash over columns [(dtype, data, valid, lengths)] → int32[n]."""
    if is_torch(xp):
        h = torch.full((n,), seed & _MASK, dtype=torch.int64, device=xp.device)
        for dt, data, valid, lengths in cols:
            h = hash_column(xp, dt, data, valid, lengths, h)
        # two's complement: lanes >= 2**31 are the negative int32s
        return torch.where(h >= 2**31, h - 2**32, h).to(torch.int32)
    h = xp.broadcast_to(_u32(xp, np.uint32(seed)), (n,)).astype(xp.uint32)
    for dt, data, valid, lengths in cols:
        h = hash_column(xp, dt, data, valid, lengths, h)
    return h.astype(xp.int32)


def partition_ids(xp, row_hash_i32, num_partitions: int):
    """Spark's ``Pmod(hash, n)`` — non-negative modulus."""
    if is_torch(xp):
        # torch's % on tensors is the floor modulus, as numpy's
        return (row_hash_i32.to(torch.int64) % num_partitions).to(torch.int32)
    from .. import native

    if native.available():
        return native.pmod(row_hash_i32, num_partitions)
    m = row_hash_i32 % np.int32(num_partitions)
    return xp.where(m < 0, m + np.int32(num_partitions), m).astype(xp.int32)
