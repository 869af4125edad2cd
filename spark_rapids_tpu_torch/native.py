"""The port's loader of the native host data plane (``native/srt_host.cc``).

The port of ``spark_rapids_tpu/native/__init__.py``, with its semantics: the
shared C++ source is built with ``g++`` at first use (here through
``kernels.build_host``, into ``build/torch_kernels/``, keyed by the source's
hash), loaded with ``ctypes``, and every entry point has a numpy fallback,
so the engine never *requires* the toolchain: ``available()`` says which
plane is active, and ``spark.rapids.native.enabled`` gates it (the session
sets the gate).

Exposed planes:

* :func:`murmur3_update` / :func:`pmod` — Spark-exact columnar murmur3
  (HashFunctions.scala semantics; bit-identical to ``ops/hash.py``'s numpy
  path, which uses them when the plane is on);
* :class:`AddressSpaceAllocator` — best-fit arena sub-allocation
  (AddressSpaceAllocator.scala:22);
* :func:`frame_pack` / :func:`frame_write` / :func:`frame_unpack` —
  contiguous multi-buffer frames (``.srtf``), the DISK spill tier's
  currency (``mem/spill.py``).

``native/srt_rows.cc``'s ``rows_decode`` (collect's row assembly over
pyarrow tables) is not loaded: it waits for ROADMAP item 10b.
"""
from __future__ import annotations

import ctypes
import os
import struct
import threading
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

SRC = Path(__file__).resolve().parent.parent / "native" / "srt_host.cc"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
_enabled = True


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64 = ctypes.c_int64
    lib.srt_version.restype = ctypes.c_int32
    for name, args in (
        ("srt_mm3_i32", [i32p, u8p, u32p, i64]),
        ("srt_mm3_i64", [ctypes.POINTER(ctypes.c_int64), u8p, u32p, i64]),
        ("srt_mm3_bool", [u8p, u8p, u32p, i64]),
        ("srt_mm3_f32", [ctypes.POINTER(ctypes.c_float), u8p, u32p, i64]),
        ("srt_mm3_f64", [ctypes.POINTER(ctypes.c_double), u8p, u32p, i64]),
        ("srt_mm3_bytes", [u8p, i32p, u8p, u32p, i64, i64]),
        ("srt_pmod_i32", [i32p, i32p, i64, ctypes.c_int32]),
    ):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = None
    lib.srt_asa_create.argtypes = [ctypes.c_uint64]
    lib.srt_asa_create.restype = ctypes.c_void_p
    lib.srt_asa_destroy.argtypes = [ctypes.c_void_p]
    lib.srt_asa_alloc.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.srt_asa_alloc.restype = ctypes.c_int64
    lib.srt_asa_free.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.srt_asa_free.restype = ctypes.c_int64
    for name in ("srt_asa_allocated", "srt_asa_available"):
        getattr(lib, name).argtypes = [ctypes.c_void_p]
        getattr(lib, name).restype = ctypes.c_uint64
    lib.srt_asa_largest_free.argtypes = [ctypes.c_void_p]
    lib.srt_asa_largest_free.restype = ctypes.c_int64
    lib.srt_frame_size.argtypes = [u64p, ctypes.c_int32]
    lib.srt_frame_size.restype = ctypes.c_int64
    lib.srt_frame_pack.argtypes = [ctypes.POINTER(u8p), u64p, ctypes.c_int32, u8p, ctypes.c_uint64]
    lib.srt_frame_pack.restype = ctypes.c_int64
    lib.srt_frame_count.argtypes = [u8p, ctypes.c_uint64]
    lib.srt_frame_count.restype = ctypes.c_int32
    lib.srt_frame_unpack.argtypes = [u8p, ctypes.c_uint64, u64p, u64p, ctypes.c_int32]
    lib.srt_frame_unpack.restype = ctypes.c_int32
    return lib


def _load() -> Optional[ctypes.CDLL]:
    """The library, built on first use; None where it cannot be built
    (no ``g++``) or ``SRT_NATIVE_DISABLE`` is set — the numpy paths run."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("SRT_NATIVE_DISABLE"):
            return None
        from .kernels import build_host

        try:
            _lib = _bind(ctypes.CDLL(str(build_host("srt_host", SRC))))
        except (OSError, RuntimeError):
            _lib = None
        return _lib


def set_enabled(flag: bool) -> None:
    """Session-level gate (``spark.rapids.native.enabled``)."""
    global _enabled
    _enabled = bool(flag)


def available() -> bool:
    return _enabled and _load() is not None


# ── murmur3 ─────────────────────────────────────────────────────────────────


def _vp(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _valid_ptr(valid: Optional[np.ndarray]):
    if valid is None:
        return ctypes.cast(None, ctypes.POINTER(ctypes.c_uint8)), None
    v = np.ascontiguousarray(np.asarray(valid), dtype=np.uint8)
    return v.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), v


def murmur3_update(dtype_kind: str, data: np.ndarray, valid: Optional[np.ndarray],
                   h: np.ndarray, lengths: Optional[np.ndarray] = None) -> None:
    """In-place update of the running row-hash ``h`` (uint32[n], contiguous)
    with one column. ``dtype_kind`` ∈ {i32,i64,bool,f32,f64,bytes}; for
    ``bytes`` ``data`` is padded ``[n, width]`` u8 with ``lengths``."""
    lib = _load()
    assert lib is not None
    n = h.shape[0]
    vp, keep = _valid_ptr(valid)  # noqa: F841 - keep alive through call
    hp = _vp(h, ctypes.c_uint32)
    if dtype_kind == "i32":
        lib.srt_mm3_i32(_vp(data, ctypes.c_int32), vp, hp, n)
    elif dtype_kind == "i64":
        lib.srt_mm3_i64(_vp(data, ctypes.c_int64), vp, hp, n)
    elif dtype_kind == "bool":
        lib.srt_mm3_bool(_vp(data, ctypes.c_uint8), vp, hp, n)
    elif dtype_kind == "f32":
        lib.srt_mm3_f32(_vp(data, ctypes.c_float), vp, hp, n)
    elif dtype_kind == "f64":
        lib.srt_mm3_f64(_vp(data, ctypes.c_double), vp, hp, n)
    elif dtype_kind == "bytes":
        assert lengths is not None and data.ndim == 2
        lib.srt_mm3_bytes(_vp(data, ctypes.c_uint8), _vp(lengths, ctypes.c_int32), vp, hp,
                          n, data.shape[1])
    else:  # pragma: no cover
        raise ValueError(dtype_kind)


def pmod(h_i32: np.ndarray, num_partitions: int) -> np.ndarray:
    lib = _load()
    assert lib is not None
    h = np.ascontiguousarray(h_i32, dtype=np.int32)
    out = np.empty_like(h)
    lib.srt_pmod_i32(_vp(h, ctypes.c_int32), _vp(out, ctypes.c_int32), h.shape[0],
                     num_partitions)
    return out


# ── address-space allocator ─────────────────────────────────────────────────


class AddressSpaceAllocator:
    """Best-fit offset allocator over an arena of ``size`` bytes (native;
    AddressSpaceAllocator.scala:22). ``alloc`` returns an offset or None."""

    def __init__(self, size: int):
        lib = _load()
        assert lib is not None
        self._lib = lib
        self._h = lib.srt_asa_create(size)
        if not self._h:  # pragma: no cover - allocation failure
            raise MemoryError("srt_asa_create failed")
        self.size = size

    def alloc(self, size: int) -> Optional[int]:
        off = self._lib.srt_asa_alloc(self._h, size)
        return None if off < 0 else int(off)

    def free(self, offset: int) -> int:
        n = self._lib.srt_asa_free(self._h, offset)
        if n < 0:
            raise ValueError(f"free of unallocated offset {offset}")
        return int(n)

    @property
    def allocated(self) -> int:
        return int(self._lib.srt_asa_allocated(self._h))

    @property
    def available(self) -> int:
        return int(self._lib.srt_asa_available(self._h))

    @property
    def largest_free(self) -> int:
        return int(self._lib.srt_asa_largest_free(self._h))

    def close(self):
        if self._h:
            self._lib.srt_asa_destroy(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass


# ── contiguous frames ───────────────────────────────────────────────────────


def _as_u8_arrays(buffers: Sequence) -> List[np.ndarray]:
    """bytes / memoryview / contiguous ndarray buffers → flat uint8 arrays
    (the one definition frame_pack and frame_write share, so their layouts
    stay byte-identical)."""
    arrs = []
    for b in buffers:
        if isinstance(b, np.ndarray):
            a = np.ascontiguousarray(b).reshape(-1)
            arrs.append(a.view(np.uint8) if a.size else np.empty(0, np.uint8))
        else:
            arrs.append(np.frombuffer(b, dtype=np.uint8) if len(b) else np.empty(0, np.uint8))
    return arrs


def frame_pack(buffers: Sequence) -> memoryview:
    """Pack buffers into one contiguous frame (8-byte-aligned payloads); a
    zero-copy view of the frame's array."""
    lib = _load()
    assert lib is not None
    n = len(buffers)
    arrs = _as_u8_arrays(buffers)
    lens = np.asarray([a.shape[0] for a in arrs], dtype=np.uint64)
    lens_p = _vp(lens, ctypes.c_uint64)
    total = lib.srt_frame_size(lens_p, n)
    out = np.empty(int(total), dtype=np.uint8)
    ptrs = (ctypes.POINTER(ctypes.c_uint8) * n)(
        *[a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)) for a in arrs]
    )
    wrote = lib.srt_frame_pack(ptrs, lens_p, n, _vp(out, ctypes.c_uint8), total)
    assert wrote == total, (wrote, total)
    return out.data


def frame_write(fobj, buffers: Sequence) -> int:
    """Stream buffers to a file in the exact ``srt_frame_pack`` layout
    without materializing the frame (the spill path runs under memory
    pressure). Returns the bytes written."""
    arrs = _as_u8_arrays(buffers)
    n = len(arrs)
    lens = np.asarray([a.shape[0] for a in arrs], dtype=np.uint64)
    fobj.write(struct.pack("<IIII", 0x46545253, 1, n, 0))
    fobj.write(lens.tobytes())
    off = 16 + 8 * n
    for a in arrs:
        pad = (-off) % 8
        if pad:
            fobj.write(b"\x00" * pad)
            off += pad
        if a.shape[0]:
            fobj.write(memoryview(a))
        off += a.shape[0]
    return off


def frame_unpack(data) -> List[memoryview]:
    """Unpack a frame into zero-copy views over ``data``."""
    lib = _load()
    assert lib is not None
    arr = np.frombuffer(data, dtype=np.uint8)
    n = lib.srt_frame_count(_vp(arr, ctypes.c_uint8), arr.shape[0])
    if n < 0:
        raise ValueError("malformed srt frame")
    offs = np.empty(n, dtype=np.uint64)
    lens = np.empty(n, dtype=np.uint64)
    rc = lib.srt_frame_unpack(_vp(arr, ctypes.c_uint8), arr.shape[0],
                              _vp(offs, ctypes.c_uint64), _vp(lens, ctypes.c_uint64), n)
    if rc != 0:
        raise ValueError("malformed srt frame")
    mv = memoryview(data)
    return [mv[int(o) : int(o) + int(l)] for o, l in zip(offs, lens)]
