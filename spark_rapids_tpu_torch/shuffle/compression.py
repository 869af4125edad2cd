"""Shuffle/spill buffer compression codecs.

Reference: TableCompressionCodec.scala (:41 SPI, :137 batched compressor,
:282 registry) + NvcompLZ4CompressionCodec.scala (GPU LZ4) +
CopyCompressionCodec.scala. Codecs run on host staging buffers, where the
TCP path stages data anyway. The codec used for a buffer is recorded in its
``BufferMeta.codec`` so readers self-describe (CodecBufferDescriptor
pattern).

The port's counterpart of ``spark_rapids_tpu/shuffle/compression.py``,
whose LZ4 and ZSTD are pyarrow's. The port's ``lz4`` is the LZ4 *frame*
format written in its host C++ library (``csrc/host/io_codec.cc``, built
with g++ at first use, as the Parquet snappy is), so its frames and
``pa.Codec("lz4")``'s read each other. The card's machine has no ZSTD
module, so ``zstd`` raises ``NotImplementedError`` naming the codec.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from . import meta as M

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from ..kernels import host_library

        lib = host_library("io_codec")
        i64, vp = ctypes.c_int64, ctypes.c_void_p
        for name, res, args in (
            ("srt_lz4f_max_compressed", i64, [i64]),
            ("srt_lz4f_compress", i64, [vp, i64, vp]),
            ("srt_lz4f_decompress", i64, [vp, i64, vp, i64]),
        ):
            fn = getattr(lib, name)
            fn.restype = res
            fn.argtypes = args
        _LIB = lib
    return _LIB


def _u8(data) -> np.ndarray:
    return np.frombuffer(data, dtype=np.uint8)


class CompressionCodec:
    """SPI: bytes→bytes with a wire id (TableCompressionCodec.scala:41)."""

    codec_id: int = M.CODEC_NONE
    name: str = "none"

    def compress(self, data: bytes) -> bytes:
        return data

    def decompress(self, data: bytes, uncompressed_size: int) -> bytes:
        return data


class CopyCodec(CompressionCodec):
    """Identity 'codec' (CopyCompressionCodec.scala) — used to exercise the
    compressed-buffer plumbing without a real codec."""

    codec_id = M.CODEC_COPY
    name = "copy"


class Lz4FrameCodec(CompressionCodec):
    """The LZ4 frame format (nvcomp LZ4's role), in the host codec
    library."""

    codec_id = M.CODEC_LZ4
    name = "lz4"

    def compress(self, data: bytes) -> bytes:
        src = _u8(data)
        lib = _lib()
        out = np.empty(lib.srt_lz4f_max_compressed(src.size), dtype=np.uint8)
        n = lib.srt_lz4f_compress(src.ctypes.data if src.size else None, src.size, out.ctypes.data)
        return out[:n].tobytes()

    def decompress(self, data: bytes, uncompressed_size: int) -> bytes:
        src = _u8(data)
        out = np.empty(max(uncompressed_size, 1), dtype=np.uint8)
        got = _lib().srt_lz4f_decompress(
            src.ctypes.data if src.size else None, src.size, out.ctypes.data, uncompressed_size
        )
        if got != uncompressed_size:
            raise ValueError(
                f"malformed LZ4 frame (decoded {got} of {uncompressed_size} bytes)"
            )
        return out[:uncompressed_size].tobytes()


def _zstd():
    raise NotImplementedError(
        "shuffle compression codec 'zstd' is not available in the torch port "
        "(no ZSTD module on the card's machine); use lz4, copy or none"
    )


def get_codec(name: Optional[str]) -> CompressionCodec:
    """Registry lookup (TableCompressionCodec.getCodec :282)."""
    name = (name or "none").lower()
    if name in ("none", "off"):
        return CompressionCodec()
    if name == "copy":
        return CopyCodec()
    if name == "lz4":
        return Lz4FrameCodec()
    if name == "zstd":
        _zstd()
    raise ValueError(f"unknown shuffle compression codec {name!r}")


def codec_for_id(codec_id: int) -> CompressionCodec:
    if codec_id == M.CODEC_ZSTD:
        _zstd()
    return {
        M.CODEC_NONE: CompressionCodec,
        M.CODEC_COPY: CopyCodec,
        M.CODEC_LZ4: Lz4FrameCodec,
    }[codec_id]()
