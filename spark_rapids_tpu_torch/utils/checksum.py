"""Frame integrity checksums — CRC32C (Castagnoli) for the wire protocols.

Both framed transports (the serve Arrow-IPC protocol and the shuffle TCP
DATA plane) stamp every frame with a 32-bit checksum so a flipped bit on
the wire (or a framing bug) surfaces as a typed ``FrameCorruptError`` /
silent-drop-and-retry instead of a pyarrow decode crash deep inside a
query. CRC32C is the polynomial storage and RPC systems standardize on
(iSCSI, ext4, gRPC); a native implementation (the ``crc32c`` /
``google_crc32c`` wheels) is used when importable.

Fallback: when no native CRC32C is available (this image ships none and
nothing may be installed), frames are checksummed with zlib's C-speed
CRC-32 instead. The polynomial choice is a PER-PROCESS-FLEET constant,
never negotiated on the wire: every endpoint of a link runs this same
module from the same install (the serve client/server share the process
or the repo checkout; multiproc shuffle ranks are spawned from one
install), so both sides always agree. Checksums guard INTEGRITY, not
authenticity — neither polynomial is cryptographic.

Copied from ``spark_rapids_tpu/utils/checksum.py`` unchanged.
"""
from __future__ import annotations

import zlib

__all__ = ["frame_checksum", "IMPL"]


def _native_crc32c():
    try:
        import crc32c as _c  # type: ignore

        return _c.crc32c, "crc32c"
    except ImportError:
        pass
    try:
        import google_crc32c as _g  # type: ignore

        return (lambda data: int.from_bytes(_g.Checksum(bytes(data)).digest(), "big")), "google-crc32c"
    except ImportError:
        pass
    return None, ""


_fn, IMPL = _native_crc32c()
if _fn is None:
    _fn, IMPL = (lambda data: zlib.crc32(data) & 0xFFFFFFFF), "zlib-crc32"


def frame_checksum(data) -> int:
    """32-bit integrity checksum of ``data`` (bytes/memoryview). CRC32C
    when a native implementation exists, zlib CRC-32 otherwise — see the
    module docstring for why the selection never needs negotiation."""
    return _fn(data) & 0xFFFFFFFF
